"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without
one. The file imports no jax, so on a machine without jax it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: the DTW kernels equal their twins exactly (min/add only); the
NMF kernels (the fused MU iteration too) sum in another order than cuBLAS,
so one call agrees within a relative error max|kernel − plain| / max|plain|
of 1e-5. The NMF kernels use no atomics, so repeated launches are compared
for equal bits, and the update's float4 and scalar epilogues (aligned and
misaligned pointers) for equal bits too: they do the same arithmetic. The fused Griffin-Lim's unit phases after 6 iterations are held
to a float64 run of its twin: the kernel's mean phase error may be at most
twice the float32 twin's own (+ 1e-7), and kernel and twin agree within
1e-4 relative L2. An element-wise 1e-4 between kernel and twin holds only
at small shapes: at F = 688 the float32 twin is itself up to 8.5e-4 from
float64 after 6 iterations (a bin whose t = rebuilt − μ/(1+μ)·prev nearly
cancels turns rounding into phase), and such a worst bin is a tail
statistic that differs between two roundings by a factor of ~3."""

import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch.align import dtw_cuda
from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
from exemplars_vc_tpu_torch.dsp import griffin_lim_cuda
from exemplars_vc_tpu_torch.factorize import nmf_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(64, 64), (300, 241), (1408, 1408)])
def test_dtw_kernels_equal_twins(cuda, ta, tb):
    rng = np.random.default_rng(ta)
    n = 3
    fa = torch.as_tensor(rng.standard_normal((n, ta, 20)).astype(np.float32), device=cuda)
    fb = torch.as_tensor(rng.standard_normal((n, tb, 20)).astype(np.float32), device=cuda)
    lens = torch.tensor([[ta, tb], [ta // 2, tb - 3], [5, 7]], dtype=torch.int32, device=cuda)
    C = pairwise_sqdist(fa, fb).contiguous()
    before = dtw_cuda.dtw_wavefront.launches
    cost, dirs = dtw_cuda.dtw_wavefront(C, lens)
    assert dtw_cuda.dtw_wavefront.launches == before + 1
    cost_p, dirs_p = dtw_cuda.dtw_wavefront_plain(C, lens)
    assert torch.equal(dirs, dirs_p) and torch.equal(cost, cost_p)
    for got, ref in zip(dtw_cuda.dtw_backtrace(dirs, lens),
                        dtw_cuda.dtw_backtrace_plain(dirs, lens)):
        assert torch.equal(got, ref)


# the edges of the split-K tiling: one row, one row past a 32-row tile, fewer
# K rows than the split, one K row past a slice boundary, one column, a
# ragged 128-column tile
NMF_EDGES = [(1, 130, 25), (689, 7681, 201), (33, 3, 25), (100, 700, 1), (100, 700, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", [(33, 130, 25), (100, 700, 201), (688, 7680, 201),
                                   *NMF_EDGES])
def test_nmf_kernels_match_twins(cuda, F, K, D):
    rng = np.random.default_rng(F)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - K // 10:] = 0.0
    A = torch.as_tensor(A, device=cuda)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=cuda)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=cuda)
    Num = X @ A.T
    P = nmf_cuda.nmf_recon_plain(H, A)
    assert _rel(nmf_cuda.nmf_recon(H, A), P) <= 1e-5
    for l1 in (0.0, 0.3):
        ref = nmf_cuda.nmf_update_plain(P, A, H, Num, l1)
        assert _rel(nmf_cuda.nmf_update(P, A, H, Num, l1), ref) <= 1e-5
    Hin = H.clone()
    out = nmf_cuda.nmf_update(P, A, Hin, Num, out=Hin)
    assert out is Hin and _rel(Hin, nmf_cuda.nmf_update_plain(P, A, H, Num)) <= 1e-5


# the update's edges: K % 4 != 0 (3, 130, 7681; the scalar epilogue), K below
# the 128-column tile, F below / one past the 64-row tile, D = 1, and
# D = 8193, past the fused kernel's limit (the update stages D in slices)
UPDATE_EDGES = [(13, 3, 25), (64, 130, 201), (65, 7681, 201), (63, 100, 1), (1, 130, 8193),
                (100, 700, 8193), (688, 7680, 201)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", UPDATE_EDGES)
def test_nmf_update_edges_match_twin(cuda, F, K, D):
    """Zero dictionary rows make den = 0 (l1 = 0) → EPS; there Num = 0 too,
    so the update collapses to 0 and stays finite."""
    rng = np.random.default_rng(F + K + D)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    zero = max(1, K // 10)
    A[K - zero:] = 0.0
    A = torch.as_tensor(A, device=cuda)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=cuda)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=cuda)
    Num = X @ A.T
    P = nmf_cuda.nmf_recon_plain(H, A)
    for l1 in (0.0, 0.3):
        before = nmf_cuda.nmf_update.launches
        got = nmf_cuda.nmf_update(P, A, H, Num, l1)
        assert nmf_cuda.nmf_update.launches == before + 1
        assert _rel(got, nmf_cuda.nmf_update_plain(P, A, H, Num, l1)) <= 1e-5
        assert bool(torch.isfinite(got).all()) and (got[:, K - zero:] == 0).all()
    Hin = H.clone()
    out = nmf_cuda.nmf_update(P, A, Hin, Num, out=Hin)
    assert out is Hin and _rel(Hin, nmf_cuda.nmf_update_plain(P, A, H, Num)) <= 1e-5


@pytest.mark.cuda
def test_nmf_update_in_place_on_misaligned_views(cuda):
    """H, Num and out as contiguous views 4 bytes into their storage: the
    kernel takes its scalar epilogue, in place, and gives the bits of the
    float4 epilogue on aligned copies."""
    F, K, D = 100, 700, 201
    A, H, Num = _nmf_inputs(F, K, D, cuda)
    P = nmf_cuda.nmf_recon(H, A)
    aligned = nmf_cuda.nmf_update(P, A, H, Num, 0.3)
    hbuf = torch.empty(F * K + 1, device=cuda)
    nbuf = torch.empty(F * K + 1, device=cuda)
    Hv, Nv = hbuf[1:].view(F, K), nbuf[1:].view(F, K)
    assert Hv.is_contiguous() and Hv.data_ptr() % 16 == 4
    Hv.copy_(H)
    Nv.copy_(Num)
    out = nmf_cuda.nmf_update(P, A, Hv, Nv, 0.3, out=Hv)
    assert out is Hv and torch.equal(Hv, aligned)
    assert _rel(Hv, nmf_cuda.nmf_update_plain(P, A, H, Num, 0.3)) <= 1e-5


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    H = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nmf_cuda.nmf_recon(H, torch.zeros((8, 3), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="expected"):
        nmf_cuda.nmf_recon(H, torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="shared"):
        dtw_cuda.dtw_wavefront(torch.zeros((1, 20000, 2), device=cuda),
                               torch.tensor([[1, 1]], dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", [(33, 130, 25), (100, 700, 201), (13, 1000, 300),
                                   (688, 7680, 201), *NMF_EDGES, (13, 700, 6144)])
def test_nmf_fused_matches_twin(cuda, F, K, D):
    rng = np.random.default_rng(F + K)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - K // 10:] = 0.0
    A = torch.as_tensor(A, device=cuda)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=cuda)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=cuda)
    Num = X @ A.T
    for l1 in (0.0, 0.3):
        before = nmf_cuda.nmf_mu_fused.launches
        got = nmf_cuda.nmf_mu_fused(H, A, Num, l1)
        assert nmf_cuda.nmf_mu_fused.launches == before + 1
        assert _rel(got, nmf_cuda.nmf_mu_fused_plain(H, A, Num, l1)) <= 1e-5
    # zero dictionary rows: den = 0 → EPS, the activation collapses to 0
    assert (got[:, K - K // 10:] == 0).all()
    Hin = H.clone()
    out = nmf_cuda.nmf_mu_fused(Hin, A, Num, out=Hin)
    assert out is Hin and _rel(Hin, nmf_cuda.nmf_mu_fused_plain(H, A, Num)) <= 1e-5


def _nmf_inputs(F, K, D, device):
    rng = np.random.default_rng(K)
    A = torch.as_tensor(np.abs(rng.standard_normal((K, D))).astype(np.float32), device=device)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=device)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=device)
    return A, H, X @ A.T


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", [(688, 7680, 201), (689, 7681, 300), (65, 1030, 520)])
def test_nmf_split_k_kernels_are_deterministic(cuda, F, K, D):
    """No atomics: repeated launches give equal bits, and the fused iteration
    equals recon + update bit for bit (both sum P over the same K slices, and
    den over d ascending from zero)."""
    A, H, Num = _nmf_inputs(F, K, D, cuda)
    P = nmf_cuda.nmf_recon(H, A)
    assert torch.equal(P, nmf_cuda.nmf_recon(H, A))
    got = nmf_cuda.nmf_mu_fused(H, A, Num, 0.3)
    assert torch.equal(got, nmf_cuda.nmf_mu_fused(H, A, Num, 0.3))
    upd = nmf_cuda.nmf_update(P, A, H, Num, 0.3)
    assert torch.equal(upd, nmf_cuda.nmf_update(P, A, H, Num, 0.3))
    assert torch.equal(got, upd)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["nmf_recon", "nmf_mu_fused", "nmf_update"])
@pytest.mark.parametrize("fault", ["cluster", "smem", "tile"])
def test_nmf_plan_that_cannot_launch_raises(cuda, kernel, fault):
    """A cluster above the portable 8 (for the update, any cluster), shared
    memory above the opt-in limit or a tile the source does not compile is
    refused before any launch."""
    F, K, D = 100, 700, 201
    A, H, Num = _nmf_inputs(F, K, D, cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = {"nmf_recon": nmf_cuda.nmf_recon_plan, "nmf_mu_fused": nmf_cuda.nmf_mu_fused_plan,
            "nmf_update": nmf_cuda.nmf_update_plan}[kernel](F, K, D, n_sms)
    if fault == "cluster" and kernel == "nmf_update":
        plan = dict(plan, split=2)
    elif fault == "cluster":
        plan = dict(plan, split=9, cluster=(9, 1, 1), grid=(9, *plan["grid"][1:]),
                    k_bounds=tuple(range(0, 9 * 64, 64)) + (K,))
    elif fault == "smem":
        plan = dict(plan, smem_bytes=nmf_cuda.SMEM_LIMIT_BYTES + 1024)
    else:
        plan = dict(plan, tile=(24, plan["tile"][1]))
    fn = getattr(nmf_cuda, kernel)
    before = fn.launches
    out = torch.full_like(H, -1.0)
    with pytest.raises((ValueError, RuntimeError)):
        if kernel == "nmf_recon":
            nmf_cuda.nmf_recon(H, A, plan=plan)
        elif kernel == "nmf_update":
            nmf_cuda.nmf_update(nmf_cuda.nmf_recon_plain(H, A), A, H, Num, out=out, plan=plan)
        else:
            nmf_cuda.nmf_mu_fused(H, A, Num, out=out, plan=plan)
    torch.cuda.synchronize()
    assert fn.launches == before and bool((out == -1.0).all())
    with pytest.raises(RuntimeError):
        nmf_cuda.co_resident_clusters(kernel, plan, F, K, D)


@pytest.mark.cuda
@pytest.mark.parametrize("F,n_fft,hop", [(13, 32, 8), (100, 64, 16), (688, 400, 80)])
def test_gl_fused_matches_twin(cuda, F, n_fft, hop):
    rng = np.random.default_rng(F)
    nb = n_fft // 2 + 1
    mag = np.abs(rng.standard_normal((F, nb))).astype(np.float32)
    mag[[0, F // 2]] = 0.0                        # zero rows, as silent frames give
    ang = np.exp(2j * np.pi * rng.random((F, nb))).astype(np.complex64)
    mag, ang = torch.as_tensor(mag, device=cuda), torch.as_tensor(ang, device=cuda)
    before = griffin_lim_cuda.gl_angles_fused.launches
    got = griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9)
    assert griffin_lim_cuda.gl_angles_fused.launches == before + 1
    ref = griffin_lim_cuda.gl_angles_fused_plain(mag, ang, n_fft, hop, 6, 0.9)
    ref64 = griffin_lim_cuda.gl_angles_fused_plain(mag.double(), ang.to(torch.complex128),
                                                   n_fft, hop, 6, 0.9)
    torch.cuda.synchronize()
    e_k64 = float((got - ref64).abs().mean())
    e_p64 = float((ref - ref64).abs().mean())
    assert e_k64 <= 2 * e_p64 + 1e-7, (e_k64, e_p64)
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 1e-4
    if F < 50:
        assert float((got - ref).abs().max()) <= 1e-4
    # a smaller grid walks several tiles per block and computes the same
    got2 = griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9, _grid_blocks=3)
    assert torch.equal(got2, got)


@pytest.mark.cuda
def test_fused_wrappers_reject_bad_inputs(cuda):
    H = torch.zeros((4, 8), device=cuda)
    A = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nmf_cuda.nmf_mu_fused(H, A.double(), torch.zeros_like(H))
    with pytest.raises(ValueError, match="expected"):
        nmf_cuda.nmf_mu_fused(H, A.cpu(), torch.zeros_like(H))
    with pytest.raises(ValueError, match="float32"):
        nmf_cuda.nmf_mu_fused(H, A, torch.zeros((4, 9), device=cuda))
    mag = torch.ones((10, 201), device=cuda)
    ang = torch.ones((10, 201), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="hop must divide n_fft"):
        griffin_lim_cuda.gl_angles_fused(mag, ang, 400, 96, 2, 0.9)
    with pytest.raises(ValueError, match="on"):
        griffin_lim_cuda.gl_angles_fused(mag, ang.cpu(), 400, 80, 2, 0.9)
    with pytest.raises(ValueError, match="n_fft//2"):
        griffin_lim_cuda.gl_angles_fused(mag[:, :100], ang[:, :100], 400, 80, 2, 0.9)
    # a grid larger than the co-resident block count would deadlock: refused
    plan = griffin_lim_cuda.gl_fused_plan(10, 400, 80)
    with pytest.raises(RuntimeError, match="evc_gl_fused"):
        griffin_lim_cuda.gl_angles_fused(mag, ang, 400, 80, 2, 0.9,
                                         _grid_blocks=plan["resident"] + 1)
