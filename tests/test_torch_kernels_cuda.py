"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without
one. The file imports no jax, so on a machine without jax it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: the DTW kernels equal their twins exactly (min/add only); the
NMF kernels (the fused MU iteration too) sum in another order than cuBLAS,
so one call agrees within a relative error max|kernel − plain| / max|plain|
of 1e-5. The fused Griffin-Lim's unit phases after 6 iterations are held
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


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", [(33, 130, 25), (100, 700, 201), (688, 7680, 201)])
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
                                   (688, 7680, 201)])
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
