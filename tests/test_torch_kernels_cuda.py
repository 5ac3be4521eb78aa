"""The port's CUDA kernels against their plain-PyTorch twins, on the card.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip without
one. The file imports no jax, so on a machine without jax it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: the DTW kernels equal their twins exactly (min/add only), and
repeated launches give equal bits; the NMF kernels (the fused MU iteration
too) sum in another order than cuBLAS, so one call agrees within a relative
error max|kernel − plain| / max|plain| of 1e-5. The NMF kernels use no
atomics, so repeated launches are compared for equal bits, and the update's
float4 and scalar epilogues (aligned and misaligned pointers) for equal bits
too: they do the same arithmetic. The KL update sums R·Aᵀ over d in another
order than cuBLAS, and every term is non-negative, so each element is well
conditioned: it is held per element, max |kernel − twin| / |twin| ≤ 1e-5
(and 0 where the twin is 0); in place, out of place, misaligned and repeated
runs give equal bits. The fused Griffin-Lim's unit phases after 6 iterations
are held to a float64 run of its twin: the kernel's mean phase error may be
at most twice the float32 twin's own (+ 1e-7), and kernel and twin agree
within 1e-4 relative L2. An element-wise 1e-4 between kernel and twin holds
only at small shapes: at F = 688 the float32 twin is itself up to 8.5e-4
from float64 after 6 iterations (a bin whose t = rebuilt − μ/(1+μ)·prev
nearly cancels turns rounding into phase), and such a worst bin is a tail
statistic that differs between two roundings by a factor of ~3. The centered
kernel (the production's projection) at the served and streamed shapes, 300
and 60 iterations, is held to the float64 twin by the same mean-phase rule
alone: over hundreds of iterations the float32 twin drifts from float64 by
more than 1e-4. The production ``griffin_lim`` takes the centered kernel for
those shapes, and runs its eager loop for the others (a hop that does not
divide n_fft, more frames than the kernel's tiles hold), where it must equal
``_fused=False`` bit for bit and hold no memory after."""

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


def _dtw_lens(ta, tb):
    """Full lengths, a ragged pair, a short one, and la = 1 / lb = 1 edges."""
    rows = [[ta, tb], [max(1, ta // 2), max(1, tb - 3)], [min(5, ta), min(7, tb)],
            [1, tb], [ta, 1], [1, 1]]
    return torch.tensor(rows, dtype=torch.int32)


def _dtw_check(cuda, ta, tb, lens, dim=20, seed=0):
    """Both DTW kernels against their twins, byte for byte; returns the
    kernels' outputs."""
    rng = np.random.default_rng(seed)
    n = lens.shape[0]
    fa = torch.as_tensor(rng.standard_normal((n, ta, dim)).astype(np.float32), device=cuda)
    fb = torch.as_tensor(rng.standard_normal((n, tb, dim)).astype(np.float32), device=cuda)
    lens = lens.to(cuda)
    C = pairwise_sqdist(fa, fb).contiguous()
    before = dtw_cuda.dtw_wavefront.launches
    cost, dirs = dtw_cuda.dtw_wavefront(C, lens)
    assert dtw_cuda.dtw_wavefront.launches == before + 1
    cost_p, dirs_p = dtw_cuda.dtw_wavefront_plain(C, lens)
    assert torch.equal(cost, cost_p), (cost, cost_p)
    assert torch.equal(dirs, dirs_p), int((dirs != dirs_p).sum())
    before = dtw_cuda.dtw_backtrace.launches
    paths = dtw_cuda.dtw_backtrace(dirs, lens)
    assert dtw_cuda.dtw_backtrace.launches == before + 1
    for got, ref in zip(paths, dtw_cuda.dtw_backtrace_plain(dirs, lens)):
        assert torch.equal(got, ref)
    return C, lens, cost, dirs, paths


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb,band_rows", [(300, 241, 64), (300, 241, 7), (517, 300, 100),
                                             (1408, 1408, 1024), (4200, 50, 4097)])
def test_dtw_kernel_bands_equal_twin(cuda, ta, tb, band_rows):
    """The wavefront in row bands (one launch a band, each band's last row
    handed to the next) against the unbanded twin, byte for byte: bands
    that start off a 16-byte boundary (7, 100 rows), bands of one row a
    lane and of eight (4097), and the lengths of ``_dtw_lens``."""
    rng = np.random.default_rng(ta + band_rows)
    lens = _dtw_lens(ta, tb).to(cuda)
    n = lens.shape[0]
    fa = torch.as_tensor(rng.standard_normal((n, ta, 8)).astype(np.float32), device=cuda)
    fb = torch.as_tensor(rng.standard_normal((n, tb, 8)).astype(np.float32), device=cuda)
    C = pairwise_sqdist(fa, fb).contiguous()
    before = dtw_cuda.dtw_wavefront.launches
    cost, dirs = dtw_cuda.dtw_wavefront(C, lens, band_rows=band_rows)
    assert dtw_cuda.dtw_wavefront.launches == before + -(-ta // band_rows)
    cost_p, dirs_p = dtw_cuda.dtw_wavefront_plain(C, lens)
    assert torch.equal(cost, cost_p), (cost, cost_p)
    assert torch.equal(dirs, dirs_p), int((dirs != dirs_p).sum())


# Ta > 1024 and not a multiple of 32 (1409), Ta < Tb and Ta > Tb, Ta = 1 and
# Tb = 1, Ta not a multiple of 4 (the byte-wise stores and window loads)
@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(64, 64), (300, 241), (1408, 1408), (1409, 1300),
                                   (300, 517), (517, 300), (1, 40), (33, 1), (690, 683)])
def test_dtw_kernels_equal_twins(cuda, ta, tb):
    _dtw_check(cuda, ta, tb, _dtw_lens(ta, tb), seed=ta)


@pytest.mark.cuda
def test_dtw_kernels_at_the_mcd_shape(cuda):
    """The MCD's launch on the main path: one pair of 683 uncentered
    mel-cepstral frames (order 25) of the 54,995-sample held-out input."""
    _dtw_check(cuda, 683, 683, torch.tensor([[683, 683]], dtype=torch.int32), dim=26)


@pytest.mark.cuda
def test_dtw_kernels_long_pair(cuda):
    """The longest source the wrappers take (Ta = 32,768): 8 rows a lane
    over a cluster of 8 CTAs of 16 warps; a path of ~35k steps through ~140
    windows (the codes take 1.1 GB)."""
    ta, tb = dtw_cuda.MAX_TA, 2000
    assert dtw_cuda.fits_plan(ta) and not dtw_cuda.fits_plan(ta + 1)
    _dtw_check(cuda, ta, tb, torch.tensor([[ta, tb]], dtype=torch.int32), dim=4)


def _tiled_sweep(C, n_rows, col_block, tile, codes=True):
    """The DP of one pair (Ta, Tb) in n_rows row blocks x column blocks of
    col_block, tile by tile in a wavefront order, each tile's halos from its
    neighbours (a message of col_block + 4 floats, the bottom row then the
    corner, as the sequence-parallel DTW hands it on). Returns the codes
    (Ta, Tb) (or None), the last cell's cost and the tile launches."""
    ta, tb = C.shape
    R = ta // n_rows
    dev = C.device
    dirs = torch.zeros((ta, tb), dtype=torch.int8, device=dev) if codes else None
    bottoms, rights = {}, {}
    for r in range(n_rows):
        for b in range(-(-tb // col_block)):
            c0, c1 = b * col_block, min(tb, (b + 1) * col_block)
            top = corner = None
            if r > 0:
                msg = torch.full((col_block + 4,), dtw_cuda.BIG, dtype=torch.float32, device=dev)
                msg[: c1 - c0] = bottoms[r - 1, b]
                if b > 0:
                    msg[col_block] = bottoms[r - 1, b - 1][-1]
                    corner = msg[col_block:col_block + 1]
                top = msg
            bot, right, cd = tile(C[r * R:(r + 1) * R, c0:c1], top, corner,
                                  rights.get((r, b - 1)), origin=r == 0 and b == 0, codes=codes)
            bottoms[r, b], rights[r, b] = bot, right
            if codes:
                dirs[r * R:(r + 1) * R, c0:c1] = cd
    return dirs, bottoms[n_rows - 1, -(-tb // col_block) - 1][-1]


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb,n_rows,col_block", [
    (128, 200, 2, 64), (128, 200, 4, 32), (300, 241, 3, 100), (300, 241, 1, 241),
    (8200, 700, 2, 512), (64, 90, 4, 32)])
def test_dtw_tile_mode_equals_one_sweep(cuda, ta, tb, n_rows, col_block):
    """The wavefront's tile mode in a wavefront schedule of tiles against one
    sweep of the same C, byte for byte (codes and the last cost), and the
    distance-only variant's cost equal too; tiles of one row a lane and of
    eight (4100 rows), windows off a 16-byte boundary (100, 241 columns) and
    a ragged last column block; the tile twin gives the same codes."""
    rng = np.random.default_rng(ta + col_block)
    fa = torch.as_tensor(rng.standard_normal((ta, 6)).astype(np.float32), device=cuda)
    fb = torch.as_tensor(rng.standard_normal((tb, 6)).astype(np.float32), device=cuda)
    C = pairwise_sqdist(fa, fb).contiguous()
    lens = torch.tensor([[ta, tb]], dtype=torch.int32, device=cuda)
    cost, dirs = dtw_cuda.dtw_wavefront(C[None].contiguous(), lens)
    sweep = dtw_cuda.tile_codes(dirs[0], ta, tb)
    before = dtw_cuda.dtw_tile.launches
    got, last = _tiled_sweep(C, n_rows, col_block, dtw_cuda.dtw_tile)
    n_tiles = n_rows * -(-tb // col_block)
    assert dtw_cuda.dtw_tile.launches == before + n_tiles
    assert torch.equal(got, sweep), int((got != sweep).sum())
    assert float(last) == float(cost[0])
    _, last_d = _tiled_sweep(C, n_rows, col_block, dtw_cuda.dtw_tile, codes=False)
    assert float(last_d) == float(cost[0])
    if ta <= 300:
        twin, last_p = _tiled_sweep(C.cpu(), n_rows, col_block, dtw_cuda.dtw_tile_plain)
        assert torch.equal(twin, got.cpu()) and float(last_p) == float(cost[0])


@pytest.mark.cuda
def test_dtw_tile_refuses_bad_halos(cuda):
    C = torch.rand((64, 40), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        dtw_cuda.dtw_tile(C, torch.zeros(41, device=cuda))
    with pytest.raises(ValueError, match="left"):
        dtw_cuda.dtw_tile(C, left=torch.zeros(10, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("host_lens", [True, False], ids=["host-lens", "device-lens"])
def test_dtw_batch_refuses_out_of_range_lengths(cuda, host_lens):
    """The range check on the lengths holds on the card whether the caller
    hands host arrays (checked without a device sync) or device tensors
    (one copy back): a bad length raises before either kernel launches, and
    good lengths give the twins' paths."""
    from exemplars_vc_tpu_torch.align.dtw import dtw_batch

    rng = np.random.default_rng(0)
    fa = torch.as_tensor(rng.standard_normal((2, 40, 6)).astype(np.float32), device=cuda)
    fb = torch.as_tensor(rng.standard_normal((2, 33, 6)).astype(np.float32), device=cuda)

    def lens(a, b):
        a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
        return (a, b) if host_lens else (torch.as_tensor(a, device=cuda),
                                         torch.as_tensor(b, device=cuda))

    launches = (dtw_cuda.dtw_wavefront.launches, dtw_cuda.dtw_backtrace.launches)
    for la, lb in (([41, 10], [33, 33]), ([40, 10], [33, 34]), ([0, 10], [33, 33]),
                   ([40, 10], [33, -1])):
        with pytest.raises(ValueError, match="lens out of range"):
            dtw_batch(fa, fb, *lens(la, lb))
    assert (dtw_cuda.dtw_wavefront.launches, dtw_cuda.dtw_backtrace.launches) == launches
    r = dtw_batch(fa, fb, *lens([40, 10], [33, 20]))
    assert (dtw_cuda.dtw_wavefront.launches, dtw_cuda.dtw_backtrace.launches) == \
        (launches[0] + 1, launches[1] + 1)
    both = torch.tensor([[40, 33], [10, 20]], dtype=torch.int32, device=cuda)
    cost, dirs = dtw_cuda.dtw_wavefront_plain(pairwise_sqdist(fa, fb).contiguous(), both)
    assert torch.equal(r.raw_distance, cost)
    for got, ref in zip((r.path_i, r.path_j, r.path_len),
                        dtw_cuda.dtw_backtrace_plain(dirs, both)):
        assert torch.equal(got, ref)
    # a host copy of another shape than the device lengths is refused too
    with pytest.raises(ValueError, match="lens_host"):
        dtw_cuda._check_lens(both, 2, 40, 33, both.device, np.ones((3, 2), np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,ta,tb", [(3, 1409, 700), (40, 1409, 300), (132, 512, 64),
                                     (1, 4097, 300), (2, 4096, 50)])
def test_dtw_wavefront_plans_give_equal_codes(cuda, n, ta, tb):
    """The plans the pair count and Ta lead to (clusters of 8, 3 and 1 CTAs
    at one row a lane, eight rows a lane past 4096) compute the same codes."""
    lens = _dtw_lens(ta, tb)
    lens = lens[torch.arange(n) % lens.shape[0]]
    _dtw_check(cuda, ta, tb, lens, dim=4, seed=n + ta)


@pytest.mark.cuda
def test_dtw_kernels_are_deterministic(cuda):
    """Repeated launches give equal bits (no atomics; the warp chain's
    handshakes order every read after its write)."""
    C, lens, cost, dirs, paths = _dtw_check(cuda, 1408, 1408, _dtw_lens(1408, 1408))
    for _ in range(5):
        c2, d2 = dtw_cuda.dtw_wavefront(C, lens)
        assert torch.equal(c2, cost) and torch.equal(d2, dirs)
        for got, ref in zip(dtw_cuda.dtw_backtrace(dirs, lens), paths):
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_dtw_plan_that_cannot_cover_ta_raises(cuda, monkeypatch):
    """The C entry refuses a plan that does not cover Ta or names a variant
    that is not compiled, and the wrapper raises without counting a launch."""
    C = torch.zeros((1, 600, 50), device=cuda)
    lens = torch.tensor([[600, 50]], dtype=torch.int32, device=cuda)
    plan = dict(rows_per_lane=1, cluster=1, warps_per_cta=16)     # 512 rows < 600
    before = dtw_cuda.dtw_wavefront.launches
    for bad in (plan, dict(plan, rows_per_lane=2, warps_per_cta=10)):
        monkeypatch.setattr(dtw_cuda, "dtw_wavefront_plan", lambda n, ta, n_sms, p=bad: p)
        with pytest.raises(RuntimeError, match="dtw_wavefront"):
            dtw_cuda.dtw_wavefront(C, lens)
    assert dtw_cuda.dtw_wavefront.launches == before


# the edges of the split-K tiling: one row, one row past a 32-row tile, fewer
# K rows than the split, one K row past a slice boundary, one column, a
# ragged 128-column tile
NMF_EDGES = [(1, 130, 25), (689, 7681, 201), (33, 3, 25), (100, 700, 1), (100, 700, 300)]
# the served recon shapes (K = 14,336: a stream chunk, requests at D = 201 and
# 1025, the longest request), and an edge of their tiling: K = 14,335 ends
# inside the last unit's last slice (and, K % 4 != 0, takes H in 4-byte copies)
NMF_SERVED = [(16, 14_336, 201), (620, 14_336, 201), (620, 14_336, 1025),
              (1360, 14_336, 1025), (620, 14_335, 1025)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", [(33, 130, 25), (100, 700, 201), (688, 7680, 201),
                                   *NMF_EDGES, *NMF_SERVED])
def test_nmf_kernels_match_twins(cuda, F, K, D):
    rng = np.random.default_rng(F)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - K // 10:] = 0.0
    A = torch.as_tensor(A, device=cuda)
    X = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=cuda)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=cuda)
    Num = X @ A.T
    P = nmf_cuda.nmf_recon_plain(H, A)
    got = nmf_cuda.nmf_recon(H, A)
    assert _rel(got, P) <= 1e-5
    assert torch.equal(got, nmf_cuda.nmf_recon(H, A))   # no atomics: the same bits
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
    # a source one row past a launch's reach runs in two bands: the same codes
    # and cost as in bands of 8192 rows and as the twin (on the card)
    rng = np.random.default_rng(7)
    ta, tb = dtw_cuda.MAX_TA + 1, 3
    C = torch.as_tensor(rng.uniform(0, 1, (1, ta, tb)).astype(np.float32), device=cuda)
    lens = torch.tensor([[ta, tb]], dtype=torch.int32, device=cuda)
    before = dtw_cuda.dtw_wavefront.launches
    cost, dirs = dtw_cuda.dtw_wavefront(C, lens)
    assert dtw_cuda.dtw_wavefront.launches == before + 2
    cost_8k, dirs_8k = dtw_cuda.dtw_wavefront(C, lens, band_rows=8192)
    cost_p, dirs_p = dtw_cuda.dtw_wavefront_plain(C, lens)
    assert torch.equal(cost, cost_8k) and torch.equal(dirs, dirs_8k)
    assert torch.equal(cost, cost_p) and torch.equal(dirs, dirs_p)
    with pytest.raises(ValueError, match="outside"):
        dtw_cuda.dtw_wavefront(C, lens, band_rows=dtw_cuda.MAX_TA + 1)


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
@pytest.mark.parametrize("F,K,D", [(688, 7680, 201), (689, 7681, 300), (65, 1030, 520),
                                   (16, 14_336, 201), (620, 14_336, 1025)])
def test_nmf_split_k_kernels_are_deterministic(cuda, F, K, D):
    """No atomics: repeated launches give equal bits, and the fused iteration
    equals recon + update bit for bit (both sum P over the same K pieces, in
    the recon's groups, and den over d ascending from zero)."""
    A, H, Num = _nmf_inputs(F, K, D, cuda)
    P = nmf_cuda.nmf_recon(H, A)
    assert torch.equal(P, nmf_cuda.nmf_recon(H, A))
    got = nmf_cuda.nmf_mu_fused(H, A, Num, 0.3)
    assert torch.equal(got, nmf_cuda.nmf_mu_fused(H, A, Num, 0.3))
    upd = nmf_cuda.nmf_update(P, A, H, Num, 0.3)
    assert torch.equal(upd, nmf_cuda.nmf_update(P, A, H, Num, 0.3))
    assert torch.equal(got, upd)


@pytest.mark.cuda
def test_nmf_recon_keeps_one_workspace_a_stream(cuda):
    """Recons on one stream reuse one kept workspace, another stream keeps
    its own, and a workspace past the kept size (1360 x 14,336 x 1025) is
    allocated for its call and kept by no one; every answer is the same."""
    A, H, _ = _nmf_inputs(16, 14_336, 201, cuda)
    P = nmf_cuda.nmf_recon(H, A)
    key = (H.device.index, torch.cuda.current_stream(cuda).cuda_stream)
    ws = nmf_cuda._workspaces[key]
    assert torch.equal(nmf_cuda.nmf_recon(H, A), P) and nmf_cuda._workspaces[key] is ws
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        Ps = nmf_cuda.nmf_recon(H, A)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert nmf_cuda._workspaces[(H.device.index, side.cuda_stream)] is not ws
    assert torch.equal(Ps, P)
    A, H, _ = _nmf_inputs(1360, 14_336, 1025, cuda)
    plan = nmf_cuda.nmf_recon_plan(1360, 14_336, 1025, nmf_cuda._sms(cuda))
    assert plan["workspace_floats"] > nmf_cuda._WS_KEPT
    kept = dict(nmf_cuda._workspaces)
    Pb = nmf_cuda.nmf_recon(H, A)
    assert nmf_cuda._workspaces.keys() == kept.keys()
    assert all(nmf_cuda._workspaces[k] is v for k, v in kept.items())
    assert _rel(Pb, nmf_cuda.nmf_recon_plain(H, A)) <= 1e-5
    assert torch.equal(Pb, nmf_cuda.nmf_recon(H, A))


# the quality preset's recon: K = 71,680 (the padded 20-pair dictionary and
# its four VTLP copies, each block ending in zero rows) at D = 201, for a
# 3.9 s request and for the longest, 6.8 s
NMF_QUALITY = [(620, 71_680, 201), (1360, 71_680, 201)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", NMF_QUALITY)
def test_nmf_recon_at_the_quality_shapes(cuda, F, K, D):
    A, H, _ = _nmf_inputs(F, K, D, cuda)
    A.view(5, K // 5, D)[:, -393:] = 0.0
    P = nmf_cuda.nmf_recon(H, A)
    assert _rel(P, nmf_cuda.nmf_recon_plain(H, A)) <= 1e-5
    assert torch.equal(P, nmf_cuda.nmf_recon(H, A))


# the KL update's shapes: the quality cell's (K = 71,680, D = 201), and edges:
# F within one 128-row tile (F = 37, 16, 13), K % 4 != 0 (4-byte H and Aᵀ
# copies, element stores; 7681, 130, 1030), a short last K tile, fewer d
# slices than the ring (D = 25, 7), and R staged in d slices beside Aᵀ
# (D = 1025, 2500)
NMF_KL = [(620, 71_680, 201), (1360, 71_680, 201), (37, 7681, 201), (16, 14_336, 201),
          (100, 130, 25), (65, 300, 7), (620, 14_336, 1025), (65, 1030, 1025), (13, 300, 2500)]


def _kl_inputs(F, K, D, device):
    """R > 0, A ≥ 0 with zero rows at the end (den = EPS there, the quotient
    0) as the update reads it (Aᵀ), H in [0, 0.05) and den as the solve makes
    it (l1 = 0)."""
    rng = np.random.default_rng(F + K + D)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    A[K - max(1, K // 10):] = 0.0
    A = torch.as_tensor(A, device=device)
    R = torch.as_tensor(np.abs(rng.standard_normal((F, D))).astype(np.float32), device=device)
    H = torch.as_tensor(rng.uniform(0, 0.05, (F, K)).astype(np.float32), device=device)
    den = A.sum(dim=1)[None, :]
    return R, nmf_cuda.nmf_kl_operand(A), H, torch.where(den == 0.0, nmf_cuda.EPS, den)


def _rel_each(got, ref):
    """max |got − ref| / |ref| over ref's non-zero elements; inf where got
    is not 0 where ref is."""
    nz = ref != 0
    if not bool((got[~nz] == 0).all()):
        return float("inf")
    return float(((got - ref).abs()[nz] / ref.abs()[nz]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,D", NMF_KL)
def test_nmf_kl_update_matches_twin(cuda, F, K, D):
    R, At, H, den = _kl_inputs(F, K, D, cuda)
    ref = nmf_cuda.nmf_kl_update_plain(R, At, H, den)
    before = nmf_cuda.nmf_kl_update.launches
    got = nmf_cuda.nmf_kl_update(R, At, H, den)
    assert nmf_cuda.nmf_kl_update.launches == before + 1
    assert _rel_each(got, ref) <= 1e-5
    assert bool((got[:, K - max(1, K // 10):] == 0).all())
    assert torch.equal(got, nmf_cuda.nmf_kl_update(R, At, H, den))   # no atomics: the same bits
    Hin = H.clone()
    assert nmf_cuda.nmf_kl_update(R, At, Hin, den, out=Hin) is Hin
    assert torch.equal(Hin, got)


@pytest.mark.cuda
def test_nmf_kl_update_in_place_on_misaligned_views(cuda):
    """H (in place), out and Aᵀ as contiguous views 4 bytes into their
    storage: the kernel copies H and Aᵀ in 4-byte pieces and stores element
    by element, and gives the bits of its 16-byte path on aligned tensors;
    Aᵀ as a transposed view of A is refused."""
    F, K, D = 100, 700, 201
    R, At, H, den = _kl_inputs(F, K, D, cuda)
    aligned = nmf_cuda.nmf_kl_update(R, At, H, den)
    with pytest.raises(ValueError):
        nmf_cuda.nmf_kl_update(R, At.T.contiguous().T, H, den)
    abuf = torch.empty(D * K + 1, device=cuda)
    Atv = abuf[1:].view(D, K)
    assert Atv.is_contiguous() and Atv.data_ptr() % 16 == 4
    Atv.copy_(At)
    assert torch.equal(nmf_cuda.nmf_kl_update(R, Atv, H, den), aligned)
    hbuf = torch.empty(F * K + 1, device=cuda)
    Hv = hbuf[1:].view(F, K)
    assert Hv.is_contiguous() and Hv.data_ptr() % 16 == 4
    Hv.copy_(H)
    assert nmf_cuda.nmf_kl_update(R, At, Hv, den, out=Hv) is Hv
    assert torch.equal(Hv, aligned)
    obuf = torch.empty(F * K + 1, device=cuda)
    Ov = obuf[1:].view(F, K)
    assert torch.equal(nmf_cuda.nmf_kl_update(R, At, H, den, out=Ov), aligned)
    assert _rel_each(aligned, nmf_cuda.nmf_kl_update_plain(R, At, H, den)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tol,max_iter", [(0.0, 30), (1e-4, 150)])
def test_kl_solve_takes_its_recon_from_the_kernel(cuda, monkeypatch, tol, max_iter):
    """The KL solve launches ``nmf_recon`` 1 + n_iter times (a check's P
    feeds the next step), ``nmf_kl_update`` n_iter times and ``nmf_update``
    never. With the tolerance off its H agrees with the same solve on
    cuBLAS products (the recon and the update swapped for their twins)
    within 1e-4 relative L2: each recon is within 1e-5 of its twin, each
    update within 1e-5 per element, and 30 multiplicative steps carry that
    along."""
    from exemplars_vc_tpu_torch.factorize import nmf

    A, _, _ = _nmf_inputs(200, 7168, 201, cuda)
    A[-300:] = 0.0
    rng = np.random.default_rng(3)
    X = torch.as_tensor(np.abs(rng.standard_normal((200, 201))).astype(np.float32), device=cuda)
    recons, updates = nmf_cuda.nmf_recon.launches, nmf_cuda.nmf_update.launches
    kl_updates = nmf_cuda.nmf_kl_update.launches
    st = nmf.nmf_activations(X, A, beta_loss="kl", tol=tol, max_iter=max_iter)
    assert nmf_cuda.nmf_recon.launches - recons == 1 + st.n_iter
    assert nmf_cuda.nmf_kl_update.launches - kl_updates == st.n_iter
    assert nmf_cuda.nmf_update.launches == updates
    assert bool(torch.isfinite(st.H).all()) and bool((st.H >= 0).all())
    if tol == 0.0:
        monkeypatch.setattr(nmf, "nmf_recon", nmf_cuda.nmf_recon_plain)
        monkeypatch.setattr(nmf, "nmf_kl_update", nmf_cuda.nmf_kl_update_plain)
        ref = nmf.nmf_activations(X, A, beta_loss="kl", tol=tol, max_iter=max_iter)
        assert st.n_iter == ref.n_iter == max_iter
        assert float(torch.linalg.norm(st.H - ref.H) / torch.linalg.norm(ref.H)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["nmf_recon", "nmf_mu_fused", "nmf_update", "nmf_kl_update"])
@pytest.mark.parametrize("fault", ["cluster", "smem", "tile"])
def test_nmf_plan_that_cannot_launch_raises(cuda, kernel, fault):
    """A cluster above the portable 8 (for the two updates, any cluster; for
    the recon, whose CTAs meet at a grid barrier, more CTAs than the card
    holds at once), shared memory above the opt-in limit or a tile the source
    does not compile is refused before any launch."""
    F, K, D = 100, 700, 201
    A, H, Num = _nmf_inputs(F, K, D, cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = {"nmf_recon": nmf_cuda.nmf_recon_plan, "nmf_mu_fused": nmf_cuda.nmf_mu_fused_plan,
            "nmf_update": nmf_cuda.nmf_update_plan,
            "nmf_kl_update": nmf_cuda.nmf_kl_update_plan}[kernel](F, K, D, n_sms)
    if fault == "cluster" and kernel in ("nmf_update", "nmf_kl_update"):
        plan = dict(plan, split=2)
    elif fault == "cluster" and kernel == "nmf_recon":
        ctas = 4 * n_sms   # one CTA an SM fits: four do not
        plan = dict(plan, single_ctas=0, range_ctas=ctas, range_units=plan["units"],
                    grid=(ctas, 1, 1))
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
        elif kernel == "nmf_kl_update":
            nmf_cuda.nmf_kl_update(torch.rand((F, D), device=cuda), nmf_cuda.nmf_kl_operand(A),
                                   H, A.sum(dim=1)[None, :], out=out, plan=plan)
        else:
            nmf_cuda.nmf_mu_fused(H, A, Num, out=out, plan=plan)
    torch.cuda.synchronize()
    assert fn.launches == before and bool((out == -1.0).all())
    with pytest.raises(RuntimeError):
        nmf_cuda.co_resident_clusters(kernel, plan, F, K, D)


# n_fft 48 = 16 x 3: a radix-3 pass (M = 24 = 8 x 3)
@pytest.mark.cuda
@pytest.mark.parametrize("F,n_fft,hop", [(13, 32, 8), (100, 64, 16), (300, 48, 16),
                                         (688, 400, 80)])
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
    # other tiles (fewer CTAs, more frames each) compute the same bits
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = griffin_lim_cuda.gl_fused_plan(F, n_fft, hop, n_sms)
    for other in (dict(plan, tile=plan["tile"] + 1), dict(plan, tile=plan["tile"] + 2)):
        got2 = griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, 6, 0.9, _plan=other)
        assert torch.equal(got2, got), other


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
    # a grid larger than the co-resident CTA count would deadlock: refused
    # before launch, nothing counted
    plan = dict(griffin_lim_cuda.gl_fused_plan(10, 400, 80, 132), tile=1)
    F = griffin_lim_cuda.gl_fused_resident(plan, 400, 80)["resident"] + 1
    before = griffin_lim_cuda.gl_angles_fused.launches
    with pytest.raises(RuntimeError, match="evc_gl_fused"):
        griffin_lim_cuda.gl_angles_fused(torch.ones((F, 201), device=cuda),
                                         torch.ones((F, 201), dtype=torch.complex64,
                                                    device=cuda), 400, 80, 2, 0.9, _plan=plan)
    assert griffin_lim_cuda.gl_angles_fused.launches == before


@pytest.mark.cuda
def test_gl_fused_plan_matches_the_card(cuda):
    """The pure plan's shared memory is what the C side computes, and its
    grid fits the card at once (a cooperative launch needs that)."""
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for F, n_fft, hop in ((688, 400, 80), (300, 48, 16), (13, 32, 8), (1409, 400, 80)):
        plan = griffin_lim_cuda.gl_fused_plan(F, n_fft, hop, n_sms)
        got = griffin_lim_cuda.gl_fused_resident(plan, n_fft, hop)
        assert got["smem_bytes"] == plan["smem_bytes"]
        assert plan["grid"] <= got["resident"]


# the centered kernel at the served shapes (tiles 5 and 11, 300 iterations)
# and the stream's (tile 1: frame 0's mirror sums frames beyond its r − 1
# neighbours; 60 iterations). After 6 iterations it is held by
# test_gl_fused_matches_twin's gates (rel L2 ≤ 1e-4; max |phase diff| ≤
# 1e-4 where F < 50) to the twin run in float64, the arithmetic the kernel
# shares, over all frames and again over the 2r frames at each end, the
# only ones the reflect pad's mirror changes (r = n_fft/hop): a mirror one
# sample off reads ≥ 0.37 there. Not to the float32 twin: at 1361 frames
# its own rounding flips the phase of bins 197–199 in frames 844–847 (rel
# L2 5.8e-3 from the float64 twin, either projection), where the kernel's
# numpy model reads 1.9e-6 (CPU). The float32 twin still sets the
# mean-phase rule, after 6 iterations and after the long run.
@pytest.mark.cuda
@pytest.mark.parametrize("F,n_iter", [(620, 300), (1361, 300), (48, 60)])
def test_gl_fused_centered_matches_twin(cuda, F, n_iter):
    n_fft, hop = 400, 80
    rng = np.random.default_rng(F + 1)
    nb = n_fft // 2 + 1
    mag = np.abs(rng.standard_normal((F, nb))).astype(np.float32)
    mag[[0, F // 2]] = 0.0
    ang = np.exp(2j * np.pi * rng.random((F, nb))).astype(np.complex64)
    mag, ang = torch.as_tensor(mag, device=cuda), torch.as_tensor(ang, device=cuda)

    def runs(n):
        got = griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, n, 0.9, center=True)
        ref = griffin_lim_cuda.gl_angles_fused_plain(mag, ang, n_fft, hop, n, 0.9, center=True)
        ref64 = griffin_lim_cuda.gl_angles_fused_plain(mag.double(), ang.to(torch.complex128),
                                                       n_fft, hop, n, 0.9, center=True)
        torch.cuda.synchronize()
        e_k64 = float((got - ref64).abs().mean())
        e_p64 = float((ref - ref64).abs().mean())
        assert e_k64 <= 2 * e_p64 + 1e-7, (n, e_k64, e_p64)
        return got, ref64.to(torch.complex64)

    got, ref64 = runs(6)
    r2 = 2 * (n_fft // hop)
    ends = torch.tensor(sorted(set(range(min(F, r2))) | set(range(max(F - r2, 0), F))),
                        device=cuda)
    for rows in (slice(None), ends):
        a, b = got[rows], ref64[rows]
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-4
    if F < 50:
        assert float((got - ref64).abs().max()) <= 1e-4
    got, _ = runs(n_iter)
    # the centered and uncentered kernels share every frame's arithmetic but
    # not their fixed points
    assert not torch.equal(got, griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, n_iter,
                                                                 0.9))
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = griffin_lim_cuda.gl_fused_plan(F, n_fft, hop, n_sms, center=True)
    got2 = griffin_lim_cuda.gl_angles_fused(mag, ang, n_fft, hop, n_iter, 0.9, center=True,
                                            _plan=dict(plan, tile=plan["tile"] + 1))
    assert torch.equal(got2, got)


@pytest.mark.cuda
def test_griffin_lim_new_length_takes_the_fused_kernel(cuda):
    """A served length: one launch of the centered kernel and no span of
    its own; its phases no farther from the float64 twin than the eager
    float32 loop's (the same mean-phase rule)."""
    from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
    from exemplars_vc_tpu_torch.dsp.stft import stft

    rng = np.random.default_rng(13)
    S = stft(torch.as_tensor(rng.standard_normal(16400).astype(np.float32), device=cuda))
    mag = torch.abs(S) * 1.1
    fused = griffin_lim.fused
    launches = griffin_lim_cuda.gl_angles_fused.launches
    recs = _traced_spans(lambda: griffin_lim(mag, n_iter=25, init_phase=S))
    assert recs == []
    assert griffin_lim.fused == fused + 1
    assert griffin_lim_cuda.gl_angles_fused.launches == launches + 1
    y, a = griffin_lim(mag, n_iter=25, init_phase=S, return_phase=True)
    y_e, a_e = griffin_lim(mag, n_iter=25, init_phase=S, return_phase=True, _fused=False)
    assert y.shape == y_e.shape
    a0 = torch.where(S.abs() > 0, S / torch.clamp(S.abs(), min=1e-16),
                     torch.ones((), dtype=torch.complex64, device=cuda))
    a64 = griffin_lim_cuda.gl_angles_fused_plain(mag.double(), a0.to(torch.complex128), 400,
                                                 80, 25, 0.9, center=True)
    e_f = float((a - a64).abs().mean())
    e_e = float((a_e - a64).abs().mean())
    assert e_f <= 2 * e_e + 1e-7, (e_f, e_e)


@pytest.mark.cuda
@pytest.mark.parametrize("hop,n_frames", [(96, 200), (80, 2509)])
def test_refused_shapes_take_the_eager_loop(cuda, hop, n_frames):
    """A shape the fused kernel refuses (a hop that does not divide n_fft;
    one frame more than its tiles hold at hop 80) runs the eager loop on the
    card: no fused call or launch, bit-equal to ``_fused=False``, and no
    memory held once the result is freed."""
    from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
    from exemplars_vc_tpu_torch.dsp.stft import stft

    rng = np.random.default_rng(11)
    x = rng.standard_normal((n_frames - 1) * hop).astype(np.float32)
    S = stft(torch.as_tensor(x, device=cuda), hop_length=hop)
    assert S.shape[0] == n_frames
    mag = torch.abs(S) * 1.1
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert not griffin_lim_cuda.fused_route(n_frames, 400, hop, 25, n_sms)
    torch.cuda.synchronize(cuda)
    mem0 = torch.cuda.memory_allocated(cuda)
    fused, launches = griffin_lim.fused, griffin_lim_cuda.gl_angles_fused.launches
    y, a = griffin_lim(mag, hop_length=hop, n_iter=25, init_phase=S, return_phase=True)
    assert griffin_lim.fused == fused
    assert griffin_lim_cuda.gl_angles_fused.launches == launches
    y_e, a_e = griffin_lim(mag, hop_length=hop, n_iter=25, init_phase=S, return_phase=True,
                           _fused=False)
    assert torch.equal(a, a_e) and torch.equal(y, y_e)
    del y, a, y_e, a_e
    torch.cuda.synchronize(cuda)
    assert torch.cuda.memory_allocated(cuda) == mem0


# -- the program's spans on the card --------------------------------------------

SPAN_CHUNK = 16


@pytest.fixture(scope="module")
def card_converters(tmp_path_factory):
    """{kind: Converter} on the card over the synthetic corpus, prepared on
    first use (the tests ask for the ``cuda`` fixture first, so nothing is
    built without a card)."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from torch_corpus import OVERRIDES, write_synthetic_corpus

    data, src, _ = write_synthetic_corpus(tmp_path_factory.mktemp("span_corpus"))
    store = ArtifactStore(str(tmp_path_factory.mktemp("span_store")))
    made = {}

    def get(kind):
        if kind not in made:
            over = OVERRIDES + (["data.use_stft=false"] if kind == "world" else [])
            made[kind] = Converter(load_config(overrides=over), store, data, nb_file=3,
                                   device="cuda")
        return made[kind], src
    return get


def _traced_spans(fn):
    from torch.profiler import ProfilerActivity, profile

    from exemplars_vc_tpu_torch.obs.profiling import cursor, spans

    with profile(activities=[ProfilerActivity.CPU]):
        before = cursor()
        fn()
        after = cursor()
    return spans(before, after)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stft", "world", "stream"])
def test_span_device_times_lie_within_their_roots(cuda, card_converters, kind):
    """Every span of a conversion (a push) on the card has its device time,
    from the events on the current stream; a child's lies within its
    root's, and the three stages (two in a push) within the root."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.dsp.stft import stft
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter
    from torch_corpus import OVERRIDES

    conv, src = card_converters("stft" if kind == "stream" else kind)
    if kind == "stream":
        x, _ = read_wav(src)
        S = stft(torch.as_tensor(x, device=cuda), n_fft=400, hop_length=80)
        A, B = conv.dicts["stft"]
        sc = StreamingConverter(load_config(overrides=OVERRIDES), A, B, synth_iters=20,
                                device=cuda)

        def call():
            for k in range(0, 3 * SPAN_CHUNK, SPAN_CHUNK):
                sc.push(torch.abs(S[k: k + SPAN_CHUNK]), S[k: k + SPAN_CHUNK])
    else:
        def call():
            conv.convert(src, synth_iters=20)
    recs = _traced_spans(call)
    roots = {s["id"]: s for s in recs if s["parent"] is None}
    assert {r["name"] for r in roots.values()} == {"push" if kind == "stream" else "convert"}
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0.0 for s in recs)
    for s in recs:
        assert s["device_ms"] <= roots[s["root"]]["device_ms"]
    for root in roots.values():
        stages = [s for s in recs if s["parent"] == root["id"]]
        assert len(stages) == (2 if kind == "stream" else 3)
        assert sum(s["device_ms"] for s in stages) <= root["device_ms"]


@pytest.mark.cuda
def test_quality_spans_on_the_card(cuda, tmp_path):
    """A conversion under the quality preset on the card: its ``nmf`` span
    says it solved KL and made 1 + n_iter recons, and the ``h_smooth``
    span sits in its ``solve`` with a device time within the solve's."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from torch_corpus import OVERRIDES, write_synthetic_corpus

    data, src, _ = write_synthetic_corpus(tmp_path / "corpus")
    conv = Converter(load_config(preset="quality", overrides=OVERRIDES),
                     ArtifactStore(str(tmp_path / "store")), data, nb_file=3, device=cuda)
    recons = nmf_cuda.nmf_recon.launches
    recs = _traced_spans(lambda: conv.convert(src, synth_iters=20))
    (nmf,) = [s for s in recs if s["name"] == "nmf"]
    (solve,) = [s for s in recs if s["name"] == "solve"]
    (smooth,) = [s for s in recs if s["name"] == "h_smooth"]
    assert nmf["attrs"]["beta"] == "kl"
    assert nmf_cuda.nmf_recon.launches - recons == 1 + nmf["attrs"]["n_iter"]
    assert smooth["parent"] == solve["id"] and smooth["attrs"]["s"] == 2
    assert smooth["attrs"]["K"] == conv.dicts["stft"][0].shape[0] == nmf["attrs"]["K"]
    assert 0.0 <= smooth["device_ms"] <= solve["device_ms"]
