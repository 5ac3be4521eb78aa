"""The port's DTW and exemplar gathers against the JAX reference.

The DP is min/add only, so on the same cost matrix the plain twin's
direction codes and costs must EQUAL the Pallas kernel's (interpret mode)
and the paths must equal the JAX backtrace's. Where each side computes its
own cost matrix (dtw_batch end to end), the costs agree to float32 rounding
(rtol 1e-5) and, on continuous random features, the paths are still equal.
The CUDA kernels themselves are held to these twins in
``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.align import dtw_batch as jdtw_batch
from exemplars_vc_tpu.align.dtw import BIG, _backtrace, _skew
from exemplars_vc_tpu.align.dtw import dtw as jdtw
from exemplars_vc_tpu.align.dtw import pairwise_sqdist as jsqdist
from exemplars_vc_tpu.align.dtw_pallas import dtw_wavefront_pallas
from exemplars_vc_tpu.align.exemplar import build_exemplar_dicts_padded as jbuild
from exemplars_vc_tpu_torch.align import dtw_cuda
from exemplars_vc_tpu_torch.align.dtw import dtw, dtw_batch, pairwise_sqdist
from exemplars_vc_tpu_torch.align.exemplar import build_exemplar_dicts_padded, gather_aligned

LENS = np.array([[48, 48], [30, 41], [17, 23], [40, 12]], np.int32)


def _features(seed, n=4, ta=48, tb=48, d=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, ta, d)).astype(np.float32),
            rng.standard_normal((n, tb, d)).astype(np.float32))


def test_pairwise_sqdist_matches_jax():
    fa, fb = _features(0, d=20)
    got = pairwise_sqdist(torch.as_tensor(fa), torch.as_tensor(fb)).numpy()
    ref = np.stack([np.asarray(jsqdist(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(fa, fb)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * ref.max())
    assert (got >= 0).all()


def test_wavefront_twin_equals_pallas_kernel():
    fa, fb = _features(1)
    n, ta, tb = fa.shape[0], fa.shape[1], fb.shape[1]
    C = np.stack([np.asarray(jsqdist(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(fa, fb)])
    valid = ((np.arange(ta)[None, :, None] < LENS[:, 0, None, None])
             & (np.arange(tb)[None, None, :] < LENS[:, 1, None, None]))
    sk = jnp.stack([_skew(jnp.asarray(c)) for c in np.where(valid, C, BIG)])
    cost_ref, dirs_ref = dtw_wavefront_pallas(sk, jnp.asarray(LENS), interpret=True)
    cost, dirs = dtw_cuda.dtw_wavefront(torch.as_tensor(C), torch.as_tensor(LENS))
    assert dirs.shape == (n, ta + tb - 1, ta) and dirs.dtype == torch.int8
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(dirs_ref)[:, : ta + tb - 1, :ta])
    np.testing.assert_array_equal(cost.numpy(), np.asarray(cost_ref))

    # the backtrace twin walks the Pallas codes to the JAX backtrace's paths
    pi, pj, plen = dtw_cuda.dtw_backtrace(dirs, torch.as_tensor(LENS))
    for k in range(n):
        ri, rj, rl = _backtrace(jnp.asarray(dirs.numpy()[k]), jnp.int32(LENS[k, 0]),
                                jnp.int32(LENS[k, 1]), ta + tb - 1)
        assert int(plen[k]) == int(rl)
        np.testing.assert_array_equal(pi[k].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pj[k].numpy(), np.asarray(rj))


def test_tie_order_diag_up_left():
    # an all-zero cost matrix ties every cell: diagonal moves win everywhere
    C = torch.zeros((1, 5, 5))
    lens = torch.tensor([[5, 5]], dtype=torch.int32)
    cost, dirs = dtw_cuda.dtw_wavefront(C, lens)
    pi, pj, plen = dtw_cuda.dtw_backtrace(dirs, lens)
    assert float(cost[0]) == 0.0 and int(plen[0]) == 5
    assert pi[0, :5].tolist() == pj[0, :5].tolist() == [0, 1, 2, 3, 4]
    assert (pi[0, 5:] == -1).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_dtw_batch_matches_jax(seed):
    fa, fb = _features(seed, ta=64, tb=56, d=20)
    la, lb = np.array([64, 50, 31, 9], np.int32), np.array([56, 44, 40, 15], np.int32)
    ref = jdtw_batch(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(la), jnp.asarray(lb))
    got = dtw_batch(torch.as_tensor(fa), torch.as_tensor(fb), torch.as_tensor(la),
                    torch.as_tensor(lb))
    for name in ("path_i", "path_j", "path_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(ref.distance), rtol=1e-5)
    np.testing.assert_allclose(got.raw_distance.numpy(), np.asarray(ref.raw_distance), rtol=1e-5)


@pytest.mark.parametrize("band", [None, 6])
def test_single_pair_dtw_matches_jax(band):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((40, 26)).astype(np.float32)
    b = rng.standard_normal((33, 26)).astype(np.float32)
    ref = jdtw(jnp.asarray(a), jnp.asarray(b), band=band)
    got = dtw(torch.as_tensor(a), torch.as_tensor(b), band=band)
    assert int(got.path_len) == int(ref.path_len)
    np.testing.assert_array_equal(got.path_i.numpy(), np.asarray(ref.path_i))
    np.testing.assert_array_equal(got.path_j.numpy(), np.asarray(ref.path_j))
    np.testing.assert_allclose(float(got.distance), float(ref.distance), rtol=1e-5)


def test_exemplar_dicts_equal_jax():
    rng = np.random.default_rng(5)
    fa = rng.standard_normal((3, 32, 7)).astype(np.float32)
    fb = rng.standard_normal((3, 32, 7)).astype(np.float32)
    lens = np.array([[32, 30], [20, 25], [9, 12]], np.int32)
    r = jdtw_batch(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(lens[:, 0]),
                   jnp.asarray(lens[:, 1]))
    pi, pj = np.array(r.path_i), np.array(r.path_j)
    k_pad = 128
    Aj, Bj = jbuild(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(pi), jnp.asarray(pj),
                    k_pad=k_pad)
    At, Bt = build_exemplar_dicts_padded(torch.as_tensor(fa), torch.as_tensor(fb),
                                         torch.as_tensor(pi), torch.as_tensor(pj), k_pad=k_pad)
    assert At.shape == (k_pad, 7)
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
    k_true = int(np.asarray(r.path_len).sum())
    assert (At[k_true:] == 0).all() and (At[:k_true].abs().sum(1) > 0).all()
    g = gather_aligned(torch.as_tensor(fa[0]), torch.as_tensor(pi[0]))
    np.testing.assert_array_equal(g.numpy(), fa[0][np.clip(pi[0], 0, 31)])


def test_wrappers_validate_inputs():
    C = torch.zeros((2, 5, 4))
    with pytest.raises(ValueError, match="lens out of range"):
        dtw_cuda._check_lens(torch.tensor([[6, 4], [1, 1]], dtype=torch.int32), 2, 5, 4,
                             C.device)
    with pytest.raises(ValueError, match="int32"):
        dtw_cuda._check_lens(torch.tensor([[5, 4], [1, 1]]), 2, 5, 4, C.device)
    assert dtw_cuda.fits_plan(1408) and not dtw_cuda.fits_plan(40000)


@pytest.mark.parametrize("band", [7, 64, None], ids=["7", "64", "Ta"])
@pytest.mark.parametrize("seed", [4, 5])
def test_banded_twin_equals_unbanded(seed, band):
    """The twin swept in row bands (the kernel's schedule past ``MAX_TA``
    rows: each band starts from the previous band's last row, the codes
    outside a band's diagonals stay 0) equals the unbanded twin byte for
    byte: codes and final costs, on seeded pairs with ragged lengths."""
    rng = np.random.default_rng(seed)
    n, ta, tb = 4, 150, 97
    C = pairwise_sqdist(torch.as_tensor(rng.standard_normal((n, ta, 5)).astype(np.float32)),
                        torch.as_tensor(rng.standard_normal((n, tb, 5)).astype(np.float32)))
    lens = torch.tensor([[ta, tb], [60, 97], [ta, 40], [1, 1]], dtype=torch.int32)
    cost, dirs = dtw_cuda.dtw_wavefront_plain(C, lens)
    rows = ta if band is None else band
    got_cost, got_dirs = dtw_cuda.dtw_wavefront(C, lens, band_rows=rows)   # CPU: the twin
    assert torch.equal(got_cost, cost) and torch.equal(got_dirs, dirs)
    paths = dtw_cuda.dtw_backtrace(got_dirs, lens)
    for got, ref in zip(paths, dtw_cuda.dtw_backtrace(dirs, lens)):
        assert torch.equal(got, ref)


def test_row_bands():
    assert dtw_cuda.row_bands(100, 7)[-2:] == [(91, 98), (98, 100)]
    assert dtw_cuda.row_bands(40_000) == [(0, 32_768), (32_768, 40_000)]
    assert dtw_cuda.row_bands(32_768) == [(0, 32_768)]
    for bad in (0, dtw_cuda.MAX_TA + 1):
        with pytest.raises(ValueError, match="outside"):
            dtw_cuda.row_bands(10, bad)

