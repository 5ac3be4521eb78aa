"""The port's sequence-parallel DTW (``parallel/sharded_long_dtw.py``)
against the JAX package's, on the JAX tests' cases
(``tests/test_sharded_long_dtw.py``).

The port runs in one world of eight processes on the CPU over gloo, spawned
once for the module; meshes of two and four ranks are its first ranks. The
JAX side runs in this process on the 8 virtual CPU devices. Paths equal the
JAX package's and the single-device DTW's; distances within the JAX tests'
1e-2 (the port's are the single sweep's to the byte, below); the
distance-only variant equals the path mode. The tile twin in a wavefront
schedule of tiles is byte-equal to one sweep on the same C.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.align import dtw as jdtw
from exemplars_vc_tpu.parallel import make_mesh as jmake_mesh
from exemplars_vc_tpu.parallel.sharded_long_dtw import sharded_dtw_long as jsharded_dtw_long
from exemplars_vc_tpu_torch.align import dtw_cuda
from exemplars_vc_tpu_torch.parallel import make_mesh
from exemplars_vc_tpu_torch.parallel.sharded_long_dtw import (
    backtrace_host,
    cost_strip,
    sharded_dtw_long,
)
from torch_parallel_workers import run_world

WORLD = 8

# name: (seed, ta, tb, dim, n_dev, col_block, keep_dirs)
CASES = {
    "match_2_64": (0, 128, 200, 6, 2, 64, True),
    "match_4_32": (0, 128, 200, 6, 4, 32, True),
    "match_8_64": (0, 128, 200, 6, 8, 64, True),
    "padded_columns": (1, 64, 90, 4, 4, 32, True),
    "distance_only": (2, 64, 64, 4, 8, 32, False),
    "padded_path": (3, 128, 173, 5, 4, 48, True),
    "padded_distance_only": (3, 128, 173, 5, 4, 48, False),
}


def _pair(seed, ta, tb, dim):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ta, dim)).astype(np.float32),
            rng.standard_normal((tb, dim)).astype(np.float32))


@pytest.fixture(scope="module")
def world():
    cases = [("long_dtw", (*_pair(*c[:4]), *c[4:])) for c in CASES.values()]
    ranks = run_world(WORLD, cases)
    return {name: [r["cases"][i] for r in ranks] for i, name in enumerate(CASES)}


def _ranks(world, name):
    """The results of the mesh's ranks, all equal; the others took no part."""
    n_dev = CASES[name][4]
    got = world[name]
    assert all(r is None for r in got[n_dev:])
    for r in got[1:n_dev]:
        assert r["distance"] == got[0]["distance"]
        assert (r["dirs"] is None) == (got[0]["dirs"] is None)
        assert r["dirs"] is None or torch.equal(r["dirs"], got[0]["dirs"])
    return got[0]


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[6]])
def test_paths_match_jax(world, name):
    seed, ta, tb, dim, n_dev, col_block, _ = CASES[name]
    a, b = _pair(seed, ta, tb, dim)
    ref = jdtw(jnp.asarray(a), jnp.asarray(b))
    jdist, jdirs = jsharded_dtw_long(a, b, jmake_mesh(data=n_dev, dict_=1), col_block=col_block)
    got = _ranks(world, name)
    assert got["dirs"].shape == (ta, tb) and got["dirs"].dtype == torch.int8
    assert abs(got["distance"] - float(ref.raw_distance)) < 1e-2 * max(1.0, float(ref.raw_distance))
    assert abs(got["distance"] - jdist) < 1e-2 * max(1.0, jdist)
    pi, pj = backtrace_host(got["dirs"])
    jpi, jpj = backtrace_host(jdirs)
    np.testing.assert_array_equal(pi, jpi)
    np.testing.assert_array_equal(pj, jpj)
    pl = int(ref.path_len)
    np.testing.assert_array_equal(pi, np.asarray(ref.path_i[:pl]))
    np.testing.assert_array_equal(pj, np.asarray(ref.path_j[:pl]))
    assert pi[-1] == ta - 1 and pj[-1] == tb - 1


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[6]])
def test_codes_and_distance_equal_one_sweep(world, name):
    """On the same cost matrix (each rank's strip, ``cost_strip``), the
    ranks' codes and distance equal one sweep of the wavefront twin."""
    seed, ta, tb, dim, n_dev, col_block, _ = CASES[name]
    a, b = _pair(seed, ta, tb, dim)
    R = ta // n_dev
    b_pad = torch.zeros((-(-tb // col_block) * col_block, dim))
    b_pad[:tb] = torch.as_tensor(b)
    C = torch.cat([cost_strip(torch.as_tensor(a[q * R:(q + 1) * R]), b_pad, tb)
                   for q in range(n_dev)])[:, :tb].contiguous()
    cost, dirs = dtw_cuda.dtw_wavefront_plain(C[None], torch.tensor([[ta, tb]], dtype=torch.int32))
    got = _ranks(world, name)
    assert torch.equal(got["dirs"], dtw_cuda.tile_codes(dirs[0], ta, tb))
    assert got["distance"] == float(cost[0])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c[6]])
def test_distance_only_matches_jax(world, name):
    seed, ta, tb, dim, n_dev, col_block, _ = CASES[name]
    a, b = _pair(seed, ta, tb, dim)
    ref = jdtw(jnp.asarray(a), jnp.asarray(b))
    jdist, _ = jsharded_dtw_long(a, b, jmake_mesh(data=n_dev, dict_=1), col_block=col_block,
                                 keep_dirs=False)
    got = _ranks(world, name)
    assert got["dirs"] is None
    assert abs(got["distance"] - float(ref.raw_distance)) < 1e-2
    assert abs(got["distance"] - jdist) < 1e-2 * max(1.0, jdist)
    if name == "padded_distance_only":
        # on-the-fly tiles give the path mode's distance exactly (same DP,
        # same halo schedule)
        assert got["distance"] == _ranks(world, "padded_path")["distance"]


def test_one_process_and_refusals():
    """A mesh of one rank sweeps all rows itself; Ta must divide by the
    axis' size."""
    a, b = _pair(0, 40, 70, 3)
    d, dirs = sharded_dtw_long(a, b, make_mesh(), col_block=32, device="cpu")
    ref = jdtw(jnp.asarray(a), jnp.asarray(b))
    pi, pj = backtrace_host(dirs)
    pl = int(ref.path_len)
    np.testing.assert_array_equal(pi, np.asarray(ref.path_i[:pl]))
    assert abs(d - float(ref.raw_distance)) < 1e-2 * float(ref.raw_distance)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_dtw_long(a[:39], b, make_mesh(data=2, ranks=[0, 1]), device="cpu")


def _tiled(C, n_rows, col_block, codes=True):
    """The tile twin over (n_rows x column blocks) tiles in a wavefront
    order, halos handed on as the pipeline hands them."""
    ta, tb = C.shape
    R = ta // n_rows
    out = torch.zeros((ta, tb), dtype=torch.int8)
    bottoms, rights = {}, {}
    nb = -(-tb // col_block)
    for r in range(n_rows):
        for b in range(nb):
            c0, c1 = b * col_block, min(tb, (b + 1) * col_block)
            top = bottoms.get((r - 1, b))
            corner = bottoms[r - 1, b - 1][-1:] if r > 0 and b > 0 else None
            bot, right, cd = dtw_cuda.dtw_tile(C[r * R:(r + 1) * R, c0:c1], top, corner,
                                               rights.get((r, b - 1)),
                                               origin=r == 0 and b == 0, codes=codes)
            bottoms[r, b], rights[r, b] = bot, right
            if codes:
                out[r * R:(r + 1) * R, c0:c1] = cd
    return out, bottoms[n_rows - 1, nb - 1][-1]


@pytest.mark.parametrize("ta,tb,n_rows,col_block", [(12, 17, 3, 5), (16, 16, 4, 4),
                                                    (9, 20, 1, 7), (20, 9, 4, 3)])
def test_tile_twin_equals_one_sweep(ta, tb, n_rows, col_block):
    """The twin's tile mode (window, left and top halos, corner, right
    column) byte-equal to one sweep on the same C, with many ties (a third
    of the costs equal) so the tie order shows; codes=False gives the same
    last cost."""
    rng = np.random.default_rng(ta * tb)
    C = torch.as_tensor(rng.random((ta, tb)).astype(np.float32))
    C[torch.as_tensor(rng.random((ta, tb)) < 0.3)] = 0.5
    cost, dirs = dtw_cuda.dtw_wavefront_plain(C[None].contiguous(),
                                              torch.tensor([[ta, tb]], dtype=torch.int32))
    got, last = _tiled(C, n_rows, col_block)
    assert torch.equal(got, dtw_cuda.tile_codes(dirs[0], ta, tb))
    assert float(last) == float(cost[0])
    assert float(_tiled(C, n_rows, col_block, codes=False)[1]) == float(cost[0])
