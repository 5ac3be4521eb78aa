"""The port's ``parallel`` package against the JAX package's on the same
seeded numpy inputs.

The port runs in one world of four processes on the CPU over gloo
(``torch_parallel_workers.run_world``, spawned once for the module); its
meshes of two ranks are the world's first two. The JAX side runs in this
process on the 8 virtual CPU devices of ``tests/conftest.py``, on meshes of
the same shapes.

Tolerances: the sharded NMF's H within rtol 2e-3 / atol 1e-5 of the JAX
package's and its error within rtol 1e-3 (the all-reduce sums the ranks'
partials in another order than XLA's psum), n_iter equal; every rank of a
line holds the same bits. The sharded DTW batch: paths and lengths equal,
distances within rtol 1e-5. Mesh shapes, errors and placements exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.align import dtw_batch as jdtw_batch
from exemplars_vc_tpu.parallel import initialize_multihost as jinitialize_multihost
from exemplars_vc_tpu.parallel import make_mesh as jmake_mesh
from exemplars_vc_tpu.parallel import sharded_dtw_batch as jsharded_dtw_batch
from exemplars_vc_tpu.parallel import sharded_nmf_activations as jsharded_nmf
from exemplars_vc_tpu.parallel.mesh import replicate as jreplicate
from exemplars_vc_tpu.parallel.mesh import shard_batch as jshard_batch
from exemplars_vc_tpu_torch.parallel import initialize_multihost, make_mesh, shard_batch
from exemplars_vc_tpu_torch.parallel.mesh import replicate
from torch_parallel_workers import run_world

WORLD = 4

# (seed, F, K, D, tol, max_iter): the JAX tests' cases, the remainder
# iterations (25 = 2 blocks of 10 + 5), the early stop, and a run that stops
# on the tolerance at the conversion's width
NMF_CASES = {"match": (0, 24, 64, 16, 0.0, 50), "remainder": (0, 12, 16, 10, 0.0, 25),
             "early_stop": (1, 10, 32, 8, 1e-1, 150), "tol": (2, 40, 96, 201, 1e-4, 150)}
PLACEMENT_X = np.arange(32, dtype=np.float32).reshape(8, 4)
PLACEMENTS = [(4, 1), (2, 2)]


def _nmf_inputs(seed, F, K, D):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    X = np.abs(rng.standard_normal((F, D))).astype(np.float32)
    return X, A


def _dtw_inputs():
    rng = np.random.default_rng(2)
    N, T, D = 8, 36, 5
    fa = rng.standard_normal((N, T, D)).astype(np.float32)
    fb = rng.standard_normal((N, T, D)).astype(np.float32)
    la = rng.integers(10, T, N).astype(np.int32)
    lb = rng.integers(10, T, N).astype(np.int32)
    return fa, fb, la, lb


def _cases():
    cases = {}
    for name, (seed, F, K, D, tol, max_iter) in NMF_CASES.items():
        X, A = _nmf_inputs(seed, F, K, D)
        for n in (2, 4):
            cases[("nmf", name, n)] = ("nmf", (X, A, n, tol, max_iter))
    cases[("sharded_solve",)] = ("sharded_solve", (*_nmf_inputs(3, 20, 6, 12), 30))
    for data in (2, 4):
        cases[("dtw_batch", data)] = ("dtw_batch", (*_dtw_inputs(), data))
    for data, dict_ in PLACEMENTS:
        cases[("placement", data, dict_)] = ("placement", (PLACEMENT_X, data, dict_))
    return cases


@pytest.fixture(scope="module")
def world():
    """{case key: [each rank's result]} and the ranks' summaries, from one
    world of four processes."""
    cases = _cases()
    ranks = run_world(WORLD, list(cases.values()))
    by_key = {key: [r["cases"][i] for r in ranks] for i, key in enumerate(cases)}
    return by_key, [r["info"] for r in ranks]


def test_mesh_shapes_and_errors():
    """``make_mesh`` over eight ranks (the JAX mesh's eight devices) keeps
    the JAX function's shapes, defaults, sub-meshes and error texts."""
    ranks = list(range(8))
    mesh, jmesh = make_mesh(ranks=ranks), jmake_mesh()
    assert mesh.shape == dict(jmesh.shape) == {"data": 8, "dict": 1}
    m2, j2 = make_mesh(data=2, dict_=4, ranks=ranks), jmake_mesh(data=2, dict_=4)
    assert m2.shape == dict(j2.shape) and m2.axis_names == j2.axis_names
    np.testing.assert_array_equal(m2.devices, np.vectorize(lambda d: d.id)(j2.devices))
    assert make_mesh(data=2, dict_=1, ranks=ranks).devices.size == 2
    assert make_mesh(dict_=2, ranks=ranks).shape == dict(jmake_mesh(dict_=2).shape)
    for kw in (dict(data=3, dict_=3), dict(dict_=16), dict(data=16)):
        with pytest.raises(ValueError) as got:
            make_mesh(ranks=ranks, **kw)
        with pytest.raises(ValueError) as ref:
            jmake_mesh(**kw)
        assert str(got.value) == str(ref.value)
    # without a process group the world is this one process
    assert make_mesh().shape == {"data": 1, "dict": 1} and make_mesh().coordinate() == (0, 0)


def test_shard_and_replicate_in_one_process():
    xs = shard_batch(PLACEMENT_X, make_mesh(), device="cpu")
    xr = replicate(PLACEMENT_X, make_mesh(), device="cpu")
    np.testing.assert_array_equal(xs.numpy(), PLACEMENT_X)
    np.testing.assert_array_equal(xr.numpy(), PLACEMENT_X)


@pytest.mark.parametrize("data,dict_", PLACEMENTS)
def test_shard_and_replicate(world, data, dict_):
    """Each rank holds its block of rows along ``data`` (the same block on
    the ranks of a ``dict`` line), and the whole array gathers back, as the
    JAX package's sharded arrays do."""
    got = world[0][("placement", data, dict_)]
    jmesh = jmake_mesh(data=data, dict_=dict_)
    np.testing.assert_array_equal(np.asarray(jshard_batch(PLACEMENT_X, jmesh)), PLACEMENT_X)
    np.testing.assert_array_equal(np.asarray(jreplicate(PLACEMENT_X, jmesh)), PLACEMENT_X)
    rows = PLACEMENT_X.shape[0] // data
    for rank, r in enumerate(got):
        assert r["shape"] == dict(jmesh.shape)
        i = r["coordinate"][0]
        assert r["coordinate"] == (rank // dict_, rank % dict_)
        np.testing.assert_array_equal(r["local"].numpy(), PLACEMENT_X[i * rows:(i + 1) * rows])
        np.testing.assert_array_equal(r["full"].numpy(), PLACEMENT_X)
        np.testing.assert_array_equal(r["replicated"].numpy(), PLACEMENT_X)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(NMF_CASES))
def test_sharded_nmf_matches_jax(world, name, n):
    seed, F, K, D, tol, max_iter = NMF_CASES[name]
    X, A = _nmf_inputs(seed, F, K, D)
    ref = jsharded_nmf(jnp.asarray(X), jnp.asarray(A), jmake_mesh(data=1, dict_=n), tol=tol,
                       max_iter=max_iter)
    got = world[0][("nmf", name, n)]
    assert all(r is None for r in got[n:])          # ranks outside the mesh
    first = got[0]
    assert first["n_iter"] == int(ref.n_iter)
    if name == "remainder":
        assert first["n_iter"] == 25
    if name == "early_stop":
        assert first["n_iter"] < 150
    np.testing.assert_allclose(first["H"].numpy(), np.asarray(ref.H), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(first["error"], float(ref.error), rtol=1e-3)
    kl = K // n
    for rank, r in enumerate(got[:n]):
        assert r["H"].equal(first["H"]) and r["error"] == first["error"]
        assert r["H_loc"].equal(first["H"][:, rank * kl:(rank + 1) * kl])


def test_mu_sharded_solve_shrinks_its_axis(world):
    """The conversion's ``mu_sharded`` dispatch in a world of four over K =
    6: the axis shrinks to 3 ranks (the JAX package shrinks it the same
    way), the fourth takes no shard and receives H, n_iter and the error;
    every rank holds the same bits, within the tolerances of the JAX
    package's sharded solve on a mesh of 3."""
    X, A = _nmf_inputs(3, 20, 6, 12)
    ref = jsharded_nmf(jnp.asarray(X), jnp.asarray(A), jmake_mesh(data=1, dict_=3), tol=0.0,
                       max_iter=30)
    got = world[0][("sharded_solve",)]
    for r in got:
        assert r["n_iter"] == int(ref.n_iter) == 30
        assert r["H"].equal(got[0]["H"]) and r["error"] == got[0]["error"]
    np.testing.assert_allclose(got[0]["H"].numpy(), np.asarray(ref.H), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got[0]["error"], float(ref.error), rtol=1e-3)


@pytest.mark.parametrize("data", [2, 4])
def test_sharded_dtw_batch_matches_jax(world, data):
    fa, fb, la, lb = _dtw_inputs()
    ref = jsharded_dtw_batch(fa, fb, la, lb, jmake_mesh(data=data, dict_=1))
    single = jdtw_batch(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(la), jnp.asarray(lb))
    got = world[0][("dtw_batch", data)]
    assert all(r is None for r in got[data:])
    for r in got[:data]:
        np.testing.assert_allclose(r["raw_distance"].numpy(), np.asarray(ref.raw_distance),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["distance"].numpy(), np.asarray(ref.distance), rtol=1e-5)
        for k in ("path_len", "path_i", "path_j"):
            np.testing.assert_array_equal(r[k].numpy(), np.asarray(getattr(ref, k)))
            np.testing.assert_array_equal(r[k].numpy(), np.asarray(getattr(single, k)))
    with pytest.raises(ValueError, match="not divisible"):
        from exemplars_vc_tpu_torch.parallel import sharded_dtw_batch

        sharded_dtw_batch(fa[:3], fb[:3], la[:3], lb[:3], make_mesh(data=2, ranks=[0, 1]),
                          device="cpu")


def test_initialize_multihost_single_process():
    info = initialize_multihost(device="cpu")
    ref = jinitialize_multihost()
    assert sorted(info) == sorted(ref)
    assert info["process_count"] == ref["process_count"] == 1
    assert info["process_index"] == 0 and info["global_devices"] == 1
    if not torch.cuda.is_available():
        # a rank asked for the card (the default) without one raises
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            initialize_multihost()


def test_initialize_multihost_world(world):
    """Four processes joined by a TCP rendezvous: each reports its index and
    the world's size; a rank drives one device."""
    infos = world[1]
    assert [i["process_index"] for i in infos] == list(range(WORLD))
    assert all(i["process_count"] == WORLD == i["global_devices"] for i in infos)
    assert all(i["local_devices"] == 1 for i in infos)
