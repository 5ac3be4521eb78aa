"""The port's batch-sharded separation (``exemplars_vc_tpu_torch/parallel/
sharded_separate.py``) and a batch-sharded NSGT on the CPU: counterparts of
``tests/test_sharded_separate.py`` and of ``tests/test_parallel.py::
test_batch_sharded_nsgt_matches_single_device``, in one world of two
processes over gloo (``torch_parallel_workers.run_world``, spawned once for
the module), and the same inputs through the JAX package.

Tolerances: each mixture's images and NLL trace equal to the single-mixture
path (``fit_multichannel_nmf`` + Wiener images) on the same inits within
1e-5 relative (the ranks run one torch thread, this process two); against
the JAX package's ``separate_batch`` from the same key, after 6 EM iterations,
the NLL traces within 1e-5 relative (measured ≤ 2.1e-7) and the images
within 2e-3 (measured ≤ 7.3e-4): the mixtures are two pure tones at
n_fft 128, so most bins are near-silent, and the JAX package alone moves
its images by up to 3.2e-4 when its input is multiplied by
(1 + 1e-7·noise); the sharded NSGT equal to the single-process transform within
1e-5 relative and its inverse within 1e-3 of the signal, as the JAX test
holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from exemplars_vc_tpu.parallel.sharded_separate import separate_batch as jax_separate_batch
from exemplars_vc_tpu.separate.multichannel import random_spatial_init as jax_spatial_init
from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.dsp.nsgt import insgt, nsgt
from exemplars_vc_tpu_torch.parallel.sharded_separate import batch_inits, separate_batch
from exemplars_vc_tpu_torch.separate.multichannel import _wiener_images, fit_multichannel_nmf
from test_sharded_separate import _mixture_batch
from test_torch_separate import key_kw
from torch_parallel_workers import run_world

WORLD = 2
CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_batch_inits(key, M, J, F, K, N, C):
    """The W0, H0, R0 that JAX ``separate_batch(..., key=key)`` draws."""
    kw, kh, kr = jax.random.split(key, 3)
    W0 = np.array(jax.random.normal(kw, (M, J, F, K)) ** 2)
    H0 = np.array(jax.random.normal(kh, (M, J, K, N)) ** 2)
    R0 = np.stack([np.array(jax_spatial_init(k, J, F, C)) for k in jax.random.split(kr, M)])
    return W0, H0, R0


@pytest.fixture(scope="module")
def batch():
    X = np.array(_mixture_batch(M=4, seed=3))
    M, F, N, C = X.shape
    key = jax.random.PRNGKey(7)
    ranks = run_world(WORLD, [("separate_batch", (X, 8, None)),
                              ("separate_batch", (X, 6, np.asarray(key).astype(np.int64))),
                              ("nsgt", (NSGT_X,))])
    return dict(X=X, key=key, ranks=ranks)


NSGT_X = np.random.default_rng(7).standard_normal((4, 2560)).astype(np.float32)


# ---- counterparts of tests/test_sharded_separate.py ------------------------


def test_separate_batch_runs_sharded_over_mesh(batch):
    X = batch["X"]
    ranks = batch["ranks"]
    res = ranks[0]["cases"][0]
    images, nll = res["images"].numpy(), res["nll"].numpy()
    assert images.shape == (4, 2) + X.shape[1:] and nll.shape == (4, 8)
    assert res["placements"] == [("Shard", 0), ("Replicate", None)]
    assert tuple(res["local"].shape) == (2, 2) + X.shape[1:]
    assert (nll[:, -1] < nll[:, 0]).all()
    resid = np.abs(images.sum(axis=1) - X)
    assert resid.max() < 0.15 * np.abs(X).max()
    # every rank holds the same whole batch
    assert torch.equal(ranks[1]["cases"][0]["images"], res["images"])


def test_separate_batch_matches_single_mixture_path(batch):
    """Each mixture equals fitting it alone with the same inits (the
    default key's draws), and the JAX package's ``separate_batch`` from the
    same key, each package drawing its own inits."""
    X = batch["X"]
    M, F, N, C = X.shape
    W0, H0, R0 = batch_inits(prng.PRNGKey(0), M, 2, F, 2, N, C)
    res = batch["ranks"][0]["cases"][0]
    for m in range(M):
        single = fit_multichannel_nmf(X[m], n_sources=2, n_components=2, n_em=8,
                                      W_init=W0[m], H_init=H0[m], R_init=R0[m], device=CPU)
        img = _wiener_images(torch.from_numpy(X[m]), single.W, single.H, single.R)
        assert rel(res["images"][m].numpy(), img.numpy()) < 1e-5, m
        assert rel(res["nll"][m].numpy(), single.neg_log_like.numpy()) < 1e-5, m

    ref_img, ref_nll = jax_separate_batch(jnp.asarray(X), n_sources=2, n_components=2, n_em=6,
                                          key=batch["key"], mesh=jax_make_mesh(data=4, dict_=1))
    got = batch["ranks"][0]["cases"][1]
    for m in range(M):
        assert rel(got["images"][m].numpy(), np.asarray(ref_img)[m]) < 2e-3, m
        assert rel(got["nll"][m].numpy(), np.asarray(ref_nll)[m]) < 1e-5, m


@pytest.mark.parametrize("seed", [None, 7])
def test_separate_batch_from_a_key_matches_jax(seed):
    """No inits, in one process: W0 and H0 as one draw each and R0 from
    ``split(kr, M)``, from the default key (None) or another, in both
    packages; the tolerances of the JAX comparison above."""
    X = np.array(_mixture_batch(M=4, seed=3))
    M, F, N, C = X.shape
    jk, tk = key_kw(seed)
    k = 0 if seed is None else seed
    for got, want in zip(batch_inits(prng.PRNGKey(k), M, 2, F, 2, N, C),
                         jax_batch_inits(jax.random.PRNGKey(k), M, 2, F, 2, N, C)):
        assert rel(got.numpy(), want) < 1e-6
    ref_img, ref_nll = jax_separate_batch(jnp.asarray(X), n_sources=2, n_components=2, n_em=6,
                                          mesh=jax_make_mesh(data=4, dict_=1), **jk)
    img, nll = separate_batch(X, n_sources=2, n_components=2, n_em=6, device=CPU, **tk)
    for m in range(M):
        assert rel(img[m].numpy(), np.asarray(ref_img)[m]) < 2e-3, m
        assert rel(nll[m].numpy(), np.asarray(ref_nll)[m]) < 1e-5, m


def test_one_process_world_returns_plain_tensors():
    """Without a process group the batch runs in this process and returns
    plain tensors; a batch the data axis does not divide raises."""
    X = np.array(_mixture_batch(M=2, seed=1))
    images, nll = separate_batch(X, n_sources=2, n_components=2, n_em=3,
                                 key=prng.PRNGKey(0), device=CPU)
    assert type(images) is torch.Tensor and images.shape == (2, 2) + X.shape[1:]
    assert nll.shape == (2, 3)
    with pytest.raises(ValueError, match="not divisible"):
        from exemplars_vc_tpu_torch.parallel.mesh import Mesh

        separate_batch(X[:1], mesh=Mesh(np.array([[0], [1]]), {}), n_em=1, device=CPU)


# ---- counterpart of tests/test_parallel.py:120 -----------------------------


def test_batch_sharded_nsgt_matches_single_device(batch):
    want = nsgt(NSGT_X, sr=16000, fmin=150.0, device=CPU).numpy()
    for r in batch["ranks"]:
        got = r["cases"][2]
        assert rel(got["c"].numpy(), want) < 1e-5
        np.testing.assert_allclose(got["back"].numpy(), NSGT_X, atol=1e-3)
    back = insgt(want, NSGT_X.shape[-1], sr=16000, fmin=150.0, device=CPU).numpy()
    np.testing.assert_allclose(back, NSGT_X, atol=1e-3)


def test_entry_point_defaults_to_the_card():
    import inspect

    assert inspect.signature(separate_batch).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        separate_batch(np.zeros((1, 5, 4, 2), np.complex64), n_em=1)
