"""The port's least-squares activation solvers against the JAX package's
(``exemplars_vc_tpu/factorize/qrmf.py``) on the same seeded numpy inputs.

Tolerance: 1e-4 relative L2 on H. Both sides run float32 QR decompositions
and triangular solves (LAPACK routines that pivot and sum in their own
orders) or a few hundred float32 FISTA steps; measured ~1e-6. The
underdetermined QR solve (K > D) is also held to the minimum-norm solution
of ``numpy.linalg.lstsq`` in float64, within 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.factorize import qrmf as jqrmf
from exemplars_vc_tpu.pipelines import convert as jconvert
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.factorize import qrmf as tqrmf
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from torch_corpus import rel_l2


def _problem(seed, F, K, D):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal((F, D))).astype(np.float32),
            np.abs(rng.standard_normal((K, D))).astype(np.float32))


@pytest.mark.parametrize("K,D", [(12, 25), (25, 25), (60, 25)],
                         ids=["K<D", "K=D", "K>D"])
def test_qr_activations_matches_jax(K, D):
    X, A = _problem(0, 18, K, D)
    ref = np.asarray(jqrmf.qr_activations(jnp.asarray(X), jnp.asarray(A)))
    got = tqrmf.qr_activations(torch.as_tensor(X), torch.as_tensor(A))
    assert got.shape == (18, K) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), ref) <= 1e-4
    if K > D:   # the minimum-norm solution of the underdetermined system
        lstsq = np.linalg.lstsq(A.astype(np.float64).T, X.astype(np.float64).T, rcond=None)[0].T
        assert rel_l2(got.numpy(), lstsq) <= 1e-3
        np.testing.assert_allclose(got.numpy() @ A, X, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_iter", [1, 50, 200])
def test_nnls_activations_matches_jax(n_iter):
    X, A = _problem(1, 20, 48, 25)
    A[40:] = 0.0
    ref = np.asarray(jqrmf.nnls_activations(jnp.asarray(X), jnp.asarray(A), n_iter=n_iter))
    got = tqrmf.nnls_activations(torch.as_tensor(X), torch.as_tensor(A), n_iter=n_iter)
    assert (got >= 0).all() and (got[:, 40:] == 0).all()     # zero rows stay inert
    assert rel_l2(got.numpy(), ref) <= 1e-4
    if n_iter == 200:   # FISTA has reached the neighbourhood of the NNLS optimum
        from scipy.optimize import nnls
        best = np.stack([nnls(A[:40].astype(np.float64).T, x.astype(np.float64))[0] for x in X])
        fit = lambda H: np.linalg.norm(X - H @ A[:40])
        assert fit(got.numpy()[:, :40]) <= 1.02 * fit(best) + 1e-3


@pytest.mark.parametrize("overrides,n_iter", [
    (["nmf.solver=cd"], 10 * 20), (["nmf.solver=cd", "nmf.max_iter=30"], 300),
    (["nmf.solver=nnls", "nmf.nnls_iters=40"], 40), (["nmf.solver=qr"], 1),
    (["nmf.solver=qrmf"], 1),
], ids=["cd", "cd-max_iter", "nnls-iters", "qr", "qrmf"])
def test_solver_dispatch_matches_jax(overrides, n_iter):
    """``_solve_activations`` with the least-squares solvers: the iteration
    budget ``nnls_iters or 10·max(max_iter, 20)``, the QR result clamped at
    0, the Frobenius error of the returned H."""
    X, A = _problem(2, 16, 40, 25)
    ov = ["nmf.max_iter=10"] + overrides
    ref = jconvert._solve_activations(jnp.asarray(X), jnp.asarray(A), jload_config(overrides=ov))
    got = tconvert._solve_activations(torch.as_tensor(X), torch.as_tensor(A),
                                      load_config(overrides=ov))
    assert got.n_iter == int(ref.n_iter) == n_iter
    assert (got.H >= 0).all()
    assert rel_l2(got.H.numpy(), ref.H) <= 1e-4
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)
