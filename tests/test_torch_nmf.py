"""The port's MU NMF against the JAX reference (XLA ``nmf_activations`` and
the Pallas kernels of ``nmf_activations_pallas`` in interpret mode, run as
``tests/test_pallas_kernels.py`` runs them), and against sklearn as
``tests/test_nmf.py`` holds the JAX package.

Tolerance: both sides run float32 matmuls that sum in different orders, and
every MU step multiplies those rounding differences into H; after 40
iterations H agrees elementwise within rtol 1e-4 (measured ~1e-5 against
XLA, ~2e-6 against the Pallas interpreter), the error within 1e-4 relative,
and the tol cadence stops at the same iteration. On the CPU the recon and
update wrappers run their plain twins; the CUDA kernels are held to those
twins in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.factorize.nmf import _mu_step_frobenius
from exemplars_vc_tpu.factorize.nmf import convert_features as jconvert
from exemplars_vc_tpu.factorize.nmf import nmf_activations as jnmf
from exemplars_vc_tpu.factorize.nmf import residual_compensation as jresidual
from exemplars_vc_tpu.factorize.nmf_pallas import nmf_activations_pallas
from exemplars_vc_tpu_torch.factorize import nmf_cuda
from exemplars_vc_tpu_torch.factorize.nmf import (
    convert_features,
    nmf_activations,
    residual_compensation,
)


def _problem(seed, F=40, K=130, D=25, pad_rows=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    if pad_rows:
        A[K - pad_rows:] = 0.0
    X = np.abs(rng.standard_normal((F, D))).astype(np.float32)
    return X, A


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_twins_match_pallas_kernels():
    X, A = _problem(0)   # unaligned shapes exercise the Pallas padding
    ref = nmf_activations_pallas(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=40,
                                 tile_f=8, tile_k=128, interpret=True)
    got = nmf_activations(*_t(X, A), tol=0.0, max_iter=40)
    assert got.n_iter == int(ref.n_iter) == 40
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)


@pytest.mark.parametrize("max_iter", [40, 45])   # 45: the remainder iterations
def test_frobenius_matches_xla(max_iter):
    X, A = _problem(1, pad_rows=30)
    ref = jnmf(jnp.asarray(X), jnp.asarray(A), tol=0.0, max_iter=max_iter)
    got = nmf_activations(*_t(X, A), tol=0.0, max_iter=max_iter)
    assert got.n_iter == int(ref.n_iter) == max_iter
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)
    # zero dictionary rows are inert: their activations collapse to exactly 0
    assert (got.H[:, -30:] == 0).all()


@pytest.mark.parametrize("beta", ["frobenius", "kullback-leibler"])
@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_tol_cadence_matches_xla(beta, tol):
    rng = np.random.default_rng(2)
    A = (np.abs(rng.standard_normal((256, 60))) ** 2).astype(np.float32)
    A[200:] = 0.0
    X = (np.abs(rng.standard_normal((30, 60))) ** 2).astype(np.float32)
    ref = jnmf(jnp.asarray(X), jnp.asarray(A), beta_loss=beta, tol=tol, max_iter=150)
    got = nmf_activations(*_t(X, A), beta_loss=beta, tol=tol, max_iter=150)
    assert got.n_iter == int(ref.n_iter) < 150
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)


@pytest.mark.parametrize("l1", [0.0, 0.5])
def test_one_step_twins_match_jax_step(l1):
    # one update from the same H: rounding of one matmul pair only (rtol 1e-5)
    X, A = _problem(3, pad_rows=10)
    rng = np.random.default_rng(4)
    H = rng.uniform(0.0, 0.2, (X.shape[0], A.shape[0])).astype(np.float32)
    Num = X @ A.T
    ref = _mu_step_frobenius(jnp.asarray(H), jnp.asarray(X), jnp.asarray(A),
                             jnp.asarray(Num), l1=l1)
    Ht, At, Nt = _t(H, A, Num)
    got = nmf_cuda.nmf_update(nmf_cuda.nmf_recon(Ht, At), At, Ht, Nt, l1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-8)
    # a zero denominator (all-zero dictionary row with l1 = 0) becomes EPS
    if l1 == 0.0:
        assert (got[:, -10:] == 0).all()


def test_update_in_place_and_validation():
    X, A = _problem(5)
    H = torch.full((X.shape[0], A.shape[0]), 0.1)
    At, Xt = _t(A, X)
    expect = nmf_cuda.nmf_update_plain(H @ At, At, H, Xt @ At.T)
    out = nmf_cuda.nmf_update(H @ At, At, H, Xt @ At.T, out=H)
    assert out is H
    torch.testing.assert_close(H, expect, rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32"):
        nmf_cuda._check_f32("H", H.double(), tuple(H.shape), H.device)


def test_convert_and_residual_match_jax():
    X, A = _problem(6)
    rng = np.random.default_rng(7)
    H = rng.uniform(0.0, 0.1, (X.shape[0], A.shape[0])).astype(np.float32)
    B = np.abs(rng.standard_normal(A.shape)).astype(np.float32)
    Ht, At, Bt, Xt = _t(H, A, B, X)
    for mode in ("correct", "reference"):
        ref = np.asarray(jresidual(jnp.asarray(X), jnp.asarray(H), jnp.asarray(A), mode=mode))
        got = residual_compensation(Xt, Ht, At, mode=mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
        R = torch.as_tensor(ref)
        np.testing.assert_allclose(
            convert_features(Ht, Bt, R).numpy(),
            np.asarray(jconvert(jnp.asarray(H), jnp.asarray(B), jnp.asarray(ref))),
            rtol=1e-5, atol=1e-6, equal_nan=True)
    with pytest.raises(ValueError, match="beta_loss"):
        nmf_activations(Xt, At, beta_loss="itakura-saito")


@pytest.mark.parametrize("beta", ["frobenius", "kullback-leibler"])
def test_matches_sklearn(beta):
    """The reference's own solver call (sklearn MU, fixed dictionary) in
    float64 against the port in float32: the same fixed point within the
    float32 drift ``tests/test_nmf.py`` allows the JAX package (reconstruction
    within 5e-3 Frobenius / 1e-2 KL, n_iter within one 10-iteration block)."""
    from sklearn.decomposition import non_negative_factorization

    rng = np.random.default_rng(8)
    A = np.abs(rng.standard_normal((60, 25)))
    X = np.abs(rng.standard_normal((40, 25)))
    W, _, n_ref = non_negative_factorization(
        X=X, H=A, init="custom", update_H=False, n_components=A.shape[0], solver="mu",
        beta_loss=beta, tol=1e-4, max_iter=150)
    got = nmf_activations(*_t(X.astype(np.float32), A.astype(np.float32)), beta_loss=beta)
    tol = 5e-3 if beta == "frobenius" else 1e-2
    np.testing.assert_allclose(got.H.double().numpy() @ A, W @ A, rtol=tol, atol=tol)
    assert abs(got.n_iter - n_ref) <= 10


# ---------------------------------------------------------------------------
# the single-kernel MU iteration (fused=True), against the Pallas fused
# kernel in interpret mode at the shapes tests/test_pallas_kernels.py uses:
# the same tolerance as the two-kernel twins (rtol 1e-4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol,max_iter", [(0.0, 30), (1e-2, 150)])
def test_fused_matches_pallas_fused(tol, max_iter):
    X, A = _problem(3, F=16, K=256, D=25)
    ref = nmf_activations_pallas(jnp.asarray(X), jnp.asarray(A), tol=tol, max_iter=max_iter,
                                 tile_f=8, tile_k=128, interpret=True, fused=True)
    got = nmf_activations(*_t(X, A), tol=tol, max_iter=max_iter, fused=True)
    assert got.n_iter == int(ref.n_iter)
    if tol > 0:
        assert got.n_iter < max_iter      # the tol cadence stopped the solve
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)
    # the two-kernel path is the same math
    two = nmf_activations(*_t(X, A), tol=tol, max_iter=max_iter)
    assert two.n_iter == got.n_iter
    np.testing.assert_allclose(got.H.numpy(), two.H.numpy(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("l1", [0.0, 0.5])
def test_fused_step_matches_jax_step(l1):
    # the JAX fused kernel has no l1: hold l1 = 0 and l1 != 0 to the XLA step
    X, A = _problem(4, pad_rows=10)
    rng = np.random.default_rng(5)
    H = rng.uniform(0.0, 0.2, (X.shape[0], A.shape[0])).astype(np.float32)
    Num = X @ A.T
    ref = _mu_step_frobenius(jnp.asarray(H), jnp.asarray(X), jnp.asarray(A),
                             jnp.asarray(Num), l1=l1)
    Ht, At, Nt = _t(H, A, Num)
    np.testing.assert_allclose(nmf_cuda.nmf_mu_fused_plain(Ht, At, Nt, l1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-8)
    before = nmf_cuda.nmf_mu_fused.launches
    out = nmf_cuda.nmf_mu_fused(Ht, At, Nt, l1, out=Ht)
    assert out is Ht and nmf_cuda.nmf_mu_fused.launches == before   # CPU: the twin
    np.testing.assert_allclose(Ht.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-8)


def test_fused_needs_frobenius():
    X, A = _problem(6)
    with pytest.raises(ValueError, match="frobenius"):
        nmf_activations(*_t(X, A), beta_loss="kullback-leibler", fused=True)
