"""The port's IS-NMF and multichannel NMF (``exemplars_vc_tpu_torch/separate/
{isnmf,multichannel}.py``) on the CPU: counterparts of ``tests/test_separate.py``
and the same numpy inputs through the JAX package and the port.

The port draws its inits from the JAX package's keys (``prng``, the
counterpart of ``jax.random``): the ``*_from_a_key_matches_jax`` tests run
each function without inits, from the default key and from one other key,
against the JAX function. Its normals are within 3 ulp of JAX's (1 % of
them not bit-equal), which the fits carry at roundoff. The other parity
tests run both packages from one key, or hand the fits that take explicit
inits (as the JAX ones do) inits drawn through the JAX package.

Tolerances. One E-step agrees to 1e-5 relative (float32 complex einsums
summed in another order). The EM amplifies that roundoff with every
iteration, so the fits are compared after 5 or 6 EM iterations: images,
W, H and R to 1e-4 relative and every iteration's NLL to 1e-5 (from the
DEMIX init 1e-3 and 1e-4; see ``test_separate_signal_matches_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import isnmf as jisnmf
from exemplars_vc_tpu.separate import multichannel as jmc
from exemplars_vc_tpu.separate.glue import host_stft_stack as jax_host_stft_stack
from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.separate import (
    fit_multichannel_nmf,
    is_divergence,
    is_nmf,
    separate_signal,
    sf_nmf,
)
from exemplars_vc_tpu_torch.separate import isnmf as tisnmf
from exemplars_vc_tpu_torch.separate import multichannel as tmc
from test_separate import _two_source_stereo, low_rank_power, ref_is_nmf

CPU = "cpu"


def rel(a, b) -> float:
    """max |a − b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def key(seed: int) -> torch.Tensor:
    return prng.PRNGKey(seed)


def key_kw(seed: int | None) -> tuple[dict, dict]:
    """The ``key=`` arguments of the JAX function and of the port for
    ``seed``; None gives neither, so that both take their default key."""
    if seed is None:
        return {}, {}
    return {"key": jax.random.PRNGKey(seed)}, {"key": prng.PRNGKey(seed)}


# the default key (PRNGKey(0) in both packages) and one other
KEY_SEEDS = [None, 7]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---- counterparts of tests/test_separate.py --------------------------------


def test_is_nmf_matches_pyfasst_oracle():
    rng = np.random.default_rng(0)
    SX = low_rank_power(rng)
    W0 = (rng.standard_normal((48, 5)) ** 2).astype(np.float32)
    H0 = (rng.standard_normal((5, 40)) ** 2).astype(np.float32)
    W, H = is_nmf(SX, n_components=5, n_iter=8, W_init=W0, H_init=H0, device=CPU)
    Wr, Hr = ref_is_nmf(SX, W0, H0, n_iter=8)
    np.testing.assert_allclose(W.numpy(), Wr, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(H.numpy(), Hr, rtol=2e-3, atol=1e-5)


def test_is_nmf_monotone_divergence():
    SX = low_rank_power(np.random.default_rng(1))
    prev = None
    for it in (2, 8, 30):
        W, H = is_nmf(SX, n_components=4, n_iter=it, key=key(3), device=CPU)
        d = float(is_divergence(torch.from_numpy(SX), W @ H))
        if prev is not None:
            assert d <= prev * (1 + 1e-5)
        prev = d
    # a rank-3 target with 4 components must fit well
    assert prev / SX.size < 0.05


def test_is_nmf_fixed_W_stays_fixed():
    rng = np.random.default_rng(2)
    SX = low_rank_power(rng)
    W0 = (rng.random((48, 4)) + 0.1).astype(np.float32)
    W, H = is_nmf(SX, n_components=4, n_iter=6, W_init=W0, update_W=False, device=CPU)
    np.testing.assert_array_equal(W.numpy(), W0)
    # H alone still reduces the divergence vs its init
    d0 = float(is_divergence(torch.from_numpy(SX),
                             torch.from_numpy(W0) @ torch.ones((4, 40)) * float(SX.mean())))
    d1 = float(is_divergence(torch.from_numpy(SX), W @ H))
    assert d1 < d0


def test_is_nmf_W_columns_normalized():
    SX = low_rank_power(np.random.default_rng(3))
    W, _ = is_nmf(SX, n_components=4, n_iter=5, key=key(1), device=CPU)
    np.testing.assert_allclose(W.numpy().sum(axis=0), 1.0, rtol=1e-4)


def _source_filter_target(rng, F=64, N=32):
    exc = np.zeros((F, 2), np.float32)
    exc[::8, 0] = 1.0   # comb with period 8
    exc[::5, 1] = 1.0   # comb with period 5
    filt = np.stack(
        [np.exp(-np.arange(F) / 20.0), np.exp(-((np.arange(F) - 30) ** 2) / 200.0)],
        axis=1).astype(np.float32)
    h = (rng.random((2, N)) + 0.05).astype(np.float32)
    hf = (rng.random((2, N)) + 0.05).astype(np.float32)
    return (exc @ h) * (filt @ hf) + 0.01


def test_sf_nmf_fits_source_filter_structure():
    SX = _source_filter_target(np.random.default_rng(4))
    F, N = SX.shape
    W, H, WF, HF, WR, HR = sf_nmf(SX, n_components=2, n_filt_components=2,
                                  n_res_components=1, n_iter=60, key=key(0), device=CPU)
    assert W.shape == (F, 2) and H.shape == (2, N)
    assert WF.shape == (F, 2) and HF.shape == (2, N)
    hat = (W @ H) * (WF @ HF) + WR @ HR
    SXt = torch.from_numpy(SX)
    d = float(is_divergence(SXt, hat))
    d0 = float(is_divergence(SXt, torch.full_like(SXt, float(SX.mean()))))
    assert d < 0.1 * d0


def _stft_fnc(x: np.ndarray, n_fft: int, hop: int) -> torch.Tensor:
    return stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).permute(2, 1, 0)


def test_multichannel_nll_monotone():
    _, _, mix = _two_source_stereo(None)
    model = fit_multichannel_nmf(_stft_fnc(mix, 128, 64), n_sources=2, n_components=2,
                                 n_em=12, key=key(0), device=CPU)
    nll = model.neg_log_like.numpy()
    # EM on the local Gaussian model: NLL non-increasing (small slack for f32)
    assert nll[-1] < nll[0]
    viol = np.diff(nll) > np.abs(nll[:-1]) * 1e-3
    assert viol.sum() <= 1, f"NLL increased at iterations {np.where(viol)[0]}"


def _sdr(ref, est) -> float:
    return 10 * np.log10(float((ref ** 2).sum()) / (float(((ref - est) ** 2).sum()) + 1e-12))


def test_multichannel_separation_recovers_panned_sources():
    """The JAX test's operating point: its key, ``PRNGKey(1)``. The EM's end
    point depends on the init on this mixture (some keys stay under the 5 dB
    margin), so the port starts where the JAX test starts."""
    img1, img2, mix = _two_source_stereo(None)
    images, _ = separate_signal(mix, n_sources=2, n_components=2, n_em=40, n_fft=128,
                                hop_length=32, key=key(1), device=CPU)
    images = images.numpy()
    assert images.shape == (2, 2, mix.shape[1])
    # near-conservativity: Wiener images sum back to the mixture up to the
    # energy the fitted model fails to cover
    resid = np.linalg.norm(images.sum(axis=0) - mix) / np.linalg.norm(mix)
    assert resid < 0.10, f"reconstruction residual {resid:.3f}"
    best = max(min(_sdr(img1, images[p]), _sdr(img2, images[1 - p])) for p in (0, 1))
    base = min(_sdr(img1, mix), _sdr(img2, mix))
    assert best > base + 5.0, f"separation SDR {best:.1f} dB vs mixture {base:.1f} dB"


def test_multichannel_three_channels_general_inverse():
    tt = np.arange(3000) / 8000.0
    s1 = np.sin(2 * np.pi * 300 * tt).astype(np.float32)
    s2 = np.sin(2 * np.pi * 900 * tt).astype(np.float32)
    mix = (np.array([1.0, 0.5, 0.1], np.float32)[:, None] * s1
           + np.array([0.1, 0.5, 1.0], np.float32)[:, None] * s2)
    images, _ = separate_signal(mix, n_sources=2, n_components=1, n_em=10, n_fft=128,
                                hop_length=64, key=key(2), device=CPU)
    assert images.shape == (2, 3, 3000)
    assert torch.isfinite(images).all()


# ---- the port against the JAX package --------------------------------------


def _hermitian_pd(rng, shape, C):
    A = rng.standard_normal(shape + (C, C)) + 1j * rng.standard_normal(shape + (C, C))
    return (A @ np.conj(np.swapaxes(A, -1, -2)) + 0.5 * np.eye(C)).astype(np.complex64)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_inv_hermitian_matches_jax_and_inverts(C):
    M = _hermitian_pd(np.random.default_rng(C), (7, 5), C)
    got = tmc._inv_hermitian(t(M)).numpy()
    ref = np.asarray(jmc._inv_hermitian(jnp.asarray(M)))
    assert rel(got, ref) < 1e-5
    eye = np.broadcast_to(np.eye(C), M.shape)
    assert np.abs(M @ got - eye).max() < 1e-4


def _em_inputs(rng, F=9, N=30, C=2, J=2, K=3):
    X = (rng.standard_normal((F, N, C)) + 1j * rng.standard_normal((F, N, C))) \
        .astype(np.complex64)
    W = (rng.standard_normal((J, F, K)) ** 2).astype(np.float32)
    H = (rng.standard_normal((J, K, N)) ** 2).astype(np.float32)
    R = np.asarray(jmc.random_spatial_init(jax.random.PRNGKey(5), J, F, C))
    return X, W, H, R


def test_spatial_estep_matches_jax():
    X, W, H, R = _em_inputs(np.random.default_rng(5))
    v = np.maximum(np.einsum("jfk,jkn->jfn", W, H), 1e-10).astype(np.float32)
    XXj = jnp.asarray(X)[..., :, None] * jnp.conj(jnp.asarray(X))[..., None, :]
    ref = jmc._spatial_estep(XXj, jnp.asarray(v), jnp.asarray(R))
    got = tmc._spatial_estep(tmc._outer(t(X)), t(v), t(R))
    for name, g, r in zip(("R", "scale", "z", "nll"), got, ref):
        assert rel(g.numpy(), r) < 1e-5, name


def test_spatial_estep_from_a_rank1_init_matches_jax():
    """From the DEMIX init (rank-1 plus 5 % diffuse) on the two-tone mixture,
    one E-step's updated R and NLL agree at roundoff, but z = tr(R⁻¹R̂)/C
    only to ~1e-3: R⁻¹ of the near-rank-1 update (condition number up to 2e5
    through the 1e-5·I ridge) multiplies R̂'s float32 roundoff."""
    from exemplars_vc_tpu.separate.demix import demix as jax_demix

    mix = _two_source_stereo(None)[2]
    X = np.array(jax_host_stft_stack(mix, 128, 32))
    W, H, _ = jax_nmf_inits(jax.random.PRNGKey(11), mix, 2, 2, 128, 32, draw_R=False)
    R = np.array(jax_demix(jnp.asarray(mix), n_sources=2, n_fft=128, hop_length=32)
                 .spatial_init(np.arange(X.shape[0]) / 128))
    v = np.maximum(np.einsum("jfk,jkn->jfn", W, H), 1e-10).astype(np.float32)
    XXj = jnp.asarray(X)[..., :, None] * jnp.conj(jnp.asarray(X))[..., None, :]
    ref = jmc._spatial_estep(XXj, jnp.asarray(v), jnp.asarray(R))
    got = tmc._spatial_estep(tmc._outer(t(X)), t(v), t(R))
    for name, g, r, tol in zip(("R", "scale", "z", "nll"), got, ref, (1e-5, 1e-5, 5e-3, 1e-5)):
        assert rel(g.numpy(), r) < tol, name


@pytest.mark.parametrize("n_inner", [1, 2])
def test_em_loop_matches_jax(n_inner):
    X, W, H, R = _em_inputs(np.random.default_rng(6))
    ref = jmc._em_loop(jnp.asarray(X), jnp.asarray(W), jnp.asarray(H), jnp.asarray(R),
                       5, n_inner)
    got = tmc._em_loop(t(X), t(W), t(H), t(R), 5, n_inner)
    for name in ("W", "H", "R"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-4, name
    nll_r = np.asarray(ref.neg_log_like)
    assert np.abs(got.neg_log_like.numpy() - nll_r).max() / np.abs(nll_r).max() < 1e-5


def test_wiener_images_match_jax():
    X, W, H, R = _em_inputs(np.random.default_rng(7))
    ref = jmc._wiener_images(jnp.asarray(X), jnp.asarray(W), jnp.asarray(H), jnp.asarray(R))
    got = tmc._wiener_images(t(X), t(W), t(H), t(R))
    assert rel(got.numpy(), ref) < 1e-5


def test_is_nmf_matches_jax():
    rng = np.random.default_rng(8)
    SX = low_rank_power(rng)
    W0 = (rng.standard_normal((48, 5)) ** 2).astype(np.float32)
    H0 = (rng.standard_normal((5, 40)) ** 2).astype(np.float32)
    for kw in ({}, {"update_W": False}, {"update_H": False}):
        ref = jisnmf.is_nmf(SX, n_components=5, n_iter=10, W_init=W0, H_init=H0, **kw)
        got = is_nmf(SX, n_components=5, n_iter=10, W_init=W0, H_init=H0, device=CPU, **kw)
        for g, r in zip(got, ref):
            assert rel(g.numpy(), r) < 1e-4, kw


def test_sf_nmf_matches_jax():
    rng = np.random.default_rng(9)
    SX = _source_filter_target(rng)
    F, N = SX.shape
    inits = dict(
        W_init=(rng.standard_normal((F, 2)) ** 2).astype(np.float32),
        H_init=(rng.standard_normal((2, N)) ** 2).astype(np.float32),
        W_filt_init=(rng.standard_normal((F, 2)) ** 2).astype(np.float32),
        H_filt_init=(rng.standard_normal((2, N)) ** 2).astype(np.float32),
        W_res_init=((1 + rng.standard_normal((F, 1))) ** 2).astype(np.float32),
        H_res_init=((1 + rng.standard_normal((1, N))) ** 2).astype(np.float32))
    for kw in ({}, {"update_res": False}, {"update_W_filt": False, "update_H": False}):
        ref = jisnmf.sf_nmf(SX, n_components=2, n_filt_components=2, n_res_components=1,
                            n_iter=8, **inits, **kw)
        got = sf_nmf(SX, n_components=2, n_filt_components=2, n_res_components=1,
                     n_iter=8, device=CPU, **inits, **kw)
        for g, r in zip(got, ref):
            assert rel(g.numpy(), r) < 1e-4, kw


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_is_nmf_from_a_key_matches_jax(seed):
    """No inits: W and H come from the key in both packages (the tolerance
    of ``test_is_nmf_matches_jax``)."""
    SX = low_rank_power(np.random.default_rng(8))
    jk, tk = key_kw(seed)
    ref = jisnmf.is_nmf(SX, n_components=5, n_iter=6, **jk)
    got = is_nmf(SX, n_components=5, n_iter=6, device=CPU, **tk)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r) < 1e-4


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_sf_nmf_from_a_key_matches_jax(seed):
    """No inits: the six factors come from the six-way split of the key."""
    SX = _source_filter_target(np.random.default_rng(9))
    jk, tk = key_kw(seed)
    kw = dict(n_components=2, n_filt_components=2, n_res_components=1, n_iter=6)
    ref = jisnmf.sf_nmf(SX, **kw, **jk)
    got = sf_nmf(SX, **kw, device=CPU, **tk)
    for g, r in zip(got, ref):
        assert rel(g.numpy(), r) < 1e-4


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_random_spatial_init_from_a_key_matches_jax(seed):
    k = 0 if seed is None else seed
    ref = np.asarray(jmc.random_spatial_init(jax.random.PRNGKey(k), 3, 5, 2))
    got = tmc.random_spatial_init(prng.PRNGKey(k), 3, 5, 2, device=CPU).numpy()
    assert rel(got, ref) < 1e-6


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_fit_multichannel_nmf_from_a_key_matches_jax(seed):
    """No inits: W, H and R from the three-way split of the key, 5 EM
    iterations (the tolerances of ``test_em_loop_matches_jax``)."""
    X = _em_inputs(np.random.default_rng(6))[0]
    jk, tk = key_kw(seed)
    ref = jmc.fit_multichannel_nmf(jnp.asarray(X), n_sources=2, n_components=3, n_em=5, **jk)
    got = fit_multichannel_nmf(X, n_sources=2, n_components=3, n_em=5, device=CPU, **tk)
    for name in ("W", "H", "R"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-4, name
    nll_r = np.asarray(ref.neg_log_like)
    assert np.abs(got.neg_log_like.numpy() - nll_r).max() / np.abs(nll_r).max() < 1e-5


def jax_nmf_inits(key, x, n_sources, n_components, n_fft, hop, draw_R=True):
    """The W, H (and R) that JAX ``separate_signal(x, key=key)`` draws."""
    X = jax_host_stft_stack(x, n_fft, hop)
    F, N, C = X.shape
    kw, kh, kr = jax.random.split(key, 3)
    W = np.array(jax.random.normal(kw, (n_sources, F, n_components)) ** 2)
    H = np.array(jax.random.normal(kh, (n_sources, n_components, N)) ** 2)
    R = np.array(jmc.random_spatial_init(kr, n_sources, F, C)) if draw_R else None
    return W, H, R


@pytest.mark.parametrize("spatial_init,tol", [("random", 1e-4), ("demix", 1e-3)])
def test_separate_signal_matches_jax(spatial_init, tol):
    """The slice as a whole: host STFT → (DEMIX) → EM → Wiener images →
    ISTFT, both packages from ``PRNGKey(11)``.

    From the DEMIX init the fit is worse conditioned: R_j(f) starts rank-1
    plus 5 % diffuse, the 1e-5 ridge leaves R⁻¹ a condition number up to
    2e5, and z = tr(R⁻¹R̂)/C carries R̂'s float32 roundoff times that
    (``test_spatial_estep_from_a_rank1_init_matches_jax``): 1e-3 there (the
    NLL 1e-4), against 1e-4 (the NLL 1e-5) from the random init."""
    img1, img2, mix = _two_source_stereo(None)
    kw = dict(n_sources=2, n_components=2, n_em=6, n_fft=128, hop_length=32)
    jk, tk = key_kw(11)
    ref_img, ref = jmc.separate_signal(jnp.asarray(mix), spatial_init=spatial_init, **jk, **kw)
    img, got = separate_signal(mix, spatial_init=spatial_init, device=CPU, **tk, **kw)
    assert img.shape == (2, 2, mix.shape[1])
    assert rel(img.numpy(), ref_img) < tol
    for name in ("W", "H", "R"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < tol, name
    nll_r = np.asarray(ref.neg_log_like)
    np.testing.assert_allclose(got.neg_log_like.numpy(), nll_r, rtol=tol / 10)


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_separate_signal_from_a_key_matches_jax(seed):
    """The slice as a whole with no inits: the port draws what the JAX
    function draws for the key (the tolerance of the random-init case of
    ``test_separate_signal_matches_jax``)."""
    mix = _two_source_stereo(None)[2]
    kw = dict(n_sources=2, n_components=2, n_em=6, n_fft=128, hop_length=32)
    jk, tk = key_kw(seed)
    ref_img, ref = jmc.separate_signal(jnp.asarray(mix), **kw, **jk)
    img, got = separate_signal(mix, device=CPU, **kw, **tk)
    assert rel(img.numpy(), ref_img) < 1e-4
    for name in ("W", "H", "R"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-4, name
    np.testing.assert_allclose(got.neg_log_like.numpy(), np.asarray(ref.neg_log_like),
                               rtol=1e-5)


def test_separate_signal_refuses_unknown_models():
    mix = _two_source_stereo(None)[2][:, :2000]
    with pytest.raises(ValueError, match="spatial_init"):
        separate_signal(mix, n_em=1, spatial_init="nope", device=CPU)
    with pytest.raises(ValueError, match="spectral_model"):
        separate_signal(mix, n_em=1, spectral_model="nope", device=CPU)


def test_same_generator_seed_same_fit():
    mix = _two_source_stereo(None)[2][:, :3000]
    a = separate_signal(mix, n_em=3, n_fft=128, hop_length=32, key=key(4), device=CPU)
    b = separate_signal(mix, n_em=3, n_fft=128, hop_length=32, key=key(4), device=CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].neg_log_like, b[1].neg_log_like)


@pytest.mark.parametrize("name", ["is_nmf", "sf_nmf", "fit_multichannel_nmf",
                                  "separate_signal", "random_spatial_init"])
def test_entry_point_defaults_to_the_card(name):
    """Called without ``device``, an entry point asks for the card: on a host
    without one it raises rather than fall back to the CPU."""
    import inspect

    fn = getattr(tisnmf if name in ("is_nmf", "sf_nmf") else tmc, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    args = {"is_nmf": (np.ones((4, 5), np.float32),),
            "sf_nmf": (np.ones((4, 5), np.float32),),
            "fit_multichannel_nmf": (np.ones((4, 5, 2), np.complex64),),
            "separate_signal": (np.zeros((2, 800), np.float32),),
            "random_spatial_init": (key(0), 2, 4, 2)}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
