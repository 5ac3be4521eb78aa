"""The port's DEMIX and HMM spectral models (``exemplars_vc_tpu_torch/
separate/{demix,hmm}.py``) on the CPU: counterparts of the DEMIX, HMM and
multichannel-HMM classes of ``tests/test_separate_ext.py`` and the same
numpy inputs through the JAX package and the port.

Tolerances. DEMIX angles agree to ~1e-6 rad and the delays exactly. The
confidence of a time-frequency bin whose smoothed covariance is exactly
rank 1 (a pure tone) is decided by roundoff: λ2 = (a+d)/2 − disc cancels to
0 in one run and to ~1e-8·λ1 in the other, so that bin's confidence is
log1p(1e12)·c in one and log1p(~1e8)·c in the other. The histogram and the
cluster masses, sums of confidences, are held to 1e-2 of their largest
value on the same STFT and to 5e-2 through each package's own device STFT
(measured: 1.4e-2 on the delayed two-source mixture); the angles and delays
they lead to are held to 1e-5 rad and exactly. HMM paths are integers:
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import hmm as jhmm
from exemplars_vc_tpu.separate import multichannel as jmc
from exemplars_vc_tpu.separate.demix import _tf_features as jax_tf_features
from exemplars_vc_tpu.separate.demix import demix as jax_demix
from exemplars_vc_tpu.separate.glue import host_stft_stack as jax_host_stft_stack
from exemplars_vc_tpu.separate.glue import stft_stack as jax_stft_stack
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.separate import (
    demix,
    fit_hmm_spectra,
    fit_multichannel_hmm,
    separate_signal,
    sticky_transition,
)
from exemplars_vc_tpu_torch.separate import hmm as thmm
from exemplars_vc_tpu_torch.separate.demix import _tf_features
from test_separate_ext import TestHMMSpectra as _JaxHMM
from test_separate_ext import _stereo_pan_mixture
from test_torch_separate import key_kw

CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _two_state_spec(seed):
    return _JaxHMM._two_state_spec(None, seed=seed)


def _stft_fnc(x, n_fft, hop):
    return stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).permute(2, 1, 0)


class TestDemix:
    def test_recovers_pan_angles(self):
        true = np.array([0.2, 0.75, 1.25])
        est = demix(_stereo_pan_mixture(true), n_sources=3, n_fft=512, hop_length=128,
                    device=CPU)
        got = np.sort(est.theta)
        assert np.allclose(got, np.sort(true), atol=0.06), got

    def test_auto_source_count(self):
        true = np.array([0.25, 1.15])
        est = demix(_stereo_pan_mixture(true), n_sources=None, n_fft=512, hop_length=128,
                    device=CPU)
        assert len(est.theta) == 2, est.theta
        assert np.allclose(np.sort(est.theta), np.sort(true), atol=0.06)

    def test_recovers_integer_delay(self):
        x = _stereo_pan_mixture(np.array([0.3, 1.1]), delays=[3, 0])
        est = demix(x, n_sources=2, n_fft=512, hop_length=128, max_delay=6.0, device=CPU)
        delays = est.delay[np.argsort(est.theta)]
        assert abs(delays[0] - 3.0) <= 0.5, est
        assert abs(delays[1] - 0.0) <= 0.5, est

    def test_spatial_init_shapes(self):
        est = demix(_stereo_pan_mixture(np.array([0.3, 1.1])), n_sources=2, n_fft=512,
                    hop_length=128, device=CPU)
        freqs = np.arange(257) / 512
        assert est.steering_vectors(freqs, device=CPU).shape == (2, 257, 2)
        R = est.spatial_init(freqs, device=CPU)
        assert R.shape == (2, 257, 2, 2)
        tr = R.diagonal(dim1=-2, dim2=-1).sum(-1).real.numpy()
        assert np.allclose(tr, 2.0, atol=1e-3)

    def test_rejects_non_stereo(self):
        with pytest.raises(ValueError, match="stereo"):
            demix(np.zeros((3, 1000), np.float32), device=CPU)


class TestHMMSpectra:
    def test_segmentation_recovered(self):
        V, states = _two_state_spec(1)
        path = fit_hmm_spectra(V, n_states=2, n_iter=10, device=CPU).states.numpy()
        agree = max(np.mean(path == states), np.mean(path == 1 - states))
        assert agree > 0.95, agree

    def test_cost_decreases(self):
        V, _ = _two_state_spec(3)
        c = fit_hmm_spectra(V, n_states=2, n_iter=8, device=CPU).cost.numpy()
        assert c[-1] <= c[0] + 1e-3

    def test_sticky_transition_matches_pyfasst_formula(self):
        A = sticky_transition(4, device=CPU).numpy()
        assert np.allclose(A, (9 * np.eye(4) + 1) / (9 + 4))

    def test_fixed_transition_not_updated(self):
        V, _ = _two_state_spec(4)
        A0 = sticky_transition(2, device=CPU)
        fit = fit_hmm_spectra(V, n_states=2, n_iter=5, transition=A0,
                              update_transition=False, device=CPU)
        assert np.allclose(fit.A.numpy(), A0.numpy())

    def test_free_transition_rows_normalized(self):
        V, _ = _two_state_spec(5)
        rows = fit_hmm_spectra(V, n_states=3, n_iter=6, device=CPU).A.numpy().sum(axis=1)
        assert np.all((np.abs(rows - 1) < 1e-5) | (rows == 1.0)), rows


class TestMultichannelHMM:
    def test_fit_and_separate(self):
        x = _stereo_pan_mixture(np.array([0.2, 1.3]), T=4000, seed=7, disjoint=False)
        model = fit_multichannel_hmm(_stft_fnc(x, 256, 64), n_sources=2, n_states=3,
                                     n_em=15, device=CPU)
        H = model.H.numpy()
        assert H.shape[0] == 2 and H.shape[1] == 3
        assert np.allclose(H.sum(axis=1), 1.0)
        assert set(np.unique(H)) <= {0.0, 1.0}
        nll = model.neg_log_like.numpy()
        assert np.all(np.isfinite(nll))
        assert nll[-1] <= nll[0]

    def test_separate_signal_hmm_path(self):
        x = _stereo_pan_mixture(np.array([0.25, 1.2]), T=3000, seed=8, disjoint=False)
        y, _ = separate_signal(x, n_sources=2, n_components=3, n_em=10, n_fft=256,
                               hop_length=64, spectral_model="shmm", device=CPU)
        assert y.shape == (2, 2, 3000)
        assert torch.isfinite(y).all()

    def test_separate_signal_demix_init(self):
        x = _stereo_pan_mixture(np.array([0.25, 1.2]), T=3000, seed=9)
        y, _ = separate_signal(x, n_sources=2, n_components=3, n_em=10, n_fft=256,
                               hop_length=64, spatial_init="demix", device=CPU)
        assert y.shape == (2, 2, 3000)
        assert torch.isfinite(y).all()


# ---- the port against the JAX package --------------------------------------


@pytest.mark.parametrize("disjoint", [True, False])
def test_tf_features_match_jax(disjoint):
    x = _stereo_pan_mixture(np.array([0.3, 1.1]), T=8000, seed=3, delays=[2, 0],
                            disjoint=disjoint)
    X = np.array(jax_stft_stack(jnp.asarray(x), 256, 64))
    ref = jax_tf_features(jnp.asarray(X), 3, 3, 90)
    got = _tf_features(t(X), 3, 3, 90)
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() < 1e-5       # θ, rad
    ph = np.angle(np.exp(1j * (got[1].numpy() - np.asarray(ref[1]))))
    conf_r = np.asarray(ref[2])
    strong = conf_r > 1e-3 * conf_r.max()      # a bin whose direction counts
    assert np.abs(ph[strong]).max() < 1e-3                               # phase, rad
    assert rel(got[3].numpy(), ref[3]) < 1e-2                             # histogram


@pytest.mark.parametrize("n_sources,delays", [(2, [3, 0]), (3, None), (None, None)])
def test_demix_matches_jax(n_sources, delays):
    true = np.array([0.3, 1.1]) if n_sources != 3 else np.array([0.2, 0.75, 1.25])
    x = _stereo_pan_mixture(true, delays=delays)
    kw = dict(n_sources=n_sources, n_fft=512, hop_length=128, max_delay=6.0)
    ref = jax_demix(jnp.asarray(x), **kw)
    got = demix(x, device=CPU, **kw)
    assert len(got.theta) == len(ref.theta)
    np.testing.assert_allclose(got.theta, ref.theta, atol=1e-5)
    np.testing.assert_array_equal(got.delay, ref.delay)
    assert rel(got.hist, ref.hist) < 5e-2
    assert rel(got.weight, ref.weight) < 5e-2
    freqs = np.arange(257) / 512
    assert rel(got.spatial_init(freqs, device=CPU).numpy(),
               np.asarray(ref.spatial_init(freqs))) < 1e-4


@pytest.mark.parametrize("update_transition", [True, False])
def test_fit_hmm_spectra_matches_jax(update_transition):
    V, _ = _two_state_spec(6)
    V = V * np.random.default_rng(6).uniform(0.5, 2.0, V.shape[1]).astype(np.float32)
    kw = dict(n_states=3, n_iter=6, update_transition=update_transition)
    ref = jhmm.fit_hmm_spectra(V, **kw)
    got = fit_hmm_spectra(V, device=CPU, **kw)
    np.testing.assert_array_equal(got.states.numpy(), np.asarray(ref.states))
    assert rel(got.W.numpy(), ref.W) < 1e-5
    np.testing.assert_allclose(got.A.numpy(), np.asarray(ref.A), atol=1e-7)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-5)


def jax_hmm_inits(key, X, J, S):
    """W0, P0, R0 as JAX ``fit_multichannel_hmm`` draws them for ``key``."""
    F, N, C = X.shape
    kw, kr, kp = jax.random.split(key, 3)
    W0 = np.array(jax.random.normal(kw, (J, F, S)) ** 2)
    paths0 = jax.random.randint(kp, (J, N), 0, S)
    P0 = np.array(jax.nn.one_hot(paths0, S, dtype=jnp.float32).transpose(0, 2, 1))
    a = jax.random.normal(kr, (J, C)) + 1j * jax.random.normal(kr, (J, C))
    aaH = a[:, :, None] * jnp.conj(a)[:, None, :]
    aaH = aaH / jnp.maximum(jnp.real(jnp.trace(aaH, axis1=-2, axis2=-1))[:, None, None],
                            1e-10)
    R0 = (jnp.eye(C, dtype=jnp.complex64)[None] * 0.8 + 0.2 * C * aaH.astype(jnp.complex64))
    return W0, P0, np.array(jnp.broadcast_to(R0[:, None], (J, F, C, C)))


@pytest.mark.parametrize("sticky", [False, True])
def test_em_loop_hmm_matches_jax(sticky):
    x = _stereo_pan_mixture(np.array([0.2, 1.3]), T=4000, seed=7, disjoint=False)
    X = np.array(jax_host_stft_stack(x, 256, 64))
    J, S = 2, 3
    W0, P0, R0 = jax_hmm_inits(jax.random.PRNGKey(2), X, J, S)
    A0 = np.broadcast_to(np.asarray(jhmm.sticky_transition(S)) if sticky
                         else np.full((S, S), 1.0 / S, np.float32), (J, S, S)).copy()
    ref = jhmm._em_loop_hmm(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(P0),
                            jnp.asarray(A0), jnp.asarray(R0), 5, not sticky)
    got = thmm._em_loop_hmm(t(X), t(W0), t(P0), t(A0), t(R0), 5, not sticky)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))     # state paths
    for name, g, r in zip(("W", "A", "R"), (got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        assert rel(g.numpy(), r) < 1e-4, name
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5)


@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("sticky", [False, True])
def test_fit_multichannel_hmm_from_a_key_matches_jax(sticky, seed):
    """No inits: W, R and the random paths come from the three-way split of
    the key in both packages (the JAX function's ``randint`` paths and its
    one-key complex draw too), default key (None) or another; 5 EM
    iterations, the tolerances of ``test_em_loop_hmm_matches_jax``."""
    x = _stereo_pan_mixture(np.array([0.2, 1.3]), T=4000, seed=7, disjoint=False)
    X = np.array(jax_host_stft_stack(x, 256, 64))
    jk, tk = key_kw(seed)
    ref = jhmm.fit_multichannel_hmm(jnp.asarray(X), n_sources=2, n_states=3, n_em=5,
                                    sticky=sticky, **jk)
    got = fit_multichannel_hmm(X, n_sources=2, n_states=3, n_em=5, sticky=sticky,
                               device=CPU, **tk)
    np.testing.assert_array_equal(got.H.numpy(), np.asarray(ref.H))     # state paths
    for name in ("W", "R"):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 1e-4, name
    np.testing.assert_allclose(got.neg_log_like.numpy(), np.asarray(ref.neg_log_like),
                               rtol=1e-5)


def test_hmm_paths_match_jax_on_the_benchmark_mixture():
    """At the separation benchmark's settings (2 s mixture, n_fft 400, 8
    states) the JAX package and the port keep equal state paths for 10 EM
    iterations; later the fit sits on near-ties and roundoff flips states."""
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture

    X = np.array(jax_host_stft_stack(synthetic_mixture(), 400, 80))
    J, S = 2, 8
    W0, P0, R0 = jax_hmm_inits(jax.random.PRNGKey(0), X, J, S)
    A0 = np.full((J, S, S), 1.0 / S, np.float32)
    ref = jhmm._em_loop_hmm(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(P0),
                            jnp.asarray(A0), jnp.asarray(R0), 10, True)
    got = thmm._em_loop_hmm(t(X), t(W0), t(P0), t(A0), t(R0), 10, True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-5)


@pytest.mark.parametrize("sticky", [False, True], ids=["hmm", "shmm"])
def test_hmm_fit_on_the_benchmark_mixture_parts_from_jax_in_paths_only(sticky):
    """The 20-iteration fit of the benchmark mixture, from four seeds' JAX
    inits: after 10 iterations the paths are equal (above), after 20 a few
    per cent of the frames are on other states while the NLL stays within
    1e-4 of the JAX package's at every iteration. This is the spread that
    ``chip_smoke.py`` phase 10 meets between the card and the CPU run, and
    the reason it gates the paths after 5 iterations. ``-s`` prints the
    table (measured: hmm 94.1-99.8 % of frames equal, shmm 99.3-100 %; NLL
    at most 3.4e-5 apart)."""
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture

    X = np.array(jax_host_stft_stack(synthetic_mixture(), 400, 80))
    J, S = 2, 8
    A0 = np.broadcast_to(np.asarray(jhmm.sticky_transition(S)) if sticky
                         else np.full((S, S), 1.0 / S, np.float32), (J, S, S)).copy()
    for seed in range(4):
        W0, P0, R0 = jax_hmm_inits(jax.random.PRNGKey(seed), X, J, S)
        ref = jhmm._em_loop_hmm(jnp.asarray(X), jnp.asarray(W0), jnp.asarray(P0),
                                jnp.asarray(A0), jnp.asarray(R0), 20, not sticky)
        got = thmm._em_loop_hmm(t(X), t(W0), t(P0), t(A0), t(R0), 20, not sticky)
        equal = float((got[1].numpy().argmax(1) == np.asarray(ref[1]).argmax(1)).mean())
        nll = float(np.abs(got[4].numpy() / np.asarray(ref[4]) - 1).max())
        print(f"{'shmm' if sticky else 'hmm'} seed {seed}, 20 EM: paths equal on "
              f"{equal:.4f} of frames, NLL at most {nll:.3g} relative apart")
        assert nll < 1e-4
        assert equal >= 0.9


def test_separate_signal_hmm_matches_jax():
    """The HMM slice as a whole, both packages from ``PRNGKey(4)``."""
    x = _stereo_pan_mixture(np.array([0.25, 1.2]), T=3000, seed=8, disjoint=False)
    kw = dict(n_sources=2, n_components=3, n_em=5, n_fft=256, hop_length=64,
              spectral_model="hmm")
    jk, tk = key_kw(4)
    ref_img, ref = jmc.separate_signal(jnp.asarray(x), **jk, **kw)
    img, got = separate_signal(x, device=CPU, **tk, **kw)
    np.testing.assert_array_equal(got.H.numpy(), np.asarray(ref.H))
    assert rel(img.numpy(), ref_img) < 1e-4
    np.testing.assert_allclose(got.neg_log_like.numpy(), np.asarray(ref.neg_log_like),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["demix", "fit_hmm_spectra", "fit_multichannel_hmm",
                                  "sticky_transition"])
def test_entry_point_defaults_to_the_card(name):
    import inspect

    from exemplars_vc_tpu_torch import separate

    fn = getattr(separate, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    args = {"demix": (np.zeros((2, 4000), np.float32),),
            "fit_hmm_spectra": (np.ones((4, 5), np.float32),),
            "fit_multichannel_hmm": (np.ones((4, 5, 2), np.complex64),),
            "sticky_transition": (3,)}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
