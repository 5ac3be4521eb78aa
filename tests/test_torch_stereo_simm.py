"""The port's stereo SIMM (``exemplars_vc_tpu_torch/separate/stereo_simm.py``)
on the CPU: counterparts of ``tests/test_stereo_simm.py`` (held to the
float64 oracle ``tests/oracles/stereo_simm.py`` as the JAX module is), and
the same inputs through the JAX package and the port.

The port draws its inits from the JAX package's keys (``prng``): the
``*_from_a_key_matches_jax`` tests run without inits from the default and
one other key. The other parity tests draw the inits through the JAX
package (the same splits, :func:`jax_simm_draws`) and hand them to the
port as numpy arrays.

Tolerances: against the oracle as the JAX test (5e-3 relative to each
factor's largest entry after 6 iterations, the IS trace rtol 1e-3); against
the JAX package, the fit's factors and IS trace after 6 iterations within
5e-3 relative (measured: ≤ 4e-6), the two-round pipeline's audio within
1e-4 of its peak and its melody path equal on ≥ 99 % of frames; the
dictionaries within 1e-5 relative (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import separate_lead_stereo as jax_separate_lead_stereo
from exemplars_vc_tpu.separate import stereo_simm as jax_stereo_simm
from exemplars_vc_tpu.separate.lead import harmonic_dictionary as jax_harmonic_dictionary
from exemplars_vc_tpu.separate.lead import hann_filter_basis as jax_hann_filter_basis
from exemplars_vc_tpu.separate.lead import klglott88_amplitudes as jax_klglott88
from exemplars_vc_tpu.separate.lead import melody_transition as jax_melody_transition
from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.separate import separate_lead_stereo, stereo_simm
from exemplars_vc_tpu_torch.separate.lead import (
    hann_filter_basis,
    harmonic_dictionary,
    klglott88_amplitudes,
    melody_transition,
)
from exemplars_vc_tpu_torch.separate.stereo_simm import simm_draws
from test_stereo_simm import _stereo_melody_mixture, _tiny_problem
from test_torch_separate import key_kw
from tests.oracles.stereo_simm import stereo_simm_oracle

CPU = "cpu"
FIELDS = ("alpha", "beta", "HGAMMA", "HPHI", "HF0", "WM", "HM")


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def jax_simm_draws(key, F, N, NF0, P, n_filters, n_accomp) -> dict:
    """The inits JAX ``stereo_simm(..., key=key)`` draws, keyed as its
    ``*_init`` arguments."""
    ks = jax.random.split(key, 6)

    def absn(k, shape):
        return np.array(jnp.abs(jax.random.normal(k, shape)).astype(jnp.float32))

    bR = np.array(jax.random.uniform(ks[5], (n_accomp,), dtype=jnp.float32))
    return dict(HGAMMA_init=absn(ks[0], (P, n_filters)), HPHI_init=absn(ks[1], (n_filters, N)),
                HF0_init=absn(ks[2], (NF0, N)), WM_init=absn(ks[3], (F, n_accomp)),
                HM_init=absn(ks[4], (n_accomp, N)), beta_init=np.stack([bR, 1.0 - bR]))


def jax_round_draws(key, x, n_fft, hop, f0_grid, n_filt_atoms, n_filters, n_accomp):
    """(round 1, round 2) inits JAX ``separate_lead_stereo(..., key=key)``
    draws (its rounds take ``jax.random.split(key)``)."""
    F, N = n_fft // 2 + 1, 1 + x.shape[-1] // hop
    return tuple(jax_simm_draws(k, F, N, len(f0_grid), n_filt_atoms, n_filters, n_accomp)
                 for k in jax.random.split(key))


def _inits(inits):
    return {k + "_init": v for k, v in inits.items()}


# ---- counterparts of tests/test_stereo_simm.py -----------------------------


class TestStereoSIMMOracleParity:
    @pytest.mark.parametrize("update_hgamma", [True, False])
    def test_trajectory_matches_float64_oracle(self, update_hgamma):
        SXR, SXL, WF0, WGAMMA, inits, beta = _tiny_problem()
        n_iter = 6
        ref = stereo_simm_oracle(SXR, SXL, WF0, WGAMMA, n_iter=n_iter, beta=beta,
                                 update_hgamma=update_hgamma, **inits)
        got = stereo_simm(SXR, SXL, WF0, WGAMMA, n_filters=inits["HGAMMA"].shape[1],
                          n_accomp=inits["WM"].shape[1], n_iter=n_iter,
                          update_hgamma=update_hgamma, beta_init=beta, device=CPU,
                          **_inits(inits))
        for name in FIELDS:
            assert rel(getattr(got, name).numpy(), ref[name]) < 5e-3, name
        assert np.allclose(got.is_error.numpy(), ref["is_error"], rtol=1e-3)

    def test_is_error_decreases(self):
        SXR, SXL, WF0, WGAMMA, inits, beta = _tiny_problem(seed=3)
        got = stereo_simm(SXR, SXL, WF0, WGAMMA, n_filters=3, n_accomp=4, n_iter=25,
                          beta_init=beta, device=CPU, **_inits(inits))
        errs = got.is_error.numpy()
        assert errs[-1] < errs[0]
        assert np.mean(np.diff(errs) <= 1e-6 * abs(errs[0])) > 0.9

    def test_alpha_beta_normalized(self):
        SXR, SXL, WF0, WGAMMA, inits, beta = _tiny_problem(seed=5)
        got = stereo_simm(SXR, SXL, WF0, WGAMMA, n_filters=3, n_accomp=4, n_iter=10,
                          beta_init=beta, device=CPU, **_inits(inits))
        assert abs(float(got.alpha.sum()) - 1.0) < 1e-5
        assert np.allclose(got.beta.numpy().sum(axis=0), 1.0, atol=1e-5)


class TestSeparateLeadStereo:
    def test_separates_panned_melody(self):
        x, true_lead, f0s = _stereo_melody_mixture()
        res = separate_lead_stereo(x, sample_rate=16000.0, n_fft=1024, hop_length=256,
                                   f0_min=150.0, f0_max=500.0, n_iter=25, n_accomp=8,
                                   n_harmonics=10, device=CPU)
        lead = res.lead.numpy().astype(np.float64)
        assert lead.shape == x.shape
        snr_mix = 10 * np.log10(np.sum(true_lead ** 2) / np.sum((x - true_lead) ** 2))
        snr_est = 10 * np.log10(np.sum(true_lead ** 2) / np.sum((lead - true_lead) ** 2))
        assert snr_est > snr_mix + 5.0, (snr_mix, snr_est)
        voiced = res.f0 > 0
        assert voiced.mean() > 0.5
        centers = np.arange(len(res.f0)) * 256
        seg = x.shape[1] // len(f0s)
        true_f0 = np.asarray(f0s)[np.minimum(centers // seg, len(f0s) - 1)]
        cents = 1200 * np.abs(np.log2(res.f0[voiced] / true_f0[voiced]))
        assert np.median(cents) < 100, np.median(cents)

    def test_alpha_tracks_lead_panning(self):
        kw = dict(n_iter=25, f0_min=150.0, f0_max=500.0, n_accomp=8, n_harmonics=10,
                  device=CPU)
        x, _, _ = _stereo_melody_mixture(pan_lead=0.2, pan_acc=0.7)
        alpha = separate_lead_stereo(x, **kw).model.alpha.numpy()
        assert alpha[0] > alpha[1], alpha
        pi2 = np.pi / 2
        xm, _, _ = _stereo_melody_mixture(pan_lead=pi2 - 0.2, pan_acc=pi2 - 0.7)
        alpham = separate_lead_stereo(xm, **kw).model.alpha.numpy()
        assert alpham[1] > alpham[0], alpham

    def test_mono_input_promoted(self):
        x, _, _ = _stereo_melody_mixture()
        res = separate_lead_stereo(x[0], n_iter=5, f0_min=150.0, f0_max=500.0, n_accomp=4,
                                   device=CPU)
        assert res.lead.shape[0] == 2


class TestHarmonicDictionaryVariants:
    def test_klglott88_amplitudes_decay_and_convergence(self):
        a = klglott88_amplitudes(10)
        assert np.argmax(a) == 1
        assert a[0] > 0.8
        assert np.all(np.diff(a[1:]) < 0)
        assert np.abs(a - klglott88_amplitudes(10, oversample=16384)).max() < 1e-4

    def test_chirped_dictionary_shapes_and_widths(self):
        f0g = 100 * 2.0 ** (np.arange(6) / 12.0)
        W = harmonic_dictionary(f0g, 1024, 16000.0, 8, chirp_per_f0=3)
        assert W.shape == (513, 18) and W.dtype == np.float32
        assert np.allclose(W.sum(axis=0), 1.0, atol=1e-5)
        assert W[:, 2].max() < W[:, 0].max()

    def test_klglott88_source_separates_melody(self):
        from exemplars_vc_tpu_torch.dsp.stft import stft

        x, _, _ = _stereo_melody_mixture(T=8000)
        X = stft(torch.from_numpy(x), n_fft=1024, hop_length=256).transpose(1, 2)
        SXR = torch.clamp(X[0].abs() ** 2, min=1e-20)
        SXL = torch.clamp(X[1].abs() ** 2, min=1e-20)
        sc = 0.5 * (SXR.mean() + SXL.mean())
        f0g = 150.0 * 2.0 ** (np.arange(40) / 24.0)
        WF0 = harmonic_dictionary(f0g, 1024, 16000.0, 10, source="klglott88")
        m = stereo_simm(SXR / sc, SXL / sc, WF0, hann_filter_basis(513, 10), n_filters=3,
                        n_accomp=6, n_iter=15, device=CPU)
        errs = m.is_error.numpy()
        assert np.isfinite(errs).all() and errs[-1] < errs[0]


# ---- parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("source,chirp", [("decay", 1), ("klglott88", 1), ("decay", 3)])
def test_dictionaries_match_jax(source, chirp):
    f0g = 100.0 * 2.0 ** (np.arange(85) / 48.0)
    got = harmonic_dictionary(f0g, 1024, 16000.0, 30, source=source, chirp_per_f0=chirp)
    want = np.asarray(jax_harmonic_dictionary(f0g, 1024, 16000.0, 30, source=source,
                                              chirp_per_f0=chirp))
    assert got.shape == want.shape and rel(got, want) < 1e-5
    assert rel(hann_filter_basis(513, 20), jax_hann_filter_basis(513, 20)) < 1e-5
    assert rel(melody_transition(f0g, 10.0), jax_melody_transition(f0g, 10.0)) < 1e-5
    assert np.array_equal(klglott88_amplitudes(30), jax_klglott88(30))
    with pytest.raises(ValueError, match="unknown source"):
        harmonic_dictionary(f0g, 1024, 16000.0, source="nope")


@pytest.mark.parametrize("update_hgamma,update_accomp", [(True, True), (False, True),
                                                         (True, False)])
def test_stereo_simm_matches_jax(update_hgamma, update_accomp):
    """From the JAX package's own draws of a key, 6 iterations; with the
    diagnostics traces."""
    SXR, SXL, WF0, WGAMMA, inits, _ = _tiny_problem(seed=7)
    key = jax.random.PRNGKey(4)
    kw = dict(n_filters=3, n_accomp=4, n_iter=6, update_hgamma=update_hgamma,
              update_accomp=update_accomp, return_diagnostics=True)
    ref, ref_d = jax_stereo_simm(SXR, SXL, WF0, WGAMMA, key=key, **kw)
    draws = jax_simm_draws(key, *SXR.shape, WF0.shape[1], WGAMMA.shape[1], 3, 4)
    got, got_d = stereo_simm(SXR, SXL, WF0, WGAMMA, device=CPU, **draws, **kw)
    for name in FIELDS + ("is_error",):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 5e-3, name
    assert set(got_d) == set(ref_d)
    for name in got_d:
        assert rel(got_d[name].numpy(), ref_d[name]) < 5e-3, name


@pytest.mark.parametrize("seed", [None, 7])
def test_stereo_simm_from_a_key_matches_jax(seed):
    """No inits: the six-way split of the key (default ``PRNGKey(0)`` when
    None) in both packages; the tolerance of ``test_stereo_simm_matches_jax``."""
    SXR, SXL, WF0, WGAMMA, _, _ = _tiny_problem(seed=7)
    jk, tk = key_kw(seed)
    kw = dict(n_filters=3, n_accomp=4, n_iter=6)
    ref = jax_stereo_simm(SXR, SXL, WF0, WGAMMA, **kw, **jk)
    got = stereo_simm(SXR, SXL, WF0, WGAMMA, device=CPU, **kw, **tk)
    for name in FIELDS + ("is_error",):
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 5e-3, name


def test_simm_draws_fill_only_what_is_missing():
    d = simm_draws(prng.PRNGKey(3), 9, 7, 5, 4, 3, 2)
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        "HGAMMA_init": (4, 3), "HPHI_init": (3, 7), "HF0_init": (5, 7), "WM_init": (9, 2),
        "HM_init": (2, 7), "beta_init": (2, 2)}
    assert torch.allclose(d["beta_init"].sum(0), torch.ones(2))
    SXR, SXL, WF0, WGAMMA, _, _ = _tiny_problem(F=9, N=7, NF0=5, P=4)
    a = stereo_simm(SXR, SXL, WF0, WGAMMA, n_filters=3, n_accomp=2, n_iter=2,
                    key=prng.PRNGKey(3), device=CPU)
    b = stereo_simm(SXR, SXL, WF0, WGAMMA, n_filters=3, n_accomp=2, n_iter=2, device=CPU,
                    **simm_draws(prng.PRNGKey(3), 9, 7, 5, 4, 3, 2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("n_warmup", [10, 0])
def test_separate_lead_stereo_matches_jax(n_warmup):
    """The slice's stereo pipeline, both packages from ``PRNGKey(5)``: host
    powers → round 1 (warm-up + fit) → Viterbi melody → round 2 →
    per-channel Wiener masks, 6 iterations a round on the benchmark
    mixture."""
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture

    x = synthetic_mixture()
    jk, tk = key_kw(5)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter=6, n_warmup=n_warmup)
    ref = jax_separate_lead_stereo(jnp.asarray(x), **jk, **kw)
    got = separate_lead_stereo(x, device=CPU, **tk, **kw)
    assert np.array_equal(got.f0_candidates, ref.f0_candidates)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    for part in ("lead", "accomp"):
        want = np.asarray(getattr(ref, part))
        assert np.abs(getattr(got, part).numpy() - want).max() < 1e-4 * np.abs(x).max(), part
    for name in FIELDS + ("is_error",):
        assert rel(getattr(got.model, name).numpy(), getattr(ref.model, name)) < 5e-3, name


@pytest.mark.parametrize("seed", [None, 7])
def test_separate_lead_stereo_from_a_key_matches_jax(seed):
    """The two-round pipeline with no inits: each round's fits draw from
    its half of ``split(key)`` in both packages; the tolerances of
    ``test_separate_lead_stereo_matches_jax``."""
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture

    x = synthetic_mixture()
    jk, tk = key_kw(seed)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter=6)
    ref = jax_separate_lead_stereo(jnp.asarray(x), **kw, **jk)
    got = separate_lead_stereo(x, device=CPU, **kw, **tk)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    for part in ("lead", "accomp"):
        want = np.asarray(getattr(ref, part))
        assert np.abs(getattr(got, part).numpy() - want).max() < 1e-4 * np.abs(x).max(), part
    for name in FIELDS + ("is_error",):
        assert rel(getattr(got.model, name).numpy(), getattr(ref.model, name)) < 5e-3, name


def test_committed_draws_equal_the_jax_draws():
    """``io/data/jax_simm_draws_key1.npz`` (``tools/jax_simm_draws.py``)
    holds what ``separate_lead_stereo(key=PRNGKey(1))`` draws on the
    benchmark mixture."""
    from exemplars_vc_tpu_torch.io.standin import jax_simm_draws, synthetic_mixture

    x = synthetic_mixture()
    grid = np.arange(1 + int(np.ceil(48 * np.log2(8.0))))
    want = jax_round_draws(jax.random.PRNGKey(1), x, 1024, 256, grid, 20, 4, 20)
    for got, ref in zip(jax_simm_draws(), want):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], ref[k]), k


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (stereo_simm, separate_lead_stereo):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    SXR, SXL, WF0, WGAMMA, _, _ = _tiny_problem()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        stereo_simm(SXR, SXL, WF0, WGAMMA)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        separate_lead_stereo(np.zeros((2, 4000), np.float32))
