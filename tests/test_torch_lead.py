"""The port's SIMM lead separation (``exemplars_vc_tpu_torch/separate/
lead.py``) on the CPU: counterparts of ``tests/test_separate_ext.py::
TestLeadSeparation`` and ``tests/test_separation_platform_parity.py::
TestOperatingPoint``, and the same inputs through the JAX package and the
port, from the same key.

Tolerances: after 6 iterations a pass, the audio within 1e-4 of the
mixture's peak and HF0 within 5e-3 relative of the JAX package's, the
melody equal on ≥ 99 % of frames; the operating point (15 iterations, the
benchmark mixture) as the JAX test holds it — the lead energy share within
0.05 of 0.676, the median voiced f0 within 10 Hz of 220 Hz, the lead SDR
above 3 dB — and its melody equal to the JAX run's on ≥ 99 % of frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import separate_lead as jax_separate_lead
from exemplars_vc_tpu.separate import separate_lead_stereo as jax_separate_lead_stereo
from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
from exemplars_vc_tpu_torch.separate import separate_lead, separate_lead_stereo
from test_separate_ext import TestLeadSeparation as JaxLeadCases
from test_torch_separate import key_kw

CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _snr(sig, ref):
    e = ref - sig
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-12))


# ---- counterparts of tests/test_separate_ext.py::TestLeadSeparation --------


class TestLeadSeparation:
    def test_melody_tracked_and_lead_enhanced(self):
        lead, accomp, f0_true = JaxLeadCases()._melody_mixture()
        mix = lead + accomp
        out = separate_lead(mix, sample_rate=16000.0, n_fft=1024, hop_length=256,
                            f0_min=150.0, f0_max=500.0, n_iter=20, n_harmonics=10,
                            n_accomp=4, device=CPU)
        centers = np.clip(np.arange(len(out.f0)) * 256, 0, len(f0_true) - 1)
        truth = f0_true[centers]
        voiced = out.f0 > 0
        assert voiced.mean() > 0.7, voiced.mean()
        err_semitones = np.abs(12 * np.log2(out.f0[voiced] / truth[voiced]))
        assert np.median(err_semitones) < 1.0, np.median(err_semitones)
        est = out.lead.numpy()[0]
        n = min(len(est), len(lead))
        assert _snr(est[:n], lead[:n]) > _snr(mix[:n], lead[:n]) + 2.5

    def test_shapes_and_reconstruction(self):
        lead, accomp, _ = JaxLeadCases()._melody_mixture(T=8000, seed=2)
        mix = np.stack([lead + accomp, lead + 0.5 * accomp])
        out = separate_lead(mix, n_fft=512, hop_length=128, f0_min=150.0, f0_max=500.0,
                            n_iter=10, device=CPU)
        assert out.lead.shape == (2, 8000) and out.accomp.shape == (2, 8000)
        rec = (out.lead + out.accomp).numpy()
        mid = slice(512, 8000 - 512)
        assert np.allclose(rec[:, mid], mix[:, mid], atol=1e-2)


# ---- parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("mono,n_warmup", [(True, 10), (False, 0)])
def test_separate_lead_matches_jax(mono, n_warmup):
    """The mono pipeline on the benchmark mixture (its channel mean, or both
    channels masked alike), both packages from ``PRNGKey(3)``: warm-up,
    pass 1, melody, pass 2, Wiener mask."""
    x = synthetic_mixture()
    x = x.mean(axis=0) if mono else x
    jk, tk = key_kw(3)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0,
              f0_max=800.0, n_accomp=20, n_iter=6, n_warmup=n_warmup)
    ref = jax_separate_lead(jnp.asarray(x), **jk, **kw)
    got = separate_lead(x, device=CPU, **tk, **kw)
    assert np.array_equal(got.f0_candidates, ref.f0_candidates)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    assert rel(got.HF0.numpy(), ref.HF0) < 5e-3
    for part in ("lead", "accomp"):
        want, g = np.asarray(getattr(ref, part)), getattr(got, part)
        assert tuple(g.shape) == want.shape and g.dtype == torch.float32, part
        assert np.abs(g.numpy() - want).max() < 1e-4 * np.abs(x).max(), part


@pytest.mark.parametrize("seed", [None, 7])
def test_separate_lead_from_a_key_matches_jax(seed):
    """No inits: every pass draws from the key (default ``PRNGKey(0)`` when
    None) in both packages; the tolerances of
    ``test_separate_lead_matches_jax``."""
    x = synthetic_mixture().mean(axis=0)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0,
              f0_max=800.0, n_accomp=20, n_iter=6)
    jk, tk = key_kw(seed)
    ref = jax_separate_lead(jnp.asarray(x), **kw, **jk)
    got = separate_lead(x, device=CPU, **kw, **tk)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    assert rel(got.HF0.numpy(), ref.HF0) < 5e-3
    for part in ("lead", "accomp"):
        g, want = getattr(got, part).numpy(), np.asarray(getattr(ref, part))
        assert np.abs(g - want).max() < 1e-4 * np.abs(x).max(), part


def _operating_point(res, lead_img):
    lead, accomp = (np.asarray(a, np.float64) for a in (res.lead, res.accomp))
    e_l, e_a = (lead ** 2).sum(), (accomp ** 2).sum()
    f0 = res.f0[res.f0 > 0]
    ref = lead_img[..., : lead.shape[-1]].astype(np.float64)
    sdr = 10 * np.log10((ref ** 2).sum() / max(((lead - ref) ** 2).sum(), 1e-30))
    return e_l / (e_l + e_a), f0, sdr


def test_lead_energy_share_pinned():
    """Counterpart of ``TestOperatingPoint``: the benchmark scenario's
    converged split (0.6757 in the JAX package on both platforms, true
    share 0.647), the port started from its own draws of the test's key,
    which are the JAX package's.

    The split depends on the random start in both packages
    (``tools/simm_seed_sweep.py``): from ``PRNGKey(0..31)`` the JAX package
    converges to shares 0.22-0.72 (median 0.586, 16 of 32 within 0.05 of
    0.6757), the median f0 218.1 Hz in every run; so the pin holds for this
    key, not for any seed."""
    from exemplars_vc_tpu_torch import prng

    x, lead_img, _ = synthetic_mixture(return_components=True)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter=15)
    ref = jax_separate_lead_stereo(jnp.asarray(x), key=jax.random.PRNGKey(1), **kw)
    res = separate_lead_stereo(x, key=prng.PRNGKey(1), device=CPU, **kw)
    share, f0, sdr = _operating_point(res, lead_img)
    assert abs(share - 0.676) < 0.05, share
    assert len(f0) > 50 and abs(np.median(f0) - 220.0) < 10.0
    assert sdr > 3.0, sdr
    assert np.mean(res.f0 == ref.f0) >= 0.99
    assert abs(share - _operating_point(ref, lead_img)[0]) < 1e-3


def test_entry_point_defaults_to_the_card():
    import inspect

    assert inspect.signature(separate_lead).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        separate_lead(np.zeros(4000, np.float32))
