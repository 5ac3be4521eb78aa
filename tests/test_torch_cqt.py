"""The port's constant-Q transform (``exemplars_vc_tpu_torch/dsp/cqt.py``) on
the CPU: counterparts of ``tests/test_cqt.py`` and the same seeded numpy
inputs through the JAX package and the port.

Tolerances: the coefficients within 1e-4 relative (max |Δ| / max |JAX|) of
the JAX package's (one float32 convolution summed in another order); the
reflect pad equal to numpy's ``np.pad(mode="reflect")``, also where the pad
is longer than the signal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.dsp.cqt import cqt as jax_cqt
from exemplars_vc_tpu.dsp.cqt import hybrid_cqt as jax_hybrid_cqt
from exemplars_vc_tpu_torch.dsp.cqt import (
    cqt,
    cqt_frequencies,
    cqt_magnitude,
    hybrid_cqt,
    reflect_pad,
)
from test_cqt import naive_cqt_frame

CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---- counterparts of tests/test_cqt.py -------------------------------------


def test_cqt_matches_naive_inner_products():
    sr, hop = 8000, 200
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    freqs = cqt_frequencies(36, 55.0, 12)
    C = cqt(x, sr=sr, hop_length=hop, fmin=55.0, n_bins=36, bins_per_octave=12,
            device=CPU).numpy()
    Q = 1.0 / (2.0 ** (1.0 / 12) - 1.0)
    max_len = int(np.ceil(Q * sr / 55.0))
    xp = np.pad(x, (max_len // 2, max_len // 2), mode="reflect")
    for fi in (0, 3, 10):
        ref = naive_cqt_frame(xp[fi * hop : fi * hop + max_len], sr, freqs, 12)
        np.testing.assert_allclose(C[fi], ref, rtol=2e-4, atol=2e-5)


def test_cqt_tone_peaks_at_its_bin():
    sr = 8000
    freqs = cqt_frequencies(48, 55.0, 12)
    t = np.arange(8000) / sr
    for target_bin in (12, 30, 43):
        x = np.sin(2 * np.pi * freqs[target_bin] * t).astype(np.float32)
        M = cqt_magnitude(x, sr=sr, hop_length=400, fmin=55.0, n_bins=48,
                          bins_per_octave=12, device=CPU).numpy()
        mid = M[M.shape[0] // 2]
        assert int(np.argmax(mid)) == target_bin
        # hann-windowed unit-amplitude tone → |coef| ≈ 0.5 at the center bin
        assert 0.35 < mid[target_bin] < 0.65


def test_cqt_rejects_bins_above_nyquist():
    with pytest.raises(ValueError, match="Nyquist"):
        cqt(np.zeros(1000, np.float32), sr=8000, fmin=1000.0, n_bins=36,
            bins_per_octave=12, device=CPU)


def test_cqt_batched_leading_axes():
    x = np.random.default_rng(1).standard_normal((3, 2000)).astype(np.float32)
    C = cqt(x, sr=8000, hop_length=500, fmin=110.0, n_bins=24, device=CPU)
    assert C.shape[:1] == (3,) and C.shape[-1] == 24 and C.dtype == torch.complex64
    single = cqt(x[1], sr=8000, hop_length=500, fmin=110.0, n_bins=24, device=CPU)
    np.testing.assert_allclose(C[1].numpy(), single.numpy(), rtol=1e-5)


def test_hybrid_cqt_covers_full_spectrum():
    sr, f_lo, f_hi = 16000, 220.0, 7000.0
    t = np.arange(8000) / sr
    x = (np.sin(2 * np.pi * f_lo * t) + np.sin(2 * np.pi * f_hi * t)).astype(np.float32)
    cq, lin, lin_freqs = hybrid_cqt(x, sr=sr, n_bins=60, device=CPU)
    assert cq.shape[-2] == lin.shape[-2]               # aligned hop grid
    freqs_cq = cqt_frequencies(60, 32.70319566257483)
    assert lin_freqs[0] > freqs_cq[-1]                 # complementary coverage
    k_lo = int(np.argmax(cq.abs().numpy().mean(axis=0)))
    assert abs(freqs_cq[k_lo] - f_lo) / f_lo < 0.06
    k_hi = int(np.argmax(lin.abs().numpy().mean(axis=0)))
    assert abs(lin_freqs[k_hi] - f_hi) < 40.0 + 1e-9


# ---- parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("T,pad", [(1, 3), (2, 5), (5, 0), (5, 4), (7, 30), (17, 100)])
def test_reflect_pad_equals_numpy(T, pad):
    """numpy's reflect semantics, also where the pad is several times the
    signal (``F.pad(mode="reflect")`` refuses a pad ≥ the length)."""
    x = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32)
    want = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    assert np.array_equal(reflect_pad(torch.from_numpy(x), pad).numpy(), want)


@pytest.mark.parametrize("T", [16000, 1000])
def test_cqt_matches_jax_at_the_defaults(T):
    """The defaults (C1, 84 bins, 16 kHz): the pad is 4110 samples, so the
    1000-sample signal is reflected over and over, as numpy and JAX do."""
    x = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32)
    want = np.asarray(jax_cqt(jnp.asarray(x)))
    got = cqt(x, device=CPU).numpy()
    assert got.shape == want.shape
    assert rel(got, want) < 1e-4


def test_hybrid_cqt_matches_jax():
    x = np.random.default_rng(3).standard_normal(6000).astype(np.float32)
    want = jax_hybrid_cqt(jnp.asarray(x), sr=16000, n_bins=60)
    got = hybrid_cqt(x, sr=16000, n_bins=60, device=CPU)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and rel(g.numpy(), np.asarray(w)) < 1e-4
    assert np.array_equal(got[2], want[2])


def test_defaults_to_the_card():
    import inspect

    for fn in (cqt, hybrid_cqt):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cqt(np.zeros(2000, np.float32))
