"""The port's MinQT (``exemplars_vc_tpu_torch/dsp/minqt.py``) on the CPU:
counterparts of ``tests/test_minqt.py`` and the same seeded numpy inputs
through the JAX package and the port.

Tolerances: the plan equal to the JAX package's field for field; the
analysis within 1e-4 relative (max |Δ| / max |JAX|); the 48-step CG inverse
within 1e-4 of the signal's peak (the float32 CG steps sum in another order,
and each step feeds the next); the adjoint identity to 1e-3 relative and the
in-band reconstruction above 40 dB, as the JAX tests hold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.dsp.minqt import _conv_adjoint as jax_conv_adjoint
from exemplars_vc_tpu.dsp.minqt import iminqt as jax_iminqt
from exemplars_vc_tpu.dsp.minqt import minqt as jax_minqt
from exemplars_vc_tpu.dsp.minqt import minqt_plan as jax_minqt_plan
from exemplars_vc_tpu_torch.dsp.minqt import (
    _conv_adjoint,
    _conv_analysis,
    iminqt,
    minqt,
    minqt_plan,
)

SR = 16000
CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def plan():
    return minqt_plan(SR, bins_per_octave=12, lin_fft=1024)


def _bank(plan):
    return torch.from_numpy(plan.kernel)[:, None, :]


# ---- counterparts of tests/test_minqt.py -----------------------------------


def test_min_q_property(plan):
    assert plan.q_values.shape == (plan.n_bins,)
    assert plan.q_values.min() >= plan.q_min - 0.5
    lin_q = plan.q_values[plan.n_cq :]
    assert (np.diff(lin_q) > 0).all()
    assert lin_q[0] >= plan.q_min


def test_split_frequency_formula(plan):
    kmax = int(np.ceil(plan.q_min))
    expect = 2.0 ** (-1 / 12) * kmax * SR / plan.lin_fft
    assert abs(plan.split_hz - expect) < 1e-9
    assert abs(plan.freqs_hz[plan.n_cq] - kmax * SR / plan.lin_fft) < 1e-9
    assert (np.diff(plan.freqs_hz) > 0).all()


def test_analysis_shapes(plan):
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    C = minqt(x, sr=SR, device=CPU)
    assert C.ndim == 2 and C.shape[1] == plan.n_bins
    assert C.dtype == torch.complex64
    C2 = minqt(np.stack([x, x]), sr=SR, device=CPU)
    assert C2.shape == (2,) + C.shape
    # the batch of two takes another convolution algorithm than one signal
    # (its float32 sums differ in the last bits): 1e-5 of the largest
    # coefficient, where the JAX test's element-wise rtol is 1e-6
    assert rel(C2[0].numpy(), C.numpy()) < 1e-5


def test_adjoint_identity(plan):
    """<A x, c> == <x, Aᴴ c>: the transposed conv is the exact adjoint. The
    signal is 2048 samples padded as ``minqt`` pads it (at 2048 alone the
    JAX test's signal is shorter than one atom, and its analysis has no
    frame)."""
    rng = np.random.default_rng(1)
    T = 2048 + 2 * (plan.L // 2)
    kernel = _bank(plan)
    x = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32))
    Ax = _conv_analysis(x, kernel, plan.hop)
    c = torch.from_numpy(rng.standard_normal(tuple(Ax.shape)).astype(np.float32))
    lhs = float((Ax * c).sum())
    rhs = float((x * _conv_adjoint(c, kernel, plan.hop, T)).sum())
    assert abs(lhs - rhs) <= 1e-3 * max(abs(lhs), 1.0)


def test_sine_peaks_at_matching_bin(plan):
    t = np.arange(8192) / SR
    for f_target in (110.0, 2000.0):
        x = np.sin(2 * np.pi * f_target * t).astype(np.float32)
        mag = minqt(x, sr=SR, device=CPU).abs().numpy()[4:-4]   # interior frames
        f_peak = plan.freqs_hz[int(mag.mean(axis=0).argmax())]
        assert abs(np.log2(f_peak / f_target)) < 1.5 / 12, (f_target, f_peak)


def _in_band(T=4096):
    rng = np.random.default_rng(2)
    t = np.arange(T) / SR
    x = np.zeros(T)
    for f in (90.0, 220.0, 700.0, 1500.0, 3300.0, 6100.0):
        x += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
    return x.astype(np.float32)


def test_exact_inverse_in_band():
    """SNR > 40 dB on the interior (edges lack frame coverage)."""
    x = _in_band()
    T = len(x)
    y = iminqt(minqt(x, sr=SR, device=CPU), length=T, sr=SR, device=CPU).numpy()
    lo, hi = 1024, T - 1024
    err = x[lo:hi] - y[lo:hi]
    snr = 10 * np.log10(np.sum(x[lo:hi] ** 2) / max(np.sum(err**2), 1e-20))
    assert snr > 40.0, snr


# ---- parity with the JAX package -------------------------------------------


def test_plan_equals_jax():
    for kw in ({}, {"bins_per_octave": 24, "lin_fft": 2048, "q": 1.5, "hop": 300}):
        a = minqt_plan(SR, **kw)
        b = jax_minqt_plan(SR, **kw)
        for name in a._fields:
            assert np.array_equal(np.asarray(getattr(a, name)),
                                  np.asarray(getattr(b, name))), name


@pytest.mark.parametrize("T", [4096, 5000])
def test_minqt_matches_jax(T):
    """5000 samples: the last frame is partial."""
    x = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32)
    want = np.asarray(jax_minqt(jnp.asarray(x), sr=SR))
    got = minqt(x, sr=SR, device=CPU).numpy()
    assert got.shape == want.shape and rel(got, want) < 1e-4


def test_adjoint_matches_jax_with_a_partial_last_frame(plan):
    """The adjoint's zero pad on the right edge (T_padded past the last
    frame's support)."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((1, 2 * plan.n_bins, 9)).astype(np.float32)
    t_padded = (9 - 1) * plan.hop + plan.L + 100
    want = np.asarray(jax_conv_adjoint(jnp.asarray(c), jnp.asarray(plan.kernel), plan.hop,
                                       t_padded))
    got = _conv_adjoint(torch.from_numpy(c), _bank(plan), plan.hop, t_padded).numpy()
    assert got.shape == want.shape == (1, t_padded)
    assert not want[:, -100:].any() and not got[:, -100:].any()
    assert rel(got, want) < 1e-4


def test_iminqt_matches_jax():
    x = _in_band()
    C = np.array(jax_minqt(jnp.asarray(x), sr=SR))
    want = np.asarray(jax_iminqt(jnp.asarray(C), length=len(x), sr=SR))
    got = iminqt(C, length=len(x), sr=SR, device=CPU).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(x).max()


def test_defaults_to_the_card():
    import inspect

    for fn in (minqt, iminqt):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        minqt(np.zeros(4096, np.float32))
