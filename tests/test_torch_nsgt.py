"""The port's NSGT (``exemplars_vc_tpu_torch/dsp/nsgt.py``) on the CPU:
counterparts of the eight NSGT tests of ``tests/test_nsgt.py`` (its four
tests of ``dsp/fft.py``, the JAX package's matmul FFT, have none: the port
calls ``torch.fft``) and the same seeded numpy inputs through the JAX
package and the port.

Tolerances: the plan equal to the JAX package's field for field;
coefficients within 1e-4 relative (max |Δ| / max |JAX|) and the inverse
within 1e-4 of the JAX inverse's peak (float32 FFTs of other libraries);
perfect reconstruction as the JAX tests hold it (5e-4 of the peak, 2e-3
for the batch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.dsp.nsgt import insgt as jax_insgt
from exemplars_vc_tpu.dsp.nsgt import nsgt as jax_nsgt
from exemplars_vc_tpu.dsp.nsgt import nsgt_plan as jax_nsgt_plan
from exemplars_vc_tpu_torch.dsp.nsgt import insgt, nsgt, nsgt_plan

CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---- counterparts of tests/test_nsgt.py:64-126 -----------------------------


def test_plan_shapes_and_m_divides_l():
    p = nsgt_plan(16000, 3000, fmin=100.0, bins_per_octave=12)
    assert p.L % 256 == 0 and p.L >= 3000
    assert p.L % p.M == 0
    assert p.n_bands == 2 * p.n_pos + 2
    assert p.idx.shape == p.win.shape == p.dual.shape == p.pos.shape
    assert p.freqs[0] == 0.0 and p.freqs[p.n_pos + 1] == 8000.0


def test_perfect_reconstruction():
    x = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    c = nsgt(x, sr=16000, fmin=100.0, device=CPU)
    back = insgt(c, 3000, sr=16000, fmin=100.0, device=CPU).numpy()
    np.testing.assert_allclose(back, x, atol=5e-4 * np.abs(x).max())


def test_perfect_reconstruction_batched():
    """The JAX test's batched case (there on its matmul FFT)."""
    x = np.random.default_rng(4).standard_normal((2, 2800)).astype(np.float32)
    c = nsgt(x, sr=16000, fmin=120.0, bins_per_octave=8, device=CPU)
    assert c.shape[:2] == (2, nsgt_plan(16000, 2800, 120.0, 8).n_bands)
    back = insgt(c, 2800, sr=16000, fmin=120.0, bins_per_octave=8, device=CPU).numpy()
    np.testing.assert_allclose(back, x, atol=2e-3)


def test_tone_lands_in_matching_band():
    sr, Ls, f0 = 16000, 4000, 880.0
    x = np.sin(2 * np.pi * f0 * np.arange(Ls) / sr).astype(np.float32)
    p = nsgt_plan(sr, Ls, fmin=100.0, bins_per_octave=12)
    mag = nsgt(x, sr=sr, fmin=100.0, device=CPU).abs().numpy()
    band_energy = mag[1 : p.n_pos + 1].sum(axis=-1)
    expect = np.argmin(np.abs(p.freqs[1 : p.n_pos + 1] - f0))
    assert abs(int(np.argmax(band_energy)) - int(expect)) <= 1


def test_constant_q_band_supports_scale_with_frequency():
    p = nsgt_plan(16000, 8000, fmin=100.0, bins_per_octave=12)
    lens = (p.win > 0).sum(axis=1)[1 : p.n_pos + 1]
    assert lens[-1] > 4 * lens[0]


def test_insgt_rejects_mismatched_coefficients():
    x = np.random.default_rng(5).standard_normal(3000).astype(np.float32)
    c = nsgt(x, sr=16000, fmin=100.0, device=CPU)
    with pytest.raises(ValueError, match="do not match the plan"):
        insgt(c[..., : c.shape[-1] // 2], 3000, sr=16000, fmin=100.0, device=CPU)
    with pytest.raises(ValueError, match="do not match the plan"):
        insgt(c, 3000, sr=16000, fmin=200.0, device=CPU)


def test_nsgt_rejects_complex_input():
    with pytest.raises(ValueError, match="real signal"):
        nsgt(torch.ones(1000, dtype=torch.complex64), device=CPU)


def test_plan_length_is_smooth():
    p = nsgt_plan(16000, 256 * 8209, fmin=100.0)
    m = p.L // 256
    for q in (2, 3, 5, 7):
        while m % q == 0:
            m //= q
    assert m == 1 and p.L >= 256 * 8209 and p.L % p.M == 0


# ---- parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("length,fmin,bpo", [(3000, 100.0, 12), (2800, 120.0, 8),
                                             (16000, 65.40639132514966, 12)])
def test_plan_equals_jax(length, fmin, bpo):
    a, b = nsgt_plan(16000, length, fmin, bpo), jax_nsgt_plan(16000, length, fmin, bpo)
    for name in a._fields:
        assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))), name


@pytest.mark.parametrize("shape,fmin,bpo", [((3000,), 100.0, 12), ((2, 2800), 120.0, 8),
                                            ((2, 8000), 65.40639132514966, 12)])
def test_nsgt_and_insgt_match_jax(shape, fmin, bpo):
    x = np.random.default_rng(shape[-1]).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_nsgt(jnp.asarray(x), sr=16000, fmin=fmin, bins_per_octave=bpo))
    got = nsgt(x, sr=16000, fmin=fmin, bins_per_octave=bpo, device=CPU)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) < 1e-4
    back_want = np.asarray(jax_insgt(jnp.asarray(want), shape[-1], sr=16000, fmin=fmin,
                                     bins_per_octave=bpo))
    back = insgt(np.array(want), shape[-1], sr=16000, fmin=fmin, bins_per_octave=bpo,
                 device=CPU).numpy()
    assert rel(back, back_want) < 1e-4


def test_defaults_to_the_card():
    import inspect

    for fn in (nsgt, insgt):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        nsgt(np.zeros(3000, np.float32))
