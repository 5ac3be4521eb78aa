"""The port's DSP (windows, STFT/ISTFT, mel/MFCC, mel-cepstrum) against the
JAX reference on the same seeded numpy inputs (JAX on the CPU).

Tolerances: both sides compute in float32 with different FFT and reduction
orders, so values agree to a few float32 ulps of the largest magnitude:
rtol 1e-5 with an absolute floor of 1e-5 of the array's peak (bins far
below the peak carry the absolute rounding of the peak's transform). The
numpy table builders are copies and must be bit-equal."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.dsp.windows import get_window as jget_window
from exemplars_vc_tpu_torch.dsp.windows import get_window

# both packages' dsp/__init__ re-export functions under the module names
jmcep = importlib.import_module("exemplars_vc_tpu.dsp.mcep")
jmel = importlib.import_module("exemplars_vc_tpu.dsp.mel")
jstft = importlib.import_module("exemplars_vc_tpu.dsp.stft")
tmcep = importlib.import_module("exemplars_vc_tpu_torch.dsp.mcep")
tmel = importlib.import_module("exemplars_vc_tpu_torch.dsp.mel")
tstft = importlib.import_module("exemplars_vc_tpu_torch.dsp.stft")


def _close(got, ref, rtol=1e-5, floor=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _speechlike(rng, n):
    t = np.arange(n) / 16000.0
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 1.5 * t)
    ph = 2 * np.pi * np.cumsum(f0) / 16000.0
    x = sum(np.sin(k * ph) / k for k in range(1, 12)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.3 * x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("args", [(16000, 400, 128), (16000, 512, 64), (22050, 1024, 80)])
def test_mel_filterbank_copy_bit_equal(args):
    sr, n_fft, n_mels = args
    np.testing.assert_array_equal(tmel.mel_filterbank(sr, n_fft, n_mels),
                                  jmel.mel_filterbank(sr, n_fft, n_mels))


def test_dct_and_warped_basis_copies_bit_equal():
    np.testing.assert_array_equal(tmel.dct_matrix(20, 128), jmel.dct_matrix(20, 128))
    np.testing.assert_array_equal(tmcep.warped_basis(257, 25, 0.42),
                                  jmcep.warped_basis(257, 25, 0.42))
    f = np.linspace(0, 8000, 97)
    np.testing.assert_array_equal(tmel.hz_to_mel(f), jmel.hz_to_mel(f))
    np.testing.assert_array_equal(tmel.mel_to_hz(f / 100), jmel.mel_to_hz(f / 100))


@pytest.mark.parametrize("name,periodic", [("hann", True), ("blackman", False),
                                           ("hamming", True)])
def test_window_matches(name, periodic):
    # the JAX window is evaluated in float32 (x64 off: cos of a float32
    # argument near 2π carries ~1e-7 absolute error), the port's in float64
    np.testing.assert_allclose(get_window(name, 400, periodic=periodic).numpy(),
                               np.asarray(jget_window(name, 400, periodic=periodic)),
                               atol=1e-6)
    with pytest.raises(ValueError, match="kaiser"):
        get_window("kaiser", 16)


def test_stft_matches_jax():
    rng = np.random.default_rng(0)
    x = np.stack([_speechlike(rng, 8000), _speechlike(rng, 8000)[::-1].copy()])
    got = tstft.stft(torch.as_tensor(x))
    ref = np.asarray(jstft.stft(jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 101, 201)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("length", [None, 7000, 9000])
def test_istft_matches_jax(length):
    rng = np.random.default_rng(1)
    spec = np.asarray(jstft.stft(jnp.asarray(_speechlike(rng, 8000))))
    spec = spec * np.exp(1j * rng.uniform(0, 0.3, spec.shape)).astype(np.complex64)
    got = tstft.istft(torch.as_tensor(spec), length=length).numpy()
    ref = np.asarray(jstft.istft(jnp.asarray(spec), length=length))
    assert got.shape == ref.shape
    _close(got, ref)


def test_istft_inverts_stft():
    x = _speechlike(np.random.default_rng(2), 6000)
    y = tstft.istft(tstft.stft(torch.as_tensor(x)), length=len(x)).numpy()
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_frame_signal_matches_jax():
    x = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(tstft.frame_signal(torch.as_tensor(x), 400, 80).numpy(),
                                  np.asarray(jstft.frame_signal(jnp.asarray(x), 400, 80)))


def test_melspectrogram_and_mfcc_match_jax():
    rng = np.random.default_rng(3)
    x = _speechlike(rng, 9600)
    x[6000:] = 0.0                     # digital silence exercises the top_db floor
    _close(tmel.melspectrogram(torch.as_tensor(x)).numpy(),
           np.asarray(jmel.melspectrogram(jnp.asarray(x))))
    got = tmel.mfcc(torch.as_tensor(x)).numpy()
    ref = np.asarray(jmel.mfcc(jnp.asarray(x)))
    assert got.shape == ref.shape == (121, 20)
    # dB of near-equal powers: log compresses the relative error further
    _close(got, ref)


def test_mfcc_batched_equals_per_utterance():
    rng = np.random.default_rng(4)
    xs = np.stack([_speechlike(rng, 4000), 0.1 * _speechlike(rng, 4000)])
    batched = tmel.mfcc(torch.as_tensor(xs))
    for i in range(2):
        torch.testing.assert_close(batched[i], tmel.mfcc(torch.as_tensor(xs[i])))


def test_mcep_matches_jax():
    # 10 float32 Newton steps with batched solves on each side; the mel-
    # cepstra agree to 1e-4 of their peak, far inside what moves MCD
    x = _speechlike(np.random.default_rng(5), 6400)
    got = tmcep.mcep(torch.as_tensor(x)).numpy()
    ref = np.asarray(jmcep.mcep(jnp.asarray(x)))
    assert got.shape == ref.shape == (76, 26)
    _close(got, ref, rtol=1e-4, floor=1e-4)
