"""The port's separation glue (``exemplars_vc_tpu_torch/separate/glue.py``)
and separation inputs (``io/standin.py``) on the CPU.

The host transforms compute in numpy float64 in both packages and round to
float32 parts: they are held bit-equal to the JAX package's. The device
helpers are held to the JAX functions on the same inputs at float32
roundoff (1e-5 relative, the ISTFTs 1e-5 of the signal's peak). The three
host-transform tests of ``tests/test_separation_platform_parity.py`` have
counterparts here on the port's copy of the benchmark mixture, which is held
bit-equal to ``bench_separate.synthetic_mixture``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_separate
import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import glue as jglue
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.io.standin import speech_mixture, synthetic_mixture
from exemplars_vc_tpu_torch.separate import glue

CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_synthetic_mixture_equals_bench_separate():
    for a, b in zip(synthetic_mixture(return_components=True),
                    bench_separate.synthetic_mixture(return_components=True)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_speech_mixture_is_two_talkers_of_real_length():
    x, images, sr = speech_mixture(seconds=20.0)
    assert sr == 16000 and x.shape == (2, 20 * sr) and images.shape == (2, 2, 20 * sr)
    assert np.abs(x - images.sum(axis=0)).max() < 1e-6
    assert abs(np.abs(x).max() - 0.5) < 1e-6
    a, b = images[0], images[1]
    np.testing.assert_allclose(a[1], a[0] * (0.35 / 0.9), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b[1, 3:], b[0, :-3] * (0.9 / 0.35), rtol=1e-5, atol=1e-6)
    assert abs(np.corrcoef(a[0], b[0])[0, 1]) < 0.2     # different utterances
    with pytest.raises(ValueError, match="in-repo speech"):
        speech_mixture(seconds=1000.0)


# ---- counterparts of TestHostTransforms ------------------------------------


def test_host_stft_matches_device_stft():
    x, _, _ = synthetic_mixture(return_components=True)
    n_fft, hop = 512, 128
    Xh = glue.host_stft_stack(x, n_fft, hop, fnc=False, device=CPU).abs().numpy()
    Xd = stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).permute(0, 2, 1).abs().numpy()
    assert Xh.shape == Xd.shape
    assert np.abs(Xh - Xd).max() / np.abs(Xd).max() < 1e-5


def test_host_powers_consistent_with_host_stft():
    x, _, _ = synthetic_mixture(return_components=True)
    n_fft, hop = 1024, 256
    SXR, SXL = glue.host_stereo_powers(x, n_fft, hop)
    P = glue.host_stft_stack(x, n_fft, hop, fnc=False, device=CPU).abs().numpy() \
        .astype(np.float64) ** 2
    scale = 0.5 * (P[0].mean() + P[-1].mean())
    assert np.allclose(SXR, P[0] / scale, rtol=1e-4, atol=1e-6)
    assert np.allclose(SXL, P[-1] / scale, rtol=1e-4, atol=1e-6)
    assert np.allclose(glue.host_mean_power(x, n_fft, hop), P.mean(axis=0), rtol=1e-4,
                       atol=1e-9)


def test_host_powers_deterministic():
    x, _, _ = synthetic_mixture(return_components=True)
    a = glue.host_stereo_powers(x, 1024, 256)
    b = glue.host_stereo_powers(x.copy(), 1024, 256)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()


# ---- the port against the JAX package --------------------------------------


@pytest.mark.parametrize("n_fft,hop,fnc", [(400, 80, True), (512, 128, False), (255, 64, True)])
def test_host_transforms_equal_jax_bit_for_bit(n_fft, hop, fnc):
    x = synthetic_mixture()
    got = glue.host_stft_stack(x, n_fft, hop, fnc=fnc, device=CPU)
    ref = jglue.host_stft_stack(x, n_fft, hop, fnc=fnc)
    assert got.dtype == torch.complex64
    assert np.array_equal(got.numpy(), np.asarray(ref))
    for a, b in zip(glue.host_stereo_powers(x, n_fft, hop),
                    jglue.host_stereo_powers(x, n_fft, hop)):
        assert np.array_equal(a, b)
    assert np.array_equal(glue.host_mean_power(x, n_fft, hop),
                          jglue.host_mean_power(x, n_fft, hop))


def test_stft_stack_and_powers_match_jax():
    x = synthetic_mixture()[:, :8000]
    for fnc in (True, False):
        assert rel(glue.stft_stack(t(x), 400, 80, fnc=fnc).numpy(),
                   jglue.stft_stack(jnp.asarray(x), 400, 80, fnc=fnc)) < 1e-5
    X = jglue.stft_stack(jnp.asarray(x), 400, 80, fnc=False)
    for a, b in zip(glue.stereo_powers(t(X)), jglue.stereo_powers(X)):
        assert rel(a.numpy(), b) < 1e-5
    Xf = jnp.transpose(X, (1, 2, 0))
    assert rel(glue.mean_power(t(Xf)).numpy(), jglue.mean_power(Xf)) < 1e-5
    assert rel(glue.unit_power(t(Xf)).numpy(), jglue.unit_power(Xf)) < 1e-5


@pytest.mark.parametrize("fnc", [True, False])
def test_masked_istft_matches_jax(fnc):
    x = synthetic_mixture()[:, :6000]
    X = jglue.host_stft_stack(x, 400, 80, fnc=fnc)
    gain = np.random.default_rng(0).uniform(0, 1, X.shape).astype(np.float32)
    got = glue.masked_istft(t(X), t(gain), 400, 80, 6000, fnc=fnc)
    ref = jglue.masked_istft(X, jnp.asarray(gain), 400, 80, 6000, fnc=fnc)
    for g, r in zip(got, ref):
        assert g.shape == (2, 6000)
        assert rel(g.numpy(), r) < 1e-5
    np.testing.assert_allclose((got[0] + got[1]).numpy(), x, atol=1e-5)


def test_images_istft_matches_jax():
    rng = np.random.default_rng(1)
    Y = (rng.standard_normal((3, 201, 40, 2)) + 1j * rng.standard_normal((3, 201, 40, 2))) \
        .astype(np.complex64)
    got = glue.images_istft(t(Y), 400, 80, 3100)
    ref = jglue.images_istft(jnp.asarray(Y), 400, 80, 3100)
    assert got.shape == (3, 2, 3100)
    assert rel(got.numpy(), ref) < 1e-5


def test_spatial_builders_match_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 4000)).astype(np.float32)
    assert rel(glue.empirical_spatial_cov(t(img), 256, 64, 0.1).numpy(),
               jglue.empirical_spatial_cov(jnp.asarray(img), 256, 64, 0.1)) < 1e-5
    theta = np.array([0.3, 1.2], np.float32)
    delay = np.array([2.0, -1.5], np.float32)
    freqs = (np.arange(129) / 256).astype(np.float32)
    a = glue.anechoic_steering(t(theta), t(delay), t(freqs))
    a_ref = jglue.anechoic_steering(jnp.asarray(theta), jnp.asarray(delay), jnp.asarray(freqs))
    assert a.dtype == torch.complex64 and rel(a.numpy(), a_ref) < 1e-5
    R = glue.steering_to_spatial(a, 0.05)
    R_ref = jglue.steering_to_spatial(a_ref, 0.05)
    assert R.dtype == torch.complex64 and rel(R.numpy(), R_ref) < 1e-5
    S = glue.stack_spatial(R[0], R[1], 3)
    assert S.shape == (4, 129, 2, 2)
    assert np.array_equal(S.numpy(), np.asarray(jglue.stack_spatial(jnp.asarray(R.numpy()[0]),
                                                                    jnp.asarray(R.numpy()[1]),
                                                                    3)))


def test_host_stft_stack_defaults_to_the_card():
    import inspect

    assert inspect.signature(glue.host_stft_stack).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        glue.host_stft_stack(np.zeros((2, 800), np.float32), 400, 80)
