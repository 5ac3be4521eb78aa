"""The port's fused Griffin-Lim (``dsp/griffin_lim_cuda.py``) against the JAX
reference ``dsp/griffin_lim_pallas.py`` (its kernel run in interpret mode, as
``tests/test_pallas_kernels.py`` runs it), on seeded numpy inputs. On the
CPU ``gl_angles_fused`` runs its plain twin; the CUDA kernel is held to the
twin in ``test_torch_kernels_cuda.py``.

Tolerances: the basis builders are copies and must be bit-equal when given
the same window (the port's float64-built window and JAX's float32 one
differ by ≤ 2.4e-7, float32 cos implementations); phases agree within
rtol 1e-4, atol 1e-5 after 6 iterations (float32 matmuls in another order,
amplified by the normalisation), the projection within the
``test_gl_pallas_projection_matches_istft_stft`` tolerance, and quality by
the spectral-convergence rule of ``test_gl_pallas_quality_parity_with_xla_gl``.

The centered projection (``center=True``, the production's) is held to
``stft(istft(s))[:F]`` of both packages within the center=False
projection's tolerance. Its iterations, run by the float64 twin on speech,
give audio within 1e-4 relative L2 of the port's CPU ``griffin_lim`` and of
the JAX package's (read: ≤ 7.3e-6 after 60 iterations): both loops round in
float32, and the momentum carries that rounding into the phase of bins whose
update nearly cancels, so they are held to the float64 twin, not to each
other's bits. The float32 twin's mean phase error against the float64 one
may be at most twice the production loop's own (+ 1e-7; read 1.5×)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exemplars_vc_tpu.dsp.griffin_lim_pallas as jglp
from exemplars_vc_tpu.dsp.fft import _irdft_mats as j_irdft_mats
from exemplars_vc_tpu.dsp.fft import _rdft_mats as j_rdft_mats
from exemplars_vc_tpu.dsp.griffin_lim import griffin_lim as j_griffin_lim
from exemplars_vc_tpu.dsp.stft import istft as j_istft
from exemplars_vc_tpu.dsp.stft import stft as j_stft
from exemplars_vc_tpu_torch.dsp import griffin_lim_cuda as tglc
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.dsp.stft import istft, stft
from exemplars_vc_tpu_torch.dsp.windows import get_window
from exemplars_vc_tpu_torch.io.wav import read_wav

N_SMS = 132
SPEECH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts",
                      "audio", "heldout_100162_stft_parity.wav")


def _inputs(seed, F, n_fft, zero_rows=()):
    rng = np.random.default_rng(seed)
    nb = n_fft // 2 + 1
    mag = np.abs(rng.standard_normal((F, nb))).astype(np.float32)
    mag[list(zero_rows)] = 0.0
    ang = np.exp(2j * np.pi * rng.random((F, nb))).astype(np.complex64)
    return mag, ang


@pytest.mark.parametrize("n_fft,hop", [(32, 8), (64, 16), (400, 80)])
def test_basis_copies_bit_equal(monkeypatch, n_fft, hop):
    np.testing.assert_array_equal(tglc._rdft_mats(n_fft)[0], j_rdft_mats(n_fft)[0])
    np.testing.assert_array_equal(tglc._rdft_mats(n_fft)[1], j_rdft_mats(n_fft)[1])
    np.testing.assert_array_equal(tglc._irdft_mats(n_fft)[0], j_irdft_mats(n_fft)[0])
    np.testing.assert_array_equal(tglc._irdft_mats(n_fft)[1], j_irdft_mats(n_fft)[1])
    # hand the JAX builders the port's window; the builders must then agree
    monkeypatch.setattr(jglp, "get_window",
                        lambda name, n, periodic=True, dtype=None: get_window(name, n).numpy())
    for got, ref in zip(tglc._gl_mats(n_fft, hop, "hann"),
                        jglp._gl_mats.__wrapped__(n_fft, hop, "hann")):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    for F in (1, 12, 688):
        np.testing.assert_array_equal(tglc._inv_wsum(F, n_fft, hop, "hann"),
                                      jglp._inv_wsum.__wrapped__(F, n_fft, hop, "hann"))


@pytest.mark.parametrize("zero_rows", [(), (0, 5, 11)])
def test_fused_twin_matches_pallas_interpret(zero_rows):
    F, n_fft, hop = 12, 32, 8
    mag, ang = _inputs(5, F, n_fft, zero_rows)
    ref = jglp.gl_angles_fused(jnp.asarray(mag), jnp.asarray(ang), n_fft, hop, n_iter=6,
                               momentum=0.9, interpret=True)
    before = tglc.gl_angles_fused.launches
    got = tglc.gl_angles_fused(torch.as_tensor(mag), torch.as_tensor(ang), n_fft, hop,
                               n_iter=6, momentum=0.9)
    assert got.dtype == torch.complex64 and got.shape == (F, n_fft // 2 + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the kernel wrapper was not entered: a CPU tensor takes the twin
    assert tglc.gl_angles_fused.launches == before


def test_projection_matches_istft_stft_and_jax():
    rng = np.random.default_rng(6)
    F, n_fft, hop = 10, 40, 8
    nb = n_fft // 2 + 1
    spec = (rng.standard_normal((F, nb)) + 1j * rng.standard_normal((F, nb))
            ).astype(np.complex64)
    got = tglc.project_nocenter_reference(torch.as_tensor(spec), n_fft, hop)
    t = torch.as_tensor(spec)
    ref = stft(istft(t, n_fft=n_fft, hop_length=hop, center=False), n_fft=n_fft,
               hop_length=hop, center=False)[:F]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)
    jref = jglp.project_nocenter_reference(jnp.asarray(spec), n_fft, hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4, atol=1e-5)


def test_shape_guard():
    assert tglc.supports(688, 400, 80)
    assert not tglc.supports(688, 400, 0)
    assert not tglc.supports(688, 400, 96)      # 400 % 96 != 0
    mag, ang = _inputs(1, 8, 400)
    for hop in (96, 0):
        with pytest.raises(ValueError, match="hop must divide n_fft"):
            tglc.gl_angles_fused(torch.as_tensor(mag), torch.as_tensor(ang), 400, hop, 2, 0.9)
    with pytest.raises(ValueError, match="n_fft//2"):
        tglc.gl_angles_fused(torch.as_tensor(mag[:, :-1]), torch.as_tensor(ang[:, :-1]),
                             400, 80, 2, 0.9)
    with pytest.raises(ValueError, match="complex"):
        tglc.gl_angles_fused(torch.as_tensor(mag), torch.as_tensor(mag), 400, 80, 2, 0.9)


def test_quality_parity_with_production_griffin_lim():
    """Phases from the fused twin reconstruct the magnitude as well as the
    port's production (center=True) ``griffin_lim`` at the same budget."""
    rng = np.random.default_rng(7)
    n_fft, hop = 64, 16
    t = np.arange(4096) / 16000.0
    x = np.sin(2 * np.pi * 220 * t) + 0.4 * np.sin(2 * np.pi * 440 * t)
    mag = torch.abs(stft(torch.as_tensor(x, dtype=torch.float32), n_fft=n_fft, hop_length=hop))
    F = mag.shape[0]
    ang0 = torch.as_tensor(np.exp(2j * np.pi * rng.random(tuple(mag.shape))).astype(np.complex64))

    def sc(y):
        m = torch.abs(stft(y, n_fft=n_fft, hop_length=hop))[:F]
        return float(torch.linalg.norm(m - mag) / torch.linalg.norm(mag))

    y_x = griffin_lim(mag, n_fft=n_fft, hop_length=hop, n_iter=30, momentum=0.9,
                      init_phase=ang0)
    a_p = tglc.gl_angles_fused(mag, ang0, n_fft, hop, n_iter=30, momentum=0.9)
    y_p = istft(mag * a_p, n_fft=n_fft, hop_length=hop)
    assert torch.isfinite(y_p).all()
    assert sc(y_p) < 1.3 * sc(y_x) + 0.02, (sc(y_p), sc(y_x))


# F = 4 is the fewest frames the route takes at n_fft 400, hop 80 (the
# trimmed signal, 240 samples, must outlast the 200-sample reflect pad); at
# F ≤ 132 a tile is one frame, and frame 0's mirrored samples sum frames up
# to n_fft/hop = 5 away, beyond the r − 1 = 4 neighbours of the
# center=False overlap-add; 48 is the stream's shape, 620 a served one
# (tile 5); (6, 45, 15) takes an odd n_fft
@pytest.mark.parametrize("F,n_fft,hop", [(4, 400, 80), (5, 400, 80), (48, 400, 80),
                                         (620, 400, 80), (10, 40, 8), (7, 32, 8),
                                         (6, 45, 15)])
def test_center_projection_matches_istft_stft_and_jax(F, n_fft, hop):
    rng = np.random.default_rng(F + n_fft)
    nb = n_fft // 2 + 1
    spec = (rng.standard_normal((F, nb)) + 1j * rng.standard_normal((F, nb))
            ).astype(np.complex64)
    got = tglc.project_center_reference(torch.as_tensor(spec), n_fft, hop)
    t = torch.as_tensor(spec)
    ref = stft(istft(t, n_fft=n_fft, hop_length=hop), n_fft=n_fft, hop_length=hop)[:F]
    assert got.shape == ref.shape == (F, nb)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3, atol=1e-4)
    jspec = jnp.asarray(spec)
    jref = j_stft(j_istft(jspec, n_fft=n_fft, hop_length=hop), n_fft=n_fft,
                  hop_length=hop)[:F]
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-3, atol=1e-4)
    # the centered and uncentered projections differ at the edge frames only
    plain = tglc.project_nocenter_reference(t, n_fft, hop).numpy()
    r = n_fft // hop
    if F > 2 * r:
        np.testing.assert_allclose(got.numpy()[r:F - r], plain[r:F - r], rtol=1e-3, atol=1e-4)
    assert not np.allclose(got.numpy()[0], plain[0], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n_iter,silent", [(20, 0), (60, 3)])
def test_centered_twin_matches_production_griffin_lim(n_iter, silent):
    """The float64 centered twin, then the final ISTFT, against the port's
    CPU ``griffin_lim`` and the JAX package's on 1 s of in-repo speech (the
    magnitude scaled by 1.1, as a converted one is not consistent), seeded
    with its phase; ``silent`` leading frames zeroed as digital silence."""
    x, _ = read_wav(SPEECH)
    n_fft, hop = 400, 80
    S = stft(torch.as_tensor(x[:16000], dtype=torch.float32), n_fft=n_fft, hop_length=hop)
    mag = torch.abs(S) * 1.1
    mag[:silent] = 0.0
    a = torch.abs(S)
    ang0 = torch.where(a > 0.0, S / torch.clamp(a, min=1e-16),
                       torch.ones((), dtype=torch.complex64))
    y_port, a_port = griffin_lim(mag, n_fft=n_fft, hop_length=hop, n_iter=n_iter,
                                 init_phase=S, return_phase=True)
    y_jax = np.asarray(j_griffin_lim(jnp.asarray(mag.numpy()), n_fft=n_fft, hop_length=hop,
                                     n_iter=n_iter, init_phase=jnp.asarray(S.numpy())))
    a64 = tglc.gl_angles_fused_plain(mag.double(), ang0.to(torch.complex128), n_fft, hop,
                                     n_iter, 0.9, center=True)
    a32 = tglc.gl_angles_fused(mag, ang0, n_fft, hop, n_iter, 0.9, center=True)
    y64 = istft((mag.double() * a64).to(torch.complex64), n_fft=n_fft, hop_length=hop)

    def rel(u, v):
        return float(np.linalg.norm(np.asarray(u) - np.asarray(v)) / np.linalg.norm(v))

    assert y64.shape == y_port.shape == y_jax.shape
    assert rel(y_port, y64.numpy()) <= 1e-4
    assert rel(y_jax, y64.numpy()) <= 1e-4
    e32 = float((a32 - a64.to(torch.complex64)).abs().mean())
    e_port = float((a_port - a64.to(torch.complex64)).abs().mean())
    assert e32 <= 2 * e_port + 1e-7, (e32, e_port)


@pytest.mark.parametrize("F,n_fft,hop,n_iter,want", [
    (201, 400, 80, 300, "fused"), (620, 400, 80, 300, "fused"), (1361, 400, 80, 300, "fused"),
    (48, 400, 80, 60, "fused"), (16, 400, 80, 60, "fused"), (4, 400, 80, 300, "fused"),
    (2508, 400, 80, 300, "fused"), (2509, 400, 80, 300, "eager"),
    (3000, 400, 80, 300, "eager"), (620, 400, 96, 300, "eager"),
    (3, 400, 80, 300, "eager"), (620, 400, 80, 0, "eager"),
])
def test_route_is_a_function_of_the_shape(F, n_fft, hop, n_iter, want):
    """Serve shapes (201–1361 × 201) and the stream's (16–48 × 201) take
    the fused kernel; 3,000 frames (a tile beyond shared memory), a hop
    that does not divide n_fft, a signal too short for the reflect pad, and
    n_iter = 0 do not (``griffin_lim`` sends them all to its eager loop);
    every refusal but n_iter = 0 is the plan's own."""
    assert tglc.fused_route(F, n_fft, hop, n_iter, N_SMS) == (want == "fused")
    if want == "eager" and n_iter > 0:
        with pytest.raises(ValueError):
            tglc.gl_fused_plan(F, n_fft, hop, N_SMS, center=True)
    else:
        assert tglc.gl_fused_plan(F, n_fft, hop, N_SMS, center=True) == \
            tglc.gl_fused_plan(F, n_fft, hop, N_SMS)


def test_center_refuses_a_signal_shorter_than_its_pad():
    mag, ang = _inputs(2, 3, 400)
    with pytest.raises(ValueError, match="reflect pad"):
        tglc.gl_angles_fused(torch.as_tensor(mag), torch.as_tensor(ang), 400, 80, 2, 0.9,
                             center=True)
    with pytest.raises(ValueError, match="reflect pad"):
        tglc.project_center_reference(torch.as_tensor(ang), 400, 80)
    # center=False takes any F
    tglc.gl_angles_fused(torch.as_tensor(mag), torch.as_tensor(ang), 400, 80, 2, 0.9)
