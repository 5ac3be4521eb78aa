"""The port's Griffin-Lim against the JAX reference with source-phase
seeding (the conversion path's setting), a few iterations.

Tolerance: each iteration is an ISTFT/STFT pair in float32 on both sides
with different FFT orders; after 8 iterations the signals agree within
1e-4 relative L2 (measured ~1e-6). The random init draws the JAX
package's uniform phases from the same key (``prng``), so it is held to
the JAX function with the same tolerance, and checked for convergence."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import fused_route
from exemplars_vc_tpu_torch.dsp.stft import stft
from test_torch_separate import key_kw

jgl = importlib.import_module("exemplars_vc_tpu.dsp.griffin_lim")
jstft = importlib.import_module("exemplars_vc_tpu.dsp.stft")


def _signal(seed, n=6400):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = sum(np.sin(2 * np.pi * 140.0 * k * t + rng.uniform(0, 6)) / k for k in range(1, 10))
    return (0.2 * x * np.hanning(n) + 0.005 * rng.standard_normal(n)).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_source_phase_gl_matches_jax(momentum):
    x = _signal(0)
    seed = _signal(1)                        # another signal's phase seeds it
    S = np.asarray(jstft.stft(jnp.asarray(x)))
    mag = np.abs(S) * 1.1
    seed_spec = np.array(jstft.stft(jnp.asarray(seed)))
    seed_spec[:, 0] = 0.0                    # zero bins take unit phase
    ref_y, ref_ph = jgl.griffin_lim(jnp.asarray(mag), n_iter=8, length=len(x),
                                    momentum=momentum, init_phase=jnp.asarray(seed_spec),
                                    return_phase=True)
    y, ph = griffin_lim(torch.as_tensor(mag), n_iter=8, length=len(x), momentum=momentum,
                        init_phase=torch.as_tensor(seed_spec), return_phase=True)
    assert y.shape == (len(x),) and ph.shape == mag.shape
    assert _rel_l2(y.numpy(), np.asarray(ref_y)) < 1e-4
    assert _rel_l2(ph.numpy(), np.asarray(ref_ph)) < 1e-4


def test_zero_iterations_is_seeded_istft():
    x = _signal(2)
    S = stft(torch.as_tensor(x))
    y = griffin_lim(torch.abs(S), n_iter=0, length=len(x), init_phase=S)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)


def test_random_init_needs_generator_and_converges():
    """Without ``init_phase`` or ``key`` the phases come from ``PRNGKey(0)``
    (the JAX default; no generator is needed): repeatable, and converging."""
    x = _signal(3)
    mag = torch.abs(stft(torch.as_tensor(x)))

    def run(n_iter):
        return griffin_lim(mag, n_iter=n_iter, length=len(x))

    def inconsistency(y):
        return float(torch.linalg.norm(torch.abs(stft(y)) - mag) / torch.linalg.norm(mag))

    torch.testing.assert_close(run(4), run(4), rtol=0, atol=0)
    assert inconsistency(run(30)) < 0.5 * inconsistency(run(0))


@pytest.mark.parametrize("seed", [None, 7])
def test_random_init_from_a_key_matches_jax(seed):
    """Uniform random phases from the default key (None) or another, in
    both packages: the starting phases within 1e-6, and after 8 iterations
    the tolerance of the source-phase case on the signal and on the
    spectrum mag·phase. The bare phases of near-silent bins (the window's
    ends) are not held: with a random start they drift apart through the
    FFTs' roundoff (1.2e-4 relative L2 after 8 iterations, measured, while
    mag·phase agrees to 3e-6) and carry no energy into the signal."""
    x = _signal(4)
    mag = np.abs(np.asarray(jstft.stft(jnp.asarray(x))))
    jk, tk = key_kw(seed)
    for n_iter, tol in ((0, 1e-6), (8, 1e-4)):
        ref_y, ref_ph = jgl.griffin_lim(jnp.asarray(mag), n_iter=n_iter, length=len(x),
                                        return_phase=True, **jk)
        y, ph = griffin_lim(torch.as_tensor(mag), n_iter=n_iter, length=len(x),
                            return_phase=True, **tk)
        assert _rel_l2(y.numpy(), np.asarray(ref_y)) < tol, n_iter
        assert _rel_l2(mag * ph.numpy(), mag * np.asarray(ref_ph)) < tol, n_iter
    assert _rel_l2(ph.numpy(), np.asarray(ref_ph)) < 1e-3


@pytest.mark.parametrize("hop,n_frames,seed", [(96, 67, "source"), (96, 67, 3),
                                               (80, 2509, "source")])
def test_refused_shapes_match_jax(hop, n_frames, seed):
    """Shapes the fused kernel refuses (a hop that does not divide n_fft;
    one frame more than its tiles hold at hop 80), from the source phase or
    from ``PRNGKey(3)``: the eager loop the card runs for them is the one
    run here, held to the JAX function after 8 iterations on the signal
    and on mag·phase."""
    x = _signal(5, (n_frames - 1) * hop)
    mag = np.abs(np.asarray(jstft.stft(jnp.asarray(x), hop_length=hop))) * 1.1
    assert mag.shape[0] == n_frames
    assert not fused_route(n_frames, 400, hop, 8, n_sms=132)      # an H100's SMs
    if seed == "source":
        spec = np.array(jstft.stft(jnp.asarray(_signal(6, len(x))), hop_length=hop))
        jk, tk = {"init_phase": jnp.asarray(spec)}, {"init_phase": torch.as_tensor(spec)}
    else:
        jk, tk = key_kw(seed)
    ref_y, ref_ph = jgl.griffin_lim(jnp.asarray(mag), hop_length=hop, n_iter=8,
                                    length=len(x), return_phase=True, **jk)
    y, ph = griffin_lim(torch.as_tensor(mag), hop_length=hop, n_iter=8, length=len(x),
                        return_phase=True, **tk)
    assert _rel_l2(y.numpy(), np.asarray(ref_y)) < 1e-4
    assert _rel_l2(mag * ph.numpy(), mag * np.asarray(ref_ph)) < 1e-4
