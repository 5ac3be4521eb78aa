"""The port's LPC and LSP (``exemplars_vc_tpu_torch/dsp/lpc.py``) against the
JAX package's, on hamming-windowed 400-sample frames (hop 80) of the in-repo
speech at orders 8 and 20.

Tolerances. The LSP root finder takes the same LPC vectors in both packages:
≤ 1e-4 rad on every frame, ascending, inside (0, π). The Levinson recursion
amplifies the autocorrelation's rounding by the condition number κ of the
frame's Toeplitz system, and speech frames have a median κ of 1e4–7e4: there
the JAX package's float32 coefficients are up to 5e-2 (relative) off the
float64 solution, so no float32 port can agree with them to 1e-4. The port
computes the LPC (and the LSPs) in float64. So its coefficients are held to ≤ 1e-5 relative
(max |Δ| / max |a|) of a float64 oracle (``scipy.linalg.solve_toeplitz``) on
every frame, and to ≤ 1e-4 of the JAX package's on the frames with κ ≤ 300
(κ · 3e-7 ≤ 1e-4, float32's rounding of the autocorrelation); the JAX
package's own solution is checked to satisfy the exact Yule-Walker equations
within 1e-5 (residual over ‖r‖, r0 = 1) on every frame. The LSPs of the
port's own LPC lie within 1e-4 rad of the float64 polynomial roots
(``np.roots``) on every frame, and of the JAX package's where κ ≤ 300.

One frame of these inputs finds the JAX package's root finder off by one grid
cell (π/1024) from the float64 roots of the same polynomials, where the port
is within 1e-4 rad of them: a sign change at a grid edge moved the JAX
package's bracket (``test_reference_lsp_grid_edge_fault``). The parity test
accepts a disagreement only where it is that recorded fault.
"""

import numpy as np
import pytest
import torch
from scipy.linalg import solve_toeplitz, toeplitz

import jax.numpy as jnp

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.dsp.lpc import lpc as jlpc
from exemplars_vc_tpu.dsp.lpc import lpc_to_lsp as jlpc_to_lsp
from exemplars_vc_tpu_torch.dsp.lpc import lpc, lpc_to_lsp
from exemplars_vc_tpu_torch.io.standin import AUDIO_DIR
from exemplars_vc_tpu_torch.io.wav import read_wav

SPEECH = ["heldout_100162_stft_parity.wav", "loo/world_parity_100003.wav"]
# frames where the JAX package's LSP misses the float64 root by a grid cell
REFERENCE_FAULTS = {("loo/world_parity_100003.wav", 20): [197]}


def speech_frames(name: str) -> np.ndarray:
    x, _ = read_wav(str(AUDIO_DIR / name), dtype=np.float32)
    fr = np.lib.stride_tricks.sliding_window_view(x, 400)[::80]
    return (fr * np.hamming(400)).astype(np.float32)


def yule_walker(frames: np.ndarray, order: int):
    """float64 normalised autocorrelation r (r0 = 1), the Toeplitz systems
    T a = −r[1:], their condition numbers and their solutions as LPC rows
    [1, a_1 … a_p]."""
    f = frames.astype(np.float64)
    r = np.fft.irfft(np.abs(np.fft.rfft(f, n=1024)) ** 2, n=1024)[:, : order + 1]
    r = r / r[:, :1]
    T = np.stack([toeplitz(ri[:order]) for ri in r])
    a = np.stack([np.r_[1.0, solve_toeplitz(ri[:order], -ri[1:])] for ri in r])
    return r, T, np.linalg.cond(T), a


def polynomial_roots(a: np.ndarray) -> np.ndarray:
    """float64 LSP oracle: the angles in (0, π) of the roots of P and Q
    (``np.roots``), ascending, for each monic LPC row of ``a``."""
    out = []
    for v in a.astype(np.float64):
        v = np.r_[1.0, v[1:]]
        ext, flip = np.r_[v, 0.0], np.r_[0.0, v[::-1]]
        ang = np.concatenate([np.angle(np.roots(ext + flip)), np.angle(np.roots(ext - flip))])
        out.append(np.sort(ang[(ang > 1e-6) & (ang < np.pi - 1e-6)]))
    return np.asarray(out)


@pytest.mark.parametrize("order", [8, 20])
@pytest.mark.parametrize("name", SPEECH)
def test_lpc_and_lsp_match_jax(name, order):
    fr = speech_frames(name)
    a_j = np.asarray(jlpc(jnp.asarray(fr), order=order))
    a_t = lpc(torch.as_tensor(fr), order=order).numpy()
    assert a_t.shape == a_j.shape == (len(fr), order + 1) and np.isfinite(a_t).all()

    r, T, kappa, a64 = yule_walker(fr, order)
    scale = np.abs(a64[:, 1:]).max(axis=1)
    assert (np.abs(a_t[:, 1:] - a64[:, 1:]).max(axis=1) / scale).max() <= 1e-5
    well = kappa <= 300
    assert well.sum() >= 40, "too few well-conditioned frames to hold the coefficients"
    rel = np.abs(a_t[:, 1:] - a_j[:, 1:]).max(axis=1) / np.abs(a_j[:, 1:]).max(axis=1)
    assert rel[well].max() <= 1e-4
    assert (np.abs(a_t[:, 0] - a_j[:, 0]) / a_j[:, 0])[well].max() <= 1e-4    # the gain
    resid = np.linalg.norm(np.einsum("bij,bj->bi", T, a_j[:, 1:].astype(np.float64))
                           + r[:, 1:], axis=1)
    assert resid.max() <= 1e-5

    # the root finder on the same LPC vectors
    l_j = np.asarray(jlpc_to_lsp(jnp.asarray(a_j)))
    l_t = lpc_to_lsp(torch.as_tensor(a_j.copy())).numpy()
    differ = np.where(np.abs(l_t - l_j).max(axis=1) > 1e-4)[0]
    assert differ.tolist() == REFERENCE_FAULTS.get((name, order), [])
    if len(differ):
        oracle = polynomial_roots(a_j[differ])
        assert np.abs(l_t[differ] - oracle).max() <= 1e-4
        assert (np.abs(l_j[differ] - oracle).max(axis=1) > 1e-4).all()
    own = lpc_to_lsp(torch.as_tensor(a_t)).numpy()
    for lsp in (l_t, own):
        assert (np.diff(lsp, axis=1) >= 0).all() and (lsp > 0).all() and (lsp < np.pi).all()
    assert np.abs(own - polynomial_roots(a64)).max() <= 1e-4
    assert np.abs(own - l_j)[well].max() <= 1e-4


def test_reference_lsp_grid_edge_fault():
    """The recorded fault of the JAX package (ROADMAP queue 3): frame 197 of
    ``loo/world_parity_100003.wav`` at order 20. Its first LSP lies in the
    first cells of the 1024-point grid; float32 rounding of the Chebyshev sum
    moves the JAX package's bracket one cell up, where bisection without a
    sign change converges to the cell's edge (in the call on the file's
    frames; a call on the one frame rounds otherwise and finds the root). The
    port brackets the root."""
    name, order = "loo/world_parity_100003.wav", 20
    a_j = np.asarray(jlpc(jnp.asarray(speech_frames(name)), order=order))
    oracle = polynomial_roots(a_j[197:198])[0]
    # the call on the file's frames: the flip needs that call's rounding
    l_j = np.asarray(jlpc_to_lsp(jnp.asarray(a_j)))[197]
    l_t = lpc_to_lsp(torch.as_tensor(a_j.copy())).numpy()[197]
    cell = np.pi / 1024
    assert abs(abs(l_j[0] - oracle[0]) - cell) < 0.05 * cell
    assert np.abs(l_j[1:] - oracle[1:]).max() <= 1e-4
    assert np.abs(l_t - oracle).max() <= 1e-4


def test_lpc_batch_axes():
    """Leading axes are a batch: a (3, 4, N) call equals the flat one."""
    fr = speech_frames(SPEECH[0])[:12]
    a_flat = lpc(torch.as_tensor(fr), order=8)
    a = lpc(torch.as_tensor(fr.reshape(3, 4, 400)), order=8)
    assert a.shape == (3, 4, 9)
    torch.testing.assert_close(a.reshape(12, 9), a_flat, rtol=1e-6, atol=1e-7)
    lsp = lpc_to_lsp(a)
    assert lsp.shape == (3, 4, 8)
    torch.testing.assert_close(lsp.reshape(12, 8), lpc_to_lsp(a_flat), rtol=0, atol=1e-6)


def test_odd_order_raises_as_jax():
    a = torch.zeros(2, 8)
    a[:, 0] = 1.0
    with pytest.raises(NotImplementedError, match="even LPC order"):
        lpc_to_lsp(a)
