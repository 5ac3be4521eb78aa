"""Mel-cepstral analysis as a batched Newton solve (port of
``exemplars_vc_tpu/dsp/mcep.py``), over ``torch.fft`` and
``torch.linalg.solve``.

Minimizes SPTK's criterion E = (1/2π)∫ [exp R(ω) − R(ω) − 1] dω with
R(ω) = log I(ω) − 2·Σ_m c_m cos(m·ω̃(ω)) on the FFT grid: a weighted
least-squares init, then 10 Newton steps batched over frames.
"""

from __future__ import annotations

import numpy as np
import torch

from exemplars_vc_tpu_torch.dsp.stft import frame_signal
from exemplars_vc_tpu_torch.dsp.windows import get_window


def warped_phase(omega: np.ndarray, alpha: float) -> np.ndarray:
    """Phase response ω̃(ω) of the all-pass z̃⁻¹ = (z⁻¹ − α)/(1 − α z⁻¹)."""
    return omega + 2.0 * np.arctan2(alpha * np.sin(omega), 1.0 - alpha * np.cos(omega))


def warped_basis(n_bins: int, order: int, alpha: float) -> np.ndarray:
    """(n_bins, order+1) basis Φ[n,m] = cos(m·ω̃(ω_n)), ω_n = πn/(n_bins−1)."""
    omega = np.linspace(0.0, np.pi, n_bins)
    wt = warped_phase(omega, alpha)
    return np.cos(np.outer(wt, np.arange(order + 1))).astype(np.float64)


def _quad_weights(n_bins: int) -> np.ndarray:
    w = np.ones(n_bins)
    w[0] = w[-1] = 0.5  # trapezoid endpoints on [0, π]
    return w


def mcep_from_log_periodogram(log_I: torch.Tensor, order: int = 25,
                              alpha: float = 0.42, n_iter: int = 10) -> torch.Tensor:
    """(..., n_bins) log power spectra → (..., order+1) mel-cepstra."""
    n_bins = log_I.shape[-1]
    kw = dict(dtype=log_I.dtype, device=log_I.device)
    phi = torch.as_tensor(warped_basis(n_bins, order, alpha), **kw)
    w = torch.as_tensor(_quad_weights(n_bins), **kw)
    phiw = phi * w[:, None]
    gram = phi.T @ phiw
    proj = torch.linalg.solve(gram, phiw.T)           # (M+1, n_bins)
    c = 0.5 * (log_I @ proj.T)
    for _ in range(n_iter):
        s2 = 2.0 * (c @ phi.T)
        eR = torch.exp(torch.clamp(log_I - s2, -60.0, 30.0))
        g = -2.0 * ((w * (eR - 1.0)) @ phi)
        H = 4.0 * torch.einsum("...n,nm,nk->...mk", w * eR, phi, phi)
        c = c + torch.linalg.solve(H, -g[..., None])[..., 0]
    return c


def mcep_frames(frames: torch.Tensor, order: int = 25, alpha: float = 0.42,
                n_fft: int = 512, n_iter: int = 10, eps: float = 1e-8) -> torch.Tensor:
    """Windowed frames (..., frame_length) → mel-cepstra (..., order+1)."""
    s = torch.fft.rfft(frames, n=n_fft)
    spec = s.real ** 2 + s.imag ** 2
    floor = eps * torch.amax(spec, dim=-1, keepdim=True) + 1e-30
    return mcep_from_log_periodogram(torch.log(torch.maximum(spec, floor)),
                                     order=order, alpha=alpha, n_iter=n_iter)


def mcep(x: torch.Tensor, frame_length: int = 400, hop_length: int = 80,
         order: int = 25, alpha: float = 0.42, window: str = "blackman",
         n_fft: int = 512, n_iter: int = 10) -> torch.Tensor:
    """Whole-utterance mel-cepstrogram (n_frames, order+1): uncentered
    framing, symmetric window, then :func:`mcep_frames`."""
    frames = frame_signal(x, frame_length, hop_length)
    frames = frames * get_window(window, frame_length, periodic=False,
                                 device=x.device, dtype=frames.dtype)
    return mcep_frames(frames, order=order, alpha=alpha, n_fft=n_fft, n_iter=n_iter)


def mcep_to_spectrum(c: torch.Tensor, n_bins: int = 257, alpha: float = 0.42) -> torch.Tensor:
    """Mel-cepstra (..., order+1) → linear power spectrum |D(ω)|² on (..., n_bins)."""
    phi = torch.as_tensor(warped_basis(n_bins, c.shape[-1] - 1, alpha),
                          dtype=c.dtype, device=c.device)
    return torch.exp(2.0 * (c @ phi.T))
