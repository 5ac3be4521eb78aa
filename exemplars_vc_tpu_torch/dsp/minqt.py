"""Minimum-Q transform (MinQT): CQT low band + linear-FFT high band, with a
guaranteed per-bin minimum Q and an exact iterative inverse (port of
``exemplars_vc_tpu/dsp/minqt.py``; pyfasst ``MinQTKernel``/``MinQTransfo``,
``tftransforms/minqt.py:309-402``).

With ``b`` bins per octave (pyfasst ``minqt.py:318-325``)::

    Q    = q / (2^(1/b) − 1)            # the minimum Q of the transform
    Kmax = ceil(Q)
    fmax = 2^(−1/b) · Kmax · fs / N_lin # CQ/linear split frequency

Below ``fmax``: log-spaced constant-Q bins. At and above it: bins ``p =
Kmax … N_lin/2`` of an ``N_lin``-point windowed FFT (Q = p ≥ Kmax ≥ Q_min).
Atoms use the sqrt-Blackman-Harris window, as pyfasst does.

All atoms share one hop grid. The analysis is one strided ``F.conv1d``
against a real cos/sin kernel bank; its adjoint is ``F.conv_transpose1d``
at the same stride. The inverse is the least-squares x̂ = (AᴴA)⁻¹Aᴴc,
solved by conjugate gradients (a fixed number of steps, float32) whose
matvec is that conv pair.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.device import resolve_device


def sqrt_blackmanharris(n: int) -> np.ndarray:
    """sqrt of the 4-term Blackman-Harris window (pyfasst's default atom
    window, ``tftransforms/minqt.py:21-28``)."""
    m = np.arange(n)
    w = (0.35875 - 0.48829 * np.cos(2 * np.pi * m / (n - 1))
         + 0.14128 * np.cos(4 * np.pi * m / (n - 1))
         - 0.01168 * np.cos(6 * np.pi * m / (n - 1)))
    return np.sqrt(np.maximum(w, 0.0))


class MinQTPlan(NamedTuple):
    kernel: np.ndarray      # (2·n_bins, L) float32 cos/sin analysis atoms
    n_bins: int
    n_cq: int               # leading CQ bins; the rest are linear bins
    hop: int
    L: int                  # common (centered) atom frame length
    freqs_hz: np.ndarray    # (n_bins,) ascending center frequencies
    q_values: np.ndarray    # (n_bins,) per-bin Q = f_k · len_k / fs
    q_min: float
    split_hz: float
    lin_fft: int


@lru_cache(maxsize=8)
def minqt_plan(
    sr: int,
    bins_per_octave: int = 12,
    fmin: float = 65.40639132514966,     # C2
    lin_fft: int = 1024,
    q: float = 1.0,
    hop: int | None = None,
) -> MinQTPlan:
    Q = q / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    kmax = int(np.ceil(Q))
    split = 2.0 ** (-1.0 / bins_per_octave) * kmax * sr / lin_fft
    if split <= fmin:
        raise ValueError(
            f"split {split:.1f} Hz <= fmin {fmin:.1f} Hz: raise lin_fft or fmin"
        )
    # CQ bins ascending, top bin one CQ step below the split
    n_cq = int(np.floor(bins_per_octave * np.log2(split / fmin))) + 1
    freqs_cq = split * 2.0 ** (-np.arange(n_cq, 0, -1) / bins_per_octave)
    lens_cq = np.round(Q * sr / freqs_cq).astype(int)
    # linear bins p = kmax … lin_fft/2 of the lin_fft-point windowed FFT
    p = np.arange(kmax, lin_fft // 2 + 1)
    freqs_lin = p * sr / lin_fft

    L = int(max(lens_cq.max(), lin_fft))
    n_bins = n_cq + len(p)
    kre = np.zeros((n_bins, L), np.float32)
    kim = np.zeros((n_bins, L), np.float32)
    for k, (fk, nk) in enumerate(zip(freqs_cq, lens_cq)):
        n = np.arange(nk)
        win = sqrt_blackmanharris(nk)
        phase = 2 * np.pi * fk / sr * n
        start = (L - nk) // 2
        kre[k, start : start + nk] = (win * np.cos(phase)) * (2.0 / nk)
        kim[k, start : start + nk] = (win * np.sin(phase)) * (2.0 / nk)
    win_lin = sqrt_blackmanharris(lin_fft)
    start = (L - lin_fft) // 2
    n = np.arange(lin_fft)
    for i, pk in enumerate(p):
        phase = 2 * np.pi * pk / lin_fft * n
        kre[n_cq + i, start : start + lin_fft] = (
            win_lin * np.cos(phase) * (2.0 / lin_fft)
        )
        kim[n_cq + i, start : start + lin_fft] = (
            win_lin * np.sin(phase) * (2.0 / lin_fft)
        )
    freqs = np.concatenate([freqs_cq, freqs_lin])
    q_values = freqs * np.concatenate(
        [lens_cq, np.full(len(p), lin_fft)]
    ) / sr
    return MinQTPlan(
        kernel=np.concatenate([kre, kim], axis=0),
        n_bins=n_bins, n_cq=n_cq, hop=int(hop or lin_fft // 4), L=L,
        freqs_hz=freqs, q_values=q_values, q_min=Q,
        split_hz=split, lin_fft=lin_fft,
    )


@lru_cache(maxsize=8)
def _plan_bank(sr: int, bins_per_octave: int, fmin: float, lin_fft: int, q: float,
               hop: int | None, device: torch.device) -> tuple[MinQTPlan, torch.Tensor]:
    """The plan and its kernel as (2·n_bins, 1, L) on ``device``, made once
    (read only)."""
    p = minqt_plan(sr, bins_per_octave, float(fmin), lin_fft, float(q), hop)
    return p, torch.as_tensor(p.kernel, device=device)[:, None, :]


def _conv_analysis(x: torch.Tensor, kernel: torch.Tensor, hop: int) -> torch.Tensor:
    """x (N, T_padded) real → (N, 2K, frames) strided correlation; kernel
    (2K, 1, L)."""
    return F.conv1d(x[:, None, :], kernel, stride=hop)


def _conv_adjoint(c: torch.Tensor, kernel: torch.Tensor, hop: int,
                  t_padded: int) -> torch.Tensor:
    """Adjoint of :func:`_conv_analysis`: (N, 2K, frames) → (N, T_padded)."""
    y = F.conv_transpose1d(c, kernel, stride=hop)[:, 0, :]
    if y.shape[-1] < t_padded:   # last partial frame: adjoint support ends early
        y = F.pad(y, (0, t_padded - y.shape[-1]))
    return y[:, :t_padded]


def minqt(x, sr: int = 16000, bins_per_octave: int = 12,
          fmin: float = 65.40639132514966, lin_fft: int = 1024, q: float = 1.0,
          hop: int | None = None, device: str | torch.device = "cuda") -> torch.Tensor:
    """MinQT analysis of ``x`` (..., T) → complex64 (..., frames, n_bins) on
    ``device``."""
    dev = resolve_device(device)
    p, kernel = _plan_bank(sr, bins_per_octave, float(fmin), lin_fft, float(q), hop, dev)
    x = torch.as_tensor(x, device=dev).to(torch.float32)
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, x.shape[-1]), (p.L // 2, p.L // 2))   # zero pad: linear op
    out = _conv_analysis(xp, kernel, p.hop)
    re = out[:, : p.n_bins].transpose(1, 2)
    im = out[:, p.n_bins :].transpose(1, 2)
    return torch.complex(re, -im).reshape(lead + re.shape[1:])


def iminqt(coeffs, length: int, sr: int = 16000, bins_per_octave: int = 12,
           fmin: float = 65.40639132514966, lin_fft: int = 1024, q: float = 1.0,
           hop: int | None = None, n_cg: int = 48,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """Least-squares inverse: the x̂ of given ``length`` whose MinQT best
    matches ``coeffs`` (exact reconstruction for in-band signals).

    Solves (AᴴA) x = Aᴴ c by ``n_cg`` conjugate-gradient steps in float32;
    both operators are the analysis conv and its transpose, no matrix is
    built."""
    dev = resolve_device(device)
    p, kernel = _plan_bank(sr, bins_per_octave, float(fmin), lin_fft, float(q), hop, dev)
    coeffs = torch.as_tensor(coeffs, device=dev).to(torch.complex64)
    lead = coeffs.shape[:-2]
    c = coeffs.reshape((-1,) + coeffs.shape[-2:])
    # complex (N, F, K) → stacked real channels (N, 2K, F), undoing the −im
    c2 = torch.cat([c.real.transpose(1, 2), (-c.imag).transpose(1, 2)], dim=1)
    t_padded = length + 2 * (p.L // 2)

    def S(x):
        return _conv_adjoint(_conv_analysis(x, kernel, p.hop), kernel, p.hop, t_padded)

    b = _conv_adjoint(c2.contiguous(), kernel, p.hop, t_padded)
    x = torch.zeros_like(b)
    r = b - S(x)
    d = r
    rs = torch.sum(r * r, -1, keepdim=True)
    for _ in range(n_cg):
        Sd = S(d)
        alpha = rs / torch.clamp(torch.sum(d * Sd, -1, keepdim=True), min=1e-30)
        x = x + alpha * d
        r = r - alpha * Sd
        rs_new = torch.sum(r * r, -1, keepdim=True)
        d = r + (rs_new / torch.clamp(rs, min=1e-30)) * d
        rs = rs_new
    x = x[:, p.L // 2 : p.L // 2 + length]
    return x.reshape(lead + (length,))
