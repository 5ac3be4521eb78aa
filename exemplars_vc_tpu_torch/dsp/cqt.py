"""Constant-Q transform as one strided convolution against a complex kernel
bank (port of ``exemplars_vc_tpu/dsp/cqt.py``; pyfasst's ``minqt.py`` /
``hybridcqt.py`` capability).

Log-spaced center frequencies f_k = fmin·2^(k/b) with per-bin Q-matched
window lengths N_k = ceil(Q·sr/f_k), Q = 1/(2^(1/b)−1). Bin k's kernel is a
periodic-Hann-windowed complex exponential of length N_k, scaled by 2/N_k and
centered in the longest kernel's frame. The analysis is one ``F.conv1d``
with ``stride=hop_length`` against the (2·n_bins, 1, max_len) cos/sin bank:
the convolution is the transform (cuDNN on a card, TF32 off by the
package's device settings).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.device import resolve_device


def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    return fmin * (2.0 ** (np.arange(n_bins) / bins_per_octave))


@lru_cache(maxsize=8)
def _cqt_kernel(sr: int, n_bins: int, bins_per_octave: int, fmin: float):
    """(2·n_bins, max_len) float32 cos/sin bank + max_len."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    if freqs[-1] > sr / 2:
        raise ValueError(
            f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist ({sr / 2:.1f} Hz)"
        )
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lens = np.ceil(Q * sr / freqs).astype(int)
    max_len = int(lens[0])
    kre = np.zeros((n_bins, max_len), np.float32)
    kim = np.zeros((n_bins, max_len), np.float32)
    for k, (fk, nk) in enumerate(zip(freqs, lens)):
        n = np.arange(nk)
        win = 0.5 - 0.5 * np.cos(2 * np.pi * n / nk)          # periodic hann
        phase = 2 * np.pi * fk / sr * n
        start = (max_len - nk) // 2                            # center-align
        kre[k, start : start + nk] = (win * np.cos(phase)) * (2.0 / nk)
        kim[k, start : start + nk] = (win * np.sin(phase)) * (2.0 / nk)
    return np.concatenate([kre, kim], axis=0), max_len


@lru_cache(maxsize=8)
def _bank(sr: int, n_bins: int, bins_per_octave: int, fmin: float,
          device: torch.device) -> tuple[torch.Tensor, int]:
    """The kernel bank as a (2·n_bins, 1, max_len) tensor on ``device``,
    made once (read only)."""
    kernel, max_len = _cqt_kernel(sr, n_bins, bins_per_octave, fmin)
    return torch.as_tensor(kernel, device=device)[:, None, :], max_len


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's ``np.pad(..., mode="reflect")`` of the last axis by ``pad``
    on both sides, also where ``pad`` ≥ the length: the signal reflects
    again at every end (period 2·(T − 1); a single sample repeats), where
    ``F.pad(mode="reflect")`` refuses."""
    T = x.shape[-1]
    i = torch.arange(-pad, T + pad, device=x.device)
    if T == 1:
        i = torch.zeros_like(i)
    else:
        period = 2 * (T - 1)
        i = torch.remainder(i, period)
        i = torch.where(i >= T, period - i, i)
    return x.index_select(-1, i)


def _as_signal(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.float32)


def cqt(x, sr: int = 16000, hop_length: int = 80,
        fmin: float = 32.70319566257483,   # C1
        n_bins: int = 84, bins_per_octave: int = 12,
        device: str | torch.device = "cuda") -> torch.Tensor:
    """Constant-Q spectrogram of ``x`` (..., T) → complex64 (..., frames,
    n_bins) on ``device``.

    Frames are taken every ``hop_length`` samples with the signal reflect-
    padded by half the longest kernel (center-aligned analysis,
    librosa-like)."""
    dev = resolve_device(device)
    kernel, max_len = _bank(sr, n_bins, bins_per_octave, float(fmin), dev)
    x = _as_signal(x, dev)
    lead = x.shape[:-1]
    xp = reflect_pad(x.reshape(-1, x.shape[-1]), max_len // 2)
    out = F.conv1d(xp[:, None, :], kernel, stride=hop_length)     # (N, 2K, frames)
    re = out[:, :n_bins].transpose(1, 2)
    im = out[:, n_bins:].transpose(1, 2)
    return torch.complex(re, -im).reshape(lead + re.shape[1:])


def cqt_magnitude(x, **kw) -> torch.Tensor:
    return cqt(x, **kw).abs()


def hybrid_cqt(x, sr: int = 16000, hop_length: int = 80,
               fmin: float = 32.70319566257483, n_bins: int = 84,
               bins_per_octave: int = 12, n_fft: int = 400,
               device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Hybrid constant-Q + linear-frequency analysis (pyfasst's
    ``HybridCQTKernel``): constant-Q bins up to the top CQ center
    frequency, then the STFT's linear bins for the remaining spectrum, both
    on the same hop grid. Returns ``(cq_coeffs (..., frames, n_bins),
    lin_coeffs (..., frames, n_lin), lin_freqs_hz)``; frame counts are
    aligned by truncation to the shorter."""
    from exemplars_vc_tpu_torch.dsp.stft import stft

    dev = resolve_device(device)
    x = _as_signal(x, dev)
    cq = cqt(x, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins,
             bins_per_octave=bins_per_octave, device=dev)
    f_top = float(cqt_frequencies(n_bins, fmin, bins_per_octave)[-1])
    spec = stft(x, n_fft=n_fft, hop_length=hop_length)     # (..., frames, bins)
    lin_freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    k0 = int(np.searchsorted(lin_freqs, f_top, side="right"))
    n = min(cq.shape[-2], spec.shape[-2])
    return cq[..., :n, :], spec[..., :n, k0:], lin_freqs[k0:]
