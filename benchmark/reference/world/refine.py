"""Flanagan instantaneous-frequency refinement (port of
``exemplars_vc_tpu/world/refine.py``): the estimator behind WORLD's
StoneMask and Harvest's GetRefinedF0.

Per candidate frequency, a 3-period Blackman window and its discrete
derivative window; Flanagan's estimator gives the instantaneous frequency
per bin, and the refined f0 is the amplitude-weighted mean of
inst_freq(k·f0)/k over the first ``n_harmonics`` harmonics. Harvest also
scores each candidate by the inverse mean relative harmonic deviation.
Every (utterance, point) window goes through one rFFT pair of
``fft_size`` sized by the largest window, masked per row.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.world._ops import gather_last


def flanagan_refine(x: torch.Tensor, cfs: torch.Tensor, centers: torch.Tensor, sr: int,
                    fft_size: int, max_win: int, n_harmonics: int = 6):
    """Refine candidate frequencies ``cfs`` (U, P) at integer sample
    ``centers`` (U, P) or (P,) of the signals x (U, T).

    ``cfs`` must already be clipped to a positive range. Returns (refined,
    score, den), each (U, P): ``score`` is Harvest's reliability and ``den``
    the total harmonic amplitude (0: no usable harmonics)."""
    U, T = x.shape
    dev = x.device
    half = torch.ceil(3.0 * sr / cfs / 2.0)                             # (U, P)
    base = torch.arange(max_win, device=dev) - max_win // 2             # (L,)
    inside = torch.abs(base) <= half[..., None]
    idx = torch.clamp(centers.long()[..., None] + base, 0, T - 1)
    idx = idx.expand(U, *idx.shape[-2:]) if idx.dim() == 2 else idx
    seg = torch.gather(x, 1, idx.reshape(U, -1)).reshape(idx.shape)
    n_win = 2.0 * half[..., None] + 1.0
    phase = 2.0 * math.pi * base.to(torch.float32) / n_win
    main = (0.42 + 0.5 * torch.cos(phase) + 0.08 * torch.cos(2.0 * phase)) * inside
    # the discrete derivative window with WORLD's edges (main = 0 outside)
    diffw = -(F.pad(main, (0, 1))[..., 1:] - F.pad(main, (1, 0))[..., :-1]) / 2.0

    X = torch.fft.rfft(seg * main, n=fft_size)
    Xd = torch.fft.rfft(seg * diffw, n=fft_size)
    power = X.real * X.real + X.imag * X.imag
    B = power.shape[-1]
    freqs = torch.arange(B, device=dev) * (sr / fft_size)
    inst = freqs + (X.real * Xd.imag - X.imag * Xd.real) / torch.clamp(power, min=1e-30) * (
        sr / (2.0 * math.pi))

    num = torch.zeros_like(cfs)
    den = torch.zeros_like(cfs)
    dev_sum = torch.zeros_like(cfs)
    for k in range(1, n_harmonics + 1):
        j = torch.floor(cfs * k * fft_size / sr + 0.5).to(torch.int32)
        ok = (k * cfs < sr / 2.0) & (j < B)
        j = torch.clamp(j, 0, B - 1)
        amp = torch.sqrt(gather_last(power, j[..., None])[..., 0])
        fk = gather_last(inst, j[..., None])[..., 0]
        amp = torch.where(ok, amp, torch.zeros_like(amp))
        num = num + fk / k * amp
        den = den + amp
        dev_sum = dev_sum + amp * torch.abs(fk / k - cfs) / cfs
    refined = num / torch.clamp(den, min=1e-30)
    score = 1.0 / (dev_sum / torch.clamp(den, min=1e-30) + 1e-12)
    return refined, score, den
