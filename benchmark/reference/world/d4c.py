"""D4C band aperiodicity (port of ``exemplars_vc_tpu/world/d4c.py``).

D4C (Morise 2016) as in the WORLD sources, held to the float64 oracle
``tests/oracles/world_d4c.py``:

1. LoveTrain VUV check: a 3·T0 Hanning power spectrum; the cumulated-power
   ratio (100, 4000] / (100, 7900] Hz; frames with f0 = 0 or ratio ≤ 0.85
   stay fully aperiodic;
2. static centroid: two unit-energy 4·T0 Blackman windows at ±0.25/f0;
3. smoothed power: 4·T0 Hanning, DC correction, width-f0 box smoothing;
4. static group delay: centroid/power, width-f0/2 smoothing, detrended by
   its width-f0 smoothing;
5. coarse aperiodicity a 3 kHz band: the Nuttall-windowed group delay's
   sorted power spectrum, 10·log10 of the cumulative fraction outside the
   top ≈ 8 main-lobe bins, revised by min(0, ap + (f0−100)/50);
6. full band: linear interpolation in dB over [0 → −60 dB, the bands,
   Nyquist → 0 dB], then 10^(dB/20).

All frames (U, F) at once; voicing decisions are masks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.world._ops import cumsum, interp, nuttall, rfft_magsq
from benchmark.reference.world.cheaptrick import (
    _dc_correction,
    _linear_smoothing,
    _windowed_waveform_batch,
)

K_FLOOR_F0_D4C = 47.0
K_LOWEST_F0_LOVE = 40.0
K_FREQ_INTERVAL = 3000.0
K_UPPER_LIMIT = 15000.0
K_THRESHOLD = 0.85
K_SAFE_MIN = 1e-12
# WORLD's ceiling is 1 − 1e-12, which float32 rounds to 1.0: the closest
# float32 value that keeps aperiodicity strictly inside (0, 1)
AP_CEIL = 0.999999


def d4c_fft_size(sr: int) -> int:
    return int(2 ** (1 + int(math.log2(4.0 * sr / K_FLOOR_F0_D4C + 1.0))))


def _love_train_fft_size(sr: int) -> int:
    return int(2 ** (1 + int(math.log2(3.0 * sr / K_LOWEST_F0_LOVE + 1.0))))


def _n_bands(sr: int) -> int:
    return int(min(K_UPPER_LIMIT, sr / 2.0 - K_FREQ_INTERVAL) / K_FREQ_INTERVAL)


def _love_train(x, f0, centers, sr):
    """(U, F) cumulated-power ratio (100, 4000] / (100, 7900] Hz a frame."""
    N = _love_train_fft_size(sr)
    b0 = int(np.ceil(100.0 * N / sr))
    b1 = int(np.ceil(4000.0 * N / sr))
    b2 = min(int(np.ceil(7900.0 * N / sr)), N // 2)
    f0_lt = torch.clamp(f0, min=K_LOWEST_F0_LOVE)
    wave = _windowed_waveform_batch(x, centers, f0_lt, sr, N, periods=3.0,
                                    normalize_window=False)
    power = rfft_magsq(wave, N) * (torch.arange(N // 2 + 1, device=x.device) > b0)
    cum = cumsum(power)
    return cum[..., b1] / torch.clamp(cum[..., b2], min=1e-30)


def _centroid(x, f0, centers_f, sr, fft_size, max_win):
    """Re(conj(X)·FFT(t·x̂)) with a unit-energy 4·T0 Blackman window. WORLD
    weights by the buffer index from the window's start; the wave here is
    centered at max_win//2, and the origin shift Δ, which adds Δ·|X|², is
    taken off analytically."""
    wave = _windowed_waveform_batch(x, centers_f, f0, sr, max_win, periods=4.0,
                                    window="blackman", normalize_window=False,
                                    normalize_wave=True)
    t = torch.arange(max_win, dtype=wave.dtype, device=wave.device)
    X = torch.fft.rfft(wave, n=fft_size)
    Y = torch.fft.rfft(wave * t, n=fft_size)
    half = torch.floor(2.0 * sr / f0 + 0.5)                               # window half length
    shift = (max_win // 2 - half)[..., None]
    return (X.real * Y.real + X.imag * Y.imag
            - shift * (X.real * X.real + X.imag * X.imag))


def _static_group_delay(x, f0, centers, sr, fft_size, max_win):
    shift = 0.25 * sr / f0
    c1 = _centroid(x, f0, centers - shift, sr, fft_size, max_win)
    c2 = _centroid(x, f0, centers + shift, sr, fft_size, max_win)
    centroid = _dc_correction(c1 + c2, f0, sr, fft_size)
    wave = _windowed_waveform_batch(x, centers, f0, sr, max_win, periods=4.0,
                                    normalize_window=False)
    power = rfft_magsq(wave, fft_size)
    power = _dc_correction(power, f0, sr, fft_size)
    power = _linear_smoothing(power, f0, sr, fft_size)
    gd = centroid / torch.clamp(power, min=1e-30)
    gd = _linear_smoothing(gd, f0 / 2.0, sr, fft_size)
    return gd - _linear_smoothing(gd, f0, sr, fft_size)


def _coarse_aperiodicity(gd, f0, sr, fft_size):
    """(U, F, n_bands) dB estimates from sorted group-delay band spectra."""
    wl = int(K_FREQ_INTERVAL * fft_size / sr) * 2 + 1
    boundary = int(np.floor(fft_size * 8.0 / wl + 0.5))
    half = wl // 2
    window = torch.as_tensor(nuttall(wl), dtype=gd.dtype, device=gd.device)
    outs = []
    for i in range(_n_bands(sr)):
        center = int(K_FREQ_INTERVAL * (i + 1) * fft_size / sr)
        seg = gd[..., center - half: center - half + wl] * window
        power = torch.sort(rfft_magsq(seg, fft_size), dim=-1).values
        cum = cumsum(power)
        ratio = cum[..., fft_size // 2 - boundary - 1] / torch.clamp(cum[..., -1], min=1e-30)
        outs.append(10.0 * torch.log10(torch.clamp(ratio, min=1e-30)))
    coarse = torch.stack(outs, dim=-1)
    return torch.clamp(coarse + (f0[..., None] - 100.0) / 50.0, max=0.0)


def d4c_aperiodicity(x: torch.Tensor, f0: torch.Tensor, centers: torch.Tensor,
                     sr: int = 16000, fft_size: int = 1024,
                     threshold: float = K_THRESHOLD) -> torch.Tensor:
    """Aperiodicity (..., F, fft_size//2+1) in (0, 1) of x (T,) or (U, T) at
    the frames f0 (..., F), sample ``centers`` as in ``cheaptrick``."""
    single = x.dim() == 1
    x = (x[None] if single else x).to(torch.float32)
    f0 = (f0[None] if single else f0).to(torch.float32)
    centers = centers.to(torch.float32)
    N = d4c_fft_size(sr)
    f0_use = torch.clamp(f0, min=K_FLOOR_F0_D4C)
    voiced = (f0 > 0.0) & (_love_train(x, f0, centers, sr) > threshold)
    # a 4·T0 window at f0 ≥ 47 Hz fits the D4C fft buffer by construction
    gd = _static_group_delay(x, f0_use, centers, sr, N, max_win=N)
    coarse = _coarse_aperiodicity(gd, f0_use, sr, N)
    nb = coarse.shape[-1]
    axis = torch.as_tensor(np.concatenate([[0.0], K_FREQ_INTERVAL * (1 + np.arange(nb)),
                                           [sr / 2.0]]), dtype=torch.float32, device=x.device)
    B = fft_size // 2 + 1
    freqs = torch.arange(B, device=x.device) * (sr / fft_size)
    lo = torch.full(coarse.shape[:-1] + (1,), -60.0, device=x.device)
    hi = torch.full(coarse.shape[:-1] + (1,), float(-np.float32(K_SAFE_MIN)), device=x.device)
    ap_db = interp(freqs, axis, torch.cat([lo, coarse, hi], dim=-1))
    ap = torch.clamp(torch.pow(10.0, ap_db / 20.0), 1e-6, AP_CEIL)
    ap = torch.where(voiced[..., None], ap, torch.full_like(ap, AP_CEIL))
    return ap[0] if single else ap
