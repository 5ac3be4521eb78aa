"""CheapTrick spectral envelopes (port of
``exemplars_vc_tpu/world/cheaptrick.py``).

CheapTrick (Morise 2015) as in the WORLD sources, held to the float64
oracle ``tests/oracles/world_cheaptrick.py``:

1. GetWindowedWaveform: a pitch-synchronous Hanning window of 3·T0,
   edge-clamped gather, window normalized by √Σw², window-weighted bias
   removal;
2. GetPowerSpectrum + DCCorrection: rFFT power; bins below f0 get the
   spectrum mirrored about f0 added;
3. LinearSmoothing: a box of full width 2f0/3 over the mirror-extended
   spectrum, as a banded stencil of nonnegative weights (no cancellation);
4. SmoothingWithRecovery: the cosine-part cepstrum of the symmetrized log
   spectrum, times the sinc smoothing lifter and the q1 compensation
   lifter (q1 = −0.15).

All frames (U, F) at once; per-frame window lengths and smoothing widths
are masks and weights, not shapes.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.world._ops import gather_last, rfft_magsq

DEFAULT_F0 = 500.0   # WORLD kDefaultF0 (unvoiced / below-floor frames)
Q1 = -0.15           # CheapTrick lifter coefficient
_MARGIN = 96         # static mirror margin ≥ boundary(f0_ceil) in bins
_STENCIL = 64        # static smoothing band half-width ≥ h_max + 1 bins


def world_fft_size(sr: int, f0_floor: float = 71.0) -> int:
    """WORLD's CheapTrick default: 2^(1 + floor(log2(3·sr/f0_floor + 1)))."""
    return int(2 ** (1 + int(math.log2(3.0 * sr / f0_floor + 1.0))))


def _windowed_waveform_batch(x, centers, f0, sr, max_win, periods=3.0, bias_removal=True,
                             window="hanning", normalize_window=True, normalize_wave=False):
    """WORLD GetWindowedWaveform over frames: x (U, T), centers and f0
    (U, F) → (U, F, max_win) segments. A ``window`` ("hanning" or
    "blackman") of ``periods``·T0 at ``centers`` (samples, may be
    fractional), edge-clamped gather, optional window energy normalization
    (CheapTrick) or waveform energy normalization (D4C's GetCentroid),
    window-weighted mean removal."""
    U, T = x.shape
    half = torch.floor((periods / 2.0) * sr / f0 + 0.5)                  # matlab_round
    base = torch.arange(max_win, device=x.device) - max_win // 2
    inside = torch.abs(base) <= half[..., None]
    origin = torch.floor(centers.to(torch.float32) + 0.001 + 0.5).to(torch.int64)
    origin = origin.expand_as(f0)
    idx = torch.clamp(origin[..., None] + base, 0, T - 1)
    seg = torch.gather(x, 1, idx.reshape(U, -1)).reshape(idx.shape)
    pos = base.to(torch.float32) / ((periods / 2.0) * sr)
    arg = math.pi * pos * f0[..., None]
    if window == "hanning":
        win = 0.5 * torch.cos(arg) + 0.5
    else:
        win = 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(2.0 * arg)
    win = win * inside
    if normalize_window:
        win = win / torch.sqrt(torch.sum(win * win, dim=-1, keepdim=True))
    wave = seg * win
    if bias_removal:
        coeff = torch.sum(wave, dim=-1, keepdim=True) / torch.sum(win, dim=-1, keepdim=True)
        wave = wave - win * coeff
    wave = wave * inside
    if normalize_wave:
        wave = wave / (torch.sqrt(torch.sum(wave * wave, dim=-1, keepdim=True)) + 1e-30)
    return wave


def _dc_correction(power, f0, sr, fft_size):
    """WORLD DCCorrection: add the spectrum mirrored about f0 below f0."""
    B = power.shape[-1]
    bin_hz = sr / fft_size
    i = torch.arange(B, dtype=power.dtype, device=power.device)
    q = f0[..., None] / bin_hz - i                                       # (f0 − f)/bin
    lo = torch.clamp(torch.floor(q).to(torch.int64), 0, B - 2)
    frac = q - lo.to(power.dtype)
    replica = gather_last(power, lo) * (1.0 - frac) + gather_last(power, lo + 1) * frac
    upper = (2 + (f0 * fft_size / sr).to(torch.int32)) - 1
    mask = torch.arange(B, device=power.device) < upper[..., None]
    return power + torch.where(mask, replica, torch.zeros_like(replica))


def _linear_smoothing(power, width_hz, sr, fft_size):
    """WORLD LinearSmoothing (width in Hz, a frame): output bin i integrates
    the piecewise-constant mirror-extended spectrum E over (i − h − ½,
    i + h − ½] with h = width/(2·bin); the weight of E[i+d] is the overlap
    of (d−1, d] with (−h−½, h−½]. Every term is nonnegative, so a float32
    sum keeps the quiet bins (a cumulative-sum difference would cancel).
    The band is ``_STENCIL`` bins each side; the terms are added in order
    of d, one fused multiply-add a term, as the reference adds them."""
    B = power.shape[-1]
    bin_hz = sr / fft_size
    M = _MARGIN
    low = power[..., 1:M + 1].flip(-1)                                   # P[|k|], k < 0
    top = power[..., B - 1 - M:B - 1].flip(-1)                           # P[2·half − k]
    E = torch.cat([low, power, top], dim=-1)                             # (..., B + 2M)
    h = (width_hz / (2.0 * bin_hz))[..., None]
    d = torch.arange(-_STENCIL, _STENCIL + 1, device=power.device, dtype=power.dtype)
    w = torch.clamp(torch.minimum(d, h - 0.5) - torch.maximum(d - 1.0, -h - 0.5), min=0.0)
    out = torch.zeros_like(power)
    for t in range(2 * _STENCIL + 1):
        out.addcmul_(w[..., t:t + 1], E[..., M + t - _STENCIL: M + t - _STENCIL + B])
    return out * bin_hz / width_hz[..., None]


def _smoothing_with_recovery(power, f0, sr, fft_size):
    """WORLD SmoothingWithRecovery: lifter the cosine-part cepstrum."""
    B = power.shape[-1]
    log_spec = torch.log(power)
    symmetric = torch.cat([log_spec, log_spec[..., 1:B - 1].flip(-1)], dim=-1)
    cep = torch.fft.rfft(symmetric).real                                 # cosine part
    tau = torch.arange(B, device=power.device) / sr                     # quefrency (s)
    arg = math.pi * f0[..., None] * tau
    smoothing = torch.where(arg > 1e-12, torch.sin(arg) / torch.clamp(arg, min=1e-12),
                            torch.ones_like(arg))
    compensation = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2.0 * arg)
    cep = cep * smoothing * compensation
    log_env = torch.fft.irfft(cep.to(torch.complex64), n=fft_size)[..., :B]
    return torch.exp(torch.clamp(log_env, -80.0, 80.0))


def cheaptrick(x: torch.Tensor, f0: torch.Tensor, centers: torch.Tensor, sr: int = 16000,
               fft_size: int = 1024, f0_floor: float = 71.0,
               max_win: int | None = None) -> torch.Tensor:
    """Spectral envelope (..., F, fft_size//2+1), linear power, of x (T,)
    or (U, T) at the frames f0 (..., F) and sample ``centers`` (F,) or
    (..., F). f0 ≤ f0_floor (unvoiced 0 too) uses WORLD's kDefaultF0 =
    500 Hz."""
    if max_win is None:
        max_win = fft_size
    single = x.dim() == 1
    x = (x[None] if single else x).to(torch.float32)
    f0 = (f0[None] if single else f0).to(torch.float32)
    f0_safe = torch.where(f0 > f0_floor, f0, torch.full_like(f0, DEFAULT_F0))
    wave = _windowed_waveform_batch(x, centers, f0_safe, sr, max_win)
    power = rfft_magsq(wave, fft_size)
    power = _dc_correction(power, f0_safe, sr, fft_size)
    power = _linear_smoothing(power, f0_safe * 2.0 / 3.0, sr, fft_size)
    power = power + 1e-12          # AddInfinitesimalNoise, deterministic
    sp = _smoothing_with_recovery(power, f0_safe, sr, fft_size)
    return sp[0] if single else sp
