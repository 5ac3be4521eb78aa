"""F0 estimation and refinement (port of ``exemplars_vc_tpu/world/f0.py``).

- :func:`estimate_f0` (``world.f0_method='ncc'``): the normalized
  autocorrelation of every frame through one batched rFFT, peak picking in
  [sr/f0_ceil, sr/f0_floor] with parabolic interpolation, a 5-tap median
  over voiced runs.
- :func:`estimate_f0_tracked` (``'tracked'``): the top NCC local maxima of
  every frame as a lattice and a Viterbi path over it (one step a frame on
  the device, the backtrace on the host).
- :func:`refine_f0_stonemask`: WORLD's StoneMask, the default refinement,
  over the shared Flanagan estimator.

Each takes x (T,) or a padded batch (U, T) and gives (..., F) contours;
unvoiced frames carry f0 = 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.world._ops import cumsum, gather_last, rfft_magsq
from exemplars_vc_tpu_torch.world.refine import flanagan_refine


def _batch(x: torch.Tensor):
    single = x.dim() == 1
    return (x[None] if single else x).to(torch.float32), single


def _extract_segments(x: torch.Tensor, centers: torch.Tensor, length: int) -> torch.Tensor:
    """(U, F, length) segments centered at each position (edge-padded)."""
    pad = length // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="replicate")[:, 0]
    idx = (centers[:, None] + torch.arange(length, device=x.device)).reshape(-1)
    return xp[:, idx].reshape(x.shape[0], centers.shape[0], length)


def _ncc_matrix(x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len):
    """The NCC front end of the two NCC pickers: returns (ncc (U, F, L)
    unmasked, nccm masked to -1 outside the lag range, local_max, total
    (U, F, 1) frame energies)."""
    hop = int(round(sr * frame_period_ms / 1000.0))
    n_frames = x.shape[-1] // hop + 1
    centers = torch.arange(n_frames, device=x.device) * hop
    seg = _extract_segments(x, centers, seg_len)
    seg = seg - seg.mean(dim=-1, keepdim=True)
    n_fft = 2 * seg_len
    ac = torch.fft.irfft(rfft_magsq(seg, n_fft).to(torch.complex64), n=n_fft)[..., :seg_len]

    # r[tau] = ac[tau] / sqrt(e0[tau] e1[tau]), e0 = sum_{t<L-tau} x², e1 = sum_{t>=tau} x²
    csum = cumsum(seg * seg)
    total = csum[..., -1:]
    tau = torch.arange(seg_len, device=x.device)
    cpad = F.pad(csum, (1, 0))
    e0 = cpad[..., seg_len - tau]
    e1 = total - cpad[..., tau]
    ncc = ac / torch.sqrt(torch.clamp(e0 * e1, min=1e-12))

    lag_min = int(math.floor(sr / f0_ceil))
    lag_max = int(math.ceil(sr / f0_floor))
    valid = (tau >= lag_min) & (tau <= min(lag_max, seg_len - 2))
    nccm = torch.where(valid, ncc, torch.full_like(ncc, -1.0))
    local_max = (nccm >= F.pad(nccm, (1, 0))[..., :-1]) & (nccm >= F.pad(nccm, (0, 1))[..., 1:])
    return ncc, nccm, local_max, total


def _ncc_candidates(x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len):
    ncc, nccm, local_max, total = _ncc_matrix(x, sr, frame_period_ms, f0_floor, f0_ceil,
                                              seg_len)
    tau = torch.arange(seg_len, device=x.device)
    # a periodic signal has near-equal NCC peaks at every multiple of its
    # period: take the smallest-lag local maximum within 10 % of the global
    # maximum, not the global argmax
    global_max = nccm.max(dim=-1, keepdim=True).values
    good = local_max & (nccm >= 0.90 * global_max) & (global_max > 0)
    pref = torch.where(good, seg_len - tau, torch.full_like(tau, -1))
    peak_lag = torch.argmax(pref, dim=-1)
    no_cand = pref.max(dim=-1).values < 0
    peak_lag = torch.where(no_cand, torch.argmax(nccm, dim=-1), peak_lag)
    peak_val = gather_last(nccm, peak_lag[..., None])[..., 0]
    lm1 = gather_last(ncc, torch.clamp(peak_lag - 1, min=0)[..., None])[..., 0]
    lp1 = gather_last(ncc, torch.clamp(peak_lag + 1, max=seg_len - 1)[..., None])[..., 0]
    denom2 = lm1 - 2.0 * peak_val + lp1
    delta = torch.where(torch.abs(denom2) > 1e-9, 0.5 * (lm1 - lp1) / denom2,
                        torch.zeros_like(denom2))
    lag = peak_lag.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    return sr / torch.clamp(lag, min=1.0), peak_val, total[..., 0]


def _median5(x: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x[:, None, :], (2, 2), mode="replicate")[:, 0]
    stack = torch.stack([xp[:, i: i + x.shape[-1]] for i in range(5)])
    return stack.median(dim=0).values


def estimate_f0(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
                f0_floor: float = 71.0, f0_ceil: float = 800.0,
                voicing_threshold: float = 0.45, seg_len: int = 512):
    """NCC f0 contour; F = T // hop + 1 frames. Returns (f0, voiced)."""
    x, single = _batch(x)
    f0, ncc, energy = _ncc_candidates(x, sr, frame_period_ms, f0_floor, f0_ceil, seg_len)
    gate = energy > 1e-6 * torch.clamp(energy.max(dim=-1, keepdim=True).values, min=1e-12)
    voiced = (ncc > voicing_threshold) & gate
    v = voiced.to(torch.float32)
    vp = F.pad(v, (1, 1))
    voiced = voiced & ((vp[:, :-2] + vp[:, 2:]) > 0)      # no isolated voiced frame
    zero = torch.zeros_like(f0)
    f0_smooth = _median5(torch.where(voiced, f0, zero))
    out = torch.where(voiced & (f0_smooth > 0), f0_smooth, zero)
    out = torch.where((out >= f0_floor) & (out <= f0_ceil), out, zero)
    out = out[0] if single else out
    return out, out > 0


def estimate_f0_tracked(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
                        f0_floor: float = 71.0, f0_ceil: float = 800.0, seg_len: int = 512,
                        n_cand: int = 5, voicing_threshold: float = 0.45,
                        transition_weight: float = 6.0, voicing_switch_cost: float = 1.0):
    """F0 by a Viterbi path through the top-``n_cand`` NCC local maxima of
    every frame and one unvoiced state. Emission: the NCC score (voiced) or
    ``voicing_threshold`` (unvoiced); transition −transition_weight·|Δ log f|
    between voiced states, −voicing_switch_cost on a voicing flip. The top-k
    is a stable descending sort: ties go to the lower lag, as in
    ``lax.top_k``. Returns (f0, voiced)."""
    x, single = _batch(x)
    _, nccm, local_max, total = _ncc_matrix(x, sr, frame_period_ms, f0_floor, f0_ceil,
                                            seg_len)
    masked = torch.where(local_max, nccm, torch.full_like(nccm, -1.0))
    scores, lags = torch.sort(masked, dim=-1, descending=True, stable=True)
    scores, lags = scores[..., :n_cand], lags[..., :n_cand]
    freqs = sr / torch.clamp(lags.to(torch.float32), min=1.0)               # (U, F, C)
    energy = total[..., 0]
    gate = energy > 1e-6 * torch.clamp(energy.max(dim=-1, keepdim=True).values, min=1e-12)

    U, Fr, C = freqs.shape
    S = C + 1                                        # the last state is unvoiced
    logf = torch.log(torch.clamp(freqs, min=1.0))
    emit = torch.cat([torch.where(scores > -0.5, scores, torch.full_like(scores, -5.0)),
                      torch.full((U, Fr, 1), voicing_threshold, device=x.device)], dim=-1)
    trans = torch.full((U, Fr, S, S), -voicing_switch_cost, device=x.device)
    trans[:, 1:, :C, :C] = -transition_weight * torch.abs(logf[:, :-1, :, None]
                                                          - logf[:, 1:, None, :])
    trans[:, :, C, C] = 0.0
    cum = emit[:, 0]
    antes = []
    for t in range(1, Fr):
        step = cum[:, :, None] + trans[:, t]
        best, ante = step.max(dim=1)
        antes.append(ante)
        cum = best + emit[:, t]
    states = torch.empty((U, Fr), dtype=torch.int64)
    states[:, -1] = torch.argmax(cum, dim=-1).cpu()
    if antes:
        ante_h = torch.stack(antes, dim=1).cpu()                            # (U, F-1, S)
        for t in range(Fr - 2, -1, -1):
            states[:, t] = ante_h[:, t].gather(1, states[:, t + 1:t + 2])[:, 0]
    states = states.to(x.device)
    picked = gather_last(freqs, torch.clamp(states, max=C - 1)[..., None])[..., 0]
    voiced = (states < C) & gate
    zero = torch.zeros_like(picked)
    f0 = torch.where(voiced, picked, zero)
    f0 = torch.where((f0 >= f0_floor) & (f0 <= f0_ceil), f0, zero)
    f0 = f0[0] if single else f0
    return f0, f0 > 0


def refine_f0_stonemask(x: torch.Tensor, f0: torch.Tensor, sr: int = 16000,
                        frame_period_ms: float = 5.0, f0_floor: float = 71.0,
                        f0_ceil: float = 800.0, fft_size: int | None = None,
                        max_win: int | None = None, n_harmonics: int = 6) -> torch.Tensor:
    """WORLD StoneMask refinement of ``f0`` (F,) or (U, F): frames refine
    only where the input is voiced, and the result is clamped at WORLD's
    kFloorF0StoneMask = 40 Hz. The window capacity covers the 3/f0_floor
    Blackman window at this sample rate."""
    if max_win is None:
        max_win = 2 * int(math.ceil(3.0 * sr / f0_floor / 2.0)) + 2
    if fft_size is None:
        fft_size = int(2 ** (math.ceil(math.log2(max_win)) + 1))
    x, single = _batch(x)
    f0 = f0[None] if single else f0
    hop = int(round(sr * frame_period_ms / 1000.0))
    centers = torch.arange(f0.shape[-1], device=x.device) * hop
    cf = torch.clamp(torch.where(f0 > 0, f0, torch.full_like(f0, f0_floor)), f0_floor, f0_ceil)
    refined, _, _ = flanagan_refine(x, cf, centers, sr, fft_size, max_win, n_harmonics)
    good = (refined >= 40.0) & (refined <= f0_ceil)
    out = torch.where((f0 > 0) & good, refined, torch.zeros_like(refined))
    return out[0] if single else out
