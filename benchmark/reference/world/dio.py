"""DIO f0 estimation (port of ``exemplars_vc_tpu/world/dio.py``).

WORLD's DIO (Morise-Kawahara-Katayose 2009), held to the float64 oracle
``tests/oracles/world_dio.py``:

1. 50 Hz low-cut, then per channel c (boundary f0 = floor·2^((c+1)/2)) a
   zero-phase Nuttall low-pass of length 4·round(fs/boundary/2+½);
2. four event-interval tracks per channel (negative/positive zero
   crossings, peaks, dips), each 1/period at event midpoints, linearly
   interpolated onto the frame grid;
3. candidate = mean of the four, score = relative std; candidates outside
   [boundary/2, 2·boundary] ∪ [floor, ceil] invalid;
4. best contour = per-frame lowest score;
5. contour fixing: jumps over allowed_range killed, voiced runs shorter
   than voice_range_minimum frames killed, voiced regions re-extended from
   the candidate pool until stable.

Every function takes a batch of utterances (U, T) padded to one length,
as the reference's ``vmap`` does: the mean and the event capacity are
those of the padded signal. The extension of step 5 sweeps the whole batch
until every row is stable; it checks for that once every
``EXTEND_CHECK_EVERY`` sweeps (one host sync each, counted in
``extend_from_candidates.syncs``) and never runs more than F sweeps, the
reference's cap. A sweep of a stable contour returns it unchanged, so the
result is the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.world._ops import nuttall

EXTEND_CHECK_EVERY = 16


def _channel_filter_bank(sr: int, f0_floor: float, f0_ceil: float,
                         channels_in_octave: float):
    """(n_bands, L_max) zero-phase Nuttall low-pass FIRs + boundary f0s."""
    n_bands = 1 + int(math.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundaries = f0_floor * 2.0 ** ((1 + np.arange(n_bands)) / channels_in_octave)
    lens = [int(np.floor(sr / b / 2.0 + 0.5 + 0.5)) * 4 for b in boundaries]
    L = max(lens)
    bank = np.zeros((n_bands, L), np.float32)
    for i, n in enumerate(lens):
        w = nuttall(n)
        w = w / w.sum()
        start = (L - n) // 2                       # center → zero phase
        bank[i, start: start + n] = w
    return bank, np.asarray(boundaries, np.float32)


def _lowcut_50hz(x: torch.Tensor, sr: int) -> torch.Tensor:
    """Subtract a smooth ≤ 50 Hz trend: an edge-padded convolution of each
    row (U, T) with a normalised Hann window."""
    n = int(sr / 25) | 1
    w = np.hanning(n) / np.hanning(n).sum()
    # jnp.convolve flips its kernel; conv1d correlates
    w = torch.as_tensor(w[::-1].copy(), dtype=x.dtype, device=x.device)
    pad = n // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="replicate")
    trend = F.conv1d(xp, w[None, None, :])[:, 0, : x.shape[-1]]
    return x - trend


def _event_tracks(sig: torch.Tensor, offsets: torch.Tensor, e_max: int):
    """Batched event extraction. sig (M, T) → (loc (M, E), iv (M, E),
    count (M,)): interval midpoints (samples) and 1/period (per sample).
    Events past the capacity are dropped, as the reference's scatter
    drops out-of-range indices."""
    M, T = sig.shape
    s0, s1 = sig[:, :-1], sig[:, 1:]
    m = (s0 > 0.0) & (s1 <= 0.0)
    frac = torch.where(m, s0 / torch.where(m, s0 - s1, torch.ones_like(s0)),
                       torch.zeros_like(s0))
    tpos = torch.arange(T - 1, dtype=sig.dtype, device=sig.device) + frac + offsets[:, None]
    ordinal = torch.cumsum(m.to(torch.int64), dim=-1) - 1
    keep = m & (ordinal < e_max)
    idx = torch.where(keep, ordinal, torch.full_like(ordinal, e_max))
    times = torch.zeros((M, e_max + 1), dtype=sig.dtype, device=sig.device)
    times.scatter_(1, idx, torch.where(keep, tpos, torch.zeros_like(tpos)))
    times[:, e_max] = 0.0
    count = m.sum(dim=-1)
    t0, t1 = times[:, :-1], times[:, 1:]
    loc = (t0 + t1) / 2.0
    gap = t1 - t0
    iv = torch.where(gap > 0, 1.0 / torch.clamp(gap, min=1e-6), torch.zeros_like(gap))
    return loc, iv, count


def _interp_tracks(loc, iv, n_mid, pos):
    """``np.interp`` semantics, batched: loc/iv (M, E) with n_mid (M,) valid
    ascending midpoints; evaluate at pos (P,) → (M, P)."""
    M, E = loc.shape
    big = torch.tensor(np.float32(1e30), device=loc.device)
    locv = torch.where(torch.arange(E, device=loc.device)[None, :] < n_mid[:, None], loc, big)
    j = torch.searchsorted(locv, pos.expand(M, -1).contiguous())
    hi = torch.clamp(n_mid - 1, min=1)[:, None]
    j = torch.minimum(torch.clamp(j, min=1), hi)
    x0, x1 = torch.gather(locv, 1, j - 1), torch.gather(locv, 1, j)
    y0, y1 = torch.gather(iv, 1, j - 1), torch.gather(iv, 1, j)
    w = torch.clamp((pos - x0) / torch.clamp(x1 - x0, min=1e-6), 0.0, 1.0)
    return y0 + w * (y1 - y0)


def _fix_short_runs(f0: torch.Tensor, vmin: int) -> torch.Tensor:
    """Kill voiced runs shorter than vmin frames (FixStep2); f0 (U, F)."""
    Fr = f0.shape[-1]
    v = (f0 > 0).to(torch.int64)
    prev = F.pad(v, (1, 0))[:, :-1]
    run_id = torch.cumsum(v * (1 - prev), dim=-1) * v   # 1-based id a voiced run, 0 gaps
    lengths = torch.zeros((f0.shape[0], Fr + 1), dtype=torch.int64, device=f0.device)
    lengths.scatter_add_(1, run_id, v)
    ok = torch.gather(lengths, 1, run_id) >= vmin
    return torch.where((v > 0) & ok, f0, torch.zeros_like(f0))


def _pick(cands: torch.Tensor, ref: torch.Tensor, allowed_range: float) -> torch.Tensor:
    """Per frame, the candidate (U, C, F) nearest ``ref`` (U, F) within
    allowed_range of it, or 0."""
    diff = torch.abs(cands - ref[:, None, :])
    ok = (cands > 0) & (diff <= allowed_range * torch.clamp(ref, min=1e-6)[:, None, :])
    dist = torch.where(ok, diff, torch.full_like(diff, 1e30))
    mn, best = torch.min(dist, dim=1)
    val = torch.gather(cands, 1, best[:, None, :])[:, 0]
    return torch.where(mn < 1e29, val, torch.zeros_like(val))


def _sweep(f0: torch.Tensor, cands: torch.Tensor, allowed_range: float) -> torch.Tensor:
    left = F.pad(f0, (1, 0))[:, :-1]
    fill = _pick(cands, left, allowed_range)
    f0 = torch.where((f0 == 0) & (left > 0) & (fill > 0), fill, f0)
    right = F.pad(f0, (0, 1))[:, 1:]
    fill = _pick(cands, right, allowed_range)
    return torch.where((f0 == 0) & (right > 0) & (fill > 0), fill, f0)


def extend_from_candidates(f0: torch.Tensor, cands: torch.Tensor,
                           allowed_range: float) -> torch.Tensor:
    """FixStep3/4: grow voiced regions one frame a sweep from the candidate
    pool (U, C, F) until stable, at most F sweeps (module docstring)."""
    Fr = f0.shape[-1]
    done = 0
    while done < Fr:
        block = min(EXTEND_CHECK_EVERY, Fr - done)
        for _ in range(block - 1):
            f0 = _sweep(f0, cands, allowed_range)
        before = f0
        f0 = _sweep(f0, cands, allowed_range)
        done += block
        extend_from_candidates.syncs += 1
        if not bool((f0 != before).any()):
            break
    return f0


extend_from_candidates.syncs = 0


def estimate_f0_dio(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
                    f0_floor: float = 71.0, f0_ceil: float = 800.0,
                    channels_in_octave: float = 2.0, allowed_range: float = 0.1):
    """WORLD-DIO f0 contour of x (T,) or a padded batch (U, T). Returns
    (f0, voiced) of (..., F) with F = T·1000/(sr·frame_period_ms) + 1."""
    single = x.dim() == 1
    x = (x[None] if single else x).to(torch.float32)
    U, T = x.shape
    dev = x.device
    hop = sr * frame_period_ms / 1000.0
    Fr = int(T / sr * 1000.0 / frame_period_ms) + 1
    pos = torch.arange(Fr, dtype=torch.float32, device=dev) * np.float32(hop)

    bank, boundaries = _channel_filter_bank(sr, f0_floor, f0_ceil, channels_in_octave)
    n_bands, L = bank.shape
    xh = _lowcut_50hz(x - x.mean(dim=-1, keepdim=True), sr)
    pad = L // 2
    xp = F.pad(xh, (pad, L - 1 - pad))[:, None, :]
    filtered = F.conv1d(xp, torch.as_tensor(bank, device=dev)[:, None, :])   # (U, B, T)

    d = torch.diff(filtered, dim=-1)
    d = torch.cat([d, d[..., -1:]], dim=-1)
    sigs = torch.cat([filtered, -filtered, d, -d], dim=1).reshape(U * 4 * n_bands, T)
    offsets = torch.cat([torch.zeros(2 * n_bands), torch.full((2 * n_bands,), 0.5)])
    offsets = offsets.to(dev).repeat(U)

    e_max = max(T // 4, 16)
    loc, iv, count = _event_tracks(sigs, offsets, e_max)
    n_mid = torch.clamp(count - 1, min=0)
    tracks_hz = _interp_tracks(loc, iv, n_mid, pos) * sr          # (U·4B, F)
    usable = (count >= 3).reshape(U, 4, n_bands).all(dim=1)       # (U, B)

    tr = tracks_hz.reshape(U, 4, n_bands, Fr)
    cand = tr.mean(dim=1)                                         # (U, B, F)
    score = torch.sqrt(torch.sum((tr - cand[:, None]) ** 2, dim=1) / 3.0)
    score = score / torch.clamp(cand, min=1e-12)
    b = torch.as_tensor(boundaries, device=dev)[None, :, None]
    bad = ((cand < b / 2) | (cand > b * 2) | (cand < f0_floor) | (cand > f0_ceil)
           | ~usable[:, :, None])
    cand = torch.where(bad, torch.zeros_like(cand), cand)
    score = torch.where(bad, torch.full_like(score, 1e8), score)

    best = torch.gather(cand, 1, torch.argmin(score, dim=1)[:, None, :])[:, 0]

    # FixStep1: relative-jump removal (against the original neighbours)
    prev = F.pad(best, (1, 0))[:, :-1]
    jump = (best > 0) & (prev > 0) & (
        torch.abs(best - prev) / torch.clamp(best, min=1e-12) > allowed_range)
    f0 = torch.where(jump, torch.zeros_like(best), best)
    vmin = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1
    f0 = _fix_short_runs(f0, vmin)
    f0 = extend_from_candidates(f0, cand, allowed_range)
    if single:
        f0 = f0[0]
    return f0, f0 > 0
