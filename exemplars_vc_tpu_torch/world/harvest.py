"""Harvest f0 estimation (port of ``exemplars_vc_tpu/world/harvest.py``).

Harvest (Morise 2017) as in the WORLD sources, held to the float64 oracle
``tests/oracles/world_harvest.py``:

1. 50 Hz low-cut, then a dense band-pass channel bank: boundary f0s at 40
   channels an octave over [0.9·floor, 1.1·ceil], each channel a 4-period
   Nuttall-windowed cosine at its boundary (zero phase);
2. four event-interval tracks a channel interpolated onto a 1 ms grid; a
   channel yields a candidate where their mean lies within
   [0.9, 1.1]·boundary ∩ [floor, ceil];
3. official candidates: runs of > 2 adjacent agreeing channels merge to
   their mean (≤ 12 a frame);
4. refinement: each (frame, candidate) through the Flanagan estimator,
   giving a refined f0 and a reliability score; each frame's pool is then
   overlapped with its ±3 neighbours;
5. contour: best score a frame; jump removal, short-run removal, the
   candidate-pool extension (``dio.extend_from_candidates``); a final
   own-frame re-refinement; zero-phase [¼ ½ ¼]² smoothing of voiced
   segments; sampled from the 1 ms grid at the frame period.

The 12 candidate rows are refined one after another, as the reference
does, so the refinement's (points, window) workspace stays that of one row.
Takes x (T,) or a padded batch (U, T), like ``dio``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.world._ops import nuttall
from exemplars_vc_tpu_torch.world.dio import (
    _event_tracks,
    _fix_short_runs,
    _interp_tracks,
    _lowcut_50hz,
    extend_from_candidates,
)
from exemplars_vc_tpu_torch.world.refine import flanagan_refine

CHANNELS_IN_OCTAVE = 40.0
BASIC_PERIOD_MS = 1.0
OVERLAP_NEIGHBORS = 3
MAX_CANDIDATES = 12


def _bandpass_bank(sr: int, f0_floor: float, f0_ceil: float):
    """(n_ch, L) zero-phase band-pass FIRs + boundary f0s (float32)."""
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_ch = 1 + int(math.log2(adj_ceil / adj_floor) * CHANNELS_IN_OCTAVE)
    boundaries = adj_floor * 2.0 ** ((1 + np.arange(n_ch)) / CHANNELS_IN_OCTAVE)
    halves = [int(np.floor(sr / b * 2.0 + 0.5)) for b in boundaries]
    L = 2 * max(halves) + 1
    bank = np.zeros((n_ch, L), np.float32)
    c = L // 2
    for i, (b, h) in enumerate(zip(boundaries, halves)):
        n = 2 * h + 1
        t = (np.arange(n) - h) / sr
        bank[i, c - h: c + h + 1] = nuttall(n) * np.cos(2.0 * np.pi * b * t)
    return bank, np.asarray(boundaries, np.float32)


def _official_candidates(raw: torch.Tensor, max_candidates: int) -> torch.Tensor:
    """Merge runs (> 2 long) of adjacent agreeing channels a frame: raw
    (U, n_ch, F) channel candidates (0 = none) → (U, max_candidates, F),
    the accepted runs' means in channel order, zero-filled."""
    U, n_ch, Fr = raw.shape
    m = raw > 0.0
    prev = F.pad(m, (0, 0, 1, 0))[:, :-1]
    run_id = torch.cumsum((m & ~prev).to(torch.int64), dim=1) * m        # 0 = no run
    sums = torch.zeros((U, n_ch + 1, Fr), dtype=raw.dtype, device=raw.device)
    sums.scatter_add_(1, run_id, raw)
    counts = torch.zeros_like(sums)
    counts.scatter_add_(1, run_id, ((run_id > 0) & (raw > 0)).to(raw.dtype))
    ok = counts > 2.0                                                   # ≥ 3 channels agree
    means = torch.where(ok, sums / torch.clamp(counts, min=1.0), torch.zeros_like(sums))
    # compact the accepted runs (run ids ascend with the channel); the sort
    # is stable, as the reference's
    order = torch.where(ok, torch.arange(n_ch + 1, device=raw.device)[None, :, None],
                        torch.full_like(run_id[:, :1], n_ch + 1).expand(U, n_ch + 1, Fr))
    rank = torch.argsort(order, dim=1, stable=True)
    return torch.gather(means, 1, rank)[:, :max_candidates]


def _refine_batch(x, cf, centers, sr, f0_floor, f0_ceil, max_win, fft_size, n_harmonics=6):
    """Refine candidates cf (U, P) at sample centers (P,) → (refined,
    score): Harvest's GetRefinedF0 gates around the Flanagan estimator."""
    valid = cf > 0.0
    cfs = torch.clamp(torch.where(valid, cf, torch.full_like(cf, f0_floor)), f0_floor, f0_ceil)
    refined, score, den = flanagan_refine(x, cfs, centers, sr, fft_size, max_win, n_harmonics)
    good = valid & (den > 0) & (refined >= f0_floor) & (refined <= f0_ceil)
    zero = torch.zeros_like(refined)
    return torch.where(good, refined, zero), torch.where(good, score, zero)


def _overlap(a: torch.Tensor, n: int) -> torch.Tensor:
    """(U, C, F) → (U, C·(2n+1), F): each frame also sees ±n neighbours' rows."""
    Fr = a.shape[-1]
    outs = [a]
    for s in range(1, n + 1):
        outs.append(F.pad(a, (s, 0))[..., :Fr])
        outs.append(F.pad(a, (0, s))[..., s:])
    return torch.cat(outs, dim=1)


def _smooth_voiced(f0: torch.Tensor) -> torch.Tensor:
    """Two zero-phase [¼ ½ ¼] passes with per-voiced-segment edge
    replication (the oracle's reflect-padded segment smoothing)."""
    def one(f):
        v = f > 0
        fp, vp = F.pad(f, (1, 0))[:, :-1], F.pad(v, (1, 0))[:, :-1]
        fn, vn = F.pad(f, (0, 1))[:, 1:], F.pad(v, (0, 1))[:, 1:]
        left = torch.where(vp, fp, f)
        right = torch.where(vn, fn, f)
        return torch.where(v, 0.25 * left + 0.5 * f + 0.25 * right, torch.zeros_like(f))

    return one(one(f0))


def estimate_f0_harvest(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
                        f0_floor: float = 71.0, f0_ceil: float = 800.0,
                        allowed_range: float = 0.1):
    """WORLD-Harvest f0 contour of x (T,) or (U, T). Returns (f0, voiced)
    of (..., F) with F = T·1000/(sr·frame_period_ms) + 1."""
    single = x.dim() == 1
    x = (x[None] if single else x).to(torch.float32)
    U, T = x.shape
    dev = x.device
    F1 = int(T / sr * 1000.0 / BASIC_PERIOD_MS) + 1
    hop1 = sr * BASIC_PERIOD_MS / 1000.0
    pos1 = torch.arange(F1, dtype=torch.float32, device=dev) * np.float32(hop1)

    bank, boundaries = _bandpass_bank(sr, f0_floor, f0_ceil)
    n_ch, L = bank.shape
    xh = _lowcut_50hz(x - x.mean(dim=-1, keepdim=True), sr)
    pad = L // 2
    xp = F.pad(xh, (pad, L - 1 - pad))[:, None, :]
    filtered = F.conv1d(xp, torch.as_tensor(bank, device=dev)[:, None, :])   # (U, C, T)

    d = torch.diff(filtered, dim=-1)
    d = torch.cat([d, d[..., -1:]], dim=-1)
    sigs = torch.cat([filtered, -filtered, d, -d], dim=1).reshape(U * 4 * n_ch, T)
    offsets = torch.cat([torch.zeros(2 * n_ch), torch.full((2 * n_ch,), 0.5)]).to(dev).repeat(U)
    # a band-passed signal's event rate is bounded by its band (top boundary
    # ≈ 1.11·f0_ceil); twice that, so noisy channels do not overflow
    e_max = int(T / sr * f0_ceil * 2.0) + 16
    loc, iv, count = _event_tracks(sigs, offsets, e_max)
    n_mid = torch.clamp(count - 1, min=0)
    tracks_hz = _interp_tracks(loc, iv, n_mid, pos1) * sr
    usable = (count >= 3).reshape(U, 4, n_ch).all(dim=1)

    tr = tracks_hz.reshape(U, 4, n_ch, F1)
    cand = tr.mean(dim=1)                                               # (U, C, F1)
    b = torch.as_tensor(boundaries, device=dev)[None, :, None]
    bad = ((cand < 0.9 * b) | (cand > 1.1 * b) | (cand < f0_floor) | (cand > f0_ceil)
           | ~usable[:, :, None])
    raw = torch.where(bad, torch.zeros_like(cand), cand)
    official = _official_candidates(raw, MAX_CANDIDATES)                # (U, 12, F1)

    # refinement, one candidate row after another
    max_win = 2 * int(math.ceil(3.0 * sr / f0_floor / 2.0)) + 2
    fft_size = int(2 ** (math.ceil(math.log2(max_win)) + 1))
    centers1 = torch.floor(pos1 + 0.5).to(torch.int64)
    rows = [_refine_batch(x, official[:, r], centers1, sr, f0_floor, f0_ceil, max_win,
                          fft_size) for r in range(official.shape[1])]
    refined = _overlap(torch.stack([r[0] for r in rows], dim=1), OVERLAP_NEIGHBORS)
    score = _overlap(torch.stack([r[1] for r in rows], dim=1), OVERLAP_NEIGHBORS)

    best = torch.argmax(score, dim=1)[:, None]
    f0 = torch.gather(refined, 1, best)[:, 0]
    f0 = torch.where(torch.gather(score, 1, best)[:, 0] > 0, f0, torch.zeros_like(f0))

    # contour fixes on the 1 ms grid
    prev = F.pad(f0, (1, 0))[:, :-1]
    jump = (f0 > 0) & (prev > 0) & (
        torch.abs(f0 - prev) / torch.clamp(f0, min=1e-12) > allowed_range)
    f0 = torch.where(jump, torch.zeros_like(f0), f0)
    vmin = int(0.5 + 1000.0 / BASIC_PERIOD_MS / f0_floor) + 1
    f0 = _fix_short_runs(f0, vmin)
    f0 = extend_from_candidates(f0, refined, allowed_range)

    # the selected contour refined once more at its own frames
    f0_ref, score_ref = _refine_batch(x, f0, centers1, sr, f0_floor, f0_ceil, max_win,
                                      fft_size)
    f0 = torch.where((f0 > 0) & (score_ref > 0), f0_ref, f0)
    f0 = _smooth_voiced(f0)

    # sample the 1 ms contour at the frame period
    Fr = int(T / sr * 1000.0 / frame_period_ms) + 1
    q = torch.arange(Fr, dtype=torch.float32, device=dev) * np.float32(
        frame_period_ms / BASIC_PERIOD_MS)
    idx = torch.clamp(torch.floor(q + 0.5).to(torch.int64), max=F1 - 1)
    out = f0[:, idx]
    out = out[0] if single else out
    return out, out > 0
