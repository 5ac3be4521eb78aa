"""F0 refinement (port of ``exemplars_vc_tpu/world/f0.py``, its StoneMask
part): :func:`refine_f0_stonemask`, WORLD's StoneMask over the shared
Flanagan estimator. It takes x (T,) or a padded batch (U, T) and an f0
contour (..., F); unvoiced frames carry f0 = 0.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.world.refine import flanagan_refine


def _batch(x: torch.Tensor):
    single = x.dim() == 1
    return (x[None] if single else x).to(torch.float32), single


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
