"""WORLD analysis: f0 → envelope → aperiodicity (port of
``exemplars_vc_tpu/world/analysis.py``), the chain the reference runs with
pyworld (``pw.dio → pw.stonemask → pw.cheaptrick → pw.d4c``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.world.cheaptrick import cheaptrick
from benchmark.reference.world.d4c import d4c_aperiodicity
from benchmark.reference.world.dio import estimate_f0_dio
from benchmark.reference.world.f0 import refine_f0_stonemask


class WorldFeatures(NamedTuple):
    f0: torch.Tensor       # (..., F) Hz, 0 where unvoiced
    sp: torch.Tensor       # (..., F, fft//2+1) spectral envelope (power)
    ap: torch.Tensor       # (..., F, fft//2+1) aperiodicity in (0, 1)
    centers: torch.Tensor  # (F,) sample positions
    sr: int
    frame_period_ms: float


def analyze(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
            f0_floor: float = 71.0, f0_ceil: float = 800.0, fft_size: int = 1024,
            refine_f0: bool = True) -> WorldFeatures:
    """WORLD features of x (T,) or of a padded batch of utterances (U, T):
    f0 by DIO (the only ``world.f0_method`` the benchmark's reference has;
    ``convert.check_plain`` refuses the others); ``refine_f0`` runs
    StoneMask (the reference config's f0_is_refined)."""
    x = x.to(torch.float32)
    hop = int(round(sr * frame_period_ms / 1000.0))
    f0, _ = estimate_f0_dio(x, sr=sr, frame_period_ms=frame_period_ms, f0_floor=f0_floor,
                            f0_ceil=f0_ceil)
    if refine_f0:
        f0 = refine_f0_stonemask(x, f0, sr=sr, frame_period_ms=frame_period_ms,
                                 f0_floor=f0_floor, f0_ceil=f0_ceil)
    centers = torch.arange(f0.shape[-1], device=x.device) * hop
    sp = cheaptrick(x, f0, centers, sr=sr, fft_size=fft_size, f0_floor=f0_floor)
    ap = d4c_aperiodicity(x, f0, centers, sr=sr, fft_size=fft_size)
    return WorldFeatures(f0=f0, sp=sp, ap=ap, centers=centers, sr=sr,
                         frame_period_ms=frame_period_ms)
