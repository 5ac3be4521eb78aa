"""WORLD analysis: f0 → envelope → aperiodicity (port of
``exemplars_vc_tpu/world/analysis.py``), the chain the reference runs with
pyworld (``pw.dio → pw.stonemask → pw.cheaptrick → pw.d4c``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.world.cheaptrick import cheaptrick
from exemplars_vc_tpu_torch.world.d4c import d4c_aperiodicity
from exemplars_vc_tpu_torch.world.dio import estimate_f0_dio
from exemplars_vc_tpu_torch.world.f0 import (
    estimate_f0,
    estimate_f0_tracked,
    refine_f0_stonemask,
)
from exemplars_vc_tpu_torch.world.harvest import estimate_f0_harvest

F0_METHODS = {"dio": estimate_f0_dio, "harvest": estimate_f0_harvest,
              "tracked": estimate_f0_tracked, "ncc": estimate_f0}


class WorldFeatures(NamedTuple):
    f0: torch.Tensor       # (..., F) Hz, 0 where unvoiced
    sp: torch.Tensor       # (..., F, fft//2+1) spectral envelope (power)
    ap: torch.Tensor       # (..., F, fft//2+1) aperiodicity in (0, 1)
    centers: torch.Tensor  # (F,) sample positions
    sr: int
    frame_period_ms: float


def analyze(x: torch.Tensor, sr: int = 16000, frame_period_ms: float = 5.0,
            f0_floor: float = 71.0, f0_ceil: float = 800.0, fft_size: int = 1024,
            refine_f0: bool = True, f0_method: str = "ncc") -> WorldFeatures:
    """WORLD features of x (T,) or of a padded batch of utterances (U, T).
    ``f0_method``: "dio", "harvest", "tracked" or anything else for "ncc"
    (as the reference); ``refine_f0`` runs StoneMask (the reference
    config's f0_is_refined). While a profiler records, the three steps are
    the spans ``world.f0`` (the estimate and StoneMask), ``world.cheaptrick``
    and ``world.d4c`` (``obs.profiling``)."""
    x = x.to(torch.float32)
    hop = int(round(sr * frame_period_ms / 1000.0))
    estimate = F0_METHODS.get(f0_method, estimate_f0)
    with Timer(x.device, name="world.f0"):
        f0, _ = estimate(x, sr=sr, frame_period_ms=frame_period_ms, f0_floor=f0_floor,
                         f0_ceil=f0_ceil)
        if refine_f0:
            f0 = refine_f0_stonemask(x, f0, sr=sr, frame_period_ms=frame_period_ms,
                                     f0_floor=f0_floor, f0_ceil=f0_ceil)
    centers = torch.arange(f0.shape[-1], device=x.device) * hop
    with Timer(x.device, name="world.cheaptrick"):
        sp = cheaptrick(x, f0, centers, sr=sr, fft_size=fft_size, f0_floor=f0_floor)
    with Timer(x.device, name="world.d4c"):
        ap = d4c_aperiodicity(x, f0, centers, sr=sr, fft_size=fft_size)
    return WorldFeatures(f0=f0, sp=sp, ap=ap, centers=centers, sr=sr,
                         frame_period_ms=frame_period_ms)
