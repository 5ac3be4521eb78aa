"""Mel-cepstral distortion (port of ``exemplars_vc_tpu/obs/metrics.py``).

``mcd_aligned`` aligns with the port's :func:`~exemplars_vc_tpu_torch.align.dtw.dtw`,
so on the card it runs the DTW kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from exemplars_vc_tpu_torch.align.dtw import dtw
from exemplars_vc_tpu_torch.align.exemplar import gather_aligned

_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mcd(c_a: torch.Tensor, c_b: torch.Tensor, exclude_c0: bool = True) -> torch.Tensor:
    """MCD (dB) between frame-aligned mel-cepstra (T, M+1), c0 excluded."""
    s = 1 if exclude_c0 else 0
    d = c_a[..., s:] - c_b[..., s:]
    return torch.mean(_MCD_CONST * torch.sqrt(torch.sum(d * d, dim=-1)))


def mcd_aligned(c_a: torch.Tensor, c_b: torch.Tensor) -> torch.Tensor:
    """MCD after DTW-aligning the two sequences (lengths may differ)."""
    r = dtw(c_a, c_b)
    ga = gather_aligned(c_a, r.path_i)
    gb = gather_aligned(c_b, r.path_j)
    mask = (r.path_i >= 0).to(c_a.dtype)
    d = ga[..., 1:] - gb[..., 1:]
    per_frame = _MCD_CONST * torch.sqrt(torch.sum(d * d, dim=-1))
    return torch.sum(per_frame * mask) / torch.clamp(torch.sum(mask), min=1.0)


def spectral_convergence(mag_est: torch.Tensor, mag_ref: torch.Tensor) -> torch.Tensor:
    """‖|X̂| − |X|‖_F / max(‖|X|‖_F, 1e-12)."""
    return torch.linalg.norm(mag_est - mag_ref) / torch.clamp(torch.linalg.norm(mag_ref),
                                                              min=1e-12)
