"""Dynamic time warping over the wavefront kernels (port of
``exemplars_vc_tpu/align/dtw.py``).

The cost matrix is one batched matmul, ‖a‖² + ‖b‖² − 2·a·bᵀ clamped at 0 —
the reference's formula; another one (``torch.cdist``) rounds differently,
moves ties and so moves paths. The DP and the backtrace run in
:mod:`exemplars_vc_tpu_torch.align.dtw_cuda` (kernels on the card, plain
twins on the CPU). The distance is the raw cost over ``len_a + len_b``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from exemplars_vc_tpu_torch.align.dtw_cuda import BIG, dtw_backtrace, dtw_wavefront


class DtwResult(NamedTuple):
    distance: torch.Tensor      # normalized distance D[end] / (len_a + len_b)
    raw_distance: torch.Tensor  # D[len_a-1, len_b-1]
    path_i: torch.Tensor        # (..., Ta+Tb-1) int32, ascending, padded with -1
    path_j: torch.Tensor
    path_len: torch.Tensor      # (...,) int32


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Ta, D), (..., Tb, D) → (..., Ta, Tb) squared-euclidean cost."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    cross = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * cross, min=0.0)


def band_mask(ta: int, tb: int, la: torch.Tensor, lb: torch.Tensor,
              band: int) -> torch.Tensor:
    """(N, Ta, Tb) Sakoe-Chiba band around the stretched diagonal, in
    source-frame units (``dtw.py:_band_mask``)."""
    dev = la.device
    i = torch.arange(ta, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(tb, dtype=torch.float32, device=dev)[None, None, :]
    slope = la.float() / torch.clamp(lb.float(), min=1.0)
    return torch.abs(i - j * slope[:, None, None]) <= band


def dtw_batch(feats_a: torch.Tensor, feats_b: torch.Tensor,
              lens_a, lens_b, band: int | None = None) -> DtwResult:
    """Batched alignment: (N, Ta, D) vs (N, Tb, D) with true lengths (N,).

    The lengths are tensors or host arrays. They are range-checked once, on
    the host: host arrays (or CPU tensors) as they are, device tensors after
    one copy back, which waits for the device; both kernels then take that
    host copy."""
    ta, tb = feats_a.shape[1], feats_b.shape[1]
    C = pairwise_sqdist(feats_a.float(), feats_b.float())
    lens_host = torch.stack([torch.as_tensor(lens_a).to(torch.int32).cpu(),
                             torch.as_tensor(lens_b).to(torch.int32).cpu()], dim=1)
    lens = lens_host.to(C.device).contiguous()
    if band is not None:
        C = torch.where(band_mask(ta, tb, lens[:, 0], lens[:, 1], band), C, BIG)
    raw, dirs = dtw_wavefront(C.contiguous(), lens, lens_host)
    path_i, path_j, path_len = dtw_backtrace(dirs, lens, lens_host)
    dist = raw / (lens[:, 0] + lens[:, 1]).float()
    return DtwResult(dist, raw, path_i, path_j, path_len)


def dtw(feat_a: torch.Tensor, feat_b: torch.Tensor,
        len_a: int | None = None, len_b: int | None = None,
        band: int | None = None) -> DtwResult:
    """Align one pair (Ta, D) vs (Tb, D); lengths default to the full rows."""
    la = torch.tensor([feat_a.shape[0] if len_a is None else int(len_a)])
    lb = torch.tensor([feat_b.shape[0] if len_b is None else int(len_b)])
    r = dtw_batch(feat_a[None], feat_b[None], la, lb, band=band)
    return DtwResult(*(x[0] for x in r))
