"""Utterance-batch data-parallel DTW over the mesh (port of
``exemplars_vc_tpu/parallel/sharded_dtw.py``).

The dictionary build's pair axis splits over the mesh's ``data`` axis: each
rank runs ``dtw_batch`` (the wavefront and backtrace kernels) on its pairs
with no communication, and the results are all-gathered, so every rank
holds the whole batch's result as the JAX package's global array does.
"""

from __future__ import annotations

import torch

from exemplars_vc_tpu_torch.align.dtw import DtwResult, dtw_batch
from exemplars_vc_tpu_torch.parallel.distributed import all_gather_cat
from exemplars_vc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def sharded_dtw_batch(feats_a, feats_b, lens_a, lens_b, mesh: Mesh, axis: str = DATA_AXIS,
                      *, device: str | torch.device = "cuda") -> DtwResult:
    """``dtw_batch`` with the pair axis split over ``axis``. Every rank
    passes the whole batch (arrays or tensors); the pair count must divide by
    the axis' size (pad with dummy pairs if needed). Each rank aligns its
    contiguous block of pairs on ``device``; the result is the whole batch's."""
    n = feats_a.shape[0]
    m = mesh.shape[axis]
    if n % m:
        raise ValueError(f"{n} pairs not divisible by {m} shards")
    r = mesh.axis_index(axis)
    sl = slice(r * (n // m), (r + 1) * (n // m))
    fa = torch.as_tensor(feats_a[sl], device=device)
    fb = torch.as_tensor(feats_b[sl], device=device)
    res = dtw_batch(fa, fb, torch.as_tensor(lens_a)[sl], torch.as_tensor(lens_b)[sl])
    group = mesh.group(axis)
    return DtwResult(*(all_gather_cat(t, group) for t in res))
