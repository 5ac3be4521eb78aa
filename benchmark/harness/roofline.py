"""The least time of a conversion's activation solve on one H100, from its
shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores (the solve is float32 with TF32 off),
3.35 TB/s of HBM3. The work is what the method needs, whatever kernels run
it, for one fixed-dictionary MU solve of F frames over K exemplars of D
bins that ran ``n_iter`` steps:

- the numerator X·Aᵀ once: 2·F·K·D;
- the reconstruction H·A once a step and once for the first error: 2·F·K·D
  × (n_iter + 1) (a check's reconstruction feeds the next step);
- the denominator (H·A)·Aᵀ a step: 2·F·K·D × n_iter, and the update's
  division, product and guard: 3·F·K × n_iter;
- the conversion Y = H·B: 2·F·K·D; with the residual (the WORLD path) also
  H·A and X / (H·A) ⊙ Y: 2·F·K·D + 2·F·D.

Bytes: X, A and B read once and Y written once, in float32 (H lives between
steps and is not counted). The least time is the larger of the operations
over the peak rate and the bytes over the bandwidth.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def solve_work(F: int, K: int, D: int, n_iter: int, residual: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one solve and its conversion."""
    fkd = 2 * F * K * D
    flops = fkd * (1 + (n_iter + 1) + n_iter + 1) + 3 * F * K * n_iter
    if residual:
        flops += fkd + 2 * F * D
    nbytes = 4 * (F * D + 2 * K * D + F * D)
    return flops, nbytes


def least_seconds(flops: int, nbytes: int) -> float:
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
