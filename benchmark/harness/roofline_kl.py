"""The least time of a served KL solve on one H100, from its shapes alone,
on the peaks of :mod:`benchmark.harness.roofline`.

The work is what the method needs, whatever kernels run it, for one
fixed-dictionary KL MU solve of F frames over K exemplars of D bins that ran
``n_iter`` steps, then the box filter of half-width s and the conversion:

- the reconstruction P = H·A once a step and once for the first error:
  2·F·K·D × (n_iter + 1) (a check's reconstruction feeds the next step);
- the product R·Aᵀ a step: 2·F·K·D × n_iter;
- R = X ⊘ max(P, ε) a step: 2·F·D × n_iter;
- the update, a division by the row sums and a product: 2·F·K × n_iter;
- the error sqrt(2·D_KL) at each check, the first and one every 10 steps:
  6·F·D a check;
- the box filter, 2s additions and a division an entry: (2s + 1)·F·K;
- the conversion Y = H·B: 2·F·K·D.

Bytes are counted as :func:`benchmark.harness.roofline.solve_work` counts
them: X, A and B read once and Y written once, in float32.
"""

from __future__ import annotations

from benchmark.harness.roofline import solve_work

CHECK_EVERY = 10


def kl_solve_work(F: int, K: int, D: int, n_iter: int, s: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one KL solve, its box filter and its conversion."""
    fkd = 2 * F * K * D
    checks = 1 + -(-n_iter // CHECK_EVERY)
    flops = (fkd * ((n_iter + 1) + n_iter + 1) + 2 * F * D * n_iter + 2 * F * K * n_iter
             + 6 * F * D * checks + (2 * s + 1) * F * K)
    return flops, solve_work(F, K, D, n_iter)[1]
