"""Dictionary-sharded NMF: the exemplar dictionary split over ranks (port of
``exemplars_vc_tpu/parallel/sharded_nmf.py``).

The K axis of the dictionary A (K, D) and of the activations H (F, K) is
split over the mesh's ``dict`` axis: rank r holds A_loc (K/n, D) and H_loc
(F, K/n). Per MU iteration:

    P     = H_loc · A_loc     ``nmf_recon`` (partial (F, D)) → one all-reduce (SUM)
    H_loc ← H_loc ⊙ Num_loc / (P · A_locᵀ)   ``nmf_update``, Num_loc = X · A_locᵀ

One (F, D) all-reduce an iteration, small next to the two K-sized products;
X is on every rank. The error check reads the all-reduced P, so every rank
sees the same error and stops at the same block, and that P feeds the next
update (H has not changed in between), as in the single-device solve: a
solve takes 1 + n_iter recon launches a rank. The all-reduce sums the ranks'
partials in another order than one kernel sums K, so the result agrees with
the single-device solve to rounding, not bit for bit; every rank of a line
holds the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from exemplars_vc_tpu_torch.factorize.nmf import NmfState, _frob_error, _mu_loop
from exemplars_vc_tpu_torch.factorize.nmf_cuda import nmf_recon, nmf_update
from exemplars_vc_tpu_torch.parallel.distributed import all_gather_cat
from exemplars_vc_tpu_torch.parallel.mesh import DICT_AXIS, Mesh


def sharded_nmf_activations(X: torch.Tensor, A: torch.Tensor, mesh: Mesh,
                            tol: float = 1e-4, max_iter: int = 150, check_every: int = 10,
                            axis: str = DICT_AXIS) -> NmfState:
    """Frobenius-MU activations with A and H split over ``axis`` of ``mesh``.

    Every rank of the mesh calls it with the same X (F, D) and the whole A
    (K, D), K divisible by the axis' size, on its own device; it takes its
    block of A's rows. H0 = sqrt(max(mean X, 0) / K) with the global K; the
    tol test every ``check_every`` steps and the remainder of ``max_iter`` as
    in ``factorize.nmf``. Returns this rank's shard: H_loc (F, K/n), n_iter
    and the error (equal on every rank); :func:`gather_activations` makes
    the whole H."""
    X = X.float().contiguous()
    A = A.float()
    F = X.shape[0]
    K = A.shape[0]
    n = mesh.shape[axis]
    if K % n:
        raise ValueError(f"K={K} not divisible by {n} dictionary shards")
    r = mesh.axis_index(axis)
    group = mesh.group(axis)
    kl = K // n
    A_loc = A[r * kl:(r + 1) * kl].contiguous()
    avg = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K)
    H = avg.expand(F, kl).contiguous()
    Num = X @ A_loc.T

    def recon(H):
        P = nmf_recon(H, A_loc)
        if group is not None:
            dist.all_reduce(P, op=dist.ReduceOp.SUM, group=group)
        return P

    checked = []      # the last check's P; H has not changed since

    def step(H):
        P = checked.pop() if checked else recon(H)
        return nmf_update(P, A_loc, H, Num, 0.0, out=H)

    def error(H):
        checked[:] = [recon(H)]
        return _frob_error(X, checked[0])

    return NmfState(*_mu_loop(H, step, error, tol, max_iter, check_every))


def gather_activations(H_loc: torch.Tensor, mesh: Mesh, axis: str = DICT_AXIS) -> torch.Tensor:
    """The whole H (F, K) on every rank of the line: the shards of
    :func:`sharded_nmf_activations`, all-gathered in rank order."""
    return all_gather_cat(H_loc, mesh.group(axis), dim=1)
