"""Sequence-parallel DTW: one long alignment split over ranks (port of
``exemplars_vc_tpu/parallel/sharded_long_dtw.py``).

- The cost matrix's rows split over the mesh axis: rank d owns the row
  block [d·R, (d+1)·R).
- Columns go in blocks of ``col_block``; the ranks form a systolic pipeline
  of super-steps: at step s rank d works on column block s − d, so all
  ranks are busy once the pipeline fills (n_ranks + n_blocks − 1 steps).
- A tile is one launch of the wavefront kernel's tile mode
  (``align.dtw_cuda.dtw_tile``): the rank's R rows × one column block, with
  the row above it (from rank d − 1), the column left of it (the rank's own
  previous tile) and the corner as halos. After each tile, its bottom row
  and the corner of the next block (the previous tile's last bottom value,
  one block late) go to rank d + 1 in one message (send/recv, the JAX
  package's ``ppermute``).
- Path mode keeps each tile's int8 codes in the rank's (R, Tb) strip, in
  the JAX layout (code (i, j) at row i, column j); the strips are
  all-gathered and :func:`backtrace_host` walks them. ``keep_dirs=False``
  builds each tile's costs from the feature blocks inside its step and runs
  the variant that stores no codes: the working set is O(R·col_block +
  (R + Tb)·D) a rank, and the distance equals the path mode's.

Each cell sees the neighbours and arithmetic of one sweep, so on the same
cost matrix the codes and the distance equal the single-device wavefront's
byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist
from exemplars_vc_tpu_torch.align.dtw_cuda import BIG, dtw_tile
from exemplars_vc_tpu_torch.parallel.distributed import all_gather_cat, send_recv
from exemplars_vc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def cost_strip(a_rows: torch.Tensor, b: torch.Tensor, tb: int) -> torch.Tensor:
    """The (R, Tb_pad) costs of a row block against the padded target: the
    squared distances, BIG in the padding columns from ``tb`` on."""
    C = pairwise_sqdist(a_rows.float(), b.float())
    ok = torch.arange(b.shape[0], device=C.device) < tb
    return torch.where(ok[None, :], C, BIG).contiguous()


def sharded_dtw_long(feat_a, feat_b, mesh: Mesh, axis: str = DATA_AXIS,
                     col_block: int | None = None, keep_dirs: bool = True,
                     *, device: str | torch.device = "cuda"):
    """Align ONE (Ta, D) vs (Tb, D) pair with its rows split over ``axis``.

    Every rank of the mesh calls it with the whole pair (arrays or tensors);
    Ta must divide by the axis' size. Returns (raw distance as a float, the
    codes (Ta, Tb) int8 on ``device``, or None with ``keep_dirs=False``),
    the same on every rank. Use :func:`backtrace_host` for the path."""
    n_dev = mesh.shape[axis]
    ta, tb = feat_a.shape[0], feat_b.shape[0]
    if ta % n_dev:
        raise ValueError(f"Ta={ta} not divisible by {n_dev} devices")
    R = ta // n_dev
    Cb = col_block or min(tb, 512)
    nb = -(-tb // Cb)
    tb_pad = nb * Cb
    rank = mesh.axis_index(axis)
    group = mesh.group(axis)
    a_loc = torch.as_tensor(feat_a[rank * R:(rank + 1) * R], device=device).float()
    b_all = torch.zeros((tb_pad, feat_b.shape[1]), dtype=torch.float32, device=a_loc.device)
    b_all[:tb] = torch.as_tensor(feat_b, device=a_loc.device)
    dev = a_loc.device
    if keep_dirs:
        C_loc = cost_strip(a_loc, b_all, tb)
        strip = torch.empty((R, tb_pad), dtype=torch.int8, device=dev)

    # the message to rank d+1: a tile's bottom row, then the corner of the
    # receiver's next block (BIG-padded to col_block + 4 floats: the kernel
    # reads its top row in 16-byte blocks)
    inbox = torch.full((Cb + 4,), BIG, dtype=torch.float32, device=dev)
    outbox = torch.full((Cb + 4,), BIG, dtype=torch.float32, device=dev)
    left = None                   # the right column of this rank's previous tile
    prev_last = torch.full((1,), BIG, dtype=torch.float32, device=dev)
    final = torch.zeros((1,), dtype=torch.float32, device=dev)
    for s in range(n_dev + nb - 1):
        b = s - rank
        if 0 <= b < nb:
            if keep_dirs:
                C_tile = C_loc[:, b * Cb:(b + 1) * Cb]
            else:
                C_tile = cost_strip(a_loc, b_all[b * Cb:(b + 1) * Cb], tb - b * Cb)
            top = inbox.clone() if rank > 0 else None
            corner = top[Cb:Cb + 1] if rank > 0 and b > 0 else None
            bottom, left, codes = dtw_tile(C_tile, top, corner, left,
                                           origin=rank == 0 and b == 0, codes=keep_dirs)
            if keep_dirs:
                strip[:, b * Cb:(b + 1) * Cb] = codes
            outbox[:Cb] = bottom
            outbox[Cb:Cb + 1] = prev_last
            prev_last = bottom[Cb - 1:Cb]
            if rank == n_dev - 1 and b == nb - 1:
                final = bottom[tb - 1 - b * Cb:tb - b * Cb].clone()
        # rank d sends what it just made; rank d+1 uses it in the next step
        sends = 0 <= b < nb and rank + 1 < n_dev
        recvs = rank > 0 and 0 <= b + 1 < nb
        if sends or recvs:
            send_recv(outbox if sends else None, rank + 1, inbox if recvs else None,
                      rank - 1, group)
    if group is not None:
        dist.all_reduce(final, op=dist.ReduceOp.SUM, group=group)
    distance = float(final[0])
    if not keep_dirs:
        return distance, None
    return distance, all_gather_cat(strip, group)[:, :tb]


def backtrace_host(dirs) -> tuple[np.ndarray, np.ndarray]:
    """Follow direction codes (0=diag, 1=up, 2=left) from the end to (0,0)."""
    dirs = dirs.cpu().numpy() if isinstance(dirs, torch.Tensor) else np.asarray(dirs)
    i, j = dirs.shape[0] - 1, dirs.shape[1] - 1
    pi, pj = [i], [j]
    while i > 0 or j > 0:
        c = dirs[i, j]
        if c == 0:
            i, j = i - 1, j - 1
        elif c == 1:
            i -= 1
        else:
            j -= 1
        pi.append(i)
        pj.append(j)
    return np.asarray(pi[::-1]), np.asarray(pj[::-1])
