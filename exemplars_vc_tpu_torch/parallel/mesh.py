"""The (data × dict) rank grid and the placement of tensors on it (port of
``exemplars_vc_tpu/parallel/mesh.py``).

Two parallel axes, as in the JAX package:

- ``data``: utterance-batch data parallelism (DTW pairs, warping-net
  minibatches, the rows of the sequence-parallel DTW);
- ``dict``: the exemplar dictionary's K axis, split over ranks, with one
  all-reduce of the (F, D) reconstruction an MU iteration (``sharded_nmf``).

A :class:`Mesh` is an explicit grid of the world's ranks, one device a rank,
with a process group for each line along each axis. Without a process group
the world is this one process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DICT_AXIS = "dict"
AXES = (DATA_AXIS, DICT_AXIS)

# a line's process group by (its ranks, the world's size): make_mesh is
# called by every rank in the same order, so every rank finds the same groups
# here, and a repeated mesh creates no new communicator
_GROUPS: dict = {}


class Mesh:
    """A (data, dict) grid of global ranks.

    ``shape[axis]`` is the axis' size, ``devices`` the rank grid (the JAX
    mesh's device array), :meth:`coordinate` this process's place in it
    (None for a rank outside the grid), :meth:`group` the process group of
    this process's line along an axis (None for an axis of one rank, which
    needs no collective)."""

    def __init__(self, ranks: np.ndarray, groups: dict):
        self.devices = ranks
        self.axis_names = AXES
        self.shape = dict(zip(AXES, ranks.shape))
        self._groups = groups
        self._device_mesh = None

    def coordinate(self) -> tuple[int, int] | None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        hit = np.argwhere(self.devices == rank)
        return (int(hit[0, 0]), int(hit[0, 1])) if len(hit) else None

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        """This process's index along ``axis`` (its rank in that line)."""
        coord = self.coordinate()
        if coord is None:
            raise ValueError("this rank is outside the mesh")
        return coord[AXES.index(axis)]

    def device_mesh(self, device_type: str):
        """torch's ``DeviceMesh`` over the same grid (built once, by every
        rank of the world: its construction is collective)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(device_type, torch.as_tensor(self.devices),
                                           mesh_dim_names=AXES)
        return self._device_mesh


def _line_groups(ranks: np.ndarray) -> dict:
    """The process group of this rank's line along each axis of more than
    one rank. ``new_group`` is collective over the world, so every rank
    creates every line's group, in one order."""
    if not dist.is_initialized():
        return {}
    me = dist.get_rank()
    world = dist.get_world_size()
    out = {}
    for a, axis in enumerate(AXES):
        if ranks.shape[a] == 1:
            continue
        lines = ranks if a == 1 else ranks.T
        for line in lines:
            key = (tuple(int(r) for r in line), world)
            g = _GROUPS.get(key)
            if g is None:
                g = (dist.group.WORLD if sorted(key[0]) == list(range(world))
                     else dist.new_group([int(r) for r in line]))
                _GROUPS[key] = g
            if me in line:
                out[axis] = g
    return out


def make_mesh(data: int | None = None, dict_: int | None = None,
              ranks: list | None = None) -> Mesh:
    """Build a (data × dict) mesh of ``ranks`` (default: every rank of the
    world; one without a process group). Defaults: all ranks on ``data``.
    Every rank of the world calls it, in the same order, with the same
    arguments (it may create process groups)."""
    if ranks is None:
        ranks = list(range(dist.get_world_size() if dist.is_initialized() else 1))
    n = len(ranks)
    if data is None and dict_ is None:
        data, dict_ = n, 1
    elif data is None:
        data = n // dict_
    elif dict_ is None:
        dict_ = n // data
    if data < 1 or dict_ < 1:
        raise ValueError(
            f"mesh {data}x{dict_} has a zero-sized axis "
            f"(an axis larger than the {n} available devices floor-divides "
            f"the other axis to 0)")
    if data * dict_ > n:
        raise ValueError(f"mesh {data}x{dict_} > {n} devices")
    # non-divisible configs intentionally use the first data·dict_ ranks
    grid = np.asarray(ranks[: data * dict_], dtype=np.int64).reshape(data, dict_)
    return Mesh(grid, _line_groups(grid))


def _placed(x, mesh: Mesh, placements, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device)
    if not dist.is_initialized():
        return x      # a world of one process: nothing to distribute
    from torch.distributed.tensor import distribute_tensor

    # every rank holds x (as the JAX package's device_put from the host), so
    # each takes its own shard locally: no data leaves a rank
    return distribute_tensor(x, mesh.device_mesh(x.device.type), placements,
                             src_data_rank=None)


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS, *, device: str | torch.device = "cuda"):
    """Place ``x`` with its leading dimension sharded over ``axis`` and
    replicated over the other: a DTensor with ``Shard(0)`` on ``axis``
    (the plain tensor on ``device`` in a world of one process)."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Shard(0) if a == axis else Replicate() for a in AXES]
    return _placed(x, mesh, placements, device)


def replicate(x, mesh: Mesh, *, device: str | torch.device = "cuda"):
    """Place ``x`` whole on every rank of the mesh (``Replicate()``)."""
    from torch.distributed.tensor import Replicate

    return _placed(x, mesh, [Replicate(), Replicate()], device)
