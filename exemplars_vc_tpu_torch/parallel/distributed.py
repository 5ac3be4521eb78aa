"""The process group of a multi-process run (port of
``exemplars_vc_tpu/parallel/distributed.py``).

One process a rank, ``torch.distributed`` for the group and explicit
collectives. The JAX package forms its group with
``jax.distributed.initialize``; here :func:`initialize_multihost` calls
``init_process_group`` with a TCP rendezvous (``coordinator_address``,
``num_processes``, ``process_id``) or, without them, torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

The backend follows the device: ``nccl`` when each rank of a host has a card
of its own, ``gloo`` on the CPU or when ranks share one card (NCCL refuses
two ranks on one device). It is a parameter, not a fallback: tensors stay on
the device the caller named, and :func:`send_recv` stages them through
pinned host memory only where the backend cannot move device memory itself.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from exemplars_vc_tpu_torch.device import resolve_device

_TIMEOUT = timedelta(seconds=300)


def default_backend(device: str | torch.device = "cuda", ranks_per_host: int = 1) -> str:
    """``nccl`` where each of the host's ``ranks_per_host`` ranks has a card
    of its own, else ``gloo`` (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         *, device: str | torch.device = "cuda",
                         backend: str | None = None) -> dict:
    """Idempotent process-group bootstrap.

    ``coordinator_address="host:port"`` with ``num_processes`` and
    ``process_id`` joins a TCP rendezvous; without it, ``MASTER_ADDR`` and
    ``WORLD_SIZE`` in the environment join torchrun's (``env://``); with
    neither, nothing is initialized and the summary reports one process. A
    group that exists already is kept. ``device`` is the device the rank
    computes on (a CUDA device without a card raises); ``backend`` defaults
    to :func:`default_backend` for it and the host's ranks
    (``LOCAL_WORLD_SIZE``, else the world's size); with ``nccl`` the rank
    binds the card of its place on the host (``LOCAL_RANK``, else its rank).

    Returns {process_index, process_count, local_devices, global_devices}:
    a rank drives one device, so a process has one and the world as many as
    it has ranks."""
    device = resolve_device(device)
    env_rendezvous = bool(os.environ.get("MASTER_ADDR")) and bool(os.environ.get("WORLD_SIZE"))
    if not dist.is_initialized() and (coordinator_address or env_rendezvous):
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError("coordinator_address needs num_processes and process_id")
            world, rank = int(num_processes), int(process_id)
            kw = dict(init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)
        else:
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
            kw = dict(init_method="env://")
        backend = backend or default_backend(device,
                                             int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend=backend, timeout=_TIMEOUT, **kw)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def world_size(group=None) -> int:
    """Ranks of ``group`` (default: the world); 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether point-to-point traffic of ``t`` goes through host memory:
    gloo sends and receives CPU tensors only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send_recv(send: torch.Tensor | None, dst: int | None, recv: torch.Tensor | None,
              src: int | None, group=None) -> None:
    """Send ``send`` to group rank ``dst`` and receive ``recv`` (in place)
    from group rank ``src``, either side optional; both posted before either
    waits, so a chain of ranks cannot deadlock. Device tensors pass through
    pinned host copies where the backend moves only host memory (gloo)."""
    ops = []
    staged_recv = None
    if send is not None:
        s = send
        if _host_staged(send, group):
            s = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
            s.copy_(send)
        ops.append(dist.P2POp(dist.isend, s.contiguous(), dist.get_global_rank(group, dst)
                              if group is not None else dst, group))
    if recv is not None:
        r = recv
        if _host_staged(recv, group):
            staged_recv = r = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        ops.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(group, src)
                              if group is not None else src, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged_recv is not None:
        recv.copy_(staged_recv)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along
    ``dim`` in rank order; ``t`` itself without a group."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
