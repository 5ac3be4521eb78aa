"""Corpus-scale source separation: mixtures data-parallel over the mesh (port
of ``exemplars_vc_tpu/parallel/sharded_separate.py``).

A batch of mixture STFTs is split over the mesh's ``data`` axis; every rank
fits the multichannel NMF EM (``separate.multichannel``) to each mixture of
its shard in turn, with no communication (mixtures are independent: the
reference's process-pool fan-out, one process a rank). Each mixture's fit is
the single-mixture path itself, so a mixture separates to the same bits as
``fit_multichannel_nmf`` on the same inits and device. The collective ops
of the mesh's ``DTensor`` are not used for the EM: each rank works on its
local shard and the results are reassembled with ``DTensor.from_local``.
"""

from __future__ import annotations

import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh, shard_batch
from exemplars_vc_tpu_torch.separate.multichannel import (
    _em_loop,
    _wiener_images,
    random_spatial_init,
)


def batch_inits(key: torch.Tensor, M: int, J: int, F: int, K: int, N: int,
                C: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every mixture's inits, drawn on the CPU from ``split(key, 3)`` as the
    JAX package draws them: W (M, J, F, K) and H (M, J, K, N) squared
    normals, one draw each, and R (M, J, F, C, C), mixture m's from the
    m-th key of ``split(kr, M)`` (:func:`random_spatial_init`)."""
    kw, kh, kr = prng.split(key, 3)
    W = prng.normal(kw, (M, J, F, K)) ** 2
    H = prng.normal(kh, (M, J, K, N)) ** 2
    R = torch.stack([random_spatial_init(k, J, F, C, device="cpu")
                     for k in prng.split(kr, M)])
    return W, H, R


def _local(t):
    """This rank's shard of a placed tensor (the tensor itself in a world
    of one process)."""
    return t.to_local() if hasattr(t, "to_local") else t


def separate_batch(X, n_sources: int = 2, n_components: int = 4, n_em: int = 30,
                   n_nmf_inner: int = 1, key: torch.Tensor | None = None,
                   mesh: Mesh | None = None, device: str | torch.device = "cuda"):
    """Fit + separate a batch of mixture STFTs, split over the data axis.

    X: (M, F, N, C) complex mixture STFTs (pad ragged mixtures to a common
    frame count), the whole batch on every rank; M must divide by the
    ``data`` axis' size. The inits come from ``key`` (``PRNGKey(0)`` when
    None, :func:`batch_inits`; every rank draws the whole batch's). Returns
    (images (M, J, F, N, C) complex64, the per-mixture negative
    log-likelihood traces (M, n_em)): ``DTensor``s sharded as X over a
    process group, plain tensors on ``device`` without one."""
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(torch.complex64)
    M, F, N, C = X.shape
    if mesh is None:
        mesh = make_mesh()
    n_shards = mesh.shape[DATA_AXIS]
    if M % n_shards:
        raise ValueError(f"{M} mixtures not divisible by {n_shards} shards")
    W0, H0, R0 = batch_inits(prng.key_or_default(key), M, n_sources, F, n_components, N, C)
    Xs = shard_batch(X, mesh, device=dev)
    parts = [_local(shard_batch(a, mesh, device=dev)) for a in (W0, H0, R0)]
    images, nlls = [], []
    for x, w, h, r in zip(_local(Xs), *parts):
        model = _em_loop(x, w, h, r, n_em, n_nmf_inner)
        images.append(_wiener_images(x, model.W, model.H, model.R))
        nlls.append(model.neg_log_like)
    images, nlls = torch.stack(images), torch.stack(nlls)
    if not hasattr(Xs, "to_local"):
        return images, nlls
    from torch.distributed.tensor import DTensor

    placements = Xs.placements
    dmesh = mesh.device_mesh(dev.type)
    return (DTensor.from_local(images, dmesh, placements, run_check=False),
            DTensor.from_local(nlls, dmesh, placements, run_check=False))
