"""Exemplar dictionaries gathered along DTW paths (port of
``exemplars_vc_tpu/align/exemplar.py``)."""

from __future__ import annotations

import torch


def gather_aligned(feat: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """(..., T, D) features + (..., P) path indices (−1 padded) → (..., P, D).

    Padded entries return row 0; mask with ``path >= 0`` downstream."""
    idx = path.long().clamp(0, feat.shape[-2] - 1)
    return torch.take_along_dim(feat, idx[..., None], dim=-2)


# (N, T, D) + (N, P) → (N, P, D): the JAX package's batched name for the same gather
gather_aligned_batch = gather_aligned


def build_exemplar_dicts_padded(feats_a: torch.Tensor, feats_b: torch.Tensor,
                                path_i: torch.Tensor, path_j: torch.Tensor,
                                k_pad: int | None = None):
    """(N, T, D) features + (N, P) paths → (K_pad, D) dictionaries A, B.

    Rows at padded path positions are exact zeros, which keeps them inert in
    the MU solve (their numerator column X·Aᵀ is 0). With ``k_pad`` the
    valid rows come first in their original order (stable sort) and the
    buffer is cut to ``k_pad`` rows."""
    valid = (path_i >= 0)[..., None]
    A = torch.where(valid, gather_aligned(feats_a, path_i), 0.0)
    B = torch.where(valid, gather_aligned(feats_b, path_j), 0.0)
    D = A.shape[-1]
    A = A.reshape(-1, D).float()
    B = B.reshape(-1, D).float()
    if k_pad is not None and k_pad < A.shape[0]:
        order = torch.argsort(torch.where(valid.reshape(-1), 0, 1), stable=True)[:k_pad]
        A, B = A[order], B[order]
    return A, B


def alignment_keep_mask(feats_a: torch.Tensor, feats_b: torch.Tensor, path_i: torch.Tensor,
                        path_j: torch.Tensor, k_pad: int, k_true: int,
                        prune_frac: float) -> torch.Tensor:
    """(k_pad,) bool mask that keeps the best-aligned (1 − prune_frac) of the
    ``k_true`` exemplar pairs (``data.dict_prune_frac``).

    A pair's rank is its alignment cost ‖feat_a[path_i] − feat_b[path_j]‖²
    over the alignment features, the cost the DTW minimised; the rows are
    packed as :func:`build_exemplar_dicts_padded` packs them, so the mask
    applies row-wise to every gathered dictionary. The threshold is the
    sorted cost at index min(max(int((1 − prune_frac)·k_true), 1), k_pad − 1),
    with the padding rows sorted last at +inf."""
    Am, Bm = build_exemplar_dicts_padded(feats_a, feats_b, path_i, path_j, k_pad=k_pad)
    cost = torch.sum((Am - Bm) ** 2, dim=1)
    valid = torch.arange(cost.shape[0], device=cost.device) < k_true
    ranked = torch.sort(torch.where(valid, cost, torch.inf)).values
    idx = min(max(int((1.0 - prune_frac) * k_true), 1), k_pad - 1)
    return valid & (cost <= ranked[idx])


def apply_keep_mask(M: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the rows of (K, D) ``M`` where ``keep`` is False."""
    return M * keep[:, None].to(M.dtype)


def build_exemplar_dicts(feats_a, feats_b, path_i, path_j, path_lens):
    """(N, T, D) padded features + (N, P) DTW paths (−1 padded) + (N,) path
    lengths → the ragged dictionaries (A, B), each (K, D) with K = Σ
    path_lens: pair n's first ``path_lens[n]`` aligned rows, pair after
    pair, as the reference list-extends them (``04_align_n_nmf.py:230-246``).

    Takes tensors or numpy arrays and returns tensors on ``feats_a``'s
    device in its dtype; the rows are those that
    :func:`build_exemplar_dicts_padded` keeps first, bit for bit."""
    fa = torch.as_tensor(feats_a)
    dev = fa.device
    fb = torch.as_tensor(feats_b, device=dev)
    pi = torch.as_tensor(path_i, device=dev).long()
    pj = torch.as_tensor(path_j, device=dev).long()
    lens = torch.as_tensor(path_lens, device=dev).long()
    n, p = pi.shape
    take = torch.arange(p, device=dev)[None, :] < lens[:, None]
    pair = torch.arange(n, device=dev)[:, None].expand(n, p)[take]
    return fa[pair, pi[take]], fb[pair, pj[take]]
