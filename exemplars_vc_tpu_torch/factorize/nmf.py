"""Fixed-dictionary NMF by multiplicative updates (port of
``exemplars_vc_tpu/factorize/nmf.py``).

Given features X (F, D) and a fixed exemplar dictionary A (K, D), find
activations H ≥ 0 (F, K) with X ≈ H·A, as sklearn's
``non_negative_factorization(..., init='custom', update_H=False,
solver='mu')`` does:

    H ← H ⊙ (X·Aᵀ) / ((H·A)·Aᵀ + λ)       [Frobenius]
    H ← H ⊙ ((X ⊘ H·A)·Aᵀ) / (1·Aᵀ + λ)   [KL]

H0 = sqrt(max(mean(X), 0) / K) with K the dictionary's (padded) row count;
a zero denominator becomes EPS; the error is checked every ``check_every``
iterations and the solve stops when (prev − err) < tol·err_init. The
Frobenius update runs through :mod:`exemplars_vc_tpu_torch.factorize.nmf_cuda`
(the recon and update kernels on the card, their twins on the CPU; with
``fused=True`` one ``nmf_mu_fused`` launch per iteration, the counterpart of
``nmf_activations_pallas(fused=True)``). The error check's recon is carried
into the next update: H does not change between a check and the step after
it, and the recon kernel sums in one order, so that P has the same bits. A
solve therefore takes 1 + n_iter recons. The KL solve takes its P from the
same recon, carried the same way, forms R = X ⊘ max(P, EPS) in torch and
updates H in place by ``nmf_kl_update`` (on the card one kernel for R·Aᵀ,
the division and the product; on the CPU its twin, ``torch.mm`` then the
division and the product). The
``work_dtype`` solve, which stores H, A and the numerator in bfloat16 and
accumulates products in float32, is plain torch (in the JAX package it is
XLA outside any Pallas kernel).

:func:`prune_topk_refine` and :func:`sharpen_activations` are the two
shape-preserving refinements of a solved H.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from exemplars_vc_tpu_torch.factorize.nmf_cuda import (EPS, nmf_kl_operand, nmf_kl_update,
                                                       nmf_mu_fused, nmf_recon, nmf_update)


class NmfState(NamedTuple):
    H: torch.Tensor        # (F, K) activations
    n_iter: int            # iterations actually run
    error: torch.Tensor    # final error (Frobenius norm, or sqrt(2·D_KL))


def _frob_error(X: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    R = X - P
    return torch.sqrt(torch.sum(R * R))


def _kl_error(X: torch.Tensor, WH: torch.Tensor) -> torch.Tensor:
    # sklearn's reported KL error: sqrt(2·D_KL(X ‖ HA)), HA clipped at f32 eps
    Yh = torch.clamp(WH, min=1.1920929e-07)
    div = (torch.sum(torch.where(X > 0, X * torch.log(torch.clamp(X, min=1e-30) / Yh), 0.0))
           - torch.sum(X) + torch.sum(Yh))
    return torch.sqrt(torch.clamp(2.0 * div, min=0.0))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b accumulated and returned in float32, whatever a and b are stored in."""
    return a.float() @ b.float()


def _dot_stored(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b accumulated in float32 and rounded once to the operands' storage
    dtype. On the card the bfloat16 matmul does exactly that and reads the
    operands as stored; on the CPU the product is made in float32."""
    if a.is_cuda:
        return a @ b
    return _dot(a, b).to(a.dtype)


def _nmf_activations_stored(X: torch.Tensor, A: torch.Tensor, beta_loss: str, tol: float,
                            max_iter: int, check_every: int, l1: float,
                            dtype: torch.dtype) -> NmfState:
    """The MU solve with X, A, H and the numerator stored in ``dtype``
    (bfloat16) and every product accumulated in float32: plain torch ops,
    no hand-written kernel. Within ~1 % of the float32 fixed point; not
    sklearn parity."""
    out_dtype = X.dtype
    F, K = X.shape[0], A.shape[0]
    X = X.to(dtype).contiguous()
    A = A.to(dtype).contiguous()
    At = A.T.contiguous()
    avg = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K)
    H = avg.to(dtype).expand(F, K).contiguous()
    Xf, A32, At32 = X.float(), A.float(), At.float()   # the rounded values, widened once

    if beta_loss == "frobenius":
        Num = _dot_stored(X, At)

        def step(H):
            den = _dot(_dot_stored(H, A), At32) + l1
            den = torch.where(den == 0.0, EPS, den)
            return (H.float() * (Num.float() / den)).to(dtype)

        def error(H):
            return _frob_error(Xf, _dot(H, A32))
    elif beta_loss in ("kullback-leibler", "kl"):
        den = A.sum(dim=1)[None, :].to(dtype) + l1
        den = torch.where(den == 0.0, EPS, den)

        def step(H):
            ratio = X / torch.clamp(_dot_stored(H, A), min=EPS)
            return H * (_dot_stored(ratio, At) / den)

        def error(H):
            return _kl_error(Xf, _dot(H, A32))
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")
    H, n_iter, err = _mu_loop(H, step, error, tol, max_iter, check_every)
    return NmfState(H.to(out_dtype), n_iter, err)


def _mu_loop(H, step, error, tol: float, max_iter: int, check_every: int):
    """sklearn's cadence: the error every ``check_every`` steps, stop when
    (prev − err) < tol·err_init; then the remainder of ``max_iter``."""
    err_init = error(H)
    prev = err_init
    err = err_init
    n_blocks = max_iter // check_every
    blocks = 0
    while blocks < n_blocks:
        for _ in range(check_every):
            H = step(H)
        err = error(H)
        blocks += 1
        if tol > 0 and bool((prev - err) < tol * err_init):
            break
        prev = err
    n_iter = blocks * check_every
    rem = max_iter - n_blocks * check_every
    if rem:
        for _ in range(rem):
            H = step(H)
        err = error(H)
        n_iter += rem
    return H, n_iter, err


def nmf_activations(X: torch.Tensor, A: torch.Tensor, beta_loss: str = "frobenius",
                    tol: float = 1e-4, max_iter: int = 150, check_every: int = 10,
                    l1: float = 0.0, fused: bool = False,
                    work_dtype: torch.dtype | None = None) -> NmfState:
    """Solve for H ≥ 0 with X ≈ H·A, A fixed.

    The tol test reads one scalar back every ``check_every`` iterations.
    ``fused=True`` (Frobenius only) runs each iteration as one
    ``nmf_mu_fused`` call; its error check goes through its own
    ``nmf_recon``. ``work_dtype=torch.bfloat16`` stores H, A and the
    numerator in bfloat16 with float32 accumulation (plain torch, no
    kernel) and returns H in X's dtype; the default is float32 throughout."""
    if work_dtype is not None and work_dtype != torch.float32:
        if fused:
            raise ValueError("fused=True is a float32 kernel; it takes no work_dtype")
        return _nmf_activations_stored(X, A, beta_loss, tol, max_iter, check_every, l1,
                                       work_dtype)
    X = X.float().contiguous()
    A = A.float().contiguous()
    F = X.shape[0]
    K = A.shape[0]
    avg = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K)
    H = avg.expand(F, K).contiguous()

    if beta_loss == "frobenius":
        Num = X @ A.T                               # loop-invariant numerator

        if fused:
            def step(H):
                return nmf_mu_fused(H, A, Num, l1, out=H)

            def error(H):
                return _frob_error(X, nmf_recon(H, A))
        else:
            checked = []      # the last check's P; H has not changed since

            def step(H):
                P = checked.pop() if checked else nmf_recon(H, A)
                return nmf_update(P, A, H, Num, l1, out=H)

            def error(H):
                checked[:] = [nmf_recon(H, A)]
                return _frob_error(X, checked[0])
    elif beta_loss in ("kullback-leibler", "kl"):
        if fused:
            raise ValueError("fused=True needs beta_loss='frobenius' "
                             "(the JAX package has no fused KL kernel)")
        den = A.sum(dim=1)[None, :] + l1
        den = torch.where(den == 0.0, EPS, den)
        At = nmf_kl_operand(A)    # A as the update reads it, once a solve
        checked = []          # the last check's P; H has not changed since

        def step(H):
            # H ⊙ ((X ⊘ P)·Aᵀ ⊘ den) in that order, in place
            P = checked.pop() if checked else nmf_recon(H, A)
            return nmf_kl_update(X / torch.clamp(P, min=EPS), At, H, den, out=H)

        def error(H):
            checked[:] = [nmf_recon(H, A)]
            return _kl_error(X, checked[0])
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")

    return NmfState(*_mu_loop(H, step, error, tol, max_iter, check_every))


def prune_topk_refine(X: torch.Tensor, A: torch.Tensor, H: torch.Tensor, k: int,
                      beta_loss: str = "frobenius", n_iter: int = 100) -> NmfState:
    """Re-solve each frame over only its ``k`` largest activations.

    Each frame keeps its top-k entries of H (ties go to the lower index),
    gathers its own (k, D)
    dictionary and runs ``n_iter`` unpenalised MU steps batched over frames,
    warm-started from the kept values; the result is scattered back into an
    (F, K) H with at most k non-zeros a row. The error is the solver's own
    metric for ``beta_loss`` (Frobenius norm, or sqrt(2·D_KL))."""
    F, K = X.shape[0], A.shape[0]
    k = min(k, K)
    # a stable sort, not torch.topk: a DTW path repeats frames, so A has
    # equal rows and H equal columns, and among equal activations the lower
    # index must win, as it does in the reference's top_k
    vals, idx = torch.sort(H, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]                 # (F, k)
    Af = A[idx].float()                                 # (F, k, D)
    h = vals.float()
    Xf = X.float()

    if beta_loss == "frobenius":
        num = torch.einsum("fd,fkd->fk", Xf, Af)        # loop-invariant

        def step(h):
            WH = torch.einsum("fk,fkd->fd", h, Af)
            den = torch.einsum("fd,fkd->fk", WH, Af)
            return h * num / torch.where(den == 0.0, EPS, den)
    elif beta_loss in ("kullback-leibler", "kl"):
        rs = Af.sum(dim=2)
        rs = torch.where(rs == 0.0, EPS, rs)

        def step(h):
            WH = torch.einsum("fk,fkd->fd", h, Af)
            ratio = Xf / torch.clamp(WH, min=EPS)
            return h * torch.einsum("fd,fkd->fk", ratio, Af) / rs
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")

    for _ in range(n_iter):
        h = step(h)
    Yh = torch.einsum("fk,fkd->fd", h, Af)
    err = _frob_error(Xf, Yh) if beta_loss == "frobenius" else _kl_error(Xf, Yh)
    Hs = torch.zeros((F, K), dtype=X.dtype, device=X.device)
    Hs.scatter_(1, idx, h.to(X.dtype))
    return NmfState(Hs, n_iter, err)


def sharpen_activations(H: torch.Tensor, A: torch.Tensor, X: torch.Tensor,
                        gamma: float) -> torch.Tensor:
    """H ← s ⊙ H^γ: the γ-power concentrates each frame on its dominant
    exemplars, and the per-frame least-squares gain s_f = ⟨X_f, X̂_f⟩ / ‖X̂_f‖²
    (X̂ = H^γ·A), clamped at 0, restores the fit."""
    Hs = torch.pow(H, gamma)
    Xh = _dot(Hs, A)
    s = (X * Xh).sum(dim=1) / torch.clamp((Xh * Xh).sum(dim=1), min=EPS)
    return torch.clamp(s, min=0.0)[:, None].to(H.dtype) * Hs


def residual_compensation(X: torch.Tensor, H: torch.Tensor, A: torch.Tensor,
                          mode: str = "correct") -> torch.Tensor:
    """Residual factor R (F, D) such that conversion multiplies H·B by R
    (``nmf.py:residual_compensation``; "reference" reproduces the
    reference's log(X̂ − X) quirk, NaNs included)."""
    Xhat = H @ A
    if mode == "correct":
        return X / torch.clamp(Xhat, min=EPS)
    if mode == "reference":
        diff = Xhat - X
        r = torch.where(diff > 0, torch.log(diff), 0.0)
        return torch.exp(torch.log(r))
    raise ValueError(f"unknown residual mode {mode!r}")


def convert_features(H: torch.Tensor, B: torch.Tensor,
                     R: torch.Tensor | None = None) -> torch.Tensor:
    """Converted features Y = (H·B) ⊙ R (R optional)."""
    Y = H @ B
    return Y if R is None else Y * R
