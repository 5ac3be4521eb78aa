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
``nmf_activations_pallas(fused=True)``); the error check reuses the recon
output. KL stays plain torch (the JAX package has no kernel for it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from exemplars_vc_tpu_torch.factorize.nmf_cuda import EPS, nmf_mu_fused, nmf_recon, nmf_update


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


def nmf_activations(X: torch.Tensor, A: torch.Tensor, beta_loss: str = "frobenius",
                    tol: float = 1e-4, max_iter: int = 150, check_every: int = 10,
                    l1: float = 0.0, fused: bool = False) -> NmfState:
    """Solve for H ≥ 0 with X ≈ H·A, A fixed (float32 throughout).

    The tol test reads one scalar back every ``check_every`` iterations.
    ``fused=True`` (Frobenius only) runs each iteration as one
    ``nmf_mu_fused`` call; the error check still goes through ``nmf_recon``."""
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
        else:
            def step(H):
                return nmf_update(nmf_recon(H, A), A, H, Num, l1, out=H)

        def error(H):
            return _frob_error(X, nmf_recon(H, A))
    elif beta_loss in ("kullback-leibler", "kl"):
        if fused:
            raise ValueError("fused=True needs beta_loss='frobenius' "
                             "(the JAX package has no fused KL kernel)")
        den = A.sum(dim=1)[None, :] + l1
        den = torch.where(den == 0.0, EPS, den)

        def step(H):
            ratio = X / torch.clamp(H @ A, min=EPS)
            return H * ((ratio @ A.T) / den)

        def error(H):
            return _kl_error(X, H @ A)
    else:
        raise ValueError(f"unknown beta_loss {beta_loss!r}")

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
    return NmfState(H, n_iter, err)


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
