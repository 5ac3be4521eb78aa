"""Least-squares activation variants: a QR solve and a FISTA NNLS (port of
``exemplars_vc_tpu/factorize/qrmf.py``). Plain torch; the JAX package has no
kernel for either.

- :func:`qr_activations`: unconstrained least squares X ≈ H·A through a QR
  decomposition (exact minimiser, may be negative).
- :func:`nnls_activations`: H ≥ 0 by accelerated projected gradient with the
  step 1/L, L from a power iteration on the D × D Gram.
"""

from __future__ import annotations

import math

import torch


def qr_activations(X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Minimise ‖X − H·A‖_F over unconstrained H (F, K).

    K ≤ D: Aᵀ = Q·R, H = (R⁻¹·Qᵀ·Xᵀ)ᵀ. K > D (underdetermined): A = Q·R with
    Q (K, D); G = X·R⁻¹ and the minimum-norm H = G·Qᵀ."""
    K, D = A.shape
    if K <= D:
        Q, R = torch.linalg.qr(A.T)                      # (D, K), (K, K)
        return torch.linalg.solve_triangular(R, Q.T @ X.T, upper=True).T
    Q, R = torch.linalg.qr(A)                            # (K, D), (D, D)
    G = torch.linalg.solve_triangular(R.T, X.T, upper=False).T
    return G @ Q.T


def nnls_activations(X: torch.Tensor, A: torch.Tensor, n_iter: int = 200) -> torch.Tensor:
    """H ≥ 0 minimising ‖X − H·A‖_F by FISTA, ``n_iter`` steps from H = 0.

    The Lipschitz constant of the gradient (H·A − X)·Aᵀ is σ_max(AᵀA): 30
    power iterations on the D × D Gram give a Rayleigh quotient, a lower
    bound, which a 5 % margin keeps inside the convergent range."""
    D = X.shape[1]
    G = A.T @ A
    v = torch.full((D,), 1.0 / math.sqrt(D), dtype=X.dtype, device=X.device)
    for _ in range(30):
        v = G @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    L = 1.05 * torch.clamp(v @ (G @ v), min=1e-12)

    XAt = X @ A.T
    H = torch.zeros((X.shape[0], A.shape[0]), dtype=X.dtype, device=X.device)
    Y, t = H, 1.0
    for _ in range(n_iter):
        grad = (Y @ A) @ A.T - XAt
        H_new = torch.clamp(Y - grad / L, min=0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        Y = H_new + ((t - 1.0) / t_new) * (H_new - H)
        H, t = H_new, t_new
    return H
