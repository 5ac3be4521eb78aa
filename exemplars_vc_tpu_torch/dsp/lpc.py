"""LPC (Levinson-Durbin) and LSP conversion (port of
``exemplars_vc_tpu/dsp/lpc.py``).

The AMF frequency warping's analysis: hamming-windowed frames → LPC → line
spectral pairs. The autocorrelation is a batched ``torch.fft`` round trip,
the Levinson recursion a loop over the (small, static) order batched over
frames, and the LSP roots a sign-change scan on a fixed grid plus a
fixed-iteration bisection of the Chebyshev-transformed symmetric and
antisymmetric polynomials, batched over frames as well.

The recursion amplifies the autocorrelation's rounding by the condition
number of the frame's Toeplitz system, ~1e4 for a median speech frame: in
float32 (the JAX package's precision) the coefficients of such frames are up
to 1e-2 off the exact solution. And a float32 sign test on the LSP grid can
flip at a grid point next to a root, which moves the root's bracket by a
cell (π/1024). So both :func:`lpc` and :func:`lpc_to_lsp` compute in float64
and return their input's dtype.
"""

from __future__ import annotations

import math

import torch


def lpc(frames: torch.Tensor, order: int = 20) -> torch.Tensor:
    """Windowed frames (..., N) → LPC coefficients (..., order+1).

    SPTK's layout: ``[sqrt(residual_gain), a_1 … a_p]`` for the all-pole
    model H(z) = g / (1 + Σ a_k z^{-k}); computed in float64."""
    out_dtype = frames.dtype
    frames = frames.to(torch.float64)
    n = frames.shape[-1]
    n_fft = 1
    while n_fft < 2 * n:
        n_fft *= 2
    s = torch.fft.rfft(frames, n=n_fft)
    r = torch.fft.irfft(s.real ** 2 + s.imag ** 2, n=n_fft)[..., : order + 1]
    r0 = torch.clamp(r[..., :1], min=1e-12)
    r = r / r0                       # normalized autocorrelation; gain restored at the end

    a = torch.zeros(r.shape, dtype=frames.dtype, device=frames.device)
    a[..., 0] = 1.0
    err = torch.ones(r.shape[:-1], dtype=frames.dtype, device=frames.device)
    for m in range(1, order + 1):
        # acc = Σ_{i=1}^{m-1} a[i]·r[m-i]; a[i] += k·a[m-i] for i in 1..m-1
        acc = torch.sum(a[..., 1:m] * torch.flip(r[..., 1:m], (-1,)), dim=-1)
        k = -(r[..., m] + acc) / torch.clamp(err, min=1e-12)
        upd = a[..., 1:m] + k[..., None] * torch.flip(a[..., 1:m], (-1,))
        a = torch.cat([a[..., :1], upd, k[..., None], a[..., m + 1:]], dim=-1)
        err = err * (1.0 - k * k)
    gain = torch.sqrt(torch.clamp(err * r0[..., 0], min=1e-20))
    return torch.cat([gain[..., None], a[..., 1:]], dim=-1).to(out_dtype)


def _cheb_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_k coeffs[b, k]·T_k(x[b, j]) via T_k(cos θ) = cos kθ: (B, M), (B, J) → (B, J)."""
    theta = torch.arccos(torch.clamp(x, -1.0, 1.0))
    k = torch.arange(coeffs.shape[-1], dtype=x.dtype, device=x.device)
    return torch.sum(torch.cos(theta[..., None] * k) * coeffs[:, None, :], dim=-1)


def _deflate(c: torch.Tensor, root_sign: float) -> torch.Tensor:
    """Synthetic division of Σ c_k z^{-k} (B, L) by (1 − root_sign·z⁻¹) → (B, L−1)."""
    out, prev = [], torch.zeros_like(c[:, 0])
    for j in range(c.shape[1] - 1):
        prev = c[:, j] + root_sign * prev
        out.append(prev)
    return torch.stack(out, dim=1)


def _to_cheb(c: torch.Tensor) -> torch.Tensor:
    """Palindromic even-degree polynomial (B, 2m+1) → Chebyshev coefficients
    (B, m+1) of z^m·poly in x = cos ω."""
    m = (c.shape[1] - 1) // 2
    return torch.cat([c[:, m : m + 1], 2.0 * torch.flip(c[:, :m], (1,))], dim=1)


def _roots(cheb: torch.Tensor, x: torch.Tensor, m: int, n_bisect: int) -> torch.Tensor:
    """The first ``m`` sign changes of each row's Chebyshev series on the grid
    ``x`` (by position; fewer than m fill with the first unflipped
    brackets), each bisected ``n_bisect`` times → (B, m) angles."""
    vals = cheb @ torch.cos(torch.arccos(torch.clamp(x, -1.0, 1.0))[:, None]
                            * torch.arange(cheb.shape[1], dtype=x.dtype, device=x.device)).T
    flips = torch.signbit(vals[:, 1:]) != torch.signbit(vals[:, :-1])
    pos = torch.argsort((~flips).to(torch.uint8), dim=1, stable=True)[:, :m]
    pos = torch.sort(pos, dim=1).values
    lo, hi = x[pos], x[pos + 1]
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        same = torch.signbit(_cheb_eval(cheb, mid)) == torch.signbit(_cheb_eval(cheb, lo))
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    return torch.arccos(torch.clamp(0.5 * (lo + hi), -1.0, 1.0))


def lpc_to_lsp(a: torch.Tensor, n_grid: int = 1024, n_bisect: int = 30) -> torch.Tensor:
    """LPC (..., order+1) → LSP frequencies (..., order) in (0, π), ascending.

    The gain term a[..., 0] is ignored (treated as monic), as
    ``pysptk.lpc2lsp`` takes its input; computed in float64."""
    order = a.shape[-1] - 1
    if order % 2 != 0:
        raise NotImplementedError("lpc_to_lsp currently supports even LPC order")
    out_dtype, lead = a.dtype, a.shape[:-1]
    a = a.to(torch.float64)
    a1 = torch.cat([torch.ones_like(a[..., :1]), a[..., 1:]], dim=-1).reshape(-1, order + 1)
    # P(z) = A(z) + z^{-(p+1)}·A(z⁻¹) has degree p+1: A gets a trailing zero,
    # its reversal a leading one (one degree short loses the roots at z = ∓1)
    zero = torch.zeros_like(a1[:, :1])
    ext = torch.cat([a1, zero], dim=1)
    flip = torch.cat([zero, torch.flip(a1, (1,))], dim=1)
    p_d = _deflate(ext + flip, -1.0)   # P has a root at z = −1
    q_d = _deflate(ext - flip, 1.0)    # Q has a root at z = +1
    x = torch.cos(torch.linspace(1e-4, math.pi - 1e-4, n_grid, dtype=a.dtype,
                                 device=a.device))      # ω ascending
    m = order // 2
    lsp = torch.cat([_roots(_to_cheb(p_d), x, m, n_bisect),
                     _roots(_to_cheb(q_d), x, m, n_bisect)], dim=1)
    return torch.sort(lsp, dim=1).values.reshape(lead + (order,)).to(out_dtype)
