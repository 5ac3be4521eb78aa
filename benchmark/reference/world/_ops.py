"""Array operations the WORLD modules share, written to compute what their
JAX counterparts compute in float32.

- :func:`cumsum` sums in the order XLA's CPU backend does (a prefix scan in
  rows of 16, each row a sequential float32 sum, the row totals scanned the
  same way and added back), so a long float32 running sum (the synthesis
  phase over ~50k samples) rounds as in the reference. ``torch.cumsum``
  accumulates in float64 on the CPU and in another order on the card.
- :func:`interp` is ``jnp.interp`` (clamped ends), batched over rows.
- :func:`gather_last` indexes the last axis by an index tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SCAN_ROW = 16


def nuttall(n: int) -> np.ndarray:
    """The 4-term Nuttall window of the DIO/Harvest filter banks and the
    D4C band windows (float64)."""
    m = np.arange(n)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * m / (n - 1))
            + 0.144232 * np.cos(4 * np.pi * m / (n - 1))
            - 0.012604 * np.cos(6 * np.pi * m / (n - 1)))


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 running sum along the last axis, in XLA's CPU
    order (module docstring)."""
    n = x.shape[-1]
    if n <= _SCAN_ROW:
        return _row_scan(x)
    lead = x.shape[:-1]
    m = -(-n // _SCAN_ROW) * _SCAN_ROW
    rows = F.pad(x, (0, m - n)).reshape(*lead, m // _SCAN_ROW, _SCAN_ROW)
    within = _row_scan(rows)
    carry = cumsum(within[..., -1])
    before = F.pad(carry[..., :-1], (1, 0))
    return (within + before[..., None]).reshape(*lead, m)[..., :n]


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` with ``idx`` broadcast over x's leading axes."""
    idx = idx.long()
    if idx.dim() < x.dim():
        idx = idx.expand(*x.shape[:-1], idx.shape[-1])
    return torch.gather(x, -1, idx)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for each row of ``fp`` (..., P) on the
    shared sorted grid ``xp`` (P,), evaluated at ``x`` (Q,): linear inside,
    the end values outside."""
    P = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(1, P - 1)
    f_lo, f_hi = fp[..., i - 1], fp[..., i]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * (f_hi - f_lo))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def rfft_magsq(x: torch.Tensor, n: int) -> torch.Tensor:
    """|rfft(x, n)|² along the last axis (zero padded or cut to n)."""
    s = torch.fft.rfft(x, n=n)
    return s.real ** 2 + s.imag ** 2
