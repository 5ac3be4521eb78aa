"""Non-stationary Gabor transform (NSGT), matrix form, with exact inverse
(port of ``exemplars_vc_tpu/dsp/nsgt.py``; pyfasst ``tftransforms/nsgt/``:
nsgfwin window construction, nsgtf/nsigtf forward/inverse, nsdual dual
frames).

A painless constant-Q Gabor frame (Velasco et al. 2011): band centers at DC,
log-spaced f_k = fmin·2^(k/B) up to Nyquist, Nyquist, and mirrored negative
bands; each window is an asymmetric Hann reaching zero at the neighboring
centers, so the frame operator diagonal d(f) = Σ_k g_k(f)² is positive and
the canonical dual is g̃_k = g_k / d.

Matrix form: every band yields M coefficients, M a divisor of the padded
length L, so the modulation property holds. The forward transform is one
``torch.fft.fft`` of the signal, a gather of every band's support, a
windowing and one batched length-M inverse FFT; the inverse mirrors it with
the dual windows and a scatter-add (``index_add_``) into the spectrum. On a
card that scatter adds in atomic order, so its float32 sums differ from a
CPU run's in the last bits. The plan (windows, supports, duals) is host
numpy, cached per parameter set; it pads L to 256 × a 7-smooth number, as
the JAX package does for its matmul FFT, which fixes L and M and so the
output shape.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from exemplars_vc_tpu_torch.device import resolve_device


class NSGTPlan(NamedTuple):
    L: int            # padded signal/DFT length
    M: int            # time samples per band (divides L)
    n_bands: int      # total bands incl. DC, Nyquist, negative mirror
    n_pos: int        # positive-frequency log bands (excl. DC/Nyquist)
    idx: np.ndarray   # (n_bands, Lg) int32 DFT-bin index of each support tap
    win: np.ndarray   # (n_bands, Lg) float32 analysis window values (0 = pad)
    dual: np.ndarray  # (n_bands, Lg) float32 canonical dual window values
    pos: np.ndarray   # (n_bands, Lg) int32 position of each tap in the M-buffer
    perm: np.ndarray  # (n_bands, M) int32 roll permutation for the forward pack
    freqs: np.ndarray  # (n_bands,) band center frequencies in Hz


def nsgt_frequencies(sr: int, fmin: float, bins_per_octave: int = 12) -> np.ndarray:
    """Positive log-spaced band centers in Hz (excluding DC and Nyquist)."""
    n = int(np.floor(bins_per_octave * np.log2((sr / 2) / fmin)))
    f = fmin * 2.0 ** (np.arange(n + 1) / bins_per_octave)
    return f[f < sr / 2]


def _is_smooth(n: int) -> bool:
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=8)
def _plan(sr: int, Ls: int, fmin: float, bins_per_octave: int) -> NSGTPlan:
    # L = 256 × a 7-smooth number, as the JAX package pads for its matmul FFT
    m = -(-Ls // 256)
    while not _is_smooth(m):
        m += 1
    L = 256 * m
    fpos = nsgt_frequencies(sr, fmin, bins_per_octave)
    n_pos = len(fpos)
    if n_pos < 2:
        raise ValueError("nsgt: need at least 2 positive bands (raise sr/2/fmin)")
    # circular center list in DFT bins: DC, positives, Nyquist, mirrored negatives
    bpos = fpos * L / sr
    centers = np.concatenate([[0.0], bpos, [L / 2.0], L - bpos[::-1]])
    n_bands = len(centers)
    ext = np.concatenate([[centers[-1] - L], centers, [L + centers[0]]])
    lwid = centers - ext[:-2]    # distance to left neighbor (bins)
    rwid = ext[2:] - centers     # distance to right neighbor

    starts = np.floor(centers - lwid).astype(int) + 1
    stops = np.ceil(centers + rwid).astype(int) - 1   # inclusive
    lens = stops - starts + 1
    Lg = int(lens.max())

    idx = np.zeros((n_bands, Lg), np.int32)
    win = np.zeros((n_bands, Lg), np.float32)
    for k in range(n_bands):
        u = starts[k] + np.arange(lens[k])            # unwrapped bin positions
        rel = u - centers[k]
        g = np.where(
            rel <= 0,
            np.cos(0.5 * np.pi * np.clip(-rel / lwid[k], 0, 1)) ** 2,
            np.cos(0.5 * np.pi * np.clip(rel / rwid[k], 0, 1)) ** 2,
        )
        idx[k, : lens[k]] = np.mod(u, L)
        win[k, : lens[k]] = g

    # frame operator diagonal and canonical dual
    d = np.zeros(L, np.float64)
    np.add.at(d, idx.ravel(), (win.astype(np.float64) ** 2).ravel())
    if d.min() <= 1e-10:
        raise ValueError("nsgt: frame operator not invertible (coverage gap)")
    dual = (win / d[idx]).astype(np.float32)
    dual[win == 0] = 0.0

    # M: smallest divisor of L that fits the widest support (mod-M injective,
    # and M | L keeps the modulation property (u mod L) mod M == u mod M)
    M = next(m for m in sorted(
        {dv for i in range(1, int(np.sqrt(L)) + 1) if L % i == 0 for dv in (i, L // i)}
    ) if m >= Lg)

    p0 = np.mod(starts, M)
    j = np.arange(Lg)[None, :]
    pos = np.mod(p0[:, None] + j, M).astype(np.int32)
    q = np.arange(M)[None, :]
    perm = np.mod(q - p0[:, None], M).astype(np.int32)
    freqs = np.concatenate([[0.0], fpos, [sr / 2.0], -fpos[::-1] + 0.0])
    return NSGTPlan(L, int(M), n_bands, n_pos, idx, win, dual, pos, perm, freqs)


@lru_cache(maxsize=8)
def _plan_tensors(sr: int, Ls: int, fmin: float, bins_per_octave: int,
                  device: torch.device) -> tuple[NSGTPlan, dict]:
    """The plan and its index and window tables on ``device``, made once
    (read only)."""
    p = _plan(sr, Ls, fmin, bins_per_octave)
    tabs = {name: torch.as_tensor(getattr(p, name), device=device)
            for name in ("win", "dual")}
    for name in ("idx", "pos", "perm"):
        tabs[name] = torch.as_tensor(getattr(p, name).astype(np.int64), device=device)
    return p, tabs


def nsgt(x, sr: int = 16000, fmin: float = 65.40639132514966,   # C2
         bins_per_octave: int = 12, device: str | torch.device = "cuda") -> torch.Tensor:
    """NSGT coefficients of ``x`` (..., T) → complex64 (..., n_bands, M) on
    ``device``.

    Every band yields M coefficient frames (``nsgt_plan(sr, T, fmin,
    bins_per_octave).M``). Band order: DC, positive log bands, Nyquist,
    mirrored negative bands (``plan.freqs``)."""
    x = torch.as_tensor(x)
    if torch.is_complex(x):
        raise ValueError("nsgt expects a real signal (got complex input)")
    dev = resolve_device(device)
    x = x.to(dev, torch.float32)
    p, tabs = _plan_tensors(sr, x.shape[-1], float(fmin), bins_per_octave, dev)
    X = torch.fft.fft(x, n=p.L)
    v = X[..., tabs["idx"]] * tabs["win"]                        # (..., B, Lg)
    v = torch.nn.functional.pad(v, (0, p.M - v.shape[-1]))
    y = torch.gather(v, -1, tabs["perm"].expand(v.shape))
    return torch.fft.ifft(y)                                     # (..., B, M)


def insgt(c, length: int, sr: int = 16000, fmin: float = 65.40639132514966,
          bins_per_octave: int = 12, device: str | torch.device = "cuda") -> torch.Tensor:
    """Inverse NSGT: coefficients (..., n_bands, M) → real signal (...,
    length) on ``device``."""
    dev = resolve_device(device)
    p, tabs = _plan_tensors(sr, int(length), float(fmin), bins_per_octave, dev)
    c = torch.as_tensor(c, device=dev).to(torch.complex64)
    if tuple(c.shape[-2:]) != (p.n_bands, p.M):
        raise ValueError(
            f"insgt: coefficients {tuple(c.shape[-2:])} do not match the plan for "
            f"(sr={sr}, length={length}, fmin={fmin}, B={bins_per_octave}) — "
            f"expected {(p.n_bands, p.M)}")
    Y = torch.fft.fft(c)                                         # (..., B, M)
    lead = c.shape[:-2]
    pos = tabs["pos"].expand(Y.shape[:-1] + tabs["pos"].shape[-1:])
    v = torch.gather(Y, -1, pos) * tabs["dual"]                  # (..., B, Lg)
    flat = v.reshape((-1, v.shape[-2] * v.shape[-1]))
    idx = tabs["idx"].reshape(-1)
    Xr, Xi = (torch.zeros((flat.shape[0], p.L), device=dev).index_add_(1, idx, part)
              for part in (flat.real, flat.imag))
    x = torch.fft.ifft(torch.complex(Xr, Xi)).real
    return x[..., :length].reshape(lead + (length,))


def nsgt_plan(sr: int, length: int, fmin: float = 65.40639132514966,
              bins_per_octave: int = 12) -> NSGTPlan:
    """Expose the cached plan (band count, M, center frequencies)."""
    return _plan(sr, int(length), float(fmin), bins_per_octave)
