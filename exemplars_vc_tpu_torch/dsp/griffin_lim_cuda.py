"""Fused Griffin-Lim: all iterations in one CUDA launch, and its plain twin
(port of ``exemplars_vc_tpu/dsp/griffin_lim_pallas.py``).

``gl_angles_fused`` replaces the Pallas kernel ``gl_pallas_angles`` (entered
through ``gl_angles_fused``); the kernel is ``csrc/griffin_lim_fused.cu``. A
CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
``gl_angles_fused_plain``.

Each iteration is the fast-GL update over a ``center=False`` consistency
projection with NOLA normalisation (``project_nocenter_reference``)::

    rebuilt = project(mag ⊙ angles);  t = rebuilt − μ/(1+μ)·prev
    prev = rebuilt;  angles = t / max(|t|, 1e-16)

It is a different fixed point from ``dsp/griffin_lim.py``'s centered,
reflect-padded projection at the r − 1 edge frames, so it stays opt-in, as
in the JAX package. The state stays at F rows: the TPU kernel's F + r − 1
rows and circular rolls are a layout device, and its rows [:F] equal this
acyclic projection.

The twin keeps the reference's table products (the spec of an iteration);
the kernel computes the same projection with FFTs, a frame's real n_fft-point
transform as one complex M-point FFT (:func:`transform_len`). Its host-side
pieces are here: the radix schedule and twiddle table of its mixed-radix
Stockham FFT (:func:`fft_radices`, :func:`fft_tables`), the real-transform
twiddles and the windows with the inverse transform's 1/n folded in
(:func:`kernel_consts`), and the launch plan (:func:`gl_fused_plan`, pure
Python).

The numpy table builders are copies of ``dsp/fft.py:_rdft_mats`` /
``_irdft_mats`` and ``griffin_lim_pallas.py:_gl_mats`` / ``_inv_wsum``
(without the 128-lane ``hop_pad`` and the reversed chunk order, both TPU
layout devices), because the JAX modules import jax. Their window is the
port's ``get_window``, which the STFT uses too.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from exemplars_vc_tpu_torch.dsp.stft import overlap_add
from exemplars_vc_tpu_torch.dsp.windows import get_window
from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES, check, load_library

GL_MAX_THREADS = 512     # threads a CTA (EVC_GL_MAX_THREADS)


@lru_cache(maxsize=32)
def _rdft_mats(n: int):
    t = np.arange(n)[:, None]
    k = np.arange(n // 2 + 1)[None, :]
    ang = -2.0 * np.pi * t * k / n
    return (
        np.cos(ang).astype(np.float32),       # (n, n//2+1)
        np.sin(ang).astype(np.float32),
    )


@lru_cache(maxsize=32)
def _irdft_mats(n: int):
    n_bins = n // 2 + 1
    k = np.arange(n_bins)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    w = np.full((n_bins, 1), 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cr = (w * np.cos(ang) / n).astype(np.float32)   # (n_bins, n) for Re
    ci = (-w * np.sin(ang) / n).astype(np.float32)  # (n_bins, n) for Im
    return cr, ci


def _window(window: str, n_fft: int) -> np.ndarray:
    return get_window(window, n_fft, periodic=True).numpy()


@lru_cache(maxsize=8)
def _gl_mats(n_fft: int, hop: int, window: str):
    """Chunked float32 bases, as the JAX builder lays them out:
    bsyn_re/bsyn_im (r, bins, hop) — irfft ∘ window, lane-chunked;
    bana_re/bana_im (r, hop, bins) — window ∘ rfft, row-chunked."""
    w = np.asarray(_window(window, n_fft), np.float32)
    CR, CI = _irdft_mats(n_fft)            # (bins, n_fft)
    C, S = _rdft_mats(n_fft)               # (n_fft, bins)
    r = n_fft // hop
    bins = n_fft // 2 + 1
    b_syn_re = (CR * w[None, :]).reshape(bins, r, hop).transpose(1, 0, 2)
    b_syn_im = (CI * w[None, :]).reshape(bins, r, hop).transpose(1, 0, 2)
    b_ana_re = (C * w[:, None]).reshape(r, hop, bins)
    b_ana_im = (S * w[:, None]).reshape(r, hop, bins)
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (b_syn_re, b_syn_im, b_ana_re, b_ana_im))


@lru_cache(maxsize=32)
def _inv_wsum(n_frames: int, n_fft: int, hop: int, window: str):
    """1 / window-sum in the (F+r−1, hop) chunked-signal layout (numpy)."""
    w = np.asarray(_window(window, n_fft), np.float64)
    r = n_fft // hop
    out_len = n_fft + hop * (n_frames - 1)
    wsum = np.zeros(out_len)
    for t in range(n_frames):
        wsum[t * hop : t * hop + n_fft] += w * w
    inv = 1.0 / np.maximum(wsum, 1e-8)
    return inv.reshape(n_frames + r - 1, hop).astype(np.float32)


def _flat_bases(n_fft: int, hop: int, window: str):
    """The chunked bases joined back (exact reshapes): Bsyn (bins, n_fft),
    Bana (n_fft, bins), re and im."""
    bsr, bsi, bar, bai = _gl_mats(n_fft, hop, window)
    r, bins, _ = bsr.shape
    return (bsr.transpose(1, 0, 2).reshape(bins, n_fft),
            bsi.transpose(1, 0, 2).reshape(bins, n_fft),
            bar.reshape(n_fft, bins), bai.reshape(n_fft, bins))


@lru_cache(maxsize=16)
def _consts(n_frames: int, n_fft: int, hop: int, window: str, device: torch.device):
    """(Bsyn_re, Bsyn_im, Bana_re, Bana_im, inv_w flat) on ``device``, built
    once per shape."""
    arrays = (*_flat_bases(n_fft, hop, window),
              _inv_wsum(n_frames, n_fft, hop, window).reshape(-1))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays)


# ---------------------------------------------------------------------------
# the kernel's FFT: radix schedule, twiddles, windows
# ---------------------------------------------------------------------------

def fft_radices(n: int) -> tuple[int, ...]:
    """Radix schedule of the kernel's n-point complex FFT, pass by pass:
    the odd prime factors ascending, then one 2 or 4, then 8s (2, 3, 4, 5
    and 8 have register butterflies; any other prime is a direct DFT pass).
    As many 8s as divide n: fewer passes are fewer shared-memory round
    trips. The widest radix goes last: a pass writes its butterfly's R
    outputs R·Ns apart, and the first pass (Ns = 1) of radix 8 put the 8
    threads of a quarter-warp's 16-byte stores on the same banks."""
    eights, small, odd = [], [], []
    while n % 8 == 0:
        eights.append(8)
        n //= 8
    if n % 2 == 0:
        small.append(n & -n)        # the 2 or 4 left
        n //= n & -n
    p = 3
    while n > 1:
        while n % p == 0:
            odd.append(p)
            n //= p
        p += 2
    return tuple(odd + small + eights)


@lru_cache(maxsize=32)
def fft_tables(n: int) -> np.ndarray:
    """The kernel's twiddle table, complex64, built in float64 and rounded
    once. Pass s of radix R, after the passes before it span Ns points
    (Ns = product of their radices), reads Ns·(R−1) twiddles at
    ``Σ Ns'·(R'−1)`` over the earlier passes: entry ``(r − 1)·Ns + k`` is
    exp(−2πi·k·r / (Ns·R)), 1 ≤ r < R, k < Ns (n − 1 entries in all; r
    major, so neighbouring butterflies read neighbouring entries). The R
    roots exp(−2πi·q / R) of each pass's R-point DFT follow, pass by
    pass."""
    tw, roots, ns = [], [], 1
    for R in fft_radices(n):
        r = np.arange(1, R)[:, None]
        k = np.arange(ns)[None, :]
        tw.append(np.exp(-2j * np.pi * k * r / (ns * R)).reshape(-1))
        roots.append(np.exp(-2j * np.pi * np.arange(R) / R))
        ns *= R
    return np.concatenate(tw + roots + [np.zeros(0)]).astype(np.complex64)


def transform_len(n_fft: int) -> int:
    """M, the length of the complex FFT that carries one frame's real
    n_fft-point transform: n_fft/2 (samples 2m and 2m + 1 as real and
    imaginary parts) where n_fft is even, else n_fft (a zero imaginary
    part)."""
    return n_fft if n_fft % 2 else n_fft // 2


@lru_cache(maxsize=8)
def kernel_consts(n_fft: int, window: str) -> np.ndarray:
    """What the kernel stages into shared memory once, as float32 (complex
    values re, im interleaved): the M-point FFT's twiddle table, the M + 1
    twiddles exp(−2πi·k/n_fft), k ≤ M, that split and join the packed real
    transform (n_fft even only), the synthesis window with the inverse
    transform's 1/n folded in (win/n) and the analysis window; all built in
    float64 and rounded once."""
    w = get_window(window, n_fft, periodic=True, dtype=torch.float64).numpy()
    m = transform_len(n_fft)
    rtw = np.exp(-2j * np.pi * np.arange(m + 1) / n_fft) if n_fft % 2 == 0 else np.zeros(0)
    return np.concatenate([fft_tables(m).view(np.float32), rtw.astype(np.complex64).view(
        np.float32), (w / n_fft).astype(np.float32), w.astype(np.float32)])


# ---------------------------------------------------------------------------
# launch plan (pure)
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(tile: int, n_fft: int, hop: int) -> int:
    """Dynamic shared memory of one CTA (EVC GlSmem): in float64, two FFT
    buffers of ``tile`` complex M-point transforms, the twiddle tables, the
    tile's momentum state (complex) and its signal segment; in float32, the
    tile's magnitudes, the two windows and the segment's 1/window-sum."""
    bins = n_fft // 2 + 1
    m = transform_len(n_fft)
    n_tw = len(fft_tables(m)) + (0 if n_fft % 2 else m + 1)
    seg = (tile - 1) * hop + n_fft
    return 16 * (2 * tile * m + n_tw + tile * bins) + 8 * seg + 4 * (tile * bins + 2 * n_fft
                                                                      + seg)


def supports(n_frames: int, n_fft: int, hop: int) -> bool:
    """Whether the fused kernel takes this shape: hop divides n_fft (the
    JAX kernel's chunked layout needs it; the kernel's frames overlap r =
    n_fft/hop times), and a tile of one frame fits one block's shared
    memory (n_fft up to 2048 at any such hop, more at wider hops)."""
    if n_frames < 1 or n_fft < 2 or hop <= 0 or n_fft % hop != 0:
        return False
    return _smem_bytes(1, n_fft, hop) <= SMEM_LIMIT_BYTES


def gl_fused_plan(n_frames: int, n_fft: int, hop: int, n_sms: int) -> dict:
    """The kernel's launch plan on a card of ``n_sms`` SMs.

    One CTA owns a tile of ``tile`` consecutive frames and keeps the tile's
    magnitudes and momentum state in shared memory for all iterations: the
    smallest tile that leaves at most one CTA an SM. Threads: one for each
    work item of the tile's widest step, a multiple of 32, at most 512 (the
    kernel's float64 butterflies need up to 128 registers): an FFT pass has
    M/R butterflies a frame (a direct DFT pass M outputs), the spectrum pass
    M/2 + 1 items a frame (n_fft odd: bins). Raises ValueError where the
    tile would not fit one block's shared memory (beyond ~18 frames an SM
    at n_fft 400)."""
    if not supports(n_frames, n_fft, hop):
        raise ValueError(f"gl_fused_plan: n_frames={n_frames}, n_fft={n_fft}, hop={hop} not "
                         f"supported (hop must divide n_fft)")
    tile = _cdiv(n_frames, max(n_sms, 1))
    smem = _smem_bytes(tile, n_fft, hop)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"gl_fused_plan: {n_frames} frames need tiles of {tile} frames on "
                         f"{n_sms} SMs, {smem} B of shared memory (limit {SMEM_LIMIT_BYTES})")
    m = transform_len(n_fft)
    radices = fft_radices(m)
    items = m // 2 + 1 if n_fft % 2 == 0 else n_fft // 2 + 1
    widest = max([items] + [m // R if R in (2, 3, 4, 5, 8) else m for R in radices])
    threads = min(GL_MAX_THREADS, max(64, 32 * _cdiv(tile * widest, 32)))
    return {"tile": tile, "grid": _cdiv(n_frames, tile), "threads": threads,
            "smem_bytes": smem, "radices": radices}


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _project(sre, sim, bsr, bsi, bar, bai, inv_w, n_fft: int, hop: int):
    """center=False projection on re/im planes: windowed irDFT frames,
    overlap-add, × 1/window-sum, re-frame, windowed rDFT."""
    frames = sre @ bsr + sim @ bsi                       # (F, n_fft)
    y = overlap_add(frames, hop) * inv_w                 # (n_fft + hop·(F−1),)
    Y = y.unfold(0, n_fft, hop)                          # (F, n_fft)
    return Y @ bar, Y @ bai


def project_nocenter_reference(spec: torch.Tensor, n_fft: int, hop: int,
                               window: str = "hann") -> torch.Tensor:
    """Plain twin of the kernel's center=False consistency projection
    (complex (F, bins) in and out) — the spec of what each fused iteration
    computes."""
    F = spec.shape[0]
    bsr, bsi, bar, bai, inv_w = _consts(F, n_fft, hop, window, spec.device)
    rre, rim = _project(spec.real.float(), spec.imag.float(), bsr, bsi, bar, bai, inv_w,
                        n_fft, hop)
    return torch.complex(rre, rim)


def _check_args(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int, hop: int):
    F, bins = magnitude.shape
    if not supports(F, n_fft, hop):
        raise ValueError(f"gl_angles_fused: n_frames={F}, n_fft={n_fft}, hop={hop} not "
                         f"supported (hop must divide n_fft)")
    if bins != n_fft // 2 + 1 or tuple(angles0.shape) != (F, bins):
        raise ValueError(f"gl_angles_fused: magnitude {tuple(magnitude.shape)} and angles0 "
                         f"{tuple(angles0.shape)} must both be (F, n_fft//2+1 = "
                         f"{n_fft // 2 + 1})")
    if not angles0.is_complex():
        raise ValueError(f"gl_angles_fused: angles0 must be complex, got {angles0.dtype}")
    if magnitude.is_complex() or angles0.device != magnitude.device:
        raise ValueError(f"gl_angles_fused: magnitude must be real and on {angles0.device}, "
                         f"got {magnitude.dtype} on {magnitude.device}")


def gl_angles_fused_plain(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int,
                          hop: int, n_iter: int, momentum: float,
                          window: str = "hann") -> torch.Tensor:
    """Plain twin of the fused kernel: n_iter projections plus momentum in
    torch over the same bases. Returns complex (F, bins) unit phases.

    It computes in float32, or in float64 when the magnitude is float64 (the
    accuracy reference the kernel and the float32 twin are both held to:
    the phase of a bin where |t| nearly cancels carries float32 rounding far
    above 1e-4 within a few iterations)."""
    _check_args(magnitude, angles0, n_fft, hop)
    dtype = torch.float64 if magnitude.dtype == torch.float64 else torch.float32
    mag = torch.clamp(magnitude.to(dtype), min=0.0)
    consts = [c.to(dtype) for c in _consts(mag.shape[0], n_fft, hop, window, mag.device)]
    mom = float(momentum) / (1.0 + float(momentum))
    are = angles0.real.to(dtype)
    aim = angles0.imag.to(dtype)
    pre = torch.zeros_like(are)
    pim = torch.zeros_like(aim)
    for _ in range(n_iter):
        rre, rim = _project(mag * are, mag * aim, *consts, n_fft, hop)
        tre = rre - mom * pre
        tim = rim - mom * pim
        pre, pim = rre, rim
        norm = torch.clamp(torch.sqrt(tre * tre + tim * tim), min=1e-16)
        are, aim = tre / norm, tim / norm
    return torch.complex(are, aim)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _lib():
    return load_library("griffin_lim_fused")


def gl_fused_resident(plan: dict, n_fft: int, hop: int) -> dict:
    """What the card makes of ``plan``: the CTAs of its shape that fit on
    the card at once (a cooperative launch needs the whole grid among them)
    and the dynamic shared memory the C side computes for it."""
    lib = _lib()
    fn = lib.evc_gl_fused_resident
    fn.restype = ctypes.c_int
    ci, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ci, ci, ci, ci, ci, pi, pi]
    resident, smem = ctypes.c_int(), ctypes.c_int()
    check(fn(plan["tile"], n_fft, hop, len(fft_tables(transform_len(n_fft))), plan["threads"],
             ctypes.byref(resident), ctypes.byref(smem)), "evc_gl_fused_resident", lib)
    return {"resident": resident.value, "smem_bytes": smem.value}


def grid_sync_probe(grid: int, n: int, device: torch.device) -> None:
    """Launch a cooperative kernel that does ``n`` grid-wide barriers over
    ``grid`` blocks and nothing else (the barrier-latency floor)."""
    lib = _lib()
    fn = lib.evc_grid_sync_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(grid, n, stream), "evc_grid_sync_probe", lib)


@lru_cache(maxsize=16)
def _device_consts(n_frames: int, n_fft: int, hop: int, window: str, device: torch.device):
    """The kernel's constant table and the flat 1/window-sum on ``device``."""
    return (torch.as_tensor(kernel_consts(n_fft, window), device=device),
            torch.as_tensor(_inv_wsum(n_frames, n_fft, hop, window).reshape(-1), device=device))


def gl_angles_fused(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int, hop: int,
                    n_iter: int, momentum: float, window: str = "hann",
                    _plan: dict | None = None) -> torch.Tensor:
    """Complex (F, bins) magnitude (clamped at 0) + initial unit phases →
    final unit phases after ``n_iter`` fused fast-GL iterations; on CUDA one
    cooperative launch of ``evc_gl_fused`` with :func:`gl_fused_plan`
    (counted in ``gl_angles_fused.launches``). Raises ValueError where hop
    does not divide n_fft. ``_plan`` overrides the plan (another tile gives
    equal bits); the C entry refuses a plan the card cannot launch (a grid
    larger than the co-resident CTAs would deadlock) and the call raises."""
    if magnitude.device.type == "cpu":
        return gl_angles_fused_plain(magnitude, angles0, n_fft, hop, n_iter, momentum,
                                     window)
    if magnitude.device.type != "cuda":
        raise ValueError(f"gl_angles_fused: unsupported device {magnitude.device}")
    _check_args(magnitude, angles0, n_fft, hop)
    dev = magnitude.device
    F, bins = magnitude.shape
    plan = _plan or gl_fused_plan(F, n_fft, hop,
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
    mag = torch.clamp(magnitude.float(), min=0.0).contiguous()
    ang0 = angles0.to(torch.complex64).contiguous()
    out = torch.empty_like(ang0)
    frames = torch.empty((2, F, n_fft), dtype=torch.float64, device=dev)
    consts, inv_w = _device_consts(F, n_fft, hop, window, dev)
    radices = (ctypes.c_int * max(1, len(plan["radices"])))(*plan["radices"])
    mom = float(momentum) / (1.0 + float(momentum))
    lib = _lib()
    fn = lib.evc_gl_fused
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] * 5 + [ctypes.POINTER(ctypes.c_int), ci, ci, ctypes.c_double,
                                         vp]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(fn(mag.data_ptr(), ang0.data_ptr(), out.data_ptr(), frames.data_ptr(),
                 consts.data_ptr(), inv_w.data_ptr(), F, n_fft, hop, plan["tile"],
                 plan["threads"], radices, len(plan["radices"]), int(n_iter), mom, stream),
              "evc_gl_fused", lib)
    gl_angles_fused.launches += 1
    return out


gl_angles_fused.launches = 0
