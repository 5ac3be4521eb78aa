"""Fused Griffin-Lim: all iterations in one CUDA launch, and its plain twin
(port of ``exemplars_vc_tpu/dsp/griffin_lim_pallas.py``).

``gl_angles_fused`` replaces the Pallas kernel ``gl_pallas_angles`` (entered
through ``gl_angles_fused``); the kernel is ``csrc/griffin_lim_fused.cu``. A
CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
``gl_angles_fused_plain``.

Each iteration is the fast-GL update over a consistency projection with
NOLA normalisation::

    rebuilt = project(mag ⊙ angles);  t = rebuilt − μ/(1+μ)·prev
    prev = rebuilt;  angles = t / max(|t|, 1e-16)

Two projections, by ``center``:

- ``center=False`` (``project_nocenter_reference``): frames re-taken from
  the overlap-add itself, the JAX package's ``gl_pallas_angles``. The state
  stays at F rows: the TPU kernel's F + r − 1 rows and circular rolls are a
  layout device, and its rows [:F] equal this acyclic projection.
- ``center=True`` (``project_center_reference``): ``stft(istft(s))[:F]`` of
  ``dsp/stft.py``, the overlap-add trimmed by n_fft/2 at both ends and
  reflect-padded back, so the first and last n_fft/2 samples mirror interior
  ones. This is the production's fixed point: ``dsp/griffin_lim.py`` sends
  every CUDA shape that :func:`fused_route` accepts here (the served and
  streamed syntheses), and the two projections differ at the r − 1 edge
  frames.

The twin keeps the reference's table products (the spec of an iteration);
the kernel computes the same projection with FFTs, a frame's real n_fft-point
transform as one complex M-point FFT (:func:`transform_len`). Its host-side
pieces are here: the radix schedule and twiddle table of its mixed-radix
Stockham FFT (:func:`fft_radices`, :func:`fft_tables`), the real-transform
twiddles and the windows with the inverse transform's 1/n folded in
(:func:`kernel_consts`), and the launch plan (:func:`gl_fused_plan`, pure
Python). The kernel computes its 1/window-sum itself, bit-equal to
:func:`_inv_wsum`, so a new F uploads nothing, and its frame buffer is one
scratch a device and stream, grown to the largest F seen.

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
_MAX_INDEX = 1 << 22     # signal samples the kernel indexes (EVC_GL_MAX_INDEX)


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


def _centered_fits(n_frames: int, n_fft: int, hop: int) -> bool:
    """Whether the centered signal, trimmed by n_fft//2 at both ends, is
    longer than the reflect pad that restores it (``F.pad`` refuses a pad as
    long as its input)."""
    return hop * (n_frames - 1) + n_fft - 2 * (n_fft // 2) > n_fft // 2


def _plan(n_frames: int, n_fft: int, hop: int, n_sms: int, center: bool) -> dict | str:
    """The launch plan of :func:`gl_fused_plan`, or why it refuses the shape."""
    if not supports(n_frames, n_fft, hop):
        return (f"n_frames={n_frames}, n_fft={n_fft}, hop={hop} not supported (hop must "
                f"divide n_fft)")
    if center and not _centered_fits(n_frames, n_fft, hop):
        return (f"{n_frames} frames of hop {hop} are too short for the centered projection's "
                f"reflect pad of {n_fft // 2}")
    tile = _cdiv(n_frames, max(n_sms, 1))
    smem = _smem_bytes(tile, n_fft, hop)
    if smem > SMEM_LIMIT_BYTES:
        return (f"{n_frames} frames need tiles of {tile} frames on {n_sms} SMs, {smem} B of "
                f"shared memory (limit {SMEM_LIMIT_BYTES})")
    if hop * n_frames + n_fft >= _MAX_INDEX:
        return f"{n_frames} frames of hop {hop} exceed the kernel's index range"
    m = transform_len(n_fft)
    radices = fft_radices(m)
    items = m // 2 + 1 if n_fft % 2 == 0 else n_fft // 2 + 1
    widest = max([items] + [m // R if R in (2, 3, 4, 5, 8) else m for R in radices])
    threads = min(GL_MAX_THREADS, max(64, 32 * _cdiv(tile * widest, 32)))
    return {"tile": tile, "grid": _cdiv(n_frames, tile), "threads": threads,
            "smem_bytes": smem, "radices": radices}


def fused_route(n_frames: int, n_fft: int, hop: int, n_iter: int, n_sms: int) -> bool:
    """Whether ``griffin_lim``'s ``n_iter`` iterations of an (n_frames,
    n_fft//2+1) magnitude on a card of ``n_sms`` SMs take the centered
    kernel: n_iter > 0, hop divides n_fft, the tile fits shared memory (up
    to 19 frames an SM at n_fft 400: 2,508 frames on 132 SMs) and the
    signal is long enough for the reflect pad (F ≥ 4 at n_fft 400, hop 80).
    Pure: the shape alone decides."""
    return n_iter > 0 and isinstance(_plan(n_frames, n_fft, hop, n_sms, True), dict)


def gl_fused_plan(n_frames: int, n_fft: int, hop: int, n_sms: int,
                  center: bool = False) -> dict:
    """The kernel's launch plan on a card of ``n_sms`` SMs.

    One CTA owns a tile of ``tile`` consecutive frames and keeps the tile's
    magnitudes and momentum state in shared memory for all iterations: the
    smallest tile that leaves at most one CTA an SM. Threads: one for each
    work item of the tile's widest step, a multiple of 32, at most 512 (the
    kernel's float64 butterflies need up to 128 registers): an FFT pass has
    M/R butterflies a frame (a direct DFT pass M outputs), the spectrum pass
    M/2 + 1 items a frame (n_fft odd: bins). Raises ValueError where the
    tile would not fit one block's shared memory (beyond 19 frames an SM
    at n_fft 400), or, with ``center``, where the signal is too short for
    the reflect pad. The plan does not depend on ``center``."""
    plan = _plan(n_frames, n_fft, hop, n_sms, center)
    if isinstance(plan, str):
        raise ValueError(f"gl_fused_plan: {plan}")
    return plan


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _center_index(n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """For each sample g of the centered projection's padded signal, the
    overlap-add sample it takes: g, or its reflection in the first or last
    sample kept by the trim of pad = n_fft//2 (the kernel's ``gl_source``)."""
    L, pad = n_fft + hop * (n_frames - 1), n_fft // 2
    g = np.arange(L)
    return np.where(g < pad, 2 * pad - g, np.where(g >= L - pad, 2 * (L - pad - 1) - g, g))


def _project(sre, sim, bsr, bsi, bar, bai, inv_w, n_fft: int, hop: int, center: bool = False):
    """The projection on re/im planes: windowed irDFT frames, overlap-add,
    × 1/window-sum, with ``center`` the trim and reflect pad as one gather,
    re-frame, windowed rDFT."""
    frames = sre @ bsr + sim @ bsi                       # (F, n_fft)
    y = overlap_add(frames, hop) * inv_w                 # (n_fft + hop·(F−1),)
    if center:
        y = y[torch.as_tensor(_center_index(frames.shape[0], n_fft, hop), device=y.device)]
    Y = y.unfold(0, n_fft, hop)                          # (F, n_fft)
    return Y @ bar, Y @ bai


def _project_reference(spec: torch.Tensor, n_fft: int, hop: int, window: str,
                       center: bool) -> torch.Tensor:
    F = spec.shape[0]
    bsr, bsi, bar, bai, inv_w = _consts(F, n_fft, hop, window, spec.device)
    rre, rim = _project(spec.real.float(), spec.imag.float(), bsr, bsi, bar, bai, inv_w,
                        n_fft, hop, center)
    return torch.complex(rre, rim)


def project_nocenter_reference(spec: torch.Tensor, n_fft: int, hop: int,
                               window: str = "hann") -> torch.Tensor:
    """Plain twin of the kernel's center=False consistency projection
    (complex (F, bins) in and out) — the spec of what each fused iteration
    computes."""
    return _project_reference(spec, n_fft, hop, window, False)


def project_center_reference(spec: torch.Tensor, n_fft: int, hop: int,
                             window: str = "hann") -> torch.Tensor:
    """Plain twin of the kernel's center=True projection, ``stft(istft(s))
    [:F]`` of ``dsp/stft.py`` (complex (F, bins) in and out); F must pass
    the reflect pad's length rule (F ≥ 4 at n_fft 400, hop 80)."""
    if not _centered_fits(spec.shape[0], n_fft, hop):
        raise ValueError(f"project_center_reference: {spec.shape[0]} frames of hop {hop} are "
                         f"too short for the reflect pad of {n_fft // 2}")
    return _project_reference(spec, n_fft, hop, window, True)


def _check_args(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int, hop: int,
                center: bool):
    F, bins = magnitude.shape
    if not supports(F, n_fft, hop):
        raise ValueError(f"gl_angles_fused: n_frames={F}, n_fft={n_fft}, hop={hop} not "
                         f"supported (hop must divide n_fft)")
    if center and not _centered_fits(F, n_fft, hop):
        raise ValueError(f"gl_angles_fused: {F} frames of hop {hop} are too short for the "
                         f"centered projection's reflect pad of {n_fft // 2}")
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
                          hop: int, n_iter: int, momentum: float, window: str = "hann",
                          center: bool = False) -> torch.Tensor:
    """Plain twin of the fused kernel: n_iter projections (``center`` picks
    which, module docstring) plus momentum in torch over the same bases.
    Returns complex (F, bins) unit phases.

    It computes in float32, or in float64 when the magnitude is float64 (the
    accuracy reference the kernel and the float32 twin are both held to:
    the phase of a bin where |t| nearly cancels carries float32 rounding far
    above 1e-4 within a few iterations)."""
    _check_args(magnitude, angles0, n_fft, hop, center)
    dtype = torch.float64 if magnitude.dtype == torch.float64 else torch.float32
    mag = torch.clamp(magnitude.to(dtype), min=0.0)
    consts = [c.to(dtype) for c in _consts(mag.shape[0], n_fft, hop, window, mag.device)]
    mom = float(momentum) / (1.0 + float(momentum))
    are = angles0.real.to(dtype)
    aim = angles0.imag.to(dtype)
    pre = torch.zeros_like(are)
    pim = torch.zeros_like(aim)
    for _ in range(n_iter):
        rre, rim = _project(mag * are, mag * aim, *consts, n_fft, hop, center)
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


@lru_cache(maxsize=8)
def _device_consts(n_fft: int, window: str, device: torch.device) -> torch.Tensor:
    """The kernel's constant table on ``device`` (it depends on n_fft
    alone, not on F)."""
    return torch.as_tensor(kernel_consts(n_fft, window), device=device)


# The kernel's (2, F, n_fft) float64 frame buffer: 8.7 MB at F = 1361. A
# torch.empty for each new F can make the caching allocator call cudaMalloc
# (a 17 ms stall on a served request), so one buffer a (device, stream) is
# kept and grown to the largest F seen. Launches on one stream run in order,
# and the kernel writes every frame it reads within the iteration, so each
# launch may reuse what its predecessor left.
_frame_buffers: dict[tuple[int, int], torch.Tensor] = {}


def _frame_buffer(device: torch.device, stream: int, doubles: int) -> torch.Tensor:
    buf = _frame_buffers.get((device.index, stream))
    if buf is None or buf.numel() < doubles:
        buf = torch.empty(doubles, dtype=torch.float64, device=device)
        _frame_buffers[(device.index, stream)] = buf
    return buf


def gl_angles_fused(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int, hop: int,
                    n_iter: int, momentum: float, window: str = "hann",
                    _plan: dict | None = None, center: bool = False) -> torch.Tensor:
    """Complex (F, bins) magnitude (clamped at 0) + initial unit phases →
    final unit phases after ``n_iter`` fused fast-GL iterations over the
    ``center`` projection (module docstring); on CUDA one cooperative launch
    of ``evc_gl_fused`` with :func:`gl_fused_plan` (counted in
    ``gl_angles_fused.launches``). Raises ValueError where hop does not
    divide n_fft, or where a centered signal is too short for its reflect
    pad. ``_plan`` overrides the plan (another tile gives equal bits); the C
    entry refuses a plan the card cannot launch (a grid larger than the
    co-resident CTAs would deadlock) and the call raises."""
    if magnitude.device.type == "cpu":
        return gl_angles_fused_plain(magnitude, angles0, n_fft, hop, n_iter, momentum,
                                     window, center)
    if magnitude.device.type != "cuda":
        raise ValueError(f"gl_angles_fused: unsupported device {magnitude.device}")
    _check_args(magnitude, angles0, n_fft, hop, center)
    dev = magnitude.device
    F, bins = magnitude.shape
    plan = _plan or gl_fused_plan(F, n_fft, hop,
                                  torch.cuda.get_device_properties(dev).multi_processor_count,
                                  center)
    mag = torch.clamp(magnitude.float(), min=0.0).contiguous()
    ang0 = angles0.to(torch.complex64).contiguous()
    out = torch.empty_like(ang0)
    consts = _device_consts(n_fft, window, dev)
    radices = (ctypes.c_int * max(1, len(plan["radices"])))(*plan["radices"])
    mom = float(momentum) / (1.0 + float(momentum))
    lib = _lib()
    fn = lib.evc_gl_fused
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [ci] * 5 + [ctypes.POINTER(ctypes.c_int), ci, ci, ctypes.c_double,
                                         ci, vp]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        frames = _frame_buffer(dev, stream, 2 * F * n_fft)
        check(fn(mag.data_ptr(), ang0.data_ptr(), out.data_ptr(), frames.data_ptr(),
                 consts.data_ptr(), F, n_fft, hop, plan["tile"], plan["threads"], radices,
                 len(plan["radices"]), int(n_iter), mom, int(center), stream),
              "evc_gl_fused", lib)
    gl_angles_fused.launches += 1
    return out


gl_angles_fused.launches = 0
