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

# the kernel keeps a tile of 6 frames' spectra (bins × 6 complex) or signal
# ((6 − 1)·hop + n_fft floats) in one block's shared memory (EVC_GL_TF)
_TILE_FRAMES = 6


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


def supports(n_frames: int, n_fft: int, hop: int) -> bool:
    """Whether the fused kernel takes this shape: hop divides n_fft (the
    JAX kernel's chunked layout needs it), and a tile's spectra and signal
    fit one block's shared memory."""
    if n_frames < 1 or hop <= 0 or n_fft % hop != 0:
        return False
    bins = n_fft // 2 + 1
    smem = max(8 * bins * _TILE_FRAMES, 4 * ((_TILE_FRAMES - 1) * hop + n_fft))
    return smem <= SMEM_LIMIT_BYTES


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


def _lib():
    return load_library("griffin_lim_fused")


def gl_fused_plan(n_frames: int, n_fft: int, hop: int) -> dict:
    """The kernel's launch plan on the current card: grid blocks, the
    co-resident block count, and dynamic shared memory in bytes."""
    lib = _lib()
    fn = lib.evc_gl_fused_plan
    fn.restype = ctypes.c_int
    ci, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ci, ci, ci, ci, pi, pi, pi]
    grid, resident, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(fn(n_frames, n_fft // 2 + 1, n_fft, hop, ctypes.byref(grid), ctypes.byref(resident),
             ctypes.byref(smem)), "evc_gl_fused_plan", lib)
    return {"grid": grid.value, "resident": resident.value, "smem_bytes": smem.value}


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


def gl_angles_fused(magnitude: torch.Tensor, angles0: torch.Tensor, n_fft: int, hop: int,
                    n_iter: int, momentum: float, window: str = "hann",
                    _grid_blocks: int = 0) -> torch.Tensor:
    """Complex (F, bins) magnitude (clamped at 0) + initial unit phases →
    final unit phases after ``n_iter`` fused fast-GL iterations; on CUDA one
    cooperative launch of ``evc_gl_fused`` (counted in
    ``gl_angles_fused.launches``). Raises ValueError where hop does not
    divide n_fft. ``_grid_blocks`` overrides the grid (a grid larger than
    the co-resident block count raises instead of deadlocking)."""
    if magnitude.device.type == "cpu":
        return gl_angles_fused_plain(magnitude, angles0, n_fft, hop, n_iter, momentum,
                                     window)
    if magnitude.device.type != "cuda":
        raise ValueError(f"gl_angles_fused: unsupported device {magnitude.device}")
    _check_args(magnitude, angles0, n_fft, hop)
    dev = magnitude.device
    F, bins = magnitude.shape
    mag = torch.clamp(magnitude.float(), min=0.0).contiguous()
    # the kernel's phase state, updated in place
    are = angles0.real.float().clone(memory_format=torch.contiguous_format)
    aim = angles0.imag.float().clone(memory_format=torch.contiguous_format)
    pre = torch.empty_like(are)
    pim = torch.empty_like(aim)
    frames = torch.empty((2, F, n_fft), dtype=torch.float32, device=dev)
    bsr, bsi, bar, bai, inv_w = _consts(F, n_fft, hop, window, dev)
    mom = float(momentum) / (1.0 + float(momentum))
    lib = _lib()
    fn = lib.evc_gl_fused
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 11 + [ci] * 5 + [ctypes.c_float, ci, vp]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(fn(mag.data_ptr(), are.data_ptr(), aim.data_ptr(), pre.data_ptr(),
                 pim.data_ptr(), frames.data_ptr(), bsr.data_ptr(), bsi.data_ptr(),
                 bar.data_ptr(), bai.data_ptr(), inv_w.data_ptr(), F, bins, n_fft, hop,
                 int(n_iter), mom, int(_grid_blocks), stream), "evc_gl_fused", lib)
    gl_angles_fused.launches += 1
    return torch.complex(are, aim)


gl_angles_fused.launches = 0
