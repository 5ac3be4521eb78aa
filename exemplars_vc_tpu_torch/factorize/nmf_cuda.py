"""Frobenius MU kernels: CUDA wrappers and their plain-PyTorch twins.

``nmf_recon`` replaces ``exemplars_vc_tpu/factorize/nmf_pallas.py:_recon_kernel``,
``nmf_update`` replaces ``_update_kernel`` and ``nmf_mu_fused`` replaces
``_fused_mu_call`` (one MU iteration per launch); all are in ``csrc/nmf_mu.cu``.
A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
the twin.
"""

from __future__ import annotations

import ctypes

import torch

from exemplars_vc_tpu_torch.kernels.build import check, load_library

EPS = 2.220446049250313e-16  # np.finfo(float64).eps — sklearn's EPSILON


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _launch(fn_name: str, argtypes: list, *args) -> None:
    lib = load_library("nmf_mu")
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    check(fn(*args), fn_name, lib)


# ---------------------------------------------------------------------------
# P = H·A
# ---------------------------------------------------------------------------

def nmf_recon_plain(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """P (F, D) = H (F, K) · A (K, D)."""
    return H @ A


def nmf_recon(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Reconstruction P = H·A; on CUDA through ``evc_nmf_recon`` (counted in
    ``nmf_recon.launches``)."""
    if H.device.type == "cpu":
        return nmf_recon_plain(H, A)
    if H.device.type != "cuda":
        raise ValueError(f"nmf_recon: unsupported device {H.device}")
    F, K = H.shape
    D = A.shape[1]
    _check_f32("H", H, (F, K), H.device)
    _check_f32("A", A, (K, D), H.device)
    P = torch.empty((F, D), dtype=torch.float32, device=H.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_recon", [vp, vp, vp, ci, ci, ci, vp],
                H.data_ptr(), A.data_ptr(), P.data_ptr(), F, K, D, stream)
    nmf_recon.launches += 1
    return P


nmf_recon.launches = 0


# ---------------------------------------------------------------------------
# H ← H ⊙ Num / (P·Aᵀ + l1)
# ---------------------------------------------------------------------------

def nmf_update_plain(P: torch.Tensor, A: torch.Tensor, H: torch.Tensor,
                     Num: torch.Tensor, l1: float = 0.0) -> torch.Tensor:
    """H (F, K) ⊙ Num / den, den = P (F, D) · A (K, D)ᵀ + l1, den == 0 → EPS."""
    den = P @ A.T + l1
    den = torch.where(den == 0.0, EPS, den)
    return H * (Num / den)


def nmf_update(P: torch.Tensor, A: torch.Tensor, H: torch.Tensor,
               Num: torch.Tensor, l1: float = 0.0,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One MU update; on CUDA through ``evc_nmf_update`` (counted in
    ``nmf_update.launches``). ``out=H`` updates H in place, which the kernel
    allows (each element is read, then written, by one thread)."""
    if H.device.type == "cpu":
        res = nmf_update_plain(P, A, H, Num, l1)
        if out is None:
            return res
        return out.copy_(res)
    if H.device.type != "cuda":
        raise ValueError(f"nmf_update: unsupported device {H.device}")
    F, K = H.shape
    D = A.shape[1]
    for name, t, shape in (("P", P, (F, D)), ("A", A, (K, D)), ("H", H, (F, K)),
                           ("Num", Num, (F, K))):
        _check_f32(name, t, shape, H.device)
    if out is None:
        out = torch.empty_like(H)
    else:
        _check_f32("out", out, (F, K), H.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_update", [vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp],
                P.data_ptr(), A.data_ptr(), H.data_ptr(), Num.data_ptr(),
                out.data_ptr(), F, K, D, float(l1), stream)
    nmf_update.launches += 1
    return out


nmf_update.launches = 0


# ---------------------------------------------------------------------------
# one MU iteration as one kernel: H ← H ⊙ Num / ((H·A)·Aᵀ + l1)
# ---------------------------------------------------------------------------

# the fused kernel keeps a (D, 8) P tile beside 34 KB of staging in one
# block's shared memory
FUSED_MAX_D = 6144


def nmf_mu_fused_plain(H: torch.Tensor, A: torch.Tensor, Num: torch.Tensor,
                       l1: float = 0.0) -> torch.Tensor:
    """One whole MU iteration: ``nmf_update_plain(H @ A, A, H, Num, l1)``."""
    return nmf_update_plain(H @ A, A, H, Num, l1)


def nmf_mu_fused(H: torch.Tensor, A: torch.Tensor, Num: torch.Tensor, l1: float = 0.0,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One MU iteration in one launch; on CUDA through ``evc_nmf_fused_mu``
    (counted in ``nmf_mu_fused.launches``), the counterpart of
    ``nmf_activations_pallas(fused=True)``'s kernel. P = H·A stays on chip.
    ``out=H`` updates H in place, which the kernel allows (a block reads and
    writes only its own rows)."""
    if H.device.type == "cpu":
        res = nmf_mu_fused_plain(H, A, Num, l1)
        if out is None:
            return res
        return out.copy_(res)
    if H.device.type != "cuda":
        raise ValueError(f"nmf_mu_fused: unsupported device {H.device}")
    F, K = H.shape
    D = A.shape[1]
    for name, t, shape in (("A", A, (K, D)), ("H", H, (F, K)), ("Num", Num, (F, K))):
        _check_f32(name, t, shape, H.device)
    if D > FUSED_MAX_D:
        raise ValueError(f"nmf_mu_fused: D = {D} exceeds the kernel's {FUSED_MAX_D} "
                         f"(its P tile lives in shared memory)")
    if out is None:
        out = torch.empty_like(H)
    else:
        _check_f32("out", out, (F, K), H.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_fused_mu", [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp],
                H.data_ptr(), A.data_ptr(), Num.data_ptr(), out.data_ptr(), F, K, D,
                float(l1), stream)
    nmf_mu_fused.launches += 1
    return out


nmf_mu_fused.launches = 0
