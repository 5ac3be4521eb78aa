"""Frobenius MU kernels: CUDA wrappers, their launch plans and their
plain-PyTorch twins.

``nmf_recon`` replaces ``exemplars_vc_tpu/factorize/nmf_pallas.py:_recon_kernel``,
``nmf_update`` replaces ``_update_kernel`` and ``nmf_mu_fused`` replaces
``_fused_mu_call`` (one MU iteration per launch); all are in ``csrc/nmf_mu.cu``.
A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
the twin.

``nmf_recon`` and ``nmf_mu_fused`` are split-K kernels launched as
thread-block clusters. Their plans (``nmf_recon_plan``, ``nmf_mu_fused_plan``)
are pure functions of the shape and the card's SM count: the CTA tile, the
split (CTAs per cluster, one contiguous K slice each), the slice bounds, the
grid and the dynamic shared memory. Both take the split and the slices from
``_k_split``, so P sums in the same order on both paths and the fused solve
equals the two-kernel solve bit for bit. ``nmf_update`` has no split (K is
its output axis); its plan (``nmf_update_plan``) gives the tile, the grid
over K and F and the shared memory of its staging ring, which does not grow
with D. The C entries refuse a plan that cannot launch, and the wrappers
raise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES, check, load_library

EPS = 2.220446049250313e-16  # np.finfo(float64).eps — sklearn's EPSILON

MAX_CLUSTER = 8          # portable thread-block cluster size
_BK = 16                 # reduction depth of one staged slice (EVC_BK)
_THREAD_TILE = (8, 4)    # outputs of one thread (EVC_TM x EVC_TN)
RECON_TILE = (32, 128)   # nmf_recon's CTA tile, F x D (EVC_RECON_BM/BN)
_RECON_STAGES = 4        # nmf_recon's cp.async ring (EVC_RECON_NS)
_FUSED_BN = 256          # fused: phase-1 D chunk and phase-2 K pass (EVC_FUSED_BN)
# fused (F tile, ring depth) instances of evc_fused_any, preferred first
_FUSED_TILES = ((32, 4), (16, 2), (8, 2))
UPDATE_TILE = (64, 128)  # nmf_update's CTA tile, F x K (EVC_UPDATE_BM/BN)
_UPDATE_STAGES = 4       # nmf_update's cp.async ring (EVC_UPDATE_NS)


def _check_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


@lru_cache(maxsize=None)
def _entry(fn_name: str, argtypes: tuple):
    lib = load_library("nmf_mu")
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return lib, fn


def _launch(fn_name: str, argtypes: list, *args) -> None:
    lib, fn = _entry(fn_name, tuple(argtypes))
    check(fn(*args), fn_name, lib)


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _k_split(F: int, K: int, n_sms: int) -> tuple[int, tuple[int, ...]]:
    """CTAs per cluster and the bounds of their K slices, shared by both
    kernels so that P sums in one order on both paths: the smallest of 1, 2,
    4 and 8 that gives the fused kernel's ceil(F/32) clusters at least
    ``n_sms`` CTAs (else 8, the portable maximum), fewer only where K has
    fewer ``_BK`` slices. Powers of two: on an H100 a cluster of 5 to 8 CTAs
    at one CTA an SM fills only 102 to 120 of the 132 SMs at once and a
    cluster of 6 fits worst (PERF.md). The slices are contiguous, in order,
    ``_BK``-aligned, and none is empty (K = 0: one empty slice)."""
    if K <= 0:
        return 1, (0, 0)
    tiles = _cdiv(F, _FUSED_TILES[0][0])
    split = next((s for s in (1, 2, 4) if tiles * s >= n_sms), MAX_CLUSTER)
    split = min(split, _cdiv(K, _BK))
    step = _cdiv(_cdiv(K, split), _BK) * _BK
    split = _cdiv(K, step)
    return split, tuple(min(i * step, K) for i in range(split)) + (K,)


def _recon_smem_bytes(bm: int) -> int:
    """The cp.async ring (k-major H and A stages), which the partial tile
    reuses."""
    return 4 * max(_RECON_STAGES * _BK * (bm + 4 + RECON_TILE[1]), bm * RECON_TILE[1])


def nmf_recon_plan(F: int, K: int, D: int, n_sms: int) -> dict:
    """``nmf_recon``'s launch plan: a 32 × 128 (F × D) tile per cluster of
    ``split`` CTAs, 128 threads of 8 × 4 outputs each, grid (split,
    D tiles, F tiles)."""
    bm, bn = RECON_TILE
    split, bounds = _k_split(F, K, n_sms)
    return {"tile": (bm, bn), "thread_tile": _THREAD_TILE,
            "threads": bm * bn // (_THREAD_TILE[0] * _THREAD_TILE[1]),
            "stages": _RECON_STAGES, "split": split, "cluster": (split, 1, 1),
            "k_bounds": bounds, "grid": (split, _cdiv(D, bn), _cdiv(F, bm)),
            "smem_bytes": _recon_smem_bytes(bm)}


def _fused_smem_bytes(tf: int, stages: int, D: int) -> int:
    """The whole P tile ([D rounded up to 16][tf]) beside the larger of the
    phase-1 ring, the phase-2 ring and the partial chunk (EVC FusedTile)."""
    work = max(stages * _BK * (tf + 4 + _FUSED_BN), stages * _BK * (_FUSED_BN + 4),
               _FUSED_BN * tf)
    return 4 * (_cdiv(D, _BK) * _BK * tf + work)


def nmf_mu_fused_plan(F: int, K: int, D: int, n_sms: int) -> dict:
    """``nmf_mu_fused``'s launch plan: a cluster of ``split`` CTAs per tile of
    TF rows of F (32; 16 or 8 where D leaves the P tile too little room),
    8·TF threads of 8 × 4 outputs each, grid (split, F tiles, 1). Raises
    ValueError where even TF = 8 does not fit one block's shared memory."""
    for tf, stages in _FUSED_TILES:
        smem = _fused_smem_bytes(tf, stages, D)
        if smem <= SMEM_LIMIT_BYTES:
            break
    else:
        raise ValueError(f"nmf_mu_fused: D = {D}: the P tile does not fit "
                         f"{SMEM_LIMIT_BYTES} B of shared memory")
    split, bounds = _k_split(F, K, n_sms)
    return {"tile": (tf, _FUSED_BN), "thread_tile": _THREAD_TILE, "threads": 8 * tf,
            "stages": stages, "split": split, "cluster": (split, 1, 1), "k_bounds": bounds,
            "grid": (split, _cdiv(F, tf), 1), "smem_bytes": smem}


def nmf_update_plan(F: int, K: int, D: int, n_sms: int) -> dict:
    """``nmf_update``'s launch plan: a 64 × 128 (F × K) tile per CTA of 256
    threads of 8 × 4 outputs each, grid (K tiles, F tiles, 1), no cluster.
    D and ``n_sms`` leave it unchanged (the signature is the other plans'):
    the kernel stages D ``_BK`` columns at a time, so its shared memory, a
    ring of d-major P and A slices with padded rows, is the same for every
    D."""
    bm, bn = UPDATE_TILE
    return {"tile": (bm, bn), "thread_tile": _THREAD_TILE,
            "threads": bm * bn // (_THREAD_TILE[0] * _THREAD_TILE[1]),
            "stages": _UPDATE_STAGES, "grid": (_cdiv(K, bn), _cdiv(F, bm), 1),
            "smem_bytes": 4 * _UPDATE_STAGES * _BK * (bm + 4 + bn + 4)}


class _Plan(ctypes.Structure):
    """``EvcPlan`` of ``csrc/nmf_mu.cu``."""
    _fields_ = [*((name, ctypes.c_int) for name in ("bm", "bn", "threads", "stages", "split",
                                                     "grid_x", "grid_y", "grid_z",
                                                     "smem_bytes")),
                ("k_bounds", ctypes.c_int * (MAX_CLUSTER + 1))]


def _pack(plan: dict) -> _Plan:
    # bounds past the struct's room are dropped: the C entry refuses such a
    # split before it reads them. A plan without a split (nmf_update) packs
    # split 1 and bounds that the C entry does not read.
    bounds = list(plan.get("k_bounds", (0,)))[:MAX_CLUSTER + 1]
    bounds += [bounds[-1]] * (MAX_CLUSTER + 1 - len(bounds))
    return _Plan(*plan["tile"], plan["threads"], plan["stages"], plan.get("split", 1),
                 *plan["grid"],
                 plan["smem_bytes"], (ctypes.c_int * (MAX_CLUSTER + 1))(*bounds))


def co_resident_clusters(kernel: str, plan: dict, F: int, K: int, D: int) -> int:
    """How many clusters of ``plan`` the current card holds at once, for
    ``kernel`` "nmf_recon", "nmf_mu_fused" or "nmf_update" (no cluster: its
    CTAs, CTAs an SM times the SMs, as the occupancy query reports them). The
    C entry checks the plan as for a launch and raises where it would refuse
    it."""
    name = {"nmf_recon": "evc_nmf_recon_clusters",
            "nmf_mu_fused": "evc_nmf_fused_mu_clusters",
            "nmf_update": "evc_nmf_update_clusters"}[kernel]
    ci = ctypes.c_int
    n = ci()
    _launch(name, [ci, ci, ci, ctypes.POINTER(_Plan), ctypes.POINTER(ci)], F, K, D,
            ctypes.byref(_pack(plan)), ctypes.byref(n))
    return n.value


_PLANS = {"nmf_recon": nmf_recon_plan, "nmf_update": nmf_update_plan,
          "nmf_mu_fused": nmf_mu_fused_plan}


@lru_cache(maxsize=64)
def _default_plan(kernel: str, F: int, K: int, D: int, n_sms: int) -> _Plan:
    return _pack(_PLANS[kernel](F, K, D, n_sms))


@lru_cache(maxsize=8)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return _n_sms(device.index if device.index is not None else torch.cuda.current_device())


# ---------------------------------------------------------------------------
# P = H·A
# ---------------------------------------------------------------------------

def nmf_recon_plain(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """P (F, D) = H (F, K) · A (K, D)."""
    return H @ A


def nmf_recon(H: torch.Tensor, A: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """Reconstruction P = H·A; on CUDA through ``evc_nmf_recon`` (counted in
    ``nmf_recon.launches``) with ``plan`` (default ``nmf_recon_plan`` for the
    shape and the card); a plan the card cannot launch raises RuntimeError."""
    if H.device.type == "cpu":
        return nmf_recon_plain(H, A)
    if H.device.type != "cuda":
        raise ValueError(f"nmf_recon: unsupported device {H.device}")
    F, K = H.shape
    D = A.shape[1]
    _check_f32("H", H, (F, K), H.device)
    _check_f32("A", A, (K, D), H.device)
    packed = (_default_plan("nmf_recon", F, K, D, _sms(H.device)) if plan is None
              else _pack(plan))
    P = torch.empty((F, D), dtype=torch.float32, device=H.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_recon", [vp, vp, vp, ci, ci, ci, ctypes.POINTER(_Plan), vp],
                H.data_ptr(), A.data_ptr(), P.data_ptr(), F, K, D, ctypes.byref(packed),
                stream)
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
               out: torch.Tensor | None = None, plan: dict | None = None) -> torch.Tensor:
    """One MU update; on CUDA through ``evc_nmf_update`` (counted in
    ``nmf_update.launches``) with ``plan`` (default ``nmf_update_plan``; one
    the card cannot launch raises RuntimeError). ``out=H`` updates H in
    place, which the kernel allows (each element is read, then written, by
    one thread)."""
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
    packed = (_default_plan("nmf_update", F, K, D, _sms(H.device)) if plan is None
              else _pack(plan))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_update",
                [vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ctypes.POINTER(_Plan), vp],
                P.data_ptr(), A.data_ptr(), H.data_ptr(), Num.data_ptr(),
                out.data_ptr(), F, K, D, float(l1), ctypes.byref(packed), stream)
    nmf_update.launches += 1
    return out


nmf_update.launches = 0


# ---------------------------------------------------------------------------
# one MU iteration as one kernel: H ← H ⊙ Num / ((H·A)·Aᵀ + l1)
# ---------------------------------------------------------------------------

# the fused kernel keeps the (D, TF) P tile in one block's shared memory;
# at D = 6144 TF shrinks to 8 rows (nmf_mu_fused_plan)
FUSED_MAX_D = 6144


def nmf_mu_fused_plain(H: torch.Tensor, A: torch.Tensor, Num: torch.Tensor,
                       l1: float = 0.0) -> torch.Tensor:
    """One whole MU iteration: ``nmf_update_plain(H @ A, A, H, Num, l1)``."""
    return nmf_update_plain(H @ A, A, H, Num, l1)


def nmf_mu_fused(H: torch.Tensor, A: torch.Tensor, Num: torch.Tensor, l1: float = 0.0,
                 out: torch.Tensor | None = None, plan: dict | None = None) -> torch.Tensor:
    """One MU iteration in one launch; on CUDA through ``evc_nmf_fused_mu``
    (counted in ``nmf_mu_fused.launches``), the counterpart of
    ``nmf_activations_pallas(fused=True)``'s kernel, with ``plan`` (default
    ``nmf_mu_fused_plan``; one the card cannot launch raises RuntimeError).
    P = H·A stays on chip. ``out=H`` updates H in place, which the kernel
    allows (a CTA reads and writes only its own rows and K slice)."""
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
    packed = (_default_plan("nmf_mu_fused", F, K, D, _sms(H.device)) if plan is None
              else _pack(plan))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        _launch("evc_nmf_fused_mu",
                [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ctypes.POINTER(_Plan), vp],
                H.data_ptr(), A.data_ptr(), Num.data_ptr(), out.data_ptr(), F, K, D,
                float(l1), ctypes.byref(packed), stream)
    nmf_mu_fused.launches += 1
    return out


nmf_mu_fused.launches = 0
