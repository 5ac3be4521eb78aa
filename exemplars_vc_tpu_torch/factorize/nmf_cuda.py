"""Frobenius MU kernels: CUDA wrappers, their launch plans and their
plain-PyTorch twins.

``nmf_recon`` replaces ``exemplars_vc_tpu/factorize/nmf_pallas.py:_recon_kernel``,
``nmf_update`` replaces ``_update_kernel`` and ``nmf_mu_fused`` replaces
``_fused_mu_call`` (one MU iteration per launch); all are in ``csrc/nmf_mu.cu``.
A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes to
the twin.

``nmf_recon`` is a persistent split-K over every SM, one cooperative launch.
Its plan (``nmf_recon_plan``) is a pure function of the shape and the card's
SM count. It cuts P into tiles of 16·TM rows of F by 208 columns of D (TM
= 8, or 1 where F ≤ 48) and K into pieces that are the same for every tile:
as many long pieces as whole sets of tiles fit the SMs, and, where SMs are
left over, one short remainder piece whose units those SMs share. A unit is
one tile over one piece; each CTA takes one unit or a run of remainder
units and writes each unit's partial tile to a workspace. After a grid
barrier every CTA sums the partials in a fixed order: the pieces of each
group in order, then the groups in order (``recon_order``). The groups are
the fused kernel's cluster ranks: ``nmf_mu_fused_plan`` takes the recon's
pieces and groups, each fused CTA sums its group's pieces in the same order
in registers before the rank-order cluster sum, and so the fused solve
equals the two-kernel solve bit for bit. On an H100 the recon is bound by
its FMA rate from F ~ 100 up (52 % of its fp32 bound at F = 620, K =
14,336, D = 1025) and by reading A from L2 at F = 16 (15 µs a launch;
``csrc/nmf_mu.cu``'s head note). ``nmf_update`` has no split (K is
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

MAX_CLUSTER = 8          # portable thread-block cluster size: the fused kernel's ranks
_BK = 16                 # reduction depth of one staged slice (EVC_BK)
_THREAD_TILE = (8, 4)    # outputs of one thread in the update and fused kernels
RECON_THREADS = 256      # nmf_recon: 16 x 16 threads (EVC_RECON_NT)
RECON_TN = 13            # nmf_recon: D columns of a thread's register tile
RECON_BN = 16 * RECON_TN  # nmf_recon's D tile, 208 (EVC_RECON_BN)
_RECON_BK = 16           # nmf_recon's staged slice depth (EVC_RECON_BK)
_RECON_AP = 20           # A-stage floats a thread column takes, 13 used (EVC_RECON_AP)
_RECON_STAGES = {1: 6, 8: 4}  # nmf_recon's cp.async ring depth by thread-tile height
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


def _recon_tm(F: int) -> int:
    """Rows of F in a recon thread's register tile: 8 (128-row F tiles),
    or 1 (16-row tiles) where F ≤ 48. A 1 × 13 tile issues 13 FMAs for
    4.25 shared loads and an 8 × 13 tile 104 for 6, so the short tile pays
    only where a 128-row tile would be more than 60 % empty."""
    return 1 if F <= 48 else 8


def _recon_pieces(T: int, nkb: int, n_sms: int) -> tuple[int, int]:
    """The K pieces of ``T`` tiles over ``nkb`` staged slices on ``n_sms``
    SMs, as (q, rem): q long pieces cut the first nkb − rem slices as evenly
    as slices allow, then a remainder piece takes the last rem (none where
    rem = 0). q is the number of whole sets of T tiles that fit the SMs, so
    each long unit has an SM of its own; the SMs left over share the T
    remainder units in runs, and rem makes a run as long as a long piece.
    More tiles than SMs: q equal pieces (at most 8), the units shared out
    in runs over every SM."""
    if nkb == 0:
        return 1, 0
    q = n_sms // T
    if q == 0:
        return min(range(1, min(8, nkb) + 1),
                   key=lambda s: (_cdiv(T * s, n_sms) * _cdiv(nkb, s), s)), 0
    q = min(q, nkb)
    spare = n_sms - T * q
    if spare == 0 or q == nkb:
        return q, 0
    run = _cdiv(T, min(spare, T))        # remainder units a spare SM takes

    def load(rem):
        return max(_cdiv(nkb - rem, q), run * rem) if rem else _cdiv(nkb, q)

    lo, hi = 1, nkb - q                  # the smallest rem whose run outweighs a long piece
    while lo < hi:
        mid = (lo + hi) // 2
        if run * mid >= _cdiv(nkb - mid, q):
            hi = mid
        else:
            lo = mid + 1
    return q, min((0, lo - 1, lo), key=lambda rem: (load(rem), rem))


def _piece_bounds(K: int, q: int, rem: int) -> tuple[int, ...]:
    """K bounds of the pieces (EvcPieces::k): q long pieces over the first
    nkb − rem slices of ``_BK`` rows, then the remainder piece."""
    nkb = _cdiv(K, _BK)
    kb = [j * (nkb - rem) // q for j in range(q + 1)] + ([nkb] if rem else [])
    return tuple(min(K, _BK * b) for b in kb)


def _groups(F: int, pieces: int, n_sms: int) -> int:
    """Groups of pieces, the fused kernel's CTAs per cluster: the smallest
    of 1, 2, 4 and 8 that gives its ceil(F/32) clusters at least ``n_sms``
    CTAs (else 8), halved while it exceeds the pieces, so that it stays a
    power of two and every group has a piece."""
    tiles = _cdiv(F, _FUSED_TILES[0][0])
    g = next((c for c in (1, 2, 4) if tiles * c >= n_sms), MAX_CLUSTER)
    while g > pieces:
        g //= 2
    return g


def _recon_smem_bytes(tm: int) -> int:
    """The cp.async ring: an F-major H stage of 16·tm rows with rows of
    ``_RECON_BK`` + 4 floats, and a k-major A stage of ``_RECON_BK`` rows of
    16 thread columns of ``_RECON_AP`` floats."""
    return 4 * _RECON_STAGES[tm] * (16 * tm * (_RECON_BK + 4) + _RECON_BK * 16 * _RECON_AP)


def nmf_recon_plan(F: int, K: int, D: int, n_sms: int) -> dict:
    """``nmf_recon``'s launch plan: 256 threads of TM × 13 outputs each, a
    tile of 16·TM rows of F by 208 columns of D, the K pieces
    (``piece_bounds``: ``long_pieces`` long ones, then a remainder of
    ``rem_kb`` slices where ``rem_kb`` > 0), their ``groups`` (``k_bounds``:
    the groups' K bounds, as the fused kernel's ranks take them) and the
    persistent grid: ``single_ctas`` CTAs with one unit each, then
    ``range_ctas`` CTAs that share ``range_units`` units in runs
    (``recon_units``). A unit u is tile u % T over piece u // T, so the CTAs
    in flight read one K slice of A for every F tile at once."""
    tm = _recon_tm(F)
    bm = 16 * tm
    tiles = (_cdiv(F, bm), _cdiv(D, RECON_BN))
    T = tiles[0] * tiles[1]
    q, rem = _recon_pieces(T, _cdiv(K, _BK), n_sms)
    s = q + (rem > 0)
    g = _groups(F, s, n_sms)
    pieces = _piece_bounds(K, q, rem)
    units = T * s
    if rem:
        single, ranged = T * q, min(n_sms - T * q, T)
    elif units <= n_sms:
        single, ranged = units, 0
    else:
        single, ranged = 0, n_sms
    return {"tile": (bm, RECON_BN), "thread_tile": (tm, RECON_TN), "threads": RECON_THREADS,
            "stages": _RECON_STAGES[tm], "split": 1, "tiles": tiles, "long_pieces": q,
            "rem_kb": rem, "pieces": s, "piece_bounds": pieces, "groups": g,
            "k_bounds": tuple(pieces[r * s // g] for r in range(g + 1)),
            "single_ctas": single, "range_ctas": ranged, "range_units": units - single,
            "units": units, "grid": (single + ranged, 1, 1),
            "workspace_floats": units * tm * RECON_TN * RECON_THREADS,
            "smem_bytes": _recon_smem_bytes(tm)}


def recon_units(plan: dict, cta: int) -> range:
    """The units CTA ``cta`` of ``nmf_recon_plan`` computes, in order."""
    single = plan["single_ctas"]
    if cta < single:
        return range(cta, cta + 1)
    c, n, u = cta - single, plan["range_ctas"], plan["range_units"]
    return range(single + c * u // n, single + (c + 1) * u // n)


def recon_order(plan: dict) -> list[list[int]]:
    """The order in which ``nmf_recon`` sums a tile's partials: for each
    group, its pieces in order. The kernel folds each group from its first
    piece (g = p₀ + p₁ + …, left to right), then the groups from the first."""
    s, g = plan["pieces"], plan["groups"]
    return [list(range(r * s // g, (r + 1) * s // g)) for r in range(g)]


def _fused_smem_bytes(tf: int, stages: int, D: int) -> int:
    """The whole P tile ([D rounded up to 16][tf]) beside the larger of the
    phase-1 ring, the phase-2 ring and the partial chunk (EVC FusedTile)."""
    work = max(stages * _BK * (tf + 4 + _FUSED_BN), stages * _BK * (_FUSED_BN + 4),
               _FUSED_BN * tf)
    return 4 * (_cdiv(D, _BK) * _BK * tf + work)


def nmf_mu_fused_plan(F: int, K: int, D: int, n_sms: int) -> dict:
    """``nmf_mu_fused``'s launch plan: a cluster of ``split`` CTAs per tile of
    TF rows of F (32; 16 or 8 where D leaves the P tile too little room),
    8·TF threads of 8 × 4 outputs each, grid (split, F tiles, 1). The split,
    the K slices and the pieces inside them are ``nmf_recon_plan``'s groups
    and pieces. Raises ValueError where even TF = 8 does not fit one block's
    shared memory."""
    for tf, stages in _FUSED_TILES:
        smem = _fused_smem_bytes(tf, stages, D)
        if smem <= SMEM_LIMIT_BYTES:
            break
    else:
        raise ValueError(f"nmf_mu_fused: D = {D}: the P tile does not fit "
                         f"{SMEM_LIMIT_BYTES} B of shared memory")
    recon = nmf_recon_plan(F, K, D, n_sms)
    split = recon["groups"]
    return {"tile": (tf, _FUSED_BN), "thread_tile": _THREAD_TILE, "threads": 8 * tf,
            "stages": stages, "split": split, "cluster": (split, 1, 1),
            "k_bounds": recon["k_bounds"], "long_pieces": recon["long_pieces"],
            "rem_kb": recon["rem_kb"], "pieces": recon["pieces"],
            "piece_bounds": recon["piece_bounds"], "groups": split,
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


_PIECE_FIELDS = ("long_pieces", "rem_kb", "pieces", "groups")
_RECON_FIELDS = ("single_ctas", "range_ctas", "range_units")


class _Plan(ctypes.Structure):
    """``EvcPlan`` of ``csrc/nmf_mu.cu``."""
    _fields_ = [*((name, ctypes.c_int) for name in ("bm", "bn", "threads", "stages", "split",
                                                     "grid_x", "grid_y", "grid_z",
                                                     "smem_bytes")),
                ("k_bounds", ctypes.c_int * (MAX_CLUSTER + 1)),
                *((name, ctypes.c_int) for name in (*_PIECE_FIELDS, *_RECON_FIELDS,
                                                     "tiles_f", "tiles_d"))]


def _pack(plan: dict) -> _Plan:
    # bounds past the struct's room are dropped: the C entry refuses such a
    # split before it reads them. A plan without pieces (nmf_update) packs
    # split 1, one piece and bounds that the C entry does not read.
    bounds = list(plan.get("k_bounds", (0,)))[:MAX_CLUSTER + 1]
    bounds += [bounds[-1]] * (MAX_CLUSTER + 1 - len(bounds))
    defaults = {"long_pieces": 1, "pieces": 1, "groups": 1}
    return _Plan(*plan["tile"], plan["threads"], plan["stages"], plan.get("split", 1),
                 *plan["grid"], plan["smem_bytes"],
                 (ctypes.c_int * (MAX_CLUSTER + 1))(*bounds),
                 *(plan.get(k, defaults.get(k, 0)) for k in (*_PIECE_FIELDS, *_RECON_FIELDS)),
                 *plan.get("tiles", (0, 0)))


def co_resident_clusters(kernel: str, plan: dict, F: int, K: int, D: int) -> int:
    """How many clusters of ``plan`` the current card holds at once, for
    ``kernel`` "nmf_recon", "nmf_mu_fused" or "nmf_update" (the recon and
    the update have no cluster: their CTAs, CTAs an SM times the SMs, as the
    occupancy query reports them). The C entry checks the plan as for a
    launch and raises where it would refuse it."""
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
def _default_plan(kernel: str, F: int, K: int, D: int, n_sms: int) -> tuple[_Plan, int]:
    plan = _PLANS[kernel](F, K, D, n_sms)
    return _pack(plan), plan.get("workspace_floats", 0)


@lru_cache(maxsize=8)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return _n_sms(device.index if device.index is not None else torch.cuda.current_device())


# the recon's partial tiles. Launches on one stream run in order, so each may
# reuse the buffer its predecessor wrote: one buffer of _WS_KEPT floats (16
# MiB) is kept a (device, stream). A torch.empty a call costs ~6 µs of host
# on an H100 machine, and a stream chunk's recon is host-bound (~30 µs a
# call for a 14 µs kernel). A larger workspace (F in the thousands, a
# kernel of a millisecond or more) is allocated for its call. Two threads
# racing here each get a valid buffer.
_WS_KEPT = 1 << 22
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    if floats > _WS_KEPT:
        return torch.empty(floats, dtype=torch.float32, device=device)
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        ws = torch.empty(_WS_KEPT, dtype=torch.float32, device=device)
        _workspaces[(device.index, stream)] = ws
    return ws


# ---------------------------------------------------------------------------
# P = H·A
# ---------------------------------------------------------------------------

def nmf_recon_plain(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """P (F, D) = H (F, K) · A (K, D)."""
    return H @ A


def nmf_recon(H: torch.Tensor, A: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """Reconstruction P = H·A; on CUDA through ``evc_nmf_recon`` (counted in
    ``nmf_recon.launches``) with ``plan`` (default ``nmf_recon_plan`` for the
    shape and the card); a plan the card cannot launch raises RuntimeError.
    The partial tiles go to the workspace kept for the current stream
    (``_workspace``)."""
    if H.device.type == "cpu":
        return nmf_recon_plain(H, A)
    if H.device.type != "cuda":
        raise ValueError(f"nmf_recon: unsupported device {H.device}")
    F, K = H.shape
    D = A.shape[1]
    _check_f32("H", H, (F, K), H.device)
    _check_f32("A", A, (K, D), H.device)
    P = torch.empty((F, D), dtype=torch.float32, device=H.device)
    if F == 0 or D == 0:
        return P
    if plan is None:
        packed, ws_floats = _default_plan("nmf_recon", F, K, D, _sms(H.device))
    else:
        packed, ws_floats = _pack(plan), plan["workspace_floats"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        ws = _workspace(H.device, stream, ws_floats)
        _launch("evc_nmf_recon",
                [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ctypes.POINTER(_Plan), vp],
                H.data_ptr(), A.data_ptr(), P.data_ptr(), ws.data_ptr(), ws.numel(), F, K, D,
                ctypes.byref(packed), stream)
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
    packed = (_default_plan("nmf_update", F, K, D, _sms(H.device))[0] if plan is None
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
    packed = (_default_plan("nmf_mu_fused", F, K, D, _sms(H.device))[0] if plan is None
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
