"""DTW wavefront and backtrace: CUDA kernels and their plain-PyTorch twins.

``dtw_wavefront`` replaces the Pallas kernel
``exemplars_vc_tpu/align/dtw_pallas.py:dtw_wavefront_pallas``;
``dtw_backtrace`` replaces the device half of ``align/dtw.py:_backtrace``.
The kernels are ``csrc/dtw_wavefront.cu``. A CUDA tensor goes to the kernel
(or the call raises); a CPU tensor goes to the twin, which computes the same
codes and paths with vectorised torch ops.

The wavefront kernel is a systolic sweep: each lane of a warp owns R
consecutive rows (1, or 8 above 4096 rows) and the warps of one pair form a
chain through the CTAs of a thread-block cluster; :func:`dtw_wavefront_plan`
(pure Python) chooses R, the cluster size and the warps a CTA.

Direction codes: 0 = diag (i-1, j-1), 1 = up (i-1, j), 2 = left (i, j-1);
tie order diag < up < left. Layout: ``dirs[n, d, i]`` with ``d = i + j``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES, check, load_library

BIG = 1e30
# the longest source the wrappers take: three float32 wavefronts of Ta in one
# block's shared memory, the range of the first design, which every later
# plan keeps (19,370 frames)
MAX_TA = SMEM_LIMIT_BYTES // 12
DTW_MAX_CLUSTER = 8          # CTAs a pair (the portable cluster size)
DTW_MAX_WARPS = 16           # warps a CTA
# rows a lane and steps a chunk of the two compiled variants: one row a lane
# (measured fastest) covers Ta up to 8 CTAs x 16 warps x 32 lanes = 4096,
# eight rows a lane (4-step chunks, for their registers) the rest
DTW_ONE_ROW_MAX_TA = DTW_MAX_CLUSTER * DTW_MAX_WARPS * 32
DTW_CHUNK = {1: 16, 8: 4}


def fits_smem(ta: int) -> bool:
    """Whether the wavefront kernel takes a source length of ``ta`` frames
    (the counterpart of ``dtw_pallas.fits_vmem``)."""
    return 1 <= ta <= MAX_TA


def dtw_wavefront_plan(n: int, ta: int, n_sms: int) -> dict:
    """Launch plan of the wavefront kernel for ``n`` pairs of ``ta`` source
    frames on a card of ``n_sms`` SMs.

    One pair is a chain of ``warps = ceil(ta / (32 R))`` warps, R rows a
    lane (1 up to 4096 rows, else 8), spread over a cluster of CTAs of
    ``warps_per_cta`` warps (warps of a CTA hand over their boundary row
    through a pair barrier, CTAs through st.async and mbarriers). The
    cluster aims at ``n_sms // n`` CTAs a pair, at most 8, so that few rows
    share an SM, and widens up to 8 where a CTA would need more than 16
    warps. Raises ValueError outside ``1 <= ta <= MAX_TA``."""
    if not fits_smem(ta):
        raise ValueError(f"dtw_wavefront: Ta={ta} is outside 1..{MAX_TA}")
    r = 1 if ta <= DTW_ONE_ROW_MAX_TA else 8
    warps = -(-ta // (32 * r))
    target = min(DTW_MAX_CLUSTER, max(1, n_sms // max(n, 1)))
    size = max(target, -(-warps // DTW_MAX_WARPS))
    wpc = -(-warps // min(size, warps))
    ctas = -(-warps // wpc)
    return dict(rows_per_lane=r, chunk=DTW_CHUNK[r], warps=warps, warps_per_cta=wpc,
                cluster=ctas, threads=32 * wpc, grid=(n * ctas, 1, 1))


def _check_lens(lens: torch.Tensor, n: int, ta: int, tb: int, device) -> None:
    if lens.dtype != torch.int32 or lens.shape != (n, 2) or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous int32 ({n}, 2), got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if lens.device != device:
        raise ValueError(f"lens on {lens.device}, costs on {device}")
    host = lens.cpu()
    if (host < 1).any() or (host[:, 0] > ta).any() or (host[:, 1] > tb).any():
        raise ValueError(f"lens out of range 1..({ta}, {tb}): {host.tolist()}")


# ---------------------------------------------------------------------------
# wavefront DP
# ---------------------------------------------------------------------------

def dtw_wavefront_plain(C: torch.Tensor, lens: torch.Tensor):
    """Plain twin of the wavefront kernel: one vectorised step per diagonal.

    C: (N, Ta, Tb) f32 pairwise costs; lens: (N, 2) int32 [len_a, len_b].
    Returns (raw cost (N,) f32, dirs (N, Ta+Tb-1, Ta) int8)."""
    n, ta, tb = C.shape
    n_diag = ta + tb - 1
    dev = C.device
    la = lens[:, 0].long()
    lb = lens[:, 1].long()
    i_idx = torch.arange(ta, device=dev)
    ar = torch.arange(n, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    rows_ok = i_idx[None, :] < la[:, None]
    end_d = la + lb - 2
    prev = torch.full((n, ta), BIG, dtype=torch.float32, device=dev)
    prev2 = prev.clone()
    final = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    dirs = torch.empty((n, n_diag, ta), dtype=torch.int8, device=dev)
    for d in range(n_diag):
        j = d - i_idx
        c = C[:, i_idx, j.clamp(0, tb - 1)]
        c = torch.where((j >= 0)[None, :] & (j[None, :] < lb[:, None]) & rows_ok, c, big)
        left = torch.where((j >= 1)[None, :], prev, big)
        up = F.pad(prev[:, :-1], (1, 0), value=BIG)
        dg = torch.where((j >= 1)[None, :], F.pad(prev2[:, :-1], (1, 0), value=BIG), big)
        best = torch.minimum(torch.minimum(dg, up), left)
        choice = torch.where(best == dg, 0, torch.where(best == up, 1, 2))
        if d == 0:
            best[:, 0] = 0.0
        new = torch.clamp(c + torch.clamp(best, max=BIG), max=BIG)
        new = torch.where((j >= 0)[None, :], new, big)
        dirs[:, d] = choice.to(torch.int8)
        final = torch.where(end_d == d, new[ar, la - 1], final)
        prev2, prev = prev, new
    return final, dirs


def dtw_wavefront(C: torch.Tensor, lens: torch.Tensor):
    """Batched wavefront DP; same contract as :func:`dtw_wavefront_plain`.

    On a CUDA tensor this launches ``evc_dtw_wavefront`` with the
    :func:`dtw_wavefront_plan` of this card and counts the launch in
    ``dtw_wavefront.launches``; the C entry refuses a plan that does not
    cover Ta, and the call raises."""
    if C.device.type == "cpu":
        return dtw_wavefront_plain(C, lens)
    if C.device.type != "cuda":
        raise ValueError(f"dtw_wavefront: unsupported device {C.device}")
    if C.dtype != torch.float32 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError(f"C must be contiguous float32 (N, Ta, Tb), got "
                         f"{C.dtype} {tuple(C.shape)}")
    n, ta, tb = C.shape
    if not fits_smem(ta):
        raise ValueError(f"dtw_wavefront: Ta={ta} is more than {MAX_TA} frames, the range "
                         f"of three float32 wavefronts in {SMEM_LIMIT_BYTES} B of shared memory")
    _check_lens(lens, n, ta, tb, C.device)
    plan = dtw_wavefront_plan(n, ta, torch.cuda.get_device_properties(C.device)
                              .multi_processor_count)
    lib = load_library("dtw_wavefront")
    fn = lib.evc_dtw_wavefront
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    cost = torch.empty((n,), dtype=torch.float32, device=C.device)
    dirs = torch.empty((n, ta + tb - 1, ta), dtype=torch.int8, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        code = fn(C.data_ptr(), lens.data_ptr(), n, ta, tb, plan["rows_per_lane"],
                  plan["cluster"], plan["warps_per_cta"], cost.data_ptr(), dirs.data_ptr(),
                  stream)
    check(code, "dtw_wavefront", lib)
    dtw_wavefront.launches += 1
    return cost, dirs


dtw_wavefront.launches = 0


# ---------------------------------------------------------------------------
# backtrace
# ---------------------------------------------------------------------------

def dtw_backtrace_plain(dirs: torch.Tensor, lens: torch.Tensor):
    """Plain twin of the backtrace kernel, vectorised over pairs.

    dirs: (N, Ta+Tb-1, Ta) int8; lens: (N, 2) int32. Returns ascending
    (path_i, path_j) (N, Ta+Tb-1) int32 padded with -1, and path_len (N,)."""
    n, max_path, ta = dirs.shape
    dev = dirs.device
    ar = torch.arange(n, device=dev)
    i = lens[:, 0].long() - 1
    j = lens[:, 1].long() - 1
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    rev_i = torch.full((n, max_path), -1, dtype=torch.long, device=dev)
    rev_j = rev_i.clone()
    for k in range(max_path):
        if k % 64 == 0 and bool(done.all()):
            break
        rev_i[:, k] = torch.where(done, -1, i)
        rev_j[:, k] = torch.where(done, -1, j)
        at_origin = (i == 0) & (j == 0)
        code = dirs[ar, (i + j).clamp(0, max_path - 1), i.clamp(0, ta - 1)]
        ni = torch.where(code == 2, i, i - 1)   # left keeps i
        nj = torch.where(code == 1, j, j - 1)   # up keeps j
        stop = done | at_origin | (ni < 0) | (nj < 0)
        i = torch.where(stop, i, ni)
        j = torch.where(stop, j, nj)
        done = stop
    path_len = (rev_i >= 0).sum(dim=1)
    k = torch.arange(max_path, device=dev)[None, :]
    src = (path_len[:, None] - 1 - k).clamp(0, max_path - 1)
    keep = k < path_len[:, None]
    path_i = torch.where(keep, rev_i.gather(1, src), -1).to(torch.int32)
    path_j = torch.where(keep, rev_j.gather(1, src), -1).to(torch.int32)
    return path_i, path_j, path_len.to(torch.int32)


def dtw_backtrace(dirs: torch.Tensor, lens: torch.Tensor):
    """Backtrace; same contract as :func:`dtw_backtrace_plain`. On a CUDA
    tensor this launches ``evc_dtw_backtrace`` (one CTA a pair, the codes
    staged in shared-memory windows, one walk) and counts the launch in
    ``dtw_backtrace.launches``."""
    if dirs.device.type == "cpu":
        return dtw_backtrace_plain(dirs, lens)
    if dirs.device.type != "cuda":
        raise ValueError(f"dtw_backtrace: unsupported device {dirs.device}")
    if dirs.dtype != torch.int8 or dirs.dim() != 3 or not dirs.is_contiguous():
        raise ValueError(f"dirs must be contiguous int8 (N, Ta+Tb-1, Ta), got "
                         f"{dirs.dtype} {tuple(dirs.shape)}")
    n, max_path, ta = dirs.shape
    tb = max_path - ta + 1
    _check_lens(lens, n, ta, tb, dirs.device)
    lib = load_library("dtw_wavefront")
    fn = lib.evc_dtw_backtrace
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    path_i = torch.empty((n, max_path), dtype=torch.int32, device=dirs.device)
    path_j = torch.empty_like(path_i)
    path_len = torch.empty((n,), dtype=torch.int32, device=dirs.device)
    with torch.cuda.device(dirs.device):
        stream = torch.cuda.current_stream(dirs.device).cuda_stream
        code = fn(dirs.data_ptr(), lens.data_ptr(), n, ta, tb, path_i.data_ptr(),
                  path_j.data_ptr(), path_len.data_ptr(), stream)
    check(code, "dtw_backtrace", lib)
    dtw_backtrace.launches += 1
    return path_i, path_j, path_len


dtw_backtrace.launches = 0
