"""DTW wavefront and backtrace: CUDA kernels and their plain-PyTorch twins.

``dtw_wavefront`` replaces the Pallas kernel
``exemplars_vc_tpu/align/dtw_pallas.py:dtw_wavefront_pallas``;
``dtw_backtrace`` replaces the device half of ``align/dtw.py:_backtrace``.
The kernels are ``csrc/dtw_wavefront.cu``. A CUDA tensor goes to the kernel
(or the call raises); a CPU tensor goes to the twin, which computes the same
codes and paths with vectorised torch ops.

Direction codes: 0 = diag (i-1, j-1), 1 = up (i-1, j), 2 = left (i, j-1);
tie order diag < up < left. Layout: ``dirs[n, d, i]`` with ``d = i + j``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES, check, load_library

BIG = 1e30


def fits_smem(ta: int) -> bool:
    """Whether the wavefront kernel takes a source length of ``ta`` frames
    (the counterpart of ``dtw_pallas.fits_vmem``): it keeps three wavefronts
    of Ta floats in one block's shared memory."""
    return 3 * ta * 4 <= SMEM_LIMIT_BYTES


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

    On a CUDA tensor this launches ``evc_dtw_wavefront`` and counts the
    launch in ``dtw_wavefront.launches``."""
    if C.device.type == "cpu":
        return dtw_wavefront_plain(C, lens)
    if C.device.type != "cuda":
        raise ValueError(f"dtw_wavefront: unsupported device {C.device}")
    if C.dtype != torch.float32 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError(f"C must be contiguous float32 (N, Ta, Tb), got "
                         f"{C.dtype} {tuple(C.shape)}")
    n, ta, tb = C.shape
    if not fits_smem(ta):
        raise ValueError(f"dtw_wavefront: Ta={ta} needs {12 * ta} bytes of shared "
                         f"memory, more than {SMEM_LIMIT_BYTES}")
    _check_lens(lens, n, ta, tb, C.device)
    lib = load_library("dtw_wavefront")
    fn = lib.evc_dtw_wavefront
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    cost = torch.empty((n,), dtype=torch.float32, device=C.device)
    dirs = torch.empty((n, ta + tb - 1, ta), dtype=torch.int8, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        code = fn(C.data_ptr(), lens.data_ptr(), n, ta, tb, cost.data_ptr(),
                  dirs.data_ptr(), stream)
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
    tensor this launches ``evc_dtw_backtrace`` (one thread per pair) and
    counts the launch in ``dtw_backtrace.launches``."""
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
