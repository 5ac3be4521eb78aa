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
(pure Python) chooses R, the cluster size and the warps a CTA. A source
longer than one plan's reach (``MAX_TA`` rows) runs as row bands of at most
``MAX_TA`` rows, one launch a band in order, each handing its last row's
costs to the next (``band_rows``; the twin takes the same bands).

Direction codes: 0 = diag (i-1, j-1), 1 = up (i-1, j), 2 = left (i, j-1);
tie order diag < up < left. Layout: ``dirs[n, d, i]`` with ``d = i + j``.
"""

from __future__ import annotations

import ctypes

import torch

from exemplars_vc_tpu_torch.kernels.build import check, load_library

BIG = 1e30
DTW_MAX_CLUSTER = 8          # CTAs a pair (the portable cluster size)
DTW_MAX_WARPS = 16           # warps a CTA
# rows a lane and steps a chunk of the two compiled variants: one row a lane
# (measured fastest) covers Ta up to 8 CTAs x 16 warps x 32 lanes = 4096,
# eight rows a lane (4-step chunks, for their registers) the rest
DTW_ONE_ROW_MAX_TA = DTW_MAX_CLUSTER * DTW_MAX_WARPS * 32
DTW_CHUNK = {1: 16, 8: 4}
# the most rows one launch sweeps: the reach of the widest plan, 8 CTAs x 16
# warps x 32 lanes x 8 rows = 32,768 frames (the kernel keeps no Ta-sized
# buffer); a longer source runs as bands of at most this many rows
MAX_TA = DTW_ONE_ROW_MAX_TA * 8


def fits_plan(ta: int) -> bool:
    """Whether one launch of the wavefront kernel sweeps ``ta`` rows (the
    counterpart of ``dtw_pallas.fits_vmem``); longer sources run in bands."""
    return 1 <= ta <= MAX_TA


def row_bands(ta: int, band_rows: int = MAX_TA) -> list[tuple[int, int]]:
    """The row bands [i0, i1) of a source of ``ta`` frames: ``band_rows``
    rows each, the last one shorter. Raises ValueError for a band height
    outside ``1..MAX_TA``."""
    if not fits_plan(band_rows):
        raise ValueError(f"dtw_wavefront: band_rows={band_rows} is outside 1..{MAX_TA}")
    return [(i0, min(i0 + band_rows, ta)) for i0 in range(0, ta, band_rows)]


def _band_diagonals(ta: int, tb: int, i0: int, i1: int) -> int:
    """Diagonals a band sweeps: its rows' cells up to column tb, whose codes
    depend on the data (one past the last cell), within the Ta + Tb - 1."""
    return min(i1 - i0 + tb, ta + tb - 1 - i0)


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
    if not fits_plan(ta):
        raise ValueError(f"dtw_wavefront: Ta={ta} is outside 1..{MAX_TA}")
    r = 1 if ta <= DTW_ONE_ROW_MAX_TA else 8
    warps = -(-ta // (32 * r))
    target = min(DTW_MAX_CLUSTER, max(1, n_sms // max(n, 1)))
    size = max(target, -(-warps // DTW_MAX_WARPS))
    wpc = -(-warps // min(size, warps))
    ctas = -(-warps // wpc)
    return dict(rows_per_lane=r, chunk=DTW_CHUNK[r], warps=warps, warps_per_cta=wpc,
                cluster=ctas, threads=32 * wpc, grid=(n * ctas, 1, 1))


def _check_lens(lens: torch.Tensor, n: int, ta: int, tb: int, device,
                lens_host=None) -> None:
    """Refuse lengths the kernels would read or write out of bounds with.

    The range check needs the values on the host. ``lens_host`` is the
    caller's host copy of the same (n, 2) values (an array or a CPU tensor);
    without it the check copies ``lens`` back, which waits for the device."""
    if lens.dtype != torch.int32 or lens.shape != (n, 2) or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous int32 ({n}, 2), got "
                         f"{lens.dtype} {tuple(lens.shape)}")
    if lens.device != device:
        raise ValueError(f"lens on {lens.device}, costs on {device}")
    host = lens.cpu() if lens_host is None else torch.as_tensor(lens_host).cpu()
    if tuple(host.shape) != (n, 2):
        raise ValueError(f"lens_host must be ({n}, 2), got {tuple(host.shape)}")
    if (host < 1).any() or (host[:, 0] > ta).any() or (host[:, 1] > tb).any():
        raise ValueError(f"lens out of range 1..({ta}, {tb}): {host.tolist()}")


# ---------------------------------------------------------------------------
# wavefront DP
# ---------------------------------------------------------------------------

def _plain_band(C: torch.Tensor, lens: torch.Tensor, i0: int, i1: int, top, dirs, final,
                left=None, corner=None, origin: bool | None = None, right=None):
    """One row band [i0, i1) of the twin, in the band's own indices (i' =
    i - i0, d' = d - i0, j = d' - i'): ``top`` (N, Tb) holds row i0-1's costs
    (None for the first band), the codes go to ``dirs[:, i0 + d', i0:i1]``
    (None: no codes), ``final`` takes the cost of the pairs whose row la-1 is
    in the band. The tile mode's halos: ``left`` (N, rows) holds column -1's
    costs of the band's rows and ``corner`` (N,) the cell above-left of the
    band's first cell (None: BIG); ``origin`` makes the first cell the DP's
    origin (best = 0; default: the first band); ``right`` (N, rows), where
    given, takes the last column's costs. Returns the band's last row's
    costs (N, Tb)."""
    n, ta, tb = C.shape
    rows = i1 - i0
    dev = C.device
    origin = i0 == 0 if origin is None else origin
    if corner is not None:
        corner = corner.reshape(-1)[:1].expand(n)
    la_band = lens[:, 0].long() - i0
    has_end = (la_band >= 1) & (la_band <= rows)
    la = la_band.clamp(0, rows)
    lb = lens[:, 1].long()
    i_idx = torch.arange(rows, device=dev)
    ar = torch.arange(n, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    rows_ok = i_idx[None, :] < la[:, None]
    end_d = la_band + lb - 2
    Cb = C[:, i0:i1]
    prev = torch.full((n, rows), BIG, dtype=torch.float32, device=dev)
    prev2 = prev.clone()
    big_col = torch.full((n, 1), BIG, dtype=torch.float32, device=dev)
    corner_col = big_col if corner is None else corner.reshape(n, 1)
    if left is not None:
        # row i's column -1 and row i-1's (the diag of column 0), BIG above
        left_dg = torch.cat([corner_col, left[:, :-1]], dim=1)
    last = torch.full((n, tb), BIG, dtype=torch.float32, device=dev)
    for d in range(_band_diagonals(ta, tb, i0, i1)):
        j = d - i_idx
        c = Cb[:, i_idx, j.clamp(0, tb - 1)]
        c = torch.where((j >= 0)[None, :] & (j[None, :] < lb[:, None]) & rows_ok, c, big)
        left_n = torch.where((j >= 1)[None, :], prev, big)
        # row i0-1 at the step before (up, column d) and the one before that (diag)
        up_head = top[:, d:d + 1] if top is not None and d < tb else big_col
        dg_head = (top[:, d - 1:d] if top is not None and 1 <= d <= tb
                   else corner_col if d == 0 else big_col)
        up = torch.cat([up_head, prev[:, :-1]], dim=1)
        dg = torch.where((j >= 1)[None, :], torch.cat([dg_head, prev2[:, :-1]], dim=1), big)
        if left is not None:
            at0 = (j == 0)[None, :]
            left_n = torch.where(at0, left, left_n)
            dg = torch.where(at0 & (i_idx >= 1)[None, :], left_dg, dg)
        if d == 0:
            dg[:, 0] = corner_col[:, 0]
        best = torch.minimum(torch.minimum(dg, up), left_n)
        choice = torch.where(best == dg, 0, torch.where(best == up, 1, 2))
        if d == 0 and origin:
            best[:, 0] = 0.0
        new = torch.clamp(c + torch.clamp(best, max=BIG), max=BIG)
        new = torch.where((j >= 0)[None, :], new, big)
        if dirs is not None:
            dirs[:, i0 + d, i0:i1] = choice.to(torch.int8)
        final.copy_(torch.where(has_end & (end_d == d), new[ar, (la - 1).clamp(min=0)], final))
        if 0 <= d - (rows - 1) < tb:
            last[:, d - (rows - 1)] = new[:, rows - 1]
        if right is not None and 0 <= d - (tb - 1) < rows:
            right[:, d - (tb - 1)] = new[:, d - (tb - 1)]
        prev2, prev = prev, new
    return last


def dtw_wavefront_plain(C: torch.Tensor, lens: torch.Tensor, band_rows: int | None = None):
    """Plain twin of the wavefront kernel: one vectorised step per diagonal.

    C: (N, Ta, Tb) f32 pairwise costs; lens: (N, 2) int32 [len_a, len_b].
    Returns (raw cost (N,) f32, dirs (N, Ta+Tb-1, Ta) int8). ``band_rows``
    sweeps the rows in bands of that many, as the kernel does past
    ``MAX_TA`` rows (default: one band of every row); the result is the
    same to the byte."""
    n, ta, tb = C.shape
    bands = [(0, ta)] if band_rows is None else row_bands(ta, band_rows)
    alloc = torch.zeros if len(bands) > 1 else torch.empty
    dirs = alloc((n, ta + tb - 1, ta), dtype=torch.int8, device=C.device)
    final = torch.full((n,), BIG, dtype=torch.float32, device=C.device)
    top = None
    for i0, i1 in bands:
        top = _plain_band(C, lens, i0, i1, top, dirs, final)
    return final, dirs


def dtw_wavefront(C: torch.Tensor, lens: torch.Tensor, lens_host=None, *,
                  band_rows: int = MAX_TA):
    """Batched wavefront DP; same contract as :func:`dtw_wavefront_plain`.
    ``lens_host``: the caller's host copy of ``lens`` for the range check
    (:func:`_check_lens`), which spares the launch a device sync.

    On a CUDA tensor this launches ``evc_dtw_wavefront`` once a row band of
    at most ``band_rows`` rows (one band up to ``MAX_TA`` rows by default),
    in order, each with the :func:`dtw_wavefront_plan` of its rows on this
    card, and counts each launch in ``dtw_wavefront.launches``. Several
    bands zero the codes first (a band writes only its own rows' diagonals
    up to column Tb) and hand each band's last row to the next through a
    buffer. The C entry refuses a plan that does not cover the band, and
    the call raises. A CPU tensor takes the twin with the same bands."""
    if C.device.type == "cpu":
        return dtw_wavefront_plain(C, lens, band_rows)
    if C.device.type != "cuda":
        raise ValueError(f"dtw_wavefront: unsupported device {C.device}")
    if C.dtype != torch.float32 or C.dim() != 3 or not C.is_contiguous():
        raise ValueError(f"C must be contiguous float32 (N, Ta, Tb), got "
                         f"{C.dtype} {tuple(C.shape)}")
    n, ta, tb = C.shape
    bands = row_bands(ta, band_rows)
    _check_lens(lens, n, ta, tb, C.device, lens_host)
    n_sms = torch.cuda.get_device_properties(C.device).multi_processor_count
    lib = load_library("dtw_wavefront")
    fn = lib.evc_dtw_wavefront
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 6, ctypes.c_void_p,
                   ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    cost = torch.empty((n,), dtype=torch.float32, device=C.device)
    alloc = torch.zeros if len(bands) > 1 else torch.empty
    dirs = alloc((n, ta + tb - 1, ta), dtype=torch.int8, device=C.device)
    # the rows handed between bands: 16-byte aligned rows of tb + 4 floats at
    # least, BIG past column tb
    bstride = -(-(tb + 4) // 16) * 16
    edges = (torch.full((2, n, bstride), BIG, dtype=torch.float32, device=C.device)
             if len(bands) > 1 else None)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        for b, (i0, i1) in enumerate(bands):
            plan = dtw_wavefront_plan(n, i1 - i0, n_sms)
            b_in = edges[b % 2].data_ptr() if b > 0 else None
            b_out = edges[(b + 1) % 2].data_ptr() if b + 1 < len(bands) else None
            code = fn(C.data_ptr(), lens.data_ptr(), n, ta, tb, i0, i1 - i0,
                      _band_diagonals(ta, tb, i0, i1), b_in, b_out, bstride,
                      plan["rows_per_lane"], plan["cluster"], plan["warps_per_cta"],
                      cost.data_ptr(), dirs.data_ptr(), stream)
            check(code, "dtw_wavefront", lib)
            dtw_wavefront.launches += 1
    return cost, dirs


dtw_wavefront.launches = 0


# ---------------------------------------------------------------------------
# one tile of a longer DP: the wavefront's tile mode
# ---------------------------------------------------------------------------

def tile_codes(skewed: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The (rows, cols) codes of a tile, a view of its skewed (rows+cols-1,
    rows) layout: code (i, j) sits at diagonal i + j, position i."""
    return skewed.as_strided((rows, cols), (rows + 1, rows), skewed.storage_offset())


def _check_tile(C, top, corner, left) -> tuple[int, int]:
    if C.dtype != torch.float32 or C.dim() != 2 or C.stride(1) != 1:
        raise ValueError(f"C must be a float32 (rows, cols) window with unit column stride, "
                         f"got {C.dtype} {tuple(C.shape)} strides {C.stride()}")
    rows, cols = C.shape
    for name, t, n in (("top", top, cols), ("corner", corner, 1), ("left", left, rows)):
        if t is not None and (t.dtype != torch.float32 or t.dim() != 1 or t.numel() < n
                              or not t.is_contiguous() or t.device != C.device):
            raise ValueError(f"{name} must be a contiguous float32 vector of >= {n} on "
                             f"{C.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return rows, cols


def dtw_tile_plain(C: torch.Tensor, top=None, corner=None, left=None, origin: bool = False,
                   codes: bool = True):
    """Plain twin of the wavefront's tile mode: the DP over one (rows, cols)
    window C of a longer cost matrix, with its halos.

    ``top``: the costs of the row above the window (its first ``cols``
    values are read); ``corner``: one value, the cell above-left; ``left``
    (rows,): the column left of the window; each None means BIG (the
    matrix's edge). ``origin``: the window's first cell is the DP's origin.
    Returns (bottom row (cols,), right column (rows,), codes (rows, cols)
    int8 or None with ``codes=False``). The same cells, neighbours and
    arithmetic as one sweep, so tiles in a wavefront schedule give the
    sweep's costs and codes to the byte."""
    rows, cols = _check_tile(C, top, corner, left)
    dev = C.device
    lens = torch.tensor([[rows, cols]], dtype=torch.int32, device=dev)
    dirs = (torch.empty((1, rows + cols - 1, rows), dtype=torch.int8, device=dev)
            if codes else None)
    final = torch.full((1,), BIG, dtype=torch.float32, device=dev)
    right = torch.full((1, rows), BIG, dtype=torch.float32, device=dev)
    bottom = _plain_band(C[None], lens, 0, rows, None if top is None else top[None, :cols],
                         dirs, final, left=None if left is None else left[None],
                         corner=corner, origin=origin, right=right)
    return bottom[0], right[0], (tile_codes(dirs[0], rows, cols) if codes else None)


def dtw_tile(C: torch.Tensor, top=None, corner=None, left=None, origin: bool = False,
             codes: bool = True):
    """The wavefront's tile mode; same contract as :func:`dtw_tile_plain`.

    On a CUDA tensor this launches ``evc_dtw_tile`` (counted in
    ``dtw_tile.launches``): ``dtw_wavefront_kernel``'s tile variant, one
    pair of ``rows`` rows with the :func:`dtw_wavefront_plan` of its rows,
    C read at its row stride, the left halo read by each row's lane, the
    bottom row and the right column written out; ``codes=False`` runs the
    variant that stores no codes. ``top`` must then hold ``cols`` + 3
    readable floats (the kernel reads it in 16-byte blocks; the values past
    ``cols`` are not used) and start 16-byte aligned. A launch the C entry
    refuses raises. A CPU tensor takes the twin."""
    if C.device.type == "cpu":
        return dtw_tile_plain(C, top, corner, left, origin, codes)
    if C.device.type != "cuda":
        raise ValueError(f"dtw_tile: unsupported device {C.device}")
    rows, cols = _check_tile(C, top, corner, left)
    if rows > MAX_TA:
        raise ValueError(f"dtw_tile: {rows} rows > {MAX_TA}")
    if top is not None and (top.numel() < cols + 3 or top.data_ptr() % 16):
        raise ValueError(f"dtw_tile: top needs {cols + 3} floats from a 16-byte boundary")
    plan = dtw_wavefront_plan(1, rows, torch.cuda.get_device_properties(C.device)
                              .multi_processor_count)
    lib = load_library("dtw_wavefront")
    fn = lib.evc_dtw_tile
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, ci, vp, vp, vp, ci, vp, vp, ci, ci, ci, vp, vp]
    bottom = torch.empty((cols,), dtype=torch.float32, device=C.device)
    right = torch.empty((rows,), dtype=torch.float32, device=C.device)
    dirs = (torch.empty((rows + cols - 1, rows), dtype=torch.int8, device=C.device)
            if codes else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        code = fn(C.data_ptr(), C.stride(0), rows, cols, ptr(top), ptr(corner), ptr(left),
                  int(origin), bottom.data_ptr(), right.data_ptr(), plan["rows_per_lane"],
                  plan["cluster"], plan["warps_per_cta"], ptr(dirs), stream)
    check(code, "dtw_tile", lib)
    dtw_tile.launches += 1
    return bottom, right, (tile_codes(dirs, rows, cols) if codes else None)


dtw_tile.launches = 0


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


def dtw_backtrace(dirs: torch.Tensor, lens: torch.Tensor, lens_host=None):
    """Backtrace; same contract as :func:`dtw_backtrace_plain`. On a CUDA
    tensor this launches ``evc_dtw_backtrace`` (one CTA a pair, the codes
    staged in shared-memory windows, one walk) and counts the launch in
    ``dtw_backtrace.launches``. ``lens_host`` as in :func:`dtw_wavefront`."""
    if dirs.device.type == "cpu":
        return dtw_backtrace_plain(dirs, lens)
    if dirs.device.type != "cuda":
        raise ValueError(f"dtw_backtrace: unsupported device {dirs.device}")
    if dirs.dtype != torch.int8 or dirs.dim() != 3 or not dirs.is_contiguous():
        raise ValueError(f"dirs must be contiguous int8 (N, Ta+Tb-1, Ta), got "
                         f"{dirs.dtype} {tuple(dirs.shape)}")
    n, max_path, ta = dirs.shape
    tb = max_path - ta + 1
    _check_lens(lens, n, ta, tb, dirs.device, lens_host)
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
