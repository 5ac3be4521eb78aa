"""The fused Griffin-Lim kernel's host side, checked on the CPU: its launch
plan (pure Python), its FFT's radix schedule and twiddle table, and a numpy
model of what the kernel computes with them.

The model runs the kernel's algorithm step for step, as the kernel does in
float64 arithmetic over float32 tables: a frame's real transform as one
complex M-point FFT (``transform_len``), the mixed-radix Stockham passes of
``fft_radices`` with the twiddles and roots of ``fft_tables``, the
real-transform twiddles and windows of ``kernel_consts``, overlap-add in
ascending frame order. Tolerances: one transform against ``np.fft``
(float64) within 1e-6 relative L2 (the float32 rounding of the tables,
~1e-7 measured); six iterations against the float32 twin within 1e-4
relative L2, and a mean phase error against the float64 twin at most twice
the float32 twin's (+ 1e-7): the card's gates (PERF.md §2). In float32
arithmetic this model failed the second gate at 13 × 32 (a bin of |X| ≈
0.002 carries another rounding), which is why the kernel computes in
float64."""

import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch.dsp import griffin_lim_cuda as glc
from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES

N_SMS = 132


def _stockham(x: np.ndarray, n: int) -> np.ndarray:
    """The kernel's forward FFT of the rows of x (complex128, (..., n))."""
    tw = glc.fft_tables(n).astype(np.complex128)
    off, roff, ns = 0, n - 1, 1
    for R in glc.fft_radices(n):
        m = n // R
        j = np.arange(m)
        k = j % ns
        v = [x[..., j]] + [x[..., j + r * m] * tw[off + (r - 1) * ns + k]
                           for r in range(1, R)]
        y = np.empty_like(x)
        for q in range(R):
            acc = v[0].copy()
            for p in range(1, R):
                acc = acc + v[p] * tw[roff + (p * q) % R]
            y[..., (j - k) * R + k + q * ns] = acc
        x = y
        off += ns * (R - 1)
        roff += R
        ns *= R
    return x


def _consts(n: int):
    """The kernel's real-transform twiddles and its two windows, sliced out
    of ``kernel_consts`` as the kernel slices them."""
    m = glc.transform_len(n)
    n_cplx = len(glc.fft_tables(m)) + (0 if n % 2 else m + 1)
    c = glc.kernel_consts(n, "hann")
    win = c[2 * n_cplx:].astype(np.float64)
    rtw = c[:2 * n_cplx].view(np.complex64)[len(glc.fft_tables(m)):].astype(np.complex128)
    return rtw, win[:n], win[n:]


def _inverse(S: np.ndarray, n: int) -> np.ndarray:
    """Windowed irfft of the rows of S as the kernel computes it: n even,
    the M-point transform of the conjugate of E + iO (gl_pack), sample 2j
    in its real part and 2j + 1 in minus its imaginary part; n odd, the
    Hermitian extension. DC and Nyquist are taken real."""
    m = glc.transform_len(n)
    rtw, ws, _ = _consts(n)
    S = S.astype(np.complex128)
    out = np.empty(S.shape[:-1] + (n,))
    if n % 2 == 0:
        k = np.arange(m)
        a, b = S[..., k].copy(), S[..., m - k].copy()
        a[..., 0], b[..., 0] = a[..., 0].real, b[..., 0].real
        o = np.conj(rtw[k]) * (a - np.conj(b))
        w = _stockham(np.conj(a + np.conj(b) + 1j * o), m)
        out[..., 0::2], out[..., 1::2] = ws[0::2] * w.real, ws[1::2] * -w.imag
    else:
        k = np.arange(1, n // 2 + 1)
        z = np.empty(S.shape[:-1] + (n,), np.complex128)
        z[..., 0] = S[..., 0].real
        z[..., k], z[..., n - k] = np.conj(S[..., k]), S[..., k]
        out[:] = ws * _stockham(z, n).real
    return out


def _forward(Y: np.ndarray, n: int) -> np.ndarray:
    """rfft of the windowed rows of Y as the kernel computes it: n even,
    samples packed (2j, 2j + 1) into one M-point transform Z, bin k =
    E + W^k O from Z[k] and Z[M − k] (gl_unpack); n odd, a zero imaginary
    part."""
    m = glc.transform_len(n)
    rtw, _, wa = _consts(n)
    if n % 2:
        return _stockham(wa * Y + 0j, n)[..., : n // 2 + 1]
    Z = _stockham(wa[0::2] * Y[..., 0::2] + 1j * (wa[1::2] * Y[..., 1::2]), m)
    k = np.arange(m + 1)
    u, v = Z[..., k % m], Z[..., (m - k) % m]
    e = 0.5 * (u.real + v.real) + 1j * (0.5 * (u.imag - v.imag))
    o = 0.5 * (u.imag + v.imag) + 1j * (0.5 * (v.real - u.real))
    return e + rtw * o


def _source(g: np.ndarray, L: int, pad: int, center: bool) -> np.ndarray:
    """The kernel's ``gl_source``: the overlap-add sample that sample g of
    the framed signal takes."""
    if not center:
        return g
    return np.where(g < pad, 2 * pad - g, np.where(g >= L - pad, 2 * (L - pad - 1) - g, g))


def _model_inv_wsum(F: int, n: int, hop: int, g: np.ndarray) -> np.ndarray:
    """1 / max(window-sum, 1e-8) at samples g as the kernel computes it at
    its start: float64 sums of the float32 analysis window's squares over
    the overlapping frames in ascending order, rounded once to float32."""
    _, _, wa = _consts(n)
    out = np.empty(len(g), np.float32)
    for i, gi in enumerate(g):
        lo = (gi - n) // hop + 1 if gi >= n else 0
        acc = 0.0
        for t in range(lo, min(F - 1, gi // hop) + 1):
            acc += wa[gi - t * hop] * wa[gi - t * hop]
        out[i] = np.float32(1.0 / max(acc, 1e-8))
    return out


def _model_gl(mag: np.ndarray, ang: np.ndarray, n: int, hop: int, n_iter: int,
              momentum: float, center: bool = False) -> np.ndarray:
    """The kernel's n_iter iterations in numpy; angles out as complex64.
    With ``center`` each framed sample takes the overlap-add and the
    1/window-sum at its ``_source``, as the kernel's segment loop does."""
    F, bins = mag.shape
    L = n + hop * (F - 1)
    src = _source(np.arange(L), L, n // 2, center)
    inv_w = _model_inv_wsum(F, n, hop, src).astype(np.float64)
    mom = momentum / (1.0 + momentum)
    mag = mag.astype(np.float64)
    S = mag * ang.astype(np.complex128)
    prev = np.zeros((F, bins), np.complex128)
    for _ in range(n_iter):
        frames = _inverse(S, n)
        y = np.zeros(n + hop * (F - 1))
        for t in range(F):
            y[t * hop: t * hop + n] += frames[t]
        y = y[src] * inv_w
        X = _forward(np.lib.stride_tricks.sliding_window_view(y, n)[::hop], n)
        t = X - mom * prev
        prev = X
        ang = t / np.maximum(np.abs(t), 1e-16)
        S = mag * ang
    return ang.astype(np.complex64)


def _exact_gl(mag: np.ndarray, ang: np.ndarray, n: int, hop: int, n_iter: int,
              momentum: float, center: bool) -> np.ndarray:
    """The iterations in float64 with float64 tables (np.fft over the
    float64 window): the yardstick where the float64 twin's float32 tables
    dominate its own error."""
    F, _ = mag.shape
    w = glc.get_window("hann", n, dtype=torch.float64).numpy()
    L = n + hop * (F - 1)
    src = _source(np.arange(L), L, n // 2, center)
    wsum = np.zeros(L)
    for t in range(F):
        wsum[t * hop: t * hop + n] += w * w
    inv_w = 1.0 / np.maximum(wsum, 1e-8)
    mom = momentum / (1.0 + momentum)
    mag = mag.astype(np.float64)
    ang = ang.astype(np.complex128)
    prev = np.zeros_like(ang)
    for _ in range(n_iter):
        frames = w * np.fft.irfft(mag * ang, n)
        y = np.zeros(L)
        for t in range(F):
            y[t * hop: t * hop + n] += frames[t]
        y = (y * inv_w)[src]
        X = np.fft.rfft(w * np.lib.stride_tricks.sliding_window_view(y, n)[::hop])
        t = X - mom * prev
        prev = X
        ang = t / np.maximum(np.abs(t), 1e-16)
    return ang


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n,want", [(200, (5, 5, 8)), (256, (4, 8, 8)), (24, (3, 8)),
                                    (16, (2, 8)), (32, (4, 8)), (22, (11, 2)), (101, (101,)),
                                    (45, (3, 3, 5)), (2, (2,)), (4, (4,)), (1, ()),
                                    (64, (8, 8)), (12, (3, 4))])
def test_radix_schedule_and_table_layout(n, want):
    assert glc.fft_radices(n) == want and int(np.prod(want)) == n
    tw = glc.fft_tables(n)
    assert tw.dtype == np.complex64 and len(tw) == n - 1 + sum(want)
    off, roff, ns = 0, n - 1, 1
    for R in want:        # each pass's twiddles, then each pass's roots
        r, k = np.arange(1, R)[:, None], np.arange(ns)[None, :]
        np.testing.assert_allclose(tw[off: off + ns * (R - 1)],
                                   np.exp(-2j * np.pi * k * r / (ns * R)).ravel(), atol=1e-7)
        np.testing.assert_allclose(tw[roff: roff + R], np.exp(-2j * np.pi * np.arange(R) / R),
                                   atol=1e-7)
        off, roff, ns = off + ns * (R - 1), roff + R, ns * R
    assert off == n - 1 and roff == len(tw)


@pytest.mark.parametrize("n", [32, 48, 64, 400, 512, 44, 45, 202])
def test_model_transforms_match_numpy(n):
    """The kernel's inverse (windowed irfft) and forward (rfft of a windowed
    signal) transforms, through the same schedule, tables and windows,
    against np.fft in float64: n even through the packed M = n/2 point
    transform (202: M = 101, a direct DFT pass), n odd (45) through the
    whole."""
    rng = np.random.default_rng(n)
    bins = n // 2 + 1
    win = glc.get_window("hann", n, dtype=torch.float64).numpy()
    S = rng.standard_normal((3, bins)) + 1j * rng.standard_normal((3, bins))
    assert _rel(_inverse(S, n), win * np.fft.irfft(S, n)) <= 1e-6
    y = rng.standard_normal((3, n))
    assert _rel(_forward(y, n), np.fft.rfft(win * y)) <= 1e-6


@pytest.mark.parametrize("F,n,hop", [(1, 32, 8), (13, 32, 8), (30, 48, 16), (12, 44, 11),
                                     (11, 45, 15), (40, 400, 80), (688, 400, 80)])
def test_kernel_window_sum_equals_inv_wsum(F, n, hop):
    """The kernel computes its 1/window-sum in place of reading
    ``_inv_wsum``: the same float32 bits at every sample."""
    L = n + hop * (F - 1)
    np.testing.assert_array_equal(_model_inv_wsum(F, n, hop, np.arange(L)),
                                  glc._inv_wsum(F, n, hop, "hann").reshape(-1))


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("F,n,hop", [(13, 32, 8), (30, 48, 16), (21, 64, 16), (12, 44, 11),
                                     (11, 45, 15), (40, 400, 80)])
def test_model_iterations_match_twin(F, n, hop, center):
    """Six fast-GL iterations of the model against the twin, under the
    card's gates, with silent (zero) frames at the start and in the
    middle; both projections. The mean phase error is also held against
    float64 iterations over float64 tables (``_exact_gl``): the model's at
    most twice the float32 twin's (+ 1e-7). At 13 × 32 the float64 twin is
    itself as far from those as the float32 twin (1.2e-6 with center: its
    float32 tables), so there the float64-twin gate holds for center=False
    only, as before, and the centered cases take the exact yardstick alone
    (read: model 4.0e-7, float32 twin 1.2e-6)."""
    rng = np.random.default_rng(F)
    bins = n // 2 + 1
    mag = np.abs(rng.standard_normal((F, bins))).astype(np.float32)
    mag[[0, F // 2]] = 0.0
    ang = np.exp(2j * np.pi * rng.random((F, bins))).astype(np.complex64)
    got = _model_gl(mag, ang, n, hop, 6, 0.9, center)
    ref = glc.gl_angles_fused_plain(torch.as_tensor(mag), torch.as_tensor(ang), n, hop, 6,
                                    0.9, center=center).numpy()
    ref64 = glc.gl_angles_fused_plain(torch.as_tensor(mag).double(),
                                      torch.as_tensor(ang).to(torch.complex128), n, hop, 6,
                                      0.9, center=center).numpy()
    assert _rel(got, ref) <= 1e-4
    if not center:
        assert np.abs(got - ref64).mean() <= 2 * np.abs(ref - ref64).mean() + 1e-7
    exact = _exact_gl(mag, ang, n, hop, 6, 0.9, center)
    assert np.abs(got - exact).mean() <= 2 * np.abs(ref - exact).mean() + 1e-7


@pytest.mark.parametrize("F,n_fft,hop,want", [
    (688, 400, 80, (6, 115, 512)), (13, 32, 8, (1, 13, 64)), (100, 64, 16, (1, 100, 64)),
    (300, 48, 16, (3, 100, 64)), (1, 400, 80, (1, 1, 128)), (2000, 400, 80, (16, 125, 512)),
    (688, 512, 128, (6, 115, 512)), (50, 202, 101, (1, 50, 128)), (30, 45, 15, (1, 30, 64)),
])
def test_plan_at_chosen_shapes(F, n_fft, hop, want):
    """(tile, grid, threads): the smallest tile that leaves at most one CTA
    an SM, and threads for the widest step over its frames (at most 512)."""
    plan = glc.gl_fused_plan(F, n_fft, hop, N_SMS)
    assert (plan["tile"], plan["grid"], plan["threads"]) == want
    assert plan["radices"] == glc.fft_radices(glc.transform_len(n_fft))


@pytest.mark.parametrize("F", [1, 2, 3, 131, 132, 133, 264, 265, 688, 1409])
@pytest.mark.parametrize("n_fft,hop", [(400, 80), (48, 16), (32, 8), (512, 256), (45, 15)])
def test_plan_covers_every_frame(F, n_fft, hop):
    plan = glc.gl_fused_plan(F, n_fft, hop, N_SMS)
    tile, grid = plan["tile"], plan["grid"]
    assert grid * tile >= F and (grid - 1) * tile < F   # every frame, no empty CTA
    assert grid <= N_SMS                                # one CTA an SM
    assert tile == 1 or -(-F // (tile - 1)) > N_SMS     # the smallest such tile
    assert plan["threads"] % 32 == 0 and 64 <= plan["threads"] <= glc.GL_MAX_THREADS
    assert plan["smem_bytes"] == glc._smem_bytes(tile, n_fft, hop) <= SMEM_LIMIT_BYTES


def test_plan_smem_layout_and_limits():
    # the main path's tile, float64: two buffers of 6 x 200 complex, 217
    # twiddles and roots, 201 real-transform twiddles, 6 x 201 complex
    # momentum state, a segment of 5 x 80 + 400 samples; float32: 6 x 201
    # magnitudes, two windows, the segment's 1/window-sum
    assert glc._smem_bytes(6, 400, 80) == 16 * (2 * 6 * 200 + 217 + 201 + 6 * 201) \
        + 8 * 800 + 4 * (6 * 201 + 800 + 800) == 82_008
    with pytest.raises(ValueError, match="shared memory"):
        glc.gl_fused_plan(40_000, 400, 80, N_SMS)
    with pytest.raises(ValueError, match="hop must divide"):
        glc.gl_fused_plan(688, 400, 96, N_SMS)


@pytest.mark.parametrize("n_fft,hop,ok", [(400, 80, True), (48, 16, True), (45, 9, True),
                                          (2048, 512, True), (2048, 1, True),
                                          (8192, 2048, False), (400, 96, False),
                                          (400, 0, False), (1, 1, False)])
def test_supports_any_factorisation_in_shared_memory(n_fft, hop, ok):
    assert glc.supports(688, n_fft, hop) is ok


def test_cpu_tensors_take_the_twin_whatever_the_plan():
    rng = np.random.default_rng(4)
    mag = torch.as_tensor(np.abs(rng.standard_normal((9, 17))).astype(np.float32))
    ang = torch.as_tensor(np.exp(2j * np.pi * rng.random((9, 17))).astype(np.complex64))
    before = glc.gl_angles_fused.launches
    got = glc.gl_angles_fused(mag, ang, 32, 8, 3, 0.9,
                              _plan=dict(glc.gl_fused_plan(9, 32, 8, N_SMS), tile=0))
    assert glc.gl_angles_fused.launches == before
    assert torch.equal(got, glc.gl_angles_fused_plain(mag, ang, 32, 8, 3, 0.9))
