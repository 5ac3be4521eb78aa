// Fast Griffin-Lim on Hopper with all n_iter iterations in one launch.
//
// Replaces: exemplars_vc_tpu/dsp/griffin_lim_pallas.py:gl_pallas_angles
// (entered through gl_angles_fused) with center = 0, and the centered loop
// of exemplars_vc_tpu/dsp/griffin_lim.py with center = 1. Per iteration, for
// every frame t:
//
//   s        = mag * angles
//   frame_t  = window * irfft(s)                         (n_fft real)
//   y        = overlap-add of the frames * 1/window-sum  (NOLA)
//   p        = y (center = 0), or y trimmed by n_fft/2 at both ends and
//              reflect-padded back (center = 1: stft(istft(s)) of
//              dsp/stft.py): p[g] = y[n_fft - g] for g < n_fft/2, and the
//              mirror at the tail; every other sample is y's
//   rebuilt  = rfft(window * p[t*hop : t*hop + n_fft])
//   t        = rebuilt - mom * prev;  prev = rebuilt;  mom = mu / (1 + mu)
//   angles   = t / max(|t|, 1e-16)
//
// The plain twin (dsp/griffin_lim_cuda.py) computes the transforms as the
// reference's DFT table products; this kernel computes them as FFTs.
//
// Design. One CTA owns a tile of `tile` consecutive frames (the plan,
// gl_fused_plan, takes the smallest tile that leaves one CTA an SM: 6 at
// F = 688 on 132 SMs) and keeps, for all iterations, in shared memory: the
// tile's magnitudes and momentum state, the twiddle tables and windows, and
// two ping-pong buffers of its transforms. A frame's real n_fft-point
// transform is one complex M-point FFT, M = n_fft / 2 (n_fft even: samples
// 2j and 2j + 1 are the real and imaginary parts, split after the forward
// transform and joined before the inverse with the twiddles e^{-2 pi i k /
// n_fft}), or M = n_fft with a zero imaginary part (n_fft odd). The FFT is a
// mixed-radix Stockham autosort pass per radix of fft_radices(M) (200 = 5 *
// 5 * 8 at n_fft 400), each butterfly in registers between two shared
// buffers; a prime factor above 5 is a direct DFT pass. The inverse is the
// forward FFT of the conjugate, conjugated: 1/n_fft is folded into the
// synthesis window, irfft's bin weights come from the Hermitian extension,
// and the imaginary parts of DC and Nyquist are dropped, as irfft drops
// them. Each frame is transformed alone, so a silent frame stays exactly
// zero (two frames packed into one transform leak ~1e-7 of the louder into
// it, which the 1/window-sum amplifies at the signal's ends).
//
// Precision: the twiddles and windows are built in float64 on the host and
// rounded once to float32, as the twin's bases are; the arithmetic inside
// the kernel (transforms, overlap-add, momentum, the frames it exchanges) is
// float64, and the angles leave as float32. The kernel is bound by latency,
// not by its operations, and float32 arithmetic along the FFT's passes
// failed the twin's accuracy gate (mean phase error against the float64
// twin at most twice the float32 twin's) at small shapes in a numpy model of
// this kernel (tests/test_torch_gl_plan.py), where a bin that nearly cancels
// carries a different rounding.
//
// Only the overlap-add crosses CTAs: each CTA writes its windowed frames to
// a global buffer (double-buffered by iteration parity) and reads, with
// __ldcg (L2, never a stale L1 line), the frames that overlap the samples
// its segment takes: its own and r - 1 = n_fft/hop - 1 on each side. With
// center = 1 the CTAs of the first and last frames take their outer n_fft/2
// samples from the mirrored positions: the overlap-add there sums frames up
// to n_fft/hop away (frame 0 reads y[n_fft]), beyond those neighbours when
// the tile is small, and each CTA sums them itself from the global buffer
// after the grid sync, in the same order as for an interior sample. The
// 1/window-sum of each sample is computed once, at the start, in float64
// from the float32 window, frames in ascending order, as _inv_wsum builds
// it on the host: the same bits, and nothing to upload for a new F. The
// iteration
// barrier is one grid sync (a cooperative launch; a grid larger than the
// co-resident CTAs is refused before launch). A neighbour hand-off, each CTA
// waiting with ld.acquire.gpu polls only for the tiles whose frames overlap
// its segment (step tags published with st.release.gpu), measured the same
// (PERF.md, PR 6): the barrier is not where the iteration's time goes.
//
// Determinism: a frame's arithmetic does not depend on the tile (the
// overlap-add sums frames in ascending order from the one global buffer),
// so two plans give equal bits.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): not bytes and
// not operations (an inverse and a forward real FFT a frame and iteration,
// ~0.066 ms for 300 iterations at 688 x 201, n_fft 400, at the fp32 rate)
// but one SM's throughput on its tile: one CTA an SM runs every step of an
// iteration in turn, with 5-16 of its warps busy. Taking parts out of the
// kernel (tools/gl_probe_torch.py) put the six FFT passes at ~40 % of the
// time, the frame store and the overlap-add's loads through L2 at ~27 %, the
// grid sync at ~12 % and the spectrum pass at ~7 %: each pass moves every
// value through shared memory twice in float64 and waits on float64
// latency. PERF.md has the numbers.
//
// Build: plain nvcc, no -rdc. Since CUDA 11 the grid barrier of
// cooperative_groups::this_grid().sync() is implemented in the header and
// needs no relocatable device code; the launch must be cooperative.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define EVC_GL_MAX_THREADS 512
#define EVC_GL_MAX_STAGES 24
#define EVC_GL_SMEM_LIMIT 232448
#define EVC_GL_OLA_LOADS 8     // overlapping frames whose samples are loaded at once
#define EVC_GL_MAX_INDEX (1 << 22)   // gl_div is exact below this

struct GlSched {
  int n;                            // passes
  int radix[EVC_GL_MAX_STAGES];
};

// One CTA's shared memory (griffin_lim_cuda._smem_bytes mirrors it).
struct GlSmem {
  double2 *buf0, *buf1;  // [tile][M]: the frames' transforms, ping-pong
  double2 *tw, *rtw;     // [n_tw]: M-point twiddles, then each pass's roots;
                         // [n_rtw]: e^{-2 pi i k / n_fft}, k <= M (n_fft even)
  double2* prev;         // [tile][bins]: momentum state
  double* seg;           // [(tile-1)*hop + n]: the tile's signal
  float *mag, *ws, *wa;  // [tile][bins]; [n] window / n_fft; [n] window
  float* iw;             // [(tile-1)*hop + n]: 1/window-sum of the segment
};

static size_t gl_smem_bytes(int tile, int n, int hop, int n_tw) {
  const size_t bins = (size_t)n / 2 + 1, seg = (size_t)(tile - 1) * hop + n;
  const size_t m = n % 2 ? n : n / 2, n_rtw = n % 2 ? 0 : m + 1;
  return 16 * (2 * (size_t)tile * m + n_tw + n_rtw + tile * bins) + 8 * seg +
         4 * (tile * bins + 2 * (size_t)n + seg);
}

__device__ __forceinline__ GlSmem gl_carve(float4* base, int tile, int n, int hop, int n_tw) {
  GlSmem s;
  const int bins = n / 2 + 1, m = n % 2 ? n : n / 2, n_rtw = n % 2 ? 0 : m + 1;
  const int seg = (tile - 1) * hop + n;
  s.buf0 = reinterpret_cast<double2*>(base);
  s.buf1 = s.buf0 + tile * m;
  s.tw = s.buf1 + tile * m;
  s.rtw = s.tw + n_tw;
  s.prev = s.rtw + n_rtw;
  s.seg = reinterpret_cast<double*>(s.prev + tile * bins);
  s.mag = reinterpret_cast<float*>(s.seg + seg);
  s.ws = s.mag + tile * bins;
  s.wa = s.ws + n;
  s.iw = s.wa + n;
  return s;
}

// The sample of the overlap-add that sample g of the framed signal takes
// (L = n + hop (F - 1) samples): itself, or with center its reflection in
// the first or last sample that the trim by pad = n/2 keeps.
__device__ __forceinline__ int gl_source(int g, int L, int pad, bool center) {
  if (!center) return g;
  if (g < pad) return 2 * pad - g;
  if (g >= L - pad) return 2 * (L - pad - 1) - g;
  return g;
}

// floor(a / d) for 0 <= a < EVC_GL_MAX_INDEX, given rcp = 1.0f / d: (a + 0.5)
// rcp is within (a + 0.5) / d * 2^-23 < 0.5 / d of (a + 0.5) / d, which is
// 0.5 / d from the nearest integer. A runtime integer division costs ~20
// dependent instructions, and every element loop and butterfly needs one.
__device__ __forceinline__ int gl_div(int a, float rcp) {
  return __float2int_rz(__fmaf_rn((float)a, rcp, 0.5f * rcp));
}

__device__ __forceinline__ double2 gl_cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ double2 gl_cmad(double2 a, double2 b, double2 c) {   // c + a * b
  return make_double2(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}

__device__ __forceinline__ double2 gl_add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 gl_sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// 4-point forward DFT of (a, b, c, d) in place.
__device__ __forceinline__ void gl_dft4(double2& a, double2& b, double2& c, double2& d) {
  const double2 t0 = gl_add(a, c), t1 = gl_sub(a, c), t2 = gl_add(b, d), t3 = gl_sub(b, d);
  a = gl_add(t0, t2);
  c = gl_sub(t0, t2);
  b = make_double2(t1.x + t3.y, t1.y - t3.x);   // t1 - i t3
  d = make_double2(t1.x - t3.y, t1.y + t3.x);   // t1 + i t3
}

// In-place R-point forward DFT of v; w holds the roots exp(-2 pi i q / R)
// (read only for R = 3 and 5).
template <int R>
__device__ __forceinline__ void gl_dft(double2 (&v)[R], const double2 (&w)[R]) {
  if constexpr (R == 2) {
    const double2 a = v[0], b = v[1];
    v[0] = gl_add(a, b);
    v[1] = gl_sub(a, b);
  } else if constexpr (R == 4) {
    gl_dft4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    // two 4-point DFTs of the even and odd inputs, joined by W8^q
    constexpr double h = 0.70710678118654752440;   // 1/sqrt(2)
    double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    gl_dft4(e0, e1, e2, e3);
    gl_dft4(o0, o1, o2, o3);
    o1 = make_double2(h * (o1.x + o1.y), h * (o1.y - o1.x));      // * (1 - i)/sqrt 2
    o2 = make_double2(o2.y, -o2.x);                                // * -i
    o3 = make_double2(h * (o3.y - o3.x), -h * (o3.x + o3.y));     // * (-1 - i)/sqrt 2
    v[0] = gl_add(e0, o0);
    v[4] = gl_sub(e0, o0);
    v[1] = gl_add(e1, o1);
    v[5] = gl_sub(e1, o1);
    v[2] = gl_add(e2, o2);
    v[6] = gl_sub(e2, o2);
    v[3] = gl_add(e3, o3);
    v[7] = gl_sub(e3, o3);
  } else {
    double2 out[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      double2 acc = v[0];
#pragma unroll
      for (int p = 1; p < R; ++p) {
        const int e = (p * q) % R;
        acc = e == 0 ? gl_add(acc, v[p]) : gl_cmad(v[p], w[e], acc);
      }
      out[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = out[q];
  }
}

// One Stockham pass of radix R over `count` m-point transforms, x -> y: the
// earlier passes span ns points; butterfly j reads x[j + r m/R], scales by
// the twiddle of (k = j mod ns, r) at tw[(r - 1) ns + k], and writes
// y[(j - k) R + k + q ns].
template <int R>
__device__ __forceinline__ void gl_stage(const double2* __restrict__ x, double2* __restrict__ y,
                                         const double2* tw, const double2* roots, int ns,
                                         int count, int m) {
  double2 w[R];
#pragma unroll
  for (int q = 0; q < R; ++q) w[q] = (R == 3 || R == 5) ? roots[q] : make_double2(1.0, 0.0);
  const int mr = m / R;
  const float rcp_mr = 1.0f / mr, rcp_ns = 1.0f / ns;
  for (int b = threadIdx.x; b < count * mr; b += blockDim.x) {
    const int f = gl_div(b, rcp_mr), j = b - f * mr, k = j - gl_div(j, rcp_ns) * ns;
    const double2* xf = x + f * m;
    double2 v[R];
    v[0] = xf[j];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = gl_cmul(xf[j + r * mr], tw[(r - 1) * ns + k]);
    gl_dft<R>(v, w);
    double2* yf = y + f * m + (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) yf[q * ns] = v[q];
  }
}

// The same pass for any other radix: one thread an output, a direct DFT.
__device__ __noinline__ void gl_stage_dft(const double2* __restrict__ x, double2* __restrict__ y,
                                          const double2* tw, const double2* roots, int R, int ns,
                                          int count, int m) {
  const int mr = m / R;
  for (int o = threadIdx.x; o < count * m; o += blockDim.x) {
    const int f = o / m, u = o - f * m;
    const int k = u % ns, q = (u / ns) % R, j = (u / (ns * R)) * ns + k;
    const double2* xf = x + f * m;
    double2 acc = xf[j];
    for (int r = 1; r < R; ++r)
      acc = gl_cmad(gl_cmul(xf[j + r * mr], tw[(r - 1) * ns + k]), roots[(r * q) % R], acc);
    y[o] = acc;
  }
}

// Forward FFT of `count` m-point transforms starting in x (y is scratch);
// returns the buffer that holds the result. Every pass ends in a
// __syncthreads.
__device__ double2* gl_fft(double2* x, double2* y, const GlSched& sc, const double2* tw,
                           int count, int m) {
  int ns = 1, off = 0, roff = m - 1;
  for (int s = 0; s < sc.n; ++s) {
    const int R = sc.radix[s];
    switch (R) {
      case 2: gl_stage<2>(x, y, tw + off, tw + roff, ns, count, m); break;
      case 3: gl_stage<3>(x, y, tw + off, tw + roff, ns, count, m); break;
      case 4: gl_stage<4>(x, y, tw + off, tw + roff, ns, count, m); break;
      case 5: gl_stage<5>(x, y, tw + off, tw + roff, ns, count, m); break;
      case 8: gl_stage<8>(x, y, tw + off, tw + roff, ns, count, m); break;
      default: gl_stage_dft(x, y, tw + off, tw + roff, R, ns, count, m);
    }
    __syncthreads();
    off += ns * (R - 1);
    roff += R;
    ns *= R;
    double2* t = x;
    x = y;
    y = t;
  }
  return x;
}

// n_fft even. Bin k of a real frame's spectrum from the M-point transform Z
// of its samples packed (2j, 2j + 1): with u = Z[k], v = Z[M - k],
// X[k] = E + W^k O, E = (u + conj v) / 2, O = (u - conj v) / 2i.
__device__ __forceinline__ double2 gl_unpack(double2 u, double2 v, double2 wk) {
  const double2 e = make_double2(0.5 * (u.x + v.x), 0.5 * (u.y - v.y));
  const double2 o = make_double2(0.5 * (u.y + v.y), 0.5 * (v.x - u.x));
  return gl_cmad(wk, o, e);
}

// n_fft even. The conjugate of the inverse transform's input at index k,
// from the spectrum's bins a = S[k], b = S[M - k]: E + i O with E = a +
// conj b, O = conj(W^k) (a - conj b); the 1/2 of both is in window / n_fft.
__device__ __forceinline__ double2 gl_pack(double2 a, double2 b, double2 wk) {
  const double2 e = make_double2(a.x + b.x, a.y - b.y);
  const double2 d = make_double2(a.x - b.x, a.y + b.y);
  const double2 o = make_double2(fma(wk.x, d.x, wk.y * d.y), fma(wk.x, d.y, -wk.y * d.x));
  return make_double2(e.x - o.y, -(e.y + o.x));
}

// Momentum and unit-phase normalisation of one bin; returns mag * angle, the
// next iteration's spectrum, and writes the angle on the last iteration.
__device__ __forceinline__ double2 gl_update(double2 x, double2* prev, const float* mag, int idx,
                                             double mom, float2* out) {
  const double2 pv = prev[idx];
  const double tx = x.x - mom * pv.x, ty = x.y - mom * pv.y;
  prev[idx] = x;
  // 1 / max(|t|, 1e-16), one rsqrt in place of a sqrt and two divisions
  const double r = rsqrt(fmax(tx * tx + ty * ty, 1e-32));
  const double2 a = make_double2(tx * r, ty * r);
  if (out) *out = make_float2((float)a.x, (float)a.y);
  const double mg = mag[idx];
  return make_double2(mg * a.x, mg * a.y);
}

// One work item of the spectrum pass, for frame f of the tile: bins k and
// M - k (n_fft even, k <= M/2; k = 0 also takes Nyquist, M), or bin k
// (n_fft odd, k < bins). `z` is the frame's forward transform (null on the
// first pass, which reads angles0); the pass updates the state, writes the
// angles on the last iteration (`out` not null) and otherwise puts the
// inverse transform's input (the conjugate) into `nz`.
template <bool EVEN>
__device__ __forceinline__ void gl_spectrum(const double2* z, double2* nz, const GlSmem& s,
                                            const float2* ang0, float2* out, int f, int k,
                                            int n, int m, double mom) {
  const int row = f * (n / 2 + 1);
  if (EVEN) {
    const int k2 = k == 0 ? m : m - k;   // the partner bin
    const bool two = k2 != k;
    double2 a, b;
    if (z) {
      const double2 u = z[k], v = z[k == 0 ? 0 : m - k];
      a = gl_update(gl_unpack(u, v, s.rtw[k]), s.prev, s.mag, row + k, mom,
                    out ? out + row + k : nullptr);
      b = a;
      if (two)
        b = gl_update(gl_unpack(v, u, s.rtw[k2]), s.prev, s.mag, row + k2, mom,
                      out ? out + row + k2 : nullptr);
    } else {
      const float2 ga = ang0[row + k], gb = ang0[row + k2];
      const double ma = s.mag[row + k], mb = s.mag[row + k2];
      a = make_double2(ma * ga.x, ma * ga.y);
      b = make_double2(mb * gb.x, mb * gb.y);
    }
    if (out) return;
    if (k == 0) {   // DC and Nyquist are real
      a.y = 0.0;
      b.y = 0.0;
    }
    nz[k] = gl_pack(a, b, s.rtw[k]);
    if (k != 0 && two) nz[k2] = gl_pack(b, a, s.rtw[k2]);
  } else {
    double2 a;
    if (z) {
      a = gl_update(z[k], s.prev, s.mag, row + k, mom, out ? out + row + k : nullptr);
    } else {
      const float2 g = ang0[row + k];
      const double mg = s.mag[row + k];
      a = make_double2(mg * g.x, mg * g.y);
    }
    if (out) return;
    if (k == 0) {
      nz[0] = make_double2(a.x, 0.0);
    } else {
      nz[k] = make_double2(a.x, -a.y);
      nz[n - k] = a;
    }
  }
}

__global__ void __launch_bounds__(EVC_GL_MAX_THREADS)
    gl_fused_kernel(const float* __restrict__ mag_g, const float2* __restrict__ ang0,
                    float2* __restrict__ ang_out, double* frames,
                    const float* __restrict__ consts, int F, int n, int hop, int tile, int n_tw,
                    int n_iter, double mom, int center, const GlSched sc) {
  extern __shared__ float4 evc_gl_smem[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int bins = n / 2 + 1;
  const bool even = n % 2 == 0;
  const int m = even ? n / 2 : n, n_rtw = even ? m + 1 : 0;
  const int items = even ? m / 2 + 1 : bins;    // spectrum work items a frame
  const int t0 = blockIdx.x * tile, nt = min(tile, F - t0);
  const int seg_len = (nt - 1) * hop + n;
  const int sig_len = n + hop * (F - 1), pad = n / 2;
  const float rcp_m = 1.0f / m, rcp_items = 1.0f / items, rcp_hop = 1.0f / hop;
  const GlSmem s = gl_carve(evc_gl_smem, tile, n, hop, n_tw);
  const size_t base = (size_t)t0 * bins;
  const float2* ang0_t = ang0 + base;
  float2* out_t = ang_out + base;

  if (n_iter == 0) {
    for (int e = tid; e < nt * bins; e += nth) out_t[e] = ang0_t[e];
    return;
  }
  const float2* tw_g = reinterpret_cast<const float2*>(consts);
  for (int i = tid; i < n_tw + n_rtw; i += nth)   // tw and rtw are adjacent
    s.tw[i] = make_double2(tw_g[i].x, tw_g[i].y);
  const float* win_g = consts + 2 * (n_tw + n_rtw);
  for (int i = tid; i < n; i += nth) {
    s.ws[i] = win_g[i];
    s.wa[i] = win_g[n + i];
  }
  for (int e = tid; e < nt * bins; e += nth) {
    s.mag[e] = mag_g[base + e];
    s.prev[e] = make_double2(0.0, 0.0);
  }
  __syncthreads();
  // 1 / max(window-sum, 1e-8) at the sample each segment sample takes
  for (int i = tid; i < seg_len; i += nth) {
    const int g = gl_source(t0 * hop + i, sig_len, pad, center);
    const int lo = g >= n ? gl_div(g - n, rcp_hop) + 1 : 0;
    const int hi = min(F - 1, gl_div(g, rcp_hop));
    double wsum = 0.0;
    for (int t = lo; t <= hi; ++t) {
      const double w = s.wa[g - t * hop];
      wsum += w * w;
    }
    s.iw[i] = (float)(1.0 / fmax(wsum, 1e-8));
  }
  for (int e = tid; e < nt * items; e += nth) {   // the first spectra, mag * angles0
    const int f = gl_div(e, rcp_items);
    if (even)
      gl_spectrum<true>(nullptr, s.buf0 + f * m, s, ang0_t, nullptr, f, e - f * items, n, m, mom);
    else
      gl_spectrum<false>(nullptr, s.buf0 + f * m, s, ang0_t, nullptr, f, e - f * items, n, m,
                         mom);
  }
  __syncthreads();

  double2 *in = s.buf0, *other = s.buf1;
  for (int it = 0; it < n_iter; ++it) {
    // inverse transforms, times window / n_fft: sample 2j in the real part,
    // 2j + 1 in minus the imaginary part (n_fft odd: sample j, real part)
    const double2* z = gl_fft(in, other, sc, s.tw, nt, m);
    double* fr = frames + (size_t)(it & 1) * F * n;
    double* fr_t = fr + (size_t)t0 * n;
    for (int e = tid; e < nt * m; e += nth) {
      const int f = gl_div(e, rcp_m), j = e - f * m;
      const double2 w = z[e];
      if (even) {
        double* o = fr_t + (size_t)f * n + 2 * j;
        o[0] = s.ws[2 * j] * w.x;
        o[1] = s.ws[2 * j + 1] * -w.y;
      } else {
        fr_t[(size_t)f * n + j] = s.ws[j] * w.x;
      }
    }
    cg::this_grid().sync();   // every frame of this iteration is stored
    // overlap-add of the tile's segment, frames in ascending order; the
    // samples of up to EVC_GL_OLA_LOADS frames are loaded before the first
    // add, so a sample waits for one L2 round trip, not one a frame
    for (int i = tid; i < seg_len; i += nth) {
      const int g = gl_source(t0 * hop + i, sig_len, pad, center);
      const int lo = g >= n ? gl_div(g - n, rcp_hop) + 1 : 0;
      const int hi = min(F - 1, gl_div(g, rcp_hop));
      const double* src = fr + (size_t)lo * n + (g - lo * hop);   // next frame: + n - hop
      double v[EVC_GL_OLA_LOADS];
#pragma unroll
      for (int q = 0; q < EVC_GL_OLA_LOADS; ++q)
        v[q] = lo + q <= hi ? __ldcg(src + (size_t)q * (n - hop)) : 0.0;
      double y = v[0];
#pragma unroll
      for (int q = 1; q < EVC_GL_OLA_LOADS; ++q)
        if (lo + q <= hi) y += v[q];
      for (int t = lo + EVC_GL_OLA_LOADS; t <= hi; ++t)
        y += __ldcg(fr + (size_t)t * n + (g - t * hop));
      s.seg[i] = y * s.iw[i];
    }
    __syncthreads();
    // forward transforms of window * y, packed as the inverse unpacked
    for (int e = tid; e < nt * m; e += nth) {
      const int f = gl_div(e, rcp_m), j = e - f * m;
      const double* y = s.seg + f * hop;
      in[e] = even ? make_double2(s.wa[2 * j] * y[2 * j], s.wa[2 * j + 1] * y[2 * j + 1])
                   : make_double2(s.wa[j] * y[j], 0.0);
    }
    __syncthreads();
    const double2* U = gl_fft(in, other, sc, s.tw, nt, m);
    double2* nxt = U == in ? other : in;
    float2* out = it + 1 == n_iter ? out_t : nullptr;
    // spectra, momentum, normalisation, the next inverse transforms' input
    for (int e = tid; e < nt * items; e += nth) {
      const int f = gl_div(e, rcp_items), k = e - f * items;
      if (even)
        gl_spectrum<true>(U + f * m, nxt + f * m, s, nullptr, out, f, k, n, m, mom);
      else
        gl_spectrum<false>(U + f * m, nxt + f * m, s, nullptr, out, f, k, n, m, mom);
    }
    __syncthreads();
    other = nxt == s.buf0 ? s.buf1 : s.buf0;
    in = nxt;
  }
}

// n grid-wide barriers and nothing else: the barrier's latency floor.
__global__ void grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// CTAs of `threads` threads and `smem` bytes that fit on the card at once.
static int gl_resident(int threads, size_t smem, int* resident) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gl_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_fused_kernel, threads, smem);
  *resident = per_sm * sms;
  return (int)e;
}

extern "C" {

const char* evc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// What the card makes of a plan: the CTAs that fit at once and the dynamic
// shared memory of one CTA. Refuses (cudaErrorInvalidValue) a tile, thread
// count or shared-memory size that no launch can take.
int evc_gl_fused_resident(int tile, int n_fft, int hop, int n_tw, int threads, int* resident,
                          int* smem_bytes) {
  *resident = 0;
  *smem_bytes = 0;
  if (tile < 1 || n_fft < 2 || hop < 1 || n_fft % hop || n_tw < 0 || threads < 32 ||
      threads > EVC_GL_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gl_smem_bytes(tile, n_fft, hop, n_tw);
  if (smem > EVC_GL_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  return gl_resident(threads, smem, resident);
}

// mag (F, n_fft/2+1) f32 >= 0, ang0 and ang_out (F, n_fft/2+1) complex64,
// frames (at least 2 F n_fft) f64 scratch, consts (f32) = the M-point
// twiddles and roots (n_tw complex) ++ e^{-2 pi i k / n_fft}, k <= M (n_fft
// even) ++ window/n_fft ++ window. center 0 or 1; with 1 the trimmed signal,
// hop (F - 1) + n_fft - 2 (n_fft / 2) samples, must be longer than the
// reflect pad n_fft / 2. The plan: tile, threads (a multiple of 32) and the
// radix schedule, whose product is M (n_fft / 2, or n_fft when odd).
// Anything else is refused (cudaErrorInvalidValue), and a grid larger than
// the co-resident CTAs with cudaErrorCooperativeLaunchTooLarge, before
// anything is launched.
int evc_gl_fused(const float* mag, const void* ang0, void* ang_out, double* frames,
                 const float* consts, int F, int n_fft, int hop, int tile, int threads,
                 const int* radices, int n_stages, int n_iter, double mom, int center,
                 void* stream) {
  if (F < 1 || n_fft < 2 || hop < 1 || n_iter < 0 || n_stages < 0 ||
      n_stages > EVC_GL_MAX_STAGES || (center != 0 && center != 1) ||
      (long long)tile * n_fft >= EVC_GL_MAX_INDEX ||
      (long long)F * hop + n_fft >= EVC_GL_MAX_INDEX)
    return (int)cudaErrorInvalidValue;
  if (center && (long long)hop * (F - 1) + n_fft - 2 * (n_fft / 2) <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  GlSched sc;
  sc.n = n_stages;
  const int m = n_fft % 2 ? n_fft : n_fft / 2;
  long long prod = 1;
  int n_tw = m - 1;
  for (int s = 0; s < n_stages; ++s) {
    if (radices[s] < 2) return (int)cudaErrorInvalidValue;
    sc.radix[s] = radices[s];
    prod *= radices[s];
    n_tw += radices[s];
  }
  if (prod != m) return (int)cudaErrorInvalidValue;
  int resident = 0, smem = 0;
  const int e = evc_gl_fused_resident(tile, n_fft, hop, n_tw, threads, &resident, &smem);
  if (e != 0) return e;
  const int grid = (F + tile - 1) / tile;
  if (grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&mag, &ang0, &ang_out, &frames, &consts, &F, &n_fft,
                  &hop, &tile, &n_tw, &n_iter, &mom, &center, &sc};
  const cudaError_t le = cudaLaunchCooperativeKernel((const void*)gl_fused_kernel, dim3(grid),
                                                     dim3(threads), args, (size_t)smem,
                                                     (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int evc_grid_sync_probe(int grid, int n, void* stream) {
  void* args[] = {&n};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe_kernel, dim3(grid), dim3(256), args, 0,
      (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // extern "C"
