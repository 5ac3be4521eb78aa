// Fast Griffin-Lim on Hopper with all n_iter iterations in one launch.
//
// Replaces: exemplars_vc_tpu/dsp/griffin_lim_pallas.py:gl_pallas_angles
// (entered through gl_angles_fused). Per iteration, for every frame t:
//
//   s        = mag * angles                              (re, im planes)
//   frame_t  = s_re . Bsyn_re + s_im . Bsyn_im            windowed irDFT
//   y        = overlap-add of the frames * 1/window-sum   center=False, NOLA
//   rebuilt  = y[t*hop : t*hop + n_fft] . (Bana_re, Bana_im)   windowed rDFT
//   t        = rebuilt - mom * prev;  prev = rebuilt;  mom = mu / (1 + mu)
//   angles   = t / max(|t|, 1e-16)
//
// Bsyn (bins x n_fft) and Bana (n_fft x bins) are the matmul-DFT bases of
// exemplars_vc_tpu/dsp/fft.py with the window folded in, built in
// dsp/griffin_lim_cuda.py. The state stays at F rows: the TPU kernel's
// F + r - 1 rows and circular rolls are a layout device, and its output
// rows [:F] are this acyclic projection.
//
// Design: a persistent cooperative launch (cudaLaunchCooperativeKernel).
// Each block owns tiles of EVC_GL_TF = 6 frames (115 tiles at F = 688, so
// one tile per SM on 132 SMs); the grid is min(tiles, co-resident blocks)
// and a block walks its tiles grid-stride. Phase A writes the block's
// windowed irDFT frames to a global frames buffer; one grid sync; phase B
// assembles each tile's signal segment y[t0*hop, (t0+TF-1)*hop + n_fft)
// from the <= r overlapping frames into shared memory, scales it by the
// NOLA normaliser, applies the windowed rDFT and the momentum and
// normalisation to the block's own rows of the phase state. The next phase
// A reads only those rows, so it needs no grid sync: the frames buffer is
// double-buffered by iteration parity, and the one grid sync per iteration
// (after phase A) also orders phase B of iteration i before phase A of
// iteration i + 2 rewrites its buffer. The DFTs are explicit fp32 FMA dot
// products: one thread per output column (n in phase A, bin in phase B)
// for the tile's 6 frames, the basis value read once from L2 and used 6 (x2)
// times, the tile's spectra and signal broadcast from shared memory. No
// cuFFT and no library call. The frames buffer is read with __ldcg (L2,
// never a stale L1 line) because other blocks write it.
//
// What bounds it on this card: the DFTs are 2 x 2 x F x bins x n_fft FMAs
// per iteration (0.44 GFLOP at F = 688, n_fft = 400), spread over ~115 SMs
// at one tile each; every block re-reads all four bases (1.3 MB, L2
// resident) per iteration; and one grid-wide barrier per iteration (300 at
// n_iter = 300) sets a latency floor. Everything fits in the 50 MB L2
// (bases 1.3 MB, state 4 x 0.55 MB, frames 2 x 1.1 MB). Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W: 300 iterations at
// 688 x 201 take 20.0 ms (~67 us each), of which 300 bare grid syncs take
// 0.35 ms; the bound is the L2 latency of the basis loads with only 8 warps
// per SM (unrolling them 4 -> 8 deep took 26.4 -> 20.5 ms). Later Hopper
// options: a CUDA graph of per-iteration kernels measured against this
// design; tensor cores only once a bf16 or TF32 opt-in exists (fp32 parity
// rules them out here).
//
// Build: plain nvcc, no -rdc. Since CUDA 11 the grid barrier of
// cooperative_groups::this_grid().sync() is implemented in the header and
// needs no relocatable device code; the launch must be cooperative.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define EVC_GL_THREADS 256
#define EVC_GL_TF 6   // frames per tile

static size_t gl_smem_bytes(int bins, int n_fft, int hop) {
  const size_t spec = sizeof(float2) * (size_t)bins * EVC_GL_TF;          // phase A
  const size_t seg = sizeof(float) * ((size_t)(EVC_GL_TF - 1) * hop + n_fft);  // phase B
  return spec > seg ? spec : seg;
}

__global__ void __launch_bounds__(EVC_GL_THREADS)
gl_fused_kernel(const float* __restrict__ mag, float* ang_re, float* ang_im, float* prev_re,
                float* prev_im, float* frames, const float* __restrict__ bsyn_re,
                const float* __restrict__ bsyn_im, const float* __restrict__ bana_re,
                const float* __restrict__ bana_im, const float* __restrict__ inv_w, int F,
                int bins, int n_fft, int hop, int n_iter, float mom) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 evc_smem4[];
  float2* spec = reinterpret_cast<float2*>(evc_smem4);   // [bins][TF] (re, im)
  float* seg = reinterpret_cast<float*>(evc_smem4);      // the tile's y segment
  const int tid = threadIdx.x;
  const int n_tiles = (F + EVC_GL_TF - 1) / EVC_GL_TF;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * EVC_GL_TF;
    const int nt = min(EVC_GL_TF, F - t0);
    for (int e = tid; e < nt * bins; e += EVC_GL_THREADS) {
      prev_re[(size_t)t0 * bins + e] = 0.f;
      prev_im[(size_t)t0 * bins + e] = 0.f;
    }
  }

  for (int it = 0; it < n_iter; ++it) {
    float* fr = frames + (size_t)(it & 1) * F * n_fft;

    // ---- phase A: windowed irDFT of mag * angles, the block's frames ------
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int t0 = tile * EVC_GL_TF;
      const int nt = min(EVC_GL_TF, F - t0);
      __syncthreads();   // spec/seg of the previous tile or phase consumed
      for (int e = tid; e < EVC_GL_TF * bins; e += EVC_GL_THREADS) {
        const int f = e / bins, b = e % bins;
        float2 s = make_float2(0.f, 0.f);
        if (f < nt) {
          const size_t idx = (size_t)(t0 + f) * bins + b;
          const float m = __ldg(mag + idx);
          s = make_float2(m * ang_re[idx], m * ang_im[idx]);
        }
        spec[b * EVC_GL_TF + f] = s;
      }
      __syncthreads();
      for (int n = tid; n < n_fft; n += EVC_GL_THREADS) {
        // re and im products in separate chains, as the twin's two matmuls
        float acc_re[EVC_GL_TF], acc_im[EVC_GL_TF];
#pragma unroll
        for (int f = 0; f < EVC_GL_TF; ++f) acc_re[f] = acc_im[f] = 0.f;
#pragma unroll 8
        for (int b = 0; b < bins; ++b) {
          const float cr = __ldg(bsyn_re + (size_t)b * n_fft + n);
          const float ci = __ldg(bsyn_im + (size_t)b * n_fft + n);
          const float4* s4 = reinterpret_cast<const float4*>(spec + b * EVC_GL_TF);
#pragma unroll
          for (int q = 0; q < EVC_GL_TF / 2; ++q) {
            const float4 s = s4[q];   // frames 2q and 2q + 1
            acc_re[2 * q] = fmaf(s.x, cr, acc_re[2 * q]);
            acc_im[2 * q] = fmaf(s.y, ci, acc_im[2 * q]);
            acc_re[2 * q + 1] = fmaf(s.z, cr, acc_re[2 * q + 1]);
            acc_im[2 * q + 1] = fmaf(s.w, ci, acc_im[2 * q + 1]);
          }
        }
#pragma unroll
        for (int f = 0; f < EVC_GL_TF; ++f)
          if (f < nt) fr[(size_t)(t0 + f) * n_fft + n] = acc_re[f] + acc_im[f];
      }
    }

    grid.sync();   // every frame of this iteration is written

    // ---- phase B: OLA + NOLA, windowed rDFT, momentum, normalisation -------
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int t0 = tile * EVC_GL_TF;
      const int nt = min(EVC_GL_TF, F - t0);
      const int s0 = t0 * hop;
      const int len = (nt - 1) * hop + n_fft;
      __syncthreads();
      for (int i = tid; i < len; i += EVC_GL_THREADS) {
        const int g = s0 + i;   // sample of the un-cropped OLA signal
        const int lo = g >= n_fft ? (g - n_fft) / hop + 1 : 0;
        const int hi = min(F - 1, g / hop);
        float y = 0.f;
        for (int t = lo; t <= hi; ++t) y += __ldcg(fr + (size_t)t * n_fft + (g - t * hop));
        seg[i] = y * __ldg(inv_w + g);
      }
      __syncthreads();
      for (int b = tid; b < bins; b += EVC_GL_THREADS) {
        float are[EVC_GL_TF], aim[EVC_GL_TF];
#pragma unroll
        for (int f = 0; f < EVC_GL_TF; ++f) are[f] = aim[f] = 0.f;
#pragma unroll 8
        for (int n = 0; n < n_fft; ++n) {
          const float cr = __ldg(bana_re + (size_t)n * bins + b);
          const float ci = __ldg(bana_im + (size_t)n * bins + b);
#pragma unroll
          for (int f = 0; f < EVC_GL_TF; ++f) {
            if (f < nt) {
              const float y = seg[f * hop + n];
              are[f] = fmaf(y, cr, are[f]);
              aim[f] = fmaf(y, ci, aim[f]);
            }
          }
        }
#pragma unroll
        for (int f = 0; f < EVC_GL_TF; ++f) {
          if (f < nt) {
            const size_t idx = (size_t)(t0 + f) * bins + b;
            const float tre = are[f] - mom * prev_re[idx];
            const float tim = aim[f] - mom * prev_im[idx];
            prev_re[idx] = are[f];
            prev_im[idx] = aim[f];
            const float norm = fmaxf(sqrtf(tre * tre + tim * tim), 1e-16f);
            ang_re[idx] = tre / norm;
            ang_im[idx] = tim / norm;
          }
        }
      }
    }
    // no grid sync here: the next phase A reads only this block's rows and
    // writes the other frames buffer
  }
}

// n grid-wide barriers and nothing else: the latency floor of the design.
__global__ void grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

static int gl_resident_blocks(size_t smem, int* resident) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(gl_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_fused_kernel,
                                                      EVC_GL_THREADS, smem);
  *resident = per_sm * sms;
  return (int)e;
}

extern "C" {

const char* evc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan for F frames: *grid blocks of which at most *resident fit
// on the card at once, and the dynamic shared memory in bytes.
int evc_gl_fused_plan(int F, int bins, int n_fft, int hop, int* grid, int* resident,
                      int* smem_bytes) {
  const size_t smem = gl_smem_bytes(bins, n_fft, hop);
  const int e = gl_resident_blocks(smem, resident);
  const int n_tiles = (F + EVC_GL_TF - 1) / EVC_GL_TF;
  *grid = n_tiles < *resident ? n_tiles : *resident;
  *smem_bytes = (int)smem;
  return e;
}

// grid_blocks = 0 takes the plan's grid; a larger grid than the co-resident
// count would deadlock at the first grid sync and is refused with
// cudaErrorCooperativeLaunchTooLarge before anything is launched.
int evc_gl_fused(const float* mag, float* ang_re, float* ang_im, float* prev_re,
                 float* prev_im, float* frames, const float* bsyn_re, const float* bsyn_im,
                 const float* bana_re, const float* bana_im, const float* inv_w, int F,
                 int bins, int n_fft, int hop, int n_iter, float mom, int grid_blocks,
                 void* stream) {
  int grid = 0, resident = 0, smem_i = 0;
  const int e = evc_gl_fused_plan(F, bins, n_fft, hop, &grid, &resident, &smem_i);
  if (e != 0) return e;
  if (grid_blocks > 0) grid = grid_blocks;
  if (resident < 1 || grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&mag,     &ang_re,  &ang_im,  &prev_re, &prev_im, &frames,
                  &bsyn_re, &bsyn_im, &bana_re, &bana_im, &inv_w,   &F,
                  &bins,    &n_fft,   &hop,     &n_iter,  &mom};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      (const void*)gl_fused_kernel, dim3(grid), dim3(EVC_GL_THREADS), args, (size_t)smem_i,
      (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int evc_grid_sync_probe(int grid, int n, void* stream) {
  void* args[] = {&n};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe_kernel, dim3(grid), dim3(EVC_GL_THREADS), args, 0,
      (cudaStream_t)stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // extern "C"
