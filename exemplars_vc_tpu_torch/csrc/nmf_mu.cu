// Fixed-dictionary Frobenius MU NMF on Hopper: the two kernels of one
// multiplicative update  H <- H * Num / ((H.A).A^T), and below them the
// same update as one kernel (nmf_fused_mu_kernel, the opt-in fused path).
//
// Replaces: exemplars_vc_tpu/factorize/nmf_pallas.py:nmf_activations_pallas,
// its kernels _recon_kernel (P = H.A, also the reconstruction of the error
// check) and _update_kernel (Den = P.A^T fused with H * Num / Den, where
// Den == 0 becomes sklearn's EPS).
//
//   nmf_recon:  P (F, D) = H (F, K) . A (K, D), K is the reduction axis.
//   nmf_update: out (F, K) = H * (Num / den), den = P (F, D) . A (K, D)^T + l1,
//               den == 0 -> EPS = 2.220446049250313e-16. out may be H itself
//               (the update runs in place): each element of H is read and
//               then written by the same thread, and by no other.
//
// What bounds it on this card: at the main path's F = 688, K = 7680,
// D = 201 each kernel is 2.1 GFLOP on 21 MB (H) to 63 MB (H, Num, out) of
// traffic, about 100 and 33 FLOP/byte: both are compute-bound in fp32.
// Parity is fp32 (TF32 off), so the tensor cores are out of reach; the
// design is a plain shared-memory-tiled SGEMM on the FMA pipes: 32 x 32
// output tiles, 32-deep reduction slices staged in padded shared memory
// (no bank conflicts on the transposed read), 256 threads computing 2 x 2
// outputs each, ragged edges masked in the loads and the stores (no padding
// of D to 256 or of K to a tile). The denominator never leaves registers:
// the epilogue of nmf_update applies the update directly. Known slow points
// left for later work: 2 x 2 register tiles make the inner loop
// shared-memory-bound, and nmf_recon has only 154 blocks at the main-path
// shape with a 7680-long serial reduction each.

#include <cuda_runtime.h>

#define EVC_TILE 32
#define EVC_THREADS 256
#define EVC_EPS 2.220446049250313e-16f

__global__ void nmf_recon_kernel(const float* __restrict__ H, const float* __restrict__ A,
                                 float* __restrict__ P, int F, int K, int D) {
  __shared__ float Hs[EVC_TILE][EVC_TILE + 1];  // [f][k]
  __shared__ float As[EVC_TILE][EVC_TILE + 1];  // [k][d]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * EVC_TILE;
  const int col0 = blockIdx.x * EVC_TILE;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < K; k0 += EVC_TILE) {
    for (int e = threadIdx.x; e < EVC_TILE * EVC_TILE; e += EVC_THREADS) {
      const int r = e / EVC_TILE, c = e % EVC_TILE;
      const int hf = row0 + r, hk = k0 + c;
      Hs[r][c] = (hf < F && hk < K) ? H[(size_t)hf * K + hk] : 0.f;
      const int ak = k0 + r, ad = col0 + c;
      As[r][c] = (ak < K && ad < D) ? A[(size_t)ak * D + ad] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EVC_TILE; ++kk) {
      const float h0 = Hs[ty][kk], h1 = Hs[ty + 16][kk];
      const float a0 = As[kk][tx], a1 = As[kk][tx + 16];
      acc[0][0] = fmaf(h0, a0, acc[0][0]);
      acc[0][1] = fmaf(h0, a1, acc[0][1]);
      acc[1][0] = fmaf(h1, a0, acc[1][0]);
      acc[1][1] = fmaf(h1, a1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = row0 + ty + 16 * r, d = col0 + tx + 16 * c;
      if (f < F && d < D) P[(size_t)f * D + d] = acc[r][c];
    }
  }
}

// H and out may alias (in-place update), so neither is __restrict__.
__global__ void nmf_update_kernel(const float* __restrict__ P, const float* __restrict__ A,
                                  const float* H, const float* __restrict__ Num,
                                  float* out, int F, int K, int D, float l1) {
  __shared__ float Ps[EVC_TILE][EVC_TILE + 1];  // [f][d]
  __shared__ float As[EVC_TILE][EVC_TILE + 1];  // [k][d]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * EVC_TILE;  // F
  const int col0 = blockIdx.x * EVC_TILE;  // K
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int d0 = 0; d0 < D; d0 += EVC_TILE) {
    for (int e = threadIdx.x; e < EVC_TILE * EVC_TILE; e += EVC_THREADS) {
      const int r = e / EVC_TILE, c = e % EVC_TILE;
      const int d = d0 + c;
      const int pf = row0 + r;
      Ps[r][c] = (pf < F && d < D) ? P[(size_t)pf * D + d] : 0.f;
      const int ak = col0 + r;
      As[r][c] = (ak < K && d < D) ? A[(size_t)ak * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < EVC_TILE; ++dd) {
      const float p0 = Ps[ty][dd], p1 = Ps[ty + 16][dd];
      const float a0 = As[tx][dd], a1 = As[tx + 16][dd];
      acc[0][0] = fmaf(p0, a0, acc[0][0]);
      acc[0][1] = fmaf(p0, a1, acc[0][1]);
      acc[1][0] = fmaf(p1, a0, acc[1][0]);
      acc[1][1] = fmaf(p1, a1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = row0 + ty + 16 * r, k = col0 + tx + 16 * c;
      if (f < F && k < K) {
        float den = acc[r][c] + l1;
        den = (den == 0.f) ? EVC_EPS : den;
        const size_t idx = (size_t)f * K + k;
        out[idx] = H[idx] * (Num[idx] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// One whole MU iteration in one kernel.
//
// Replaces: exemplars_vc_tpu/factorize/nmf_pallas.py:_fused_mu_call (the
// fused=True path of nmf_activations_pallas): out = H * Num / den with
// den = (H.A).A^T + l1, den == 0 -> EPS, and P = H.A never written to HBM.
//
// Design: one block of 256 threads per tile of EVC_FUSED_TF = 8 rows of F
// (86 blocks at F = 688). Phase 1: thread d accumulates P[f, d] for the 8
// rows over all of K, reading A[k, d] straight from global memory (a warp
// reads 32 consecutive columns; no thread shares an A value, so staging
// would buy nothing) and the 8 H values of row k from a staged chunk
// (two broadcast float4 reads), 8 FMAs per A load. Each 32-row chunk of K
// issues its 32 A loads and its H load into registers before the barrier,
// so a thread has 33 loads in flight rather than one. The P tile (D x 8,
// 6.4 KB at D = 201) stays in shared memory. Phase 2: thread t owns
// k = k0 + t of a 256-wide K chunk; the chunk of A is staged 32 columns at
// a time (stride 33, no bank conflicts; again all 32 loads of a thread are
// issued before the stores), P is read as broadcast float4s, and the
// epilogue applies + l1, the EPS guard and H * Num / den. out may be H (in
// place): a block reads and writes only its own rows, and each element of
// phase 2 is read, then written, by one thread. Ragged F, K and D edges are
// masked; nothing is padded. fp32 FMA, no TF32.
//
// What bounds it on this card: every block streams all of A twice per
// iteration (2 x 6.2 MB at K = 7680, D = 201, from L2) and does 2 x 8 x K x D
// FMAs on one SM, so at F = 688 only 86 of 132 SMs work, each with 8 warps,
// too few to hide the latency of its loads. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3, 700.00 W: 1.49 ms per iteration at F = 688,
// K = 7680, D = 201, against 0.81 ms for nmf_recon + nmf_update (builds of
// this file with one phase compiled out, same card: phase 1 alone 0.41 ms,
// phase 2 alone 0.70 ms). The Hopper lever for later
// work is a thread-block cluster that splits phase 1's K reduction across
// CTAs and sums the P tile through distributed shared memory, so more SMs
// share one F tile and A is read once per cluster.

#define EVC_FUSED_TF 8    // F rows per block
#define EVC_FUSED_TK 32   // K rows per phase-1 chunk: TK x TF = 256 H values
#define EVC_FUSED_DC 32   // D columns per staged A chunk (phase 2)
static_assert(EVC_FUSED_TK * EVC_FUSED_TF == EVC_THREADS, "one H value per thread");

static size_t fused_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * EVC_FUSED_TF + EVC_FUSED_TK * EVC_FUSED_TF +
                          (size_t)EVC_THREADS * (EVC_FUSED_DC + 1));
}

// H and out may alias (in-place update), so neither is __restrict__.
__global__ void __launch_bounds__(EVC_THREADS)
nmf_fused_mu_kernel(const float* H, const float* __restrict__ A,
                    const float* __restrict__ Num, float* out, int F, int K, int D,
                    float l1) {
  extern __shared__ float4 evc_smem4[];
  float* Ps = reinterpret_cast<float*>(evc_smem4);   // [D][TF]   P tile, d-major
  float* Hs = Ps + (size_t)D * EVC_FUSED_TF;         // [TK][TF]  H chunk, k-major
  float* As = Hs + EVC_FUSED_TK * EVC_FUSED_TF;      // [256][DC + 1] A chunk
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * EVC_FUSED_TF;
  const int nrows = min(EVC_FUSED_TF, F - row0);
  const int fh = tid / EVC_FUSED_TK, kh = tid % EVC_FUSED_TK;   // this thread's H value

  // ---- phase 1: P[f, d] = sum_k H[row0 + f, k] A[k, d] ----------------------
  for (int d0 = 0; d0 < D; d0 += EVC_THREADS) {
    const int d = d0 + tid;
    const bool d_ok = d < D;
    float acc[EVC_FUSED_TF];
#pragma unroll
    for (int f = 0; f < EVC_FUSED_TF; ++f) acc[f] = 0.f;
    for (int k0 = 0; k0 < K; k0 += EVC_FUSED_TK) {
      const float hv = (fh < nrows && k0 + kh < K) ? H[(size_t)(row0 + fh) * K + k0 + kh] : 0.f;
      float a[EVC_FUSED_TK];
#pragma unroll
      for (int j = 0; j < EVC_FUSED_TK; ++j)
        a[j] = (d_ok && k0 + j < K) ? __ldg(A + (size_t)(k0 + j) * D + d) : 0.f;
      __syncthreads();   // the previous chunk's H has been consumed
      Hs[kh * EVC_FUSED_TF + fh] = hv;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < EVC_FUSED_TK; ++j) {
        const float4 h0 = *reinterpret_cast<const float4*>(Hs + j * EVC_FUSED_TF);
        const float4 h1 = *reinterpret_cast<const float4*>(Hs + j * EVC_FUSED_TF + 4);
        acc[0] = fmaf(h0.x, a[j], acc[0]);
        acc[1] = fmaf(h0.y, a[j], acc[1]);
        acc[2] = fmaf(h0.z, a[j], acc[2]);
        acc[3] = fmaf(h0.w, a[j], acc[3]);
        acc[4] = fmaf(h1.x, a[j], acc[4]);
        acc[5] = fmaf(h1.y, a[j], acc[5]);
        acc[6] = fmaf(h1.z, a[j], acc[6]);
        acc[7] = fmaf(h1.w, a[j], acc[7]);
      }
    }
    if (d_ok) {
#pragma unroll
      for (int f = 0; f < EVC_FUSED_TF; ++f) Ps[d * EVC_FUSED_TF + f] = acc[f];
    }
  }

  // ---- phase 2: out = H * Num / (P.A^T + l1), per 256-wide K chunk ----------
  for (int k0 = 0; k0 < K; k0 += EVC_THREADS) {
    const int k = k0 + tid;
    float acc[EVC_FUSED_TF];
#pragma unroll
    for (int f = 0; f < EVC_FUSED_TF; ++f) acc[f] = 0.f;
    for (int dc = 0; dc < D; dc += EVC_FUSED_DC) {
      // element i of this thread: row k0 + tid / DC + 8 i, column dc + tid % DC
      float v[EVC_FUSED_DC];
#pragma unroll
      for (int i = 0; i < EVC_FUSED_DC; ++i) {
        const int ka = k0 + tid / EVC_FUSED_DC + i * (EVC_THREADS / EVC_FUSED_DC);
        const int da = dc + tid % EVC_FUSED_DC;
        v[i] = (ka < K && da < D) ? __ldg(A + (size_t)ka * D + da) : 0.f;
      }
      __syncthreads();   // P is complete / the previous A chunk has been consumed
#pragma unroll
      for (int i = 0; i < EVC_FUSED_DC; ++i) {
        const int kk = tid / EVC_FUSED_DC + i * (EVC_THREADS / EVC_FUSED_DC);
        As[kk * (EVC_FUSED_DC + 1) + tid % EVC_FUSED_DC] = v[i];
      }
      __syncthreads();
      const int dn = min(EVC_FUSED_DC, D - dc);
      const float* a_row = As + tid * (EVC_FUSED_DC + 1);
      const float* p = Ps + (size_t)dc * EVC_FUSED_TF;
      for (int dd = 0; dd < dn; ++dd) {
        const float a = a_row[dd];
        const float4 p0 = *reinterpret_cast<const float4*>(p + dd * EVC_FUSED_TF);
        const float4 p1 = *reinterpret_cast<const float4*>(p + dd * EVC_FUSED_TF + 4);
        acc[0] = fmaf(p0.x, a, acc[0]);
        acc[1] = fmaf(p0.y, a, acc[1]);
        acc[2] = fmaf(p0.z, a, acc[2]);
        acc[3] = fmaf(p0.w, a, acc[3]);
        acc[4] = fmaf(p1.x, a, acc[4]);
        acc[5] = fmaf(p1.y, a, acc[5]);
        acc[6] = fmaf(p1.z, a, acc[6]);
        acc[7] = fmaf(p1.w, a, acc[7]);
      }
    }
    if (k < K) {
#pragma unroll
      for (int f = 0; f < EVC_FUSED_TF; ++f) {
        if (f < nrows) {
          float den = acc[f] + l1;
          den = (den == 0.f) ? EVC_EPS : den;
          const size_t idx = (size_t)(row0 + f) * K + k;
          out[idx] = H[idx] * (Num[idx] / den);
        }
      }
    }
  }
}

extern "C" {

const char* evc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int evc_nmf_recon(const float* H, const float* A, float* P, int F, int K, int D,
                  void* stream) {
  const dim3 grid((D + EVC_TILE - 1) / EVC_TILE, (F + EVC_TILE - 1) / EVC_TILE);
  nmf_recon_kernel<<<grid, EVC_THREADS, 0, (cudaStream_t)stream>>>(H, A, P, F, K, D);
  return (int)cudaGetLastError();
}

int evc_nmf_update(const float* P, const float* A, const float* H, const float* Num,
                   float* out, int F, int K, int D, float l1, void* stream) {
  const dim3 grid((K + EVC_TILE - 1) / EVC_TILE, (F + EVC_TILE - 1) / EVC_TILE);
  nmf_update_kernel<<<grid, EVC_THREADS, 0, (cudaStream_t)stream>>>(P, A, H, Num, out,
                                                                   F, K, D, l1);
  return (int)cudaGetLastError();
}

int evc_nmf_fused_mu(const float* H, const float* A, const float* Num, float* out, int F,
                     int K, int D, float l1, void* stream) {
  const size_t smem = fused_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nmf_fused_mu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (F + EVC_FUSED_TF - 1) / EVC_FUSED_TF;
  nmf_fused_mu_kernel<<<grid, EVC_THREADS, smem, (cudaStream_t)stream>>>(H, A, Num, out, F,
                                                                          K, D, l1);
  return (int)cudaGetLastError();
}

}  // extern "C"
