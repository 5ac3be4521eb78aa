// Fixed-dictionary Frobenius MU NMF on Hopper: the two kernels of one
// multiplicative update  H <- H * Num / ((H.A).A^T), and below them the
// same update as one kernel (nmf_fused_mu_kernel, the opt-in fused path).
//
// Replaces: exemplars_vc_tpu/factorize/nmf_pallas.py:nmf_activations_pallas,
// its kernels _recon_kernel (P = H.A, also the reconstruction of the error
// check), _update_kernel (Den = P.A^T fused with H * Num / Den, where
// Den == 0 becomes sklearn's EPS) and _fused_mu_call (both in one kernel).
//
//   nmf_recon:  P (F, D) = H (F, K) . A (K, D), K is the reduction axis.
//   nmf_update: out (F, K) = H * (Num / den), den = P (F, D) . A (K, D)^T + l1,
//               den == 0 -> EPS = 2.220446049250313e-16. out may be H itself
//               (the update runs in place): each element of H is read and
//               then written by the same thread, and by no other.
//   nmf_fused_mu: nmf_update(nmf_recon(H, A), A, H, Num, l1) in one launch.
//
// What bounds them on this card: at the main path's F = 688, K = 7680,
// D = 201 a product is 2.1 GFLOP on 6 MB (A) to 63 MB (H, Num, out) of
// traffic, 33 FLOP/byte or more: compute-bound in fp32. Parity is fp32
// (TF32 off), so the tensor cores are out of reach and every kernel here
// runs on the FMA pipes.
//
// nmf_recon and nmf_fused_mu are split-K designs on thread-block clusters.
// The launch plan (factorize/nmf_cuda.py: nmf_recon_plan, nmf_mu_fused_plan)
// cuts K into `split` contiguous slices, one per CTA of a cluster of `split`
// CTAs (at most 8, the portable size). Each CTA accumulates its slice's
// partial tile in registers (ha_accumulate below: an 8 x 4 register tile a
// thread, float4 shared-memory reads, so each shared load feeds 8 or more
// FMAs, and a 4-deep ring of 4-byte cp.async copies, so three slices load
// while one computes: rows of A are 804 bytes at D = 201 and rows of H are
// not always 16-byte aligned, so 16-byte copies and TMA are out). Then the
// cluster sums the partials through distributed shared memory in rank
// order. No atomics: the output is bit-identical from run to run. Both
// kernels take their slices from the same plan function and accumulate
// through ha_accumulate, so P sums in the same order on both paths and the
// fused solve equals the two-kernel solve bit for bit.
//
// What bounds them now (NVIDIA H100 80GB HBM3, 700 W, 1980 MHz, F = 688,
// K = 7680, D = 201): first the FMA pipe. One 8-warp CTA alone on an SM
// sustains about 46 % of its fp32 FMA rate, and the D = 201 edge idles 55 of
// 256 columns. Then cluster placement: clusters of 5 to 8 CTAs at one CTA an
// SM fill only 102 to 120 of the 132 SMs at once, and a cluster of 6 is the
// worst fit (two waves, or two CTAs on one SM). The plans take a full
// portable cluster of 8 CTAs: 352 CTAs for nmf_recon, 176 for the fused
// kernel; a split of 5 (110 CTAs) was 5 % faster for nmf_recon and 25-30 %
// for the fused kernel.
//
// nmf_update has no split: K is its output axis and D = 201 a short
// reduction. A 64 x 128 (F x K) tile per CTA of 256 threads, each thread the
// same 8 x 4 register tile, both operands staged d-major by the same
// cp.async ring (ha_accumulate, its second operand read transposed), so a d
// step costs three float4 shared loads for 32 FMAs; at most 128 registers,
// so two CTAs share an SM and one's FMAs cover the other's epilogue and
// waits. The epilogue reads H and Num and writes out as float4 where K % 4
// == 0 and the pointers are 16-byte aligned (a warp's 8 lanes along K cover
// 128 contiguous bytes of a row), else element by element, with the same
// arithmetic. What bounds it now (same card): the FMA pipe, at about 42 %
// of the fp32 peak with two CTAs an SM (30 % with one), and at K = 7680 the
// last of three waves of 264 CTAs, half full.
//
// The C entries refuse, before launching, a plan that does not match the
// compiled tiling or cannot launch (cluster above 8, shared memory above
// the opt-in limit, no cluster or CTA that fits an SM), and return the
// cudaError_t; the Python wrappers raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace cg = cooperative_groups;

#define EVC_EPS 2.220446049250313e-16f

#define EVC_TM 8              // register tile: rows (F) of a thread
#define EVC_TN 4              // register tile: columns (D or K) of a thread
#define EVC_BK 16             // reduction depth of one staged slice
#define EVC_MAX_SPLIT 8       // portable cluster size
#define EVC_SMEM_LIMIT 232448 // dynamic shared memory one block may opt into
#define EVC_RECON_BM 32       // nmf_recon output tile (F x D)
#define EVC_RECON_BN 128
#define EVC_RECON_NS 4        // nmf_recon's cp.async ring depth
#define EVC_FUSED_BN 256      // fused: phase-1 column chunk, phase-2 K pass
#define EVC_FUSED_AS (EVC_FUSED_BN + 4)  // row stride of the d-major A stage
#define EVC_UPDATE_BM 64      // nmf_update output tile (F x K)
#define EVC_UPDATE_BN 128
#define EVC_UPDATE_NS 4       // nmf_update's cp.async ring depth
#define EVC_UPDATE_MINB 2     // nmf_update CTAs an SM (caps registers at 128)

// K slice bounds of the CTAs of one cluster: rank r reduces [b[r], b[r + 1])
struct EvcKSlices {
  int b[EVC_MAX_SPLIT + 1];
};

// The launch plan the Python wrapper computes (nmf_cuda._Plan mirrors it).
struct EvcPlan {
  int bm, bn;              // CTA tile: F rows x columns
  int threads;
  int stages;              // depth of the cp.async ring
  int split;               // CTAs per cluster, one K slice each
  int grid_x, grid_y, grid_z;
  int smem_bytes;          // dynamic shared memory
  int k_bounds[EVC_MAX_SPLIT + 1];
};

// ---------------------------------------------------------------------------
// P = H.A (F x K by K x D), one K slice of one tile: the shared accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero and reads nothing: the ragged edges
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of a reduction on an 8 x 4 register tile: acc[i][j] += x[i] y[j].
__device__ __forceinline__ void fma_tile(float (&acc)[EVC_TM][EVC_TN], const float4 x0,
                                         const float4 x1, const float4 y) {
  const float xs[EVC_TM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float ys[EVC_TN] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < EVC_TM; ++i) {
#pragma unroll
    for (int j = 0; j < EVC_TN; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
  }
}

// A BM x BN output tile on BM/8 x BN/4 threads; thread (ty, tx) owns rows
// ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3. A warp covers LY x LX threads
// (4 x 8 where the tile is tall enough), so a k step's float4 shared loads
// touch LY distinct X rows and LX distinct Y quads. YT: the second operand
// is stored transposed and staged through a padded stride (see
// ha_accumulate).
template <int BM, int BN, bool YT = false>
struct HaTile {
  static constexpr int NX = BN / EVC_TN;
  static constexpr int NY = BM / EVC_TM;
  static constexpr int NT = NX * NY;
  static constexpr int LY = NY % 4 == 0 ? 4 : (NY % 2 == 0 ? 2 : 1);
  static constexpr int LX = 32 / LY;
  static constexpr int HS = BM + 4;                // row stride of the k-major X stage
  static constexpr int AS = YT ? BN + 4 : BN;      // row stride of the k-major Y stage
  static constexpr int STAGE = EVC_BK * (HS + AS); // floats of one stage: X, then Y
  static_assert(BM % EVC_TM == 0 && BN % EVC_TN == 0, "whole register tiles");
  static_assert(NX % LX == 0 && NT % 32 == 0, "whole warps");
  static __device__ __forceinline__ void yx(int tid, int& ty, int& tx) {
    const int w = tid / 32, lane = tid % 32;
    ty = (w / (NX / LX)) * LY + lane / LX;
    tx = (w % (NX / LX)) * LX + lane % LX;
  }
};

// acc += X[row0 : row0 + BM, k_lo : k_hi] . Y[k_lo : k_hi, col0 : col0 + BN],
// every element summed with one fmaf per k in ascending k from acc's value.
// X is (F, K) row-major; Y is (K, C) row-major, or with YT its transpose
// (C, K) row-major (nmf_update's A^T). Rows >= F, k >= k_hi and columns >= C
// are staged as zeros, which leave the sums unchanged. Both operands are
// staged k-major, so a k step reads float4s; a transposed operand is
// gathered along k (a warp reads 16 consecutive k of two rows) into a stride
// of BN + 4. `stage` is a ring of NS stages (NS * STAGE floats): NS - 1
// slices are in flight while one computes, one barrier a slice. The function
// ends behind a barrier, so the caller may reuse the ring at once.
template <int BM, int BN, int NS, bool YT = false>
__device__ __forceinline__ void ha_accumulate(const float* X, const float* __restrict__ Y,
                                              int F, int K, int C, int row0, int col0, int k_lo,
                                              int k_hi, float* stage,
                                              float (&acc)[EVC_TM][EVC_TN]) {
  using T = HaTile<BM, BN, YT>;
  constexpr int NH = BM * EVC_BK, NA = BN * EVC_BK;
  const int tid = threadIdx.x;
  int ty, tx;
  T::yx(tid, ty, tx);
  const int n_steps = (k_hi - k_lo + EVC_BK - 1) / EVC_BK;
  auto load = [&](int buf, int k0) {
    float* Hs = stage + buf * T::STAGE;   // [BK][HS]: X transposed, k-major
    float* As = Hs + EVC_BK * T::HS;      // [BK][AS]
#pragma unroll
    for (int i = 0; i < (NH + T::NT - 1) / T::NT; ++i) {
      const int e = tid + i * T::NT;
      if (NH % T::NT == 0 || e < NH) {
        const int m = e / EVC_BK, kk = e % EVC_BK;   // a warp reads along k: coalesced
        const int f = row0 + m, k = k0 + kk;
        const bool ok = f < F && k < k_hi;
        cp_async_f32(Hs + kk * T::HS + m, ok ? X + (size_t)f * K + k : X, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < (NA + T::NT - 1) / T::NT; ++i) {
      const int e = tid + i * T::NT;
      if (NA % T::NT == 0 || e < NA) {
        if constexpr (YT) {
          const int n = e / EVC_BK, kk = e % EVC_BK;   // along k, as X
          const int k = k0 + kk, c = col0 + n;
          const bool ok = k < k_hi && c < C;
          cp_async_f32(As + kk * T::AS + n, ok ? Y + (size_t)c * K + k : Y, ok);
        } else {
          const int kk = e / BN, n = e % BN;
          const int k = k0 + kk, c = col0 + n;
          const bool ok = k < k_hi && c < C;
          cp_async_f32(As + kk * BN + n, ok ? Y + (size_t)k * C + c : Y, ok);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_steps) load(s, k_lo + s * EVC_BK);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // slice s has landed everywhere; slice s - 1 is consumed
    if (s + NS - 1 < n_steps) load((s + NS - 1) % NS, k_lo + (s + NS - 1) * EVC_BK);
    cp_async_commit();
    const float* Hs = stage + (s % NS) * T::STAGE;
    const float* As = Hs + EVC_BK * T::HS;
#pragma unroll
    for (int kk = 0; kk < EVC_BK; ++kk) {
      const float4 h0 = *reinterpret_cast<const float4*>(Hs + kk * T::HS + ty * EVC_TM);
      const float4 h1 = *reinterpret_cast<const float4*>(Hs + kk * T::HS + ty * EVC_TM + 4);
      const float4 a = *reinterpret_cast<const float4*>(As + kk * T::AS + tx * EVC_TN);
      fma_tile(acc, h0, h1, a);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The sum of the cluster's partials at float4 q of `buf`, in rank order.
__device__ __forceinline__ float4 cluster_sum4(cg::cluster_group& cluster, float* buf, int q,
                                               int split) {
  float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, 0))[q];
  for (int r = 1; r < split; ++r) {
    const float4 w = reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, r))[q];
    v.x += w.x;
    v.y += w.y;
    v.z += w.z;
    v.w += w.w;
  }
  return v;
}

// ---------------------------------------------------------------------------
// nmf_recon: P = H.A, split over K across the CTAs of a cluster.
//
// Replaces _recon_kernel (nmf_pallas.py:34). A 32 x 128 output tile per
// cluster (22 x 2 tiles at F = 688, D = 201) and one K slice per CTA: a
// split of 8 gives 352 CTAs of 4 warps, 32 outputs a thread, in one wave
// (45 such clusters fit at once). The previous
// design (32 x 32 tiles, 2 x 2 outputs a thread, all of K serial in each of
// 154 blocks) was bound by one shared load per FMA and by its serial,
// unoverlapped K walk: 0.44 ms against cuBLAS's 0.09 ms. Here a k step costs
// three float4 shared loads for 32 FMAs, three slices are in flight while
// one computes, and K is spread over eight CTAs a tile. The partial tile goes
// to the CTA's own shared memory; after a cluster barrier rank r sums its
// share of the tile over the split partials (rank order, fixed) and stores
// it; a second barrier keeps every CTA alive until its peers have read it.
// ---------------------------------------------------------------------------

using ReconTile = HaTile<EVC_RECON_BM, EVC_RECON_BN>;

__global__ void __launch_bounds__(ReconTile::NT, 1)
nmf_recon_kernel(const float* __restrict__ H, const float* __restrict__ A,
                 float* __restrict__ P, int F, int K, int D, EvcKSlices ks) {
  using T = ReconTile;
  constexpr int BM = EVC_RECON_BM;
  extern __shared__ float4 evc_smem4[];
  float* smem = reinterpret_cast<float*>(evc_smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int split = (int)cluster.num_blocks();
  const int row0 = blockIdx.z * BM, col0 = blockIdx.y * EVC_RECON_BN;
  float acc[EVC_TM][EVC_TN] = {};
  ha_accumulate<BM, EVC_RECON_BN, EVC_RECON_NS>(H, A, F, K, D, row0, col0, ks.b[rank],
                                                ks.b[rank + 1], smem, acc);
  // the partial tile, row-major [BM][BN], over the (now free) staging buffers
  int ty, tx;
  T::yx(threadIdx.x, ty, tx);
#pragma unroll
  for (int i = 0; i < EVC_TM; ++i)
    *reinterpret_cast<float4*>(smem + (ty * EVC_TM + i) * EVC_RECON_BN + tx * EVC_TN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  constexpr int N4 = BM * EVC_RECON_BN / 4;
  const int share = (N4 + split - 1) / split;
  const int hi = min(N4, (rank + 1) * share);
  for (int q = rank * share + (int)threadIdx.x; q < hi; q += T::NT) {
    const float4 v = cluster_sum4(cluster, smem, q, split);
    const int f = row0 + q * 4 / EVC_RECON_BN, d = col0 + q * 4 % EVC_RECON_BN;
    if (f < F) {
      float* p = P + (size_t)f * D + d;
      if (d < D) p[0] = v.x;
      if (d + 1 < D) p[1] = v.y;
      if (d + 2 < D) p[2] = v.z;
      if (d + 3 < D) p[3] = v.w;
    }
  }
  cluster.sync();   // peers have read this CTA's partial
}

// ---------------------------------------------------------------------------
// nmf_update: out = H * (Num / den), den = P.A^T + l1, den == 0 -> EPS.
//
// Replaces _update_kernel (nmf_pallas.py:43). A 64 x 128 (F x K) tile per
// CTA: 11 x 60 = 660 CTAs of 8 warps at F = 688, K = 7680, two an SM. Each
// thread sums its 8 x 4 outputs over d ascending from 0.0f with one fmaf per
// d (ha_accumulate: P staged d-major as nmf_recon stages H, A transposed to
// d-major as the fused kernel's phase 2 stages it, 16 d a slice, three
// slices in flight), the order of the fused kernel's phase 2, so the fused
// iteration equals recon + update bit for bit; the zero rows at d >= D leave
// the sums unchanged. Three float4 shared loads feed 32 FMAs, loads stay in
// flight during the FMAs, D = 201 pads only to 208, and a warp stores 128
// contiguous bytes a row: 2.2x the 32 x 32, 2 x 2-a-thread tiling this
// replaced. D has no limit: only BK columns of P and A are in shared memory
// at a time. Now it runs at about
// 42 % of the card's fp32 FMA peak at K = 115,200; at K = 7680 its 660 CTAs
// take three waves of 264, the last one half full. Loading H and Num
// before the last slices (so they land under the FMAs) was slower.
// ---------------------------------------------------------------------------

using UpdateTile = HaTile<EVC_UPDATE_BM, EVC_UPDATE_BN, true>;

// H and out may alias (in-place update), so neither is __restrict__: each
// element is read, then written, by one thread.
__global__ void __launch_bounds__(UpdateTile::NT, EVC_UPDATE_MINB)
nmf_update_kernel(const float* __restrict__ P, const float* __restrict__ A, const float* H,
                  const float* __restrict__ Num, float* out, int F, int K, int D, float l1) {
  using T = UpdateTile;
  extern __shared__ float4 evc_smem4[];
  const int row0 = blockIdx.y * EVC_UPDATE_BM, col0 = blockIdx.x * EVC_UPDATE_BN;
  float acc[EVC_TM][EVC_TN] = {};
  ha_accumulate<EVC_UPDATE_BM, EVC_UPDATE_BN, EVC_UPDATE_NS, true>(
      P, A, F, D, K, row0, col0, 0, D, reinterpret_cast<float*>(evc_smem4), acc);
  int ty, tx;
  T::yx(threadIdx.x, ty, tx);
  const int k0 = col0 + tx * EVC_TN;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(H) | reinterpret_cast<uintptr_t>(Num) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = K % 4 == 0 && ptrs % 16 == 0;
  if (k0 >= K) return;
#pragma unroll
  for (int i = 0; i < EVC_TM; ++i) {
    const int f = row0 + ty * EVC_TM + i;
    if (f >= F) break;
    float den[EVC_TN];
#pragma unroll
    for (int j = 0; j < EVC_TN; ++j) {
      den[j] = acc[i][j] + l1;
      den[j] = (den[j] == 0.f) ? EVC_EPS : den[j];
    }
    const size_t idx = (size_t)f * K + k0;
    if (vec) {   // k0 + 3 < K too: K and k0 are multiples of 4
      const float4 h = *reinterpret_cast<const float4*>(H + idx);
      const float4 n = *reinterpret_cast<const float4*>(Num + idx);
      *reinterpret_cast<float4*>(out + idx) =
          make_float4(h.x * (n.x / den[0]), h.y * (n.y / den[1]), h.z * (n.z / den[2]),
                      h.w * (n.w / den[3]));
    } else {
#pragma unroll
      for (int j = 0; j < EVC_TN; ++j)
        if (k0 + j < K) out[idx + j] = H[idx + j] * (Num[idx + j] / den[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// One whole MU iteration in one kernel, one cluster per F tile.
//
// Replaces: exemplars_vc_tpu/factorize/nmf_pallas.py:_fused_mu_call (the
// fused=True path of nmf_activations_pallas): out = H * Num / den with
// den = (H.A).A^T + l1, den == 0 -> EPS, and P = H.A never written to HBM.
//
// Design: a cluster of `split` CTAs owns TF rows of F (TF = 32, or 16 or 8
// where the P tile of a wide D needs the room); CTA r owns K slice r.
//   Phase 1: for each 256-column chunk of D, the CTA accumulates the partial
//   P tile of its slice (ha_accumulate, as nmf_recon), stores it d-major in
//   its shared memory, and after a cluster barrier sums all partials of the
//   chunk in rank order into its own copy of the whole P tile (Pf, [Dp][TF],
//   d < Dp = D rounded up to 16, the rows >= D zero); a second barrier frees
//   the partial buffer. Every CTA then holds the whole P tile.
//   Phase 2: for its own slice only, in passes of 256 columns of K, the CTA
//   computes den = P.A^T with the same 8 x 4 register tile (A staged d-major
//   by a ring of cp.async copies, P read from Pf as float4 broadcasts, d
//   ascending with one fmaf each, as nmf_update) and applies + l1, the EPS
//   guard and H * Num / den in registers.
// In place: a CTA reads H only in its own K slice and F rows (phase 1 and
// the epilogue) and writes only those; each element of the epilogue is read,
// then written, by one thread. So out may be H.
//
// At F = 688, K = 7680, D = 201: 22 tiles x a split of 8 = 176 CTAs of 256
// threads (184 registers: one CTA an SM, 15 clusters at once, so two
// waves). A is read from L2 22 times an iteration (6.2 MB each) instead of
// 86 x 2 times in the previous design (one block of 8 rows streaming all of
// K twice, 86 blocks on 132 SMs, 1.47 ms: its phase 2 ran serial 201-long
// dots, 8 FMAs for three shared loads). The bound left is the FMA rate of
// one 8-warp CTA an SM, the second wave, the 55 idle columns of the
// phase-1 chunk at D = 201 and two cluster barriers.
// ---------------------------------------------------------------------------

template <int TF, int NS>
struct FusedTile {
  using P1 = HaTile<TF, EVC_FUSED_BN>;
  static constexpr int NT = P1::NT;                      // 8 TF threads
  static constexpr int STAGE2 = EVC_BK * EVC_FUSED_AS;   // floats of one phase-2 stage
  static constexpr int W1 = NS * P1::STAGE;
  static constexpr int W2 = NS * STAGE2;
  static constexpr int WP = EVC_FUSED_BN * TF;           // partial chunk [BN][TF]
  static constexpr int W = W1 > W2 ? (W1 > WP ? W1 : WP) : (W2 > WP ? W2 : WP);
};

// H and out may alias (in-place update), so neither is __restrict__.
template <int TF, int NS>
__global__ void __launch_bounds__(FusedTile<TF, NS>::NT, 1)
nmf_fused_mu_kernel(const float* H, const float* __restrict__ A,
                    const float* __restrict__ Num, float* out, int F, int K, int D, float l1,
                    EvcKSlices ks) {
  using T = FusedTile<TF, NS>;
  constexpr int NA2 = EVC_FUSED_BN * EVC_BK;
  extern __shared__ float4 evc_smem4[];
  const int Dp = (D + EVC_BK - 1) / EVC_BK * EVC_BK;
  float* Pf = reinterpret_cast<float*>(evc_smem4);  // [Dp][TF] the whole P tile
  float* W = Pf + (size_t)Dp * TF;                   // staging; the partial chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int split = (int)cluster.num_blocks();
  const int row0 = blockIdx.y * TF;
  const int k_lo = ks.b[rank], k_hi = ks.b[rank + 1];
  const int tid = threadIdx.x;
  int ty, tx;
  T::P1::yx(tid, ty, tx);

  // ---- phase 1: Pf = sum over the cluster of H[rows, slice] . A[slice, :] --
  for (int c0 = 0; c0 < D; c0 += EVC_FUSED_BN) {
    float acc[EVC_TM][EVC_TN] = {};
    ha_accumulate<TF, EVC_FUSED_BN, NS>(H, A, F, K, D, row0, c0, k_lo, k_hi, W, acc);
#pragma unroll
    for (int j = 0; j < EVC_TN; ++j) {
      float* w = W + (tx * EVC_TN + j) * TF + ty * EVC_TM;
      *reinterpret_cast<float4*>(w) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(w + 4) =
          make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
    cluster.sync();
    const int n4 = min(EVC_FUSED_BN, Dp - c0) * TF / 4;
    float4* dst = reinterpret_cast<float4*>(Pf + (size_t)c0 * TF);
    for (int q = tid; q < n4; q += T::NT) dst[q] = cluster_sum4(cluster, W, q, split);
    cluster.sync();   // peers have read W; Pf is complete
  }

  // ---- phase 2: out = H * Num / (P.A^T + l1) on this CTA's K slice -------
  const int n_d = Dp / EVC_BK;
  for (int kb = k_lo; kb < k_hi; kb += EVC_FUSED_BN) {
    float acc[EVC_TM][EVC_TN] = {};
    auto load = [&](int buf, int d0) {
      float* As = W + buf * T::STAGE2;   // [BK][AS]: A transposed, d-major
#pragma unroll 4
      for (int i = 0; i < (NA2 + T::NT - 1) / T::NT; ++i) {
        const int e = tid + i * T::NT;
        if (NA2 % T::NT == 0 || e < NA2) {
          const int kk = e / EVC_BK, dd = e % EVC_BK;   // a warp reads along d
          const int k = kb + kk, d = d0 + dd;
          const bool ok = k < k_hi && d < D;
          cp_async_f32(As + dd * EVC_FUSED_AS + kk, ok ? A + (size_t)k * D + d : A, ok);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < n_d) load(s, s * EVC_BK);
      cp_async_commit();
    }
    for (int s = 0; s < n_d; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();   // slice s has landed everywhere; slice s - 1 is consumed
      if (s + NS - 1 < n_d) load((s + NS - 1) % NS, (s + NS - 1) * EVC_BK);
      cp_async_commit();
      const float* As = W + (s % NS) * T::STAGE2;
      const float* Ps = Pf + (size_t)s * EVC_BK * TF;
#pragma unroll
      for (int dd = 0; dd < EVC_BK; ++dd) {
        const float4 p0 = *reinterpret_cast<const float4*>(Ps + dd * TF + ty * EVC_TM);
        const float4 p1 = *reinterpret_cast<const float4*>(Ps + dd * TF + ty * EVC_TM + 4);
        const float4 a = *reinterpret_cast<const float4*>(As + dd * EVC_FUSED_AS + tx * EVC_TN);
        fma_tile(acc, p0, p1, a);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next pass
#pragma unroll
    for (int i = 0; i < EVC_TM; ++i) {
      const int f = row0 + ty * EVC_TM + i;
      if (f >= F) continue;
#pragma unroll
      for (int j = 0; j < EVC_TN; ++j) {
        const int k = kb + tx * EVC_TN + j;
        if (k < k_hi) {
          float den = acc[i][j] + l1;
          den = (den == 0.f) ? EVC_EPS : den;
          const size_t idx = (size_t)f * K + k;
          out[idx] = H[idx] * (Num[idx] / den);
        }
      }
    }
  }
}

// The last plan an instance accepted on a device: a repeated plan skips the
// shared-memory attribute and the occupancy query (about 11 us a call).
struct EvcMemo {
  std::mutex mu;
  bool valid = false;
  int device = -1;
  EvcPlan plan;
  int clusters = 0;
};

// Refuse a plan that does not match the compiled tiling (cudaErrorInvalidValue),
// asks for a cluster above the portable 8 (cudaErrorInvalidClusterSize), for
// more shared memory than a block may opt into or for a cluster that no SM
// group can hold (cudaErrorInvalidConfiguration); otherwise fill the launch
// configuration, put the number of clusters the card holds at once in
// *clusters and return 0. Nothing is launched here. ks == nullptr: a launch
// without a cluster (split 1, the slices unused), whose clusters of one CTA
// are counted as CTAs an SM times the SMs.
template <typename Kern>
static int evc_check_plan(Kern kernel, EvcMemo& memo, const EvcPlan* p, int K, int bm, int bn,
                          int threads, int stages, dim3 grid, size_t smem_need,
                          cudaStream_t stream, cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* cfg, EvcKSlices* ks, int* clusters) {
  if (p->split < 1 || p->split > (ks ? EVC_MAX_SPLIT : 1)) return (int)cudaErrorInvalidClusterSize;
  if (p->smem_bytes > EVC_SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  if (p->bm != bm || p->bn != bn || p->threads != threads || p->stages != stages ||
      p->grid_x != (int)grid.x || p->grid_y != (int)grid.y || p->grid_z != (int)grid.z ||
      (size_t)p->smem_bytes < smem_need)
    return (int)cudaErrorInvalidValue;
  if (ks) {
    if (p->k_bounds[0] != 0 || p->k_bounds[p->split] != K) return (int)cudaErrorInvalidValue;
    for (int s = 0; s <= EVC_MAX_SPLIT; ++s) {
      if (s < p->split && p->k_bounds[s + 1] < p->k_bounds[s]) return (int)cudaErrorInvalidValue;
      ks->b[s] = s <= p->split ? p->k_bounds[s] : K;
    }
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = p->split;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = (size_t)p->smem_bytes;
  cfg->stream = stream;
  cfg->attrs = ks ? attr : nullptr;
  cfg->numAttrs = ks ? 1 : 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(memo.mu);
  if (memo.valid && memo.device == device && std::memcmp(&memo.plan, p, sizeof(EvcPlan)) == 0) {
    *clusters = memo.clusters;
    return 0;
  }
  memo.valid = false;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  *clusters = 0;
  if (ks) {
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
  } else {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      (size_t)p->smem_bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    *clusters = per_sm * sms;
  }
  if (e != cudaSuccess) return (int)e;
  if (*clusters < 1) return (int)cudaErrorInvalidConfiguration;
  memo.valid = true;
  memo.device = device;
  memo.plan = *p;
  memo.clusters = *clusters;
  return 0;
}

// Check the plan, then launch, or with query != nullptr only report the
// co-resident cluster count there.
static int evc_recon(const float* H, const float* A, float* P, int F, int K, int D,
                     const EvcPlan* p, cudaStream_t stream, int* query) {
  using T = ReconTile;
  static EvcMemo memo;
  const dim3 grid(p->split, (D + EVC_RECON_BN - 1) / EVC_RECON_BN,
                  (F + EVC_RECON_BM - 1) / EVC_RECON_BM);
  constexpr int ring = EVC_RECON_NS * T::STAGE, part = EVC_RECON_BM * EVC_RECON_BN;
  const size_t need = sizeof(float) * (ring > part ? ring : part);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  EvcKSlices ks;
  int clusters = 0;
  const int e = evc_check_plan(nmf_recon_kernel, memo, p, K, EVC_RECON_BM, EVC_RECON_BN, T::NT,
                               EVC_RECON_NS, grid, need, stream, attr, &cfg, &ks,
                               query ? query : &clusters);
  if (e != 0 || query) return e;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, nmf_recon_kernel, H, A, P, F, K, D, ks);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

static int evc_update(const float* P, const float* A, const float* H, const float* Num,
                      float* out, int F, int K, int D, float l1, const EvcPlan* p,
                      cudaStream_t stream, int* query) {
  using T = UpdateTile;
  static EvcMemo memo;
  const dim3 grid((K + EVC_UPDATE_BN - 1) / EVC_UPDATE_BN,
                  (F + EVC_UPDATE_BM - 1) / EVC_UPDATE_BM, 1);
  const size_t need = sizeof(float) * EVC_UPDATE_NS * T::STAGE;
  cudaLaunchConfig_t cfg;
  int ctas = 0;
  const int e = evc_check_plan(nmf_update_kernel, memo, p, K, EVC_UPDATE_BM, EVC_UPDATE_BN,
                               T::NT, EVC_UPDATE_NS, grid, need, stream, nullptr, &cfg, nullptr,
                               query ? query : &ctas);
  if (e != 0 || query) return e;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, nmf_update_kernel, P, A, H, Num, out, F, K, D, l1);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <int TF, int NS>
static int evc_fused(const float* H, const float* A, const float* Num, float* out, int F,
                     int K, int D, float l1, const EvcPlan* p, cudaStream_t stream,
                     int* query) {
  using T = FusedTile<TF, NS>;
  static EvcMemo memo;
  const int Dp = (D + EVC_BK - 1) / EVC_BK * EVC_BK;
  const dim3 grid(p->split, (F + TF - 1) / TF, 1);
  const size_t need = sizeof(float) * ((size_t)Dp * TF + T::W);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  EvcKSlices ks;
  int clusters = 0;
  const int e = evc_check_plan(nmf_fused_mu_kernel<TF, NS>, memo, p, K, TF, EVC_FUSED_BN, T::NT,
                               NS, grid, need, stream, attr, &cfg, &ks,
                               query ? query : &clusters);
  if (e != 0 || query) return e;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, nmf_fused_mu_kernel<TF, NS>, H, A, Num, out, F, K, D, l1, ks);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// plan->bm picks the compiled instance: the F tile TF and its ring depth
// (the ring shrinks where a wide D leaves the P tile little room)
static int evc_fused_any(const float* H, const float* A, const float* Num, float* out, int F,
                         int K, int D, float l1, const EvcPlan* p, cudaStream_t s, int* query) {
  switch (p->bm) {
    case 32: return evc_fused<32, 4>(H, A, Num, out, F, K, D, l1, p, s, query);
    case 16: return evc_fused<16, 2>(H, A, Num, out, F, K, D, l1, p, s, query);
    case 8: return evc_fused<8, 2>(H, A, Num, out, F, K, D, l1, p, s, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

const char* evc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int evc_nmf_recon(const float* H, const float* A, float* P, int F, int K, int D,
                  const EvcPlan* plan, void* stream) {
  return evc_recon(H, A, P, F, K, D, plan, (cudaStream_t)stream, nullptr);
}

// How many of the plan's clusters the card holds at once (the plan is
// checked as for a launch; nothing is launched).
int evc_nmf_recon_clusters(int F, int K, int D, const EvcPlan* plan, int* clusters) {
  return evc_recon(nullptr, nullptr, nullptr, F, K, D, plan, nullptr, clusters);
}

int evc_nmf_update(const float* P, const float* A, const float* H, const float* Num,
                   float* out, int F, int K, int D, float l1, const EvcPlan* plan, void* stream) {
  return evc_update(P, A, H, Num, out, F, K, D, l1, plan, (cudaStream_t)stream, nullptr);
}

// How many CTAs of the plan the card holds at once (no cluster: each CTA is
// a cluster of one).
int evc_nmf_update_clusters(int F, int K, int D, const EvcPlan* plan, int* clusters) {
  return evc_update(nullptr, nullptr, nullptr, nullptr, nullptr, F, K, D, 0.f, plan, nullptr,
                    clusters);
}

int evc_nmf_fused_mu(const float* H, const float* A, const float* Num, float* out, int F,
                     int K, int D, float l1, const EvcPlan* plan, void* stream) {
  return evc_fused_any(H, A, Num, out, F, K, D, l1, plan, (cudaStream_t)stream, nullptr);
}

int evc_nmf_fused_mu_clusters(int F, int K, int D, const EvcPlan* plan, int* clusters) {
  return evc_fused_any(nullptr, nullptr, nullptr, nullptr, F, K, D, 0.f, plan, nullptr,
                       clusters);
}

}  // extern "C"
