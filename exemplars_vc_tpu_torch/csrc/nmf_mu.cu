// Fixed-dictionary Frobenius MU NMF on Hopper: the two kernels of one
// multiplicative update  H <- H * Num / ((H.A).A^T), and below them the
// same update as one kernel (nmf_fused_mu_kernel, the opt-in fused path).
//
// Replaces: exemplars_vc_tpu/factorize/nmf_pallas.py:nmf_activations_pallas,
// its kernels _recon_kernel (:34, P = H.A, also the reconstruction of the
// error check), _update_kernel (:43, Den = P.A^T fused with H * Num / Den,
// where Den == 0 becomes sklearn's EPS) and _fused_mu_call (:50, both in
// one kernel).
//
//   nmf_recon:  P (F, D) = H (F, K) . A (K, D), K is the reduction axis.
//   nmf_update: out (F, K) = H * (Num / den), den = P (F, D) . A (K, D)^T + l1,
//               den == 0 -> EPS = 2.220446049250313e-16. out may be H itself
//               (the update runs in place): each element of H is read and
//               then written by the same thread, and by no other.
//   nmf_fused_mu: nmf_update(nmf_recon(H, A), A, H, Num, l1) in one launch.
//
// Parity is fp32 (TF32 off), so the tensor cores are out of reach and every
// kernel here runs on the FMA pipes.
//
// nmf_recon is a persistent split-K over every SM, one cooperative launch.
// The TPU kernel walks its grid in order on one core; on this card the
// served shapes (K = 14,336 exemplars; F = 16 frames for a stream chunk,
// 200 to 1,360 for a request; D = 201 or 1025) give too few output tiles to
// fill 132 SMs, and a recon is 2.F.K.D operations on A (K x D) and H (F x K):
// compute-bound from F ~ 100 up, bound by reading A (11.5 MB at D = 201,
// held in L2 across a solve) at F = 16. The plan
// (factorize/nmf_cuda.py:nmf_recon_plan) cuts K into pieces that are the
// same for every tile: q long pieces, one unit (tile x piece) a CTA, and
// where SMs are left over one short remainder piece whose units those SMs
// share, so every SM has about the same work. Each CTA accumulates a unit's
// partial tile in registers and writes it to a workspace; after a grid
// barrier every CTA sums the partials of its share of P in a fixed order:
// the pieces of each group from its first, then the groups from the first.
// No floating-point atomics: P is bit-identical from run to run. The groups
// are the fused kernel's cluster ranks, which sum their pieces in the same
// order, so the fused solve equals the two-kernel solve bit for bit.
//
// A CTA is 256 threads (16 x 16), each a TM x 13 register tile: a tile of
// 128 x 208 (TM = 8) or, where F <= 48, 16 x 208 (TM = 1), so D = 201 and
// 1025 idle 3.4 % and 1.4 % of the tile columns. One CTA an SM (up to 255
// registers), two warps a scheduler. H comes in 16-byte cp.async.cg copies
// where K % 4 == 0 and H is 16-byte aligned (else 4-byte copies), into an
// F-major stage read as float4 along k; A, whose rows of 804 or 4,100
// bytes are not 16-byte aligned and are read as the dictionary holds them,
// in 4-byte copies into a k-major stage where each thread column's 13
// floats sit in a 20-float slot. A k step of the 8 x 13 tile costs 2 float4
// loads of H (8 every 4 k) and 3 float4 and 1 scalar load of A for 104 FMAs,
// without bank conflicts; a 4- (TM = 8) or 6-deep (TM = 1) ring keeps the
// copies in flight.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, 1980 MHz, K = 14,336):
// at F = 620, D = 1025 it takes 0.519 ms, 52 % of its fp32 bound (0.845 ms
// and 32 % for the cluster design it replaced, 0.425 ms for torch.matmul).
// Phase 1 issues FMAs at ~57 % of the pipes' rate (one 8-warp CTA an SM at
// 255 registers, no spills) and takes ~96 % of the time; the ordered sum
// ~4 %. At F = 16, D = 201 (a stream chunk) it takes 15 us (82 us before;
// bound 3.7 us, by bytes): phase 1 reads A from L2 at ~1.4 TB/s, and the
// grid barrier and the ordered sum of 132 pieces take the rest.
//
// nmf_update has no split: K is its output axis and D = 201 a short
// reduction. A 64 x 128 (F x K) tile per CTA of 256 threads, each thread an
// 8 x 4 register tile, both operands staged d-major by one cp.async ring
// (ha_accumulate, its second operand read transposed), so a d step costs
// three float4 shared loads for 32 FMAs; at most 128 registers, so two CTAs
// share an SM and one's FMAs cover the other's epilogue and waits. The
// epilogue reads H and Num and writes out as float4 where K % 4 == 0 and the
// pointers are 16-byte aligned (a warp's 8 lanes along K cover 128
// contiguous bytes of a row), else element by element, with the same
// arithmetic. What bounds it (NVIDIA H100 80GB HBM3, 700 W, F = 688, K =
// 7680, D = 201): the FMA pipe, at about 42 % of the fp32 peak with two
// CTAs an SM (30 % with one), and at K = 7680 the last of three waves of
// 264 CTAs, half full.
//
// The C entries refuse, before launching, a plan that does not match the
// compiled tiling or cannot launch (a recon grid the card cannot hold at
// once, a cluster above 8, shared memory above the opt-in limit, no cluster
// or CTA that fits an SM), and return the cudaError_t; the Python wrappers
// raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace cg = cooperative_groups;

#define EVC_EPS 2.220446049250313e-16f

#define EVC_TM 8              // update and fused register tile: rows (F) of a thread
#define EVC_TN 4              // update and fused register tile: columns (D or K)
#define EVC_BK 16             // reduction depth of one staged slice
#define EVC_MAX_SPLIT 8       // portable cluster size
#define EVC_SMEM_LIMIT 232448 // dynamic shared memory one block may opt into
#define EVC_RECON_NT 256      // nmf_recon: 16 x 16 threads
#define EVC_RECON_TN 13       // nmf_recon register tile: columns (D) of a thread
#define EVC_RECON_BN 208      // nmf_recon D tile: 16 thread columns of 13
#define EVC_RECON_AP 20       // A-stage floats of one thread column (13 used)
#define EVC_RECON_BK 16       // nmf_recon: reduction depth of one staged slice
#define EVC_RECON_HP (EVC_RECON_BK + 4)  // row pitch of the F-major H stage
#define EVC_FUSED_BN 256      // fused: phase-1 column chunk, phase-2 K pass
#define EVC_FUSED_AS (EVC_FUSED_BN + 4)  // row stride of the d-major A stage
#define EVC_UPDATE_BM 64      // nmf_update output tile (F x K)
#define EVC_UPDATE_BN 128
#define EVC_UPDATE_NS 4       // nmf_update's cp.async ring depth
#define EVC_UPDATE_MINB 2     // nmf_update CTAs an SM (caps registers at 128)

// The launch plan the Python wrapper computes (nmf_cuda._Plan mirrors it).
struct EvcPlan {
  int bm, bn;              // CTA tile: F rows x columns
  int threads;
  int stages;              // depth of the cp.async ring
  int split;               // CTAs per cluster (the fused kernel's groups)
  int grid_x, grid_y, grid_z;
  int smem_bytes;          // dynamic shared memory
  int k_bounds[EVC_MAX_SPLIT + 1];  // the groups' K bounds (fused)
  int long_pieces, rem_kb, pieces, groups;       // the recon's K pieces (recon, fused)
  int single_ctas, range_ctas, range_units;      // the recon's CTAs and their units
  int tiles_f, tiles_d;                          // the recon's output tiles
};

// The K pieces both split-K kernels share (nmf_cuda._piece_bounds): over
// nkb staged slices, q long pieces cut the first nkb - rem slices, then a
// remainder piece takes the last rem (s = q + 1 pieces where rem > 0, else
// q). Group r is pieces [r s / g, (r + 1) s / g).
struct EvcPieces {
  int K, nkb, q, rem, s, g;
  __host__ __device__ int k(int j) const {
    const int kb = j <= q ? (int)((long long)j * (nkb - rem) / q) : nkb;
    return EVC_BK * kb < K ? EVC_BK * kb : K;
  }
  __host__ __device__ int group_lo(int r) const { return r * s / g; }
};

// The recon's units: CTA c < single computes unit c, CTA single + i of the
// range computes units [single + i U / n, single + (i + 1) U / n) of the U
// range units. Unit u is tile u % T over piece u / T; tile t is F tile
// t % tiles_f of D tile t / tiles_f.
struct EvcReconGrid {
  int single, range_ctas, range_units, tiles_f, tiles_d;
};

// ---------------------------------------------------------------------------
// cp.async and the register tiles
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
// nmf_recon: P = H.A, a persistent split-K over every SM.
//
// Replaces _recon_kernel (nmf_pallas.py:34). Phase 1: each CTA computes its
// units (EvcReconGrid); a unit is one output tile over one K piece, summed
// with one fmaf per k, ascending, from 0.0f (the chain the fused kernel's
// ha_accumulate makes too) and written to the workspace W as V x 256
// floats, value v of thread t at v * 256 + t, so a warp stores 128
// contiguous bytes. Phase 2, after the grid barrier: item (tile, float4
// slot, group r) on g consecutive lanes; lane r sums group r's partials
// from its first piece, and the first lane adds the other lanes' sums in
// rank order and stores the four elements. The order depends on the shape
// alone: P is the same bits from run to run.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // 16 bytes from global (L2 only), or with src-size 0 sixteen zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

template <int TM>
struct ReconTile {
  static constexpr int BM = 16 * TM;                      // F rows of a tile
  static constexpr int NS = TM == 1 ? 6 : 4;              // cp.async ring depth
  static constexpr int V = TM * EVC_RECON_TN;             // values a thread holds
  static constexpr int HS = BM * EVC_RECON_HP;            // floats: H stage [BM][BK + 4]
  static constexpr int AROW = 16 * EVC_RECON_AP;          // floats: one k row of the A stage
  static constexpr int STAGE = HS + EVC_RECON_BK * AROW;
  static constexpr int SMEM = NS * STAGE * (int)sizeof(float);
  static_assert(EVC_RECON_BN == 16 * EVC_RECON_TN, "16 thread columns");
  static_assert(HS % 4 == 0 && STAGE % 4 == 0, "16-byte aligned stages");
  // thread (ty, tx) of warp w, lane l: a warp is 4 rows x 8 columns of
  // threads (TM = 8: a k step reads 4 distinct H float4s and 8 distinct A
  // slots), or 8 x 4 where A is nearly all a thread reads (TM = 1: 4 A slots)
  static __device__ __forceinline__ void yx(int tid, int& ty, int& tx) {
    const int w = tid >> 5, l = tid & 31;
    if (TM == 1) {
      ty = (w & 1) * 8 + (l & 7);
      tx = (w >> 1) * 4 + (l >> 3);
    } else {
      ty = (w >> 1) * 4 + (l >> 3);
      tx = (w & 1) * 8 + (l & 7);
    }
  }
};

// acc += H[row0 + ty + 16 i, k_lo : k_hi] . A[k_lo : k_hi, col0 + 13 tx + j],
// one fmaf per k in ascending k. Rows >= F, k >= k_hi and columns >= D are
// staged as zeros. Ends behind a barrier: the ring is free again.
template <int TM>
__device__ __forceinline__ void recon_accumulate(const float* __restrict__ H,
                                                 const float* __restrict__ A, int F, int K, int D,
                                                 int row0, int col0, int k_lo, int k_hi,
                                                 bool vec_h, float* ring, int ty, int tx,
                                                 float (&acc)[TM][EVC_RECON_TN]) {
  using T = ReconTile<TM>;
  constexpr int BM = T::BM, NS = T::NS;
  const int tid = threadIdx.x;
  const int n_steps = (k_hi - k_lo + EVC_RECON_BK - 1) / EVC_RECON_BK;
  // thread c < 208 copies column c of every staged A row into slot c / 13
  const int a_slot = (tid / EVC_RECON_TN) * EVC_RECON_AP + tid % EVC_RECON_TN;
  const int d = col0 + tid;
  const bool a_col = tid < EVC_RECON_BN && d < D;
  auto load = [&](int buf, int k0) {
    float* Hs = ring + buf * T::STAGE;   // [BM][BK + 4]: H as it lies, F-major
    float* As = Hs + T::HS;              // [BK][16 x 20]: A, k-major
    if (vec_h) {   // K % 4 == 0: k0 and k_hi are multiples of 4, whole float4s
      constexpr int NQ = EVC_RECON_BK / 4, NH4 = BM * NQ;
#pragma unroll
      for (int i = 0; i < (NH4 + EVC_RECON_NT - 1) / EVC_RECON_NT; ++i) {
        const int e = tid + i * EVC_RECON_NT;
        if (NH4 % EVC_RECON_NT == 0 || e < NH4) {
          const int m = e / NQ, q = e % NQ;
          const int f = row0 + m, k = k0 + 4 * q;
          const bool ok = f < F && k < k_hi;
          cp_async_f32x4(Hs + m * EVC_RECON_HP + 4 * q, ok ? H + (size_t)f * K + k : H, ok);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM * EVC_RECON_BK / EVC_RECON_NT; ++i) {
        const int e = tid + i * EVC_RECON_NT;
        const int m = e / EVC_RECON_BK, kk = e % EVC_RECON_BK;   // a warp reads along k
        const int f = row0 + m, k = k0 + kk;
        const bool ok = f < F && k < k_hi;
        cp_async_f32(Hs + m * EVC_RECON_HP + kk, ok ? H + (size_t)f * K + k : H, ok);
      }
    }
    if (tid < EVC_RECON_BN) {   // a warp reads 32 consecutive columns of a row
#pragma unroll
      for (int kk = 0; kk < EVC_RECON_BK; ++kk) {
        const int k = k0 + kk;
        const bool ok = a_col && k < k_hi;
        cp_async_f32(As + kk * T::AROW + a_slot, ok ? A + (size_t)k * D + d : A, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_steps) load(s, k_lo + s * EVC_RECON_BK);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();   // slice s has landed everywhere; slice s - 1 is consumed
    if (s + NS - 1 < n_steps) load((s + NS - 1) % NS, k_lo + (s + NS - 1) * EVC_RECON_BK);
    cp_async_commit();
    const float* Hs = ring + (s % NS) * T::STAGE;
    const float* As = Hs + T::HS + tx * EVC_RECON_AP;
#pragma unroll 2
    for (int q = 0; q < EVC_RECON_BK / 4; ++q) {
      float4 h[TM];   // rows ty + 16 i, k = 4 q .. 4 q + 3
#pragma unroll
      for (int i = 0; i < TM; ++i)
        h[i] = *reinterpret_cast<const float4*>(Hs + (ty + 16 * i) * EVC_RECON_HP + 4 * q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* ap = As + (4 * q + kk) * T::AROW;
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        const float4 a2 = *reinterpret_cast<const float4*>(ap + 8);
        const float av[EVC_RECON_TN] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z,
                                        a1.w, a2.x, a2.y, a2.z, a2.w, ap[12]};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float hv = kk == 0 ? h[i].x : kk == 1 ? h[i].y : kk == 2 ? h[i].z : h[i].w;
#pragma unroll
          for (int j = 0; j < EVC_RECON_TN; ++j) acc[i][j] = fmaf(hv, av[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Phase 2's last step for one item: lane r == 0 of each g lanes adds the
// group sums of lanes 1 .. g - 1 to its own, in rank order, and stores the
// four elements of its float4 slot (values v of threads 4 t4 .. 4 t4 + 3).
// Every lane of the warp calls it: the shuffles need them all.
template <int TM>
__device__ __forceinline__ void recon_store(float* __restrict__ P, int F, int D,
                                            const EvcReconGrid& gr, const float4 sum, int item,
                                            int total, int g, int lg, int r, int lane) {
  using T = ReconTile<TM>;
  constexpr int SLOTS = T::V * (EVC_RECON_NT / 4);
  float4 p = sum;
  for (int o = 1; o < g; ++o) {
    const int from = (lane & ~(g - 1)) + o;
    p.x += __shfl_sync(0xffffffffu, sum.x, from);
    p.y += __shfl_sync(0xffffffffu, sum.y, from);
    p.z += __shfl_sync(0xffffffffu, sum.z, from);
    p.w += __shfl_sync(0xffffffffu, sum.w, from);
  }
  if (item >= total || r != 0) return;
  const int slot = item >> lg, tile = slot / SLOTS, rest = slot - tile * SLOTS;
  const int v = rest / (EVC_RECON_NT / 4), t4 = rest % (EVC_RECON_NT / 4);
  const int row = (tile % gr.tiles_f) * T::BM + 16 * (v / EVC_RECON_TN);
  const int col = (tile / gr.tiles_f) * EVC_RECON_BN + v % EVC_RECON_TN;
  const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int oy, ox;
    T::yx(4 * t4 + c, oy, ox);
    const int f = row + oy, dd = col + EVC_RECON_TN * ox;
    if (f < F && dd < D) P[(size_t)f * D + dd] = pv[c];
  }
}

template <int TM>
__global__ void __launch_bounds__(EVC_RECON_NT, 1)
nmf_recon_kernel(const float* __restrict__ H, const float* __restrict__ A,
                 float* __restrict__ P, float* __restrict__ W, int F, int K, int D,
                 EvcPieces pc, EvcReconGrid gr, int vec_h) {
  using T = ReconTile<TM>;
  constexpr int BM = T::BM, V = T::V, SLOTS = V * (EVC_RECON_NT / 4);
  extern __shared__ float4 evc_smem4[];
  float* ring = reinterpret_cast<float*>(evc_smem4);
  const int tid = threadIdx.x, lane = tid & 31;
  int ty, tx;
  T::yx(tid, ty, tx);
  const int n_tiles = gr.tiles_f * gr.tiles_d;

  // ---- phase 1: this CTA's units, each a partial tile into W -------------
  int u_lo, u_hi;
  if ((int)blockIdx.x < gr.single) {
    u_lo = blockIdx.x;
    u_hi = u_lo + 1;
  } else {
    const long long c = (int)blockIdx.x - gr.single;
    u_lo = gr.single + (int)(c * gr.range_units / gr.range_ctas);
    u_hi = gr.single + (int)((c + 1) * gr.range_units / gr.range_ctas);
  }
  for (int u = u_lo; u < u_hi; ++u) {
    const int piece = u / n_tiles, tile = u % n_tiles;
    float acc[TM][EVC_RECON_TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < EVC_RECON_TN; ++j) acc[i][j] = 0.f;
    recon_accumulate<TM>(H, A, F, K, D, (tile % gr.tiles_f) * BM,
                         (tile / gr.tiles_f) * EVC_RECON_BN, pc.k(piece), pc.k(piece + 1),
                         vec_h != 0, ring, ty, tx, acc);
    float* wp = W + (size_t)u * V * EVC_RECON_NT + tid;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < EVC_RECON_TN; ++j)
        wp[(i * EVC_RECON_TN + j) * EVC_RECON_NT] = acc[i][j];
  }
  cg::this_grid().sync();   // every partial is in W

  // ---- phase 2: P = the partials summed in the plan's order ---------------
  // Items (tile, float4 slot, group r) in rows of 32, g lanes a slot (the C
  // entry keeps their count below 2^31). A warp takes rows in turn and loads
  // before it adds, so many loads are in flight: four rows at once where a
  // group has at most four pieces, else sixteen pieces of one row at once.
  const int g = pc.g, lg = __ffs(g) - 1;   // g: a power of two, at most 8
  const int r = lane & (g - 1);
  const int j0 = pc.group_lo(r), nj = pc.group_lo(r + 1) - j0;
  const int total = n_tiles * SLOTS * g, rows = (total + 31) / 32;
  // consecutive rows on different SMs: a few rows (F = 16) still load from all
  const int warp = (tid >> 5) * gridDim.x + blockIdx.x;
  const int n_warps = gridDim.x * (EVC_RECON_NT / 32);
  const size_t part4 = (size_t)V * (EVC_RECON_NT / 4);   // float4s of one partial
  const size_t piece4 = (size_t)n_tiles * part4;          // float4s of one piece
  const float4* W4 = reinterpret_cast<const float4*>(W) + (size_t)j0 * piece4;
  auto first = [&](int item) {   // this lane's group's first partial of the item
    const int slot = item >> lg, tile = slot / SLOTS;
    return W4 + (size_t)tile * part4 + (slot - tile * SLOTS);
  };
  if (pc.s <= 4 * g) {   // every group has at most 4 pieces
    constexpr int NB = 4;
    for (int row0 = warp * NB; row0 < rows; row0 += n_warps * NB) {
      float4 x[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int item = (row0 + b) * 32 + lane;
        const float4* src = first(item < total ? item : 0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (item < total && j < nj) x[b][j] = __ldcg(src + (size_t)j * piece4);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float4 sum = x[b][0];
#pragma unroll
        for (int j = 1; j < 4; ++j)
          if (j < nj) add4(sum, x[b][j]);
        recon_store<TM>(P, F, D, gr, sum, (row0 + b) * 32 + lane, total, g, lg, r, lane);
      }
    }
  } else {
    for (int row = warp; row < rows; row += n_warps) {
      const int item = row * 32 + lane;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      if (item < total) {
        const float4* src = first(item);
        for (int j = 0; j < nj; j += 16) {
          float4 x[16];
#pragma unroll
          for (int t = 0; t < 16; ++t)
            if (j + t < nj) x[t] = __ldcg(src + (size_t)(j + t) * piece4);
#pragma unroll
          for (int t = 0; t < 16; ++t)
            if (j + t < nj) {
              if (j + t == 0)
                sum = x[t];
              else
                add4(sum, x[t]);
            }
        }
      }
      recon_store<TM>(P, F, D, gr, sum, item, total, g, lg, r, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// nmf_update: out = H * (Num / den), den = P.A^T + l1, den == 0 -> EPS.
//
// Replaces _update_kernel (nmf_pallas.py:43). A 64 x 128 (F x K) tile per
// CTA: 11 x 60 = 660 CTAs of 8 warps at F = 688, K = 7680, two an SM. Each
// thread sums its 8 x 4 outputs over d ascending from 0.0f with one fmaf per
// d (ha_accumulate: P staged d-major as the fused kernel's phase 1 stages H, A
// transposed to d-major as its phase 2 stages it, 16 d a slice, three
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
// where the P tile of a wide D needs the room); CTA r owns K slice r, the
// recon's group r of K pieces (EvcPieces).
//   Phase 1: for each 256-column chunk of D, the CTA accumulates the partial
//   P tile of each piece of its slice (ha_accumulate: one fmaf per k from
//   0.0f, the recon's chain) and sums them in piece order in registers, as
//   nmf_recon sums a group; stores the sum d-major in its shared memory,
//   and after a cluster barrier sums all partials of the chunk in rank
//   order, as nmf_recon sums the groups, into its own copy of the whole P
//   tile (Pf, [Dp][TF],
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
// threads (one CTA an SM, 15 clusters at once, so two waves), each slice
// two or three of the recon's 22 pieces. A is read from L2 22 times an
// iteration (6.2 MB each) instead of 86 x 2 times in the first design (one
// block of 8 rows streaming all of K twice, 86 blocks on 132 SMs, 1.47 ms).
// The bound left is the FMA rate of one 8-warp CTA an SM, the second wave,
// the 55 idle columns of the phase-1 chunk at D = 201 and two cluster
// barriers.
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
                    EvcPieces pc) {
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
  const int j_lo = pc.group_lo(rank), j_hi = pc.group_lo(rank + 1);
  const int k_lo = pc.k(j_lo), k_hi = pc.k(j_hi);
  const int tid = threadIdx.x;
  int ty, tx;
  T::P1::yx(tid, ty, tx);

  // ---- phase 1: Pf = sum over the cluster of H[rows, slice] . A[slice, :] --
  for (int c0 = 0; c0 < D; c0 += EVC_FUSED_BN) {
    float acc[EVC_TM][EVC_TN] = {};
    for (int j = j_lo; j < j_hi; ++j) {   // the slice's pieces, summed as nmf_recon
      float part[EVC_TM][EVC_TN] = {};
      ha_accumulate<TF, EVC_FUSED_BN, NS>(H, A, F, K, D, row0, c0, pc.k(j), pc.k(j + 1), W,
                                          part);
#pragma unroll
      for (int i = 0; i < EVC_TM; ++i)
#pragma unroll
        for (int jj = 0; jj < EVC_TN; ++jj)
          acc[i][jj] = j == j_lo ? part[i][jj] : acc[i][jj] + part[i][jj];
    }
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

enum class EvcLaunch { plain, cluster, cooperative };

// Refuse a plan that does not match the compiled tiling (cudaErrorInvalidValue),
// asks for a cluster above the portable 8 (cudaErrorInvalidClusterSize), for
// more shared memory than a block may opt into or for a cluster that no SM
// group can hold (cudaErrorInvalidConfiguration), or, cooperative, for more
// CTAs than the card holds at once (cudaErrorCooperativeLaunchTooLarge);
// otherwise fill the launch configuration, put the number of clusters the
// card holds at once in *clusters (without a cluster: CTAs an SM times the
// SMs) and return 0. Nothing is launched here.
template <typename Kern>
static int evc_check_plan(Kern kernel, EvcMemo& memo, const EvcPlan* p, int bm, int bn,
                          int threads, int stages, dim3 grid, size_t smem_need,
                          cudaStream_t stream, EvcLaunch mode, cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* cfg, int* clusters) {
  const bool cl = mode == EvcLaunch::cluster;
  if (p->split < 1 || p->split > (cl ? EVC_MAX_SPLIT : 1)) return (int)cudaErrorInvalidClusterSize;
  if (p->smem_bytes > EVC_SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  if (p->bm != bm || p->bn != bn || p->threads != threads || p->stages != stages ||
      p->grid_x != (int)grid.x || p->grid_y != (int)grid.y || p->grid_z != (int)grid.z ||
      (size_t)p->smem_bytes < smem_need)
    return (int)cudaErrorInvalidValue;
  if (cl) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = p->split;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
  } else if (mode == EvcLaunch::cooperative) {
    attr->id = cudaLaunchAttributeCooperative;
    attr->val.cooperative = 1;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = (size_t)p->smem_bytes;
  cfg->stream = stream;
  cfg->attrs = mode == EvcLaunch::plain ? nullptr : attr;
  cfg->numAttrs = mode == EvcLaunch::plain ? 0 : 1;
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
  if (cl) {
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
  if (mode == EvcLaunch::cooperative && (int)grid.x > *clusters)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  memo.valid = true;
  memo.device = device;
  memo.plan = *p;
  memo.clusters = *clusters;
  return 0;
}

// The plan's K pieces, or false where they do not cut [0, K) into s
// non-empty pieces (one empty piece at K = 0) in g groups, g a power of two
// of at most 8 and at most s.
static bool evc_pieces(const EvcPlan* p, int K, EvcPieces* pc) {
  const int nkb = (K + EVC_BK - 1) / EVC_BK;
  *pc = EvcPieces{K, nkb, p->long_pieces, p->rem_kb, p->pieces, p->groups};
  if (K < 0 || pc->q < 1 || pc->rem < 0 || pc->s != pc->q + (pc->rem > 0)) return false;
  if (K > 0 ? nkb - pc->rem < pc->q : pc->q != 1) return false;
  return pc->g >= 1 && pc->g <= EVC_MAX_SPLIT && pc->g <= pc->s && (pc->g & (pc->g - 1)) == 0;
}

// Check the plan, then launch, or with query != nullptr only report how many
// CTAs the card holds at once. bm picks the compiled instance: 16 (TM = 1)
// or 128 (TM = 8).
template <int TM>
static int evc_recon(const float* H, const float* A, float* P, float* W, long long ws_floats,
                     int F, int K, int D, const EvcPlan* p, cudaStream_t stream, int* query) {
  using T = ReconTile<TM>;
  static EvcMemo memo;
  EvcPieces pc;
  if (F < 1 || D < 1 || !evc_pieces(p, K, &pc)) return (int)cudaErrorInvalidValue;
  const EvcReconGrid gr{p->single_ctas, p->range_ctas, p->range_units, p->tiles_f, p->tiles_d};
  const long long units = (long long)gr.tiles_f * gr.tiles_d * pc.s;
  if (gr.tiles_f != (F + T::BM - 1) / T::BM || gr.tiles_d != (D + EVC_RECON_BN - 1) / EVC_RECON_BN ||
      gr.single < 0 || gr.range_ctas < 0 || (gr.range_ctas == 0) != (gr.range_units == 0) ||
      gr.single + (long long)gr.range_units != units || gr.single + gr.range_ctas != p->grid_x)
    return (int)cudaErrorInvalidValue;
  if (!query && ws_floats < units * T::V * EVC_RECON_NT) return (int)cudaErrorInvalidValue;
  if (units / pc.s * T::V * (EVC_RECON_NT / 4) * EVC_MAX_SPLIT > INT_MAX)   // phase 2's items
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int ctas = 0;
  const int e = evc_check_plan(nmf_recon_kernel<TM>, memo, p, T::BM, EVC_RECON_BN, EVC_RECON_NT,
                               T::NS, dim3(p->grid_x, 1, 1), T::SMEM, stream,
                               EvcLaunch::cooperative, attr, &cfg, query ? query : &ctas);
  if (e != 0 || query) return e;
  const uintptr_t h = reinterpret_cast<uintptr_t>(H);
  const int vec_h = K % 4 == 0 && h % 16 == 0;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, nmf_recon_kernel<TM>, H, A, P, W, F, K, D, pc, gr, vec_h);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

static int evc_recon_any(const float* H, const float* A, float* P, float* W, long long ws_floats,
                         int F, int K, int D, const EvcPlan* p, cudaStream_t s, int* query) {
  switch (p->bm) {
    case 16: return evc_recon<1>(H, A, P, W, ws_floats, F, K, D, p, s, query);
    case 128: return evc_recon<8>(H, A, P, W, ws_floats, F, K, D, p, s, query);
    default: return (int)cudaErrorInvalidValue;
  }
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
  const int e = evc_check_plan(nmf_update_kernel, memo, p, EVC_UPDATE_BM, EVC_UPDATE_BN, T::NT,
                               EVC_UPDATE_NS, grid, need, stream, EvcLaunch::plain, nullptr,
                               &cfg, query ? query : &ctas);
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
  EvcPieces pc;
  if (p->split < 1 || p->split > EVC_MAX_SPLIT) return (int)cudaErrorInvalidClusterSize;
  if (!evc_pieces(p, K, &pc) || pc.g != p->split) return (int)cudaErrorInvalidValue;
  for (int r = 0; r <= pc.g; ++r)   // the slices the plan reports are the groups'
    if (p->k_bounds[r] != pc.k(pc.group_lo(r))) return (int)cudaErrorInvalidValue;
  const int Dp = (D + EVC_BK - 1) / EVC_BK * EVC_BK;
  const dim3 grid(p->split, (F + TF - 1) / TF, 1);
  const size_t need = sizeof(float) * ((size_t)Dp * TF + T::W);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  const int e = evc_check_plan(nmf_fused_mu_kernel<TF, NS>, memo, p, TF, EVC_FUSED_BN, T::NT,
                               NS, grid, need, stream, EvcLaunch::cluster, attr, &cfg,
                               query ? query : &clusters);
  if (e != 0 || query) return e;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, nmf_fused_mu_kernel<TF, NS>, H, A, Num, out, F, K, D, l1, pc);
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

// W: the workspace of the plan's partial tiles, ws_floats floats (at least
// units x TM x 13 x 256).
int evc_nmf_recon(const float* H, const float* A, float* P, float* W, long long ws_floats, int F,
                  int K, int D, const EvcPlan* plan, void* stream) {
  return evc_recon_any(H, A, P, W, ws_floats, F, K, D, plan, (cudaStream_t)stream, nullptr);
}

// How many CTAs of the plan the card holds at once (the plan is checked as
// for a launch, whose grid may not exceed it; nothing is launched).
int evc_nmf_recon_clusters(int F, int K, int D, const EvcPlan* plan, int* clusters) {
  return evc_recon_any(nullptr, nullptr, nullptr, nullptr, 0, F, K, D, plan, nullptr, clusters);
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
