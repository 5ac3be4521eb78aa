// Batched DTW on Hopper: the anti-diagonal wavefront DP and the backtrace.
//
// Replaces: exemplars_vc_tpu/align/dtw_pallas.py:dtw_wavefront_pallas (the
// Pallas kernel _make_kernel) and the device half of
// exemplars_vc_tpu/align/dtw.py:_backtrace, which the JAX package runs
// outside its kernel.
//
// Semantics (held exactly, the DP is min/add only):
//   D[i,j] = C[i,j] + min(D[i-1,j-1], D[i-1,j], D[i,j-1]), tie order
//   diag < up < left (codes 0, 1, 2), BIG = 1e30 with min(., BIG) clamps,
//   cells with i >= la or j >= lb cost BIG, the final raw cost is read at
//   diagonal d = la+lb-2, position i = la-1. Direction codes are written in
//   the skewed layout dirs[d, i] (d = i+j) for every d < Ta+Tb-1 and i < Ta,
//   so the output equals the Pallas kernel's and the plain twin's byte for
//   byte. A cell with j < 0 holds BIG, so the neighbours of row i are row
//   i-1 (up at d-1, diag at d-2) and row i itself (left at d-1), with row -1
//   BIG throughout; the origin's diag is 0, which gives best = 0, code 0.
//
// What bounds the wavefront: a chain of Ta+Tb-1 dependent diagonals. Its
// bytes (the cells of C inside the pair's lengths read once, every code
// written once) take ~25 us for the main path's 8 pairs of <= 1408 rows; a
// step costs a few dependent float ops plus whatever hands rows over. The
// design (measured on an H100, see PERF.md):
//   - a systolic sweep: lane l of chain warp g owns R consecutive rows
//     i0 = (32 g + l) R .. i0+R-1 and at step d computes cells (i, d-i).
//     Rows inside a lane read their neighbour from registers; the lane's
//     first row reads the previous lane's last row through __shfl_up_sync,
//     so within a warp no barrier is needed at all;
//   - steps go in chunks of K (16 at R = 1, 4 at R = 8). Within a CTA, warp g
//     hands its last row to warp g+1 a chunk at a time, through a
//     double-buffered chunk in shared memory and a named barrier of the warp
//     pair (bar.sync id, 64): warp g+1 runs one chunk behind warp g, no warp
//     waits on the whole CTA;
//   - a pair's warps are spread over a thread-block cluster of up to 8 CTAs
//     (at R = 1, 6 warps an SM for the main path's 8 pairs of 1408 rows, 3
//     for the MCD's one pair of 683), so few rows share an SM. The last warp
//     of a CTA feeds the next CTA's first warp through Hopper's own
//     hand-off: st.async into 4 chunk buffers of the peer's shared memory,
//     counted on the peer's mbarrier (complete_tx), and the same back for
//     "buffer read". Neither side fences or polls memory: a release or a
//     strong poll at cluster scope waits for the thread's global loads and
//     stores in flight (~600 cycles a step when measured), and weak polled
//     slots handed over wrong values;
//   - the cost is streamed ahead of the sweep: a lane reads its row of C
//     contiguously over time (j = d - i), as 16-byte blocks one chunk ahead
//     in registers (volatile loads, so the compiler does not sink them to
//     their use) and two chunks ahead as an L2 prefetch;
//   - the codes of a chunk are staged in shared memory and leave in a few
//     wide stores (each global store instruction costs the SM ~20 cycles,
//     whatever its width): 16-byte vectors where Ta % 16 == 0, else aligned
//     words and a pass for the edge bytes;
//   - a step has no branch: stores are predicated, the final cost is kept by
//     a select, and chunks away from the edges (j < 0, the last diagonal, the
//     final cost) skip those selects.
// What bounds it (measured at R = 1 by dropping one part at a time, with
// the 8-step chunks the kernel had before they grew to 16): ~316 cycles a
// step, of which the steps alone ~84; the waits and hand-offs along the
// warp chain ~120 (a chain of 44 warps for the main path pays its fill
// too), picking the costs out of their blocks and waiting for their loads
// ~70, the shuffle ~35, the flush and load issue ~20. A 4-deep in-CTA
// hand-off moved the wait rather than removing it, and fetching three
// chunks ahead spilled registers; both were slower and are not kept.
// 16-step chunks at R = 1 took ~6 % off the 8-step ones; 32-step ones were
// slower (the chain's fill, ~44 warps x a chunk, grows with the chunk).
// Two variants are compiled: R = 1 covers Ta up to 8 CTAs x 16 warps x 32
// lanes = 4096, R = 8 up to 32,768 (2, 4 rows a lane were slower).
//
// The backtrace walks the path once, from (la-1, lb-1) to the origin, with
// one CTA a pair. The codes it reads are staged into shared memory a window
// at a time: 256 diagonals x 128 rows of the skewed dirs, read coalesced by
// seven warps as aligned words, all of a thread's loads in flight at once.
// A window is anchored where the walk stands when its load starts; the walk
// (one lane) needs at least 128 steps to leave it (d falls by at most 2 a
// step, i by at most 1) and uses it for at most 128, in two phases of 64
// steps; during each phase the other warps load the next window, anchored
// at the phase's start. The walk emits the path reversed, then the CTA
// reverses it and writes the -1 padding in parallel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define EVC_BIG 1e30f

constexpr int EVC_DTW_MAX_CLUSTER = 8;   // portable cluster size
constexpr int EVC_DTW_MAX_WARPS = 16;    // warps a CTA (512 threads)
constexpr int EVC_DTW_LINK_BUFS = 4;    // chunk buffers of the link between two CTAs
constexpr int EVC_DTW_MAX_K = 16;

// the named barrier of a warp pair of one CTA: warps w and w+1 use id 1 + w
// (0 is __syncthreads'), 64 threads
__device__ __forceinline__ void evc_pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// The link between two CTAs of a cluster (Hopper's own hand-off through
// distributed shared memory): the producer writes with st.async, which
// counts its bytes on an mbarrier in the consumer's CTA; the consumer waits
// on that barrier (try_wait.parity), reads, re-arms it, and tells the
// producer the buffer is free the same way, through an st.async onto an
// mbarrier in the producer's CTA. Neither side fences or polls memory.
__device__ __forceinline__ unsigned evc_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned evc_mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void evc_mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// arrive on this CTA's barrier and expect `bytes` more for the current phase
__device__ __forceinline__ void evc_mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void evc_mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{ .reg .pred p; EVC_WAIT_%=: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1; "
      "@!p bra EVC_WAIT_%=; }" ::"r"(bar), "r"(parity)
      : "memory");
}

// 4 bytes to a peer's shared memory, counted on the peer's barrier
__device__ __forceinline__ void evc_st_async_if(unsigned a, unsigned v, unsigned bar, bool c) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %3, 0; "
      "@q st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2]; }" ::"r"(a),
      "r"(v), "r"(bar), "r"((int)c)
      : "memory");
}

// a predicated store to this CTA's shared memory (32-bit window address)
__device__ __forceinline__ void evc_sts_if(unsigned a, float v, bool c) {
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %2, 0; @q st.shared.f32 [%0], %1; }"
               ::"r"(a), "f"(v), "r"((int)c));
}

__device__ __forceinline__ void evc_prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 16 bytes of C, issued where written: a volatile asm is not sunk towards its
// use, as a plain read-only load may be
__device__ __forceinline__ float4 evc_ld_v4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float evc_f4(const float4& q, int e) {
  return e == 0 ? q.x : (e == 1 ? q.y : (e == 2 ? q.z : q.w));
}

// Shared state of one CTA: the double-buffered boundary chunks of its warp
// pairs, and both ends of the links with its neighbours in the cluster: the
// inbound chunk buffers and their barriers (first warp), the barriers of the
// outbound link (last warp).
struct DtwShared {
  float pair_buf[EVC_DTW_MAX_WARPS][2][EVC_DTW_MAX_K];   // [producer warp][chunk parity][k]
  float link_buf[EVC_DTW_LINK_BUFS][EVC_DTW_MAX_K];      // inbound link: chunks of the CTA before
  unsigned long long full[EVC_DTW_LINK_BUFS];            // inbound link: a chunk has landed
  unsigned long long empty[EVC_DTW_LINK_BUFS];           // outbound link: the next CTA has read one
  unsigned sink;                                         // target of the next CTA's "read" signal
};

// One lane of the chain: its R rows' state, and one chunk of K steps.
//
// A lane reads its row of C contiguously over time, K floats a chunk. It
// reads them as the 16-byte-aligned blocks that cover them: block 0 of a
// chunk is the last block of the chunk before, so a chunk costs K/4 vector
// loads a row, issued one chunk before use; the K values are picked out by
// the row's alignment phase (constant along the row, as K % 4 == 0).
template <int R, int K>
struct DtwLane {
  static_assert(K % 4 == 0 && K <= EVC_DTW_MAX_K, "chunk");
  static_assert(R == 1 || R == 8, "rows a lane");
  static constexpr int NB = K / 4;   // new blocks a chunk
  const float* Cn;
  int8_t* dn;
  int ta, tb, la, lb, n_diag, end_d, i0, lane, warp;
  int end_r;                // the row of this lane that is la-1, or -1
  float final_cost;         // row la-1 at diagonal end_d, once swept
  float last_in;            // the producer's last row at the step before this chunk
  int g;                  // place of this warp in the pair's chain
  uint8_t* stage;         // this warp's K x 32R codes of the chunk (shared memory)
  // the producer of this warp's first row: none, a warp of this CTA (pair
  // barrier), or the last warp of the CTA before (link); likewise the consumer
  bool prod_pair, prod_link, cons_pair, cons_link;
  DtwShared* sh;                     // this CTA's
  unsigned peer_buf, peer_full;      // the next CTA's link buffers and barriers
  unsigned peer_sink, peer_empty;    // the previous CTA's sink and barriers
  float v[R];             // row i0+r at the last diagonal computed
  float u[R];             // row i0+r-1 at the diagonal before that (the next diag)
  const float* rowp[R];   // row i0+r of C
  int phi[R];             // alignment phase of the row: (address / 4) % 4 at column 0
  int elem[R];            // element of block 0 that holds a chunk's first column
  int lb_row[R];          // lb, or 0 for a row past la: columns [0, lb_row) cost C
  float4 keep[R];         // block 0 of the next chunk
  float4 nb[R][NB];       // blocks 1..NB of the next chunk, in flight

  // a block of row i from column jb holds a cell of the pair
  __device__ __forceinline__ bool block_ok(int i, int jb) const {
    return i < la && jb + 4 > 0 && jb < lb;
  }

  // first column of the aligned block that holds column j of row r
  __device__ __forceinline__ int block_col(int r, int j) const {
    return j - ((phi[r] + j) & 3);
  }

  __device__ __forceinline__ void init_rows() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      v[r] = EVC_BIG;
      u[r] = (i == 0) ? 0.0f : EVC_BIG;   // the origin's diag: best = 0, code 0
      rowp[r] = Cn + (size_t)i * tb;
      phi[r] = (int)((reinterpret_cast<uintptr_t>(rowp[r]) >> 2) & 3);
      elem[r] = (phi[r] - i) & 3;   // chunks start on multiples of 4
      lb_row[r] = i < la ? lb : 0;
      keep[r] = make_float4(EVC_BIG, EVC_BIG, EVC_BIG, EVC_BIG);
#pragma unroll
      for (int b = 0; b < NB; ++b) nb[r][b] = keep[r];
      const int jb = block_col(r, -i);   // block 0 of chunk 0 (column j = -i)
      if (block_ok(i, jb)) keep[r] = evc_ld_v4(rowp[r] + jb);
    }
  }

  // issue blocks 1..NB of the chunk at d0, and the L2 prefetch two chunks on
  __device__ __forceinline__ void fetch(int d0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      const int jb = block_col(r, d0 - i);
#pragma unroll
      for (int b = 1; b <= NB; ++b)
        if (block_ok(i, jb + 4 * b)) nb[r][b - 1] = evc_ld_v4(rowp[r] + jb + 4 * b);
      const int jp = jb + 2 * K;
      if (block_ok(i, jp)) evc_prefetch_l2(rowp[r] + jp);
    }
  }

  // the costs of the chunk at d0 (a multiple of 4) from its blocks: BIG
  // outside the pair
  __device__ __forceinline__ void extract(int d0, float (&c)[R][K]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float x[4];   // elements k .. k+3 of (keep, nb[0], nb[1], ...)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = k + q;
          x[q] = t < 4 ? evc_f4(keep[r], t) : evc_f4(nb[r][t / 4 - 1], t % 4);
        }
        const int e = elem[r];
        const float val = e == 0 ? x[0] : (e == 1 ? x[1] : (e == 2 ? x[2] : x[3]));
        c[r][k] = (unsigned)(d0 + k - i) < (unsigned)lb_row[r] ? val : EVC_BIG;
      }
      keep[r] = nb[r][NB - 1];
    }
  }

  // The producer's last row at steps d0-1 .. d0+K-2, for lane 0: its chunk
  // at d0 (d0-1 kept from the chunk before), from pair_buf after the pair
  // barrier that ends it (a warp of this CTA), or from link_buf once the
  // link's barrier has counted its bytes (the last warp of the CTA before).
  __device__ __forceinline__ void inbound(int d0, float (&rin)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) rin[k] = EVC_BIG;
    const int c = d0 / K;
    const float* buf = nullptr;
    if (prod_pair) {
      evc_pair_sync(warp);   // the producer (warp - 1) has finished its chunk at d0
      buf = sh->pair_buf[warp - 1][c & 1];
    } else if (prod_link && lane == 0) {
      const int b = c % EVC_DTW_LINK_BUFS;
      evc_mbar_wait(evc_smem(&sh->full[b]), (c / EVC_DTW_LINK_BUFS) & 1);
      buf = sh->link_buf[b];
    }
    if (buf != nullptr && lane == 0) {
      rin[0] = last_in;
#pragma unroll
      for (int k = 1; k < K; ++k) rin[k] = buf[k - 1];
      last_in = buf[K - 1];
    }
    if (prod_link && lane == 0) {
      // re-arm this buffer for its next chunk, then tell the producer it is free
      const int b = c % EVC_DTW_LINK_BUFS;
      evc_mbar_expect(evc_smem(&sh->full[b]), K * 4);
      evc_st_async_if(peer_sink, 0u, peer_empty + 8 * b, true);
    }
    if (cons_link && lane == 31 && c >= EVC_DTW_LINK_BUFS) {
      // the next CTA has read what this chunk overwrites; arm the next round
      const int b = c % EVC_DTW_LINK_BUFS;
      const unsigned bar = evc_smem(&sh->empty[b]);
      evc_mbar_wait(bar, ((c / EVC_DTW_LINK_BUFS) - 1) & 1);
      evc_mbar_expect(bar, 4);
    }
    __syncwarp();
  }

  // after the sweep: the next CTA has read every chunk sent to it, so no
  // st.async of its is still on the way to this CTA when it exits
  __device__ __forceinline__ void drain(int n_chunks) {
    if (!(cons_link && lane == 31)) return;
    for (int c = max(n_chunks - EVC_DTW_LINK_BUFS, 0); c < n_chunks; ++c)
      evc_mbar_wait(evc_smem(&sh->empty[c % EVC_DTW_LINK_BUFS]), (c / EVC_DTW_LINK_BUFS) & 1);
  }

  // K steps from diagonal d0; the next chunk's cost blocks go out meanwhile.
  // Nothing in a step branches: stores are predicated, the final cost is
  // kept by a select. EDGE: a chunk where this warp may meet a cell with
  // j < 0, the last diagonal, or the final cost (warp-uniform); the other
  // chunks skip those selects.
  template <bool EDGE>
  __device__ __forceinline__ void chunk(int d0) {
    float c[R][K];
    extract(d0, c);
    fetch(d0 + K);
    float rin[K];
    inbound(d0, rin);
    const unsigned pair_out =
        (unsigned)__cvta_generic_to_shared(&sh->pair_buf[warp][(d0 / K) & 1][0]);
    const bool pair_lane = cons_pair && lane == 31;
    const bool link_lane = cons_link && lane == 31;
    const int lb_idx = (d0 / K) % EVC_DTW_LINK_BUFS;
    const unsigned link_buf = peer_buf + 4 * EVC_DTW_MAX_K * lb_idx;
    const unsigned link_full = peer_full + 8 * lb_idx;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k;
      float in = __shfl_up_sync(0xffffffffu, v[R - 1], 1);
      if (lane == 0) in = rin[k];
      unsigned long long pack = 0;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {   // descending: v[r-1] is still diagonal d-1
        const float up = (r == 0) ? in : v[r > 0 ? r - 1 : 0];
        const float dg = u[r];
        const float best = fminf(fminf(dg, up), v[r]);
        const unsigned long long code = (best == dg) ? 0ull : ((best == up) ? 1ull : 2ull);
        const float nv = fminf(c[r][k] + fminf(best, EVC_BIG), EVC_BIG);
        u[r] = up;
        v[r] = (!EDGE || d >= i0 + r) ? nv : EVC_BIG;
        pack |= code << (8 * r);
        if (EDGE) final_cost = (r == end_r && d == end_d) ? v[r] : final_cost;
      }
      uint8_t* st = stage + k * 32 * R + lane * R;
      if (R == 1) *st = (uint8_t)pack;
      if (R == 8) *reinterpret_cast<unsigned long long*>(st) = pack;
      evc_sts_if(pair_out + 4 * k, v[R - 1], pair_lane);
      evc_st_async_if(link_buf + 4 * k, __float_as_uint(v[R - 1]), link_full, link_lane);
    }
    if (cons_pair) evc_pair_sync(warp + 1);   // this chunk is in pair_buf for warp + 1
    flush<EDGE>(d0);
  }

  // The chunk's codes, staged K diagonals x 32R rows, leave in as few
  // global stores as the alignment allows: each store instruction costs the
  // SM ~20 cycles whatever its width (measured), against ~1 for a shared one.
  // Ta % 16 == 0: one 16-byte vector a lane. Otherwise 4-byte words for the
  // aligned body of each diagonal, then a pass for the edge bytes.
  template <bool EDGE>
  __device__ __forceinline__ void flush(int d0) {
    __syncwarp();
    const int ibase = 32 * R * g;
    const int w = min(32 * R, ta - ibase);   // rows of this warp below ta
    int8_t* row0 = dn + (size_t)d0 * ta + ibase;
    if (ta % 16 == 0) {
      constexpr int NV = 2 * R;   // 16-byte vectors a diagonal
#pragma unroll
      for (int t = lane; t < K * NV; t += 32) {
        const int k = t / NV, q = t % NV;
        if (16 * q < w && (!EDGE || d0 + k < n_diag))
          *reinterpret_cast<uint4*>(row0 + (size_t)k * ta + 16 * q) =
              *reinterpret_cast<const uint4*>(stage + k * 32 * R + 16 * q);
      }
      return;
    }
    constexpr int NW = 8 * R;   // at most 8R whole words in 32R bytes
#pragma unroll
    for (int t = lane; t < K * NW; t += 32) {
      const int k = t / NW, q = t % NW;
      int8_t* rk = row0 + (size_t)k * ta;
      const int h = (int)((4 - (reinterpret_cast<uintptr_t>(rk) & 3)) & 3);   // head bytes
      const int off = h + 4 * q;                      // stage column of the word
      if (off + 4 <= w && (!EDGE || d0 + k < n_diag)) {
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(stage + k * 32 * R + (off & ~3));
        const uint32_t word = (off & 3) ? __funnelshift_r(sw[0], sw[1], 8 * (off & 3)) : sw[0];
        *reinterpret_cast<uint32_t*>(rk + off) = word;
      }
    }
#pragma unroll
    for (int t = lane; t < K * 8; t += 32) {   // 3 head and 3 tail bytes at most
      const int k = t / 8, e = t % 8;
      int8_t* rk = row0 + (size_t)k * ta;
      const int h = (int)((4 - (reinterpret_cast<uintptr_t>(rk) & 3)) & 3);
      const int hw = min(h, w);
      const int body = hw + ((w - hw) & ~3);       // first tail column
      const int col = e < 4 ? e : body + (e - 4);
      const bool ok = e < 4 ? e < hw : col < w;
      if (ok && (!EDGE || d0 + k < n_diag)) rk[col] = (int8_t)stage[k * 32 * R + col];
    }
  }
};

template <int R, int K>
__global__ void __launch_bounds__(EVC_DTW_MAX_WARPS * 32)
    dtw_wavefront_kernel(const float* __restrict__ C, const int* __restrict__ lens, int ta,
                         int tb, float* __restrict__ cost, int8_t* __restrict__ dirs) {
  __shared__ DtwShared sh;
  __shared__ __align__(16) uint8_t stage[EVC_DTW_MAX_WARPS][K * 32 * R];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int wpc = (int)(blockDim.x >> 5);
  const int warp = (int)(threadIdx.x >> 5);
  const int n = blockIdx.x / csize;
  const int g = rank * wpc + warp;                 // place in the pair's warp chain
  const int n_warps = (ta + 32 * R - 1) / (32 * R);
  if (threadIdx.x == 0) {
    // one arrival a phase (the owner's re-arm) plus the bytes of the phase
    for (int b = 0; b < EVC_DTW_LINK_BUFS; ++b) {
      evc_mbar_init(evc_smem(&sh.full[b]), 1);
      evc_mbar_init(evc_smem(&sh.empty[b]), 1);
      evc_mbar_expect(evc_smem(&sh.full[b]), K * 4);
      evc_mbar_expect(evc_smem(&sh.empty[b]), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();   // every CTA's barriers are set before a peer signals them

  if (g < n_warps) {
    DtwLane<R, K> s;
    s.ta = ta;
    s.tb = tb;
    s.la = lens[2 * n];
    s.lb = lens[2 * n + 1];
    s.n_diag = ta + tb - 1;
    s.end_d = s.la + s.lb - 2;
    s.lane = (int)(threadIdx.x & 31);
    s.warp = warp;
    s.i0 = (g * 32 + s.lane) * R;
    s.Cn = C + (size_t)n * ta * tb;
    s.dn = dirs + (size_t)n * s.n_diag * ta;
    s.g = g;
    s.stage = stage[warp];
    s.end_r = (s.la - 1 >= s.i0 && s.la - 1 < s.i0 + R) ? s.la - 1 - s.i0 : -1;
    s.final_cost = EVC_BIG;
    s.last_in = EVC_BIG;
    s.prod_pair = g > 0 && warp > 0;
    s.prod_link = g > 0 && warp == 0;
    s.cons_pair = g + 1 < n_warps && warp + 1 < wpc;
    s.cons_link = g + 1 < n_warps && warp + 1 == wpc;
    s.sh = &sh;
    s.peer_buf = s.cons_link ? evc_mapa(evc_smem(&sh.link_buf[0][0]), rank + 1) : 0u;
    s.peer_full = s.cons_link ? evc_mapa(evc_smem(&sh.full[0]), rank + 1) : 0u;
    s.peer_sink = s.prod_link ? evc_mapa(evc_smem(&sh.sink), rank - 1) : 0u;
    s.peer_empty = s.prod_link ? evc_mapa(evc_smem(&sh.empty[0]), rank - 1) : 0u;
    s.init_rows();
    s.fetch(0);
    // chunks where the warp's last row has started, before the last diagonal
    // and away from the final cost run without the edge selects
    const int started = (g * 32 + 31) * R + R - 1;
    for (int d0 = 0; d0 < s.n_diag; d0 += K) {
      const bool edge = d0 < started || d0 + K > s.n_diag ||
                        (s.end_d >= d0 && s.end_d < d0 + K);
      if (edge)
        s.template chunk<true>(d0);
      else
        s.template chunk<false>(d0);
    }
    s.drain((s.n_diag + K - 1) / K);
    if (s.end_r >= 0) cost[n] = s.final_cost;
  }
  cluster.sync();   // no CTA leaves while a peer may still signal it
}

// ---------------------------------------------------------------------------
// backtrace
// ---------------------------------------------------------------------------

constexpr int EVC_BT_WD = 256;              // window: diagonals
constexpr int EVC_BT_WI = 128;              // window: rows
constexpr int EVC_BT_RS = EVC_BT_WI + 4;    // bytes a staged diagonal (rows from a multiple of 4)
constexpr int EVC_BT_STEPS = 64;            // walk steps a phase; two phases a window
constexpr int EVC_BT_THREADS = 256;
constexpr size_t EVC_BT_SMEM = 2 * (size_t)EVC_BT_WD * EVC_BT_RS;
static_assert(2 * EVC_BT_STEPS <= EVC_BT_WD / 2 && 2 * EVC_BT_STEPS <= EVC_BT_WI, "window");

// First staged row of a window anchored at row i: a multiple of 4 at least
// EVC_BT_WI - 1 below it.
__device__ __forceinline__ int evc_bt_row0(int i) {
  const int lo = i - EVC_BT_WI + 1;
  return lo > 0 ? (lo & ~3) : 0;
}

// Stage dn[d, i] for d in (ad - WD, ad], i in [row0, min(row0 + RS, ta)) into
// win (row ad - d, column i - row0), by NT threads (t in [0, NT)). A staged
// diagonal is read as the aligned 4-byte words that cover it, all of a
// thread's loads issued before any is used; a word lands in win whole where
// the diagonal starts on a multiple of 4 (Ta % 4 == 0), else byte by byte.
constexpr int EVC_BT_WPR = EVC_BT_RS / 4 + 1;   // words covering RS bytes at any alignment

template <int NT>
__device__ __forceinline__ void evc_bt_stage(uint8_t* win, const int8_t* dn, int ta, int ad,
                                             int row0, int t) {
  constexpr int ITERS = (EVC_BT_WD * EVC_BT_WPR + NT - 1) / NT;
  const int nvalid = min(EVC_BT_RS, ta - row0);
  uint32_t word[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = t + it * NT;
    const int dd = idx / EVC_BT_WPR, w = idx - dd * EVC_BT_WPR, d = ad - dd;
    const uintptr_t a = reinterpret_cast<uintptr_t>(dn + (size_t)d * ta + row0);
    const int sh = (int)(a & 3);
    word[it] = 0;
    if (dd < EVC_BT_WD && d >= 0 && 4 * w < sh + nvalid)
      word[it] = __ldg(reinterpret_cast<const uint32_t*>(a - sh) + w);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = t + it * NT;
    const int dd = idx / EVC_BT_WPR, w = idx - dd * EVC_BT_WPR, d = ad - dd;
    if (dd >= EVC_BT_WD || d < 0) continue;
    const int sh = (int)(reinterpret_cast<uintptr_t>(dn + (size_t)d * ta + row0) & 3);
    uint8_t* row = win + dd * EVC_BT_RS;
    if (sh == 0) {
      if (4 * w < nvalid) *reinterpret_cast<uint32_t*>(row + 4 * w) = word[it];
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pos = 4 * w + b - sh;
        if (pos >= 0 && pos < nvalid) row[pos] = (uint8_t)(word[it] >> (8 * b));
      }
    }
  }
}

__global__ void __launch_bounds__(EVC_BT_THREADS)
    dtw_backtrace_kernel(const int8_t* __restrict__ dirs, const int* __restrict__ lens, int ta,
                         int tb, int* __restrict__ path_i, int* __restrict__ path_j,
                         int* __restrict__ path_len) {
  extern __shared__ __align__(16) uint8_t bt_win[];   // two windows
  __shared__ int pos_d[2], pos_i[2], walk_done[2], walk_len;
  const int n = blockIdx.x;
  const int t = (int)threadIdx.x;
  const int max_path = ta + tb - 1;
  const int la = lens[2 * n];
  const int lb = lens[2 * n + 1];
  const int8_t* dn = dirs + (size_t)n * max_path * ta;
  int* pi = path_i + (size_t)n * max_path;
  int* pj = path_j + (size_t)n * max_path;

  if (t == 0) {
    pos_d[0] = la + lb - 2;
    pos_i[0] = la - 1;
    walk_done[0] = 0;
  }
  // window 0, anchored at the path's end, staged by the whole CTA
  int cur_d = la + lb - 2, cur_r = evc_bt_row0(la - 1);   // anchor of window cur
  evc_bt_stage<EVC_BT_THREADS>(bt_win, dn, ta, cur_d, cur_r, t);
  __syncthreads();

  // walker state, kept by thread 0 across phases
  int d = la + lb - 2, i = la - 1, k = 0;
  int cur = 0;
  for (int ph = 0;; ++ph) {
    const int p = ph & 1;
    if (walk_done[p]) break;   // uniform: written before the last barrier
    const int ad = pos_d[p], ai = pos_i[p];
    const int nxt = cur ^ 1;
    const int nxt_r = evc_bt_row0(ai);   // window nxt is anchored at (ad, ai)
    if (t == 0) {
      // the walk: at most EVC_BT_STEPS steps inside window cur
      const uint8_t* w = bt_win + (size_t)cur * EVC_BT_WD * EVC_BT_RS;
      int off = (cur_d - d) * EVC_BT_RS + (i - cur_r);
      int done = 0;
      for (int s = 0; s < EVC_BT_STEPS; ++s) {
        pi[k] = i;
        pj[k] = d - i;
        ++k;
        if (d == 0 || k >= max_path) {   // the origin (i = j = 0), or a full row
          done = 1;
          break;
        }
        const int code = w[off];
        if ((code != 2 && i == 0) || (code != 1 && d == i)) {   // off an inconsistent dirs
          done = 1;
          break;
        }
        const int up = code != 2;   // diag and up leave the row
        d -= 1 + (code == 0);
        i -= up;
        off += EVC_BT_RS + (code == 0 ? EVC_BT_RS : 0) - up;
      }
      pos_d[p ^ 1] = d;
      pos_i[p ^ 1] = i;
      walk_done[p ^ 1] = done;
      if (done) walk_len = k;
    } else if (t >= 32) {
      // the next window, anchored where the walk stood at this phase's start
      evc_bt_stage<EVC_BT_THREADS - 32>(bt_win + (size_t)nxt * EVC_BT_WD * EVC_BT_RS, dn, ta,
                                        ad, nxt_r, t - 32);
    }
    __syncthreads();
    cur = nxt;
    cur_d = ad;
    cur_r = nxt_r;
  }

  // the walk wrote the path from its end: reverse it, then pad with -1
  const int len = walk_len;
  for (int q = t; q < len / 2; q += EVC_BT_THREADS) {
    const int r = len - 1 - q;
    const int a = pi[q], b = pj[q];
    pi[q] = pi[r];
    pj[q] = pj[r];
    pi[r] = a;
    pj[r] = b;
  }
  for (int q = len + t; q < max_path; q += EVC_BT_THREADS) {
    pi[q] = -1;
    pj[q] = -1;
  }
  if (t == 0) path_len[n] = len;
}

template <int R, int K>
static cudaError_t evc_launch_wavefront(const float* C, const int* lens, int n, int ta, int tb,
                                        int cluster, int warps, float* cost, int8_t* dirs,
                                        cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dtw_wavefront_kernel<R, K>, C, lens, ta, tb, cost, dirs);
}

extern "C" {

const char* evc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// C (n, ta, tb) f32, lens (n, 2) i32 -> cost (n,) f32, dirs (n, ta+tb-1, ta) i8.
// The plan: rows a lane (1 or 8), CTAs a pair's cluster (1..8), warps
// a CTA (1..16), covering at least ta rows; any other plan is refused
// (cudaErrorInvalidValue) before a launch.
int evc_dtw_wavefront(const float* C, const int* lens, int n, int ta, int tb, int rows_per_lane,
                      int cluster, int warps, float* cost, int8_t* dirs, void* stream) {
  if (n < 1 || ta < 1 || tb < 1 || cluster < 1 || cluster > EVC_DTW_MAX_CLUSTER || warps < 1 ||
      warps > EVC_DTW_MAX_WARPS ||
      (long long)cluster * warps * 32 * rows_per_lane < (long long)ta)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (rows_per_lane) {
    case 1: e = evc_launch_wavefront<1, 16>(C, lens, n, ta, tb, cluster, warps, cost, dirs, s); break;
    case 8: e = evc_launch_wavefront<8, 4>(C, lens, n, ta, tb, cluster, warps, cost, dirs, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dirs (n, ta+tb-1, ta) i8, lens (n, 2) i32 -> ascending paths (n, ta+tb-1)
// i32 padded with -1, path_len (n,) i32.
int evc_dtw_backtrace(const int8_t* dirs, const int* lens, int n, int ta, int tb, int* path_i,
                      int* path_j, int* path_len, void* stream) {
  // the opt-in to more than 48 KB of shared memory is a setting of the
  // current device: made on every call, so any card and any thread has it
  const cudaError_t e = cudaFuncSetAttribute(
      dtw_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)EVC_BT_SMEM);
  if (e != cudaSuccess) return (int)e;
  dtw_backtrace_kernel<<<n, EVC_BT_THREADS, EVC_BT_SMEM, (cudaStream_t)stream>>>(
      dirs, lens, ta, tb, path_i, path_j, path_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
