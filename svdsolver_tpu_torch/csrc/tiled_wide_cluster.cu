// The pivot-block column of one half-sweep of the tiled Stage I at wide
// bands (the multicore rung past t = 168): every reflector of a tile
// column's slabs, on one thread-block cluster that holds the pivot block
// in registers.
//
// Stands for no TPU kernel: the JAX package runs a half-sweep as
// lax.fori_loops over _factor_1slab and _factor_2slab
// (svdsolver_tpu/models/tiled.py:59, :72), each a fori_loop over
// _slab_factor_step (:33), which XLA compiles to one device program.  Its
// plain version is models/tiled.chain_plain; tiled_apply.cu's wide
// instances apply the history it leaves to the other columns.
//
// A half-sweep (top, pc): the 1-slab on rows [top, top + t) (R = t), then a
// TS slab for each tile row below, rows [top, top + t) over [top + s t,
// top + s t + t) (R = 2t), s = 1 .. m.  Step j of a slab takes the
// reflector of column pc + j, pivot at local row j, and applies it to every
// column of the pivot block.
//
// Why a cluster: at t = 256 a TS slab's pivot block is 2t x t floats
// (512 KB), more than one SM's registers and shared memory together; 2 MB
// at t = 512.  tiled_chain.cu holds it in one CTA's registers up to
// t = 128; tiled_wide.cu (one CTA, the block by column in device memory,
// a block barrier a step) takes any band at ~16 us a step.
//
// Design: C = ceil(t / W) CTAs of 16 warps, W = 16 NC columns each.  CTA c
// owns the contiguous columns [c W, c W + W), dealt cyclically to its
// warps: warp w holds local columns w + 16 i (i < NC) in registers, row
// lane + 32 k in x[i][k] (RPL rows a lane, 16 or 32: the rows of a TS
// slab, zeros past them).  So pivot j + 1 lies on the same SM as pivot j
// except at C - 1 hand-overs a slab.  Each CTA keeps a ring of K reflector
// slots in shared memory (32 RPL floats of v, then tau), each with a
// "full" mbarrier (one arrival and the copy's bytes a use).  Step j, in
// every warp of every CTA:
//  * wait on the full barrier of reflector j's slot, load v from the
//    pivot's row group down into registers;
//  * the warp owning column j + 1 (which claimed its slot before the wait)
//    updates that column first, computes reflector j + 1 from its
//    registers straight into its own CTA's slot (svdt_tiled::reflector's
//    arithmetic), arrives on that slot's full barrier, and copies the slot
//    into every other CTA's slot by cp.async.bulk shared::cta ->
//    shared::cluster, each copy completing the transaction bytes of the
//    remote full barrier it armed with a remote arrive.expect_tx; then it
//    writes the history (device memory, 32 rpl floats a reflector, the
//    apply's layout);
//  * every warp applies reflector j to its columns (the dots, one
//    multi-column butterfly, the rank-1 updates: svdt_tiled::apply_all).
// A slot is free again when every warp of every CTA has read it: each
// warp arrives on the slot's "empty" mbarrier in the CTA that owns the
// column of the slot's next use (step j + K: known to every reader), and
// that CTA's producer waits on it (16 C arrivals a phase; the phases of a
// CTA's barrier are its own productions into the slot, so each CTA
// counts them).  The broadcast's remote arrivals and copies go out one
// lane a destination CTA.  No cluster barrier a step; the ring runs on
// across slabs.  At a slab's end each CTA swaps its columns' tile rows
// with the next tile, prefetched by cp.async into shared memory while the
// slab ran, and writes the finished tile back.
// The arithmetic of a column is tiled_slab.cuh's in tiled_wide.cu's order,
// so every bit of the block and the history is wide_chain_kernel's (and
// through it the first design's and the two-kernel design's).
//
// What bounds it on the H100: the chain of t steps a slab (the pivot
// column's dot, butterfly and update, then a reflector: two warp
// reductions, a square root, the divisions), a cross-SM hop at C - 1 of
// them, and each SM's share of the pivot block's operations, 4 W
// sum_j (R - j) a slab (5 instructions for 4 of them, rounded one at a
// time; no tensor cores, no TF32).  A step is latency-bound: the pivot's
// update, reflector and local arrival, ~3,500 cycles at t = 256 with the
// other warps' applies beside them (tools/tiled_split.py --wide --stamps);
// 16 or 8 CTAs take about the same time, 4 lose a third (--plans).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_slab.cuh"

namespace cg = cooperative_groups;

// A timing build's clock stamps (tools/tiled_split.py --stamps): lane 0 of
// each warp of each CTA stamps the first 128 steps of slab 1; empty in the
// package's build.  Slots: 6 before the next pivot's claim of its slot, 0
// before the wait, 1 after it (v loaded), 2 after the pivot column's
// update, 3 after the reflector, 4 after the broadcast, 5 after the apply.
#ifdef SVDT_SPLIT_STAMPS
__device__ long long* g_stamps;
#define SVDT_STAMP(i)                                                   \
  if (lane == 0 && s == 1 && j < 128)                                   \
    g_stamps[(((size_t)blockIdx.x * 16 + warp) * 128 + j) * 8 + (i)] = clock64();
extern "C" int svdt_tiled_wide_cluster_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#else
#define SVDT_STAMP(i)
#endif

namespace {

using namespace svdt_tiled;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 16;
// A wait that spins this many cycles (~10 s) traps: a broken protocol
// ends the launch with an error instead of holding the card.
constexpr long long kSpinLimit = 20000000000LL;

struct Args {
  float* A;
  int ld, top, pc, t, m;
  float* hv;  // (m + 1) t reflectors of vld floats
  float* ht;  // (m + 1) t taus
  int vld;
  int slots;  // K
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of this CTA's `addr` in CTA `rank`.
__device__ __forceinline__ unsigned remote(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on this CTA's barrier (release: the warp's slot stores,
// ordered before it by __syncwarp, are seen by a thread whose wait returns).
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival on the barrier at shared::cluster address `bar` that also
// expects `bytes` of a copy.
__device__ __forceinline__ void bar_arrive_tx_remote(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` of this CTA's barrier (acquire).
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// `bytes` of this CTA's shared memory at src into CTA-of-`dst` shared memory,
// completing the transaction bytes of barrier `bar` there.
__device__ __forceinline__ void bulk_to_remote(unsigned dst, const void* src, unsigned bytes,
                                               unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// This warp's generic stores to shared memory, before a bulk copy reads them.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One arrival (release, CTA scope: this warp's reads of its own CTA's slot
// come before it) on the barrier at shared::cluster address `bar`.
__device__ __forceinline__ void bar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The reflector of the column whose row lane + 32 k is x[k], pivot at
// local row p < R, into `slot` (v on rows [0, 32 RPL): zero above p and
// from R on) and slot[32 RPL] (tau): svdt_tiled::reflector's operations in
// its order, each v entry stored as it is computed (no second array of
// RPL registers); a lane whose operands leave normal_mid stores
// __fdiv_rn's quotients over its fast ones, as reflector picks them.
template <int RPL>
__device__ __forceinline__ void reflector_to(const float (&x)[RPL], int p, int R, float* slot,
                                             int lane) {
  float piv = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane + 32 * k;
    if (r == p) piv = x[k];
    if (r > p && r < R) s2 = __fadd_rn(s2, __fmul_rn(x[k], x[k]));
  }
  piv = __shfl_sync(kFull, piv, p & 31);
  s2 = warp_sum(s2);
  const float nrm = sqrtf(__fadd_rn(__fmul_rn(piv, piv), s2));
  const float sign = piv >= 0.f ? 1.f : -1.f;
  const float beta = -sign * nrm;
  const bool trivial = s2 == 0.f;
  const float denom = trivial ? 1.f : __fsub_rn(piv, beta);
  const float safe = beta == 0.f ? 1.f : beta;
  const float num = __fsub_rn(beta, piv);
  const float r1 = recip_step(denom), rs = recip_step(safe);
  bool ok = normal_mid(denom) && (trivial || (normal_mid(num) && normal_mid(safe)));
  float tau = div_step(num, safe, rs);
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane + 32 * k;
    const float q = div_step(x[k], denom, r1);
    if (r > p && r < R) ok = ok && normal_mid(x[k]);
    slot[r] = r < R ? (r > p ? q : (r == p ? 1.f : 0.f)) : 0.f;
  }
  if (!ok) {  // rare: the compiler's division
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      if (r > p && r < R) slot[r] = __fdiv_rn(x[k], denom);
    }
    tau = __fdiv_rn(num, safe);
  }
  if (lane == 0) slot[32 * RPL] = trivial ? 0.f : tau;
}

// apply_all with the first row group fixed at compile time (k0 = j / 32,
// below RPL / 2 since j < t <= 16 RPL) and the last at run time (the
// slab's R rows); the groups between R and 32 RPL hold zeros in x and v,
// which stay +0 and add +0.
template <int NC, int RPL, int K0 = 0>
__device__ __forceinline__ void apply_from(float (&x)[NC][RPL], const float (&v)[RPL], float tau,
                                           int k0, int k1, int lane) {
  if constexpr (K0 < RPL / 2) {
    if (k0 != K0)
      apply_from<NC, RPL, K0 + 1>(x, v, tau, k0, k1, lane);
    else
      apply_all<NC, RPL>(x, v, tau, K0, k1, -1, lane);
  }
}

// Rows [r0, r0 + t) of the warp's live columns to (kStore), from, or
// swapped (kSwap) with the staging area S (t x (W + 1), row r at r - r0).
template <int NC, int RPL, bool kStore, bool kSwap = false>
__device__ __forceinline__ void stage(float (&x)[NC][RPL], float* S, int r0, int t, int live,
                                      int warp, int lane) {
  constexpr int W = 16 * NC;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = warp + 16 * c;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k - r0;
      if (q < live && r >= 0 && r < t) {
        float* p = S + r * (W + 1) + q;
        if (kSwap) {
          const float y = *p;
          *p = x[c][k];
          x[c][k] = y;
        } else if (kStore) {
          *p = x[c][k];
        } else {
          x[c][k] = *p;
        }
      }
    }
  }
}

// The t x live tile at A's rows [row0, row0 + t), columns [col0, col0 +
// live) into S by cp.async (one commit group), or S back to A.
__device__ __forceinline__ void tile_in(float* S, int W, const float* A, int ld, int row0,
                                        int col0, int t, int live, int tid) {
  for (int idx = tid; idx < t * live; idx += kThreads) {
    const int r = idx / live, q = idx - r * live;
    cp_async4(S + r * (W + 1) + q, A + (size_t)(row0 + r) * ld + col0 + q);
  }
  cp_commit();
}

__device__ __forceinline__ void tile_out(const float* S, int W, float* A, int ld, int row0,
                                         int col0, int t, int live, int tid) {
  for (int idx = tid; idx < t * live; idx += kThreads) {
    const int r = idx / live, q = idx - r * live;
    A[(size_t)(row0 + r) * ld + col0 + q] = S[r * (W + 1) + q];
  }
}

// The shared memory a CTA: the ring's full and empty barriers and this
// CTA's count of its waits on each empty barrier (a header of 5 K floats,
// rounded up to 128 bytes), the K slots, the staging tile
// (ops/cuda/tiled_slab.wide_chain_plan counts the same bytes).
template <int RPL>
struct Smem {
  static constexpr int kSlot = 32 * RPL + 4;  // v, then tau and padding: 16-byte multiple
  unsigned long long* full;
  unsigned long long* empty;
  unsigned* waits;
  float* ring;
  float* S;
  __device__ Smem(unsigned char* base, int K) {
    full = reinterpret_cast<unsigned long long*>(base);
    empty = full + K;
    waits = reinterpret_cast<unsigned*>(empty + K);
    ring = reinterpret_cast<float*>(base) + ((5 * K + 31) & ~31);
    S = ring + (size_t)K * kSlot;
  }
};

// Before reflector g goes into slot g % K: from its second use on, wait
// until every warp of every CTA has read the slot's previous use (this
// CTA's empty barrier, at the parity of this CTA's next wait on it).
template <int RPL>
__device__ __forceinline__ float* claim(const Smem<RPL>& sm, int g, int K, int lane) {
  const int i = g % K;
  if (g >= K) {
    if (lane == 0) {
      const unsigned k = sm.waits[i];
      bar_wait(sm.empty + i, k & 1u);
      sm.waits[i] = k + 1;
    }
    __syncwarp();
  }
  return sm.ring + (size_t)i * Smem<RPL>::kSlot;
}

// The slot of reflector g (pivot row group k0 = j / 32) to every CTA: this
// CTA's barrier by one arrival (before the proxy fence, which only the
// copies need), every other CTA's (lane r for CTA r) by a bulk copy of the
// slot from row 32 k0 on, which completes the bytes the remote arrival
// announced.
template <int RPL>
__device__ __forceinline__ void broadcast(const Smem<RPL>& sm, float* slot, int g, int K, int k0,
                                          int C, int rank, int lane) {
  const int i = g % K;
  __syncwarp();
  if (lane == 0) bar_arrive(sm.full + i);
  fence_to_async();
  __syncwarp();
  if (lane < C && lane != rank) {
    const unsigned bytes = 4u * (unsigned)(Smem<RPL>::kSlot - 32 * k0);
    const unsigned rbar = remote(smem_addr(sm.full + i), lane);
    bar_arrive_tx_remote(rbar, bytes);
    bulk_to_remote(remote(smem_addr(slot + 32 * k0), lane), slot + 32 * k0, bytes, rbar);
  }
}

// Reflector j of slab s into the history, from its slot: vld floats (the
// apply's layout, zeros past the slab's rows) and tau.
template <int RPL>
__device__ __forceinline__ void history(const Args& a, const float* slot, int s, int j,
                                        int lane) {
  float* h = a.hv + ((size_t)s * a.t + j) * a.vld;
  for (int r = lane; r < a.vld; r += 32) h[r] = slot[r];
  if (lane == 0) a.ht[(size_t)s * a.t + j] = slot[32 * RPL];
}

// This warp has read the slot of step g: one arrival on the slot's empty
// barrier in the CTA that owns the column of step g + K (W columns a CTA),
// where that step exists.
template <int RPL>
__device__ __forceinline__ void release(const Smem<RPL>& sm, int g, int K, int t, int W,
                                        int steps, int lane) {
  __syncwarp();
  const int next = g + K;
  if (lane == 0 && next < steps)
    bar_arrive_remote(remote(smem_addr(sm.empty + g % K), (next % t) / W));
}

// kApply false: the chain alone (the waits, the pivot columns' updates,
// the reflectors and their broadcast, the slab hand-overs; no other
// column's apply), the entry that times the chain's latency; its block and
// history are not the half-sweep's.
template <int NC, int RPL, bool kApply>
__global__ void __launch_bounds__(kThreads, 1) wide_cluster_kernel(Args a) {
  constexpr int W = 16 * NC;
  constexpr int kSlot = Smem<RPL>::kSlot;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)gridDim.x, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.slots, t = a.t;
  const Smem<RPL> sm(smem_raw, K);
  const int cbase = rank * W;
  const int live = min(W, t - cbase);  // this CTA's columns of the block
  float* const A = a.A;
  const int ld = a.ld, col0 = a.pc + cbase;
  const int steps = (a.m + 1) * t;

  if (tid < K) {
    bar_init(sm.full + tid, 1);
    bar_init(sm.empty + tid, kWarps * C);
    sm.waits[tid] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  float x[NC][RPL];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < RPL; ++k) x[c][k] = 0.f;
  tile_in(sm.S, W, A, ld, a.top, col0, t, live, tid);
  cp_wait_all();
  // every CTA's barriers initialised before any remote arrival; the top
  // tile staged
  cluster.sync();
  stage<NC, RPL, false>(x, sm.S, 0, t, live, warp, lane);
  __syncthreads();
  if (a.m > 0) tile_in(sm.S, W, A, ld, a.top + t, col0, t, live, tid);

  for (int s = 0; s <= a.m; ++s) {
    const int R = s == 0 ? t : 2 * t;
    const int k1 = (R + 31) >> 5;
    if (rank == 0 && warp == 0) {  // column 0: CTA 0's warp 0 first
      float* slot = claim(sm, s * t, K, lane);
      reflector_to<RPL>(x[0], 0, R, slot, lane);
      broadcast(sm, slot, s * t, K, 0, C, rank, lane);
      history<RPL>(a, slot, s, 0, lane);
    }
    for (int j = 0; j < t; ++j) {
      const int g = s * t + j, i = g % K;
      const int k0 = j >> 5;
      const int nx = j + 1;
      const int lq = nx - cbase;  // the next pivot's local column
      const bool pivot = nx < t && lq >= 0 && lq < W && (lq & 15) == warp;
      // the next pivot's warp claims its slot while it waits for reflector
      // j anyway (its previous use was step g + 1 - K <= g - 1: no warp
      // needs reflector j to have read it), so the claim is off the chain
      SVDT_STAMP(6);
      float* next = pivot ? claim(sm, g + 1, K, lane) : nullptr;
      SVDT_STAMP(0);
      bar_wait(sm.full + i, (unsigned)(g / K) & 1u);
      const float* slot = sm.ring + (size_t)i * kSlot;
      float v[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k) v[k] = k >= k0 ? slot[lane + 32 * k] : 0.f;
      const float tau = slot[32 * RPL];
      SVDT_STAMP(1);
      if (pivot) {
        const int skip = lq >> 4;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c == skip) {
            rank1(x[c], v, tau, warp_sum(dot_part(v, x[c], k0, k1)), k0, k1);
            SVDT_STAMP(2);
            reflector_to<RPL>(x[c], nx, R, next, lane);
            SVDT_STAMP(3);
            broadcast(sm, next, g + 1, K, nx >> 5, C, rank, lane);
            SVDT_STAMP(4);
            history<RPL>(a, next, s, nx, lane);
          }
        }
        release(sm, g, K, t, W, steps, lane);
        if (kApply) apply_all<NC, RPL>(x, v, tau, k0, k1, skip, lane);
      } else {
        release(sm, g, K, t, W, steps, lane);
        if (kApply) apply_from<NC, RPL>(x, v, tau, k0, k1, lane);
      }
      SVDT_STAMP(5);
    }
    // the slab's end: the next tile row (prefetched into S) into the
    // registers, the finished one back to A, the one after next into S
    cp_wait_all();
    __syncthreads();
    if (s < a.m) {
      if (s > 0)
        stage<NC, RPL, false, true>(x, sm.S, t, t, live, warp, lane);
      else
        stage<NC, RPL, false>(x, sm.S, t, t, live, warp, lane);
      __syncthreads();
      if (s > 0) {
        tile_out(sm.S, W, A, ld, a.top + s * t, col0, t, live, tid);
        __syncthreads();
      }
      if (s + 2 <= a.m) tile_in(sm.S, W, A, ld, a.top + (s + 2) * t, col0, t, live, tid);
    } else if (s > 0) {
      stage<NC, RPL, true>(x, sm.S, t, t, live, warp, lane);
      __syncthreads();
      tile_out(sm.S, W, A, ld, a.top + s * t, col0, t, live, tid);
      __syncthreads();
    }
  }
  stage<NC, RPL, true>(x, sm.S, 0, t, live, warp, lane);
  __syncthreads();
  tile_out(sm.S, W, A, ld, a.top, col0, t, live, tid);
  // no CTA leaves while another may still copy or count into its shared
  // memory
  cluster.sync();
}

template <int NC, int RPL, bool kApply>
int launch(const Args& a, int ctas, int smem, cudaStream_t stream) {
  auto kernel = wide_cluster_kernel<NC, RPL, kApply>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kApply>
int dispatch(const Args& a, int ctas, int cols, int rpl, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.t < 1 || a.m < 0 || a.top < 0 || a.pc < 0 || a.pc + a.t > a.ld || a.slots < 2 ||
      ctas < 1 || ctas > kMaxCluster || ctas * 16 * cols < a.t || 16 * rpl < a.t ||
      a.vld < 2 * a.t || a.vld > 32 * rpl)
    return (int)cudaErrorInvalidValue;
  if (cols == 2) {
    if (rpl == 16) return launch<2, 16, kApply>(a, ctas, smem, s);
    if (rpl == 32) return launch<2, 32, kApply>(a, ctas, smem, s);
  }
#ifdef SVDT_WIDE_PLANS  // the timing build of tools/tiled_split.py --wide --plans
  if (rpl == 16 && cols == 1) return launch<1, 16, kApply>(a, ctas, smem, s);
  if (rpl == 16 && cols == 4) return launch<4, 16, kApply>(a, ctas, smem, s);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the pivot-block column of half-sweep (top, pc) on `stream` as
// one cluster of `ctas` CTAs, in place on A (row-major, leading dimension
// ld, rows [top, top + (m + 1) t) the half-sweep's): the 1-slab and m TS
// slabs.  `cols` columns a warp (2; 1 and 4 at rpl 16 in the timing build
// SVDT_WIDE_PLANS; 16 cols columns a CTA, ctas 16 cols >= t), `rpl` rows a
// lane (16 or 32, 16 rpl >= t), `slots` reflector slots in the ring; hv ((m + 1) t reflectors of
// vld floats, 2t <= vld <= 32 rpl) and ht ((m + 1) t) receive the history;
// smem dynamic bytes a CTA (ops/cuda/tiled_slab.wide_chain_plan).  Returns
// the launch's cudaError_t.
extern "C" int svdt_tiled_wide_chain_cluster(float* A, int ld, int top, int pc, int t, int m,
                                             float* hv, float* ht, int vld, int ctas, int cols,
                                             int rpl, int slots, int smem, void* stream) {
  const Args a = {A, ld, top, pc, t, m, hv, ht, vld, slots};
  return dispatch<true>(a, ctas, cols, rpl, smem, stream);
}

// The chain alone, with the arguments of svdt_tiled_wide_chain_cluster: the
// same waits, pivot-column updates, reflectors, broadcasts and slab
// hand-overs, no other column's apply.  Its time is the chain's latency
// bound (A and the history are left as no half-sweep leaves them).
extern "C" int svdt_tiled_wide_chain_cluster_alone(float* A, int ld, int top, int pc, int t,
                                                   int m, float* hv, float* ht, int vld,
                                                   int ctas, int cols, int rpl, int slots,
                                                   int smem, void* stream) {
  const Args a = {A, ld, top, pc, t, m, hv, ht, vld, slots};
  return dispatch<false>(a, ctas, cols, rpl, smem, stream);
}
