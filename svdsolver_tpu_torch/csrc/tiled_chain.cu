// The pivot-block column of one half-sweep of the tiled Stage I (the
// multicore rung): every reflector of a tile column's slabs, in one CTA.
//
// Stands for no TPU kernel: the JAX package runs a half-sweep as
// lax.fori_loops over _factor_1slab and _factor_2slab
// (svdsolver_tpu/models/tiled.py:59, :72), each a fori_loop over
// _slab_factor_step (:33), which XLA compiles to one device program.  This
// kernel computes the part of that loop that is a chain: the reflectors and
// the pivot block they come from.  tiled_apply.cu then applies the
// reflectors to every other column.  Its plain version is
// models/tiled.chain_plain.
//
// A half-sweep (top, pc): the 1-slab on rows [top, top + t) (R = t), then
// a TS slab for each tile row below, rows [top, top + t) over [top + s t,
// top + s t + t) (R = 2t), s = 1 .. m.  Step j of a slab takes the
// reflector of column pc + j, pivot at local row j, and applies it to every
// column; this kernel holds the t columns [pc, pc + t), all R rows of the
// slab: the top block R carried from slab to slab, the sub-diagonal tile
// streamed in.
//
// Design (one CTA of 16 warps): warp w owns columns q = w + 16 c in
// registers, row lane + 32 k in x[c][k], so a step moves no column through
// memory (columns q >= t are zeros that stay zero, so every warp applies
// each reflector to all N of its columns, in code fixed at compile time:
// no branch on which column is live, and the row groups from the pivot's
// down fixed per 32 steps, svdt_tiled::apply_fixed).  Within a slab the
// warps run their steps with no block barrier: reflector j's slot in
// shared memory has an mbarrier, and a warp waits only for the reflector
// it applies next.  Step j, in each warp:
//  * wait for reflector j;
//  * the warp owning column j + 1 updates it first, computes reflector
//    j + 1 from its registers into the slab's history (shared memory for
//    this CTA, device memory for tiled_apply.cu) and arrives on its slot;
//  * the warp applies reflector j to its other columns: the N dot products,
//    their sums in one multi-column butterfly (svdt_tiled::reduce_cols,
//    about 2 N shuffles in place of 5 N), the N updates.
// So a warp that is not on the chain runs ahead to the next reflector it
// needs.  The columns left of the pivot take each reflector in the same
// step as the rest: deferring them to the slab's end (where no later step
// reads them) was measured slower, as was a block barrier a step, and so
// were handing the next pivot's other columns to its own step, 32 warps
// of 4 columns, and sums through shared memory in place of shuffles
// (tools/tiled_split.py; PERF.md).  At the slab's end the tile's rows go
// back to A and the next tile, prefetched into shared memory with cp.async
// while the slab ran, comes into the registers.  The arithmetic of a
// column is tiled_slab.cuh's, in the same order as tiled_slab.cu's, so
// every bit of the block is the first design's.
//
// What bounds it on the H100: one SM.  The pivot block's work is
// 4 t sum_j (R - j) operations a slab (12.6 M at t = 128, 1/30 of the slab
// at n = 3840), about 5 instructions for 4 of them (a product and a sum
// for the dot, two products and a difference for the update, each
// rounded alone), all issued by one SM; and the chain of t steps a slab:
// the pivot column's dot, butterfly and update, then a reflector (two warp
// reductions, a square root, the divisions), ~1,600 cycles a step with the
// SM to itself and ~2,800 beside the other warps' applies (clock stamps,
// tools/tiled_split.py --stamps).  No tensor cores: the operations are
// rank-1 updates whose bits are the first design's (fp32 products and
// sums rounded one at a time), and the reduction runs with TF32 off
// (ops/precision.py).

#include <cuda_runtime.h>

#include "tiled_slab.cuh"

// A timing build's clock stamps (tools/tiled_split.py --stamps): lane 0 of
// each warp stamps every step of the second slab; empty in the package's
// build.
#ifdef SVDT_SPLIT_STAMPS
__device__ long long* g_stamps;
#define SVDT_STAMP(i) \
  if (lane == 0 && s == 1 && j < 128) g_stamps[(warp * 128 + j) * 8 + (i)] = clock64();
extern "C" int svdt_tiled_chain_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#else
#define SVDT_STAMP(i)
#endif

namespace {

using namespace svdt_tiled;

constexpr int kThreads = 512;  // 16 warps, column q in warp q % 16

// The t x t tile at rows [row0, row0 + t), columns [pc, pc + t) of A into P
// (row-major, pitch t + 1), by cp.async.
__device__ __forceinline__ void prefetch(float* P, const float* A, int ld, int row0, int pc, int t,
                                         int tid) {
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int r = idx / t, q = idx - r * t;
    cp_async4(P + r * (t + 1) + q, A + (size_t)(row0 + r) * ld + pc + q);
  }
  cp_commit();
}

// Rows [r0, r0 + t) of the warp's columns to or from S (row-major, pitch
// t + 1, row r at r - r0).
template <int N, bool kStore>
__device__ __forceinline__ void stage(float (&x)[N][N], float* S, int r0, int t, int warp,
                                      int lane) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const int q = warp + 16 * c;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = lane + 32 * k - r0;
      if (q < t && r >= 0 && r < t) {
        if (kStore)
          S[r * (t + 1) + q] = x[c][k];
        else
          x[c][k] = S[r * (t + 1) + q];
      }
    }
  }
}

// This lane's rows of a reflector's slot (zeros above its pivot's row and
// from R on).
template <int N>
__device__ __forceinline__ void load_v(float (&v)[N], const float* slot, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = slot[lane + 32 * k];
}

template <int N>
__device__ __forceinline__ void store_v(const float (&v)[N], float* slot, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) slot[lane + 32 * k] = v[k];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on the slot's barrier (release: this thread's stores before it are
// seen by a thread whose wait returns).
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("{ .reg .b64 st; mbarrier.arrive.shared::cta.b64 st, [%0]; }" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the phase of parity `parity` of the slot's barrier (acquire).
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// kApply false: the chain alone (the pivot columns' updates and the
// reflectors, no other column), the entry svdt_tiled_chain_alone that times
// the chain's latency; its block and history are not the half-sweep's.
template <int N, bool kApply>
__global__ void __launch_bounds__(kThreads, 1)
tiled_chain_kernel(float* __restrict__ A, int ld, int top, int pc, int t, int m,
                   float* __restrict__ hv, float* __restrict__ ht) {
  constexpr int HS = 32 * N;  // a reflector's slot in the history: rows < R, zeros past
  extern __shared__ unsigned long long smem_bars[];
  unsigned long long* bars = smem_bars;                 // t: reflector j's slot is ready
  float* V = reinterpret_cast<float*>(bars + t);        // the slab's t reflectors; between
  float* T = V + t * HS;                                // slabs, a t x (t + 1) staging area
  float* P = T + t;                                     // the next tile, t x (t + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float x[N][N];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int k = 0; k < N; ++k) x[c][k] = 0.f;
  for (int j = tid; j < t; j += kThreads) bar_init(bars + j, 32);
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int r = idx / t, q = idx - r * t;
    V[r * (t + 1) + q] = A[(size_t)(top + r) * ld + pc + q];
  }
  __syncthreads();
  stage<N, false>(x, V, 0, t, warp, lane);
  __syncthreads();
  if (m > 0) prefetch(P, A, ld, top + t, pc, t, tid);

  for (int s = 0; s <= m; ++s) {
    const int R = s == 0 ? t : 2 * t;
    const int k1 = (R + 31) >> 5;
    const unsigned parity = s & 1;
    float* hvs = hv + (size_t)s * t * HS;
    float* hts = ht + (size_t)s * t;
    if (warp == 0) {  // column 0: warp 0's first
      float v[N];
      const float tau = reflector<N>(x[0], 0, R, v, lane);
      store_v(v, V, lane);
      store_v(v, hvs, lane);
      if (lane == 0) T[0] = hts[0] = tau;
      bar_arrive(bars);
    }
    for (int j = 0; j < t; ++j) {
      const int k0 = j >> 5;
      SVDT_STAMP(0);
      bar_wait(bars + j, parity);
      SVDT_STAMP(1);
      const float tau = T[j];
      float v[N];
      load_v(v, V + j * HS, lane);
      const int nx = j + 1;
      int skip = -1;
      if (nx < t && warp == (nx & 15)) {  // the next pivot column first
        skip = nx >> 4;
        float vn[N], tn = 0.f;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          if (c == skip) {
            rank1(x[c], v, tau, warp_sum(dot_part(v, x[c], k0, k1)), k0, k1);
            SVDT_STAMP(4);
            tn = reflector<N>(x[c], nx, R, vn, lane);
            SVDT_STAMP(5);
            store_v(vn, V + nx * HS, lane);
            if (lane == 0) T[nx] = tn;
          }
        }
        bar_arrive(bars + nx);
        SVDT_STAMP(2);
        store_v(vn, hvs + (size_t)nx * HS, lane);
        if (lane == 0) hts[nx] = tn;
      }
      if (kApply) {
        if (skip >= 0)
          apply_all<N, N>(x, v, tau, k0, k1, skip, lane);
        else
          apply_fixed<N, N>(x, v, tau, k0, s > 0, lane);
      }
      SVDT_STAMP(3);
    }
    __syncthreads();
    if (s > 0) {  // the tile's rows back to A
      stage<N, true>(x, V, t, t, warp, lane);
      __syncthreads();
      const int row0 = top + s * t;
      for (int idx = tid; idx < t * t; idx += kThreads) {
        const int r = idx / t, q = idx - r * t;
        A[(size_t)(row0 + r) * ld + pc + q] = V[r * (t + 1) + q];
      }
    }
    if (s < m) {  // the next tile into the registers, the one after into P
      cp_wait_all();
      __syncthreads();
      stage<N, false>(x, P, t, t, warp, lane);
      __syncthreads();
      if (s + 1 < m) prefetch(P, A, ld, top + (s + 2) * t, pc, t, tid);
    }
  }
  __syncthreads();
  stage<N, true>(x, V, 0, t, warp, lane);
  __syncthreads();
  for (int idx = tid; idx < t * t; idx += kThreads) {
    const int r = idx / t, q = idx - r * t;
    A[(size_t)(top + r) * ld + pc + q] = V[r * (t + 1) + q];
  }
}

template <int N, bool kApply>
int launch(float* A, int ld, int top, int pc, int t, int m, float* hv, float* ht, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tiled_chain_kernel<N, kApply>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tiled_chain_kernel<N, kApply><<<1, kThreads, smem, stream>>>(A, ld, top, pc, t, m, hv, ht);
  return (int)cudaGetLastError();
}

template <bool kApply>
int launch_rpl(float* A, int ld, int top, int pc, int t, int m, float* hv, float* ht, int rpl,
               int smem, void* stream) {
  if (t < 1 || m < 0 || top < 0 || pc < 0 || t > 16 * rpl) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rpl) {
    case 1: return launch<1, kApply>(A, ld, top, pc, t, m, hv, ht, smem, s);
    case 2: return launch<2, kApply>(A, ld, top, pc, t, m, hv, ht, smem, s);
    case 4: return launch<4, kApply>(A, ld, top, pc, t, m, hv, ht, smem, s);
    case 8: return launch<8, kApply>(A, ld, top, pc, t, m, hv, ht, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the pivot-block column of half-sweep (top, pc) on `stream`, in
// place on A (row-major, leading dimension ld, square of side top + (m + 1)
// t from row top on): the 1-slab and m TS slabs.  rpl (1, 2, 4 or 8, 16 rpl
// >= t) rows a lane and columns a warp; hv ((m + 1) t slots of 32 rpl
// floats) and ht ((m + 1) t floats) receive every reflector, slab by slab;
// smem dynamic bytes: 8 t for the slots' barriers, then 4 (32 rpl t + t +
// t (t + 1)) (ops/cuda/tiled_slab.chain_plan).  Returns the
// launch's cudaError_t.
extern "C" int svdt_tiled_chain(float* A, int ld, int top, int pc, int t, int m, float* hv,
                                float* ht, int rpl, int smem, void* stream) {
  return launch_rpl<true>(A, ld, top, pc, t, m, hv, ht, rpl, smem, stream);
}

// The chain alone, with the arguments of svdt_tiled_chain: the same waits,
// pivot-column updates, reflectors and slab hand-overs, no other column's
// apply.  Its time is the chain's latency bound (A and the history are
// left as no half-sweep leaves them).
extern "C" int svdt_tiled_chain_alone(float* A, int ld, int top, int pc, int t, int m, float* hv,
                                      float* ht, int rpl, int smem, void* stream) {
  return launch_rpl<false>(A, ld, top, pc, t, m, hv, ht, rpl, smem, stream);
}
