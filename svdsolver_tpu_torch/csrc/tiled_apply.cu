// A half-sweep's reflectors on the columns outside its pivot block: the
// wide, independent part of the tiled Stage I (the multicore rung).
//
// Stands for no TPU kernel: it is the rest of the loop that
// svdsolver_tpu/models/tiled.py:59 and :72 run as lax.fori_loops over
// _slab_factor_step (:33), whose full-width update XLA compiles into the
// same device program; tiled_chain.cu computes the reflectors first and
// leaves them in a history.  Its plain version is models/tiled.apply_plain.
//
// Every column q outside [pc, pc + t) takes the reflectors of the 1-slab
// on rows [top, top + t), then those of TS slab s on rows [top, top + t)
// over [top + s t, top + s t + t), s = 1 .. m, in order.  A column sees
// only the reflectors and its own entries, so the columns split over the
// CTAs with no barrier between them.
//
// Design: CTA b takes W consecutive columns (counted outside the pivot
// block); each warp owns kCols of them in registers, row lane + 32 k in
// x[c][k] (a column past the chunk's end is zeros that stay zero).  The
// top rows stay in the registers for the whole half-sweep; for slab s the
// tile row's t x W chunk comes in through shared memory (cp.async,
// prefetched one slab ahead into the other of two buffers), the slab's t
// reflectors are applied from the history (read through the read-only
// cache, the next step's v loaded under this step's work; the row groups
// fixed at compile time, svdt_tiled::apply_fixed), and the chunk goes back
// through the buffer it came in.  Within a slab there is no block barrier.
// The arithmetic of a column is tiled_slab.cuh's, in tiled_slab.cu's
// order, so every bit is the first design's.
//
// The wide bands (the wide instance's route, 168 < t <= 512) take the same
// kernel at rpl = 16 and 32 (16 rpl >= t), on tiled_wide.cu's chain history
// laid out as tiled_chain.cu's (vld = 32 rpl floats a reflector, zeros past
// its rows): a warp's 2 x 32 rpl rows stay in registers, which at rpl = 32
// caps a CTA at 8 warps (16 columns).  Past t = 512 the wide instance's
// own apply (a warp a column from device memory) stays the route.
//
// What bounds it on the H100: fp32 issue.  4 n' sum_j (R - j) operations a
// slab over n' = n - t columns (366 M for a 2-slab at n = 3840, t = 128:
// 5.5 us at 67 TFLOP/s), about 5 instructions for 4 of them, and the
// columns' butterflies.  No tensor cores: the bits are the first design's
// rank-1 updates, rounded one operation at a time, and the reduction runs
// with TF32 off (ops/precision.py).

#include <cuda_runtime.h>

#include "tiled_slab.cuh"

namespace {

using namespace svdt_tiled;

constexpr int kCols = 2;  // columns a warp

// Threads a CTA at most for rpl = N: 16 warps, 8 at rpl = 32 so that a
// lane may hold its 2 x 32 rows, v and the next v in registers (the
// launch bound leaves it 255).
template <int N>
constexpr int max_threads() {
  return N <= 16 ? 512 : 256;
}

struct Chunk {
  int o0, w, pc, t, pitch;
  // the column of A of local column i (columns counted outside the pivot block)
  __device__ __forceinline__ int col(int i) const {
    const int o = o0 + i;
    return o < pc ? o : o + t;
  }
};

// Rows [row0, row0 + t) of the chunk into B (row-major, pitch ch.pitch), by cp.async.
__device__ __forceinline__ void fetch(float* B, const float* A, int ld, int row0, const Chunk& ch,
                                      int tid, int nthreads) {
  for (int idx = tid; idx < ch.t * ch.w; idx += nthreads) {
    const int r = idx / ch.w, i = idx - r * ch.w;
    cp_async4(B + r * ch.pitch + i, A + (size_t)(row0 + r) * ld + ch.col(i));
  }
  cp_commit();
}

__device__ __forceinline__ void put(float* A, int ld, int row0, const float* B, const Chunk& ch,
                                    int tid, int nthreads) {
  for (int idx = tid; idx < ch.t * ch.w; idx += nthreads) {
    const int r = idx / ch.w, i = idx - r * ch.w;
    A[(size_t)(row0 + r) * ld + ch.col(i)] = B[r * ch.pitch + i];
  }
}

// Rows [r0, r0 + t) of the warp's columns to or from B.
template <int N, bool kStore>
__device__ __forceinline__ void stage(float (&x)[kCols][N], float* B, int r0, const Chunk& ch,
                                      int warp, int lane) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int i = warp * kCols + c;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = lane + 32 * k - r0;
      if (i < ch.w && r >= 0 && r < ch.t) {
        if (kStore)
          B[r * ch.pitch + i] = x[c][k];
        else
          x[c][k] = B[r * ch.pitch + i];
      }
    }
  }
}

// This lane's rows of a reflector's slot (zeros above its pivot's row and
// from R on, as the chain kernel leaves them), through the read-only cache.
template <int N>
__device__ __forceinline__ void load_v(float (&v)[N], const float* slot) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = __ldg(slot + 32 * k);
}

template <int N>
__global__ void __launch_bounds__(max_threads<N>())
tiled_apply_kernel(float* __restrict__ A, int ld, int n, int top, int pc, int t, int m, int W,
                   const float* __restrict__ hv, const float* __restrict__ ht) {
  constexpr int HS = 32 * N;
  extern __shared__ float smem[];
  const Chunk ch{(int)blockIdx.x * W, min(W, n - t - (int)blockIdx.x * W), pc, t, W | 1};
  if (ch.w <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = blockDim.x;
  float* buf[2] = {smem, smem + t * ch.pitch};

  float x[kCols][N];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int k = 0; k < N; ++k) x[c][k] = 0.f;
  fetch(buf[0], A, ld, top, ch, tid, nthreads);
  cp_wait_all();
  __syncthreads();
  stage<N, false>(x, buf[0], 0, ch, warp, lane);
  __syncthreads();
  if (m > 0) fetch(buf[1], A, ld, top + t, ch, tid, nthreads);

  for (int s = 0; s <= m; ++s) {
    const float* hvs = hv + (size_t)s * t * HS;
    const float* hts = ht + (size_t)s * t;
    if (s > 0) {  // tile row s into the registers, tile row s + 1 into the other buffer
      cp_wait_all();
      __syncthreads();
      stage<N, false>(x, buf[s & 1], t, ch, warp, lane);
      __syncthreads();
      if (s < m) fetch(buf[(s + 1) & 1], A, ld, top + (s + 1) * t, ch, tid, nthreads);
    }
    const float* slot = hvs + lane;
    float v[N], vn[N];
    load_v(v, slot);
    float tau = __ldg(hts);
    for (int j = 0; j < t; ++j) {  // the next step's reflector loads under this one's work
      const int jn = j + 1 < t ? j + 1 : j;
      load_v(vn, slot + (jn - j) * HS);
      const float taun = __ldg(hts + jn);
      apply_fixed<kCols, N>(x, v, tau, j >> 5, s > 0, lane);
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = vn[k];
      tau = taun;
      slot += (jn - j) * HS;
    }
    if (s > 0) {  // tile row s back through its buffer
      stage<N, true>(x, buf[s & 1], t, ch, warp, lane);
      __syncthreads();
      put(A, ld, top + s * t, buf[s & 1], ch, tid, nthreads);
    }
  }
  __syncthreads();
  stage<N, true>(x, buf[0], 0, ch, warp, lane);
  __syncthreads();
  put(A, ld, top, buf[0], ch, tid, nthreads);
}

template <int N>
int launch(float* A, int ld, int n, int top, int pc, int t, int m, int W, int ctas, int threads,
           int smem, const float* hv, const float* ht, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tiled_apply_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tiled_apply_kernel<N><<<ctas, threads, smem, stream>>>(A, ld, n, top, pc, t, m, W, hv, ht);
  return (int)cudaGetLastError();
}

}  // namespace

// Applies the history of half-sweep (top, pc) (hv: (m + 1) t slots of 32 rpl
// floats, ht: (m + 1) t taus, as svdt_tiled_chain, or svdt_tiled_wide_chain
// with vld = 32 rpl, leaves them) to the n - t columns of A outside
// [pc, pc + t), rows [top, n), on `stream`: W columns a CTA, ctas CTAs of
// `threads` threads (32 ceil(W / 2), at most 512; 256 at rpl = 32), rpl
// rows a lane (1, 2, 4, 8, or for the wide bands 16 or 32; 16 rpl >= t),
// smem dynamic bytes (ops/cuda/tiled_slab.apply_plan).  Returns the
// launch's cudaError_t.
extern "C" int svdt_tiled_apply(float* A, int ld, int n, int top, int pc, int t, int m, int W,
                                int ctas, int threads, int rpl, int smem, const float* hv,
                                const float* ht, void* stream) {
  if (t < 1 || m < 0 || W < 1 || ctas < 1 || t > 16 * rpl || threads < 32 * ((W + kCols - 1) / kCols) ||
      threads > (rpl <= 16 ? max_threads<16>() : max_threads<32>()) || threads % 32 != 0 ||
      top + (m + 1) * t > n || pc + t > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rpl) {
    case 1: return launch<1>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    case 2: return launch<2>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    case 4: return launch<4>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    case 8: return launch<8>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    case 16: return launch<16>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    case 32: return launch<32>(A, ld, n, top, pc, t, m, W, ctas, threads, smem, hv, ht, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
