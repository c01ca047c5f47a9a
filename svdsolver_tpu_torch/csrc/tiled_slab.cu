// One slab factorization of the tiled Stage I (the multicore rung), its t
// Householder steps in one launch, in place on the slab's rows of A.
//
// Stands for no TPU kernel: the JAX package's _factor_1slab and
// _factor_2slab (svdsolver_tpu/models/tiled.py:59, :72) are a
// lax.fori_loop over _slab_factor_step (:33) that XLA compiles to one
// device program.  PyTorch has no device-side loop: as plain launches a
// step is ~20 of them, ~115,000 steps at n = 3840, t = 128.  The plain
// version is models/tiled._factor_slab (ops/cuda/tiled_slab.py runs it on
// CPU tensors).
//
// The slab: rows [top, top + t) of A and, for a TS step, rows [bot, bot + t)
// stacked below them (R = t or 2t rows, read through A's leading dimension,
// no concatenated copy), all n columns.  Step j takes the reflector of
// column pc + j with its pivot at local row j and a contiguous tail below
// (_slab_factor_step's own rule: sign +1 at pivot >= 0, tau = 0 for a zero
// tail) and applies it to every column, as the reference does.
//
// Design: the CTAs split the n - t columns outside the pivot block
// [pc, pc + t) into chunks of W.  Every CTA holds the pivot block (R x t)
// and its chunk (R x W) in shared memory, column-major with a stride of
// R + 1 floats, and runs all t steps there: it needs no other CTA's data,
// so there is no grid barrier.  Every CTA computes each step's (v, tau)
// from its own copy of the pivot block with the same code, threads and
// order, so all copies hold the same bits.  A warp owns columns q = warp +
// 16 k: a dot product v . S[:, q] over the lanes' rows (row lane + 32 k,
// k from j / 32: rows below j have v = 0), a butterfly sum that leaves the
// same bits in every lane, then the rank-1 update S - tau (v w).  The warp
// that owns column j + 1 computes the next reflector from its registers
// into the other of two (v, tau) buffers, so a step has one block barrier.
// Each CTA writes its chunk back; the pivot block is written by the last
// CTA to finish (an atomicInc on a counter that wraps to 0 for the next
// launch): every other CTA has read the block by then, whatever the order
// in which the CTAs ran.
//
// What bounds it on the H100: step j's reflector is zero above row j, so
// the work it needs is 4 (R - j) n flops, 4 n (t R - t (t - 1) / 2) for the
// slab (378 M at n = 3840, t = 128, R = 256: 5.6 us at 67 TFLOP/s);
// the bytes, the slab in and out once (7.9 MB: 2.3 us).  But a step is a
// chain (reflector, barrier, dot, butterfly, update) and every CTA repeats
// the pivot block's R t updates: with ~30 chunk columns a CTA the redundant
// block is most of its work.  The main path no longer runs it: a half-sweep
// (a tile column's slabs) runs as tiled_chain.cu (the pivot-block column on
// one CTA) and tiled_apply.cu (the other columns on every SM), bit-equal to
// this kernel, which stays as their bitwise oracle and as the route for
// bands they do not take (ops/cuda/tiled_slab.tiled_route).  The column
// arithmetic is tiled_slab.cuh's, shared with them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled_slab.cuh"

namespace {

using svdt_tiled::dot_part;
using svdt_tiled::rank1;
using svdt_tiled::warp_sum;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// svdt_tiled::reflector, its v stored to shared memory (rows < R) and tau by
// lane 0.
template <int RPL>
__device__ __forceinline__ void reflector(const float (&x)[RPL], int p, int R, float* v,
                                          float* tau, int lane) {
  float vr[RPL];
  const float tv = svdt_tiled::reflector<RPL>(x, p, R, vr, lane);
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane + 32 * k;
    if (r < R) v[r] = vr[k];
  }
  if (lane == 0) *tau = tv;
}

template <int RPL>
__global__ void __launch_bounds__(kThreads, 1)
tiled_slab_kernel(float* __restrict__ A, int ld, int n, int top, int bot, int t, int pc,
                  int W, unsigned* counter) {
  extern __shared__ float smem[];
  __shared__ int last_cta;
  const int R = bot < 0 ? t : 2 * t;
  const int LD = R + 1;
  const int o0 = blockIdx.x * W;  // first chunk column, counted outside the pivot block
  const int w = max(0, min(W, n - t - o0));
  const int nq = t + w;  // local columns: the pivot block, then the chunk
  float* S = smem;
  float* V = S + (t + W) * LD;  // two reflectors of R floats
  float* T = V + 2 * R;         // two taus
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto gcol = [&](int q) {
    if (q < t) return pc + q;
    const int o = o0 + q - t;
    return o < pc ? o : o + t;
  };
  auto grow = [&](int r) {
    return (size_t)(r < t ? top + r : bot + r - t) * (size_t)ld;
  };

  for (int idx = tid; idx < R * nq; idx += kThreads) {
    const int r = idx / nq, q = idx - r * nq;
    S[q * LD + r] = A[grow(r) + gcol(q)];
  }
  __syncthreads();
  if (warp == 0) {
    float x[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      x[k] = r < R ? S[r] : 0.f;
    }
    reflector<RPL>(x, 0, R, V, T, lane);
  }
  __syncthreads();

  for (int j = 0; j < t; ++j) {
    const float* v = V + (j & 1) * R;
    const float tau = T[j & 1];
    const int k0 = j >> 5;
    float vr[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const int r = lane + 32 * k;
      vr[k] = (k >= k0 && r < R) ? v[r] : 0.f;
    }
    for (int q = warp; q < nq; q += kWarps) {
      float* col = S + q * LD;
      float x[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = lane + 32 * k;
        x[k] = (k >= k0 && r < R) ? col[r] : 0.f;
      }
      rank1(x, vr, tau, warp_sum(dot_part(vr, x, k0, RPL)), k0, RPL);
#pragma unroll
      for (int k = 0; k < RPL; ++k) {
        const int r = lane + 32 * k;
        if (k >= k0 && r < R) col[r] = x[k];
      }
      if (q == j + 1 && q < t)  // the next step's pivot column, final now
        reflector<RPL>(x, j + 1, R, V + ((j + 1) & 1) * R, T + ((j + 1) & 1), lane);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * w; idx += kThreads) {
    const int r = idx / w, q = t + idx - r * w;
    A[grow(r) + gcol(q)] = S[q * LD + r];
  }
  if (tid == 0) {
    __threadfence();  // this CTA's reads of the pivot block come before its count
    last_cta = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (last_cta) {
    for (int idx = tid; idx < R * t; idx += kThreads) {
      const int r = idx / t, q = idx - r * t;
      A[grow(r) + pc + q] = S[q * LD + r];
    }
  }
}

template <int RPL>
int launch(float* A, int ld, int n, int top, int bot, int t, int pc, int W, int ctas,
           int smem, unsigned* counter, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_slab_kernel<RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tiled_slab_kernel<RPL><<<ctas, kThreads, smem, stream>>>(A, ld, n, top, bot, t, pc, W,
                                                           counter);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the t steps of one slab factorization on `stream`, in place on A
// (row-major, leading dimension ld, n columns): rows [top, top + t) and, when
// bot >= 0, rows [bot, bot + t); pivot columns [pc, pc + t).  W chunk columns
// a CTA, ctas CTAs (ceil((n - t) / W), at least 1), rpl rows a lane (1, 2,
// 4, 8 or 11; 32 rpl >= R), smem dynamic bytes, counter one unsigned in
// device memory that is 0 between launches.  The plan is
// ops/cuda/tiled_slab.slab_plan's.  Returns the launch's cudaError_t.
extern "C" int svdt_tiled_slab(float* A, int ld, int n, int top, int bot, int t, int pc,
                               int W, int ctas, int rpl, int smem, unsigned* counter,
                               void* stream) {
  const int R = bot < 0 ? t : 2 * t;
  if (t < 1 || n < t || W < 1 || ctas < 1 || R > 32 * rpl || pc < 0 || pc + t > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rpl) {
    case 1: return launch<1>(A, ld, n, top, bot, t, pc, W, ctas, smem, counter, s);
    case 2: return launch<2>(A, ld, n, top, bot, t, pc, W, ctas, smem, counter, s);
    case 4: return launch<4>(A, ld, n, top, bot, t, pc, W, ctas, smem, counter, s);
    case 8: return launch<8>(A, ld, n, top, bot, t, pc, W, ctas, smem, counter, s);
    case 11: return launch<11>(A, ld, n, top, bot, t, pc, W, ctas, smem, counter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
