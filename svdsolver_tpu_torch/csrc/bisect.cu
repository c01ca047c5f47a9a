// All singular values of a bidiagonal by parallel multisection on the
// Golub-Kahan tridiagonal, one thread per singular value.
//
// Replaces: svdsolver_tpu/ops/pallas/bisect.py, _bisect_kernel.  Same
// arithmetic: the z^2 streams and the bound are prepared by the wrapper as
// there; each sweep probes `probes` equispaced points of the bracket; the
// Sturm count is the twisted one (forward pivots p from the top and backward
// pivots q from the bottom run in the same step and meet at the twist n+1:
// count = #neg(p) + #neg(q) + (gamma < 0) with gamma = p + q + lam); and the
// bracket keeps its untouched endpoint exact.
//
// What bounds it on the H100: each count is a chain of n dependent steps,
// each with two independent IEEE divisions, so a thread is bound by the
// division latency along the chain, iters * probes * n steps long.  The
// n lanes are independent.
//
// Design: one thread per lane, in blocks of 32 threads so that n = 3840
// lanes spread over 120 of the 132 SMs; every block stages both z^2
// streams (2n floats) in shared memory, where the whole warp reads the same
// word each step (a broadcast).  The two chains of one step are
// independent, which hides half the division latency.  Compiled without
// fast math: zero pivots must give inf and no value may flush to zero.
// __fmul_rn/__fadd_rn keep the probe points from contracting into an FMA,
// so they round as the plain PyTorch version's do.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ int twisted_count(const float* zf, const float* zr,
                                             int n, float lam) {
  float p = -lam;  // p_1
  float q = -lam;  // the backward chain starts with a sacrificial zero z^2
  int cnt = p < 0.f;
  for (int s = 0; s < n; ++s) {
    p = -lam - zf[s] / p;
    q = -lam - zr[s] / q;
    cnt += (p < 0.f) + (q < 0.f);
  }
  const float gamma = p + q + lam;  // twist pivot (zero TGK diagonal)
  // p_{n+1}, q_{n+1} were counted in the loop but belong to the twist
  return cnt - (p < 0.f) - (q < 0.f) + (gamma < 0.f);
}

__global__ void __launch_bounds__(kThreads)
bisect_kernel(const float* __restrict__ z2f, const float* __restrict__ z2r,
              const float* __restrict__ bound, float* __restrict__ out, int n,
              int iters, int probes) {
  extern __shared__ float zs[];  // z2f then z2r, n floats each
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    zs[i] = z2f[i];
    zs[n + i] = z2r[i];
  }
  __syncthreads();
  const int ks = blockIdx.x * blockDim.x + threadIdx.x;  // ks-th smallest
  if (ks >= n) return;
  const float kp1 = (float)(probes + 1);
  float lo = 0.f;
  float hi = *bound;
  for (int it = 0; it < iters; ++it) {
    const float h = (hi - lo) / kp1;
    int na = 0;  // probes below sigma_ks
    for (int j = 0; j < probes; ++j) {
      const float lam = __fadd_rn(lo, __fmul_rn((float)(j + 1), h));
      na += twisted_count(zs, zs + n, n, lam) - n <= ks;
    }
    lo = __fadd_rn(lo, __fmul_rn((float)na, h));
    // keep the untouched endpoint exact: lo + (k+1) h != hi in floating point
    hi = na >= probes ? hi : __fadd_rn(lo, h);
  }
  out[n - 1 - ks] = 0.5f * (lo + hi);  // descending
}

}  // namespace

// Launches the bisection on `stream`; returns the launch's cudaError_t.
extern "C" int svdt_bisect(const float* z2f, const float* z2r,
                           const float* bound, float* out, int n, int iters,
                           int probes, void* stream) {
  // both z^2 streams; the wrapper checks they fit
  const size_t smem = 2 * sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      bisect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kThreads - 1) / kThreads;
  bisect_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      z2f, z2r, bound, out, n, iters, probes);
  return (int)cudaGetLastError();
}
