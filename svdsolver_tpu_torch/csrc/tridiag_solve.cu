// The shifted Golub-Kahan tridiagonal solve of inverse iteration, both
// passes in one launch, one thread per shift lane.
//
// Replaces the two TPU kernels of svdsolver_tpu/ops/pallas/tridiag_solve.py:
//   _fwd_kernel  LU with partial pivoting of (TGK - lam_j I) for every lane,
//                factor rows U0, U1, U2 and R streamed to HBM;
//   _bwd_kernel  back substitution over those rows with clip(+-big).
// Arithmetic and pivoting are those of models/vectors.tgk_solve_xla (the
// plain version here is ops/cuda/tridiag_solve.tgk_solve_plain): the third
// upper carry of the band-2 elimination is identically zero for a
// tridiagonal and is dropped (p2 = swap ? z[r+1] : 0); pivots below pivmin
// are floored to +-pivmin; the last factor row is (clamped b, 0, 0, y), so
// the carry cc is never stored there.  The parity claim of the reference is
// that the pivoting decisions are identical, so every product, difference
// and quotient is rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn: no
// FMA contraction, IEEE division), as in PyTorch's eager plain version, and
// the clip is written so that a NaN stays a NaN, as jnp.clip and
// torch.clamp do (fminf/fmaxf would drop it).
//
// What bounds it on the H100: the bytes it must move are rhs in and x out,
// 2 N k floats (236 MB at n = 3840: N = 7680 rows, k = 3840 lanes), ~70 us
// at 3.35 TB/s; its ~12 N k flops are far less.  But each lane is a chain
// of N dependent steps, each with an IEEE division, in each pass, and the
// factor rows (4 N k floats more) go out to device memory and come back.
// Measured on the H100 (700 W): 7.06 ms at n = 3840, ~460 ns a row and
// pass, about five times the division chain alone: with two warps an SM,
// the latency of the row loads is what the unrolling does not hide.  A
// deeper software prefetch, or the factor rows kept on chip in chunks, is
// later work.
//
// Design: lane j is thread j; the factor rows are stored lane-major, row r
// of all lanes contiguous (the layout of rhs), so a warp's loads and stores
// are coalesced; the z entries of a row are the same for every lane (a
// broadcast through L1).  The forward loop's rhs load and the backward
// loop's four loads do not depend on the chain, so unrolling lets the
// compiler issue them ahead.  64-thread blocks spread the lanes over many
// SMs (60 at k = 3840).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float floor_pivot(float p, float pivmin) {
  const float sign = p < 0.f ? -1.f : 1.f;
  return fabsf(p) < pivmin ? sign * pivmin : p;
}

__global__ void __launch_bounds__(kThreads)
tgk_solve_kernel(const float* __restrict__ z, const float* __restrict__ lam,
                 const float* __restrict__ rhs, const float* __restrict__ piv,
                 const float* __restrict__ bigp, float* __restrict__ U0,
                 float* __restrict__ U1, float* __restrict__ U2,
                 float* __restrict__ R, float* __restrict__ x, int N, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const float pivmin = *piv;
  const float big = *bigp;
  const size_t ld = (size_t)k;
  const float bi = -lam[j];

  // ---- forward: LU with partial pivoting (TPU _fwd_kernel) ----
  float b = bi;
  float cc = z[0];
  float y = rhs[j];
#pragma unroll 4
  for (int r = 0; r < N - 1; ++r) {
    const float ai = z[r];
    const float ci = r + 1 < N - 1 ? z[r + 1] : 0.f;
    const float yi = rhs[(size_t)(r + 1) * ld + j];
    const bool swap = fabsf(ai) > fabsf(b);
    const float p0 = swap ? ai : b;
    const float p1 = swap ? bi : cc;
    const float p2 = swap ? ci : 0.f;
    const float py = swap ? yi : y;
    const float q0 = swap ? b : ai;
    const float q1 = swap ? cc : bi;
    const float q2 = swap ? 0.f : ci;
    const float qy = swap ? y : yi;
    const float safe = floor_pivot(p0, pivmin);
    const float mlt = __fdiv_rn(q0, safe);
    b = __fsub_rn(q1, __fmul_rn(mlt, p1));
    cc = __fsub_rn(q2, __fmul_rn(mlt, p2));
    y = __fsub_rn(qy, __fmul_rn(mlt, py));
    const size_t o = (size_t)r * ld + j;
    U0[o] = safe;
    U1[o] = p1;
    U2[o] = p2;
    R[o] = py;
  }
  const size_t last = (size_t)(N - 1) * ld + j;
  U0[last] = floor_pivot(b, pivmin);
  U1[last] = 0.f;
  U2[last] = 0.f;
  R[last] = y;

  // ---- backward substitution with the growth clip (TPU _bwd_kernel) ----
  // Each thread reads back only what it wrote itself: no barrier needed.
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int r = N - 1; r >= 0; --r) {
    const size_t o = (size_t)r * ld + j;
    const float num = __fsub_rn(__fsub_rn(R[o], __fmul_rn(U1[o], s1)),
                                __fmul_rn(U2[o], s2));
    float v = __fdiv_rn(num, U0[o]);
    v = v > big ? big : (v < -big ? -big : v);  // NaN compares false: kept
    x[o] = v;
    s2 = s1;
    s1 = v;
  }
}

}  // namespace

// Launches the solve on `stream`: z (N-1), lam (k), rhs (N, k) row-major,
// pivmin and big one float each in device memory; U0, U1, U2, R (N, k) are
// scratch for the factor rows, x (N, k) the solution.  Returns the launch's
// cudaError_t.
extern "C" int svdt_tgk_solve(const float* z, const float* lam,
                              const float* rhs, const float* pivmin,
                              const float* big, float* U0, float* U1,
                              float* U2, float* R, float* x, int N, int k,
                              void* stream) {
  if (N < 2 || k < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (k + kThreads - 1) / kThreads;
  tgk_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, lam, rhs, pivmin, big, U0, U1, U2, R, x, N, k);
  return (int)cudaGetLastError();
}
