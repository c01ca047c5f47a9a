// Scalar helpers of the two diagonalizer kernels (bidiag_qr.cu, dqds.cu):
// the Givens rotation and the min / max / limits of their plain PyTorch
// versions, on float and double, and the loop that loads a sweep's
// operands ahead of its dependent chain.
//
// Twin of svdsolver_tpu_torch/ops/givens.py (itself the twin of
// svdsolver_tpu/ops/givens.py): the same three cases, the same safe_*
// guards and the same order of operations.  The sources that include this
// header are compiled with -fmad=false and IEEE division and square root,
// so every rotation is bit-equal to the plain version's on the same inputs.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace svdt {

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fffffff); }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
};

// torch.minimum / torch.maximum (and jnp.minimum / jnp.maximum): a NaN in
// either argument gives NaN, where fmin / fmax would drop it.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// (c, s, r) with [c s; -s c]^T [f; g] = [r; 0]:
//   f == 0     -> (0, 1, g)
//   |f| > |g|  -> t = g/f, tt = sqrt(1+t^2); (1/tt, t/tt, f*tt)
//   otherwise  -> t = f/g, tt = sqrt(1+t^2); (t/tt, 1/tt, g*tt)
// Branch-free: the numerator and denominator are picked by select before
// the one division, one square root and the two divisions are shared, and
// (c, s, r) are picked by select, so a sweep's chain of rotations is
// straight-line code the compiler can schedule across.  The taken side's
// operations are the plain version's, so are its bits; a NaN f or g fails
// |f| > |g| and takes the second side, as the plain version's where does.
template <typename T>
__device__ __forceinline__ void givens(T f, T g, T& c, T& s, T& r) {
  const bool fdom = fabs(f) > fabs(g);
  const T num = fdom ? g : f;
  const T den = fdom ? f : (g == T(0) ? T(1) : g);  // g == 0 here only with f == 0 or NaN
  const T t = num / den;
  const T tt = sqrt(t * t + T(1));
  const T a = T(1) / tt;
  const T b = t / tt;
  const bool fz = f == T(0);  // covers g == 0 too: (0, 1, 0)
  c = fz ? T(0) : (fdom ? a : b);
  s = fz ? T(1) : (fdom ? b : a);
  r = fz ? g : den * tt;
}

// Runs body(i, a[i + OA], b[i + OB]) for i in [first, last), the operands
// loaded K steps ahead of the step that takes them: a chunk of K steps runs
// on registers loaded while the chunk before it ran, so no load sits on the
// body's dependent chain.  Loads are clamped to i = last - 1 (the arrays
// must hold a[last - 1 + OA] and b[last - 1 + OB]).  Step i may store to a
// below i + OA and to b below i + OB: the loads of later steps are issued
// before those stores and never read their addresses.
template <int K, int OA, int OB, typename T, typename Body>
__device__ __forceinline__ void pipelined(const T* a, const T* b, int first, int last,
                                          Body&& body) {
  if (first >= last) return;
  T ac[K], bc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int k = min(first + j, last - 1);
    ac[j] = a[k + OA];
    bc[j] = b[k + OB];
  }
  int i = first;
#pragma unroll 1
  for (; i + K <= last; i += K) {
    T an[K], bn[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = min(i + K + j, last - 1);
      an[j] = a[k + OA];
      bn[j] = b[k + OB];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) body(i + j, ac[j], bc[j]);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ac[j] = an[j];
      bc[j] = bn[j];
    }
  }
#pragma unroll
  for (int j = 0; j < K - 1; ++j)
    if (i + j < last) body(i + j, ac[j], bc[j]);
}

}  // namespace svdt
