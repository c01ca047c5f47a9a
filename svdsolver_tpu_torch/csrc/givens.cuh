// Scalar helpers of the two diagonalizer kernels (bidiag_qr.cu, dqds.cu):
// the Givens rotation and the min / max / limits of their plain PyTorch
// versions, on float and double.
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
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
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
template <typename T>
__device__ __forceinline__ void givens(T f, T g, T& c, T& s, T& r) {
  if (f == T(0)) {  // covers g == 0 too: (0, 1, 0)
    c = T(0);
    s = T(1);
    r = g;
    return;
  }
  if (fabs(f) > fabs(g)) {
    const T t = g / f;  // f != 0 here: the plain version's safe_f is f
    const T tt = sqrt(t * t + T(1));
    c = T(1) / tt;
    s = t / tt;
    r = f * tt;
  } else {
    const T t = f / (g == T(0) ? T(1) : g);  // g == 0 only with a NaN f
    const T tt = sqrt(t * t + T(1));
    c = t / tt;
    s = T(1) / tt;
    r = g * tt;
  }
}

}  // namespace svdt
