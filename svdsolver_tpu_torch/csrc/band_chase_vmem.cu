// Band -> bidiagonal bulge chase on the packed band: the L2 packed kernel.
//
// svdt_band_chase_vmem replaces the TPU kernel
//   svdsolver_tpu/ops/pallas/band_chase_vmem.py  _vmem_chase_kernel (the
//       sequential chase on the block-packed band held whole in VMEM, d and
//       e read out of it in the kernel)
// for the bands the copy engine does not take (b < 4 or b % 4 != 0); the
// others run the staged TMA design on a band store
// (svdt_band_chase_vmem_tma, band_chase_staged.cu), chosen by shape before
// launch (ops/cuda/band_chase_vmem.vmem_route).
// Layout, as there (models/two_stage.pack_band):
//   P[row, l] = A[row, 128 * (row / 128) - 128 + l],  l < 512,
// P of Npad = ceil((n + 3b + 8) / 128) * 128 rows.  For b <= 128 every
// window of the schedule stays in lanes [1, 511): a right apply at (r, c =
// r + b) spans lanes >= c - (r + 2b - 1) + 128 = 129 - b and <= (r + 2b - 1)
// - (r - 127) + 128 = 2b + 254, the left apply and the head pair the same
// range or less.  So the chase never leaves P, and d, e sit at lanes
// 128 + row % 128 and 129 + row % 128.
//
// On the TPU the packing kept the band in VMEM (the whole 16 MB scratch);
// on the card P lives in device memory and, at 8.9 MB for n = 3840, b = 128,
// stays resident in the 50 MB L2, where the dense n x n matrix (59 MB) does
// not.  A pack kernel (one thread an entry) builds P from the dense band;
// then one block of 512 threads walks the sequential schedule of
// models/two_stage.band_to_bidiagonal with the one chase_pair of
// chase_pair.cuh through the packed accessor, so (d, e) are bit-equal to
// svdt_band_chase's.  Bounds checks use n, as in band_chase.cu.
//
// What bounds it on the H100: as band_chase.cu, the ~n^2/(2b) pairs in
// order on one SM and their L2 round trips; the pack is one pass over the
// band (reads of the dense rows' 512-column neighbourhoods, writes of P).
#include <cuda_runtime.h>

#include "chase_pair.cuh"

namespace {

using namespace svdt;

constexpr int kMaxPackedBand = 128;

__global__ void pack_kernel(const float* __restrict__ A, float* __restrict__ P,
                            int n, int Npad) {
  const size_t total = (size_t)Npad * kPackWidth;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(idx / kPackWidth);
    const int l = (int)(idx - (size_t)row * kPackWidth);
    const int col = ((row >> 7) << 7) - 128 + l;
    P[idx] = (row < n && col >= 0 && col < n) ? A[(size_t)row * n + col] : 0.f;
  }
}

template <int KPL>
__global__ void __launch_bounds__(kThreads)
vmem_chase_kernel(float* __restrict__ P, float* __restrict__ d,
                  float* __restrict__ e, int n, int b) {
  __shared__ float v[kMaxPackedBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  const Slot none = {nullptr, nullptr};
  const PackedAt acc = {P};
  for (int i = 0; i < n - 1; ++i) {
    chase_pair<KPL, false>(acc, n, b, i, i + 1, b + 1, 1, v, part, s_tau,
                           none, none);
    const int nc = nc_of(i, n, b);
    for (int k = 0; k < nc; ++k) {
      const int r = i + 1 + k * b;
      chase_pair<KPL, false>(acc, n, b, r, r + b, 2 * b, b, v, part, s_tau,
                             none, none);
    }
  }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    d[k] = P[packed_index(k, k)];
    if (k + 1 < n) e[k] = P[packed_index(k, k + 1)];
  }
}

}  // namespace

// Packs A (n x n, row-major, upper band b <= 128) into P (Npad x 512) and
// chases P on `stream`; (d, e) as svdt_band_chase's.  Returns the first
// failing launch's cudaError_t.
extern "C" int svdt_band_chase_vmem(const float* A, float* P, float* d,
                                    float* e, int n, int b, int Npad,
                                    void* stream) {
  if (n < 2 || b < 1 || b > kMaxPackedBand || Npad < n + 3 * b + 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  pack_kernel<<<Npad * kPackWidth / 256, 256, 0, s>>>(A, P, n, Npad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (b <= 32)
    vmem_chase_kernel<1><<<1, kThreads, 0, s>>>(P, d, e, n, b);
  else if (b <= 64)
    vmem_chase_kernel<2><<<1, kThreads, 0, s>>>(P, d, e, n, b);
  else
    vmem_chase_kernel<4><<<1, kThreads, 0, s>>>(P, d, e, n, b);
  return (int)cudaGetLastError();
}
