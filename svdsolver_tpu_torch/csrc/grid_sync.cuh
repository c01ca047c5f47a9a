// The grid barrier of the wavefront chases (band_chase_wave.cu's ticks,
// band_chase_superstep.cu's pass and band_chase_cluster.cu's cluster tick):
// an atomic arrival counter, thread 0 of each CTA spinning on an acquire
// load.  Every CTA must be co-resident (a cooperative launch, coop_launch
// below).  A spin of ~10 s traps, so a broken count ends the launch with an
// error instead of holding the card.
#pragma once

#include <cuda_runtime.h>

namespace svdt {

// A wait that spins this many cycles (~10 s) traps.
constexpr long long kSpinTrap = 20000000000LL;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned x;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(x) : "l"(p) : "memory");
  return x;
}

// Grid barrier number k (target = (k + 1) * gridDim.x): every CTA's writes
// before it are seen by every CTA after it.
__device__ __forceinline__ void grid_sync(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const long long t0 = clock64();
    while (ld_acquire(ctr) < target)
      if (clock64() - t0 > kSpinTrap) __trap();
    __threadfence();
  }
  __syncthreads();
}

// A cooperative launch of `kernel`, `threads` a CTA and `smem` bytes of
// dynamic shared memory, over one CTA a work unit, at most as many as the
// card holds at once and at most max_ctas (0: no cap); the grid size goes to
// *ctas.  The card's capacity is asked again only when the kernel, the
// device or the shared memory changes from the last call of this instance
// (a launch of the pipelined chase's pass runs for some 100 us, and the
// queries would be a good part of it).  Returns the launch's cudaError_t.
template <class Kernel>
int coop_launch(Kernel kernel, int threads, int units, int max_ctas, void** args,
                size_t smem, cudaStream_t s, int* ctas) {
  static const void* known_fn = nullptr;
  static int known_dev = -1, known_max = 0;
  static size_t known_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((const void*)kernel != known_fn || dev != known_dev || smem != known_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 0)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    known_fn = (const void*)kernel;
    known_dev = dev;
    known_smem = smem;
    known_max = per_sm * sms;
  }
  int G = units < known_max ? units : known_max;
  if (max_ctas > 0 && max_ctas < G) G = max_ctas;
  if (G < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = G;
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(G), dim3(threads), args,
                                          smem, s);
}

}  // namespace svdt
