// The grid barrier of the wavefront chases (band_chase_wave.cu's ticks and
// band_chase_cluster.cu's cluster tick): an atomic arrival counter, thread
// 0 of each CTA spinning on an acquire load.  Every CTA must be
// co-resident (a cooperative launch).  A spin of ~10 s traps, so a broken
// count ends the launch with an error instead of holding the card.
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

}  // namespace svdt
