// Band -> bidiagonal bulge chase on the sequential schedule with the windows
// staged in shared memory.
//
// svdt_band_chase_staged with khops = 1 replaces the TPU kernel
//   svdsolver_tpu/ops/pallas/band_chase.py  _chase_kernel_pipelined (the
//       `pipelined=True` route: windows stay on chip, the (b, b) overlap is
//       carried to the next window, only the L-strips are copied in);
// with khops = K > 1 it replaces
//   band_chase.py  _chase_kernel_megapipe (the `mega=True` route:
//       mega-windows of K pairs).
// Schedule and arithmetic: models/two_stage.band_to_bidiagonal, through the
// one chase_pair of chase_pair.cuh, so (d, e) are bit-equal to
// svdt_band_chase's.
//
// Design: one block of 512 threads.  Chase pair k of sweep i, at
// (r, c = r + b), touches three b x b tiles: (R0, C0) = rows [r, r + b) x
// columns [c, c + b), (R1, C0) and (R1, C1), R1 and C1 the next b rows and
// columns.  The next pair's (R0, C0) is this pair's (R1, C1): that tile is
// carried in shared memory (the TPU's carried quadrant), and a pair writes
// back two tiles and loads two (the TPU's L-strips).  A mega-window of K
// pairs touches 2K + 1 tiles on the staircase, diagonal tiles D_j =
// (R_j, C_j), j = 0..K, and sub-diagonal S_j = (R_{j+1}, C_j), j < K; they
// live in a ring of 2K + 1 tile slots, D_K carried to the next mega-window
// as its D_0.  Each sweep's head pair runs on device memory (dense
// accessor), then the sweep's tiles are staged.  Loads and stores are plain
// coalesced copies between barriers, with no index division per entry
// (cp.async or TMA prefetch is later work); a write-back completes, behind
// a barrier, before any load reuses its slot.  A tile row is b + 1 floats, so warp 0's column reads of the
// left pivot column hit distinct banks.  Loads past n read zero and stores
// past n are dropped, as in band_chase.cu; tiles wholly past n are skipped.
//
// Shared memory: (2K + 1) b (b + 1) floats, dynamic; at b = 128 only K = 1
// fits (198,144 bytes of 227 KB), at b = 64 K <= 6.  Bands above 128 go to
// svdt_band_chase (the wrapper's route).
//
// What bounds it on the H100: as band_chase.cu, the ~n^2/(2b) pairs in
// order on one SM; staging moves the window's round trips from L2 to shared
// memory, at the price of copying each tile in and out once.
#include <cuda_runtime.h>

#include "chase_pair.cuh"

namespace {

using namespace svdt;

constexpr int kMaxStagedBand = 128;

// The three staged tiles of one pair with corner (r0, c0): ring slots of
// (R0, C0), (R1, C0) and (R1, C1); a tile row is tld floats.
struct TileAt {
  float* s;
  int tsz, tld, b, r0, c0, s00, s10, s11;
  __device__ float* at(int r, int c) const {
    int dr = r - r0, dc = c - c0;
    const int slot = dr < b ? s00 : (dc < b ? s10 : s11);
    if (dr >= b) dr -= b;
    if (dc >= b) dc -= b;
    return s + slot * tsz + dr * tld + dc;
  }
  __device__ float load(int r, int c) const { return *at(r, c); }
  __device__ void store(int r, int c, float x) const { *at(r, c) = x; }
};

constexpr int kTileLoads = 16;  // loads a thread keeps in flight per tile copy

// Copy the b x b tile at (r0, c0) of A into a tile slot (Load) or back.
// Thread (i0, j) owns column j of rows i0, i0 + p, i0 + 2p, ... (p = 512 / b
// rows a pass; the 512 % b threads left over idle), so the addresses step by
// a constant and no entry pays an index division: on one SM the copy is
// bound by instruction issue, not by L2.  A load issues kTileLoads reads
// before it stores any to shared memory.
template <bool Load>
__device__ void tile_io(float* t, int tld, float* A, int n, int b, int r0,
                        int c0) {
  if (r0 >= n || c0 >= n) return;  // never read: every entry is past n
  const int p = kThreads / b;
  const int i0 = threadIdx.x / b;
  const int j = threadIdx.x - i0 * b;
  if (i0 >= p) return;
  const bool col_in = c0 + j < n;
  const size_t gstep = (size_t)p * n;
  const int sstep = p * tld;
  float* g = A + (size_t)(r0 + i0) * n + c0 + j;
  float* s = t + i0 * tld + j;
  for (int i = i0; i < b; i += p * kTileLoads) {
    float x[kTileLoads];
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int ii = i + u * p;
      if constexpr (Load)
        x[u] = (ii < b && col_in && r0 + ii < n) ? g[u * gstep] : 0.f;
      else
        x[u] = ii < b ? s[u * sstep] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int ii = i + u * p;
      if constexpr (Load) {
        if (ii < b) s[u * sstep] = x[u];
      } else if (ii < b && col_in && r0 + ii < n) {
        g[u * gstep] = x[u];
      }
    }
    g += kTileLoads * gstep;
    s += kTileLoads * sstep;
  }
}

template <int KPL>
__global__ void __launch_bounds__(kThreads)
staged_chase_kernel(float* __restrict__ A, float* __restrict__ d,
                    float* __restrict__ e, int n, int b, int K) {
  extern __shared__ float tiles[];
  __shared__ float v[kMaxStagedBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  const int NT = 2 * K + 1;
  const int tld = b + 1;
  const int tsz = b * tld;
  const DenseAt dense = {A, (size_t)n};
  const Slot none = {nullptr, nullptr};
  auto slot = [&](int base, int q) { return (base + q) % NT; };
  auto tile = [&](int sl) { return tiles + sl * tsz; };
  for (int i = 0; i < n - 1; ++i) {
    chase_pair<KPL, false>(dense, n, b, i, i + 1, b + 1, 1, v, part, s_tau,
                           none, none);  // chase_pair ends with a barrier
    const int nc = nc_of(i, n, b);
    const int r00 = i + 1;  // rows R_0 of chase pair 0; its columns C_0 start b later
    int base = 0;
    tile_io<true>(tile(0), tld, A, n, b, r00, r00 + b);
    for (int k0 = 0; k0 < nc; k0 += K) {
      const int kk = min(K, nc - k0);
      const int rm = r00 + k0 * b;
      const int cm = rm + b;
      for (int j = 0; j < kk; ++j) {  // S_j, then D_{j+1}
        tile_io<true>(tile(slot(base, 2 * j + 1)), tld, A, n, b, rm + (j + 1) * b,
                      cm + j * b);
        tile_io<true>(tile(slot(base, 2 * j + 2)), tld, A, n, b, rm + (j + 1) * b,
                      cm + (j + 1) * b);
      }
      __syncthreads();
      for (int j = 0; j < kk; ++j) {
        const TileAt acc = {tiles, tsz, tld, b, rm + j * b, cm + j * b,
                            slot(base, 2 * j), slot(base, 2 * j + 1),
                            slot(base, 2 * j + 2)};
        chase_pair<KPL, false>(acc, n, b, rm + j * b, cm + j * b, 2 * b, b, v,
                               part, s_tau, none, none);
      }
      for (int j = 0; j < kk; ++j) {  // D_j, S_j; D_kk is carried
        tile_io<false>(tile(slot(base, 2 * j)), tld, A, n, b, rm + j * b,
                       cm + j * b);
        tile_io<false>(tile(slot(base, 2 * j + 1)), tld, A, n, b,
                       rm + (j + 1) * b, cm + j * b);
      }
      __syncthreads();
      base = slot(base, 2 * kk);
    }
    const int rc = r00 + nc * b;  // the carried tile D_0 of the next mega
    tile_io<false>(tile(base), tld, A, n, b, rc, rc + b);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < n; k += kThreads) {
    d[k] = A[(size_t)k * n + k];
    if (k + 1 < n) e[k] = A[(size_t)k * n + k + 1];
  }
}

template <int KPL>
int launch_kpl(float* A, float* d, float* e, int n, int b, int K,
               cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(2 * K + 1) * b * (b + 1);
  cudaError_t err = cudaFuncSetAttribute(
      staged_chase_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  staged_chase_kernel<KPL><<<1, kThreads, smem, s>>>(A, d, e, n, b, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The staged chase on `stream`, overwriting A (n x n, row-major, upper band
// b <= 128) with khops pairs a mega-window; (d, e) as svdt_band_chase's.
// Returns the launch's cudaError_t (an invalid value when the 2 khops + 1
// tiles do not fit shared memory).
extern "C" int svdt_band_chase_staged(float* A, float* d, float* e, int n,
                                      int b, int khops, void* stream) {
  if (n < 2 || b < 1 || b > kMaxStagedBand || khops < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 32) return launch_kpl<1>(A, d, e, n, b, khops, s);
  if (b <= 64) return launch_kpl<2>(A, d, e, n, b, khops, s);
  return launch_kpl<4>(A, d, e, n, b, khops, s);
}
