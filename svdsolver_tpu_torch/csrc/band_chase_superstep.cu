// One rank's pass of one superstep of the pipelined chase, as a wavefront
// over the pass's sweeps on the shared-memory tick.
//
// svdt_band_chase_superstep_wave stands for no TPU kernel: the pipelined
// chase over row-sharded ranks (parallel/distributed.py,
// band_to_bidiagonal_pipelined) is, in the JAX package, a pass of XLA
// windows a superstep (svdsolver_tpu/parallel/distributed.py:352-392), no
// Pallas kernel.  It is the second design of that pass.  The first,
// svdt_band_chase_superstep (band_chase.cu: one CTA walking the pass in
// order, each pair the L2 kernel's on the buffer through L2), stays as its
// bitwise oracle and as the route for the passes this one does not take
// (ops/cuda/band_chase.superstep_design: this design where 4 <= b <= 128,
// b, n and the row pitch are multiples of 4, the buffer is 16-byte aligned
// and the pass has two sweeps or more; one sweep in order runs faster on
// the first design).
//
// Schedule.  The pass runs sweeps i = i0 + l, l < LG: sweep l's head pair if
// lo <= i < hi, then its chase pairs k from the first whose start row
// r = i + 1 + k b reaches lo, at most s_chase of them and only while r < hi;
// lo = R0 - 3 b l, hi = R0 + m - 3 b l (Np on the last rank).  The JAX body
// staggers the sweeps' frontiers by 3b rows, the offset the global
// wavefront gives sweep i + 1 against sweep i (band_chase_wave.cu), so the
// pass runs by global tick: sweep i's head pair at tick 3 i, its chase pair
// k at tick 3 i + k + 1.  Pairs of one tick have windows at least 3b - 1
// rows apart, and two pairs whose windows meet run in the pass's order, so
// every entry sees the pass's operations in their order: the buffer comes
// out bit-equal to the first design's (the plain twin is
// models/two_stage.chase_superstep_wavefront, the schedule
// ops/chase_schedule.superstep_pairs).
//
// Design: a cooperative launch of one CTA a lane with work (at most LG <= 64
// CTAs, all co-resident; lanes stride over fewer CTAs where the card holds
// fewer), from the pass's first tick to its last, a grid barrier
// (grid_sync.cuh) after each.  Every pair is the shared-memory tick's
// (chase_tma.cuh tick_head and tick_chase, as band_chase_wave.cu's
// wave_smem_kernel runs them): the window's tiles copied in by TMA on their
// own mbarriers, smem_pair (chase_pair's arithmetic entry for entry), the
// boxes back by bulk stores drained and fenced before the barrier.  A lane
// is one sweep for the whole pass, so whenever its next pair runs it keeps
// its (r + b, c + b) tile for it and copies two tiles in instead of three.
// One tensor map covers the rank's local buffer L (row pitch Np floats,
// global row g at local row g - R0 + U), clipped at column n and at the
// local row of global row n (or at the buffer's last row), so reads past n
// give zero and writes there are dropped, as the first design's masks do:
// columns [n, Np) and the rows past n come out of the pass untouched.
// Pairs whose corner column lies past n are no-ops there and are skipped.
// No records: the pipelined entry computes singular values only.
//
// What bounds it on the H100: the pass's ticks in order (239 at 3840/b32 on
// one rank), each the slowest pair of the tick plus a grid barrier; under
// that, one SM's copy rate for a tick's boxes (the schedule bound of
// chip_smoke.py: ops/chase_schedule.superstep_copy_bytes over one CTA's
// window copy rate).  FLOPs and device memory bandwidth are far from
// bounding it.
#include <cuda_runtime.h>

#include <cstdint>

#include "chase_pair.cuh"
#include "chase_tma.cuh"
#include "grid_sync.cuh"

namespace {

using namespace svdt;

__host__ __device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

// Lane l's share of a pass: sweep i, its head pair where `head`, its chase
// pairs k in [k0, k1): the first design's bounds (band_chase.cu's
// superstep_kernel), the pairs whose corner column lies past n left out.
struct PassLane {
  int i, k0, k1;
  bool head;
};

__host__ __device__ __forceinline__ PassLane pass_lane(int n, int b, int i0, int l, int R0,
                                                       int m, int last, int s_chase, int ld) {
  PassLane p = {i0 + l, 0, 0, false};
  if (p.i > n - 2) return p;
  const int lo = R0 - 3 * b * l;
  const int hi = last ? ld : R0 + m - 3 * b * l;
  p.head = lo <= p.i && p.i < hi;
  const int first = lo - p.i - 1;  // chase pair k starts at row i + 1 + k b
  p.k0 = first > 0 ? (first + b - 1) / b : 0;
  const int below_hi = hi - p.i - 1 > 0 ? (hi - p.i - 1 + b - 1) / b : 0;  // r < hi
  const int below_n = (n - p.i - 2) / b;  // corner column r + b < n
  p.k1 = imin(imin(p.k0 + s_chase, nc_of(p.i, n, b)), imin(below_hi, below_n));
  if (p.k1 < p.k0) p.k1 = p.k0;
  return p;
}

template <int KPL, int BF>
__global__ void __launch_bounds__(kThreads, 1)
superstep_wave_kernel(const __grid_constant__ CUtensorMap tile_map, float* __restrict__ L,
                      int ld, int n, int b_rt, int i0, int l0, int lanes, int R0, int U,
                      int m, int last, int s_chase, int t0, int T, unsigned* ctr) {
  extern __shared__ __align__(128) float smem_raw[];
  __shared__ float v[kSmemBand];
  __shared__ __align__(16) float vg[2 * kSmemBand];
  __shared__ float col[kSmemBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  __shared__ __align__(8) uint64_t bar[3];
  const TickSmem sm = {align128(smem_raw), bar, v, vg, col, part, s_tau};
  const TickMat mat = {&tile_map, L, (size_t)ld, U - R0, n};
  const int b = BF ? BF : b_rt;
  const int G = gridDim.x;
  const bool carry = G == lanes;  // a lane a CTA: its tile can stay
  const Slot none = {nullptr, nullptr};
  tick_init(bar);
  TickLane ln;
  unsigned target = 0;
  for (int t = t0; t < t0 + T; ++t) {
    SVDT_SPLIT_TICK(t - t0);
    for (int u = blockIdx.x; u < lanes; u += G) {
      const PassLane p = pass_lane(n, b, i0, l0 + u, R0, m, last, s_chase, ld);
      const int s = t - 3 * p.i;  // 0: the head pair; k + 1: chase pair k
      if (s == 0 && p.head) {
        tick_head<KPL, BF, false>(mat, b, p.i, sm, ln, none, none);
      } else if (s > p.k0 && s <= p.k1) {
        const int r = p.i + 1 + (s - 1) * b;
        tick_chase<KPL, BF, false>(mat, b, p.i, s, r, r + b, carry && s < p.k1, sm, ln,
                                   none, none);
      }
    }
    SVDT_SPLIT(7);
    target += G;
    grid_sync(ctr, target);
    if (threadIdx.x == 0) fence_async();  // the barrier before the next copies
    SVDT_SPLIT(8);
  }
}

}  // namespace

// One rank's pass of one superstep of the pipelined chase on its local
// buffer L (rows x ld floats, ld = Np), in place, on `stream`: the pass of
// svdt_band_chase_superstep (band_chase.cu), the same arguments, bit-equal
// to it.  L 16-byte aligned, ld % 4 == 0, b % 4 == 0, 4 <= b <= 128.  ctr is
// one counter for the grid barrier, set to zero on the stream before the
// launch; at most max_ctas CTAs (0: one a lane with work); the grid size
// goes to *ctas (0: the pass has no pair with work, and nothing is
// launched).  Returns the first failing call's cudaError_t.
extern "C" int svdt_band_chase_superstep_wave(float* L, int ld, int rows, int n, int b,
                                              int i0, int LG, int R0, int U, int m, int last,
                                              int s_chase, unsigned* ctr, int max_ctas,
                                              int* ctas, void* stream) {
  *ctas = 0;
  if (n < 2 || LG < 1 || ld < n || rows < 1 || !tma_takes(L, ld, b))
    return (int)cudaErrorInvalidValue;
  int l_lo = -1, l_hi = -1, t_lo = 0, t_hi = 0;  // the lanes with work and their ticks
  for (int l = 0; l < LG; ++l) {
    const PassLane p = pass_lane(n, b, i0, l, R0, m, last, s_chase, ld);
    if (!p.head && p.k1 == p.k0) continue;
    const int first = p.head ? 3 * p.i : 3 * p.i + p.k0 + 1;
    const int end = p.k1 > p.k0 ? 3 * p.i + p.k1 : 3 * p.i;
    if (l_lo < 0) {
      l_lo = l;
      t_lo = first;
      t_hi = end;
    }
    l_hi = l;
    t_lo = imin(t_lo, first);
    t_hi = end > t_hi ? end : t_hi;
  }
  const int map_rows = imin(rows, n - R0 + U);  // the local row of global row n
  if (l_lo < 0 || map_rows < 1) return (int)cudaSuccess;
  alignas(64) CUtensorMap tile_map;
  int err = encode_rect_map(&tile_map, L, map_rows, n, ld, b, box_cols(b));
  if (err != 0) return err;
  int l0 = l_lo, lanes = l_hi - l_lo + 1, t0 = t_lo, T = t_hi - t_lo + 1;
  const size_t smem = smem_tick_bytes(b);
  cudaStream_t s = (cudaStream_t)stream;
  err = (int)cudaMemsetAsync(ctr, 0, sizeof(unsigned), s);
  if (err != 0) return err;
  void* args[] = {&tile_map, &L, &ld, &n, &b, &i0, &l0, &lanes, &R0, &U, &m, &last,
                  &s_chase, &t0, &T, &ctr};
#define SVDT_PASS_LAUNCH(KPL, BF)                                                      \
  err = coop_launch(superstep_wave_kernel<KPL, BF>, kThreads, lanes, max_ctas, args, smem, \
                    s, ctas)
  if (b == 32) SVDT_PASS_LAUNCH(1, 32);
  else if (b < 32) SVDT_PASS_LAUNCH(1, 0);
  else if (b == 64) SVDT_PASS_LAUNCH(2, 64);
  else if (b < 64) SVDT_PASS_LAUNCH(2, 0);
  else if (b == 128) SVDT_PASS_LAUNCH(4, 128);
  else SVDT_PASS_LAUNCH(4, 0);
#undef SVDT_PASS_LAUNCH
  return err;
}
