// Band -> bidiagonal bulge chase on a wavefront schedule, one CTA a lane.
//
// svdt_band_chase_wave replaces the TPU kernels
//   svdsolver_tpu/ops/pallas/band_chase.py  _wavefront_kernel (the
//       `wavefront=True` route of band_to_bidiagonal_pallas);
//   svdsolver_tpu/ops/pallas/band_chase_wave.py  _wave_chase_kernel (the
//       wavefront chase the JAX svdvals routes by wave_chase_preferred);
// svdt_band_chase_wave_rec (template flag Rec) replaces
//   svdsolver_tpu/ops/pallas/band_chase_wave.py  _wave_chase_rec_kernel (the
//       recording wavefront chase the JAX svd routes by
//       wave_chase_accum_preferred): each pair stores its reflectors into
//       slot (i, 0) (head pair) or (i, s) (chase pair of slot s), the slots
//       svdt_band_chase_rec fills, through the one chase_pair, so (d, e) and
//       every record are bit-equal to it;
// svdt_band_chase_wave_smem_dl (wave_smem_dl_kernel) and, on the shapes
// the copy engine does not take, svdt_band_chase_wave_dl (template flag
// DeferLeft) replace
//   svdsolver_tpu/ops/pallas/band_chase_wave.py  _wave_chase_dl_kernel (each
//       pair's left apply deferred one tick and fused into the same sweep's
//       next right apply; tick _wave_tick_dl, _pend_correct,
//       _pend_right_apply_xcol).
// Schedule: models/two_stage.band_to_bidiagonal_wavefront.  Sweep i runs its
// slot s (0: the head pair, s >= 1: chase pair s - 1) at tick t = 3 i + s.
// Windows of pairs three slots apart are 3b - 1 >= 2b rows apart, so the
// pairs of one tick touch disjoint rows and run at once, and every entry
// sees the operations of the sequential schedule in its order.  Each pair
// is the one chase_pair of chase_pair.cuh, so (d, e) are bit-equal to
// svdt_band_chase's.  The TPU ran its lanes as a batch in one core's VMEM
// and aimed idle lanes at a zero dummy corner; on the card the windows are
// exact and idle lanes do nothing.
//
// The main paths (svdvals, svd, svds) take these entries where
// ops/cuda/band_chase_wave's predicates, measured on the card, say so.
//
// Design: a cooperative launch of G CTAs of 512 threads.  Work unit 0 of a
// tick is the head pair (ticks t % 3 == 0), units 1..L the chase lanes
// (lane l holds sweep q - l, q = floor((t - 1) / 3)); CTA g runs units g,
// g + G, ..., so a shape with more lanes than co-resident CTAs still runs.
// After each tick a grid barrier (grid_sync.cuh: an atomic arrival counter,
// thread 0 of each CTA spinning on an acquire load; ~10 s of spinning
// traps) orders the ticks.  A window rewritten by
// one CTA is read by another after the barrier, so the matrix is read and
// written through L2 only (DenseL2At): no SM can hold a stale L1 line of it.
//
// DeferLeft: the left reflector of pair (i, s) is kept in a device ring slot
// of sweep i (i % R) and applied at tick t + 1, fused with the right apply
// of pair (i, s + 1), whose rows [r, r + b) are that reflector's rows:
//   pass 1 reads the pending region [r, r + b) x [c - b, c + b) for its
//     column sums w (the left apply's own partial-sum code);
//   warp 0 builds the right reflector from the pivot row as the pending
//     apply leaves it, row - tau_p w (the pending v is 1 at the pivot);
//   one read-modify-write applies the pending left and the right reflector
//     to rows [r, r + 2b) x [c, c + b), and the pending left alone to
//     [r, r + b) x [c - b, c).
// Every entry gets the roundings of the sequential order, so (d, e) are
// bit-equal again.  One extra tick a sweep (slot nc + 1) flushes its last
// pending left.
//
// Two ticks run this schedule.  The L2 tick (wave_chase_kernel) runs the
// one chase_pair (or the deferred-left slot) on the matrix through L2; it
// serves bands past 128 and shapes the copy engine cannot take (past 256
// the plain and recording entries run the wide pair of chase_pair.cuh, v
// in dynamic shared memory; the deferred-left entry stops at 256).  The
// shared-memory tick (wave_smem_kernel: svdt_band_chase_wave_smem and
// _smem_rec; wave_smem_dl_kernel: _smem_dl; where the wrapper's
// smem_tick_takes holds: 4 <= b <= 128, b and n multiples of 4, every band
// of the main paths) stages each pair's window in dynamic shared memory by
// the copy engine (TMA, one tensor map of A):
//   - thread 0 copies the window's tiles (r, c), (r + b, c), (r + b, c + b)
//     in, each on its own mbarrier, so warp 0 builds the right reflector
//     from the pivot row while the other tiles land; a box starts at a
//     16-byte column (c & ~3) and is b + 4 columns wide; entries past n read
//     zero and writes past n are dropped, as chase_pair's masks do;
//   - smem_pair runs chase_pair's arithmetic and reduction trees on the
//     tiles, entry for entry, with base pointers and one row stride, so
//     (d, e) and the records stay bit-equal to svdt_band_chase's;
//   - tile (r, c) goes back as soon as the right apply is done, the others
//     after the left apply, by bulk stores drained and fenced before the
//     grid barrier; the 4 columns two boxes of a row band share are copied
//     between them first, so both write the same values;
//   - with one CTA a unit (no striding), lane u keeps tile (r + b, c + b)
//     in shared memory for its next slot, whose tile (r, c) it is (no other
//     pair touches it at either tick), so two ticks of three copy two tiles
//     in instead of three, and two of three two out;
//   - the head pair's window, (b + 1) x 2b, is two boxes and its last row,
//     which the threads copy.
// A pair of this tick is chase_tma.cuh's tick_head / tick_chase, which the
// pipelined chase's pass on the same tick (band_chase_superstep.cu) runs
// too.
// The deferred-left tick (wave_smem_dl_kernel) runs the L2 tick's slot
// arithmetic (dl_head on an accessor of its window in shared memory; dl_slot's
// passes specialised to pointers into the tiles, tiles_partials,
// tiles_pending_left and tiles_right_apply: the same sums, entry for entry,
// by the same threads in the same order) on a window of its own: slot
// (r, c) copies (r, c - b), (r, c) and (r + b, c) in (the pending apply's
// row band and the right apply's rows; the new reflector is column c of the
// last), a slot whose corner column c is past n only its (r, c - b) tile
// (pending only: no right elimination, no new reflector), and the head its
// (b + 1) x b box.  With one CTA a unit, lane u keeps tile (r + b, c), the
// next slot's (r, c - b), and the reflector it made, which that slot
// applies, in shared memory (dl_carries); every other hand-off (the head to
// slot 1, lane u to lane u + 1, every slot when lanes stride) goes through
// the device ring, written through L2 before the grid barrier.  Each box
// goes back as soon as it is final, under the work that follows: (r, c - b)
// once its pending update, done by warps 1-15 while warp 0 builds the right
// reflector, is in; (r, c) after the right apply's rows in it; (r + b, c)
// after the rest, while warp 0 builds the new left reflector.  The stores
// are drained and fenced before the barrier.
//
// What bounds it on the H100: ~3n ticks (11,544 at n = 3840, b = 128) in
// order, each the slowest pair of the tick plus a grid barrier.  The L2
// tick is a chain of dependent L2 round trips a pair; the shared-memory
// tick's floor is one SM's copy rate for the window's boxes (the schedule
// bound of chip_smoke.py), with the pair's shared-memory passes and the
// barrier on top.  FLOPs and device memory bandwidth are far from
// bounding either.
#include <cuda_runtime.h>

#include <cstdint>

#include "chase_pair.cuh"
#include "chase_tma.cuh"
#include "grid_sync.cuh"

namespace {

using namespace svdt;

// The pending left (vp, fcol = tau_p * column sums) and the right reflector
// (v, tau; tau == 0: none) of a deferred-left lane, applied in one pass:
// rows [r, r + 2b) x columns [c, c + b) get the pending update on their
// first b rows and then the right one; rows [r, r + b) x [c - b, c) the
// pending update alone.  The entries and their roundings are those of
// apply_left followed by apply_right.
template <int KPL, class Acc>
__device__ void pend_right_apply(const Acc& a, int n, int b, int r, int c,
                                 bool pend, const float* vp, const float* fcol,
                                 const float* v, float tau) {
  constexpr int R = right_rows<KPL>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float vk[KPL], fk[KPL];
  bool in[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    in[t] = k < b && c + k < n;
    vk[t] = (tau != 0.f && in[t]) ? v[k] : 0.f;
    fk[t] = (pend && in[t]) ? fcol[b + k] : 0.f;
  }
  const int rows = min(2 * b, n - r);
  const int prows = pend ? min(b, n - r) : 0;
  if (tau != 0.f || pend)
    for (int i0 = warp * R; i0 < rows; i0 += kWarps * R) {
      float x[R][KPL];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int k = lane + 32 * t;
          const int i = i0 + q;
          const bool p = i < prows && in[t];
          x[q][t] = (i < rows && (vk[t] != 0.f || p)) ? a.load(r + i, c + k) : 0.f;
          if (p) x[q][t] = rank1(x[q][t], fk[t], vp[i]);
        }
      float f[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float xm[KPL];
#pragma unroll
        for (int t = 0; t < KPL; ++t) xm[t] = vk[t] != 0.f ? x[q][t] : 0.f;
        f[q] = row_dot<KPL>(xm, vk);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) f[q] = tau * warp_sum(f[q]);
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int k = lane + 32 * t;
          const int i = i0 + q;
          if (i < rows && vk[t] != 0.f)
            a.store(r + i, c + k, rank1(x[q][t], f[q], vk[t]));
          else if (i < prows && in[t])
            a.store(r + i, c + k, x[q][t]);
        }
    }
  // [r, r + prows) x [c - b, c): thread (i0, k) owns column k of rows i0,
  // i0 + p, ... (p = 512 / b), kChunk loads in flight before the stores
  const int p = kThreads / b;
  const int i0 = threadIdx.x / b;
  const int k = threadIdx.x - i0 * b;
  if (i0 < p && c - b + k < n) {
    const float f = fcol[k];
    for (int i = i0; i < prows; i += p * kChunk) {
      float x[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int ii = i + u * p;
        x[u] = ii < prows ? a.load(r + ii, c - b + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int ii = i + u * p;
        if (ii < prows) a.store(r + ii, c - b + k, rank1(x[u], f, vp[ii]));
      }
    }
  }
}

// Shared memory of one CTA.
struct Smem {
  float* v;     // the reflector being built or applied (b)
  float* vp;    // the pending left reflector (b)
  float* fcol;  // tau_p times the pending region's column sums (2b)
  float* part;  // left-apply partial sums (kThreads)
  float* s_tau; // tau of the right [0] and pending [1] reflectors
};

// The pending left reflector of sweep i: ring slot i % R.
struct Ring {
  float* v;  // (R, b)
  float* t;  // (R)
  int slots;
};

// Deferred-left head pair of sweep i: its right elimination, and its left
// reflector into the ring.  Acc: the matrix through L2 (the L2 tick) or the
// head's window in shared memory (the shared-memory tick).
template <int KPL, class Acc>
__device__ void dl_head(const Acc& a, int n, int b, int i, Ring ring,
                        Smem sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    float x[KPL];
    load_row<KPL>(a, n, b, i, i + 1, x);
    const float tau = warp_reflector<KPL>(x, b, sm.v);
    if (lane == 0) sm.s_tau[0] = tau;
  }
  __syncthreads();
  const float tau = sm.s_tau[0];
  if (tau != 0.f) apply_right<KPL>(a, n, b, i, i + 1, b + 1, sm.v, tau);
  __syncthreads();
  if (warp == 0) {
    float x[KPL];
    load_col<KPL>(a, n, b, i + 1, i + 1, x);
    const float tau2 = warp_reflector<KPL>(x, b, sm.v);
    float* pv = ring.v + (size_t)(i % ring.slots) * b;
    for (int k = lane; k < b; k += 32) __stcg(pv + k, sm.v[k]);
    if (lane == 0) __stcg(ring.t + i % ring.slots, tau2);
  }
  __syncthreads();
}

// Deferred-left slot (r, c): the pending left reflector (sm.vp, taup) of the
// slot before, fused with the right elimination of the pair at (r, c) when it
// exists (c < n; else the slot is "pending only"), whose left reflector warp
// 0 writes to sm.v; returns its tau to warp 0 (0: none).
template <int KPL, class Acc>
__device__ float dl_slot(const Acc& a, int n, int b, int r, int c, float taup,
                         const Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool pend = taup != 0.f;
  const bool right = c < n;
  SVDT_SPLIT(1);
  if (pend) {
    left_partials(a, n, b, r, c - b, sm.vp, sm.part);
    __syncthreads();
    const LeftThread lt(b);
    if (lt.g == 0)
      sm.fcol[lt.c] = c - b + lt.c < n ? taup * left_total(sm.part, b, lt.c) : 0.f;
    __syncthreads();
  }
  SVDT_SPLIT(2);
  if (right && warp == 0) {
    float x[KPL];
    load_row<KPL>(a, n, b, r, c, x);
    if (pend)
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int k = lane + 32 * t;
        if (k < b && c + k < n) x[t] = rank1(x[t], sm.fcol[b + k], sm.vp[0]);
      }
    const float tau = warp_reflector<KPL>(x, b, sm.v);
    if (lane == 0) sm.s_tau[0] = tau;
  }
  __syncthreads();
  SVDT_SPLIT(3);
  pend_right_apply<KPL>(a, n, b, r, c, pend, sm.vp, sm.fcol, sm.v,
                        right ? sm.s_tau[0] : 0.f);
  __syncthreads();
  SVDT_SPLIT(4);
  float tau2 = 0.f;
  if (right && warp == 0) {
    float x[KPL];
    load_col<KPL>(a, n, b, r + b, c, x);
    tau2 = warp_reflector<KPL>(x, b, sm.v);
  }
  SVDT_SPLIT(5);
  return tau2;
}

// Deferred-left chase slot s >= 1 of sweep i on the L2 tick: its pending
// reflector from the ring, its new one back there.
template <int KPL>
__device__ void dl_lane(const DenseL2At& a, int n, int b, int i, int s,
                        Ring ring, Smem sm) {
  const int tid = threadIdx.x;
  const int r = i + 1 + (s - 1) * b;
  const int c = r + b;
  float* pv = ring.v + (size_t)(i % ring.slots) * b;
  float* pt = ring.t + i % ring.slots;
  for (int k = tid; k < b; k += kThreads) sm.vp[k] = __ldcg(pv + k);
  if (tid == 0) sm.s_tau[1] = __ldcg(pt);
  __syncthreads();
  const float tau2 = dl_slot<KPL>(a, n, b, r, c, sm.s_tau[1], sm);
  if (tid < 32) {
    if (c < n)
      for (int k = tid; k < b; k += 32) __stcg(pv + k, sm.v[k]);
    if (tid == 0) __stcg(pt, tau2);
  }
  SVDT_SPLIT(6);
  __syncthreads();
}

template <int KPL, bool DeferLeft, bool Rec>
__global__ void __launch_bounds__(kThreads)
wave_chase_kernel(float* __restrict__ A, float* __restrict__ d,
                  float* __restrict__ e, int n, int b, int L, int T,
                  unsigned* ctr, Ring ring, Records rec) {
  __shared__ float v_narrow[kMaxBand];
  __shared__ float vp[kMaxBand];
  __shared__ float fcol[2 * kMaxBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  extern __shared__ float v_wide[];  // b floats for the wide pair
  float* v = KPL == kWide ? v_wide : v_narrow;
  const Smem sm = {v, vp, fcol, part, s_tau};
  const DenseL2At a = {A, (size_t)n};
  const Slot none = {nullptr, nullptr};
  const int G = gridDim.x;
  unsigned target = 0;
  for (int t = 0; t < T; ++t) {
    SVDT_SPLIT_TICK(t);
    const int q = t >= 1 ? (t - 1) / 3 : -1;  // newest sweep past its head
    for (int u = blockIdx.x; u <= L; u += G) {
      if (u == 0) {  // the head pair of sweep t / 3
        const int i = t / 3;
        if (t % 3 != 0 || i > n - 2) continue;
        if constexpr (DeferLeft)
          dl_head<KPL>(a, n, b, i, ring, sm);
        else
          chase_pair<KPL, Rec>(a, n, b, i, i + 1, b + 1, 1, v, part, s_tau,
                               Rec ? rec.right(i, 0, b) : none,
                               Rec ? rec.left(i, 0, b) : none);
        continue;
      }
      const int i = q - (u - 1);
      const int s = t - 3 * i;
      if (i < 0 || i > n - 2 || s > nc_of(i, n, b) + (DeferLeft ? 1 : 0))
        continue;
      if constexpr (DeferLeft) {
        dl_lane<KPL>(a, n, b, i, s, ring, sm);
      } else {
        const int r = i + 1 + (s - 1) * b;
        chase_pair<KPL, Rec>(a, n, b, r, r + b, 2 * b, b, v, part, s_tau,
                             Rec ? rec.right(i, s, b) : none,
                             Rec ? rec.left(i, s, b) : none);
      }
    }
    SVDT_SPLIT(7);
    target += G;
    grid_sync(ctr, target);
    SVDT_SPLIT(8);
  }
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n; k += G * kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
}

// ---- the shared-memory tick (b <= 128; TMA, chase_tma.cuh) ----

// Whether chase pair (i, s) keeps its (r + b, c + b) tile for the lane's
// next pair (ops/chase_schedule._carries): not the lane's last slot, and
// that pair exists and has work.
__device__ __forceinline__ bool carries(int i, int s, int n, int b) {
  return s % 3 != 0 && s + 1 <= nc_of(i, n, b) && i + 1 + (s + 1) * b < n;
}

template <int KPL, int BF, bool Rec>
__global__ void __launch_bounds__(kThreads, 1)
wave_smem_kernel(const __grid_constant__ CUtensorMap tile_map,
                 float* __restrict__ A, float* __restrict__ d,
                 float* __restrict__ e, int n, int b_rt, int L, int T,
                 unsigned* ctr, Records rec) {
  extern __shared__ __align__(128) float smem_raw[];
  __shared__ float v[kSmemBand];
  __shared__ __align__(16) float vg[2 * kSmemBand];
  __shared__ float col[kSmemBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  __shared__ __align__(8) uint64_t bar[3];
  const TickSmem sm = {align128(smem_raw), bar, v, vg, col, part, s_tau};
  const TickMat mat = {&tile_map, A, (size_t)n, 0, n};
  const int b = BF ? BF : b_rt;
  const int G = gridDim.x;
  const bool carry = G == L + 1;  // a unit a CTA: a lane's tile can stay
  const Slot none = {nullptr, nullptr};
  tick_init(bar);
  TickLane ln;
  unsigned target = 0;
  for (int t = 0; t < T; ++t) {
    SVDT_SPLIT_TICK(t);
    const int q = t >= 1 ? (t - 1) / 3 : -1;  // newest sweep past its head
    for (int u = blockIdx.x; u <= L; u += G) {
      if (u == 0) {  // the head pair of sweep t / 3
        const int i = t / 3;
        if (t % 3 != 0 || i > n - 2) continue;
        tick_head<KPL, BF, Rec>(mat, b, i, sm, ln, Rec ? rec.right(i, 0, b) : none,
                                Rec ? rec.left(i, 0, b) : none);
        continue;
      }
      const int i = q - (u - 1);
      const int s = t - 3 * i;
      if (i < 0 || i > n - 2 || s > nc_of(i, n, b)) continue;
      const int r = i + 1 + (s - 1) * b;
      const int c = r + b;
      if (c >= n) continue;  // all-zero window: both reflectors the identity
      tick_chase<KPL, BF, Rec>(mat, b, i, s, r, c, carry && carries(i, s, n, b), sm, ln,
                               Rec ? rec.right(i, s, b) : none,
                               Rec ? rec.left(i, s, b) : none);
    }
    SVDT_SPLIT(7);
    target += G;
    grid_sync(ctr, target);
    if (threadIdx.x == 0) fence_async();  // the barrier before the next copies
    SVDT_SPLIT(8);
  }
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n; k += G * kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
}

// ---- the deferred-left shared-memory tick ----

// A window in shared memory whose entry (r, c) sits at p, rows ld apart.
struct SmemAt {
  float* p;
  int r, c, ld;
  __device__ float load(int i, int k) const { return p[(i - r) * ld + (k - c)]; }
  __device__ void store(int i, int k, float x) const { p[(i - r) * ld + (k - c)] = x; }
};

// A deferred-left slot's tiles in shared memory: t0 the tile (r, c - b),
// t1 (r, c), t2 (r + b, c), each at its entry (0, 0), rows box_cols(b)
// apart.  The passes below are dl_slot's (left_partials, pend_right_apply):
// the same sums and updates, entry for entry, the sums by the same threads
// in the same order, through pointers (through an accessor, the index
// arithmetic of every entry bounded them by issue).  BF: b as a constant
// (0: b at run time).
struct DlTiles {
  float *t0, *t1, *t2;
  int r, c, b;
};

// left_partials over rows [r, r + b) x columns [c - b, c + b).
template <int BF>
__device__ __forceinline__ void tiles_partials(const DlTiles& w, int n,
                                               const float* vp, float* part) {
  const int b = BF ? BF : w.b;
  const int ld = box_cols(b);
  const LeftThread lt(b);
  const int rows = min(b, n - w.r);
  float s = 0.f;
  if (lt.g < lt.groups && w.c - b + lt.c < n) {
    const int step = lt.groups * ld;
    const float* q = (lt.c < b ? w.t0 + lt.c : w.t1 + (lt.c - b)) + lt.g * ld;
    for (int i0 = lt.g; i0 < rows; i0 += lt.groups * kChunk, q += kChunk * step) {
      float x[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) x[t] = i0 + t * lt.groups < rows ? q[t * step] : 0.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t * lt.groups;
        if (i < rows) s += vp[i] * x[t];
      }
    }
  }
  if (lt.g < lt.groups) part[lt.g * lt.cols + lt.c] = s;
}

// The pending update of rows [r, r + b) x columns [c - b, c) (t0), by warps
// 1 .. 15 while warp 0 builds the right reflector.
template <int BF>
__device__ __forceinline__ void tiles_pending_left(const DlTiles& w, int n,
                                                   const float* vp, const float* fcol) {
  const int b = BF ? BF : w.b;
  const int ld = box_cols(b);
  const int p = (kThreads - 32) / b;
  const int i0 = (threadIdx.x - 32) / b;
  const int k = threadIdx.x - 32 - i0 * b;
  const int prows = min(b, n - w.r);
  if (i0 >= p || w.c - b + k >= n) return;
  const float f = fcol[k];
  for (int i = i0; i < prows; i += p * kChunk) {
    float* q = w.t0 + i * ld + k;
    float x[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) x[u] = i + u * p < prows ? q[u * p * ld] : 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (i + u * p < prows) q[u * p * ld] = rank1(x[u], f, vp[i + u * p]);
  }
}

// pend_right_apply's rows [r + lo, r + hi) x columns [c, c + b), in t1
// below row r + b and in t2 from there; R rows a warp at once (any R gives
// each row the same sum: one warp's row_dot and warp_sum).  Each row reads
// its pending factor vp[i] once, and a row or column without a pending
// update gets x - fk * 0 or x - 0 * vp[i] there: x itself, in an entry the
// row's sum masks out and that is not stored.  Interior: the window lies
// inside the matrix (c + b <= n, r + 2b <= n) and b == 32 KPL, so the
// masks at n fold away.
template <int KPL, int R, int BF, bool Interior>
__device__ __forceinline__ void tiles_right_apply(const DlTiles& w, int n, int lo, int hi,
                                                  bool pend, const float* vp,
                                                  const float* fcol, const float* v,
                                                  float tau) {
  const int b = BF ? BF : w.b;
  const int ld = box_cols(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float vk[KPL], fk[KPL];
  bool in[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    in[t] = Interior || (k < b && w.c + k < n);
    vk[t] = (tau != 0.f && in[t]) ? v[k] : 0.f;
    fk[t] = (pend && in[t]) ? fcol[b + k] : 0.f;
  }
  const int rows = Interior ? hi : min(hi, n - w.r);
  const int prows = pend ? (Interior ? b : min(b, n - w.r)) : 0;
  if (tau == 0.f && !pend) return;
  for (int i0 = lo + warp * R; i0 < rows; i0 += kWarps * R) {
    float* row[R];
    float x[R][KPL];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + q;
      row[q] = (i < b ? w.t1 + i * ld : w.t2 + (i - b) * ld) + lane;
      const bool pi = i < prows;
      const float vpi = pi ? vp[i] : 0.f;
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        x[q][t] = (i < rows && (vk[t] != 0.f || (pi && in[t]))) ? row[q][32 * t] : 0.f;
        if (pend) x[q][t] = rank1(x[q][t], fk[t], vpi);
      }
    }
    float f[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float xm[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) xm[t] = vk[t] != 0.f ? x[q][t] : 0.f;
      f[q] = row_dot<KPL>(xm, vk);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) f[q] = tau * warp_sum(f[q]);
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int i = i0 + q;
        if (i < rows && vk[t] != 0.f)
          row[q][32 * t] = rank1(x[q][t], f[q], vk[t]);
        else if (i < prows && in[t])
          row[q][32 * t] = x[q][t];
      }
  }
}

// Where a deferred-left slot's boxes live and go: b0, b1, b2 in slots s0
// (-1: carried in, not loaded), s1 and s2 (-1: not loaded, the slot is
// pending only), copied from and to (r, a - b), (r, a) and (r + b, a), the
// tiles at column dl of each (c = a + dl); b2 stays in shared memory where
// `keep`.
struct DlBoxes {
  const CUtensorMap* map;
  float *b0, *b1, *b2;
  int s0, s1, s2, r, a, dl;
  bool keep;
};

// dl_slot on the shared-memory tick (the L2 tick's arithmetic; the pending
// update of t0 moved under the right reflector's build, as the entries it
// writes are read by nothing else in the slot), waiting on each box before
// it is first read.  Its boxes go back as they become final, each store
// overlapping the work that follows: t0 once its pending update is done
// (its 4 columns shared with t1 then hold t1's old values; t1's store,
// issued after t0's has landed, writes them again), t1 after the right
// apply's rows in it, t2 after the rest, while warp 0 builds the new left
// reflector (into vout).  Returns its tau to warp 0 (0: none).
template <int KPL, int BF>
__device__ float smem_dl_slot(const DlBoxes& x, int n, int b_rt, float taup,
                              const Smem& sm, float* vout, Waits& wt) {
  // the right apply's rows a warp at once: a half of 2b rows over all warps
  constexpr int R = BF >= kWarps ? (BF / kWarps < right_rows<KPL>() ? BF / kWarps
                                                                     : right_rows<KPL>())
                                 : 1;
  const int b = BF ? BF : b_rt;
  const int ld = box_cols(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = x.r, c = x.a + x.dl;
  const DlTiles w = {x.b0 + x.dl, x.b1 + x.dl, x.b2 + x.dl, r, c, b};
  const bool pend = taup != 0.f;
  const bool right = c < n;
  if (pend) {
    wt.on(x.s0);
    wt.on(x.s1);
    SVDT_SPLIT(1);
    tiles_partials<BF>(w, n, sm.vp, sm.part);
    __syncthreads();
    const LeftThread lt(b);
    if (lt.g == 0)
      sm.fcol[lt.c] = c - b + lt.c < n ? taup * left_total(sm.part, b, lt.c) : 0.f;
    __syncthreads();
  }
  SVDT_SPLIT(2);
  if (warp == 0) {
    if (right) {
      wt.on(x.s1);
      float xr[KPL];
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int k = lane + 32 * t;
        xr[t] = k < b && c + k < n ? w.t1[k] : 0.f;
        if (pend && k < b && c + k < n) xr[t] = rank1(xr[t], sm.fcol[b + k], sm.vp[0]);
      }
      const float tau = warp_reflector<KPL>(xr, b, sm.v);
      if (lane == 0) sm.s_tau[0] = tau;
    }
  } else if (pend) {
    tiles_pending_left<BF>(w, n, sm.vp, sm.fcol);
    fence_async_smem();  // t0's writes before its store
  }
  __syncthreads();
  SVDT_SPLIT(3);
  if (threadIdx.x == 0 && (pend || x.s0 < 0)) {  // t0 final: back now
    wt.on(x.s0);
    tma_store(x.map, r, x.a - b, x.b0);
    tma_commit();
  }
  if (right) {
    const float tau = sm.s_tau[0];
    // rows [r + lo, r + hi): the interior instance where the window lies
    // inside the matrix (every compile-time band is 32 KPL)
    const bool interior = c + b <= n && r + 2 * b <= n;
    const auto apply = [&](int lo, int hi, bool p) {
      if constexpr (BF != 0)
        if (interior)
          return tiles_right_apply<KPL, R, BF, true>(w, n, lo, hi, p, sm.vp, sm.fcol, sm.v, tau);
      tiles_right_apply<KPL, R, BF, false>(w, n, lo, hi, p, sm.vp, sm.fcol, sm.v, tau);
    };
    wt.on(x.s0);
    wt.on(x.s1);
    for (int k = threadIdx.x; k < 4 * b; k += kThreads)  // t0's last dl columns into t1's box
      if ((k & 3) < x.dl) x.b1[(k >> 2) * ld + (k & 3)] = x.b0[(k >> 2) * ld + (k & 3) + b];
    apply(0, b, pend);
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_wait_all();  // t0's store has written the 4 shared columns
      tma_store(x.map, r, x.a, x.b1);
      tma_commit();
    }
    wt.on(x.s2);
    apply(b, 2 * b, false);
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0 && !x.keep) tma_store(x.map, r + b, x.a, x.b2);
  } else {
    wt.on(x.s0);  // t0 landed before the slot ends
  }
  SVDT_SPLIT(4);
  float tau2 = 0.f;
  if (right && warp == 0) {
    float xc[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      xc[t] = k < b && r + b + k < n ? w.t2[k * ld] : 0.f;
    }
    tau2 = warp_reflector<KPL>(xc, b, vout);
  }
  SVDT_SPLIT(5);
  return tau2;
}

// Whether deferred-left slot (i, s) keeps its (r + b, c) tile and its new
// left reflector for the lane's next slot (ops/chase_schedule._dl_carries):
// not the lane's last slot, that slot exists, and this one makes a
// reflector (c < n).
__device__ __forceinline__ bool dl_carries(int i, int s, int n, int b) {
  return s % 3 != 0 && s + 1 <= nc_of(i, n, b) + 1 && i + 1 + s * b < n;
}

template <int KPL, int BF>
__global__ void __launch_bounds__(kThreads, 1)
wave_smem_dl_kernel(const __grid_constant__ CUtensorMap tile_map,
                    float* __restrict__ A, float* __restrict__ d,
                    float* __restrict__ e, int n, int b_rt, int L, int T,
                    unsigned* ctr, Ring ring) {
  extern __shared__ __align__(128) float smem_raw[];
  float* tiles = align128(smem_raw);
  __shared__ float v[kSmemBand];
  __shared__ float vp[kSmemBand];
  __shared__ float fcol[2 * kSmemBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  __shared__ __align__(8) uint64_t bar[3];
  const Smem sm = {v, vp, fcol, part, s_tau};
  const int b = BF ? BF : b_rt;
  const int G = gridDim.x;
  const bool carry = G == L + 1;  // a unit a CTA: a lane's tile can stay
  const int tsz = tile_floats(b);
  const int ldt = box_cols(b);
  const unsigned tile_bytes = 4u * b * ldt;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(bar + k);
    fence_async();
  }
  __syncthreads();
  unsigned parity = 0;
  int cur = 0;                   // the slot of the (r, c - b) tile
  int kept_i = -1, kept_s = -1;  // the slot whose tile and reflector are kept
  unsigned target = 0;
  for (int t = 0; t < T; ++t) {
    SVDT_SPLIT_TICK(t);
    const int q = t >= 1 ? (t - 1) / 3 : -1;  // newest sweep past its head
    for (int u = blockIdx.x; u <= L; u += G) {
      if (u == 0) {  // the head pair of sweep t / 3
        // window rows [i, i + b] x columns [i + 1, i + 1 + b): a b x b box
        // by the copy engine in slot 0 and row i + b by the threads
        const int i = t / 3;
        if (t % 3 != 0 || i > n - 2) continue;
        const int dl = (i + 1) & 3;
        const int a = i + 1 - dl;
        float* h0 = tiles;
        if (tid == 0) {
          mbar_expect(bar, tile_bytes);
          tma_load(h0, &tile_map, i, a, bar);
        }
        const int hr = i + b;
        float* xr = h0 + b * ldt + dl;  // row i + b, columns [i + 1, i + 1 + b)
        for (int k = tid; k < b; k += kThreads)
          xr[k] = hr < n && i + 1 + k < n ? __ldcg(A + (size_t)hr * n + i + 1 + k) : 0.f;
        mbar_wait(bar, parity & 1u);
        __syncthreads();
        dl_head<KPL>(SmemAt{h0 + dl, i, i + 1, ldt}, n, b, i, ring, sm);
        fence_async_smem();
        __syncthreads();
        if (tid == 0) {
          tma_store(&tile_map, i, a, h0);
          tma_store_drain();
          fence_async();
        }
        for (int k = tid; k < b; k += kThreads)
          if (hr < n && i + 1 + k < n) __stcg(A + (size_t)hr * n + i + 1 + k, xr[k]);
        parity ^= 1u;
        kept_i = -1;  // the head's window took slot 0
        continue;
      }
      const int i = q - (u - 1);
      const int s = t - 3 * i;
      if (i < 0 || i > n - 2 || s > nc_of(i, n, b) + 1) continue;
      const int r = i + 1 + (s - 1) * b;
      const int c = r + b;
      if (c - b >= n) continue;  // nothing pending, no pair
      const bool right = c < n;
      const int dl = c & 3;  // the tiles' column in their boxes
      const int a = c - dl;
      const bool cin = kept_i == i && kept_s == s;
      const bool cout = carry && dl_carries(i, s, n, b);
      const int s0 = cur, s1 = (cur + 1) % 3, s2 = (cur + 2) % 3;
      float* t0 = tiles + s0 * tsz;
      float* t1 = tiles + s1 * tsz;
      float* t2 = tiles + s2 * tsz;
      if (tid == 0) {
        if (!cin) {
          mbar_expect(bar + s0, tile_bytes);
          tma_load(t0, &tile_map, r, a - b, bar + s0);
        }
        if (right) {
          mbar_expect(bar + s1, tile_bytes);
          tma_load(t1, &tile_map, r, a, bar + s1);
          mbar_expect(bar + s2, tile_bytes);
          tma_load(t2, &tile_map, r + b, a, bar + s2);
        }
      }
      // the pending reflector: kept from the lane's last slot, or the ring's
      float* pv = ring.v + (size_t)(i % ring.slots) * b;
      float* pt = ring.t + i % ring.slots;
      if (!cin) {
        for (int k = tid; k < b; k += kThreads) vp[k] = __ldcg(pv + k);
        if (tid == 0) s_tau[1] = __ldcg(pt);
      }
      __syncthreads();
      Waits wt = {bar, parity, 0u};
      const DlBoxes boxes = {&tile_map, t0, t1, t2, cin ? -1 : s0, right ? s1 : -1,
                             right ? s2 : -1, r, a, dl, cout};
      const float tau2 = smem_dl_slot<KPL, BF>(boxes, n, b, s_tau[1], sm, cout ? vp : v, wt);
      if (tid < 32) {
        if (cout) {
          if (tid == 0) s_tau[1] = tau2;
        } else {
          if (right)
            for (int k = tid; k < b; k += 32) __stcg(pv + k, v[k]);
          if (tid == 0) __stcg(pt, tau2);
        }
      }
      if (tid == 0) {
        tma_store_drain();
        fence_async();
      }
      SVDT_SPLIT(6);
      __syncthreads();
      parity ^= (cin ? 0u : 1u << s0) | (right ? 1u << s1 | 1u << s2 : 0u);
      kept_i = cout ? i : -1;
      kept_s = s + 1;
      if (cout) cur = s2;
    }
    SVDT_SPLIT(7);
    target += G;
    grid_sync(ctr, target);
    if (tid == 0) fence_async();  // the barrier before the next copies
    SVDT_SPLIT(8);
  }
  for (int k = blockIdx.x * kThreads + tid; k < n; k += G * kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
}

// One CTA moving a chase pair's three b x b tiles at (r, c) from device
// memory into shared memory and back, `reps` times: the copy rate behind
// the shared-memory tick's schedule bound.
__global__ void __launch_bounds__(kThreads, 1)
wave_copy_kernel(const __grid_constant__ CUtensorMap tile_map, int b, int r,
                 int c, int reps) {
  extern __shared__ __align__(128) float smem_raw[];
  float* tiles = align128(smem_raw);
  __shared__ __align__(8) uint64_t bar[1];
  if (threadIdx.x != 0) return;
  mbar_init(bar);
  fence_async();
  const int tsz = tile_floats(b);
  unsigned parity = 0;
  for (int k = 0; k < reps; ++k) {
    mbar_expect(bar, 12u * b * box_cols(b));
    tma_load(tiles, &tile_map, r, c, bar);
    tma_load(tiles + tsz, &tile_map, r + b, c, bar);
    tma_load(tiles + 2 * tsz, &tile_map, r + b, c + b, bar);
    mbar_wait(bar, parity);
    parity ^= 1u;
    tma_store(&tile_map, r, c, tiles);
    tma_store(&tile_map, r + b, c, tiles + tsz);
    tma_store(&tile_map, r + b, c + b, tiles + 2 * tsz);
    tma_store_drain();
    fence_async();
  }
}

// Lanes of the schedule: ceil(S / 3) chase lanes for S slots a sweep at most.
int lanes_of(int S) { return (S + 2) / 3; }

template <bool DeferLeft, bool Rec>
int launch_smem(float* A, float* d, float* e, int n, int b, unsigned* ctr,
                Ring ring, Records rec, int max_ctas, int* ctas, int smem_req,
                void* stream) {
  if (n < 2 || !tma_takes(A, n, b)) return (int)cudaErrorInvalidValue;
  const int S = nc_of(0, n, b) + (DeferLeft ? 1 : 0);  // slots past the head
  int L = lanes_of(S);
  int T = 3 * (n - 2) + S + 1;
  if (DeferLeft && ring.slots < L + 2) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tile_map;
  int err = encode_map(&tile_map, A, n, n, b, box_cols(b));
  if (err != 0) return err;
  const size_t smem = smem_req > 0 ? (size_t)smem_req : smem_tick_bytes(b);
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {&tile_map, &A, &d, &e, &n, &b, &L, &T, &ctr,
                  DeferLeft ? (void*)&ring : (void*)&rec};
#define SVDT_SMEM_LAUNCH(KPL, BF)                                                   \
  do {                                                                              \
    if constexpr (DeferLeft)                                                        \
      err = coop_launch(wave_smem_dl_kernel<KPL, BF>, kThreads, L + 1, max_ctas,    \
                        args, smem, s, ctas);                                       \
    else                                                                            \
      err = coop_launch(wave_smem_kernel<KPL, BF, Rec>, kThreads, L + 1, max_ctas,  \
                        args, smem, s, ctas);                                       \
  } while (0)
  if (b == 32) SVDT_SMEM_LAUNCH(1, 32);
  else if (b < 32) SVDT_SMEM_LAUNCH(1, 0);
  else if (b == 64) SVDT_SMEM_LAUNCH(2, 64);
  else if (b < 64) SVDT_SMEM_LAUNCH(2, 0);
  else if (b == 128) SVDT_SMEM_LAUNCH(4, 128);
  else SVDT_SMEM_LAUNCH(4, 0);
#undef SVDT_SMEM_LAUNCH
  return err;
}

template <bool DeferLeft, bool Rec>
int launch(float* A, float* d, float* e, int n, int b, unsigned* ctr,
           float* ring_v, float* ring_t, int ring_slots, Records rec,
           int max_ctas, int* ctas, void* stream) {
  // the deferred-left slot has no wide instance: b <= kMaxBand
  if (n < 2 || b < 1 || (DeferLeft && b > kMaxBand)) return (int)cudaErrorInvalidValue;
  const int S = nc_of(0, n, b) + (DeferLeft ? 1 : 0);  // slots past the head
  int L = lanes_of(S);
  int T = 3 * (n - 2) + S + 1;
  Ring ring = {ring_v, ring_t, ring_slots};
  if (DeferLeft && ring_slots < L + 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {&A, &d, &e, &n, &b, &L, &T, &ctr, &ring, &rec};
  int err = 0;
  if constexpr (DeferLeft)
    SVDT_KPL_DISPATCH(b, err = coop_launch(wave_chase_kernel<KPL, true, Rec>, kThreads,
                                           L + 1, max_ctas, args, 0, s, ctas));
  else  // the wide pair's v: b floats of dynamic shared memory
    SVDT_BAND_DISPATCH(b, err = coop_launch(wave_chase_kernel<KPL, false, Rec>, kThreads,
                                            L + 1, max_ctas, args,
                                            KPL == kWide ? sizeof(float) * (size_t)b : 0,
                                            s, ctas));
  return err;
}

}  // namespace

// The wavefront chase on `stream`, overwriting A (n x n, row-major, upper
// band b): (d, e) as svdt_band_chase's.  ctr is one zeroed counter for the
// grid barrier; at most max_ctas CTAs (0: as many as are co-resident, at
// most one per lane); the grid size goes to *ctas.  Returns the launch's
// cudaError_t.
extern "C" int svdt_band_chase_wave(float* A, float* d, float* e, int n, int b,
                                    unsigned* ctr, int max_ctas, int* ctas,
                                    void* stream) {
  return launch<false, false>(A, d, e, n, b, ctr, nullptr, nullptr, 0,
                              {nullptr, nullptr, nullptr, nullptr, 0},
                              max_ctas, ctas, stream);
}

// As svdt_band_chase_wave, and writes every reflector into the
// zero-initialised records VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max),
// the slots and values of svdt_band_chase_rec.
extern "C" int svdt_band_chase_wave_rec(float* A, float* d, float* e, int n,
                                        int b, float* VL, float* TL, float* VR,
                                        float* TR, int s_max, unsigned* ctr,
                                        int max_ctas, int* ctas, void* stream) {
  return launch<false, true>(A, d, e, n, b, ctr, nullptr, nullptr, 0,
                             {VL, TL, VR, TR, s_max}, max_ctas, ctas, stream);
}

// As svdt_band_chase_wave with each left apply deferred one tick; ring_v
// (ring_slots, b) and ring_t (ring_slots) hold the pending reflectors,
// ring_slots >= ceil((nc_of(0) + 1) / 3) + 2.
extern "C" int svdt_band_chase_wave_dl(float* A, float* d, float* e, int n,
                                       int b, unsigned* ctr, float* ring_v,
                                       float* ring_t, int ring_slots,
                                       int max_ctas, int* ctas, void* stream) {
  return launch<true, false>(A, d, e, n, b, ctr, ring_v, ring_t, ring_slots,
                             {nullptr, nullptr, nullptr, nullptr, 0}, max_ctas,
                             ctas, stream);
}

// The wavefront chase with the shared-memory tick, as svdt_band_chase_wave:
// A's address 16-byte aligned, n % 4 == 0, b % 4 == 0, 4 <= b <= 128
// (ops/cuda/band_chase_wave routes the rest to the L2 tick).  smem: dynamic
// shared memory a CTA (0: the three tiles).  Returns the launch's
// cudaError_t.
extern "C" int svdt_band_chase_wave_smem(float* A, float* d, float* e, int n,
                                         int b, unsigned* ctr, int max_ctas,
                                         int* ctas, int smem, void* stream) {
  return launch_smem<false, false>(A, d, e, n, b, ctr, {nullptr, nullptr, 0},
                                   {nullptr, nullptr, nullptr, nullptr, 0},
                                   max_ctas, ctas, smem, stream);
}

// As svdt_band_chase_wave_smem, and writes the records of
// svdt_band_chase_wave_rec.
extern "C" int svdt_band_chase_wave_smem_rec(float* A, float* d, float* e,
                                             int n, int b, float* VL, float* TL,
                                             float* VR, float* TR, int s_max,
                                             unsigned* ctr, int max_ctas,
                                             int* ctas, int smem, void* stream) {
  return launch_smem<false, true>(A, d, e, n, b, ctr, {nullptr, nullptr, 0},
                                  {VL, TL, VR, TR, s_max}, max_ctas, ctas, smem,
                                  stream);
}

// As svdt_band_chase_wave_dl with the shared-memory tick (the shapes of
// svdt_band_chase_wave_smem): each slot's tiles staged in shared memory,
// a lane's (r + b, c) tile and pending reflector kept for its next slot.
extern "C" int svdt_band_chase_wave_smem_dl(float* A, float* d, float* e,
                                            int n, int b, unsigned* ctr,
                                            float* ring_v, float* ring_t,
                                            int ring_slots, int max_ctas,
                                            int* ctas, int smem, void* stream) {
  return launch_smem<true, false>(A, d, e, n, b, ctr,
                                  {ring_v, ring_t, ring_slots},
                                  {nullptr, nullptr, nullptr, nullptr, 0},
                                  max_ctas, ctas, smem, stream);
}

// One CTA copying the three b x b tiles at (r, c) of A (n x n) into shared
// memory and back `reps` times, as the shared-memory tick copies a window.
extern "C" int svdt_wave_copy(float* A, int n, int b, int r, int c, int reps,
                              void* stream) {
  if (!tma_takes(A, n, b) || reps < 1) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tile_map;
  int err = encode_map(&tile_map, A, n, n, b, box_cols(b));
  if (err != 0) return err;
  c &= ~3;
  const size_t smem = smem_tick_bytes(b);
  err = (int)cudaFuncSetAttribute(wave_copy_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err != 0) return err;
  wave_copy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(tile_map, b, r,
                                                                c, reps);
  return (int)cudaGetLastError();
}
