// Band -> bidiagonal bulge chase on the sequential schedule with the windows
// staged in shared memory, one CTA.
//
// svdt_band_chase_staged with khops = 1 replaces the TPU kernel
//   svdsolver_tpu/ops/pallas/band_chase.py  _chase_kernel_pipelined (the
//       `pipelined=True` route: windows stay on chip, the (b, b) overlap is
//       carried to the next window, only the L-strips are copied in);
// with khops = K > 1 it replaces
//   band_chase.py  _chase_kernel_megapipe (the `mega=True` route: the
//       copies of K pairs ahead in flight).
// Schedule and arithmetic: models/two_stage.band_to_bidiagonal, through the
// one pair of chase_pair.cuh (smem_pair of chase_tma.cuh: the same
// arithmetic on shared-memory tiles), so (d, e) are bit-equal to
// svdt_band_chase's.
//
// Design (staged_tma_kernel, where the copy engine takes the shape:
// tma_takes, 4 <= b <= 128, b and n multiples of 4): one block of 512
// threads walks the pairs in order.  Chase pair k of sweep i, at (r, c =
// r + b), touches three b x b tiles, A = (r, c), B = (r + b, c) and C =
// (r + b, c + b), each copied by TMA in a box of b rows of b + 4 columns
// from a 16-byte column (chase_tma.cuh).  The tiles live in a ring of
// NS = 2K + 1 slots: pair k's A in slot 2k mod NS, B and C in the next two,
// so C is pair k + 1's A and stays in shared memory.  The head pair is
// pair -1 of the ring: its window, rows [i, i + b] x columns [i + 1,
// i + 2b], is two boxes of b + 1 rows (a second tensor map), h0 in slot
// NS - 1 and h1 in slot 0, and h1 from its second row is pair 0's A, which
// is neither stored nor loaded between the two.  One thread (lane 0 of
// warp 1: warp 0 builds the reflectors meanwhile) issues every copy; the
// others wait on each slot's mbarrier just before they first read it,
// never on a block barrier for a copy.
//   - once the right apply is done, it waits until every store has written
//     device memory (pair k - 1's B, or h0, shares 4 columns with this A,
//     and two bulk stores in flight land in no fixed order), loads pair
//     k - 1 + K's C into that store's slot and stores A (pair 0: h1 whole);
//   - after the left apply and share_overlap it waits until A's store has
//     read its slot, loads pair k + K's B into it, and stores B (and C at
//     the sweep's last pair).
// Each wait comes a whole apply after the store it waits for, so the
// copying thread holds up no barrier: a thread that waits holds its warp,
// and every warp takes part in the applies.  Pair k + K's right apply reads
// a B loaded K - 1 pairs and a right reflector earlier; its left apply a C
// loaded K - 1 pairs and a left reflector earlier (with K = 1 that load's
// latency shows).  A sweep starts once the previous sweep's stores have
// read their slots, and have landed if that sweep had at most K + 2 pairs
// (its last stores may then meet this sweep's first loads); so no load
// meets a store in flight, across sweeps too; after each such wait for the
// stores to land, the copying thread fences device memory for the copy
// engine (fence.proxy.async.global, as the wavefront tick fences after its
// drain) before its next copies.  Writes to a tile are fenced for the copy
// engine in shared memory only (fence.proxy.async.shared::cta: the full
// proxy fence cost ~0.6 us a pair at b = 64).
// chase_schedule.staged_copies is this order in Python, and two_stage.
// band_to_bidiagonal_staged_tiles its twin.
//
// The first design, staged_v1_kernel (2K + 1 slots of b x (b + 1) floats,
// copies by all threads between block barriers, head pairs on device
// memory), runs only when `v1` asks for it, to time the two designs in
// turns.  Shapes the TMA design does not take (b or n not a multiple of 4,
// a misaligned A) go to svdt_band_chase: the wrapper routes by shape before
// launch.
//
// Shared memory: 2K + 1 slots of tile_floats(b) floats (a box and one more
// row); at b = 128 three fit (K = 1), at b = 64 twelve (K <= 5).  Bands
// above 128 go to svdt_band_chase (the wrapper's route).
//
// What bounds it on the H100: the ~n^2/(2b) pairs in order on one SM.  The
// copies, 4 boxes of b (b + 4) floats a pair at one CTA's copy rate, set
// its schedule bound (chip_smoke.py); the pair's shared-memory passes and
// the waits the lookahead does not hide come on top.
#include <cuda_runtime.h>

#include <cstdint>

#include "chase_pair.cuh"
#include "chase_tma.cuh"

// Phase mark k of the copying thread in pair `row` (tools/chase_split.py
// stamps them); empty in the package's builds.
#ifndef SVDT_SPLIT_COPY
#define SVDT_SPLIT_COPY(row, k)
#endif

namespace {

using namespace svdt;

constexpr int kMaxStagedBand = 128;
constexpr int kMaxSlots = 31;  // 2K + 1 <= 31: one mbarrier and parity bit a slot
constexpr int kCopier = 32;    // the thread that issues every copy

// ---- the first design (shapes the copy engine does not take) ----

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
staged_v1_kernel(float* __restrict__ A, float* __restrict__ d,
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
int launch_v1(float* A, float* d, float* e, int n, int b, int K,
               cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(2 * K + 1) * b * (b + 1);
  cudaError_t err = cudaFuncSetAttribute(
      staged_v1_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  staged_v1_kernel<KPL><<<1, kThreads, smem, s>>>(A, d, e, n, b, K);
  return (int)cudaGetLastError();
}


// ---- the TMA design ----

template <int KPL, int BF>
__global__ void __launch_bounds__(kThreads, 1)
staged_tma_kernel(const __grid_constant__ CUtensorMap map,
                  const __grid_constant__ CUtensorMap hmap, float* __restrict__ A,
                  float* __restrict__ d, float* __restrict__ e, int n, int b_rt,
                  int K) {
  extern __shared__ __align__(128) float smem_raw[];
  float* tiles = align128(smem_raw);
  __shared__ float v[kSmemBand];
  __shared__ __align__(16) float vg[2 * kSmemBand];
  __shared__ float col[kSmemBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  __shared__ __align__(8) uint64_t bar[kMaxSlots];
  const int b = BF ? BF : b_rt;
  const int NS = 2 * K + 1;
  const int tsz = tile_floats(b);
  const int ldt = box_cols(b);
  const unsigned tile_bytes = 4u * b * ldt;
  const bool copier = threadIdx.x == kCopier;
  const Slot none = {nullptr, nullptr};
  if (copier) {
    for (int s = 0; s < NS; ++s) mbar_init(bar + s);
    fence_async();
  }
  __syncthreads();
  unsigned pend = ~0u;  // bit s: the phase parity of slot s's last load
  auto slot = [&](int s) { return tiles + s * tsz; };
  // the copying thread's load of a box at (row, c) into slot s (a head box:
  // b + 1 rows); every thread flips the slot's parity bit with it
  auto load = [&](int s, int row, int c, bool head) {
    if (copier) {
      mbar_expect(bar + s, head ? tile_bytes + 4u * ldt : tile_bytes);
      tma_load(slot(s), head ? &hmap : &map, row, c, bar + s);
    }
    pend ^= 1u << s;
  };
  int pc = 0;  // pairs so far, heads included (the split's rows)
  int prev = -1;  // the previous sweep's chase pairs with work
  for (int i = 0; i < n - 1; ++i) {
    const int nk = min(nc_of(i, n, b), max(0, (n - i - 2) / b));
    const int dl = (i + 1) & 3;  // every tile of the sweep sits at this column
    auto row_of = [&](int k) { return i + 1 + k * b; };
    auto box_of = [&](int k) { return i + 1 + k * b - dl; };  // k = 0: the head's
    // the previous sweep's stores have read their slots, and have landed
    // where they may meet this sweep's first loads (chase_schedule.
    // staged_copies: a sweep of at most K + 2 pairs)
    if (copier && prev >= 0) {
      if (prev <= K + 2) {
        tma_wait_all();
        fence_async_global();
      } else {
        tma_wait_read();
      }
    }
    prev = nk;
    // ---- the head pair (pair -1 of the ring): rows [i, i + b] x columns
    // [i + 1, i + 2b], two boxes of b + 1 rows, h0 in slot NS - 1, h1 in
    // slot 0; h1 from its second row is pair 0's A.  The first K pairs' B
    // and the first K - 1 pairs' C load behind them. ----
    const int h0s = NS - 1;
    float* h0 = slot(h0s);
    float* h1 = slot(0);
    load(h0s, i, box_of(0), true);
    load(0, i, box_of(1), true);
    for (int j = 0; j < min(K, nk); ++j) load(2 * j + 1, row_of(j) + b, box_of(j + 1), false);
    for (int j = 0; j < min(K - 1, nk); ++j)
      load(2 * j + 2, row_of(j) + b, box_of(j + 2), false);
    {
      SVDT_SPLIT_TICK(pc);
      ++pc;
      Waits wt = {bar, pend, 0u};
      const Win w = {h0 + dl, h0 + dl, h0 + dl + ldt, h1 + dl + ldt, ldt, b + 1, b + 1, 1};
      smem_pair<KPL, BF, false>(w, b, wt, h0s, -1, 0, NoMid{}, v, vg, col, part, s_tau,
                                none, none);
      share_overlap(h0, h1, b, dl, b + 1);
      fence_async_smem();
      __syncthreads();
      if (copier) {
        tma_store(&hmap, i, box_of(0), h0);
        if (nk == 0) tma_store(&hmap, i, box_of(1), h1);
        tma_commit();
      }
    }
    // ---- the chase pairs with work (corner column below n) ----
    int sA = 0;
    for (int k = 0; k < nk; ++k) {
      const int row = pc++;
      SVDT_SPLIT_TICK(row);
      const int r = row_of(k);
      const int a = box_of(k + 1);
      const int sB = sA + 1 < NS ? sA + 1 : 0;
      const int sC = sB + 1 < NS ? sB + 1 : 0;
      float* tA = slot(sA);
      float* tB = slot(sB);
      float* tC = slot(sC);
      Waits wt = {bar, pend, 0u};
      // once the right apply is done: every store in flight has landed
      // (pair k - 1's B or h0, whose slot takes pair k - 1 + K's C), then A
      // goes back (pair 0's: h1 whole)
      const auto mid = [&] {
        if (copier) {
          SVDT_SPLIT_COPY(row, 10);
          tma_wait_all();
          fence_async_global();
          SVDT_SPLIT_COPY(row, 11);
        }
        if (k - 1 + K < nk) {
          load(sA > 0 ? sA - 1 : NS - 1, row_of(k - 1 + K) + b, box_of(k + K + 1), false);
          wt.parity = pend;  // with K = 1 this pair's C: waited below
        }
        if (copier) {
          if (k == 0) tma_store(&hmap, i, a, tA);
          else tma_store(&map, r, a, tA);
          tma_commit();
          SVDT_SPLIT_COPY(row, 12);
        }
      };
      const Win w = {tA + dl + (k == 0 ? ldt : 0), tB + dl, tB + dl, tC + dl, ldt, 2 * b, b, b};
      smem_pair<KPL, BF, false>(w, b, wt, -1, sB, sC, mid, v, vg, col, part, s_tau,
                                none, none);
      share_overlap(tB, tC, b, dl, b);
      fence_async_smem();
      __syncthreads();
      SVDT_SPLIT(7);
      if (k + K < nk) {  // pair k + K's B into A's slot once A's store has read it
        if (copier) {
          SVDT_SPLIT_COPY(row, 13);
          tma_wait_read();
          SVDT_SPLIT_COPY(row, 14);
        }
        load(sA, row_of(k + K) + b, box_of(k + K + 1), false);
      }
      if (copier) {
        tma_store(&map, r + b, a, tB);
        if (k == nk - 1) tma_store(&map, r + b, a + b, tC);
        tma_commit();
      }
      sA = sC;
    }
  }
  // every store landed, then d and e through L2
  if (copier) {
    tma_wait_all();
    fence_async();
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    d[k] = __ldcg(A + (size_t)k * n + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * n + k + 1);
  }
}

size_t tma_smem_bytes(int b, int K) {
  return sizeof(float) * (2 * K + 1) * (size_t)tile_floats(b) + 128;
}

int launch_tma(float* A, float* d, float* e, int n, int b, int K, cudaStream_t s) {
  if (!tma_takes(A, n, b) || 2 * K + 1 > kMaxSlots) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map, hmap;  // boxes of b rows, and the head's of b + 1
  int err = encode_map(&map, A, n, b, box_cols(b));
  if (err == 0) err = encode_map(&hmap, A, n, b + 1, box_cols(b));
  if (err != 0) return err;
  const size_t smem = tma_smem_bytes(b, K);
#define SVDT_TMA_LAUNCH(KPL, BF)                                                  \
  do {                                                                            \
    err = (int)cudaFuncSetAttribute(staged_tma_kernel<KPL, BF>,                   \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                    (int)smem);                                   \
    if (err != 0) return err;                                                     \
    staged_tma_kernel<KPL, BF><<<1, kThreads, smem, s>>>(map, hmap, A, d, e, n, b,  \
                                                           K);                    \
  } while (0)
  if (b == 32) SVDT_TMA_LAUNCH(1, 32);
  else if (b < 32) SVDT_TMA_LAUNCH(1, 0);
  else if (b == 64) SVDT_TMA_LAUNCH(2, 64);
  else if (b < 64) SVDT_TMA_LAUNCH(2, 0);
  else if (b == 128) SVDT_TMA_LAUNCH(4, 128);
  else SVDT_TMA_LAUNCH(4, 0);
#undef SVDT_TMA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// The staged chase on `stream`, overwriting A (n x n, row-major, upper band
// b <= 128) with the copies of khops pairs in flight ahead of the pair
// that runs; (d, e) as svdt_band_chase's.  v1 = 0: the TMA design (A's
// address 16-byte aligned, n % 4 == 0, b % 4 == 0, 4 <= b, 2 khops + 1 <=
// 31); v1 = 1: the first design (any shape; kept for timing the two in
// turns).  Returns the launch's
// cudaError_t (an invalid value for a shape the design does not take or
// slots that do not fit shared memory).
extern "C" int svdt_band_chase_staged(float* A, float* d, float* e, int n,
                                      int b, int khops, int v1, void* stream) {
  if (n < 2 || b < 1 || b > kMaxStagedBand || khops < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!v1) return launch_tma(A, d, e, n, b, khops, s);
  if (b <= 32) return launch_v1<1>(A, d, e, n, b, khops, s);
  if (b <= 64) return launch_v1<2>(A, d, e, n, b, khops, s);
  return launch_v1<4>(A, d, e, n, b, khops, s);
}
