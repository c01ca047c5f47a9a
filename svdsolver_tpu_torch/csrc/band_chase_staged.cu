// Band -> bidiagonal bulge chase on the sequential schedule with the windows
// staged in shared memory, one CTA: the card's sequential chase wherever
// the copy engine takes the shape (ops/cuda/band_chase.staged_route).
//
// svdt_band_chase_staged with khops = 1 replaces the TPU kernels
//   svdsolver_tpu/ops/pallas/band_chase.py  _chase_kernel (K3: the dense
//       chase, one DMA'd window per pair; band_to_bidiagonal with no flags);
//   band_chase.py  _chase_kernel_pipelined (K14, the `pipelined=True`
//       route: windows stay on chip, the (b, b) overlap is carried to the
//       next window, only the L-strips are copied in);
//   band_chase_stream.py  _stream_chase_kernel with rec=False (K5) where
//       the main paths' predicate picks the sequential chase;
// with khops = K > 1 it replaces
//   band_chase.py  _chase_kernel_megapipe (K15, the `mega=True` route: the
//       copies of K pairs ahead in flight).
// svdt_band_chase_staged_rec, the same kernel with Rec, replaces the
// recording twins band_chase.py _chase_kernel_rec (K6) and
// band_chase_stream.py _stream_chase_kernel with rec=True (K8) likewise.
// Shapes the copy engine does not take run svdt_band_chase(_rec)
// (band_chase.cu), chosen by shape before launch.
// svdt_band_chase_vmem_tma runs the same kernel on a band store and
// replaces
//   band_chase_vmem.py  _vmem_chase_kernel (K12: the sequential chase on
//       the band block-packed into VMEM, d and e read out of it).
// The port keeps its own layout, not the TPU's: the block packing lined up
// VMEM lanes, and on the card it would cut a b-row tile that crosses a
// 128-row block into two pieces 128 columns apart, which no one TMA box
// fetches.  The store is skewed: entry (g, j) at S g + j, S = 3b + 8, for
// j - g in [-b - 2, 2b + 4], the offsets every box of the schedule touches
// inside the matrix (chase_schedule.store_range; the tests walk every box).
// Seen by the copy engine it is the n x n matrix with row pitch S < n
// (cuTensorMapEncodeTiled accepts a pitch below the row's width, rows
// overlapping in memory, with CUDA 12.8 on the H100; bounds are checked on
// coordinates), so one tensor map describes it and the kernel runs
// unchanged with the pitch where it had n.  Entry
// (g, j) sits at (S + 1) g + (j - g), and 3b + 7 offsets fit in S + 1, so
// no two entries a box touches share an address.  The store takes
// (n - 1) S + n floats (6.0 MB at n = 3840, b = 128, against 59 MB dense),
// S a multiple of 4 for any n.  A pack kernel (one thread an address)
// builds it from the dense band first, on the same stream.
// Schedule and arithmetic: models/two_stage.band_to_bidiagonal, through the
// one pair of chase_pair.cuh (smem_pair of chase_tma.cuh: the same
// arithmetic on shared-memory tiles), so (d, e) are bit-equal to
// svdt_band_chase's, and the records to svdt_band_chase_rec's: warp 0
// stores each reflector into its slot (i, s) after building it (the head
// slot 0, chase pair k slot k + 1), from shared memory straight to device
// memory, as the recording wavefront tick does.  The pairs past n, which
// the kernel skips, keep the zero rows and tau 0 of the zeroed buffers,
// which is what svdt_band_chase_rec leaves there too.
//
// Design (staged_tma_kernel, where the copy engine takes the shape:
// tma_takes, 4 <= b <= 128, b and the row pitch multiples of 4; for the
// dense matrix the pitch is n): one block of 512
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

constexpr int kMaxSlots = 31;  // 2K + 1 <= 31: one mbarrier and parity bit a slot
constexpr int kCopier = 32;    // the thread that issues every copy

template <int KPL, int BF, bool Rec>
__global__ void __launch_bounds__(kThreads, 1)
staged_tma_kernel(const __grid_constant__ CUtensorMap map,
                  const __grid_constant__ CUtensorMap hmap, float* __restrict__ A,
                  float* __restrict__ d, float* __restrict__ e, int n, int ld,
                  int b_rt, int K, Records rec) {
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
      smem_pair<KPL, BF, Rec>(w, b, wt, h0s, -1, 0, NoMid{}, v, vg, col, part, s_tau,
                              Rec ? rec.right(i, 0, b) : none,
                              Rec ? rec.left(i, 0, b) : none);
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
      smem_pair<KPL, BF, Rec>(w, b, wt, -1, sB, sC, mid, v, vg, col, part, s_tau,
                              Rec ? rec.right(i, k + 1, b) : none,
                              Rec ? rec.left(i, k + 1, b) : none);
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
  // every store landed, then d and e through L2 (entry (k, j) at ld k + j)
  if (copier) {
    tma_wait_all();
    fence_async();
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    d[k] = __ldcg(A + (size_t)k * ld + k);
    if (k + 1 < n) e[k] = __ldcg(A + (size_t)k * ld + k + 1);
  }
}

size_t tma_smem_bytes(int b, int K) {
  return sizeof(float) * (2 * K + 1) * (size_t)tile_floats(b) + 128;
}

// The kernel on the n x n matrix whose entry (g, j) sits at A[ld g + j]:
// ld = n for the dense matrix, the store's pitch for the band store.
template <bool Rec>
int launch_tma(float* A, float* d, float* e, int n, int ld, int b, int K,
               Records rec, cudaStream_t s) {
  if (n < 2 || K < 1 || !tma_takes(A, ld, b) || 2 * K + 1 > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map, hmap;  // boxes of b rows, and the head's of b + 1
  int err = encode_map(&map, A, n, ld, b, box_cols(b));
  if (err == 0) err = encode_map(&hmap, A, n, ld, b + 1, box_cols(b));
  if (err != 0) return err;
  const size_t smem = tma_smem_bytes(b, K);
#define SVDT_TMA_LAUNCH(KPL, BF)                                                  \
  do {                                                                            \
    err = (int)cudaFuncSetAttribute(staged_tma_kernel<KPL, BF, Rec>,              \
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                    (int)smem);                                   \
    if (err != 0) return err;                                                     \
    staged_tma_kernel<KPL, BF, Rec><<<1, kThreads, smem, s>>>(map, hmap, A, d, e, \
                                                              n, ld, b, K, rec);  \
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

// The band store's row pitch: dense entry (g, j) lives at S g + j.
__host__ __device__ constexpr int store_pitch(int b) { return 3 * b + 8; }

// Packs the dense A (n x n, row-major) into the band store St of
// (n - 1) S + n floats, one thread an address: entry (g, j) with j - g in
// [-b - 2, 2b + 4] at S g + j = (S + 1) g + (j - g), every other address
// zero.  3b + 7 offsets in a period of S + 1 = 3b + 9: no two entries
// share an address.
__global__ void store_pack_kernel(const float* __restrict__ A, float* __restrict__ St,
                                  int n, int b) {
  const size_t period = store_pitch(b) + 1;
  const size_t total = (size_t)(n - 1) * store_pitch(b) + n;
  for (size_t a = (size_t)blockIdx.x * blockDim.x + threadIdx.x; a < total;
       a += (size_t)gridDim.x * blockDim.x) {
    const size_t u = a + b + 2;  // (S + 1) g + (j - g + b + 2)
    const int g = (int)(u / period);
    const int t = (int)(u - g * period) - (b + 2);  // j - g
    const int j = g + t;
    St[a] = (t <= 2 * b + 4 && j >= 0 && j < n) ? A[(size_t)g * n + j] : 0.f;
  }
}

}  // namespace

// The staged chase's TMA design on `stream`, overwriting A (n x n,
// row-major, upper band b) with the copies of khops pairs in flight ahead
// of the pair that runs; (d, e) as svdt_band_chase's.  It takes A's
// address 16-byte aligned, n % 4 == 0, b % 4 == 0, 4 <= b <= 128 and
// 2 khops + 1 <= 31 slots that fit shared memory (the wrapper's route);
// returns the launch's cudaError_t (an invalid value for any other shape).
extern "C" int svdt_band_chase_staged(float* A, float* d, float* e, int n,
                                      int b, int khops, void* stream) {
  return launch_tma<false>(A, d, e, n, n, b, khops,
                           {nullptr, nullptr, nullptr, nullptr, 0},
                           (cudaStream_t)stream);
}

// As svdt_band_chase_staged, and writes every reflector into the
// zero-initialised records VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max),
// as svdt_band_chase_rec does, bit for bit.
extern "C" int svdt_band_chase_staged_rec(float* A, float* d, float* e, int n,
                                          int b, float* VL, float* TL, float* VR,
                                          float* TR, int s_max, int khops,
                                          void* stream) {
  return launch_tma<true>(A, d, e, n, n, b, khops, {VL, TL, VR, TR, s_max},
                          (cudaStream_t)stream);
}

// The packed chase (K12) on the band store: packs the dense A (n x n,
// row-major, upper band b; not modified) into St ((n - 1)(3b + 8) + n
// floats) and chases St with the copies of khops pairs in flight, on
// `stream`; (d, e) as svdt_band_chase's.  It takes St 16-byte aligned,
// b % 4 == 0 and 4 <= b <= 128, any n >= 2; returns the first failing
// launch's cudaError_t (an invalid value for any other shape).
extern "C" int svdt_band_chase_vmem_tma(const float* A, float* St, float* d,
                                        float* e, int n, int b, int khops,
                                        void* stream) {
  const int S = store_pitch(b);
  if (n < 2 || !tma_takes(St, S, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t total = (size_t)(n - 1) * S + n;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  store_pack_kernel<<<blocks, 256, 0, s>>>(A, St, n, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_tma<false>(St, d, e, n, S, b, khops,
                           {nullptr, nullptr, nullptr, nullptr, 0}, s);
}
