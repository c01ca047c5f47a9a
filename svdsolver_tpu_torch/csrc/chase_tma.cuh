// The copy engine (TMA) pieces of the chase kernels that stage a pair's
// window in shared memory: the wavefront chase's shared-memory tick
// (band_chase_wave.cu), the pipelined chase's pass on that tick
// (band_chase_superstep.cu) and the staged chase (band_chase_staged.cu).
//
//  * mbarrier and bulk-copy primitives: one thread issues a box copy of a
//    tensor map between device and shared memory, a load completing on an
//    mbarrier, a store in a bulk group;
//  * Win, Waits and smem_pair: one elimination pair on a window held in
//    shared memory tiles, chase_pair's arithmetic entry for entry, waiting
//    on each tile's copy just before it first reads it;
//  * the box geometry (box_cols, tile_floats, share_overlap, align128) and
//    the host's tensor map encoder;
//  * tick_head and tick_chase: one pair of a shared-memory tick, its boxes
//    copied in, smem_pair, its boxes back, a lane's tile kept for its next
//    pair (the wavefront chase and the pipelined chase's pass).
//
// A box starts at a 16-byte column and its shared-memory destination on a
// 128-byte boundary: either fault shows as "illegal instruction".
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>

#include <cstdint>

#include "chase_pair.cuh"

namespace svdt {

constexpr int kSmemBand = 128;  // widest band a staged window takes

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on `bar`, expecting `bytes` from the copies issued next.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The box of `map` with corner (row, col) into shared memory, completion on
// `bar`; entries past the matrix read as zero.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int row, int col, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(map), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The box at (row, col) back from shared memory; entries past the matrix
// are dropped.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int row,
                                          int col, const float* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
      ::"l"(map), "r"(col), "r"(row), "r"(smem_u32(src)) : "memory");
}

// The bulk stores issued since the last commit become one bulk group.
__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Every committed bulk group of this thread has read its shared memory
// (the source may be overwritten); the writes may still be in flight.
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Every committed bulk group of this thread has written device memory.
__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Every bulk store this thread issued has written device memory.
__device__ __forceinline__ void tma_store_drain() {
  tma_commit();
  tma_wait_all();
}

// Orders this thread's plain accesses against the copy engine's, both
// ways, in shared and device memory.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// As fence_async, in device memory only: what the copy engine wrote there
// (bulk stores waited for with tma_wait_all) before this thread's next
// copies read it.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// As fence_async, in shared memory only: this thread's writes to a tile
// before a bulk store reads it (a barrier, then the store).  Cheaper than
// the full fence.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Where a pair's window lives in shared memory.  Right view (the right
// apply's rows 0 .. wr - 1, columns 0 .. b - 1): row i at r0 + i * ld below
// `split`, else at r1 + (i - split) * ld.  Left view (the left apply's rows
// 0 .. b - 1, right-view rows lr0 .. lr0 + b - 1; columns 0 .. 2b - 1):
// column k at l0 + k below b, else at l1 + k - b; row j at j * ld from there.
struct Win {
  float *r0, *r1, *l0, *l1;
  int ld, wr, split, lr0;
};

// The copies a pair waits for, by tile slot: each thread waits on a slot's
// barrier once a pair, before it first reads that slot.
struct Waits {
  uint64_t* bar;
  unsigned parity;  // bit k: the phase of slot k's pending copy
  unsigned done;
  __device__ void on(int k) {
    if (k < 0 || (done >> k & 1u)) return;
    mbar_wait(bar + k, parity >> k & 1u);
    done |= 1u << k;
  }
};

// What a pair does between its right and left eliminations: nothing.
struct NoMid {
  __device__ void operator()() const {}
};

// One elimination pair on a window in shared memory, waiting on slot sa
// (the box of the pivot row; -1: already there), sb (the other right rows)
// and sc (the box only the left apply reads).  chase_pair's arithmetic,
// reduction trees and thread mapping entry for entry, so (d, e) and the
// records are bit-equal to it, without its per-entry predicates: the copies
// read zero past n and drop the writes past n, so entries past n take part
// as the zeros chase_pair reads there (a +-0 term changes no sum).  The
// right apply's lane 0 keeps the left reflector's pivot column in `col` as
// it writes it, so warp 0 reads a vector, not a tile column; the left apply
// keeps its rows of one column in registers between its two passes and
// reads the reflector by row group from `vg`.  BF: b as a constant (0: b at
// run time).  Every thread calls mid() once the right apply is done and its
// writes are fenced for the copy engine (rows [0, b) of the right view are
// final then: the left apply never touches them).  Ends with the window
// complete in shared memory, after a barrier; the left apply's writes are
// not fenced for the copy engine (every caller copies the boxes' shared
// columns across first, and fences then).
template <int KPL, int BF, bool Rec, class Mid>
__device__ __forceinline__ void smem_pair(const Win& w, int b, Waits& wt,
                                          int sa, int sb, int sc, const Mid& mid,
                                          float* v, float* vg,
                                          float* col, float* part,
                                          float* s_tau, Slot rr, Slot rl_) {
  constexpr int R = right_rows<KPL>();
  constexpr int NRM = BF ? BF / (kThreads / (2 * BF)) : 4 * KPL * KPL;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- right elimination ----
  if (warp == 0) {
    wt.on(sa);
    SVDT_SPLIT(1);
    float x[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      x[t] = k < b ? w.r0[k] : 0.f;
    }
    const float tau = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[0] = tau;
    if constexpr (Rec) record(v, tau, b, rr.v, rr.t);
  }
  __syncthreads();
  SVDT_SPLIT(2);
  const float tau = s_tau[0];
  wt.on(sa);
  if (tau != 0.f) {
    float vk[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      vk[t] = k < b ? v[k] : 0.f;
    }
    for (int i0 = warp * R; i0 < w.wr; i0 += kWarps * R) {
      if (i0 + R > w.split) wt.on(sb);
      float* row[R];
      float x[R][KPL];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = i0 + q;
        row[q] = i < w.split ? w.r0 + i * w.ld : w.r1 + (i - w.split) * w.ld;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int k = lane + 32 * t;
          x[q][t] = (i < w.wr && k < b) ? row[q][k] : 0.f;
        }
      }
      float f[R];
#pragma unroll
      for (int q = 0; q < R; ++q) f[q] = row_dot<KPL>(x[q], vk);
#pragma unroll
      for (int q = 0; q < R; ++q) f[q] = tau * warp_sum(f[q]);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = i0 + q;
        if (i >= w.wr) continue;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const float y = rank1(x[q][t], f[q], vk[t]);
          if (vk[t] != 0.f) row[q][lane + 32 * t] = y;
          if (t == 0 && lane == 0 && i >= w.lr0 && i < w.lr0 + b) col[i - w.lr0] = y;
        }
      }
    }
  }
  wt.on(sb);
  fence_async_smem();  // the right apply's writes before the copy engine reads them
  __syncthreads();
  SVDT_SPLIT(3);
  mid();

  // ---- left elimination ----
  const int cols = 2 * b;
  const int groups = kThreads / cols;
  const int nrm = BF ? NRM : (b + groups - 1) / groups;  // vg's entries a group
  if (warp == 0) {
    float x[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      x[t] = k < b ? (tau != 0.f ? col[k] : w.l0[k * w.ld]) : 0.f;
    }
    const float tau2 = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[1] = tau2;
    if constexpr (Rec) record(v, tau2, b, rl_.v, rl_.t);
    __syncwarp();
    for (int k = lane; k < b; k += 32) vg[(k % groups) * nrm + k / groups] = v[k];
  }
  __syncthreads();
  SVDT_SPLIT(4);
  const float tau2 = s_tau[1];
  wt.on(sc);
  SVDT_SPLIT(15);
  if (tau2 != 0.f) {
    // thread (g, c): column c, rows g, g + groups, ... in registers
    const int g = tid / cols;
    const int c = tid - g * cols;
    const bool live = g < groups;
    const int nr = BF ? NRM : (b - g + groups - 1) / groups;
    float* p = (c < b ? w.l0 + c : w.l1 + (c - b)) + g * w.ld;
    const int step = groups * w.ld;
    const float* vr = vg + g * nrm;
    float x[NRM];
    if (live) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NRM; ++j)
        if (j < nr) x[j] = p[j * step];
      if constexpr (BF != 0 && NRM % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NRM; j += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + j);
          s += v4.x * x[j];
          s += v4.y * x[j + 1];
          s += v4.z * x[j + 2];
          s += v4.w * x[j + 3];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NRM; ++j)
          if (j < nr) s += vr[j] * x[j];
      }
      part[g * cols + c] = s;
    }
    __syncthreads();
    SVDT_SPLIT(5);
    if (live) {
      const float f = tau2 * left_total(part, b, c);
      if constexpr (BF != 0 && NRM % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NRM; j += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + j);
          p[j * step] = rank1(x[j], f, v4.x);
          p[(j + 1) * step] = rank1(x[j + 1], f, v4.y);
          p[(j + 2) * step] = rank1(x[j + 2], f, v4.z);
          p[(j + 3) * step] = rank1(x[j + 3], f, v4.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NRM; ++j)
          if (j < nr) p[j * step] = rank1(x[j], f, vr[j]);
      }
    }
  }
  __syncthreads();
  SVDT_SPLIT(6);
}

// The copy engine starts a box at a 16-byte column: a b x b tile at column
// c travels in a box of b rows of b + 4 columns from c & ~3, the tile at
// column offset c & 3 of its slot.  A slot holds the box and one more row
// (the head pair's last window row), rounded up to 128 bytes.
__host__ __device__ constexpr int box_cols(int b) { return b + 4; }
__host__ __device__ constexpr int tile_floats(int b) {
  return ((b + 1) * box_cols(b) + 31) & ~31;
}

// Two boxes of one row band, `hi` starting b columns after `lo`, overlap in
// 4 columns of their first `rows` rows; the pair updated each entry in the
// box whose tile holds it.  Copy it into the other box, so both write back
// the same values.
__device__ __forceinline__ void share_overlap(float* lo, float* hi, int b,
                                              int delta, int rows) {
  const int ld = box_cols(b);
  for (int k = threadIdx.x; k < 4 * rows; k += kThreads) {
    const int j = k >> 2, o = k & 3;
    if (o < delta)
      hi[j * ld + o] = lo[j * ld + o + b];
    else
      lo[j * ld + o + b] = hi[j * ld + o];
  }
}

// The copy engine writes shared memory at 128-byte boundaries: the first
// such boundary of the dynamic shared memory (128 bytes more are asked for).
__device__ __forceinline__ float* align128(float* raw) {
  return raw + ((128u - (smem_u32(raw) & 127u)) & 127u) / 4u;
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of the h x w matrix whose entry (g, j) sits at A[ld g + j]
// (ld >= w: row-major rows of pitch ld; ld < w: the skewed band store of
// band_chase_staged.cu, rows overlapping in memory) with box (rows, cols):
// no swizzle, zero fill past the edges.  Returns a cudaError_t.
inline int encode_rect_map(CUtensorMap* map, float* A, int h, int w, int ld, int rows,
                           int cols) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, A, dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode_rect_map of the n x n matrix.
inline int encode_map(CUtensorMap* map, float* A, int n, int ld, int rows, int cols) {
  return encode_rect_map(map, A, n, n, ld, rows, cols);
}

// Whether the copy engine takes a band b at address A with row pitch ld
// (floats): 16-byte row strides and box rows, 4 <= b <= 128.
inline bool tma_takes(const float* A, int ld, int b) {
  return b >= 4 && b <= kSmemBand && b % 4 == 0 && ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

// ---- one pair of a shared-memory tick: the wavefront chase's
// (band_chase_wave.cu) and the pipelined chase's pass (band_chase_superstep.cu) ----

// The matrix a tick's pairs run on: a tensor map whose row g + off holds
// global row g (boxes of b rows of box_cols(b) columns, the map clipped at
// global row and column n, so reads past n give zero and writes there are
// dropped), and the same rows through A (global row g at A + (g + off) ld)
// for the head pair's last window row, which the threads copy.
struct TickMat {
  const CUtensorMap* map;
  float* A;
  size_t ld;
  int off, n;
  __device__ float* at(int g, int c) const { return A + (size_t)(g + off) * ld + c; }
};

// A CTA's shared memory on the tick: three tile slots of tile_floats(b)
// floats from `tiles` (128-byte aligned), an mbarrier a slot, and
// smem_pair's vectors.
struct TickSmem {
  float* tiles;
  uint64_t* bar;
  float *v, *vg, *col, *part, *s_tau;
};

// What a CTA keeps from one pair to its next: the phase of each slot's
// copies, the slot of the (r, c) tile, and the pair (i, s) whose (r, c)
// tile that slot holds (kept_i = -1: none).
struct TickLane {
  unsigned parity = 0;
  int cur = 0;
  int kept_i = -1, kept_s = -1;
};

// The slots' mbarriers, once a launch, before any copy.
__device__ __forceinline__ void tick_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(bar + k);
    fence_async();
  }
  __syncthreads();
}

// The head pair of sweep i: window rows [i, i + b] x columns [i + 1, i + 2b]
// as two b x b boxes by the copy engine, in slots 0 and 1, and row i + b by
// the threads after each box (so each slot is b + 1 rows of b).  Its stores
// are drained and fenced before it returns.
template <int KPL, int BF, bool Rec>
__device__ __forceinline__ void tick_head(const TickMat& m, int b, int i, const TickSmem& sm,
                                          TickLane& ln, Slot rr, Slot rl) {
  const int tsz = tile_floats(b);
  const int ldt = box_cols(b);
  const unsigned tile_bytes = 4u * b * ldt;
  const int n = m.n;
  Waits wt = {sm.bar, ln.parity, 0u};
  const int dl = (i + 1) & 3;
  const int a = i + 1 - dl;
  float* h0 = sm.tiles;
  float* h1 = sm.tiles + tsz;
  if (threadIdx.x == 0) {
    mbar_expect(sm.bar, 2 * tile_bytes);
    tma_load(h0, m.map, i + m.off, a, sm.bar);
    tma_load(h1, m.map, i + m.off, a + b, sm.bar);
  }
  const int hr = i + b;
  float* x0 = h0 + b * ldt + dl;  // row i + b, columns [i + 1, i + 1 + b)
  float* x1 = h1 + b * ldt + dl - b;
  for (int k = threadIdx.x; k < 2 * b; k += kThreads) {
    const int hc = i + 1 + k;
    (k < b ? x0 : x1)[k] = hr < n && hc < n ? __ldcg(m.at(hr, hc)) : 0.f;
  }
  const Win w = {h0 + dl, h0 + dl, h0 + dl + ldt, h1 + dl + ldt, ldt, b + 1, b + 1, 1};
  smem_pair<KPL, BF, Rec>(w, b, wt, 0, -1, -1, NoMid{}, sm.v, sm.vg, sm.col, sm.part,
                          sm.s_tau, rr, rl);
  share_overlap(h0, h1, b, dl, b);
  fence_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store(m.map, i + m.off, a, h0);
    tma_store(m.map, i + m.off, a + b, h1);
    tma_store_drain();
    fence_async();
  }
  for (int k = threadIdx.x; k < 2 * b; k += kThreads) {
    const int hc = i + 1 + k;
    if (hr < n && hc < n) __stcg(m.at(hr, hc), (k < b ? x0 : x1)[k]);
  }
  ln.parity ^= 1u;
  ln.kept_i = -1;  // the head's window took slots 0 and 1
}

// Chase pair (i, s) at corner (r, c), c < n: tiles (r, c), (r + b, c) and
// (r + b, c + b) in the CTA's three slots.  Tile (r, c) stays from the CTA's
// last pair where that pair kept it for (i, s); tile (r + b, c + b) stays in
// shared memory for the CTA's next pair, (i, s + 1), whose (r, c) tile it is,
// where `cout` (no other pair may touch it at either tick).  Tile (r, c) goes
// back once the right apply is done, the others after the left apply; the
// stores are drained and fenced before it returns.
template <int KPL, int BF, bool Rec>
__device__ __forceinline__ void tick_chase(const TickMat& m, int b, int i, int s, int r,
                                           int c, bool cout, const TickSmem& sm,
                                           TickLane& ln, Slot rr, Slot rl) {
  const int tsz = tile_floats(b);
  const int ldt = box_cols(b);
  const unsigned tile_bytes = 4u * b * ldt;
  Waits wt = {sm.bar, ln.parity, 0u};
  const int dl = c & 3;  // the tiles' column in their boxes
  const int a = c - dl;
  const int rm = r + m.off;  // the map's row of global row r
  const bool cin = ln.kept_i == i && ln.kept_s == s;
  const int s00 = ln.cur, s10 = (ln.cur + 1) % 3, s11 = (ln.cur + 2) % 3;
  float* t00 = sm.tiles + s00 * tsz;
  float* t10 = sm.tiles + s10 * tsz;
  float* t11 = sm.tiles + s11 * tsz;
  if (threadIdx.x == 0) {
    if (!cin) {
      mbar_expect(sm.bar + s00, tile_bytes);
      tma_load(t00, m.map, rm, a, sm.bar + s00);
    }
    mbar_expect(sm.bar + s10, tile_bytes);
    tma_load(t10, m.map, rm + b, a, sm.bar + s10);
    mbar_expect(sm.bar + s11, tile_bytes);
    tma_load(t11, m.map, rm + b, a + b, sm.bar + s11);
  }
  const Win w = {t00 + dl, t10 + dl, t10 + dl, t11 + dl, ldt, 2 * b, b, b};
  const auto store_rc = [&] {
    if (threadIdx.x == 0) tma_store(m.map, rm, a, t00);
  };
  smem_pair<KPL, BF, Rec>(w, b, wt, cin ? -1 : s00, s10, s11, store_rc, sm.v, sm.vg, sm.col,
                          sm.part, sm.s_tau, rr, rl);
  share_overlap(t10, t11, b, dl, b);
  fence_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store(m.map, rm + b, a, t10);
    if (!cout) tma_store(m.map, rm + b, a + b, t11);
    tma_store_drain();
    fence_async();
  }
  ln.parity ^= (cin ? 0u : 1u << s00) | 1u << s10 | 1u << s11;
  ln.kept_i = cout ? i : -1;
  ln.kept_s = s + 1;
  if (cout) ln.cur = s11;
}

// The dynamic shared memory of a CTA on the tick: the three tile slots and
// the 128 bytes align128 may skip.
inline size_t smem_tick_bytes(int b) { return sizeof(float) * 3 * (size_t)tile_floats(b) + 128; }

}  // namespace svdt
