// The blocked K1's products between sub-panels (b > 256), one launch each.
//
// Replaces: svdsolver_tpu/ops/pallas/panel_qr.py, _panel_kernel (launched by
// _panel_qr_pallas): the trailing update and the larft work of its column
// loop, where the host blocks a panel past b = 256 into sub-panels of 64
// rows of Pt (ops/cuda/panel_qr.py, panel_qr_blocked).  After sub-panel
// [r0, r1) (k = r1 - r0 reflectors V_k, pivots from p0, T_k = Tt_kk^T):
//
//   panel_update   G = [Vt_{0:r0}; W_{r1:b}] V_k^T over the columns [p0, m);
//                  its rows [0, r0) to `above` (the merge's input); then
//                  W_{r1:b} -= (G_{r1:b} T_k) V_k in place;
//   panel_merge    Tt_{k,0:r0} = -Tt_kk (G_{0:r0}^T Tt_{0:r0,0:r0}).
//
// The first design (panel_qr.cu: panel_gemm, panel_sum) took four
// launches for the update (the Gram split over K into a scratch, the split
// sum, Z = G T_k, the update) and two for the merge, and read W's rows from
// device memory twice.  It stays as the bitwise oracle: these kernels give
// its bits at the same split count S, sum for sum.
//
// What bounds them on the H100: fp32 FMAs (no fp32 tensor-core mode on
// Hopper, and the repo keeps full fp32 with TF32 off), 67 TFLOP/s; the
// update's 2 (r0 + b - r1) k K + 2 (b - r1) k K operations against reading
// V and W once and writing W once.  At (512, 2048) a sub-panel's update is
// ~0.24 GFLOP, 3.6 us at the card's rate and a few us of one SM's rate
// (0.51 TFLOP/s) once spread over 7 x 16 CTAs; so the design aims at one
// launch with every SM busy and no round trip through device memory.
//
// panel_update.  One thread-block cluster for each 64-row block of the
// Gram's rows (r0 is a multiple of 64, so a block holds only V rows or only
// W rows), one CTA of the cluster for each of the S splits of [p0, m)
// (chunk = ceil(K / S) columns, as the first design splits K).  A CTA:
//   1. copies its columns of the block's 64 rows, and of V_k's rows, into
//      shared memory by the copy engine: boxes of kBox columns from its
//      first column rounded down to 16 bytes, an mbarrier a box pair (rows
//      past b, or past r1 for V_k, read as zero);
//   2. forms its 64 x k partial Gram from shared memory, each thread a 4 x 4
//      register tile, columns ascending within the split (panel_gemm's
//      order); keeps it in shared memory; cluster barrier;
//   3. sums its share of the block's rows (whole quads of rows) over the S
//      partials through distributed shared memory, 16 bytes a load, in
//      split order (panel_sum's s = p_0; s += p_z);
//   4. a V-row block writes its Gram rows to `above` and is done; a W-row
//      block forms Z = G T_k for its share of rows (c ascending), stores
//      them into every CTA of the cluster (16 bytes a store; 4-byte
//      accesses took twice as long), cluster barrier, then updates its
//      columns from shared memory, W - Z V_k (c ascending, fmaf(1, W, -acc):
//      the bits of beta = 1, alpha = -1), and stores them.
// W's rows cross device memory once each way; the split scratch and Z stay
// on chip.  A box starts on a 16-byte column, so its edges hold a few
// columns of the neighbouring splits: the Gram reads only the split's own
// columns, and the CTA stores only its own (plain 16-byte stores: a box
// store would write a neighbour's columns).  Where the boxes of both slices
// do not fit (past ~280 columns a CTA) the boxes stream through `stages`
// slots in rounds, and the update reads W's and V_k's boxes again (the
// spill instance; a box read again may hold a neighbour's columns already
// updated, but only where this CTA computes and does not store).  Where
// the copy engine cannot take the panel (a row stride that is not a
// multiple of 16 bytes, or a base off 16 bytes) the boxes come by
// cp.async, 4 bytes each, onto the same mbarriers; the arithmetic is the
// same.
//
// panel_merge.  One CTA for each 16-column block of Tt_{k,0:r0} (r0 / 16
// CTAs, so the longest sum, the first block's r0 terms, is spread over no
// more than 16 columns): Y's block, G^T Tt_{0:r0,block}, r0 ascending, G's
// and Tt's rows through shared memory 64 at a time (cp.async, two stages;
// the zero triangle of Tt_{0:r0,0:r0}, rows above the block, is skipped:
// adding a zero product leaves every sum unchanged); Y stays in shared
// memory; then -Tt_kk Y (c ascending).  It runs on the blocked panel's
// second stream, under the next sub-panel.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "chase_tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;      // rows of a Gram block and of a sub-panel
constexpr int kBox = 36;       // box columns: = 4 (mod 8), so 8 float4 rows fall on
                               // distinct bank groups
constexpr int kBoxFloats = kRows * kBox;
constexpr int kUThreads = 256;  // 16 x 16 threads, a 4 x 4 register tile each
constexpr int kLdP = 65;        // row stride of T_k (and of the merge's T_kk)
constexpr int kLd4 = 68;        // row stride of the partial Gram, G and Z^T (16-byte rows)
constexpr int kMaxStages = 16;
constexpr int kMaxCluster = 16;
constexpr int kMergeCols = 16;  // columns of T's block row a merge CTA
constexpr int kChunk = 64;      // rows of G and of Tt a merge stage
// shared memory beside the boxes: P, G, Z^T (64 x kLd4 each), T_k, and the
// 128 bytes the boxes' alignment may take
constexpr int kFixedBytes = 4 * (3 * kRows * kLd4 + kRows * kLdP) + 128;
constexpr int kMaxDynSmem = 227 * 1024 - 1024;

// tools/products_split.py builds with SVDT_PRODUCT_STAMPS: thread 0 of
// every CTA of panel_update writes, at the end of each phase i, clock64()
// to stamps[16 cta + i] and %globaltimer (ns) to stamps[16 cta + 8 + i]
// (cta = blockIdx.y gridDim.x + blockIdx.x).
#ifdef SVDT_PRODUCT_STAMPS
__device__ long long* g_stamps;
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SVDT_STAMP(i)                                                          \
  if (threadIdx.x == 0) {                                                      \
    long long* st = g_stamps + 16 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x); \
    st[i] = clock64();                                                         \
    st[8 + (i)] = globaltimer();                                               \
  }
#else
#define SVDT_STAMP(i)
#endif

struct UpdateArgs {
  float* W;          // (b, m): rows [r1, b) updated in place
  const float* Vt;   // (b, m): rows [0, r1) written
  const float* Tt;   // (b, b): T_k^T at (r0, r0)
  float* above;      // r0 x k: the Gram's V rows
  int b, m, r0, r1, p0, chunk, stages, nv, tma;
};

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(svdt::smem_u32(bar)),
               "r"(count) : "memory");
}

// 4 bytes from src into shared memory at dst, zero where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(svdt::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// This thread's cp.async groups but the newest N have landed.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(svdt::smem_u32(bar)) : "memory");
}

// A box of 64 rows x kBox columns from row-major src (row pitch m) by
// cp.async: rows from row0 below lim, columns from col0 below m.
__device__ void copy_box(float* dst, const float* src, int row0, int lim, int col0, int m) {
  for (int idx = threadIdx.x; idx < kBoxFloats; idx += kUThreads) {
    const int r = idx / kBox, c = idx - r * kBox;
    const int row = row0 + r, col = col0 + c;
    const bool valid = row < lim && col < m;
    cp_async4(dst + idx, valid ? src + (size_t)row * m + col : src, valid);
  }
}

// Columns [lo, hi) of one box pair into the partial Gram, ascending: thread
// (ig, cg) holds rows ig + 16 r of the block against V_k rows cg + 16 q.
__device__ __forceinline__ void gram_col(const float* xb, const float* vb, int c, int ig,
                                         int cg, float (&acc)[4][4]) {
  float x[4], v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) x[r] = xb[(ig + 16 * r) * kBox + c];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = vb[(cg + 16 * q) * kBox + c];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(x[r], v[q], acc[r][q]);
}

__device__ void gram_box(const float* xb, const float* vb, int lo, int hi, int ig, int cg,
                         float (&acc)[4][4]) {
  int c = lo;
  for (const int head = min(hi, (lo + 3) & ~3); c < head; ++c) gram_col(xb, vb, c, ig, cg, acc);
#pragma unroll 2
  for (; c + 4 <= hi; c += 4) {
    float4 x[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const float4*>(xb + (ig + 16 * r) * kBox + c);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = *reinterpret_cast<const float4*>(vb + (cg + 16 * q) * kBox + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][q] = fmaf(x[r].x, v[q].x, acc[r][q]);
        acc[r][q] = fmaf(x[r].y, v[q].y, acc[r][q]);
        acc[r][q] = fmaf(x[r].z, v[q].z, acc[r][q]);
        acc[r][q] = fmaf(x[r].w, v[q].w, acc[r][q]);
      }
  }
  for (; c < hi; ++c) gram_col(xb, vb, c, ig, cg, acc);
}

__global__ void __launch_bounds__(kUThreads, 1)
panel_update(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap mv,
             UpdateArgs a) {
  SVDT_STAMP(0)
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float raw[];
  __shared__ uint64_t bar[kMaxStages];
  float* boxes = svdt::align128(raw);
  float* P = boxes + a.stages * 2 * kBoxFloats;
  float* Gs = P + kRows * kLd4;
  float* Zt = Gs + kRows * kLd4;  // Zt[c kLd4 + i] = Z(i, c)
  float* Ts = Zt + kRows * kLd4;
  const int tid = threadIdx.x;
  const int S = (int)cluster.num_blocks();
  const int z = (int)cluster.block_rank();
  const bool vrows = (int)blockIdx.y < a.nv;
  const int row0 = vrows ? blockIdx.y * kRows : a.r1 + (blockIdx.y - a.nv) * kRows;
  const int k = a.r1 - a.r0;
  const int K = a.m - a.p0;
  const int s = a.p0 + min(K, z * a.chunk), e = a.p0 + min(K, (z + 1) * a.chunk);
  const int s4 = s & ~3;
  const int nq = e > s ? (((e + 3) & ~3) - s4) / 4 : 0;  // quads of the CTA's boxes
  const int nbx = (4 * nq + kBox - 1) / kBox;
  const int rounds = (nbx + a.stages - 1) / a.stages;
  const CUtensorMap* xmap = vrows ? &mv : &mw;
  const float* xsrc = vrows ? a.Vt : a.W;
  const int xlim = vrows ? a.r0 : a.b;

  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) mbar_init_count(&bar[st], a.tma ? 1u : kUThreads);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the boxes of round R into the slots, box bx into slot bx - R stages
  auto issue = [&](int R) {
    for (int bx = R * a.stages; bx < min(nbx, (R + 1) * a.stages); ++bx) {
      float* xb = boxes + (bx - R * a.stages) * 2 * kBoxFloats;
      uint64_t* slot = &bar[bx - R * a.stages];
      const int col = s4 + bx * kBox;
      if (a.tma) {
        if (tid == 0) {
          svdt::mbar_expect(slot, 2 * kBoxFloats * 4);
          svdt::tma_load(xb, xmap, row0, col, slot);
          svdt::tma_load(xb + kBoxFloats, &mv, a.r0, col, slot);
        }
      } else {
        copy_box(xb, xsrc, row0, xlim, col, a.m);
        copy_box(xb + kBoxFloats, a.Vt, a.r0, a.r1, col, a.m);
        cp_async_arrive(slot);
      }
    }
  };
  unsigned phase = 0;  // bit st: the parity of slot st's next completion
  auto wait_round = [&](int R) {
    for (int st = 0; st < min(nbx - R * a.stages, a.stages); ++st) {
      svdt::mbar_wait(&bar[st], phase >> st & 1u);
      phase ^= 1u << st;
    }
  };
  if (rounds > 0) issue(0);
  if (!vrows) {  // T_k, transposed, by cp.async: Ts[c][j] = T_k(c, j) = Tt[r0 + j][r0 + c]
    for (int idx = tid; idx < kRows * kRows; idx += kUThreads) {
      const int j = idx >> 6, c = idx & 63;
      const bool in = j < k && c < k;
      cp_async4(Ts + c * kLdP + j, in ? a.Tt + (size_t)(a.r0 + j) * a.b + a.r0 + c : a.Tt, in);
    }
    cp_commit();
  }
  SVDT_STAMP(1)

  // 2. the partial Gram over the split's own columns [s, e), ascending
  const int ig = tid >> 4, cg = tid & 15;
  float acc[4][4] = {};
  for (int R = 0; R < rounds; ++R) {
    if (R > 0) {  // the spill instance: the next round into the slots
      __syncthreads();
      issue(R);
    }
    for (int bx = R * a.stages; bx < min(nbx, (R + 1) * a.stages); ++bx) {
      const int st = bx - R * a.stages;
      svdt::mbar_wait(&bar[st], phase >> st & 1u);
      phase ^= 1u << st;
      const int c0 = s4 + bx * kBox;
      const float* xb = boxes + st * 2 * kBoxFloats;
      gram_box(xb, xb + kBoxFloats, max(s, c0) - c0, min(e, c0 + kBox) - c0, ig, cg, acc);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) P[(ig + 16 * r) * kLd4 + cg + 16 * q] = acc[r][q];
  if (rounds > 1 && !vrows) {  // the update reads the boxes again from round 0
    __syncthreads();
    issue(0);
  }
  SVDT_STAMP(2)
  cluster.sync();
  SVDT_STAMP(3)

  // 3. rows [lo, hi) of the block's Gram (whole quads of rows): the S
  // partials in split order, 16 bytes a distributed shared memory load,
  // every partial's load issued before the first add
  const int hs = 4 * ((kRows / 4 + S - 1) / S);
  const int lo = min(kRows, z * hs), hi = min(kRows, lo + hs);
  const int kq = (k + 3) / 4;  // quads of the Gram's columns
  for (int idx = tid; idx < (hi - lo) * kq; idx += kUThreads) {
    const int i = lo + idx / kq, c = 4 * (idx - (i - lo) * kq);
    float* p = P + i * kLd4 + c;
    float4 part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < S ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, q))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 sum = part[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < S) {
        sum.x += part[q].x;
        sum.y += part[q].y;
        sum.z += part[q].z;
        sum.w += part[q].w;
      }
    if (vrows) {
      float* dst = a.above + (size_t)(row0 + i) * k + c;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < k) dst[e] = v[e];
    } else {
      *reinterpret_cast<float4*>(Gs + i * kLd4 + c) = sum;
    }
  }
  SVDT_STAMP(4)
  if (vrows) {
    cluster.sync();  // no CTA leaves while another reads its partial
    SVDT_STAMP(5)
    return;
  }

  // 4. Z = G T_k on this CTA's rows, four rows a thread, stored into every
  // CTA's Z^T 16 bytes at a time; after the barrier each CTA holds the
  // block's Z and no CTA touches another's shared memory again
  cp_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < (hi - lo) / 4 * kRows; idx += kUThreads) {
    const int i = lo + 4 * (idx >> 6), j = idx & 63;
    if (j >= k) continue;
    float zz[4] = {};
    for (int c = 0; c < k; ++c) {
      const float t = Ts[c * kLdP + j];
#pragma unroll
      for (int r = 0; r < 4; ++r) zz[r] = fmaf(Gs[(i + r) * kLd4 + c], t, zz[r]);
    }
    const float4 v = make_float4(zz[0], zz[1], zz[2], zz[3]);
    for (int q = 0; q < S; ++q)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(Zt + j * kLd4 + i, q)) = v;
  }
  cluster.sync();
  SVDT_STAMP(5)

  // the update of the CTA's own columns: W - Z V_k, c ascending; thread
  // item (rg, quad): rows 4 rg .. 4 rg + 3 of the block, 4 columns
  const bool vec = a.tma;  // 16-byte rows at a 16-byte base
  for (int R = 0; R < rounds; ++R) {
    if (rounds > 1) {
      if (R > 0) {
        __syncthreads();
        issue(R);
      }
      wait_round(R);
    }
    const int q0 = R * a.stages * kBox / 4;
    const int q1 = min(nq, (R + 1) * a.stages * kBox / 4);
    for (int idx = tid; idx < 16 * (q1 - q0); idx += kUThreads) {
      const int rg = idx & 15, gq = q0 + (idx >> 4);
      const int bx = 4 * gq / kBox, cb = 4 * gq - bx * kBox;
      const float* xb = boxes + (bx - R * a.stages) * 2 * kBoxFloats;
      const float* vb = xb + kBoxFloats;
      float u[4][4] = {};
#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        const float4 zz = *reinterpret_cast<const float4*>(Zt + c * kLd4 + 4 * rg);
        const float4 vv = *reinterpret_cast<const float4*>(vb + c * kBox + cb);
        const float zr[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u[r][0] = fmaf(zr[r], vv.x, u[r][0]);
          u[r][1] = fmaf(zr[r], vv.y, u[r][1]);
          u[r][2] = fmaf(zr[r], vv.z, u[r][2]);
          u[r][3] = fmaf(zr[r], vv.w, u[r][3]);
        }
      }
      const int col = s4 + 4 * gq;
      const bool whole = vec && col >= s && col + 4 <= e;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 4 * rg + r;
        if (row >= a.b) break;
        const float4 w = *reinterpret_cast<const float4*>(xb + (4 * rg + r) * kBox + cb);
        const float out[4] = {fmaf(1.f, w.x, -u[r][0]), fmaf(1.f, w.y, -u[r][1]),
                              fmaf(1.f, w.z, -u[r][2]), fmaf(1.f, w.w, -u[r][3])};
        float* dst = a.W + (size_t)row * a.m + col;
        if (whole) {
          *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q >= s && col + q < e) dst[q] = out[q];
        }
      }
    }
  }
  SVDT_STAMP(6)
}

// T's block row of the sub-panel: CTA x takes columns [16 x, 16 x + 16) of
// Tt_{k,0:r0}.  G(c, i) at G[c k + i] (the update's `above`).  Y's rows c
// come through shared memory 64 at a time by cp.async, double-buffered.
__global__ void __launch_bounds__(kUThreads)
panel_merge(const float* __restrict__ G, float* __restrict__ Tt, int b, int r0, int k) {
  __shared__ float Gs[2][kChunk][kRows];                      // G(c, i); then T_kk (i, c)
  __shared__ __align__(16) float Ts[2][kChunk][kMergeCols];  // Tt(c, j); then Y (c, j)
  const int tid = threadIdx.x, ti = tid & 63, tj = tid >> 6;  // Y(ti, j0 + 4 tj + q)
  const int j0 = blockIdx.x * kMergeCols;
  const int chunks = (r0 - j0 + kChunk - 1) / kChunk;  // Tt(c, j) = 0 for c < j0 <= j
  auto load = [&](int t) {
    const int c0 = j0 + t * kChunk, nc = min(kChunk, r0 - c0);
    float(*gs)[kRows] = Gs[t & 1];
    float(*ts)[kMergeCols] = Ts[t & 1];
    for (int idx = tid; idx < nc * k; idx += kUThreads) {
      const int cc = idx / k, x = idx - cc * k;
      cp_async4(&gs[cc][x], G + (size_t)c0 * k + idx, true);
    }
    for (int idx = tid; idx < nc * kMergeCols; idx += kUThreads) {
      const int cc = idx / kMergeCols, x = idx - cc * kMergeCols;
      cp_async4(&ts[cc][x], Tt + (size_t)(c0 + cc) * b + j0 + x, true);
    }
    cp_commit();
  };
  float acc[4] = {};
  load(0);
  for (int t = 0; t < chunks; ++t) {
    if (t + 1 < chunks) {
      load(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int nc = min(kChunk, r0 - j0 - t * kChunk);
    float(*gs)[kRows] = Gs[t & 1];
    float(*ts)[kMergeCols] = Ts[t & 1];
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc) {
      const float g = gs[cc][ti];
      const float4 v = *reinterpret_cast<const float4*>(&ts[cc][4 * tj]);
      acc[0] = fmaf(g, v.x, acc[0]);
      acc[1] = fmaf(g, v.y, acc[1]);
      acc[2] = fmaf(g, v.z, acc[2]);
      acc[3] = fmaf(g, v.w, acc[3]);
    }
    __syncthreads();
  }
  float* Ys = &Ts[0][0][0];   // Y (c, j), 64 x kMergeCols
  float* Tk = &Gs[0][0][0];   // T_kk (i, c), row stride kLdP
  *reinterpret_cast<float4*>(Ys + ti * kMergeCols + 4 * tj) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  for (int idx = tid; idx < kRows * kRows; idx += kUThreads) {
    const int i = idx >> 6, c = idx & 63;
    Tk[i * kLdP + c] = i < k && c < k ? Tt[(size_t)(r0 + i) * b + r0 + c] : 0.f;
  }
  __syncthreads();
  float out[4] = {};
  for (int c = 0; c < k; ++c) {
    const float t = Tk[ti * kLdP + c];
    const float4 y = *reinterpret_cast<const float4*>(Ys + c * kMergeCols + 4 * tj);
    out[0] = fmaf(t, y.x, out[0]);
    out[1] = fmaf(t, y.y, out[1]);
    out[2] = fmaf(t, y.z, out[2]);
    out[3] = fmaf(t, y.w, out[3]);
  }
  if (ti < k) {
    float* dst = Tt + (size_t)(r0 + ti) * b + j0 + 4 * tj;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = -out[q];
  }
}

// The tensor maps of W and Vt (b x m, boxes of 64 x kBox), encoded once a
// panel: kept until the next call names other matrices.
struct Maps {
  alignas(64) CUtensorMap w;
  alignas(64) CUtensorMap v;
  const float* W = nullptr;
  const float* V = nullptr;
  int b = 0, m = 0, dev = -1;
};

int panel_maps(float* W, const float* Vt, int b, int m, int dev, Maps** out) {
  static Maps maps;
  if (maps.W != W || maps.V != Vt || maps.b != b || maps.m != m || maps.dev != dev) {
    maps.W = nullptr;
    int err = svdt::encode_rect_map(&maps.w, W, b, m, m, kRows, kBox);
    if (err == 0) err = svdt::encode_rect_map(&maps.v, const_cast<float*>(Vt), b, m, m, kRows, kBox);
    if (err != 0) return err;
    maps.W = W;
    maps.V = Vt;
    maps.b = b;
    maps.m = m;
    maps.dev = dev;
  }
  *out = &maps;
  return 0;
}

void configure(int S, int smem, int rows, cudaStream_t stream, cudaLaunchConfig_t* cfg,
               cudaLaunchAttribute* attr) {
  *cfg = {};
  cfg->gridDim = dim3(S, rows);
  cfg->blockDim = dim3(kUThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The kernel's attributes set, and whether a cluster of S CTAs at the
// largest shared memory fits the card, asked once a device and S.
int ready(int dev, int S) {
  constexpr int kDevs = 16;
  static int known[kDevs][kMaxCluster + 1] = {};  // 0 unknown, 1 fits, -1 does not
  if (dev < 0 || dev >= kDevs) return (int)cudaErrorInvalidDevice;
  if (known[dev][S] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        panel_update, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(panel_update,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    configure(S, kMaxDynSmem, 1, 0, &cfg, &attr);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, panel_update, &cfg);
    if (err != cudaSuccess) return (int)err;
    known[dev][S] = clusters > 0 ? 1 : -1;
  }
  return known[dev][S] > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace

#ifdef SVDT_PRODUCT_STAMPS
// Where panel_update writes its stamps (16 long longs a CTA).
extern "C" int svdt_panel_update_stamps(long long* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#endif

// Sub-panel [r0, r1)'s update on `stream` (see panel_update): the Gram in S
// splits of `chunk` columns from p0, its V rows to `above`, W's rows [r1, b)
// updated; `stages` box slots a CTA and `smem` bytes of dynamic shared
// memory (ops/cuda/panel_qr.update_plan); tma: the copy engine loads the
// boxes (m % 4 == 0, 16-byte aligned W and Vt), else cp.async.  Returns the
// launch's cudaError_t (cudaErrorInvalidConfiguration where the card cannot
// hold a cluster of S CTAs).
extern "C" int svdt_panel_update(float* W, const float* Vt, const float* Tt, float* above,
                                 int b, int m, int r0, int r1, int p0, int S, int chunk,
                                 int stages, int smem, int tma, void* stream) {
  const int k = r1 - r0;
  if (S < 1 || S > kMaxCluster || stages < 1 || stages > kMaxStages || r0 < 0 ||
      r0 % kRows != 0 || k < 1 || k > kRows || r1 > b || p0 < 0 || p0 >= m || chunk < 1 ||
      (long long)chunk * S < m - p0 || smem > kMaxDynSmem ||
      smem < kFixedBytes + stages * 2 * kBoxFloats * 4)
    return (int)cudaErrorInvalidValue;
  const int nv = r0 / kRows, rows = nv + (b - r1 + kRows - 1) / kRows;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int err = ready(dev, S);
  if (err != 0) return err;
  static Maps none{};
  Maps* maps = &none;
  if (tma) {
    err = panel_maps(W, Vt, b, m, dev, &maps);
    if (err != 0) return err;
  }
  const UpdateArgs args = {W, Vt, Tt, above, b, m, r0, r1, p0, chunk, stages, nv, tma};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(S, smem, rows, (cudaStream_t)stream, &cfg, &attr);
  e = cudaLaunchKernelEx(&cfg, panel_update, maps->w, maps->v, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Sub-panel [r0, r0 + k)'s block row of T on `stream` (see panel_merge),
// from the Gram's V rows G (r0 x k, row-major); returns the launch's
// cudaError_t.
extern "C" int svdt_panel_merge(const float* G, float* Tt, int b, int r0, int k,
                                void* stream) {
  if (r0 < kRows || r0 % kRows != 0 || k < 1 || k > kRows || r0 + k > b)
    return (int)cudaErrorInvalidValue;
  panel_merge<<<r0 / kMergeCols, kUThreads, 0, (cudaStream_t)stream>>>(G, Tt, b, r0, k);
  return (int)cudaGetLastError();
}
