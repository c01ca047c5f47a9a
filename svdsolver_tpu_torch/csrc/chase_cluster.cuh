// The wide elimination pair (b > kMaxBand) split over one thread-block
// cluster: chase_pair_cluster, the pair of band_chase_cluster.cu's two
// kernels (the sequential chase and the wavefront's cluster tick).
//
// It computes chase_pair_wide's entries with chase_pair_wide's operations
// in chase_pair_wide's order, so (d, e) and the records are those of the
// L2 kernel (band_chase.cu) bit for bit:
//  * reflectors: every CTA runs block_reflector on the same b entries (the
//    pivot row, then the pivot column) and holds the same v and tau; with
//    Rec, CTA 0 alone writes the record slot;
//  * right apply: the window's rows go to the CTAs in contiguous blocks
//    (cluster_share); in a CTA a warp takes a row and lane k sums columns
//    k, k + 32, ... in increasing order, then the warp butterfly, as
//    wide_apply_right (kWarpRows rows side by side, a chain each); the
//    CTA's rows are staged in shared memory first, so each is read from L2
//    once, not twice;
//  * left apply: the window's 2b columns go to the CTAs in contiguous
//    blocks; a thread takes a column and sums its b rows in order from the
//    CTA's b x cols slice in shared memory, as wide_apply_left; where the
//    plan finds the slice too large (ops/cuda/band_chase.wide_chase_plan)
//    the rows stream through the stage in chunks and the thread carries
//    its sum from chunk to chunk, so the order is the same; the update then
//    reads the chunks again;
//  * staging (stage_in): one bulk copy (TMA, cp.async.bulk) a row of the
//    row's 16-byte aligned span, completing on a stage mbarrier, so the
//    SM's L1 miss slots do not bound the load (plain loads, every thread's
//    16 in flight, were slower in the card runs that chose this: PERF.md);
//    the updates go out through L2 an entry a store (four-entry stores and
//    bulk stores of the rows were slower in the card runs that chose this);
//  * order: a cluster barrier after the right apply (the left reflector
//    reads column c0, which other CTAs just wrote) and one after the left
//    apply (the next pair's pivot row); generic accesses of the matrix go
//    through L2 only (__ldcg / __stcg), so no SM serves a stale L1 line,
//    and each bulk copy's issuing thread fences the proxies
//    (fence.proxy.async) before reading what generic stores wrote;
//  * CTA 0 owns the window's first row and first column, which every CTA
//    reads for the reflector: before its apply writes them, CTA 0 waits
//    until every CTA has read them (a "read" mbarrier in CTA 0, one
//    arrival a CTA after its reflector), under its own first staged load.
// The cluster barrier is two mbarriers a CTA (uses alternate, so no
// arrival of use k + 2 can land before use k completes): each CTA's
// threads 0 .. C - 1 arrive (release, cluster scope) on CTA 0 .. C - 1's
// barrier of the use, thread 0 waits (acquire) on its own.  The read
// barrier needs no second one: CTA 0 waits on use m before the cluster
// barrier that every arrival of use m + 1 follows.  A wait that spins
// ~10 s traps, so a broken handshake ends the launch with an error
// instead of holding the card.
//
// What bounds it on the H100: each CTA's share of a pair's window, 2b^2/C
// floats in and out on each side (128 KB each way at b = 512, C = 16),
// over one SM's L2 rate, plus the two reflectors (a row and a column read
// from L2, two block barriers each) and two cluster barriers a pair.  The
// column sums of the left apply are a chain of b dependent additions in
// each of the CTA's 2b/C threads.  Clock stamps of a pair:
// tools/chase_cluster_split.py --stamps.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chase_pair.cuh"
#include "grid_sync.cuh"

// A timing build's clock stamps (tools/chase_cluster_split.py): thread 0
// of every CTA stamps kStampMarks points of the pairs [first, first +
// count) of the run (a pair's index: its cluster barriers so far / 2);
// empty in the package's build.  Marks: 0 the pair's start, 1 the right
// reflector built, 2 the first right chunk staged, 3 the right apply done,
// 4 past the cluster barrier, 5 the left reflector built, 6 the first left
// chunk staged, 7 the column sums done, 8 the left apply done, 9 past the
// cluster barrier.
#ifdef SVDT_CLUSTER_STAMPS
__device__ long long* g_cluster_stamps;
__device__ int g_stamp_first, g_stamp_count;
constexpr int kStampMarks = 10;
#define SVDT_CSTAMP(cp, pair, mark)                                                   \
  if (threadIdx.x == 0 && (int)(pair) >= g_stamp_first &&                             \
      (int)(pair) < g_stamp_first + g_stamp_count)                                    \
    g_cluster_stamps[(((size_t)((pair) - g_stamp_first) * (cp).C + (cp).rank) *       \
                      kStampMarks) + (mark)] = clock64();
#else
#define SVDT_CSTAMP(cp, pair, mark)
#endif

namespace svdt {

// Rows a warp of the right apply sums side by side.
constexpr int kWarpRows = 4;
// Rows of a column sum whose loads go out together.
constexpr int kSumChunk = 16;

// The plan of the pair (ops/cuda/band_chase.wide_chase_plan): `cols`
// columns of the left apply a CTA at most (also the right apply's rows a
// CTA at most), `rchunk` rows of b floats and `lchunk` rows of `cols`
// floats a staged chunk, `stage` floats of stage.
struct WidePlan {
  int cols, rchunk, lchunk, stage;
};

// The floats before the stage in dynamic shared memory: v (b) and the
// left apply's factors (cols), each rounded up to 32 floats.
__host__ __device__ __forceinline__ int wide_head_floats(int b, int cols) {
  return ((b + 31) & ~31) + ((cols + 31) & ~31);
}

__device__ __forceinline__ unsigned cl_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One arrival (release, cluster scope) on the barrier at `addr` of this
// CTA's shared memory in CTA `rank`.
__device__ __forceinline__ void cl_arrive(unsigned addr, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// Wait (acquire, cluster scope) for the phase of parity `parity` of this
// CTA's barrier at `addr`; traps after kSpinTrap cycles.
__device__ __forceinline__ void cl_wait(unsigned addr, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
        "[%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinTrap) __trap();
  }
}

// The barriers of chase_pair_cluster (see the top of this file): `bar`
// three mbarriers of C arrivals in this CTA's static shared memory (the
// cluster barrier's two, then the read barrier, used in CTA 0 alone); `k`
// the cluster barrier's uses so far, `m` the read barrier's (the same in
// every thread of the cluster).
struct ClusterBarrier {
  unsigned long long* bar;
  int C;
  unsigned k, m, s;  // s: the stage barrier's uses (every thread of the CTA)

  __device__ void init() const {
    if (threadIdx.x < 4)  // bar[3]: this CTA's stage barrier, one arrival
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       cl_smem_addr(bar + threadIdx.x)),
                   "r"(threadIdx.x < 3 ? C : 1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Every thread of every CTA: a cluster barrier.
  __device__ void sync() {
    __syncthreads();
    const unsigned addr = cl_smem_addr(bar + (k & 1u));
    if ((int)threadIdx.x < C) cl_arrive(addr, (int)threadIdx.x);
    if (threadIdx.x == 0) cl_wait(addr, (k >> 1) & 1u);
    __syncthreads();
    ++k;
  }

  // Every thread of every CTA, after a reflector (its pivot entries read
  // and a block barrier since): this CTA's arrival on CTA 0's read barrier.
  __device__ void read_done() {
    if (threadIdx.x == 0) cl_arrive(cl_smem_addr(bar + 2), 0);
    ++m;
  }

  // CTA 0, before the block barrier that precedes its first write of the
  // window: every CTA has read the pivot entries.
  __device__ void read_wait() const {
    if (threadIdx.x == 0) cl_wait(cl_smem_addr(bar + 2), (m - 1) & 1u);
  }
};

// CTA q's block [lo, hi) of `count` items dealt to C CTAs in contiguous
// blocks of ceil(count / C) (ops/cuda/band_chase.cluster_share).
__device__ __forceinline__ void cluster_share(int count, int C, int q, int& lo, int& hi) {
  const int per = (count + C - 1) / C;
  lo = min(count, q * per);
  hi = min(count, lo + per);
}

// A staged tile's layout: row i (window row r + i) at S + i ls + off(i),
// off(i) the 16-byte offset of its first entry in A (A 16-byte aligned):
// (o0 + i nm) & 3, o0 = (r n + c) & 3, nm = n & 3.
struct Tile {
  float* S;
  int ls, o0, nm;
  __device__ __forceinline__ float* row(int i) const {
    return S + (size_t)i * ls + ((o0 + i * nm) & 3);
  }
};

// The row stride of a staged tile of w columns: the 16-byte aligned span
// of any row (at most w + 3 floats, rounded up to 4).
__host__ __device__ __forceinline__ int stage_ld(int w) { return (w + 6) & ~3; }

// Rows [r, r + nr) x columns [c, c + w) of A (n x n, 16-byte aligned) into
// the stage S.  The caller has just passed a block barrier, so no thread
// reads S any more.  One bulk copy (TMA, cp.async.bulk) a row of its
// 16-byte aligned span, each issuing thread announcing its bytes on the
// stage barrier (bar[3]), thread 0 arriving once every copy is out; the
// span's floats past A's end (the last row of an odd n) by plain loads.
// The issuing thread fences the proxies first: the generic stores of every
// CTA that the cluster barrier ordered before this copy are the matrix it
// reads.
__device__ __forceinline__ Tile stage_in(const float* A, int n, int r, int c, int nr, int w,
                                         float* S, ClusterBarrier& cb) {
  const Tile t = {S, stage_ld(w), (int)(((size_t)r * n + c) & 3), n & 3};
  const size_t total = (size_t)n * n;
  const unsigned bar = cl_smem_addr(cb.bar + 3);
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    const size_t e0 = (size_t)(r + i) * n + c;
    const size_t a0 = e0 & ~(size_t)3;
    const size_t end = (e0 + w + 3) & ~(size_t)3, last = total & ~(size_t)3;
    const size_t a1 = end < last ? end : last;
    float* dst = S + (size_t)i * t.ls;
    if (a1 > a0) {
      const unsigned bytes = 4u * (unsigned)(a1 - a0);
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(cl_smem_addr(dst)),
          "l"(A + a0), "r"(bytes), "r"(bar)
          : "memory");
    }
    for (size_t e = a1 > e0 ? a1 : e0; e < e0 + w; ++e) dst[e - a0] = __ldcg(A + e);
  }
  __syncthreads();  // every copy announced and issued
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
  cl_wait(bar, cb.s++ & 1u);  // every thread: the bytes have landed
  return t;
}

// One pair's shared state in a CTA of the cluster.
struct ClusterPair {
  float* A;
  int n;
  float* v;     // b floats
  float* fcol;  // the left apply's tau2 * column sums, cols floats
  float* S;     // the stage
  float* part;  // kWarps floats
  WidePlan p;
  int C, rank;
};

// The right reflector (v, tau) on this CTA's rows of [r0, r0 + wr) x
// columns [c0, c0 + b): wide_apply_right's sums and updates on the rows
// staged rchunk at a time.
__device__ void cluster_apply_right(const ClusterPair& cp, ClusterBarrier& cb, int b,
                                    int r0, int c0, int wr, float tau) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = cp.n;
  const int rows = min(wr, n - r0), cols = min(b, n - c0);
  int lo, hi;
  cluster_share(rows, cp.C, cp.rank, lo, hi);
  const float* v = cp.v;
  for (int x0 = lo; x0 < hi; x0 += cp.p.rchunk) {
    const int nr = min(cp.p.rchunk, hi - x0);
    const Tile t = stage_in(cp.A, n, r0 + x0, c0, nr, cols, cp.S, cb);
    if (cp.rank == 0 && x0 == lo) cb.read_wait();  // row r0 is CTA 0's
    __syncthreads();
    if (x0 == lo) SVDT_CSTAMP(cp, cb.k / 2, 2);
    // a warp's rows i0 + kWarps q, q < kWarpRows, summed side by side (one
    // chain each)
    for (int i0 = warp; i0 < nr; i0 += kWarps * kWarpRows) {
      float s[kWarpRows];
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) s[q] = 0.f;
      for (int k0 = lane; k0 < cols; k0 += 32 * kWideChunk) {
        float x[kWarpRows][kWideChunk], vk[kWideChunk];
#pragma unroll
        for (int u = 0; u < kWideChunk; ++u) {
          const int k = k0 + 32 * u;
          vk[u] = k < cols ? v[k] : 0.f;
#pragma unroll
          for (int q = 0; q < kWarpRows; ++q)
            x[q][u] = k < cols && i0 + kWarps * q < nr ? t.row(i0 + kWarps * q)[k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kWideChunk; ++u)
          if (k0 + 32 * u < cols)
#pragma unroll
            for (int q = 0; q < kWarpRows; ++q)
              s[q] = __fadd_rn(s[q], __fmul_rn(x[q][u], vk[u]));
      }
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) {
        const int i = i0 + kWarps * q;
        const float f = __fmul_rn(tau, warp_sum(s[q]));
        if (i >= nr) continue;
        const float* row = t.row(i);
        float* out = cp.A + (size_t)(r0 + x0 + i) * n + c0;
        for (int k = lane; k < cols; k += 32)
          __stcg(out + k, __fsub_rn(row[k], __fmul_rn(f, v[k])));
      }
    }
    __syncthreads();  // the stage is free again
  }
}

// The left reflector (v, tau2) on rows [rl, rl + b) x this CTA's columns
// of [c0, c0 + 2b): wide_apply_left's column sums (a thread a column, its
// rows in order, across chunks) and updates.
__device__ void cluster_apply_left(const ClusterPair& cp, ClusterBarrier& cb, int b,
                                   int rl, int c0, float tau2) {
  const int tid = threadIdx.x;
  const int n = cp.n;
  const int rows = min(b, n - rl), cols = min(2 * b, n - c0);
  int lo, hi;
  cluster_share(cols, cp.C, cp.rank, lo, hi);
  const int w = hi - lo;
  if (w <= 0) return;
  const int R = cp.p.lchunk;
  const float* v = cp.v;
  float s = 0.f;
  for (int x0 = 0; x0 < rows; x0 += R) {
    const int nr = min(R, rows - x0);
    const Tile t = stage_in(cp.A, n, rl + x0, c0 + lo, nr, w, cp.S, cb);
    if (cp.rank == 0 && x0 == 0) cb.read_wait();  // column c0 is CTA 0's
    __syncthreads();
    if (x0 == 0) SVDT_CSTAMP(cp, (cb.k - 1) / 2, 6);
    if (tid < w) {  // the chain of the column's sum, its loads kSumChunk ahead
      const float* vv = v + x0;
      int i = 0;
#pragma unroll 2
      for (; i + kSumChunk <= nr; i += kSumChunk) {
        float x[kSumChunk], vi[kSumChunk];
#pragma unroll
        for (int u = 0; u < kSumChunk; ++u) {
          x[u] = t.row(i + u)[tid];
          vi[u] = vv[i + u];
        }
#pragma unroll
        for (int u = 0; u < kSumChunk; ++u) s = __fadd_rn(s, __fmul_rn(vi[u], x[u]));
      }
      for (; i < nr; ++i) s = __fadd_rn(s, __fmul_rn(vv[i], t.row(i)[tid]));
    }
    if (x0 + R < rows) __syncthreads();  // the stage is read again
  }
  if (tid < w) cp.fcol[tid] = __fmul_rn(tau2, s);
  __syncthreads();  // the factors are in; every sum has read the stage
  SVDT_CSTAMP(cp, (cb.k - 1) / 2, 7);
  const bool whole = R >= rows;  // the one chunk is still in the stage
  for (int x0 = 0; x0 < rows; x0 += R) {
    const int nr = min(R, rows - x0);
    const Tile t = whole ? Tile{cp.S, stage_ld(w), (int)(((size_t)rl * n + c0 + lo) & 3), n & 3}
                         : stage_in(cp.A, n, rl + x0, c0 + lo, nr, w, cp.S, cb);
    const int total = nr * w;
    const int di = kThreads / w, dc = kThreads - di * w;
    int i = tid / w, j = tid - i * w;
    for (int idx = tid; idx < total; idx += kThreads) {
      __stcg(cp.A + (size_t)(rl + x0 + i) * n + c0 + lo + j,
             __fsub_rn(t.row(i)[j], __fmul_rn(cp.fcol[j], v[x0 + i])));
      j += dc;
      i += di;
      if (j >= w) {
        j -= w;
        ++i;
      }
    }
    if (!whole) __syncthreads();  // the stage is free again
  }
}

// Every CTA: the reflector of column or row entries load(k), k < b, into
// v, as chase_pair_wide builds it (block_reflector); with Rec CTA 0 stores
// it into slot `s`.
template <bool Rec, class Load>
__device__ __forceinline__ float cluster_reflector(const ClusterPair& cp, Load load, int b,
                                                   Slot s) {
  const float tau = block_reflector(load, b, cp.v, cp.part);
  if constexpr (Rec)
    if (cp.rank == 0) block_record(cp.v, tau, b, s);
  return tau;
}

// chase_pair_wide on the cluster: the window with corner (r0, c0), right
// reflector from row r0 over [r0, r0 + wr), left from column c0 over rows
// [r0 + lr0, r0 + lr0 + b); with Rec into slots rr and rl_.  Every CTA of
// the cluster calls it with the same arguments; it ends with a cluster
// barrier (none where the window lies past n).
template <bool Rec>
__device__ void chase_pair_cluster(const ClusterPair& cp, ClusterBarrier& cb, int b, int r0,
                                   int c0, int wr, int lr0, Slot rr, Slot rl_) {
  const int n = cp.n;
  if (c0 >= n) return;  // all-zero window: both reflectors are the identity
  const float* A = cp.A;
  const size_t ld = (size_t)n;
  SVDT_CSTAMP(cp, cb.k / 2, 0);
  const float tau = cluster_reflector<Rec>(
      cp, [&](int k) { return c0 + k < n ? __ldcg(A + r0 * ld + c0 + k) : 0.f; }, b, rr);
  SVDT_CSTAMP(cp, cb.k / 2, 1);
  cb.read_done();
  if (tau != 0.f)
    cluster_apply_right(cp, cb, b, r0, c0, wr, tau);
  else if (cp.rank == 0)
    cb.read_wait();
#ifdef SVDT_CLUSTER_STAMPS
  __syncthreads();
#endif
  SVDT_CSTAMP(cp, cb.k / 2, 3);
  cb.sync();
  SVDT_CSTAMP(cp, (cb.k - 1) / 2, 4);
  const int rl = r0 + lr0;
  const float tau2 = cluster_reflector<Rec>(
      cp, [&](int k) { return rl + k < n ? __ldcg(A + (rl + k) * ld + c0) : 0.f; }, b, rl_);
  SVDT_CSTAMP(cp, (cb.k - 1) / 2, 5);
  cb.read_done();
  if (tau2 != 0.f)
    cluster_apply_left(cp, cb, b, rl, c0, tau2);
  else if (cp.rank == 0)
    cb.read_wait();
#ifdef SVDT_CLUSTER_STAMPS
  __syncthreads();
#endif
  SVDT_CSTAMP(cp, (cb.k - 1) / 2, 8);
  cb.sync();
  SVDT_CSTAMP(cp, (cb.k - 2) / 2, 9);
}

}  // namespace svdt
