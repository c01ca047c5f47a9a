// One elimination pair of the band -> bidiagonal bulge chase, shared by every
// chase kernel of the package: band_chase.cu (dense matrix, plain and
// recording), band_chase_wave.cu (wavefront, one CTA a lane),
// band_chase_staged.cu (windows staged in shared memory) and
// band_chase_vmem.cu (packed band).  The pair is templated on an accessor
// that maps a matrix entry (row, col) to where that kernel keeps it; the
// arithmetic and the thread mapping are this file's alone, so every kernel
// computes the same (d, e) bit for bit.
//
// Schedule and arithmetic are those of models/two_stage.band_to_bidiagonal:
// a pair is a right Householder elimination of the pivot row over b columns,
// applied to the window's rows, then a left one of the pivot column over b
// rows, applied to the window's 2b columns.  Reads past n return zero and
// writes past n are dropped: those entries are zero, and the reflectors over
// them are the identity.
//
// Thread mapping (512 threads):
//  * warp 0 builds each reflector alone (b <= 256 entries, KPL per lane,
//    one warp reduction), then one barrier publishes v and tau;
//  * right apply: one warp per window row, R rows per warp at a time, all
//    R * KPL loads issued before the R independent warp reductions;
//  * left apply: a thread per (row group, column), its rows loaded kChunk
//    at a time into registers, partial column sums combined in shared memory
//    in the order of the groups.
// KPL = b/32 rounded up to a power of two is a template parameter so the
// register arrays stay registers.
//
// Bands past kMaxBand take the wide pair (KPL = kWide): the same schedule,
// masks and reflector rule, with v in shared memory of b floats (the
// kernel's dynamic shared memory), each reflector built by the whole block
// (a block reduction of the sum of squares), the right apply a warp a row
// in passes of 32 columns, and the left apply a thread a column in passes
// over the 2b window columns.  Its products and sums are rounded one
// operation at a time (__fmul_rn, __fadd_rn), so the kernels that run it
// (the L2 sequential kernel and the wavefront's L2 tick, plain and
// recording) give the same (d, e) and records bit for bit.  The narrow
// instances (b <= kMaxBand) are untouched by it.
#pragma once

#include <cuda_runtime.h>

// Phase marks of a pair and a tick: tools/chase_split.py defines them to
// take time stamps; empty in the package's builds.
#ifndef SVDT_SPLIT
#define SVDT_SPLIT(k)
#endif
#ifndef SVDT_SPLIT_TICK
#define SVDT_SPLIT_TICK(t)
#endif

namespace svdt {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBand = kThreads / 2;  // 2b columns <= kThreads
constexpr int kChunk = 16;     // left-apply rows a thread holds at once
constexpr int kWide = 0;       // the KPL of the wide pair (b > kMaxBand)

// ---- accessors: where entry (r, c) lives ----

// The dense n x n row-major matrix in device memory.
struct DenseAt {
  float* A;
  size_t ld;
  __device__ float load(int r, int c) const { return A[r * ld + c]; }
  __device__ void store(int r, int c, float x) const { A[r * ld + c] = x; }
};

// The dense matrix read and written through L2 only (ld.global.cg /
// st.global.cg), for kernels whose CTAs rewrite windows that other CTAs read
// after a grid barrier: no SM may serve a stale L1 line.
struct DenseL2At {
  float* A;
  size_t ld;
  __device__ float load(int r, int c) const { return __ldcg(A + r * ld + c); }
  __device__ void store(int r, int c, float x) const { __stcg(A + r * ld + c, x); }
};

// The packed band P (Npad x 512): P[r, l] = A[r, 128 * (r / 128) - 128 + l].
constexpr int kPackWidth = 512;
__device__ __forceinline__ size_t packed_index(int r, int c) {
  return (size_t)r * kPackWidth + (c - ((r >> 7) << 7) + 128);
}
struct PackedAt {
  float* P;
  __device__ float load(int r, int c) const { return P[packed_index(r, c)]; }
  __device__ void store(int r, int c, float x) const { P[packed_index(r, c)] = x; }
};

// ---- building blocks ----

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Warp 0 only: the reflector of x[0..b) (lane holds x[lane + 32 t]) with
// pivot x[0]; writes v = (1, x[1:] / (pivot - beta)) to shared memory and
// returns tau (0 for a zero tail).  The reference's sign rule:
// beta = -sign(pivot) * norm with sign(0) = +1.
template <int KPL>
__device__ float warp_reflector(const float (&x)[KPL], int b, float* v) {
  const int lane = threadIdx.x & 31;
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    if (k >= 1 && k < b) part += x[t] * x[t];
  }
  const float sigma2 = warp_sum(part);
  const float pivot = __shfl_sync(0xffffffffu, x[0], 0);
  const float norm = sqrtf(pivot * pivot + sigma2);
  const float beta = pivot >= 0.f ? -norm : norm;
  const bool trivial = sigma2 == 0.f;
  const float denom = trivial ? 1.f : pivot - beta;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    if (k < b) v[k] = k == 0 ? 1.f : x[t] / denom;
  }
  return trivial ? 0.f : (beta - pivot) / (beta == 0.f ? 1.f : beta);
}

// Warp 0 only, after warp_reflector: store the reflector it just built
// (b entries of v from shared memory, each read by the lane that wrote it)
// and its tau into one record slot; a zero row for tau = 0.
__device__ __forceinline__ void record(const float* v, float tau, int b,
                                       float* rv, float* rt) {
  const int lane = threadIdx.x & 31;
  for (int k = lane; k < b; k += 32) rv[k] = tau != 0.f ? v[k] : 0.f;
  if (lane == 0) *rt = tau;
}

// Record slot (i, s) of one side: v at (i * s_max + s) * b, tau at
// i * s_max + s.  Unused (null) in the plain chase.
struct Slot {
  float* v;
  float* t;
};

// The records of one chase: VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max),
// row-major; all null in the plain chase.  Shared by the recording entries
// of band_chase.cu (sequential) and band_chase_wave.cu (wavefront), which
// fill the same slots.
struct Records {
  float* vl;
  float* tl;
  float* vr;
  float* tr;
  int s_max;
  __device__ Slot left(int i, int s, int b) const {
    const size_t k = (size_t)i * s_max + s;
    return {vl + k * b, tl + k};
  }
  __device__ Slot right(int i, int s, int b) const {
    const size_t k = (size_t)i * s_max + s;
    return {vr + k * b, tr + k};
  }
};

// The rows a warp of the right apply holds at once.
template <int KPL>
__host__ __device__ constexpr int right_rows() { return KPL >= 8 ? 32 / KPL : 8; }

// One row's share of a right apply: the dot of the row's entries (lane holds
// x[t] at column lane + 32 t) with the reflector, before the warp reduction.
template <int KPL>
__device__ __forceinline__ float row_dot(const float (&x)[KPL],
                                         const float (&vk)[KPL]) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < KPL; ++t) s += x[t] * vk[t];
  return s;
}

// The updated entry of a rank-1 reflector apply: x - f * v.
__device__ __forceinline__ float rank1(float x, float f, float v) {
  return x - f * v;
}

// Warp 0 only: the pivot row r0, columns [c0, c0 + b), into registers.
template <int KPL, class Acc>
__device__ __forceinline__ void load_row(const Acc& a, int n, int b, int r0,
                                         int c0, float (&x)[KPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    x[t] = (k < b && c0 + k < n) ? a.load(r0, c0 + k) : 0.f;
  }
}

// Warp 0 only: the pivot column c0, rows [rl, rl + b), into registers.
template <int KPL, class Acc>
__device__ __forceinline__ void load_col(const Acc& a, int n, int b, int rl,
                                         int c0, float (&x)[KPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    x[t] = (k < b && rl + k < n) ? a.load(rl + k, c0) : 0.f;
  }
}

// The right reflector (v, tau) applied to rows [r0, r0 + wr) x columns
// [c0, c0 + b); tau != 0 (block-uniform).
template <int KPL, class Acc>
__device__ void apply_right(const Acc& a, int n, int b, int r0, int c0, int wr,
                            const float* v, float tau) {
  constexpr int R = right_rows<KPL>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float vk[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int k = lane + 32 * t;
    vk[t] = (k < b && c0 + k < n) ? v[k] : 0.f;  // 0 also masks columns >= n
  }
  const int rows = min(wr, n - r0);
  for (int i0 = warp * R; i0 < rows; i0 += kWarps * R) {
    float x[R][KPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int k = lane + 32 * t;
        x[r][t] = (i0 + r < rows && vk[t] != 0.f) ? a.load(r0 + i0 + r, c0 + k)
                                                  : 0.f;
      }
    float f[R];
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = row_dot<KPL>(x[r], vk);
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = tau * warp_sum(f[r]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int k = lane + 32 * t;
        if (i0 + r < rows && vk[t] != 0.f)
          a.store(r0 + i0 + r, c0 + k, rank1(x[r][t], f[r], vk[t]));
      }
  }
}

// The left apply's thread (g, c): row group g of `groups`, column c of 2b.
struct LeftThread {
  int cols, groups, g, c;
  __device__ LeftThread(int b) {
    cols = 2 * b;
    groups = kThreads / cols;
    g = threadIdx.x / cols;
    c = threadIdx.x - g * cols;
  }
};

// First half of a left apply of v over rows [rl, rl + b) x columns
// [c0, c0 + 2b): thread (g, c) sums v[i] * A[rl + i, c0 + c] over its rows
// into part[g * 2b + c].  A barrier must follow before left_total.
template <class Acc>
__device__ void left_partials(const Acc& a, int n, int b, int rl, int c0,
                              const float* v, float* part) {
  const LeftThread lt(b);
  const int rows = min(b, n - rl);
  const bool active = lt.g < lt.groups && c0 + lt.c < n;
  float s = 0.f;
  if (active)
    for (int i0 = lt.g; i0 < rows; i0 += lt.groups * kChunk) {
      float x[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t * lt.groups;
        x[t] = i < rows ? a.load(rl + i, c0 + lt.c) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t * lt.groups;
        if (i < rows) s += v[i] * x[t];
      }
    }
  if (lt.g < lt.groups) part[lt.g * lt.cols + lt.c] = s;
}

// Column c's sum v^T A[:, c0 + c] from the partials, combined in group order.
__device__ __forceinline__ float left_total(const float* part, int b, int c) {
  const int cols = 2 * b;
  const int groups = kThreads / cols;
  float tot = 0.f;
  for (int q = 0; q < groups; ++q) tot += part[q * cols + c];
  return tot;
}

// The left reflector (v, tau2) applied to rows [rl, rl + b) x columns
// [c0, c0 + 2b); tau2 != 0 (block-uniform).  Ends with a barrier.
template <class Acc>
__device__ void apply_left(const Acc& a, int n, int b, int rl, int c0,
                           const float* v, float tau2, float* part) {
  left_partials(a, n, b, rl, c0, v, part);
  __syncthreads();
  SVDT_SPLIT(5);
  const LeftThread lt(b);
  const int rows = min(b, n - rl);
  if (lt.g < lt.groups && c0 + lt.c < n) {
    const float f = tau2 * left_total(part, b, lt.c);
    for (int i0 = lt.g; i0 < rows; i0 += lt.groups * kChunk) {
      float x[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t * lt.groups;
        x[t] = i < rows ? a.load(rl + i, c0 + lt.c) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t * lt.groups;
        if (i < rows) a.store(rl + i, c0 + lt.c, rank1(x[t], f, v[i]));
      }
    }
  }
  __syncthreads();
}

// One elimination pair on the window with corner (r0, c0): right reflector
// from row r0, columns [c0, c0+b), applied to rows [r0, r0+wr); then left
// reflector from column c0, rows [r0+lr0, r0+lr0+b), applied to columns
// [c0, c0+2b).  With Rec, the right reflector goes to slot `rr`, the left
// one to slot `rl_`.  v (b floats), part (kThreads floats) and s_tau (2
// floats) are shared memory.  Ends with a barrier.
template <int KPL, bool Rec, class Acc>
__device__ void chase_pair_narrow(const Acc& a, int n, int b, int r0, int c0,
                                  int wr, int lr0, float* v, float* part,
                                  float* s_tau, Slot rr, Slot rl_) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (c0 >= n) return;  // all-zero window: both reflectors are the identity

  // ---- right elimination ----
  if (warp == 0) {
    float x[KPL];
    load_row<KPL>(a, n, b, r0, c0, x);
    const float tau = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[0] = tau;
    if constexpr (Rec) record(v, tau, b, rr.v, rr.t);
  }
  __syncthreads();
  SVDT_SPLIT(2);
  const float tau = s_tau[0];
  if (tau != 0.f) apply_right<KPL>(a, n, b, r0, c0, wr, v, tau);
  __syncthreads();
  SVDT_SPLIT(3);

  // ---- left elimination ----
  const int rl = r0 + lr0;
  if (warp == 0) {
    float x[KPL];
    load_col<KPL>(a, n, b, rl, c0, x);
    const float tau2 = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[1] = tau2;
    if constexpr (Rec) record(v, tau2, b, rl_.v, rl_.t);
  }
  __syncthreads();
  SVDT_SPLIT(4);
  const float tau2 = s_tau[1];
  if (tau2 != 0.f) apply_left(a, n, b, rl, c0, v, tau2, part);
  else __syncthreads();
  SVDT_SPLIT(6);
}

// ---- the wide pair (b > kMaxBand, KPL = kWide) ----

// Every thread: the reflector of x[k] = load(k), k < b, pivot x[0], built
// in shared v (b floats); returns tau to every thread.  The sum of squares
// of x[1:]: each thread's entries k = tid + kThreads q in order of q, a
// warp butterfly, then every thread sums the kWarps warp totals (part) in
// warp order, so all hold the same bits.  Ends with a barrier.
template <class Load>
__device__ float block_reflector(Load load, int b, float* v, float* part) {
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int k = tid; k < b; k += kThreads) {
    const float x = load(k);
    v[k] = x;
    if (k >= 1) s = __fadd_rn(s, __fmul_rn(x, x));
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) part[tid >> 5] = s;
  __syncthreads();
  float sigma2 = 0.f;
  for (int w = 0; w < kWarps; ++w) sigma2 = __fadd_rn(sigma2, part[w]);
  const float pivot = v[0];
  const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(pivot, pivot), sigma2));
  const float beta = pivot >= 0.f ? -norm : norm;
  const bool trivial = sigma2 == 0.f;
  const float denom = trivial ? 1.f : __fsub_rn(pivot, beta);
  const float tau =
      trivial ? 0.f : __fdiv_rn(__fsub_rn(beta, pivot), beta == 0.f ? 1.f : beta);
  __syncthreads();  // every thread has read v[0] and part
  for (int k = tid; k < b; k += kThreads) v[k] = k == 0 ? 1.f : __fdiv_rn(v[k], denom);
  __syncthreads();
  return tau;
}

// Every thread, after block_reflector: the reflector into its record slot
// (a zero row for tau = 0), as record() stores a narrow one.
__device__ __forceinline__ void block_record(const float* v, float tau, int b,
                                             Slot s) {
  for (int k = threadIdx.x; k < b; k += kThreads) s.v[k] = tau != 0.f ? v[k] : 0.f;
  if (threadIdx.x == 0) *s.t = tau;
}

// Entries the wide pair's passes hold in registers at once: their loads go
// out together, then the dependent sums or the stores (a store may alias a
// later load, so an unchunked loop pays an L2 round trip an entry).
constexpr int kWideChunk = 8;

// The right reflector (v, tau) on rows [r0, r0 + wr) x columns [c0, c0 + b):
// a warp a row, lane k's columns k, k + 32, ... summed in order, then the
// warp butterfly; the row is read again for the update.
template <class Acc>
__device__ void wide_apply_right(const Acc& a, int n, int b, int r0, int c0,
                                 int wr, const float* v, float tau) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = min(wr, n - r0);
  const int cols = min(b, n - c0);
  for (int i = warp; i < rows; i += kWarps) {
    float s = 0.f;
    for (int k0 = lane; k0 < cols; k0 += 32 * kWideChunk) {
      float x[kWideChunk];
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u) {
        const int k = k0 + 32 * u;
        x[u] = k < cols ? a.load(r0 + i, c0 + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u) {
        const int k = k0 + 32 * u;
        if (k < cols) s = __fadd_rn(s, __fmul_rn(x[u], v[k]));
      }
    }
    const float f = __fmul_rn(tau, warp_sum(s));
    for (int k0 = lane; k0 < cols; k0 += 32 * kWideChunk) {
      float x[kWideChunk];
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u) {
        const int k = k0 + 32 * u;
        x[u] = k < cols ? a.load(r0 + i, c0 + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u) {
        const int k = k0 + 32 * u;
        if (k < cols) a.store(r0 + i, c0 + k, __fsub_rn(x[u], __fmul_rn(f, v[k])));
      }
    }
  }
}

// The left reflector (v, tau2) on rows [rl, rl + b) x columns [c0, c0 + 2b):
// a thread a column, its b rows summed in order, then read again for the
// update; the columns in passes of kThreads.
template <class Acc>
__device__ void wide_apply_left(const Acc& a, int n, int b, int rl, int c0,
                                const float* v, float tau2) {
  const int rows = min(b, n - rl);
  const int cols = min(2 * b, n - c0);
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float s = 0.f;
    for (int i0 = 0; i0 < rows; i0 += kWideChunk) {
      float x[kWideChunk];
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u)
        x[u] = i0 + u < rows ? a.load(rl + i0 + u, c0 + c) : 0.f;
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u)
        if (i0 + u < rows) s = __fadd_rn(s, __fmul_rn(v[i0 + u], x[u]));
    }
    const float f = __fmul_rn(tau2, s);
    for (int i0 = 0; i0 < rows; i0 += kWideChunk) {
      float x[kWideChunk];
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u)
        x[u] = i0 + u < rows ? a.load(rl + i0 + u, c0 + c) : 0.f;
#pragma unroll
      for (int u = 0; u < kWideChunk; ++u)
        if (i0 + u < rows)
          a.store(rl + i0 + u, c0 + c, __fsub_rn(x[u], __fmul_rn(f, v[i0 + u])));
    }
  }
}

// chase_pair for b > kMaxBand: v is b floats of shared memory, part at
// least kWarps.  Ends with a barrier.
template <bool Rec, class Acc>
__device__ void chase_pair_wide(const Acc& a, int n, int b, int r0, int c0,
                                int wr, int lr0, float* v, float* part, Slot rr,
                                Slot rl_) {
  if (c0 >= n) return;  // all-zero window: both reflectors are the identity
  const float tau = block_reflector(
      [&](int k) { return c0 + k < n ? a.load(r0, c0 + k) : 0.f; }, b, v, part);
  if constexpr (Rec) block_record(v, tau, b, rr);
  if (tau != 0.f) wide_apply_right(a, n, b, r0, c0, wr, v, tau);
  __syncthreads();
  const int rl = r0 + lr0;
  const float tau2 = block_reflector(
      [&](int k) { return rl + k < n ? a.load(rl + k, c0) : 0.f; }, b, v, part);
  if constexpr (Rec) block_record(v, tau2, b, rl_);
  if (tau2 != 0.f) wide_apply_left(a, n, b, rl, c0, v, tau2);
  __syncthreads();
}

// The elimination pair of every chase kernel: the narrow instances for
// b <= kMaxBand, the wide pair for KPL = kWide (v then holds b floats).
template <int KPL, bool Rec, class Acc>
__device__ __forceinline__ void chase_pair(const Acc& a, int n, int b, int r0,
                                           int c0, int wr, int lr0, float* v,
                                           float* part, float* s_tau, Slot rr,
                                           Slot rl_) {
  if constexpr (KPL == kWide)
    chase_pair_wide<Rec>(a, n, b, r0, c0, wr, lr0, v, part, rr, rl_);
  else
    chase_pair_narrow<KPL, Rec>(a, n, b, r0, c0, wr, lr0, v, part, s_tau, rr, rl_);
}

// nc_of: chase pairs of sweep i, max(0, ceil((n - (i + 2b + 1)) / b)) + 1
// (ops/chase_schedule.py).
__device__ __host__ __forceinline__ int nc_of(int i, int n, int b) {
  const int rest = n - (i + 2 * b + 1);
  return (rest > 0 ? (rest + b - 1) / b : 0) + 1;
}

// Runs the statement(s) after b with KPL, the register chunk of band
// b <= 256, as a compile-time constant.
#define SVDT_KPL_DISPATCH(b, ...)                     \
  do {                                                \
    if ((b) <= 32) {                                  \
      constexpr int KPL = 1;                          \
      __VA_ARGS__;                                    \
    } else if ((b) <= 64) {                           \
      constexpr int KPL = 2;                          \
      __VA_ARGS__;                                    \
    } else if ((b) <= 128) {                          \
      constexpr int KPL = 4;                          \
      __VA_ARGS__;                                    \
    } else {                                          \
      constexpr int KPL = 8;                          \
      __VA_ARGS__;                                    \
    }                                                 \
  } while (0)

// SVDT_KPL_DISPATCH, and KPL = kWide for b > kMaxBand (the kernel then
// needs 4 b bytes of dynamic shared memory for v).
#define SVDT_BAND_DISPATCH(b, ...)                    \
  do {                                                \
    if ((b) > kMaxBand) {                             \
      constexpr int KPL = kWide;                      \
      __VA_ARGS__;                                    \
    } else {                                          \
      SVDT_KPL_DISPATCH(b, __VA_ARGS__);              \
    }                                                 \
  } while (0)

}  // namespace svdt
