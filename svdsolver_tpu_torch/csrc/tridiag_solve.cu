// The shifted Golub-Kahan tridiagonal solve of inverse iteration, both
// passes in one launch, one thread per shift lane: a warp of lanes a block
// with its factor rows staged through shared memory (tgk_staged_kernel), or
// the first design, factor rows in device memory (tgk_solve_kernel, kept
// for timings in turns).
//
// Replaces the two TPU kernels of svdsolver_tpu/ops/pallas/tridiag_solve.py:
//   _fwd_kernel  LU with partial pivoting of (TGK - lam_j I) for every lane,
//                factor rows U0, U1, U2 and R streamed to HBM;
//   _bwd_kernel  back substitution over those rows with clip(+-big).
// Arithmetic and pivoting are those of models/vectors.tgk_solve_xla (the
// plain version here is ops/cuda/tridiag_solve.tgk_solve_plain): the third
// upper carry of the band-2 elimination is identically zero for a
// tridiagonal and is dropped (p2 = swap ? z[r+1] : 0); pivots below pivmin
// are floored to +-pivmin; the last factor row is (clamped b, 0, 0, y), so
// the carry cc is never stored there.  The parity claim of the reference is
// that the pivoting decisions are identical, so every product, difference
// and quotient is rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn: no
// FMA contraction, IEEE division), as in PyTorch's eager plain version, and
// the clip is written so that a NaN stays a NaN, as jnp.clip and
// torch.clamp do (fminf/fmaxf would drop it).
//
// What bounds it on the H100: the bytes it must move are rhs in and x out,
// 2 N k floats (236 MB at n = 3840: N = 7680 rows, k = 3840 lanes), ~70 us
// at 3.35 TB/s; its ~12 N k flops are far less.  But each lane is a chain
// of N dependent steps, each with an IEEE division, in each pass, and the
// factor rows (4 N k floats more) go out to device memory and come back.
// Measured on the H100 (700 W): 7.06 ms at n = 3840, ~460 ns a row and
// pass, about five times the division chain alone: with two warps an SM,
// the latency of the row loads is what the unrolling does not hide.  A
// deeper software prefetch, or the factor rows kept on chip in chunks, is
// later work.
//
// The first design: lane j is thread j; the factor rows are stored
// lane-major, row r of all lanes contiguous (the layout of rhs), so a
// warp's loads and stores are coalesced; the z entries of a row are the
// same for every lane (a broadcast through L1).  The forward loop's rhs
// load and the backward loop's four loads do not depend on the chain, so
// unrolling lets the compiler issue them ahead.  64-thread blocks spread
// the lanes over many SMs (60 at k = 3840).
//
// The staged design: one block per 32 lanes (120 blocks at k = 3840, two
// resident an SM), two warps.  Warp 0 runs the lanes' chains and touches
// only shared memory; warp 1 moves the data.  Rows go in chunks of kRows:
//   forward   warp 1 keeps the rhs rows and z entries of the next
//             kRhsSlots - 1 chunks in flight (cp.async, 4 bytes a lane:
//             any k, no 16-byte row stride needed) and stores each chunk of
//             factor rows warp 0 has finished to a scratch laid out
//             (array, block, row, lane), contiguous 16-byte stores;
//   backward  the last kSlots chunks never left shared memory and feed it
//             directly; warp 1 fetches the others kSlots - 1 chunks ahead
//             (cp.async, 16 bytes) and stores each finished chunk of x.
// One __syncthreads a chunk hands the buffers over.  U2 is not stored: it
// is swap ? z[r+1] : 0, so a per-row __ballot_sync of swap (one word a
// row and warp) and z rebuild it bit for bit, a quarter less factor
// traffic.  Lanes past k compute on whatever their slots hold and store
// nothing.  Arithmetic, pivoting and clip are the first design's, row for
// row, so x is bit-equal to it.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float floor_pivot(float p, float pivmin) {
  const float sign = p < 0.f ? -1.f : 1.f;
  return fabsf(p) < pivmin ? sign * pivmin : p;
}

__global__ void __launch_bounds__(kThreads)
tgk_solve_kernel(const float* __restrict__ z, const float* __restrict__ lam,
                 const float* __restrict__ rhs, const float* __restrict__ piv,
                 const float* __restrict__ bigp, float* __restrict__ U0,
                 float* __restrict__ U1, float* __restrict__ U2,
                 float* __restrict__ R, float* __restrict__ x, int N, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const float pivmin = *piv;
  const float big = *bigp;
  const size_t ld = (size_t)k;
  const float bi = -lam[j];

  // ---- forward: LU with partial pivoting (TPU _fwd_kernel) ----
  float b = bi;
  float cc = z[0];
  float y = rhs[j];
#pragma unroll 4
  for (int r = 0; r < N - 1; ++r) {
    const float ai = z[r];
    const float ci = r + 1 < N - 1 ? z[r + 1] : 0.f;
    const float yi = rhs[(size_t)(r + 1) * ld + j];
    const bool swap = fabsf(ai) > fabsf(b);
    const float p0 = swap ? ai : b;
    const float p1 = swap ? bi : cc;
    const float p2 = swap ? ci : 0.f;
    const float py = swap ? yi : y;
    const float q0 = swap ? b : ai;
    const float q1 = swap ? cc : bi;
    const float q2 = swap ? 0.f : ci;
    const float qy = swap ? y : yi;
    const float safe = floor_pivot(p0, pivmin);
    const float mlt = __fdiv_rn(q0, safe);
    b = __fsub_rn(q1, __fmul_rn(mlt, p1));
    cc = __fsub_rn(q2, __fmul_rn(mlt, p2));
    y = __fsub_rn(qy, __fmul_rn(mlt, py));
    const size_t o = (size_t)r * ld + j;
    U0[o] = safe;
    U1[o] = p1;
    U2[o] = p2;
    R[o] = py;
  }
  const size_t last = (size_t)(N - 1) * ld + j;
  U0[last] = floor_pivot(b, pivmin);
  U1[last] = 0.f;
  U2[last] = 0.f;
  R[last] = y;

  // ---- backward substitution with the growth clip (TPU _bwd_kernel) ----
  // Each thread reads back only what it wrote itself: no barrier needed.
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int r = N - 1; r >= 0; --r) {
    const size_t o = (size_t)r * ld + j;
    const float num = __fsub_rn(__fsub_rn(R[o], __fmul_rn(U1[o], s1)),
                                __fmul_rn(U2[o], s2));
    float v = __fdiv_rn(num, U0[o]);
    v = v > big ? big : (v < -big ? -big : v);  // NaN compares false: kept
    x[o] = v;
    s2 = s1;
    s1 = v;
  }
}

// ---- the staged design ----

constexpr int kRows = 32;     // rows a chunk
constexpr int kSlots = 6;     // factor chunks in shared memory
constexpr int kRhsSlots = 4;  // rhs chunks: the current one and 3 in flight

struct FacSlot {  // one chunk of factor rows, lanes innermost
  float u0[kRows][32];
  float u1[kRows][32];
  float r[kRows][32];
  unsigned swp[kRows];  // bit j: lane j pivoted on the next row
  float zn[kRows];      // z[r+1], 0 past N-2: U2 where the bit is set
};
struct RhsSlot {
  float y[kRows][32];  // rhs row r + 1 for each row r of the chunk
  float z[kRows + 4];  // z[r0 .. r0 + kRows], 0 past N-2
};
struct Staged {
  FacSlot f[kSlots];
  RhsSlot y[kRhsSlots];
  float x[2][kRows][32];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Where the copying warp finds things.
struct Io {
  const float* z;
  const float* rhs;
  float* x;
  float* F;     // (3, nblk, N, 32): U0, U1, R of every row, lanes innermost
  unsigned* S;  // (nblk, N): the swap words
  int N, k, blk, nblk, lane;
  __device__ float* fac(int a, int r) const {
    return F + (((size_t)a * nblk + blk) * N + r) * 32;
  }
};

// rhs rows c R + 1 .. and z[c R .. c R + R] into a slot.
__device__ void load_rhs(const Io& io, int c, RhsSlot& sl) {
  const int r0 = c * kRows;
  const int j = io.blk * 32 + io.lane;
  if (j < io.k)
    for (int i = 0; i < kRows && r0 + i + 1 < io.N; ++i)
      cp_async4(&sl.y[i][io.lane], io.rhs + (size_t)(r0 + i + 1) * io.k + j);
  for (int m = io.lane; m <= kRows; m += 32) {
    if (r0 + m < io.N - 1)
      cp_async4(&sl.z[m], io.z + r0 + m);
    else
      sl.z[m] = 0.f;
  }
}

__device__ void store_fac(const Io& io, int c, const FacSlot& sl) {
  const int r0 = c * kRows;
  const int rows = min(kRows, io.N - r0);
  const float* src[3] = {&sl.u0[0][0], &sl.u1[0][0], &sl.r[0][0]};
  for (int a = 0; a < 3; ++a) {
    const float4* s4 = reinterpret_cast<const float4*>(src[a]);
    float4* d4 = reinterpret_cast<float4*>(io.fac(a, r0));
    for (int q = io.lane; q < rows * 8; q += 32) d4[q] = s4[q];
  }
  for (int i = io.lane; i < rows; i += 32)
    io.S[(size_t)io.blk * io.N + r0 + i] = sl.swp[i];
}

__device__ void load_fac(const Io& io, int c, FacSlot& sl) {
  const int r0 = c * kRows;
  const int rows = min(kRows, io.N - r0);
  float* dst[3] = {&sl.u0[0][0], &sl.u1[0][0], &sl.r[0][0]};
  for (int a = 0; a < 3; ++a) {
    const float* src = io.fac(a, r0);
    for (int q = io.lane; q < rows * 8; q += 32)
      cp_async16(dst[a] + 4 * q, src + 4 * q);
  }
  for (int i = io.lane; i < rows; i += 32) {
    cp_async4(&sl.swp[i], io.S + (size_t)io.blk * io.N + r0 + i);
    if (r0 + i + 1 < io.N - 1)
      cp_async4(&sl.zn[i], io.z + r0 + i + 1);
    else
      sl.zn[i] = 0.f;
  }
}

__device__ void store_x(const Io& io, int c, const float* xs) {
  const int r0 = c * kRows;
  const int rows = min(kRows, io.N - r0);
  const int j = io.blk * 32 + io.lane;
  if (j < io.k)
    for (int i = 0; i < rows; ++i)
      io.x[(size_t)(r0 + i) * io.k + j] = xs[i * 32 + io.lane];
}

__global__ void __launch_bounds__(64)
tgk_staged_kernel(const float* __restrict__ z, const float* __restrict__ lam,
                  const float* __restrict__ rhs,
                  const float* __restrict__ piv,
                  const float* __restrict__ bigp, float* __restrict__ F,
                  unsigned* __restrict__ S, float* __restrict__ x, int N,
                  int k) {
  extern __shared__ float4 smem4[];
  Staged& sm = *reinterpret_cast<Staged*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Io io = {z, rhs, x, F, S, N, k, (int)blockIdx.x, (int)gridDim.x, lane};
  const int j = blockIdx.x * 32 + lane;
  const int C = (N + kRows - 1) / kRows;
  const int resident = max(0, C - kSlots);  // chunks from here stay in smem

  // ---- forward: LU with partial pivoting (TPU _fwd_kernel) ----
  if (warp == 1) {
    for (int c = 0; c < kRhsSlots - 1; ++c) {
      if (c < C) load_rhs(io, c, sm.y[c]);
      cp_commit();
    }
    cp_wait<kRhsSlots - 2>();
  }
  __syncthreads();
  float pivmin = 0.f, big = 0.f, bi = 0.f, b = 0.f, cc = 0.f, y = 0.f;
  if (warp == 0) {
    pivmin = *piv;
    big = *bigp;
    bi = j < k ? -lam[j] : 0.f;
    b = bi;
    cc = z[0];
    y = j < k ? rhs[j] : 0.f;
  }
  for (int c = 0; c < C; ++c) {
    if (warp == 0) {
      FacSlot& f = sm.f[c % kSlots];
      const RhsSlot& ys = sm.y[c % kRhsSlots];
      const int r0 = c * kRows;
      const int rows = min(kRows, N - r0);
#pragma unroll 8
      for (int i = 0; i < rows; ++i) {
        if (r0 + i < N - 1) {
          const float ai = ys.z[i];
          const float ci = ys.z[i + 1];
          const float yi = ys.y[i][lane];
          const bool swap = fabsf(ai) > fabsf(b);
          const float p0 = swap ? ai : b;
          const float p1 = swap ? bi : cc;
          const float p2 = swap ? ci : 0.f;
          const float py = swap ? yi : y;
          const float q0 = swap ? b : ai;
          const float q1 = swap ? cc : bi;
          const float q2 = swap ? 0.f : ci;
          const float qy = swap ? y : yi;
          const float safe = floor_pivot(p0, pivmin);
          const float mlt = __fdiv_rn(q0, safe);
          b = __fsub_rn(q1, __fmul_rn(mlt, p1));
          cc = __fsub_rn(q2, __fmul_rn(mlt, p2));
          y = __fsub_rn(qy, __fmul_rn(mlt, py));
          f.u0[i][lane] = safe;
          f.u1[i][lane] = p1;
          f.r[i][lane] = py;
          const unsigned w = __ballot_sync(0xffffffffu, swap);
          if (lane == 0) {
            f.swp[i] = w;
            f.zn[i] = ci;
          }
        } else {  // the last row: (clamped b, 0, 0, y)
          f.u0[i][lane] = floor_pivot(b, pivmin);
          f.u1[i][lane] = 0.f;
          f.r[i][lane] = y;
          if (lane == 0) {
            f.swp[i] = 0u;
            f.zn[i] = 0.f;
          }
        }
      }
    } else {
      const int ahead = c + kRhsSlots - 1;  // into the slot chunk c-1 freed
      if (ahead < C) load_rhs(io, ahead, sm.y[ahead % kRhsSlots]);
      cp_commit();
      if (c >= 1 && c - 1 < resident) store_fac(io, c - 1, sm.f[(c - 1) % kSlots]);
      cp_wait<kRhsSlots - 2>();  // chunk c + 1 has landed
    }
    __syncthreads();
  }
  if (warp == 1) {
    cp_wait<0>();
    __threadfence();  // the factor stores before their reloads
  }

  // ---- backward substitution with the growth clip (TPU _bwd_kernel) ----
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < C; ++t) {
    const int c = C - 1 - t;
    if (warp == 0) {
      const FacSlot& f = sm.f[c % kSlots];
      float(*xs)[32] = sm.x[t & 1];
      const int rows = min(kRows, N - c * kRows);
#pragma unroll 8
      for (int i = rows - 1; i >= 0; --i) {
        const float u2 = (f.swp[i] >> lane) & 1u ? f.zn[i] : 0.f;
        const float num = __fsub_rn(__fsub_rn(f.r[i][lane], __fmul_rn(f.u1[i][lane], s1)),
                                    __fmul_rn(u2, s2));
        float v = __fdiv_rn(num, f.u0[i][lane]);
        v = v > big ? big : (v < -big ? -big : v);  // NaN compares false: kept
        xs[i][lane] = v;
        s2 = s1;
        s1 = v;
      }
    } else {
      // chunk c - (kSlots - 1) into the slot chunk c + 1 freed
      const int ahead = c - (kSlots - 1);
      if (t >= 1 && ahead >= 0) load_fac(io, ahead, sm.f[ahead % kSlots]);
      cp_commit();
      if (t >= 1) store_x(io, c + 1, &sm.x[(t - 1) & 1][0][0]);
      cp_wait<kSlots - 2>();  // chunk c - 1 has landed
    }
    __syncthreads();
  }
  if (warp == 1) store_x(io, 0, &sm.x[(C - 1) & 1][0][0]);
}

}  // namespace

// Launches the staged solve on `stream`: z (N-1), lam (k), rhs (N, k)
// row-major, pivmin and big one float each in device memory; F (3, ceil(k /
// 32), N, 32) floats and S (ceil(k / 32), N) words are scratch for the
// factor rows that leave shared memory (16-byte aligned), x (N, k) the
// solution.  Returns the launch's cudaError_t.
extern "C" int svdt_tgk_solve_staged(const float* z, const float* lam,
                                     const float* rhs, const float* pivmin,
                                     const float* big, float* F, unsigned* S,
                                     float* x, int N, int k, void* stream) {
  if (N < 2 || k < 1 || ((uintptr_t)F & 15)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Staged);
  cudaError_t err = cudaFuncSetAttribute(
      tgk_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (k + 31) / 32;
  tgk_staged_kernel<<<blocks, 64, smem, (cudaStream_t)stream>>>(
      z, lam, rhs, pivmin, big, F, S, x, N, k);
  return (int)cudaGetLastError();
}

// Launches the solve on `stream`: z (N-1), lam (k), rhs (N, k) row-major,
// pivmin and big one float each in device memory; U0, U1, U2, R (N, k) are
// scratch for the factor rows, x (N, k) the solution.  Returns the launch's
// cudaError_t.
extern "C" int svdt_tgk_solve(const float* z, const float* lam,
                              const float* rhs, const float* pivmin,
                              const float* big, float* U0, float* U1,
                              float* U2, float* R, float* x, int N, int k,
                              void* stream) {
  if (N < 2 || k < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (k + kThreads - 1) / kThreads;
  tgk_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, lam, rhs, pivmin, big, U0, U1, U2, R, x, N, k);
  return (int)cudaGetLastError();
}
