// Band -> bidiagonal bulge chase, the whole Stage II in one launch, with or
// without recording its reflectors.
//
// svdt_band_chase replaces three TPU kernels that compute the same chase and
// differ only in where the TPU keeps the band:
//   svdsolver_tpu/ops/pallas/band_chase.py        _chase_kernel (dense matrix
//       in HBM, one DMA'd window per pair);
//   svdsolver_tpu/ops/pallas/band_chase_wave.py   _wave_chase_kernel (packed
//       band resident in VMEM, wavefront schedule);
//   svdsolver_tpu/ops/pallas/band_chase_stream.py _stream_chase_kernel with
//       rec=False (packed band streamed through VMEM windows).
// svdt_band_chase_rec replaces their three recording twins, which also emit
// every reflector for the singular-vector back-transform:
//   band_chase.py        _chase_kernel_rec;
//   band_chase_wave.py   _wave_chase_rec_kernel;
//   band_chase_stream.py _stream_chase_kernel with rec=True.
// Both instantiate the one chase_pair below (template flag Rec), so the
// recording chase's arithmetic is the very code of the plain one and its
// (d, e) are bit-equal to it.  Recording: after each warp_reflector, warp 0
// stores the b entries of v and tau straight into slot (i, s) of VR/TR
// (right) or VL/TL (left), in the canonical (n-1, s_max, b) layout, so the
// TPU's lane rotations of the records have no counterpart here.  tau is
// stored as computed, not recovered as 2/v^Tv; an identity reflector
// (tau = 0) is stored as a zero row; entries past n are zero because the
// reads past n are.  Slots the schedule never reaches are left as the
// caller allocated them (zeros).  The records add 2 (b + 1) floats of
// stores a pair, under 1 % of the pair's window traffic, but warp 0 issues
// them before the pair's barrier: on the H100 (700 W) the recording entry
// took 913 ms against the plain entry's 850 ms at n = 3840, b = 128 (about
// 1 us a pair); storing from registers after the barrier is later work.
// Schedule and arithmetic are those of models/two_stage.band_to_bidiagonal:
// sweep i runs a head pair at (i, i+1) and nc_of(i, n, b) chase pairs at
// (r, r+b), r = i+1+k*b; each pair is a right Householder elimination of the
// pivot row over b columns, applied to the window's rows, then a left one of
// the pivot column over b rows, applied to the window's 2b columns.
//
// What bounds it on the H100: about n^2/(2b) pairs (57.6k at n = 3840,
// b = 128) run strictly in order, each reading and rewriting a window of up
// to 2b x 2b floats (256 KB at b = 128) from L2, with a handful of block
// barriers.  So one SM's latency to L2 and the barriers bound it, not FLOPs
// or device memory bandwidth.
//
// Design: one block of 512 threads walks the sequential schedule over the
// dense n x n matrix in device memory, in place.  The window does not fit
// shared memory for every band, so only the reflector and the column partial
// sums are staged there.  Because each pair is a chain of dependent L2 round
// trips, the kernel is written to put many loads in flight per round trip
// and to take few block barriers:
//  * warp 0 builds each reflector alone (b <= 256 entries, KPL per lane,
//    one warp reduction), then one barrier publishes v and tau;
//  * right apply: one warp per window row, R rows per warp at a time, all
//    R * KPL loads issued before the R independent warp reductions;
//  * left apply: a thread per (row group, column), its rows loaded kChunk
//    at a time into registers, partial column sums combined in shared memory.
// KPL = b/32 rounded up to a power of two is a template parameter so the
// register arrays stay registers.  Instead of the plain version's zero
// padding, reads past n return zero and writes past n are dropped: those
// entries are zero, the reflectors over them are the identity, and the
// padding copy is saved.  512 threads, not 1024: at 1024 the 64-register cap
// spills the register chunks, and the chase at n = 3840, b = 128 took 1006 ms
// on the H100 against 845 ms at 512 threads (256 threads: 1058 ms).  Running sweeps 3 pairs apart concurrently (their
// windows are disjoint) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBand = kThreads / 2;  // 2b columns <= kThreads
constexpr int kChunk = 16;     // left-apply rows a thread holds at once

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

// One elimination pair on the window with corner (r0, c0): right reflector
// from row r0, columns [c0, c0+b), applied to rows [r0, r0+wr); then left
// reflector from column c0, rows [r0+lr0, r0+lr0+b), applied to columns
// [c0, c0+2b).  With Rec, the right reflector goes to slot `rr`, the left
// one to slot `rl_`.
template <int KPL, bool Rec>
__device__ void chase_pair(float* A, int n, int b, int r0, int c0, int wr,
                           int lr0, float* v, float* part, float* s_tau,
                           Slot rr, Slot rl_) {
  constexpr int R = KPL >= 8 ? 32 / KPL : 8;  // rows a warp applies at once
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (c0 >= n) return;  // all-zero window: both reflectors are the identity
  const size_t ld = (size_t)n;

  // ---- right elimination ----
  if (warp == 0) {
    float x[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      x[t] = (k < b && c0 + k < n) ? A[r0 * ld + c0 + k] : 0.f;
    }
    const float tau = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[0] = tau;
    if constexpr (Rec) record(v, tau, b, rr.v, rr.t);
  }
  __syncthreads();
  const float tau = s_tau[0];
  if (tau != 0.f) {  // block-uniform
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
          x[r][t] = (i0 + r < rows && vk[t] != 0.f)
                        ? A[(size_t)(r0 + i0 + r) * ld + c0 + k] : 0.f;
        }
      float f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < KPL; ++t) s += x[r][t] * vk[t];
        f[r] = s;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) f[r] = tau * warp_sum(f[r]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int k = lane + 32 * t;
          if (i0 + r < rows && vk[t] != 0.f)
            A[(size_t)(r0 + i0 + r) * ld + c0 + k] = x[r][t] - f[r] * vk[t];
        }
    }
  }
  __syncthreads();

  // ---- left elimination ----
  const int rl = r0 + lr0;
  if (warp == 0) {
    float x[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int k = lane + 32 * t;
      x[t] = (k < b && rl + k < n) ? A[(size_t)(rl + k) * ld + c0] : 0.f;
    }
    const float tau2 = warp_reflector<KPL>(x, b, v);
    if (lane == 0) s_tau[1] = tau2;
    if constexpr (Rec) record(v, tau2, b, rl_.v, rl_.t);
  }
  __syncthreads();
  const float tau2 = s_tau[1];
  if (tau2 != 0.f) {
    const int cols = 2 * b;
    const int groups = kThreads / cols;
    const int g = tid / cols;
    const int c = tid - g * cols;
    const int rows = min(b, n - rl);
    const bool active = g < groups && c0 + c < n;
    float* col = A + (size_t)rl * ld + c0 + c;
    float s = 0.f;
    if (active)
      for (int i0 = g; i0 < rows; i0 += groups * kChunk) {
        float x[kChunk];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int i = i0 + t * groups;
          x[t] = i < rows ? col[(size_t)i * ld] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int i = i0 + t * groups;
          if (i < rows) s += v[i] * x[t];
        }
      }
    if (g < groups) part[g * cols + c] = s;
    __syncthreads();
    if (active) {
      float tot = 0.f;
      for (int q = 0; q < groups; ++q) tot += part[q * cols + c];
      const float f = tau2 * tot;
      for (int i0 = g; i0 < rows; i0 += groups * kChunk) {
        float x[kChunk];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int i = i0 + t * groups;
          x[t] = i < rows ? col[(size_t)i * ld] : 0.f;
        }
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int i = i0 + t * groups;
          if (i < rows) col[(size_t)i * ld] = x[t] - f * v[i];
        }
      }
    }
  }
  __syncthreads();
}

// The records of one chase: VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max),
// row-major; all null in the plain chase.
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

template <int KPL, bool Rec>
__global__ void __launch_bounds__(kThreads)
band_chase_kernel(float* __restrict__ A, float* __restrict__ d,
                  float* __restrict__ e, int n, int b, Records rec) {
  __shared__ float v[kMaxBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  const Slot none = {nullptr, nullptr};
  for (int i = 0; i < n - 1; ++i) {
    // head pair: slot 0 (left reflector rows [i+1, i+1+b))
    chase_pair<KPL, Rec>(A, n, b, i, i + 1, b + 1, 1, v, part, s_tau,
                         Rec ? rec.right(i, 0, b) : none,
                         Rec ? rec.left(i, 0, b) : none);
    // nc_of: max(0, ceil((n - (i + 2b + 1)) / b)) + 1 (ops/chase_schedule.py)
    const int rest = n - (i + 2 * b + 1);
    const int nc = (rest > 0 ? (rest + b - 1) / b : 0) + 1;
    for (int k = 0; k < nc; ++k) {  // chase pair k: slot k + 1
      const int r = i + 1 + k * b;
      chase_pair<KPL, Rec>(A, n, b, r, r + b, 2 * b, b, v, part, s_tau,
                           Rec ? rec.right(i, k + 1, b) : none,
                           Rec ? rec.left(i, k + 1, b) : none);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    d[i] = A[(size_t)i * n + i];
    if (i + 1 < n) e[i] = A[(size_t)i * n + i + 1];
  }
}

template <bool Rec>
int launch(float* A, float* d, float* e, int n, int b, Records rec,
           void* stream) {
  if (n < 2 || b < 1 || b > kMaxBand) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 32)
    band_chase_kernel<1, Rec><<<1, kThreads, 0, s>>>(A, d, e, n, b, rec);
  else if (b <= 64)
    band_chase_kernel<2, Rec><<<1, kThreads, 0, s>>>(A, d, e, n, b, rec);
  else if (b <= 128)
    band_chase_kernel<4, Rec><<<1, kThreads, 0, s>>>(A, d, e, n, b, rec);
  else
    band_chase_kernel<8, Rec><<<1, kThreads, 0, s>>>(A, d, e, n, b, rec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the chase on `stream`, overwriting A (n x n, row-major, upper band
// b); returns the launch's cudaError_t.
extern "C" int svdt_band_chase(float* A, float* d, float* e, int n, int b,
                               void* stream) {
  return launch<false>(A, d, e, n, b, {nullptr, nullptr, nullptr, nullptr, 0},
                       stream);
}

// As svdt_band_chase, and writes every reflector into the zero-initialised
// records VL, VR (n-1, s_max, b) and TL, TR (n-1, s_max).
extern "C" int svdt_band_chase_rec(float* A, float* d, float* e, int n, int b,
                                   float* VL, float* TL, float* VR, float* TR,
                                   int s_max, void* stream) {
  return launch<true>(A, d, e, n, b, {VL, TL, VR, TR, s_max}, stream);
}
