// Compact-WY Householder QR of one transposed panel, in one launch.
//
// Replaces: svdsolver_tpu/ops/pallas/panel_qr.py, _panel_kernel (launched by
// _panel_qr_pallas).  Same contract: the panel arrives transposed, Pt (b, m)
// row-major, so panel column j is row j with its pivot at column r_off + j.
// Outputs: Rt (b, m), the factored panel with exact zeros beyond each pivot;
// Vt (b, m), the reflectors as rows (zero below the pivot, one at it); and
// Tt (b, b), the compact-WY factor transposed (T^T), so that
// Q = I - V T V^T with V = Vt^T, T = Tt^T.
//
// What bounds it on the H100: the b columns are strictly sequential, and each
// one reads and rewrites the whole panel (b * m * 4 bytes, 1.97 MB at
// b = 128, m = 3840) for u = Rt v and the rank-1 update, so the kernel is
// bound by one SM's bandwidth to L2 and by the per-column block barriers.
// The panel is far beyond 227 KB of shared memory, so it stays in device
// memory, where it is L2-resident.
//
// Design: one block of 1024 threads walks the columns.  Per column the
// reflector is built from a block reduction; v (m floats) and w (b floats)
// are staged in shared memory; one warp owns each panel row, so u_i and that
// row's rank-1 update need no barrier between them; its loops are unrolled
// so each lane keeps several L2 loads in flight.  Entries below the
// pivot are skipped (v is zero there), which shrinks the passes as the
// pivot moves right.  The T row is a b-thread matvec over T rows < j.
// A pivot at or past m gives the identity reflector (tau = 0, v = 0), as the
// masked TPU arithmetic does for the last LQ panel.  Multi-block panels are
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block, returned to every thread.  red: kWarps floats.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
panel_qr_kernel(const float* __restrict__ Pt, float* __restrict__ Rt,
                float* __restrict__ Vt, float* __restrict__ Tt, int b, int m,
                int r_off) {
  extern __shared__ float smem[];
  float* v = smem;      // m: the current reflector
  float* w = v + m;     // b: Vt v over the finished rows
  float* red = w + b;   // kWarps: reduction scratch
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bm = (size_t)b * m;

  for (size_t i = tid; i < bm; i += kThreads) {
    Rt[i] = Pt[i];
    Vt[i] = 0.f;
  }
  for (int i = tid; i < b * b; i += kThreads) Tt[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const int p = r_off + j;
    const float* xrow = Rt + (size_t)j * m;
    float part = 0.f;
#pragma unroll 4
    for (int k = p + 1 + tid; k < m; k += kThreads) {
      const float x = xrow[k];
      part += x * x;
    }
    const float sigma2 = block_sum(part, red);
    const float pivot = p < m ? xrow[p] : 0.f;
    const float norm = sqrtf(pivot * pivot + sigma2);
    const float beta = pivot >= 0.f ? -norm : norm;
    const bool trivial = sigma2 == 0.f;
    const float denom = trivial ? 1.f : pivot - beta;
    const float tau = trivial ? 0.f : (beta - pivot) / (beta == 0.f ? 1.f : beta);

    float* vrow = Vt + (size_t)j * m;
    for (int k = p + tid; k < m; k += kThreads) {
      const float vk = k == p ? 1.f : xrow[k] / denom;
      v[k] = vk;
      vrow[k] = vk;
    }
    __syncthreads();

    if (tau != 0.f) {  // block-uniform; tau == 0 leaves R and the T row as they are
      for (int i = warp; i < b; i += kWarps) {
        float* row = Rt + (size_t)i * m;
        const float* vr = Vt + (size_t)i * m;
        float u = 0.f;
        float t = 0.f;  // (Vt v)_i, needed for the finished rows i < j
        if (i < j) {
#pragma unroll 8
          for (int k = p + lane; k < m; k += 32) {
            u += row[k] * v[k];
            t += vr[k] * v[k];
          }
          t = warp_sum(t);
          if (lane == 0) w[i] = t;
        } else {
#pragma unroll 8
          for (int k = p + lane; k < m; k += 32) u += row[k] * v[k];
        }
        const float f = tau * warp_sum(u);
#pragma unroll 8
        for (int k = p + lane; k < m; k += 32) row[k] -= f * v[k];
      }
      __syncthreads();
      // larft, transposed: Tt[j, :] = -tau * w^T Tt[:j, :] + tau * e_j
      for (int c = tid; c < b; c += kThreads) {
        float s = 0.f;
        for (int i = 0; i < j; ++i) s += w[i] * Tt[(size_t)i * b + c];
        Tt[(size_t)j * b + c] = -tau * s + (c == j ? tau : 0.f);
      }
    }
    __syncthreads();
  }

  // R: exact zeros beyond each pivot
  for (size_t idx = tid; idx < bm; idx += kThreads) {
    const int i = (int)(idx / m);
    const int k = (int)(idx - (size_t)i * m);
    if (k > r_off + i) Rt[idx] = 0.f;
  }
}

}  // namespace

// Launches the panel QR on `stream`; returns the launch's cudaError_t.
extern "C" int svdt_panel_qr(const float* Pt, float* Rt, float* Vt, float* Tt,
                             int b, int m, int r_off, void* stream) {
  // v (m) + w (b) + reduction scratch; the wrapper checks it fits
  const size_t smem = sizeof(float) * ((size_t)m + b + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_qr_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(Pt, Rt, Vt, Tt,
                                                               b, m, r_off);
  return (int)cudaGetLastError();
}
