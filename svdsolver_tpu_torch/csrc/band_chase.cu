// Band -> bidiagonal bulge chase, the whole Stage II in one launch, with or
// without recording its reflectors, on the matrix in device memory (the L2
// kernel).
//
// The sequential chase through L2: the bitwise oracle of every chase
// kernel, and the card's sequential chase for the shapes the staged TMA
// design (band_chase_staged.cu) does not take: b > 128, b or n not a
// multiple of 4, or A not 16-byte aligned (ops/cuda/band_chase.
// staged_route, decided by shape before launch), every band up to n.  For those shapes
// svdt_band_chase stands for the TPU kernels
//   svdsolver_tpu/ops/pallas/band_chase.py        _chase_kernel (K3: dense
//       matrix in HBM, one DMA'd window per pair);
//   svdsolver_tpu/ops/pallas/band_chase_stream.py _stream_chase_kernel with
//       rec=False (K5, packed band streamed through VMEM windows) where the
//       main paths' predicate picks the sequential chase;
// and svdt_band_chase_rec for their recording twins, which also emit every
// reflector for the singular-vector back-transform:
//   band_chase.py        _chase_kernel_rec (K6);
//   band_chase_stream.py _stream_chase_kernel with rec=True (K8).
// Every other shape of those TPU kernels runs svdt_band_chase_staged(_rec),
// the staged TMA design, bit-equal to this kernel.
// Both entries instantiate the one chase_pair of chase_pair.cuh (template
// flag Rec), so the recording chase's arithmetic is the very code of the
// plain one and its (d, e) are bit-equal to it.  Recording: after each
// warp_reflector, warp 0 stores the b entries of v and tau straight into
// slot (i, s) of VR/TR (right) or VL/TL (left), in the canonical
// (n-1, s_max, b) layout (Records, chase_pair.cuh), so the TPU's lane
// rotations of the records have no counterpart here.  tau is stored as
// computed, not recovered as 2/v^Tv; an identity reflector (tau = 0) is
// stored as a zero row; entries past n are zero because the reads past n
// are.  Slots the schedule never reaches, and the pairs whose window lies
// wholly past n, are left as the caller allocated them (zeros).  The
// records add 2 (b + 1) floats of stores a pair, under 1 % of the pair's
// window traffic, but warp 0 issues them before the pair's barrier: on the
// H100 (700 W) the recording entry took 865.7 ms against the plain entry's
// 850.1 ms at n = 3840, b = 128, in turns in one run of chip_smoke.py.
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
// Bands past 256 run the wide pair of chase_pair.cuh (KPL = kWide, v in
// dynamic shared memory), as the wavefront's L2 tick does: the two give the
// same (d, e) and records at every band.
//
// Design: one block of 512 threads walks the sequential schedule over the
// dense n x n matrix in device memory, in place, with the one chase_pair of
// chase_pair.cuh (dense accessor).  The window does not fit shared memory
// for every band, so only the reflector and the column partial sums are
// staged there.  Because each pair is a chain of dependent L2 round trips,
// the pair is written to put many loads in flight per round trip and to take
// few block barriers (chase_pair.cuh).  Instead of the plain version's zero
// padding, reads past n return zero and writes past n are dropped: those
// entries are zero, the reflectors over them are the identity, and the
// padding copy is saved.  512 threads, not 1024: at 1024 the 64-register cap
// spills the register chunks, and the chase at n = 3840, b = 128 took 1006 ms
// on the H100 against 845 ms at 512 threads (256 threads: 1058 ms).  Running
// sweeps 3 pairs apart concurrently (their windows are disjoint) is
// band_chase_wave.cu.
//
// svdt_band_chase_superstep is one rank's pass of one superstep of the
// pipelined chase over row-sharded ranks (parallel/distributed.py,
// band_to_bidiagonal_pipelined), its first design.  It stands for no TPU
// kernel: the JAX package runs that pass as XLA windows
// (svdsolver_tpu/parallel/distributed.py:352-392).  The pass's second
// design, a wavefront over its sweeps on the shared-memory tick
// (band_chase_superstep.cu), runs it wherever ops/cuda/band_chase.
// superstep_design takes the pass (4 <= b <= 128, b, n and the row pitch
// multiples of 4, the buffer 16-byte aligned: every pipelined geometry of
// the main paths; two sweeps a pass or more); this one runs the other
// passes (one sweep a pass among them) and is its bitwise oracle.  One block walks the pass in the order of the JAX body: sweeps
// i = i0 + l, l < LG, each sweep's head pair if lo <= i < hi, then its
// chase pairs whose start row lies in [lo, hi), lo = R0 - 3 b l, hi = R0 +
// m - 3 b l (Np on the last rank).  Every pair is the chase_pair of
// chase_pair.cuh on the rank's local buffer L (U + m + 4 b rows of Np
// floats, in place) through LocalAt, global row r at local row r - R0 + U;
// reads past n return zero and writes past n are dropped, as in the
// sequential kernel.  So on one rank (tp = 1: lo <= 0, hi = Np, every sweep
// whole and in order) its (d, e) are those of svdt_band_chase bit for bit.
// What bounds it: the same chain of dependent L2 round trips a pair as the
// sequential kernel, a pass's pairs in order on one SM; the ranks' passes
// of one superstep run at once.
#include <cuda_runtime.h>

#include "chase_pair.cuh"

namespace {

using namespace svdt;

template <int KPL, bool Rec>
__global__ void __launch_bounds__(kThreads)
band_chase_kernel(float* __restrict__ A, float* __restrict__ d,
                  float* __restrict__ e, int n, int b, Records rec) {
  __shared__ float v_narrow[kMaxBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  extern __shared__ float v_wide[];  // b floats for the wide pair
  float* v = KPL == kWide ? v_wide : v_narrow;
  const Slot none = {nullptr, nullptr};
  const DenseAt acc = {A, (size_t)n};
  for (int i = 0; i < n - 1; ++i) {
    // head pair: slot 0 (left reflector rows [i+1, i+1+b))
    chase_pair<KPL, Rec>(acc, n, b, i, i + 1, b + 1, 1, v, part, s_tau,
                         Rec ? rec.right(i, 0, b) : none,
                         Rec ? rec.left(i, 0, b) : none);
    const int nc = nc_of(i, n, b);
    for (int k = 0; k < nc; ++k) {  // chase pair k: slot k + 1
      const int r = i + 1 + k * b;
      chase_pair<KPL, Rec>(acc, n, b, r, r + b, 2 * b, b, v, part, s_tau,
                           Rec ? rec.right(i, k + 1, b) : none,
                           Rec ? rec.left(i, k + 1, b) : none);
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    d[i] = A[(size_t)i * n + i];
    if (i + 1 < n) e[i] = A[(size_t)i * n + i + 1];
  }
}

// A rank's local buffer of the pipelined chase: global row r at local row
// r + off (off = U - R0), Np floats a row.
struct LocalAt {
  float* L;
  size_t ld;
  int off;
  __device__ float load(int r, int c) const { return L[(size_t)(r + off) * ld + c]; }
  __device__ void store(int r, int c, float x) const { L[(size_t)(r + off) * ld + c] = x; }
};

template <int KPL>
__global__ void __launch_bounds__(kThreads)
superstep_kernel(float* __restrict__ L, int ld, int n, int b, int i0, int LG, int R0,
                 int U, int m, int last, int s_chase) {
  __shared__ float v_narrow[kMaxBand];
  __shared__ float part[kThreads];
  __shared__ float s_tau[2];
  extern __shared__ float v_wide[];  // b floats for the wide pair
  float* v = KPL == kWide ? v_wide : v_narrow;
  const Slot none = {nullptr, nullptr};
  const LocalAt acc = {L, (size_t)ld, U - R0};
  for (int l = 0; l < LG; ++l) {
    const int i = i0 + l;
    if (i > n - 2) break;
    const int lo = R0 - 3 * b * l;
    const int hi = last ? ld : R0 + m - 3 * b * l;
    if (lo <= i && i < hi)  // head pair
      chase_pair<KPL, false>(acc, n, b, i, i + 1, b + 1, 1, v, part, s_tau, none, none);
    const int first = lo - i - 1;  // chase pair k starts at row i + 1 + k b
    const int k0 = first > 0 ? (first + b - 1) / b : 0;
    const int k1 = min(k0 + s_chase, nc_of(i, n, b));
    for (int k = k0; k < k1; ++k) {
      const int r = i + 1 + k * b;
      if (r >= hi) break;
      chase_pair<KPL, false>(acc, n, b, r, r + b, 2 * b, b, v, part, s_tau, none, none);
    }
  }
}

template <int KPL>
int launch_superstep(float* L, int ld, int n, int b, int i0, int LG, int R0, int U,
                     int m, int last, int s_chase, cudaStream_t s) {
  const size_t smem = KPL == kWide ? sizeof(float) * (size_t)b : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        superstep_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  superstep_kernel<KPL><<<1, kThreads, smem, s>>>(L, ld, n, b, i0, LG, R0, U, m, last,
                                                   s_chase);
  return (int)cudaGetLastError();
}

// The wide pair's v: dynamic shared memory of b floats.
template <int KPL, bool Rec>
int launch_one(float* A, float* d, float* e, int n, int b, Records rec,
               cudaStream_t s) {
  const size_t smem = KPL == kWide ? sizeof(float) * (size_t)b : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_chase_kernel<KPL, Rec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  band_chase_kernel<KPL, Rec><<<1, kThreads, smem, s>>>(A, d, e, n, b, rec);
  return (int)cudaGetLastError();
}

template <bool Rec>
int launch(float* A, float* d, float* e, int n, int b, Records rec,
           void* stream) {
  if (n < 2 || b < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  SVDT_BAND_DISPATCH(b, err = launch_one<KPL, Rec>(A, d, e, n, b, rec, s));
  return err;
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

// One rank's pass of one superstep of the pipelined chase on its local
// buffer L (Np = ld floats a row), in place: sweeps i0 .. i0 + LG - 1 of the
// band of order n and width b, rows [lo, hi) of each (see the top of this
// file).  Returns the launch's cudaError_t.
extern "C" int svdt_band_chase_superstep(float* L, int ld, int n, int b, int i0, int LG,
                                         int R0, int U, int m, int last, int s_chase,
                                         void* stream) {
  if (n < 2 || b < 1 || LG < 1 || ld < n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  SVDT_BAND_DISPATCH(b, err = launch_superstep<KPL>(L, ld, n, b, i0, LG, R0, U, m, last,
                                                    s_chase, s));
  return err;
}
