// Singular values of a bidiagonal {d, e} by implicit-shift QR with
// deflation, the whole loop in one launch of one thread block.
//
// Stands for no TPU kernel: it is the counterpart of the loops that XLA
// compiles to one device program in svdsolver_tpu/models/diagonalize.py
// (zero_shift_sweep :27, shifted_sweep :145, diag_reduce_fixed_iter :68,
// convergence_threshold :80, the lax.while_loop of _qr_diag_chunk :186).
// PyTorch has no device-side loop: the plain version on a CUDA tensor issues
// about ten launches a Givens step, hours at n = 3840.
//
// What bounds it on the H100: one dependent chain of Givens steps a sweep,
// two rotations a step, each a division, a square root and two more
// divisions (IEEE, so multi-instruction sequences): latency, not
// operations or bytes.  The card's issue rate is nearly unused by that.
// The chain entry svdt_bidiag_qr_chain_* times a zero-shift and a shifted
// step's recurrence alone on one thread from registers: the steps of a
// run times those ns a step are its chain bound (PERF.md).
//
// Design: one block; thread 0 runs each sweep's chain with no memory
// round trip and no branch on it.  A step's d and e come from registers
// loaded kAhead steps ahead (svdt::pipelined); the values a step hands the
// next (d[i+1], e[i+1] of the shifted sweep, d[k+1] of the zero-shift one)
// stay in registers, and each value is stored once and never reloaded.
// givens is branch-free (selects around one division, one square root and
// two divisions), so the zero-shift sweep's two rotation chains (rot1 via
// c, rot2 via c_ and r1) may overlap.  d and e live in shared memory where
// they fit beside the threshold's reduction (Smem = true: n <= 28,672 in
// float32, 14,208 in float64 at 256 threads), in device memory otherwise
// (the wrapper decides by shape); the two instances run the same code and
// give the same bits.  Between sweeps the block finds the live entries
// (|e| > thresh), hard-zeroes the dead ones and locates the bottom-most
// unreduced block [lo, hi] with two strided passes and shared-memory
// atomics (kThreads threads: 14 % faster than thread 0 doing the passes
// alone at n = 3840, PERF.md).  The threshold (convergence_threshold, with
// its absolute floor) is the prologue: thread 0 runs the mu recurrence,
// another thread the lambda recurrence, the block takes the maxima.
//
// Bits: compiled with -fmad=false and IEEE division and square root, in
// the plain version's order of operations (models/diagonalize.py), so d, e,
// the threshold and sigma are bit-equal to it; min / max propagate NaN as
// torch.minimum / torch.maximum do.
#include <cuda_runtime.h>

#include "givens.cuh"

namespace {

using svdt::givens;
using svdt::Limits;
using svdt::nan_max;
using svdt::nan_min;
using svdt::pipelined;

constexpr int kThreads = 256;  // the converged driver's block

constexpr int kAhead = 8;  // steps whose d and e are loaded ahead of the chain

// One zero-shift sweep on d[lo..hi] (diagonalize.py:27).  Step k takes the
// original e[k] and d[k + 1] (loaded ahead) and stores e[k - 1] and d[k]
// once; d[k] is carried from step k - 1 in a register.  rot1's chain (via
// c) and rot2's (via c_ and r1) are independent but for r1 / s1, so the
// compiler may overlap step k + 1's rot1 with step k's rot2.
template <typename T>
__device__ void zero_shift_sweep(T* __restrict__ d, T* __restrict__ e, int lo, int hi) {
  if (hi <= lo) return;
  T c = T(1), c_ = T(1), s_ = T(0);
  T dk = d[lo];
  auto step = [&](int k, T ek, T dk1, bool store_e) {
    T c1, s1, r1, c2, s2, r2;
    givens(c * dk, ek, c1, s1, r1);
    if (store_e) e[k - 1] = r1 * s_;
    givens(c_ * r1, dk1 * s1, c2, s2, r2);
    d[k] = r2;
    c = c1;
    c_ = c2;
    s_ = s2;
    dk = dk1;
  };
  step(lo, e[lo], d[lo + 1], false);
  pipelined<kAhead, 0, 1>(e, d, lo + 1, hi,
                          [&](int k, T ek, T dk1) { step(k, ek, dk1, true); });
  const T h = c * dk;
  e[hi - 1] = h * s_;
  d[hi] = h * c_;
}

// One shifted sweep on d[lo..hi] (diagonalize.py:145, dbdsqr's forward path).
// Step i takes the original d[i + 1] and e[i + 1] (loaded ahead) and the
// current d[i] and e[i] from step i - 1 in registers; it stores d[i] and
// e[i - 1] once and reloads nothing.
template <typename T>
__device__ void shifted_sweep(T* __restrict__ d, T* __restrict__ e, int lo, int hi, T shift) {
  if (hi <= lo) return;
  const T dl = d[lo];
  const T sgn = dl >= T(0) ? T(1) : T(-1);
  T f = (fabs(dl) - shift) * (sgn + shift / (dl == T(0) ? T(1) : dl));
  T g = e[lo];
  T di = dl, ei = g;  // the current d[i] and e[i]
  // has_next: i < hi - 1, so e[i + 1] exists and feeds g
  auto step = [&](int i, T di1, T ei1, bool store_e, bool has_next) {
    T cosr, sinr, r, cosl, sinl, r2;
    givens(f, g, cosr, sinr, r);
    if (store_e) e[i - 1] = r;
    const T f2 = cosr * di + sinr * ei;
    const T ei_new = cosr * ei - sinr * di;
    const T g2 = sinr * di1;
    const T di1_a = cosr * di1;
    givens(f2, g2, cosl, sinl, r2);
    d[i] = r2;
    f = cosl * ei_new + sinl * di1_a;
    di = cosl * di1_a - sinl * ei_new;
    if (has_next) {
      g = sinl * ei1;
      ei = cosl * ei1;
    }
  };
  if (hi - lo == 1) {
    step(lo, d[hi], T(0), false, false);
  } else {
    step(lo, d[lo + 1], e[lo + 1], false, true);
    pipelined<kAhead, 1, 1>(d, e, lo + 1, hi - 1,
                            [&](int i, T di1, T ei1) { step(i, di1, ei1, true, true); });
    step(hi - 1, d[hi], T(0), true, false);
  }
  e[hi - 1] = f;
  d[hi] = di;
}

// Smaller singular value of [[f, g], [0, h]] (dlas2-style): the shift.
template <typename T>
__device__ T sigma_min_2x2(T f, T g, T h) {
  const T fa = fabs(f), ga = fabs(g), ha = fabs(h);
  const T fhmn = nan_min(fa, ha), fhmx = nan_max(fa, ha);
  if (fhmn == T(0)) return T(0);
  const T safe_fhmx = fhmx == T(0) ? T(1) : fhmx;
  const T as_ = fhmn / safe_fhmx + T(1);
  const T at = (fhmx - fhmn) / safe_fhmx;
  if (ga <= fhmx) {
    const T x = ga / safe_fhmx;
    const T au1 = x * x;
    return fhmn * (T(2) / (sqrt(as_ * as_ + au1) + sqrt(at * at + au1)));
  }
  const T safe_ga = ga == T(0) ? T(1) : ga;
  const T au2 = fhmx / safe_ga;
  if (au2 == T(0)) return fhmn * fhmx / safe_ga;
  const T y = as_ * au2, z = at * au2;
  const T c2 = T(1) / (sqrt(y * y + T(1)) + sqrt(z * z + T(1)));
  return (fhmn * c2) * au2 * T(2);
}

// Copy d, e into shared memory (Smem) or work on them where they are.
template <typename T, bool Smem>
__device__ void stage_in(T*& d, T*& e, T* dg, T* eg, int n, unsigned char* smem) {
  if (Smem) {
    d = reinterpret_cast<T*>(smem);
    e = d + n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = dg[i];
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) e[i] = eg[i];
    __syncthreads();
  } else {
    d = dg;
    e = eg;
  }
}

template <typename T, bool Smem>
__device__ void stage_out(const T* d, const T* e, T* dg, T* eg, int n) {
  if (Smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) dg[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) eg[i] = e[i];
  }
}

// Entry (a): n_iter zero-shift sweeps on [lo, hi], or one shifted sweep
// when shift is given.
template <typename T, bool Smem>
__global__ void __launch_bounds__(kThreads)
qr_sweeps_kernel(T* dg, T* eg, int n, int lo, int hi, int n_iter, const T* shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  T *d, *e;
  stage_in<T, Smem>(d, e, dg, eg, n, smem);
  if (threadIdx.x == 0) {
    if (shift != nullptr) {
      shifted_sweep(d, e, lo, hi, *shift);
    } else {
      for (int k = 0; k < n_iter; ++k) zero_shift_sweep(d, e, lo, hi);
    }
  }
  stage_out<T, Smem>(d, e, dg, eg, n);
}

// convergence_threshold (diagonalize.py:80): max(tol * lbound, floor, tiny).
template <typename T>
__device__ T threshold(const T* d, const T* e, int n, T tol_factor, T* red) {
  const int tid = threadIdx.x, nt = kThreads;
  const int lam_thread = 32;  // another warp
  __shared__ T s_mu, s_lam;
  if (tid == 0) {  // mu[j+1] = |d[j+1]| mu[j] / (mu[j] + |e[j]|)
    T mu = fabs(d[0]), m = T(0);
    for (int j = 0; j < n - 1; ++j) {
      mu = fabs(d[j + 1]) * (mu / (mu + fabs(e[j])));
      m = j == 0 ? mu : nan_min(m, mu);
    }
    s_mu = m;
  }
  if (tid == lam_thread) {  // lambda, from the bottom
    T lam = fabs(d[n - 1]), m = T(0);
    for (int j = 0; j < n - 1; ++j) {
      const int i = n - 2 - j;
      lam = fabs(d[i]) * (lam / (lam + fabs(e[i])));
      m = j == 0 ? lam : nan_min(m, lam);
    }
    s_lam = m;
  }
  // max |d| and max(|e|, 0 * |e[0]|)
  T md = fabs(d[0]), me = T(0) * fabs(e[0]);
  for (int i = tid; i < n; i += nt) md = nan_max(md, fabs(d[i]));
  for (int i = tid; i < n - 1; i += nt) me = nan_max(me, fabs(e[i]));
  red[tid] = md;
  red[nt + tid] = me;
  __syncthreads();
  __shared__ T s_thresh;
  if (tid == 0) {
    for (int t = 1; t < nt; ++t) {
      md = nan_max(md, red[t]);
      me = nan_max(me, red[nt + t]);
    }
    const T eps = Limits<T>::eps(), tiny = Limits<T>::tiny();
    const T lbound = nan_min(nan_min(s_mu, fabs(d[0])), nan_min(s_lam, fabs(d[n - 1])));
    const T floor = (T(0.5) * eps) * (md + me);
    s_thresh = nan_max(nan_max((tol_factor * eps) * lbound, floor), tiny);
  }
  __syncthreads();
  return s_thresh;
}

// Entry (b): the deflation loop of _qr_diag_chunk to convergence or
// max_sweeps more sweeps; info[0] += sweeps run, info[1] = converged,
// info[2] / info[3] += the Givens steps of its zero-shift / shifted sweeps
// (the work its bound counts).
// compute_thresh: the threshold is computed here and stored to *thresh,
// else read from it (a later chunk).
template <typename T, bool Smem>
__global__ void __launch_bounds__(kThreads)
qr_converge_kernel(T* dg, T* eg, int n, T* thresh, int compute_thresh, T tol_factor,
                   int max_sweeps, long long* info) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_hi_e, s_lo;
  T* red = reinterpret_cast<T*>(smem);  // 2 * kThreads, then d and e (Smem)
  T *d, *e;
  stage_in<T, Smem>(d, e, dg, eg, n, smem + 2 * kThreads * sizeof(T));
  const int tid = threadIdx.x, nt = kThreads;
  T thr;
  if (compute_thresh) {
    thr = threshold(d, e, n, tol_factor, red);
    if (tid == 0) *thresh = thr;
  } else {
    thr = *thresh;
  }
  const T eps = Limits<T>::eps();
  if (tid == 0) {
    s_hi_e = -1;
    s_lo = 0;
  }
  __syncthreads();
  int it = 0, hi_e;
  long long steps_zero = 0, steps_shift = 0;  // thread 0's
  for (;;) {
    // the last live entry (ascending strides: a thread's last hit is its max)
    int loc = -1;
    for (int i = tid; i < n - 1; i += nt)
      if (fabs(e[i]) > thr) loc = i;
    if (loc >= 0) atomicMax(&s_hi_e, loc);
    __syncthreads();
    hi_e = s_hi_e;
    if (hi_e < 0 || it >= max_sweeps) break;
    // hard-zero every dead entry; lo is one past the last dead one below hi_e
    int llo = 0;
    for (int i = tid; i < n - 1; i += nt) {
      if (!(fabs(e[i]) > thr)) {
        e[i] = T(0);
        if (i < hi_e) llo = i + 1;
      }
    }
    if (llo > 0) atomicMax(&s_lo, llo);
    __syncthreads();
    if (tid == 0) {
      const int lo = s_lo, hi = hi_e + 1;
      const T shift = sigma_min_2x2(d[hi - 1], e[hi_e], d[hi]);
      const T sll = fabs(d[lo]);
      const T x = shift / (sll == T(0) ? T(1) : sll);
      if (sll == T(0) || x * x < eps) {
        zero_shift_sweep(d, e, lo, hi);
        steps_zero += hi - lo;
      } else {
        shifted_sweep(d, e, lo, hi, shift);
        steps_shift += hi - lo;
      }
      s_hi_e = -1;  // every thread read it before the barrier above
      s_lo = 0;
    }
    ++it;
    __syncthreads();
  }
  if (tid == 0) {
    info[0] += it;
    info[1] = hi_e < 0;
    info[2] += steps_zero;
    info[3] += steps_shift;
  }
  stage_out<T, Smem>(d, e, dg, eg, n);
}

// The chain bound: `steps` (a multiple of kChainVals) steps of one sweep's
// dependent recurrence on one thread, every operand in registers (kChainVals
// d and e values cycled, d in [1, 2) above e in [0.25, 0.5) so the
// rotations stay away from zeros and overflow), nothing stored but the final
// state.  kind 0: zero-shift steps (both rotations, rot1's chain overlapping
// rot2's as in zero_shift_sweep); 1: shifted steps.  The stores a sweep
// makes and the values only they take are left out.
constexpr int kChainVals = 8;

template <typename T>
__global__ void qr_chain_kernel(T* out, long long steps, int kind) {
  T dv[kChainVals], ev[kChainVals];
#pragma unroll
  for (int j = 0; j < kChainVals; ++j) {
    dv[j] = T(1) + T(j) / T(kChainVals);
    ev[j] = T(0.25) + T(j) / T(4 * kChainVals);
  }
  if (kind == 0) {
    T c = T(1), c_ = T(1), s_ = T(0), dk = dv[kChainVals - 1];
    for (long long k = 0; k < steps; k += kChainVals) {
#pragma unroll
      for (int j = 0; j < kChainVals; ++j) {
        T c1, s1, r1, c2, s2, r2;
        givens(c * dk, ev[j], c1, s1, r1);
        givens(c_ * r1, dv[j] * s1, c2, s2, r2);
        c = c1;
        c_ = c2;
        s_ = s2;
        dk = dv[j];
      }
    }
    out[0] = c;
    out[1] = c_;
    out[2] = s_;
    out[3] = dk;
  } else {
    T f = dv[0], g = ev[0], di = dv[0], ei = ev[0];
    for (long long k = 0; k < steps; k += kChainVals) {
#pragma unroll
      for (int j = 0; j < kChainVals; ++j) {
        T cosr, sinr, r, cosl, sinl, r2;
        givens(f, g, cosr, sinr, r);
        const T f2 = cosr * di + sinr * ei;
        const T ei_new = cosr * ei - sinr * di;
        const T g2 = sinr * dv[j];
        const T di1_a = cosr * dv[j];
        givens(f2, g2, cosl, sinl, r2);
        f = cosl * ei_new + sinl * di1_a;
        di = cosl * di1_a - sinl * ei_new;
        g = sinl * ev[j];
        ei = cosl * ev[j];
      }
    }
    out[0] = f;
    out[1] = g;
    out[2] = di;
    out[3] = ei;
  }
}

// Dynamic shared memory: the threshold's reduction (2 values a thread),
// then d and e in the Smem instance.
template <typename T>
size_t smem_bytes(int n, int smem) {
  return sizeof(T) * (2 * (size_t)kThreads + (smem ? 2 * (size_t)n : 0));
}

template <typename T>
int launch_sweeps(T* d, T* e, int n, int lo, int hi, int n_iter, const T* shift, int smem,
                  cudaStream_t stream) {
  const size_t bytes = smem ? sizeof(T) * 2 * (size_t)n : 0;
  auto kernel = smem ? qr_sweeps_kernel<T, true> : qr_sweeps_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, bytes, stream>>>(d, e, n, lo, hi, n_iter, shift);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_converge(T* d, T* e, int n, T* thresh, int compute_thresh, double tol_factor,
                    int max_sweeps, long long* info, int smem, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(n, smem);
  auto kernel = smem ? qr_converge_kernel<T, true> : qr_converge_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kThreads, bytes, stream>>>(d, e, n, thresh, compute_thresh, (T)tol_factor,
                                         max_sweeps, info);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain(T* out, long long steps, int kind, cudaStream_t stream) {
  qr_chain_kernel<T><<<1, 1, 0, stream>>>(out, steps, kind);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int svdt_bidiag_qr_sweeps_f32(float* d, float* e, int n, int lo, int hi, int n_iter,
                              const float* shift, int smem, cudaStream_t stream) {
  return launch_sweeps<float>(d, e, n, lo, hi, n_iter, shift, smem, stream);
}

int svdt_bidiag_qr_sweeps_f64(double* d, double* e, int n, int lo, int hi, int n_iter,
                              const double* shift, int smem, cudaStream_t stream) {
  return launch_sweeps<double>(d, e, n, lo, hi, n_iter, shift, smem, stream);
}

int svdt_bidiag_qr_converge_f32(float* d, float* e, int n, float* thresh, int compute_thresh,
                                double tol_factor, int max_sweeps, long long* info,
                                int smem, cudaStream_t stream) {
  return launch_converge<float>(d, e, n, thresh, compute_thresh, tol_factor, max_sweeps, info,
                                smem, stream);
}

int svdt_bidiag_qr_converge_f64(double* d, double* e, int n, double* thresh,
                                int compute_thresh, double tol_factor, int max_sweeps,
                                long long* info, int smem, cudaStream_t stream) {
  return launch_converge<double>(d, e, n, thresh, compute_thresh, tol_factor, max_sweeps,
                                 info, smem, stream);
}

int svdt_bidiag_qr_chain_f32(float* out, long long steps, int kind, cudaStream_t stream) {
  return launch_chain<float>(out, steps, kind, stream);
}

int svdt_bidiag_qr_chain_f64(double* out, long long steps, int kind, cudaStream_t stream) {
  return launch_chain<double>(out, steps, kind, stream);
}

}  // extern "C"
