// Eigenvalues of the qd arrays (q, E) of a bidiagonal by shifted dqds with
// dlasq2/3/4's splitting, deflation, reversal and shift battery, the whole
// loop in one launch of one thread block.
//
// Stands for no TPU kernel: it is the counterpart of the lax.while_loop
// that XLA compiles to one device program in svdsolver_tpu/models/
// diagonalize.py:280 (dqds_svdvals; the loop at :958).  PyTorch has no
// device-side loop, and the plain version on a CUDA tensor costs a launch
// an operation.
//
// What bounds it on the H100: each sweep is one dependent chain, dd <-
// dd * (q[i+1] / (dd + E[i])) - tau (an IEEE division, two products and
// two sums a step, compiled without FMA contraction); the shift battery
// and the deflation tests are a few dozen scalar operations a sweep.
// Latency, not operations or bytes.  The chain entry svdt_dqds_chain_*
// times that recurrence alone on one thread from registers: steps times
// its ns a step is the kernel's chain bound (PERF.md).
//
// Design: one block; thread 0 runs each sweep's chain with nothing else on
// it.  The source pair (q, E) is read-only during a sweep, which writes the
// other pair (q', E'); an accepted sweep swaps the two, a failed one
// re-reads the untouched source (dlasq's ping-pong).  So the main loop
// carries only dd: q[i+1] and E[i] come from registers loaded kAhead steps
// ahead (svdt::pipelined), the stores go to the other pair, the three
// NaN-propagating minima are one running minimum and a NaN flag, and the
// last two steps, which record dn1 / dmin1 and dn / dmin, are peeled.  The
// two pairs and the accumulated shifts (5n values) live in shared memory
// where they fit (Smem = true: n <= 11,571 in float32, 5,785 in float64),
// else in a device workspace with the same layout and code.  Each
// iteration: the block tests every E below hi for negligibility,
// hard-zeroes it in both pairs and finds the split (shared-memory
// atomics), and copies the part of the window a split cut off into the
// other pair (the pairs agree outside the window); thread 0 runs the
// deflation loop, the progress guard and decides the flip; the block
// flips the source window; thread 0 picks the shift and runs the sweep
// (retries at tau + dmin, then at 0); the block adds the accepted shift to
// the window's accumulated shift.
//
// Bits: compiled with -fmad=false and IEEE division and square root, in
// the plain version's order of operations (models/diagonalize.py,
// _dqds_loop_plain), so the estimates, the sweep count and the shift-type
// histogram are bit-equal to it.
#include <cuda_runtime.h>

#include "givens.cuh"

namespace {

using svdt::Limits;
using svdt::nan_max;
using svdt::nan_min;
using svdt::pipelined;

constexpr int kThreads = 256;  // the block
constexpr int kBins = 19;  // ttype histogram, indexed by -ttype
constexpr int kAhead = 8;  // steps whose q and E are loaded ahead of the chain
// dlasq4's constants
constexpr double kCnst1 = 0.5625, kCnst2 = 1.01, kCnst3 = 1.05;

template <typename T>
struct Sweep {
  T dmin, dn, dmin1, dn1, dmin2, dn2;
  bool ok;
};

// A running torch.minimum without a branch: m the least of the values seen
// that are not NaN, nan whether any was NaN (the minimum is then NaN).
template <typename T>
struct RunMin {
  T m;
  bool nan;
  __device__ __forceinline__ void add(T x) {
    m = x < m ? x : m;  // nan_min(m, x) for a non-NaN m and x
    nan = nan | (x != x);
  }
  __device__ __forceinline__ T value() const { return nan ? Limits<T>::nan() : m; }
};

// One dqds sweep over [lo, hi] at shift tau from the source (q, E) into the
// destination (qn, En), the source untouched (a failed sweep re-reads it).
// dn1 / dn2 are the pivots at hi - 1 / hi - 2; where that step lies below lo
// the JAX package's masked step still records a value, computed here as
// there.  The main loop (steps lo .. hi - 3, whose pivots enter all three
// minima) carries only dd: q[i + 1] and E[i] come loaded kAhead steps
// ahead, the stores go to the other pair, the minima run as RunMin.  The
// last two steps, which record dn1 / dmin1 and dn / dmin, are peeled.
template <typename T>
__device__ Sweep<T> sweep(const T* __restrict__ q, const T* __restrict__ E, T* __restrict__ qn,
                          T* __restrict__ En, int lo, int hi, T tau) {
  const T tiny = Limits<T>::tiny();
  const T dd0 = q[lo] - tau;
  // the peeled steps' operands, loaded before the chain needs them
  const int i1 = hi - 2 > lo ? hi - 2 : lo;
  const T E1 = E[i1], q1 = q[i1 + 1], E0 = E[hi - 1], q0 = q[hi];
  auto masked = [&](int i) {
    const T qq = dd0 + E[i];
    return dd0 * (q[i + 1] / (qq == T(0) ? tiny : qq)) - tau;
  };
  Sweep<T> r;
  T dd = dd0;
  bool pos = true;
  RunMin<T> m{dd0, dd0 != dd0};
  auto step = [&](int i, T Ei, T qi1) {
    const T qq = dd + Ei;
    const T t = qi1 / (qq == T(0) ? tiny : qq);
    En[i] = Ei * t;
    qn[i] = qq;
    dd = dd * t - tau;
    pos = pos & (qq > T(0));
  };
  pipelined<kAhead, 0, 1>(E, q, lo, hi - 2, [&](int i, T Ei, T qi1) {
    step(i, Ei, qi1);
    m.add(dd);
  });
  r.dmin2 = m.value();
  r.dn2 = hi - 3 >= lo ? dd : (hi >= 3 ? masked(hi - 3) : dd0);
  if (hi - 2 >= lo) {
    step(hi - 2, E1, q1);
    m.add(dd);
    r.dn1 = dd;
  } else {
    r.dn1 = hi >= 2 ? masked(hi - 2) : dd0;
  }
  r.dmin1 = m.value();
  step(hi - 1, E0, q0);
  m.add(dd);
  qn[hi] = dd;
  r.dmin = m.value();
  r.dn = dd;
  r.ok = pos && r.dmin >= T(0) && isfinite(dd);
  return r;
}

template <typename T>
__device__ __forceinline__ T sq(T x) {
  return sqrt(nan_max(x, T(0)));
}

// dlasq4's norm-squared estimate from row start up to lo; valid = false on
// any E[i] > q[i].
template <typename T>
__device__ T norm_tail(const T* q, const T* E, int lo, int start, T b, T a, bool& valid) {
  const T tiny = Limits<T>::tiny();
  valid = true;
  for (int i = start; i >= lo; --i) {
    const int j = i > 0 ? i : 0;
    const T qi = nan_max(q[j], tiny);
    const T Ei = E[j];
    if (Ei > qi) {
      valid = false;
      return a;
    }
    const T bn = b * (Ei / qi);
    const T an = a + bn;
    const bool stop = T(100) * nan_max(bn, b) < an || an > T(kCnst1) || bn == T(0);
    a = an;
    b = bn;
    if (stop) break;
  }
  return a;
}

// Cases 7/8 and 10: the Rayleigh-residual refinement; gap2 is given a2v.
template <typename T, typename Gap>
__device__ T refined(T dmx, T a2f, Gap gap_of, bool& wide) {
  const T tiny = Limits<T>::tiny();
  const T b2s = sqrt(T(kCnst3) * a2f);
  const T a2v = dmx / (b2s * b2s + T(1));
  const T gap2 = gap_of(a2v);
  wide = gap2 > T(0) && gap2 > b2s * a2v;
  if (wide) return a2v * (T(1) - T(kCnst2) * a2v * (b2s / nan_max(gap2, tiny)) * b2s);
  return a2v * (T(1) - T(kCnst2) * b2s);
}

// The pairs' layout, in shared memory (Smem) or in the wrapper's device
// workspace: [q | E | q' | E' | accv], n values each.  The sweep reads one
// pair (the source) and writes the other; an accepted sweep makes the
// destination the source.  Invariant: below `dirty` the two pairs hold the
// same values, so only the window [dirty, hi] lives in the source alone.
// Whatever the block writes outside a sweep (the split's and the
// deflation's zeros) goes to both pairs, and where a split cuts the window
// the block copies the part it cut off ([dirty, lo)) into the other pair.
template <typename T, bool Smem>
__global__ void __launch_bounds__(kThreads)
dqds_kernel(const T* q0, const T* E0, T* out, T* work, int n, int max_sweeps,
            long long* info) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_go, s_hi, s_lo, s_flip, s_sweep, s_ok, s_cur, s_dirty;
  __shared__ T s_tau;
  __shared__ int th[kBins];
  const int tid = threadIdx.x, nt = kThreads;
  T* const base = Smem ? reinterpret_cast<T*>(smem) : work;
  T* const accv = base + 4 * (size_t)n;
  for (int i = tid; i < n; i += nt) {
    base[i] = base[2 * (size_t)n + i] = q0[i];
    base[n + i] = base[3 * (size_t)n + i] = E0[i];
    accv[i] = T(0);
  }
  const T eps = Limits<T>::eps(), tiny = Limits<T>::tiny(), zero = T(0);
  const T tol2 = (T(100) * eps) * (T(100) * eps);
  const T eps2 = eps * eps;
  const T f4 = T(4) * eps + T(1);
  // thread 0's state: the previous sweep's pivot statistics and shift type
  int hi = n - 1, hi_in = hi, it = 0, since = 0, tt = 0;
  long long steps = 0;  // the dqds steps of every sweep run, retries included
  bool stuck = false;
  T dmin = zero, dn = zero, dm1 = zero, dn1v = zero, dm2 = zero, dn2v = zero;
  T g = T(0.25);
  if (tid == 0) {
    s_go = max_sweeps > 0;
    s_hi = hi;
    s_lo = 0;
    s_cur = 0;
    s_dirty = n;
  }
  for (int i = tid; i < kBins; i += nt) th[i] = 0;
  __syncthreads();
  while (s_go) {
    const int cur = s_cur;
    T* const q = base + 2 * (size_t)cur * n;  // the source pair
    T* const E = q + n;
    T* const qo = base + 2 * (size_t)(1 - cur) * n;  // the other pair
    T* const Eo = qo + n;
    // split: hard-zero every negligible E below hi (in both pairs); lo is
    // one past the last
    {
      const int h = s_hi;
      int llo = 0;
      for (int i = tid; i < h; i += nt) {
        if (E[i] <= tol2 * accv[i] + eps2 * nan_max(q[i], q[i + 1]) + tiny) {
          E[i] = zero;
          Eo[i] = zero;
          llo = i + 1;
        }
      }
      if (llo > 0) atomicMax(&s_lo, llo);
    }
    __syncthreads();
    const int lo = s_lo, dirty = s_dirty;
    if (dirty < lo) {  // the split cut [dirty, lo) off the window: both pairs take it
      for (int i = dirty + tid; i < lo; i += nt) {
        qo[i] = q[i];
        Eo[i] = E[i];
      }
      __syncthreads();
    }
    if (tid == 0) {
      hi_in = hi;
      // dlasq3's deflation loop
      while (hi >= 0) {
        const int him1 = hi - 1 > 0 ? hi - 1 : 0, him2 = hi - 2 > 0 ? hi - 2 : 0;
        const T qh = q[hi], q1 = q[him1], q2 = q[him2];
        const T e1 = E[him1], e2 = E[him2], ah = accv[hi];
        if (hi == lo || e1 <= tol2 * (ah + qh) || e1 <= tol2 * q1 ||
            e1 <= eps2 * nan_max(qh, q1) + tiny) {
          out[hi] = qh + ah;
          E[him1] = zero;
          Eo[him1] = zero;
          hi -= 1;
          continue;
        }
        if (hi - 1 < lo || !(hi - 1 == lo || e2 <= tol2 * ah || e2 <= tol2 * q2 ||
                             e2 <= eps2 * nan_max(q1, q2) + tiny))
          break;
        // exact trailing-2x2 deflation (dlasq3 label 40)
        const T bs = nan_min(q1, qh), as_ = nan_max(q1, qh);
        const T t = T(0.5) * ((as_ - bs) + e1);
        const T tm = nan_max(t, tiny);
        const T s0 = bs * (e1 / tm);
        const T s1 = s0 <= t ? bs * (e1 / nan_max(t * (sqrt(s0 / tm + T(1)) + T(1)), tiny))
                             : bs * (e1 / nan_max(t + sqrt(t) * sqrt(t + s0), tiny));
        const T tbig = as_ + (s1 + e1);
        const bool refine = e1 > bs * tol2 && t != zero;
        out[hi] = (refine ? bs * (as_ / nan_max(tbig, tiny)) : bs) + ah;
        out[him1] = (refine ? tbig : as_) + accv[him1];
        E[him1] = zero;
        E[him2] = zero;
        Eo[him1] = zero;
        Eo[him2] = zero;
        hi -= 2;
      }
      since = hi < hi_in ? 0 : since + 1;
      stuck = stuck || since > 60;
      // dlasq2's CBIAS flip; the pivot stats describe the old orientation
      const bool flip = hi - lo >= 2 && T(1.5) * q[lo] < q[hi];
      if (flip) {
        dmin = dn = dm1 = dn1v = dm2 = dn2v = zero;
        tt = 0;
      }
      s_flip = flip;
      s_sweep = hi - lo >= 1;
      s_hi = hi;
    }
    __syncthreads();
    const int h = s_hi;
    if (s_flip) {  // reverse the source's q[lo..h] and E[lo..h-1]
      for (int i = lo + tid; i < lo + (h - lo + 1) / 2; i += nt) {
        const T x = q[i];
        q[i] = q[lo + h - i];
        q[lo + h - i] = x;
      }
      for (int i = lo + tid; i < lo + (h - lo) / 2; i += nt) {
        const T x = E[i];
        E[i] = E[lo + h - 1 - i];
        E[lo + h - 1 - i] = x;
      }
      __syncthreads();
    }
    if (tid == 0) {
      // the pairs agree below lo now; a flip or an accepted sweep leaves
      // [lo, hi] in the source alone
      int dirty_next = dirty > lo ? dirty : lo;
      if (s_flip) dirty_next = lo;
      s_ok = 0;
      if (s_sweep) {
        // ---- shift: dlasq4's battery, dispatched on the eigenvalues deflated
        // since the last sweep and where its least pivot was
        const int ndefl = hi_in - hi < 2 ? hi_in - hi : 2;
        const int him1 = hi - 1 > 0 ? hi - 1 : 0, him2 = hi - 2 > 0 ? hi - 2 : 0,
                  him3 = hi - 3 > 0 ? hi - 3 : 0;
        const bool at_dn = dn <= dmin * f4, at_dn1 = dn1v <= dmin * f4,
                   at_dn2 = dn2v <= dmin * f4, m1_at = dn1v <= dm1 * f4,
                   m2_at = dn2v <= dm2 * f4;
        T tau, gn = g;
        int ttn;
        bool valid;
        if (ndefl == 0 && at_dn && m1_at) {  // cases 2/3: the twisted asymptotic
          const T b1 = sq(q[hi]) * sq(E[him1]);
          const T b2 = sq(q[him1]) * sq(E[him2]);
          const T a2 = q[him1] + E[him1];
          const T gap2 = dm2 - a2 - T(0.25) * dm2;
          const T gap1 = gap2 > zero && gap2 > b2 ? a2 - dn - (b2 / gap2) * b2
                                                  : a2 - dn - (b1 + b2);
          const T s2 = nan_max(dn - (b1 / nan_max(gap1, tiny)) * b1, T(0.5) * dmin);
          T s3 = dn > b1 ? dn - b1 : zero;
          if (a2 > b1 + b2) s3 = nan_min(s3, a2 - (b1 + b2));
          s3 = nan_max(s3, dmin / T(3));
          const bool use2 = gap1 > zero && gap1 > b1;
          tau = use2 ? s2 : s3;
          ttn = use2 ? -2 : -3;
        } else if (ndefl == 0 && (at_dn || at_dn1)) {  // case 4
          T gam, b2i, a2i;
          int start;
          bool pre_ok;
          if (at_dn) {
            gam = dn;
            b2i = E[him1] / nan_max(q[him1], tiny);
            a2i = b2i;
            start = hi - 2;
            pre_ok = E[him1] <= q[him1];
          } else {
            gam = dn1v;
            b2i = E[him2] / nan_max(q[him2], tiny);
            a2i = E[him1] / nan_max(q[hi], tiny) + b2i;
            start = hi - 3;
            pre_ok = E[him1] <= q[hi] && E[him2] <= q[him2];
          }
          T a2f = norm_tail(q, E, lo, start, b2i, a2i, valid);
          a2f = T(kCnst3) * a2f;
          tau = pre_ok && valid && a2f < T(kCnst1) ? gam * (T(1) - sqrt(a2f)) / (a2f + T(1))
                                                    : T(0.25) * dmin;
          ttn = -4;
        } else if (ndefl == 0 && at_dn2) {  // case 5
          const bool pre_ok = E[him2] <= q[him1] && E[him1] <= q[hi];
          const T a2i = (E[him1] / nan_max(q[hi], tiny)) *
                        (E[him2] / nan_max(q[him1], tiny) + T(1));
          T a2f = a2i;
          valid = true;
          if (hi - lo > 2) {
            const T b2i = E[him3] / nan_max(q[him3], tiny);
            a2f = T(kCnst3) * norm_tail(q, E, lo, hi - 4, b2i, a2i + b2i, valid);
          }
          tau = pre_ok && valid && a2f < T(kCnst1) ? dn2v * (T(1) - sqrt(a2f)) / (a2f + T(1))
                                                    : T(0.25) * dmin;
          ttn = -5;
        } else if (ndefl == 0) {  // case 6: g * dmin with dlasq4's G history
          gn = tt == -6 ? g + (T(1) - g) / T(3) : (tt == -18 ? T(1.0 / 12.0) : T(0.25));
          tau = gn * dmin;
          ttn = -6;
        } else if (ndefl == 1 && m1_at && m2_at) {  // cases 7/8
          const T s0 = dm1 / T(3);
          const bool pre_ok = E[him1] <= q[him1];
          const T b0 = E[him1] / nan_max(q[him1], tiny);
          const T a2f = norm_tail(q, E, lo, hi - 2, b0, b0, valid);
          bool wide;
          const T ref = refined(dm1, a2f, [&](T a2v) { return T(0.5) * dm2 - a2v; }, wide);
          tau = pre_ok && valid ? nan_max(s0, ref) : s0;
          ttn = wide ? -7 : -8;
        } else if (ndefl == 1) {  // case 9
          tau = m1_at ? T(0.5) * dm1 : T(0.25) * dm1;
          ttn = -9;
        } else if (m2_at && T(2) * E[him1] < q[him1]) {  // case 10
          const T s0 = dm2 / T(3);
          const bool pre_ok = E[him1] <= q[him1];
          const T b0 = E[him1] / nan_max(q[him1], tiny);
          const T a2f = norm_tail(q, E, lo, hi - 2, b0, b0, valid);
          bool wide;
          const T ref = refined(
              dm2, a2f,
              [&](T a2v) { return q[him1] + E[him2] - sq(q[him2]) * sq(E[him2]) - a2v; }, wide);
          tau = pre_ok && valid ? nan_max(s0, ref) : s0;
          ttn = -10;
        } else {  // case 11
          tau = T(0.25) * dm2;
          ttn = -11;
        }
        tau = nan_max(zero, tau);
        // the sweep; on failure retry from the untouched source at tau +
        // dmin, then at 0
        Sweep<T> r = sweep(q, E, qo, Eo, lo, hi, tau);
        steps += hi - lo;
        if (!r.ok) {
          tau = nan_max(zero, tau + r.dmin);
          r = sweep(q, E, qo, Eo, lo, hi, tau);
          steps += hi - lo;
          ttn = -18;
          if (!r.ok) {
            tau = zero;
            r = sweep(q, E, qo, Eo, lo, hi, tau);
            steps += hi - lo;
            ttn = 0;
          }
        }
        if (r.ok) {
          dmin = r.dmin;
          dn = r.dn;
          dm1 = r.dmin1;
          dn1v = r.dn1;
          dm2 = r.dmin2;
          dn2v = r.dn2;
          s_tau = tau;
          s_ok = 1;
          s_cur = 1 - cur;
          dirty_next = lo;
        } else {
          ttn = 0;
          stuck = true;
        }
        th[-ttn < kBins - 1 ? -ttn : kBins - 1] += 1;
        tt = ttn;
        g = gn;
      }
      it += 1;
      s_go = hi >= 0 && it < max_sweeps && !stuck;
      s_lo = 0;
      s_dirty = dirty_next;
    }
    __syncthreads();
    if (s_ok) {  // the accepted shift joins the window's accumulated shift
      const T tau = s_tau;
      for (int i = lo + tid; i <= h; i += nt) accv[i] = accv[i] + tau;
    }
    __syncthreads();
  }
  // flush the estimates of an unconverged window: q + accumulated shift
  const int h = s_hi;
  const T* q = base + 2 * (size_t)s_cur * n;
  for (int i = tid; i <= h; i += nt) out[i] = q[i] + accv[i];
  if (tid == 0) {
    info[0] = hi;
    info[1] = it;
    info[2] = steps;
  }
  for (int i = tid; i < kBins; i += nt) info[3 + i] = th[i];
}

// Dynamic shared memory: the two pairs and accv (5n values) in the Smem
// instance, none in the device-memory one.
template <typename T>
int launch(const T* q, const T* E, T* out, T* work, int n, int max_sweeps, long long* info,
           int smem, cudaStream_t stream) {
  const size_t bytes = smem ? sizeof(T) * 5 * (size_t)n : 0;
  auto kernel = smem ? dqds_kernel<T, true> : dqds_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kThreads, bytes, stream>>>(q, E, out, work, n, max_sweeps, info);
  return (int)cudaGetLastError();
}

// The chain bound: `steps` (a multiple of kChainVals) steps of the sweep's
// dependent recurrence dd <- dd * (q / (dd + E)) - tau on one thread, every
// operand in registers (kChainVals q in [1, 2) and E in [0.25, 0.5) cycled,
// so dd stays positive), nothing stored but the final dd.  The stores, the
// minima and the positivity flag a sweep keeps off its chain are left out.
constexpr int kChainVals = 8;

template <typename T>
__global__ void dqds_chain_kernel(T* out, long long steps) {
  T qv[kChainVals], Ev[kChainVals];
#pragma unroll
  for (int j = 0; j < kChainVals; ++j) {
    qv[j] = T(1) + T(j) / T(kChainVals);
    Ev[j] = T(0.25) + T(j) / T(4 * kChainVals);
  }
  const T tiny = Limits<T>::tiny(), tau = T(0.01);
  T dd = T(1);
  for (long long k = 0; k < steps; k += kChainVals) {
#pragma unroll
    for (int j = 0; j < kChainVals; ++j) {
      const T qq = dd + Ev[j];
      const T t = qv[j] / (qq == T(0) ? tiny : qq);
      dd = dd * t - tau;
    }
  }
  out[0] = dd;
}

template <typename T>
int launch_chain(T* out, long long steps, cudaStream_t stream) {
  dqds_chain_kernel<T><<<1, 1, 0, stream>>>(out, steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int svdt_dqds_f32(const float* q, const float* E, float* out, float* work, int n,
                  int max_sweeps, long long* info, int smem, cudaStream_t stream) {
  return launch<float>(q, E, out, work, n, max_sweeps, info, smem, stream);
}

int svdt_dqds_f64(const double* q, const double* E, double* out, double* work, int n,
                  int max_sweeps, long long* info, int smem, cudaStream_t stream) {
  return launch<double>(q, E, out, work, n, max_sweeps, info, smem, stream);
}

int svdt_dqds_chain_f32(float* out, long long steps, cudaStream_t stream) {
  return launch_chain<float>(out, steps, stream);
}

int svdt_dqds_chain_f64(double* out, long long steps, cudaStream_t stream) {
  return launch_chain<double>(out, steps, stream);
}

}  // extern "C"
