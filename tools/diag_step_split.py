"""Split a diagonalizer step's time on the card: the sweeps of
``csrc/dqds.cu`` and ``csrc/bidiag_qr.cu`` timed alone, beside variants
that each drop or change one ingredient.

    python3 tools/diag_step_split.py [--n 3840] [--path] [--lanes] [--sass]

Writes ``build/diag_step_split/bench.cu``, which includes both sources
(their sweep functions, unchanged) and defines copies of the sweeps with
one change each, builds it with the package's flags (``-fmad=false``,
``sm_90a``) and runs each variant on one thread over one window [0, n - 1]
of positive data (q, d in [1, 2), E, e in [0.25, 0.5); dqds at tau = 0,
the shifted QR sweep at shift 0.1), ``reps`` times, with the operands in
shared memory as the kernels keep them at these n.  Each rep reads the same
input (dqds sweeps from one pair into the other; the QR sweeps start from
a fresh copy, not timed).  Prints clock64 cycles a step and ns a step
(cycles over the SM clock, read as a clock64 spin against CUDA events).
The variants:

* dqds: ``design`` (the kernel's sweep), ``no-stats`` (no minima, NaN
  flag or positivity in the loop), ``no-stores``, ``ahead4`` / ``ahead16``
  (operands loaded 4 / 16 steps ahead), ``chain`` (the recurrence with its
  loads, nothing else), ``first`` (the first design's in-place sweep);
* QR: ``design`` (shifted and zero-shift sweeps), ``no-stores``,
  ``branchy`` (the first design's ``givens`` in the new sweep), ``first``
  (the first design's sweeps), ``ahead16``.

``--path`` also times the kernels themselves on the main path's
bidiagonals (``tools/diag_times.py``'s inputs, 3840 and 1000, float32 and
float64), built from patched copies of the sources in which thread 0 adds
the clock64 cycles it spends inside the sweeps, and in all, to two extra
``info`` entries: ns a step inside the sweeps on the real data, and the
rest a sweep; and times the bench's sweeps on states of the same runs at
3840 (the QR driver's (d, e) after 0, 1000 and 3000 sweeps, over its live
window; dqds over the scaled arrays).  ``--lanes`` times the designs'
sweeps in kernels with and without a block barrier (``__syncthreads``,
PTX's non-aligned ``barrier.sync``, that barrier behind a ``__noinline__``
call) and on a uniform warp.  ``--sass`` prints, for each function of the
built bench, its convergence barriers (BSSY / BSYNC), calls and block
barriers in SASS (``cuobjdump``).  Every line carries the card's name and
power limit.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from svdsolver_tpu_torch.ops.cuda import _build  # noqa: E402

OUT = REPO / "build" / "diag_step_split"

BENCH = r'''
#include "dqds.cu"
#define kThreads kThreadsQR
#define kAhead kAheadQR
#define kChainVals kChainValsQR
#define launch_chain launch_chain_qr
#include "bidiag_qr.cu"
#undef kThreads
#undef kAhead
#undef kChainVals
#undef launch_chain

namespace bench {
using svdt::Limits;
using svdt::nan_max;
using svdt::nan_min;
using svdt::pipelined;

template <typename T>
struct RunMin {
  T m;
  bool nan;
  __device__ __forceinline__ void add(T x) {
    m = x < m ? x : m;
    nan = nan | (x != x);
  }
  __device__ __forceinline__ T value() const { return nan ? Limits<T>::nan() : m; }
};

// V: 1 no-stats, 2 no-stores, 3 ahead4, 4 ahead16, 5 chain (loads + recurrence)
template <typename T, int V, int K>
__device__ T dqds_variant(const T* __restrict__ q, const T* __restrict__ E, T* __restrict__ qn,
                          T* __restrict__ En, int lo, int hi, T tau) {
  const T tiny = Limits<T>::tiny();
  T dd = q[lo] - tau;
  bool pos = true;
  RunMin<T> m{dd, dd != dd};
  pipelined<K, 0, 1>(E, q, lo, hi, [&](int i, T Ei, T qi1) {
    const T qq = dd + Ei;
    const T t = qi1 / (qq == T(0) ? tiny : qq);
    if (V != 2 && V != 5) {
      En[i] = Ei * t;
      qn[i] = qq;
    }
    dd = dd * t - tau;
    if (V != 1 && V != 5) {
      pos = pos & (qq > T(0));
      m.add(dd);
    }
  });
  return dd + m.value() + T(pos);
}

// the first design's in-place sweep (dqds.cu before its redesign)
template <typename T>
__device__ T dqds_first(T* q, T* E, int lo, int hi, T tau) {
  const T tiny = Limits<T>::tiny();
  const T dd0 = q[lo] - tau;
  T dmin = dd0, dmin1 = dd0, dmin2 = dd0, dn1 = dd0, dn2 = dd0;
  bool pos = true;
  T dd = dd0;
  for (int i = lo; i < hi; ++i) {
    const T Ei = E[i];
    const T qq = dd + Ei;
    const T t = q[i + 1] / (qq == T(0) ? tiny : qq);
    E[i] = Ei * t;
    q[i] = qq;
    dd = dd * t - tau;
    pos = pos && qq > T(0);
    dmin = nan_min(dmin, dd);
    if (i < hi - 1) dmin1 = nan_min(dmin1, dd);
    if (i < hi - 2) dmin2 = nan_min(dmin2, dd);
    if (i == hi - 2) dn1 = dd;
    if (i == hi - 3) dn2 = dd;
  }
  q[hi] = dd;
  return dd + dmin + dmin1 + dmin2 + dn1 + dn2 + T(pos);
}

// the first design's givens (branches on the data)
template <typename T>
__device__ __forceinline__ void givens_first(T f, T g, T& c, T& s, T& r) {
  if (f == T(0)) {
    c = T(0);
    s = T(1);
    r = g;
    return;
  }
  if (fabs(f) > fabs(g)) {
    const T t = g / f;
    const T tt = sqrt(t * t + T(1));
    c = T(1) / tt;
    s = t / tt;
    r = f * tt;
  } else {
    const T t = f / (g == T(0) ? T(1) : g);
    const T tt = sqrt(t * t + T(1));
    c = t / tt;
    s = T(1) / tt;
    r = g * tt;
  }
}

struct BranchFree {
  template <typename T>
  __device__ static void rot(T f, T g, T& c, T& s, T& r) { svdt::givens(f, g, c, s, r); }
};
struct Branchy {
  template <typename T>
  __device__ static void rot(T f, T g, T& c, T& s, T& r) { givens_first(f, g, c, s, r); }
};

// the new shifted sweep with a choice of rotation, stores and lookahead
template <typename T, typename G, bool Stores, int K>
__device__ void shifted_variant(T* __restrict__ d, T* __restrict__ e, int lo, int hi, T shift) {
  const T dl = d[lo];
  const T sgn = dl >= T(0) ? T(1) : T(-1);
  T f = (fabs(dl) - shift) * (sgn + shift / (dl == T(0) ? T(1) : dl));
  T g = e[lo];
  T di = dl, ei = g;
  auto step = [&](int i, T di1, T ei1, bool store_e, bool has_next) {
    T cosr, sinr, r, cosl, sinl, r2;
    G::rot(f, g, cosr, sinr, r);
    if (Stores && store_e) e[i - 1] = r;
    const T f2 = cosr * di + sinr * ei;
    const T ei_new = cosr * ei - sinr * di;
    const T g2 = sinr * di1;
    const T di1_a = cosr * di1;
    G::rot(f2, g2, cosl, sinl, r2);
    if (Stores) d[i] = r2;
    f = cosl * ei_new + sinl * di1_a;
    di = cosl * di1_a - sinl * ei_new;
    if (has_next) {
      g = sinl * ei1;
      ei = cosl * ei1;
    }
  };
  step(lo, d[lo + 1], e[lo + 1], false, true);
  pipelined<K, 1, 1>(d, e, lo + 1, hi - 1,
                     [&](int i, T di1, T ei1) { step(i, di1, ei1, true, true); });
  step(hi - 1, d[hi], T(0), true, false);
  e[hi - 1] = f;
  d[hi] = di;
}

// the first design's sweeps (bidiag_qr.cu before its redesign)
template <typename T>
__device__ void shifted_first(T* d, T* e, int lo, int hi, T shift) {
  const T dl = d[lo];
  const T sgn = dl >= T(0) ? T(1) : T(-1);
  T f = (fabs(dl) - shift) * (sgn + shift / (dl == T(0) ? T(1) : dl));
  T g = e[lo];
  for (int i = lo; i < hi; ++i) {
    T cosr, sinr, r, cosl, sinl, r2;
    givens_first(f, g, cosr, sinr, r);
    if (i > lo) e[i - 1] = r;
    const T di = d[i], ei = e[i], di1 = d[i + 1];
    const T f2 = cosr * di + sinr * ei;
    const T ei_new = cosr * ei - sinr * di;
    const T g2 = sinr * di1;
    const T di1_a = cosr * di1;
    givens_first(f2, g2, cosl, sinl, r2);
    d[i] = r2;
    e[i] = ei_new;
    f = cosl * ei_new + sinl * di1_a;
    d[i + 1] = cosl * di1_a - sinl * ei_new;
    if (i < hi - 1) {
      const T ei1 = e[i + 1];
      g = sinl * ei1;
      e[i + 1] = cosl * ei1;
    }
  }
  e[hi - 1] = f;
}

template <typename T>
__device__ void zero_first(T* d, T* e, int lo, int hi) {
  T c = T(1), c_ = T(1), s_ = T(0);
  T dk = d[lo];
  for (int k = lo; k < hi; ++k) {
    T c1, s1, r1, c2, s2, r2;
    givens_first(c * dk, e[k], c1, s1, r1);
    if (k > lo) e[k - 1] = r1 * s_;
    const T dk1 = d[k + 1];
    givens_first(c_ * r1, dk1 * s1, c2, s2, r2);
    d[k] = r2;
    c = c1;
    c_ = c2;
    s_ = s2;
    dk = dk1;
  }
  const T h = c * dk;
  e[hi - 1] = h * s_;
  d[hi] = h * c_;
}

template <typename T>
__device__ void bench_body(const T* in0, const T* in1, int n, int lo, int hi, T shift,
                           int reps, int v, long long* cycles, T* sink, unsigned char* smem) {
  T* a = reinterpret_cast<T*>(smem);  // [a0 | a1 | b0 | b1], n each
  T* a1 = a + n;
  T* b0 = a + 2 * n;
  T* b1 = a + 3 * n;
  T acc = T(0);
  long long total = 0;
  if (v == 99) {  // spin reps million cycles: the SM clock against CUDA events
    const long long c0 = clock64();
    while (clock64() - c0 < (long long)reps * 1000000) {
    }
    if (threadIdx.x == 0) cycles[0] = clock64() - c0;
    return;
  }
  for (int r = 0; r < reps; ++r) {
    for (int i = 0; i < n; ++i) {
      a[i] = in0[i];
      a1[i] = in1[i];
    }
    const long long c0 = clock64();
    switch (v) {
      case 0: {
        const auto s = sweep(a, a1, b0, b1, lo, hi, T(0));
        acc += s.dmin + s.dn + T(s.ok);
        break;
      }
      case 1: acc += dqds_variant<T, 1, 8>(a, a1, b0, b1, 0, n - 1, T(0)); break;
      case 2: acc += dqds_variant<T, 2, 8>(a, a1, b0, b1, 0, n - 1, T(0)); break;
      case 3: acc += dqds_variant<T, 0, 4>(a, a1, b0, b1, 0, n - 1, T(0)); break;
      case 4: acc += dqds_variant<T, 0, 16>(a, a1, b0, b1, 0, n - 1, T(0)); break;
      case 5: acc += dqds_variant<T, 5, 8>(a, a1, b0, b1, 0, n - 1, T(0)); break;
      case 6: acc += dqds_first(a, a1, 0, n - 1, T(0)); break;
      case 10: shifted_sweep(a, a1, lo, hi, shift); break;
      case 11: shifted_variant<T, BranchFree, false, 8>(a, a1, 0, n - 1, T(0.1)); break;
      case 12: shifted_variant<T, Branchy, true, 8>(a, a1, 0, n - 1, T(0.1)); break;
      case 13: shifted_first(a, a1, 0, n - 1, T(0.1)); break;
      case 14: shifted_variant<T, BranchFree, true, 16>(a, a1, 0, n - 1, T(0.1)); break;
      case 20: zero_shift_sweep(a, a1, lo, hi); break;
      case 21: zero_first(a, a1, 0, n - 1); break;
    }
    total += clock64() - c0;
    acc += a[n / 2] + b0[n / 2];
  }
  if (threadIdx.x == 0) {
    cycles[0] = total;
    sink[0] = acc;
  }
}

// PTX's non-aligned block barrier in a function of its own
__device__ __noinline__ void called_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

// reps runs of variant v; cycles of the runs alone.  Thread 0 runs them,
// or (warp) all of warp 0 uniformly, every lane storing the same values;
// then every thread meets one barrier: none (Sync 0), __syncthreads (1),
// or PTX's non-aligned barrier.sync (2), or that barrier in a
// __noinline__ function (3)
template <typename T, int Sync>
__global__ void bench_kernel(const T* in0, const T* in1, int n, int lo, int hi, T shift,
                             int reps, int v, int warp, long long* cycles, T* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (warp ? threadIdx.x < 32 : threadIdx.x == 0) bench_body(in0, in1, n, lo, hi, shift, reps,
                                                             v, cycles, sink, smem);
  if (Sync == 1) __syncthreads();
  if (Sync == 2) asm volatile("barrier.sync 0;" ::: "memory");
  if (Sync == 3) called_barrier();
}
}  // namespace bench

template <typename T, int Sync>
static void run_sync(const void* in0, const void* in1, int n, int lo, int hi, double shift,
                     int reps, int v, int threads, int warp, long long* cycles, void* sink) {
  const size_t bytes = sizeof(T) * 4 * (size_t)n;
  cudaFuncSetAttribute(bench::bench_kernel<T, Sync>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  bench::bench_kernel<T, Sync><<<1, threads, bytes>>>((const T*)in0, (const T*)in1, n, lo, hi,
                                                      (T)shift, reps, v, warp, cycles, (T*)sink);
}

extern "C" int bench_run(int dbl, const void* in0, const void* in1, int n, int lo, int hi,
                         double shift, int reps, int v, int threads, int warp, int sync,
                         long long* cycles, void* sink) {
  auto fn = dbl ? (sync == 0   ? run_sync<double, 0>
                   : sync == 1 ? run_sync<double, 1>
                   : sync == 2 ? run_sync<double, 2>
                               : run_sync<double, 3>)
                : (sync == 0   ? run_sync<float, 0>
                   : sync == 1 ? run_sync<float, 1>
                   : sync == 2 ? run_sync<float, 2>
                               : run_sync<float, 3>);
  fn(in0, in1, n, lo, hi, shift, reps, v, threads, warp, cycles, sink);
  return (int)cudaGetLastError();
}
'''

DQDS = {"design": 0, "no-stats": 1, "no-stores": 2, "ahead4": 3, "ahead16": 4, "chain": 5,
        "first": 6}
QR = {"shifted design": 10, "shifted no-stores": 11, "shifted branchy": 12,
      "shifted first": 13, "shifted ahead16": 14, "zero-shift design": 20,
      "zero-shift first": 21}


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "bench.cu"
    src.write_text(BENCH)
    lib = OUT / "libbench.so"
    flags = [f for f in _build._flags("dqds") if f != "-shared"]
    cmd = [_build.nvcc_path(), *flags, "-shared", "-I", str(_build.CSRC), "-o", str(lib),
           str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return lib


# thread 0's clocks in the kernels: (text, replacement) a source
CLOCKS = {
    "bidiag_qr": [
        ("  long long steps_zero = 0, steps_shift = 0;  // thread 0's\n",
         "  long long steps_zero = 0, steps_shift = 0;  // thread 0's\n"
         "  long long cyc_sweep = 0;\n  const long long cyc0 = clock64();\n"),
        ("        zero_shift_sweep(d, e, lo, hi);\n        steps_zero",
         "        { const long long c = clock64(); zero_shift_sweep(d, e, lo, hi);"
         " cyc_sweep += clock64() - c; }\n        steps_zero"),
        ("        shifted_sweep(d, e, lo, hi, shift);\n        steps_shift",
         "        { const long long c = clock64(); shifted_sweep(d, e, lo, hi, shift);"
         " cyc_sweep += clock64() - c; }\n        steps_shift"),
        ("    info[3] += steps_shift;\n",
         "    info[3] += steps_shift;\n    info[4] += cyc_sweep;\n"
         "    info[5] += clock64() - cyc0;\n"),
    ],
    "dqds": [
        ("  long long steps = 0;  // the dqds steps of every sweep run, retries included\n",
         "  long long steps = 0;  // the dqds steps of every sweep run, retries included\n"
         "  long long cyc_sweep = 0;\n  const long long cyc0 = clock64();\n"),
        ("sweep(q, E, qo, Eo, lo, hi, tau);",
         "[&] { const long long c = clock64(); const auto s_ = sweep(q, E, qo, Eo, lo, hi, tau);"
         " cyc_sweep += clock64() - c; return s_; }();"),
        ("    info[2] = steps;\n",
         "    info[2] = steps;\n    info[22] = cyc_sweep;\n    info[23] = clock64() - cyc0;\n"),
    ],
}


def build_clocked(name):
    text = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in CLOCKS[name]:
        if old not in text:
            raise RuntimeError(f"{name}.cu: the clock patch no longer applies at {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}_clocked.cu"
    src.write_text(text)
    lib = OUT / f"lib{name}_clocked.so"
    cmd = [_build.nvcc_path(), *_build._flags(name), "-I", str(_build.CSRC), "-o", str(lib),
           str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def bench(lib, x0, x1, lo, hi, shift, reps, v, threads=1, warp=0, sync=0):
    """Cycles a step of bench variant ``v`` over [lo, hi] of (x0, x1), on
    a block of ``threads`` (thread 0 runs it, or all of warp 0 with
    ``warp``) whose kernel ends in barrier ``sync`` (0 none, 1
    ``__syncthreads``, 2 the non-aligned ``barrier.sync``)."""
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=x0.dtype, device="cuda")
    err = lib.bench_run(int(x0.dtype == torch.float64), x0.data_ptr(), x1.data_ptr(),
                        x0.shape[0], lo, hi, shift, reps, v, threads, warp, sync,
                        cycles.data_ptr(), sink.data_ptr())
    _build.raise_on_error(err, "diag_step_split")
    torch.cuda.synchronize()
    return int(cycles.item()) / (reps * (hi - lo))


def state_bench(lib, ghz, tag, d0, e0):
    """The sweeps of the bench on states of the path's own run: the QR
    driver's (d, e) after k sweeps, its live window (as the kernel finds
    it), a shifted sweep at shift 0 and a zero-shift sweep over it; the
    dqds sweep over the whole scaled qd arrays at tau = 0."""
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr

    name = str(d0.dtype).removeprefix("torch.")
    n = d0.shape[0]
    for k in (0, 1000, 3000):
        d, e, thresh, _ = bidiag_qr.converge(d0, e0, max_sweeps=k)
        live = (e.abs() > thresh).nonzero().flatten().tolist()
        if not live:
            continue
        hi_e = live[-1]
        dead = (e[:hi_e].abs() <= thresh).nonzero().flatten().tolist()
        lo, hi = (dead[-1] + 1 if dead else 0), hi_e + 1
        ee = torch.cat([e, e.new_zeros(1)])
        z = min(bench(lib, d, ee, lo, hi, 0.0, 5, 20) for _ in range(2))
        sh = min(bench(lib, d, ee, lo, hi, 0.0, 5, 10) for _ in range(2))
        print(f"[step_split] state n={n} {name} after {k} QR sweeps, window [{lo}, {hi}]: "
              f"shifted {sh:.1f} cycles a step ({sh / ghz:.2f} ns), zero-shift {z:.1f} "
              f"({z / ghz:.2f} ns) {tag}", flush=True)
    q, E, _ = dg.dqds_prepare(d0, e0)
    c = min(bench(lib, q.contiguous(), E.contiguous(), 0, n - 1, 0.0, 20, 0) for _ in range(2))
    print(f"[step_split] state n={n} {name} dqds over the scaled path arrays: {c:.1f} cycles "
          f"a step ({c / ghz:.2f} ns) {tag}", flush=True)


def lanes(lib, ghz, tag, n):
    """The designs' sweeps on one thread with no barrier in the kernel, and
    on 256 threads with thread 0 running them (as the kernels do) and the
    kernel ending in ``__syncthreads``, in the non-aligned ``barrier.sync``
    or in that barrier inside a ``__noinline__`` function, and with all of
    warp 0 running them uniformly."""
    g = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        x0 = torch.from_numpy(g.uniform(1.0, 2.0, n)).to("cuda", dtype)
        x1 = torch.from_numpy(g.uniform(0.25, 0.5, n)).to("cuda", dtype)
        for label, v in (("dqds", DQDS["design"]), ("QR shifted", QR["shifted design"]),
                         ("QR zero-shift", QR["zero-shift design"])):
            reps = 50 if v == DQDS["design"] else 10
            got = [min(bench(lib, x0, x1, 0, n - 1, 0.1, reps, v, t, w, y) for _ in range(2))
                   for t, w, y in ((1, 0, 0), (256, 0, 1), (256, 0, 2), (256, 1, 2), (256, 0, 3))]
            print(f"[step_split] lanes {name} n={n} {label}: one thread, no barrier "
                  f"{got[0] / ghz:.2f} ns a step; thread 0 of 256, __syncthreads "
                  f"{got[1] / ghz:.2f}, barrier.sync {got[2] / ghz:.2f}, barrier.sync in a "
                  f"__noinline__ function {got[4] / ghz:.2f}; warp 0 of 256 uniform, "
                  f"barrier.sync {got[3] / ghz:.2f} {tag}", flush=True)


def path_split(lib, ghz, tag):
    """The kernels on the path's bidiagonals, thread 0's cycles split; the
    bench's sweeps on states of the same runs."""
    sys.path.insert(0, str(REPO / "tools"))
    from diag_times import inputs

    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    libs = {name: build_clocked(name) for name in CLOCKS}
    for fn, args in {**bidiag_qr._ENTRIES, **dqds._ENTRIES}.items():
        getattr(libs["bidiag_qr" if "bidiag_qr" in fn else "dqds"], fn).argtypes = args
    data = inputs(str(REPO / "build" / "diag_inputs.pt"))
    stream = torch.cuda.current_stream().cuda_stream
    for n in (3840, 1000):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            s = bidiag_qr._DTYPES[dtype]
            d0, e0 = (x.to("cuda", dtype) for x in data[n])
            d, e = d0.clone(), e0.clone()
            thresh = torch.empty(1, dtype=dtype, device="cuda")
            info = torch.zeros(6, dtype=torch.int64, device="cuda")
            smem = int(bidiag_qr.memory_instance(n, dtype) == "smem")
            fn = getattr(libs["bidiag_qr"], f"svdt_bidiag_qr_converge_{s}")
            err = fn(d.data_ptr(), e.data_ptr(), n, thresh.data_ptr(), 1, 100.0, 30 * n,
                     info.data_ptr(), smem, stream)
            _build.raise_on_error(err, "bidiag_qr clocked")
            torch.cuda.synchronize()
            sweeps, _, sz, ss, cyc_sweep, cyc_all = info.tolist()
            ns_step = cyc_sweep / ghz / (sz + ss)
            rest_us = (cyc_all - cyc_sweep) / ghz / 1e3 / sweeps
            print(f"[step_split] path n={n} {name} bidiag_qr: {cyc_all / ghz / 1e6:.3f} ms on "
                  f"thread 0's clock, {cyc_sweep / ghz / 1e6:.3f} ms in {sweeps} sweeps "
                  f"({sz + ss} steps: {ns_step:.2f} ns a step), the rest {rest_us:.3f} us a "
                  f"sweep {tag}", flush=True)
            q0, E0, _ = dg.dqds_prepare(d0, e0)
            out = torch.zeros_like(q0)
            info = torch.zeros(24, dtype=torch.int64, device="cuda")
            smem = int(dqds.memory_instance(n, dtype) == "smem")
            work = None if smem else torch.empty(5 * n, dtype=dtype, device="cuda")
            fn = getattr(libs["dqds"], f"svdt_dqds_{s}")
            err = fn(q0.data_ptr(), E0.data_ptr(), out.data_ptr(),
                     None if work is None else work.data_ptr(), n, 60 * n, info.data_ptr(),
                     smem, stream)
            _build.raise_on_error(err, "dqds clocked")
            torch.cuda.synchronize()
            info = info.tolist()
            sweeps, steps, cyc_sweep, cyc_all = info[1], info[2], info[22], info[23]
            print(f"[step_split] path n={n} {name} dqds: {cyc_all / ghz / 1e6:.3f} ms on "
                  f"thread 0's clock, {cyc_sweep / ghz / 1e6:.3f} ms in {sweeps} sweeps "
                  f"({steps} steps: {cyc_sweep / ghz / steps:.2f} ns a step), the rest "
                  f"{(cyc_all - cyc_sweep) / ghz / 1e3 / sweeps:.3f} us a sweep {tag}",
                  flush=True)
            if n == 3840:
                state_bench(lib, ghz, tag, d0, e0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3840)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--path", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diag_step_split: no CUDA device", file=sys.stderr)
        return 2
    lib_path = build()
    lib = ctypes.CDLL(str(lib_path))
    lib.bench_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    tag = f"| {card()}"
    n = args.n
    g = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        x0 = torch.from_numpy(g.uniform(1.0, 2.0, n)).to("cuda", dtype)
        x1 = torch.from_numpy(g.uniform(0.25, 0.5, n)).to("cuda", dtype)

        def run(v, reps):
            return bench(lib, x0, x1, 0, n - 1, 0.1, reps, v)

        run(DQDS["chain"], 1)  # load the module
        # the SM clock: a spin of 100 M cycles (clock64) against CUDA events
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cyc = run(99, 100) * 100 * (n - 1)
        stop.record()
        torch.cuda.synchronize()
        ghz = cyc / (start.elapsed_time(stop) * 1e6)
        print(f"[step_split] {name} n={n}: SM clock {ghz:.3f} GHz (a clock64 spin against "
              f"CUDA events) {tag}", flush=True)
        for table, reps in ((DQDS, 50), (QR, 10)):
            for label, v in table.items():
                c = min(run(v, reps) for _ in range(2))
                kernel = "dqds" if table is DQDS else "bidiag_qr"
                print(f"[step_split] {name} n={n} {kernel} {label}: {c:.1f} cycles a step, "
                      f"{c / ghz:.2f} ns {tag}", flush=True)
    if args.lanes:
        lanes(lib, ghz, tag, n)
    if args.path:
        path_split(lib, ghz, tag)
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True)
        counts = {}
        for line in out.stdout.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ")[1].strip()
                counts[fn] = {"BSSY": 0, "BSYNC": 0, "CALL": 0, "BAR": 0}
            else:
                for op in ("BSSY", "BSYNC", "CALL", "BAR"):
                    if f" {op}" in line and fn in counts:
                        counts[fn][op] += 1
        for fn, c in counts.items():
            print(f"[step_split] SASS {fn[:90]}: {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
