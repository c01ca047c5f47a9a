#!/usr/bin/env python3
"""Where the time of the staged and wavefront chase kernels goes (one CUDA card).

Run from the repository root: ``python3 tools/chase_split.py``.  It copies
``csrc/band_chase_staged.cu`` and ``csrc/band_chase_wave.cu`` into
``build/chase_split/`` with switches that skip parts of the work, builds the
copies with the package's nvcc flags, and times each on the Stage I kernel's
band of a uniform [0, 5) matrix (CUDA events, median of 3) at n = 1024
(b = 64) and 3840 (b = 128):

* staged kernel (khops = 1): in full, without the tile copies, without the
  pairs on the tiles, the head pairs alone, the tile copies alone, and the
  loop with no work;
* wavefront kernel, each tick (the L2 tick and the shared-memory one): in
  full, its grid barriers alone (no pair runs), and a per-phase split of one
  busy lane (CTA 1): its thread 0 stamps ``clock64()`` at the phase marks
  ``SVDT_SPLIT`` of ``csrc/chase_pair.cuh`` and ``band_chase_wave.cu`` (empty
  in the package's builds) into a device buffer, a tick a row, and the
  global timer at each tick's start turns cycles into microseconds.

A run with skipped work computes a wrong (d, e); only the full runs are
held bit-equal to the chase kernel.  The shipped kernels are not changed.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from svdsolver_tpu_torch.ops.chase_schedule import wave_ticks  # noqa: E402
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, panel_qr  # noqa: E402

OUT = ROOT / "build" / "chase_split"
SHAPES = ((1024, 64), (3840, 128))
STAGED_MODES = (  # bit 1: skip tile copies, 2: skip tile pairs, 4: skip head pairs
    (0, "full"), (1, "no tile copies"), (2, "no tile pairs"),
    (3, "head pairs only"), (6, "tile copies only"), (7, "empty loop"),
)


def patch(text, old, new, count=1):
    if text.count(old) != count:
        raise RuntimeError(f"source changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def staged_source():
    s = (_build.CSRC / "band_chase_staged.cu").read_text()
    s = patch(s, "int n, int b, int K) {", "int n, int b, int K, int mode) {")
    s = patch(s, "    chase_pair<KPL, false>(dense,", "    if (!(mode & 4)) chase_pair<KPL, false>(dense,")
    s = patch(s, "        chase_pair<KPL, false>(acc,", "        if (!(mode & 2)) chase_pair<KPL, false>(acc,")
    s = s.replace("    tile_io<true>(", "    if (!(mode & 1)) tile_io<true>(")
    s = s.replace("    tile_io<false>(", "    if (!(mode & 1)) tile_io<false>(")
    s = patch(s, "               cudaStream_t s) {", "               cudaStream_t s, int mode) {")
    s = patch(s, "(A, d, e, n, b, K);", "(A, d, e, n, b, K, mode);")
    s = patch(s, "int b, int khops, void* stream) {", "int b, int khops, int mode, void* stream) {")
    s = patch(s, "(A, d, e, n, b, khops, s);", "(A, d, e, n, b, khops, s, mode);", count=3)
    return s


# Phase marks of one CTA (tick start, the pivot box landed, after the right
# reflector, the right apply, the left reflector, the left partials, the left
# apply, before and after the grid barrier): clock64 stamps, and the global
# timer at each tick's start to turn cycles into time.
SPLIT_PRELUDE = r"""
__device__ long long* g_split;
__device__ long long* g_split_row;
__device__ int g_split_cta;
__device__ int g_split_skip;
__device__ __forceinline__ long long split_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
#define SPLIT_MINE (g_split != nullptr && threadIdx.x == 0 && blockIdx.x == g_split_cta)
#define SVDT_SPLIT(k) do { if (SPLIT_MINE) g_split_row[k] = clock64(); } while (0)
#define SVDT_SPLIT_TICK(t)                                            \
  do {                                                                \
    if (SPLIT_MINE) {                                                 \
      g_split_row = g_split + 10 * (size_t)(t);                       \
      g_split_row[0] = clock64();                                     \
      g_split_row[9] = split_gtime();                                 \
    }                                                                 \
  } while (0)
"""
SPLIT_SETTER = """
extern "C" int svdt_split_set(long long* buf, int cta, int skip) {
  cudaError_t err = cudaMemcpyToSymbol(g_split, &buf, sizeof(buf));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_split_cta, &cta, sizeof(cta));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_split_skip, &skip, sizeof(skip));
  return (int)err;
}
"""
PHASES = ("copy-in wait", "right reflector", "right apply", "left reflector",
          "left partials", "left apply", "stores", "grid barrier")


def wave_source():
    """band_chase_wave.cu with the phase marks defined and a switch that
    skips every pair (both ticks: the grid barriers alone)."""
    s = (_build.CSRC / "band_chase_wave.cu").read_text()
    s = patch(s, "u <= L; u += G)", "u <= L && !g_split_skip; u += G)", count=2)
    return SPLIT_PRELUDE + s + SPLIT_SETTER


def phase_split(stamps):
    """Mean microseconds a tick of each phase, over the ticks in which the
    stamped CTA ran a pair; a mark the tick lacks takes the one before it
    (the L2 tick has no copies, a pair without a left apply no partials)."""
    st = stamps.astype(np.float64)
    ran = st[:, 2] > 0
    ns_per_clk = (st[-1, 9] - st[0, 9]) / (st[-1, 0] - st[0, 0])
    rows = st[ran][:, :9].copy()
    for k in range(1, 9):
        rows[:, k] = np.where(rows[:, k] > 0, rows[:, k], rows[:, k - 1])
    per = np.diff(rows, axis=1).mean(axis=0) * ns_per_clk / 1e3
    tick = (rows[:, 8] - rows[:, 0]).mean() * ns_per_clk / 1e3
    return dict(zip(PHASES, per)), tick, int(ran.sum()), 1e3 / ns_per_clk


def build(name, text):
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def median_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("chase_split: no CUDA device", file=sys.stderr)
        return 2
    V, I = ctypes.c_void_p, ctypes.c_int
    staged = build("staged", staged_source())
    staged.svdt_band_chase_staged.argtypes = [V, V, V, I, I, I, I, V]
    wave = build("wave", wave_source())
    wave.svdt_band_chase_wave.argtypes = [V, V, V, I, I, V, I, V, V]
    wave.svdt_band_chase_wave_smem.argtypes = [V, V, V, I, I, V, I, V, I, V]
    wave.svdt_split_set.argtypes = [V, I, I]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for n, b in SHAPES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        Ab = panel_qr.dense_to_band_fused(torch.from_numpy(a).cuda(), band=b)
        want = band_chase.band_to_bidiagonal(Ab, band=b)
        print(f"[split] chase kernel n={n} b={b}: "
              f"{median_ms(lambda: band_chase.band_to_bidiagonal(Ab, band=b)):.3f} ms", flush=True)
        out = {}

        def run_staged(mode):
            W = Ab.clone()
            d, e = torch.empty(n, device="cuda"), torch.empty(n - 1, device="cuda")
            err = staged.svdt_band_chase_staged(W.data_ptr(), d.data_ptr(), e.data_ptr(),
                                                n, b, 1, mode, stream())
            if err:
                raise RuntimeError(f"staged launch failed: {err}")
            out["de"] = (d, e)

        for mode, label in STAGED_MODES:
            ms = median_ms(lambda: run_staged(mode))
            note = ""
            if mode == 0:
                same = all(torch.equal(x, y) for x, y in zip(out["de"], want))
                if not same:
                    raise RuntimeError("staged copy not bit-equal to the chase kernel")
                note = ", (d, e) bit-equal to the chase kernel"
            print(f"[split] staged n={n} b={b} khops=1 {label}: {ms:.3f} ms{note}", flush=True)

        def run_wave(tick):
            W = Ab.clone()
            d, e = torch.empty(n, device="cuda"), torch.empty(n - 1, device="cuda")
            ctr = torch.zeros(1, dtype=torch.int32, device="cuda")
            got = ctypes.c_int(0)
            args = (W.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, ctr.data_ptr(), 0,
                    ctypes.addressof(got))
            if tick == "smem":
                err = wave.svdt_band_chase_wave_smem(*args, 0, stream())
            else:
                err = wave.svdt_band_chase_wave(*args, stream())
            if err:
                raise RuntimeError(f"wave launch failed: {err}")
            out["ctas"], out["de"] = got.value, (d, e)

        T = wave_ticks(n, b)
        for tick in ("l2", "smem"):
            wave.svdt_split_set(None, 1, 0)
            ms = median_ms(lambda: run_wave(tick))
            if not all(torch.equal(x, y) for x, y in zip(out["de"], want)):
                raise RuntimeError(f"wave {tick} tick copy not bit-equal to the chase kernel")
            wave.svdt_split_set(None, 1, 1)
            bar_ms = median_ms(lambda: run_wave(tick))
            stamps = torch.zeros((T, 10), dtype=torch.int64, device="cuda")
            wave.svdt_split_set(stamps.data_ptr(), 1, 0)
            run_wave(tick)
            torch.cuda.synchronize()
            wave.svdt_split_set(None, 1, 0)
            split, per_tick, ran, mhz = phase_split(stamps.cpu().numpy())
            print(f"[split] wave {tick} tick n={n} b={b}: {ms:.3f} ms on {out['ctas']} CTAs "
                  f"({T} ticks, {ms / T * 1e3:.2f} us a tick), (d, e) bit-equal to the chase "
                  f"kernel; grid barriers only {bar_ms:.3f} ms", flush=True)
            print(f"[split] wave {tick} tick n={n} b={b}, CTA 1 (lane 1), {ran} ticks with a pair, "
                  f"{per_tick:.2f} us a tick at {mhz:.0f} MHz: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " (us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
