#!/usr/bin/env python3
"""Where the time of the staged and wavefront chase kernels goes (one CUDA card).

Run from the repository root: ``python3 tools/chase_split.py``.  It copies
``csrc/band_chase_staged.cu`` and ``csrc/band_chase_wave.cu`` into
``build/chase_split/`` with the phase marks defined (and, for the
wavefront, a switch that skips every pair), builds the copies with the
package's nvcc flags, and times each on the Stage I kernel's band of a
uniform [0, 5) matrix (CUDA events, median of 3) at n = 1024 (b = 64) and
3840 (b = 128), beside the L2 kernel of the sequential chase:

* staged kernel, TMA design (khops = 1, and the largest lookahead that fits
  at b = 64), plain and recording entries (the two in turns): in full, and
  a per-phase split of the chase pairs and heads:
  thread 0 stamps ``clock64()`` at the ``SVDT_SPLIT`` marks (the A tile
  landed, each reflector and apply, the C tile landed, the pair's end), the
  copying thread at ``SVDT_SPLIT_COPY`` (before and after it waits for the
  stores in flight to land, after it issues a C load and A's store, before
  and after it waits for A's store to read its slot), a pair a row (the
  records' stores land in the reflector phases); and the TMA design, plain,
  with the full ``fence.proxy.async`` where it fences shared
  memory alone (``fence.proxy.async.shared::cta``), the cheaper fence's
  gain, and without the copying thread's device-memory fence
  (``fence.proxy.async.global``) after each wait for the stores to land,
  that fence's cost, both in turns with the package's build;
* wavefront kernel, each tick (the L2 tick and the shared-memory one) of
  the plain and the deferred-left entries: in full, its grid barriers
  alone (no pair runs), and a per-phase split of one busy lane (CTA 1):
  its thread 0 stamps ``clock64()`` at the phase marks ``SVDT_SPLIT`` of
  ``csrc/chase_pair.cuh`` and ``band_chase_wave.cu`` (empty in the
  package's builds) into a device buffer, a tick a row, and the global
  timer at each tick's start turns cycles into microseconds.

A wavefront run with skipped work computes a wrong (d, e); every other run
is held bit-equal to the L2 kernel's (d, e) and records.  The shipped
kernels are not changed.
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

from svdsolver_tpu_torch.ops.chase_schedule import (  # noqa: E402
    staged_pairs,
    wave_ticks,
    wave_units,
)
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, panel_qr  # noqa: E402

OUT = ROOT / "build" / "chase_split"
SHAPES = ((1024, 64), (3840, 128))


def patch(text, old, new, count=1):
    if text.count(old) != count:
        raise RuntimeError(f"source changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def staged_source():
    """band_chase_staged.cu with the phase marks defined."""
    return SPLIT_PRELUDE + (_build.CSRC / "band_chase_staged.cu").read_text() + SPLIT_SETTER


# Phase marks of one CTA, a row of ROW stamps a tick (wavefront) or a pair
# (staged): 0 its start, 1 the pivot box landed, 2 after the right
# reflector, 3 the right apply, 4 the left reflector, 5 the left partials,
# 6 the left apply, 7 and 8 before and after the grid barrier (wavefront) or
# 7 the pair's end (staged), 15 the C tile landed, by thread 0; 10-14 by the
# staged kernel's copying thread; 9 the global timer at the row's start, to
# turn cycles into time.
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
#define SVDT_SPLIT_COPY(row, k)                                       \
  do {                                                                \
    if (g_split != nullptr && blockIdx.x == g_split_cta)              \
      g_split[16 * (size_t)(row) + (k)] = clock64();                  \
  } while (0)
#define SVDT_SPLIT_TICK(t)                                            \
  do {                                                                \
    if (SPLIT_MINE) {                                                 \
      g_split_row = g_split + 16 * (size_t)(t);                       \
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
ROW = 16
PHASES = ("copy-in wait", "right reflector", "right apply", "left reflector",
          "left partials", "left apply", "stores", "grid barrier")
# a deferred-left slot's marks (band_chase_wave.cu dl_slot, smem_dl_slot):
# 1 the pending tiles landed (and the ring read), 2 the pending partials,
# 3 the right reflector (the shared-memory tick: with the pending update of
# the (r, c - b) tile beside it), 4 the fused apply (the shared-memory tick:
# the right apply, (r, c)'s store issued between its two tiles), 5 the new
# left reflector, 6 the stores drained and the ring written
DL_PHASES = ("pending tiles wait", "pending partials", "right reflector", "fused apply",
             "new reflector", "drain, ring", "to the barrier", "grid barrier")
# the staged TMA design's chase pair: (name, from mark, to mark); "next" is
# the next row's start
STAGED_PHASES = (("A wait", 0, 1), ("right reflector", 1, 2), ("right apply", 2, 3),
                 ("left reflector", 3, 4), ("C wait", 4, 15), ("left partials", 15, 5),
                 ("left apply", 5, 6), ("share overlap", 6, 7), ("to the next pair", 7, "next"))
COPIER_PHASES = (("stores in flight landing, then the fence", 10, 11), ("C load and A store issued", 11, 12),
                 ("A store reading", 13, 14))


def wave_source():
    """band_chase_wave.cu with the phase marks defined and a switch that
    skips every pair (both ticks: the grid barriers alone)."""
    s = (_build.CSRC / "band_chase_wave.cu").read_text()
    s = patch(s, "u <= L; u += G)", "u <= L && !g_split_skip; u += G)", count=3)
    return SPLIT_PRELUDE + s + SPLIT_SETTER


def phase_split(stamps, names=PHASES):
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
    return dict(zip(names, per)), tick, int(ran.sum()), 1e3 / ns_per_clk


def staged_split(stamps):
    """Mean microseconds of each phase of the staged TMA design's chase
    pairs (rows with a copying-thread stamp) and of its heads, a pair's and
    a head's whole time (row start to the next row's start), and the clock
    in MHz.  The copying thread's waits for a read are stamped only where
    the pair loads a later pair's tile into the slot."""
    st = stamps.astype(np.float64)
    ns_per_clk = (st[-1, 9] - st[0, 9]) / (st[-1, 0] - st[0, 0])
    us = ns_per_clk / 1e3
    nxt = np.append(st[1:, 0], np.nan)
    chase = (st[:, 10] > 0) & ~np.isnan(nxt)
    head = (st[:, 10] == 0) & (st[:, 2] > 0) & ~np.isnan(nxt)
    rows = st[chase]
    order = (0, 1, 2, 3, 4, 15, 5, 6, 7)  # a mark a pair lacks takes the one before
    for k0, k1 in zip(order, order[1:]):
        rows[:, k1] = np.where(rows[:, k1] > 0, rows[:, k1], rows[:, k0])
    out = {}
    for name, a, z in STAGED_PHASES:
        end = nxt[chase] if z == "next" else rows[:, z]
        out[name] = float(np.mean(end - rows[:, a])) * us
    for name, a, z in COPIER_PHASES:
        has = rows[:, z] > 0
        out[f"copier: {name}"] = float(np.mean(rows[has, z] - rows[has, a])) * us if has.any() else 0.0
    pair = float(np.mean(nxt[chase] - rows[:, 0])) * us
    head_us = float(np.mean(nxt[head] - st[head, 0])) * us
    return out, pair, int(chase.sum()), head_us, int(head.sum()), 1e3 / ns_per_clk


def no_global_fence_source():
    """staged_source() without the copying thread's fence_async_global
    after its waits for the stores to land."""
    return patch(staged_source(), "fence_async_global();", "", count=2)


def full_fence_header():
    """chase_tma.cuh with fence_async_smem as the full proxy fence."""
    h = (_build.CSRC / "chase_tma.cuh").read_text()
    return patch(h, 'asm volatile("fence.proxy.async.shared::cta;" ::: "memory");',
                 'asm volatile("fence.proxy.async;" ::: "memory");')


def build(name, text, header=None):
    """Compile ``text`` into build/chase_split/lib<name>.so; ``header``: a
    chase_tma.cuh beside it that replaces the package's."""
    out = OUT / name if header else OUT
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"lib{name}.so"
    if header:
        (out / "chase_tma.cuh").write_text(header)
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
    staged.svdt_band_chase_staged.argtypes = [V, V, V, I, I, I, V]
    staged.svdt_band_chase_staged_rec.argtypes = [V, V, V, I, I, V, V, V, V, I, I, V]
    staged.svdt_split_set.argtypes = [V, I, I]
    full_fence = build("staged_full_fence", staged_source(), full_fence_header())
    full_fence.svdt_band_chase_staged.argtypes = [V, V, V, I, I, I, V]
    no_fence = build("staged_no_global_fence", no_global_fence_source())
    no_fence.svdt_band_chase_staged.argtypes = [V, V, V, I, I, I, V]
    wave = build("wave", wave_source())
    wave.svdt_band_chase_wave.argtypes = [V, V, V, I, I, V, I, V, V]
    wave.svdt_band_chase_wave_smem.argtypes = [V, V, V, I, I, V, I, V, I, V]
    wave.svdt_band_chase_wave_dl.argtypes = [V, V, V, I, I, V, V, V, I, I, V, V]
    wave.svdt_band_chase_wave_smem_dl.argtypes = [V, V, V, I, I, V, V, V, I, I, V, I, V]
    wave.svdt_split_set.argtypes = [V, I, I]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for n, b in SHAPES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        Ab = panel_qr.dense_to_band_fused(torch.from_numpy(a).cuda(), band=b)
        want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        want_rec = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
        l2_ms = median_ms(lambda: band_chase.band_to_bidiagonal_l2(Ab, band=b))
        l2_rec_ms = median_ms(lambda: band_chase.band_to_bidiagonal_accum_l2(Ab, band=b))
        print(f"[split] L2 kernel n={n} b={b}: plain {l2_ms:.3f} ms, recording "
              f"{l2_rec_ms:.3f} ms", flush=True)
        out = {}

        def run_staged(K=1, lib=staged, record=False):
            W = Ab.clone()
            d, e = torch.empty(n, device="cuda"), torch.empty(n - 1, device="cuda")
            recs = [torch.zeros_like(t) for t in want_rec[2:]] if record else []
            if record:
                err = lib.svdt_band_chase_staged_rec(W.data_ptr(), d.data_ptr(), e.data_ptr(),
                                                     n, b, *(t.data_ptr() for t in recs),
                                                     recs[0].shape[1], K, stream())
            else:
                err = lib.svdt_band_chase_staged(W.data_ptr(), d.data_ptr(), e.data_ptr(),
                                                 n, b, K, stream())
            if err:
                raise RuntimeError(f"staged launch failed: {err}")
            out["de"] = (d, e, *recs)

        def same(record=False):
            return all(torch.equal(x, y) for x, y in zip(out["de"], want_rec if record else want))

        rows = (n - 1) + sum(staged_pairs(i, n, b) for i in range(n - 1))
        for K in sorted({1, band_chase.staged_khops(b, 99)}):
            first = {}
            for record in (False, True):
                entry = "recording" if record else "plain"
                staged.svdt_split_set(None, 0, 0)
                first[record] = median_ms(lambda: run_staged(K, record=record))
                if not same(record):
                    raise RuntimeError(f"staged TMA K={K} {entry} not bit-equal to the L2 kernel")
                stamps = torch.zeros((rows, ROW), dtype=torch.int64, device="cuda")
                staged.svdt_split_set(stamps.data_ptr(), 0, 0)
                run_staged(K, record=record)
                torch.cuda.synchronize()
                staged.svdt_split_set(None, 0, 0)
                split, pair, npairs, head, nheads, mhz = staged_split(stamps.cpu().numpy())
                print(f"[split] staged TMA {entry} n={n} b={b} K={K}: {first[record]:.3f} ms, "
                      f"{'(d, e) and records' if record else '(d, e)'} bit-equal to the L2 "
                      f"kernel's; {npairs} chase pairs of {pair:.2f} us, {nheads} heads of "
                      f"{head:.2f} us at {mhz:.0f} MHz: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " (us)",
                      flush=True)
            rec2 = median_ms(lambda: run_staged(K, record=True))
            plain2 = median_ms(lambda: run_staged(K))
            print(f"[split] staged TMA n={n} b={b} K={K} in turns (plain, recording, "
                  f"recording, plain; stamps off): plain {first[False]:.3f} / {plain2:.3f} ms, "
                  f"recording {first[True]:.3f} / {rec2:.3f} ms", flush=True)
            pkg = median_ms(lambda: run_staged(K))
            ff = median_ms(lambda: run_staged(K, lib=full_fence))
            same_ff = same()
            nf = median_ms(lambda: run_staged(K, lib=no_fence))
            same_nf = same()
            pkg2 = median_ms(lambda: run_staged(K))
            print(f"[split] staged TMA n={n} b={b} K={K} with full proxy fences: {ff:.3f} ms "
                  f"((d, e) {'bit-equal' if same_ff else 'NOT bit-equal'}), in turns with the "
                  f"package's shared-memory fences {pkg:.3f} / {pkg2:.3f} ms", flush=True)
            print(f"[split] staged TMA n={n} b={b} K={K} without the device-memory fences "
                  f"after the drains: {nf:.3f} ms ((d, e) "
                  f"{'bit-equal' if same_nf else 'NOT bit-equal'}), in turns with the "
                  f"package's {pkg:.3f} / {pkg2:.3f} ms", flush=True)

        def run_wave(tick, dl=False):
            W = Ab.clone()
            d, e = torch.empty(n, device="cuda"), torch.empty(n - 1, device="cuda")
            ctr = torch.zeros(1, dtype=torch.int32, device="cuda")
            got = ctypes.c_int(0)
            head = (W.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, ctr.data_ptr())
            if dl:  # the pending reflectors' ring, as band_chase_wave._launch sizes it
                slots = wave_units(n, b, defer_left=True) + 1
                ring_v, ring_t = torch.zeros((slots, b), device="cuda"), torch.zeros(slots, device="cuda")
                args = head + (ring_v.data_ptr(), ring_t.data_ptr(), slots, 0, ctypes.addressof(got))
                out["ring"] = ring_v, ring_t
            else:
                args = head + (0, ctypes.addressof(got))
            if tick == "smem":
                err = (wave.svdt_band_chase_wave_smem_dl if dl
                       else wave.svdt_band_chase_wave_smem)(*args, 0, stream())
            else:
                err = (wave.svdt_band_chase_wave_dl if dl else wave.svdt_band_chase_wave)(
                    *args, stream())
            if err:
                raise RuntimeError(f"wave launch failed: {err}")
            out["ctas"], out["de"] = got.value, (d, e)

        for dl in (False, True):
            T = wave_ticks(n, b, defer_left=dl)
            entry = "wave_dl" if dl else "wave"
            for tick in ("l2", "smem"):
                wave.svdt_split_set(None, 1, 0)
                ms = median_ms(lambda: run_wave(tick, dl))
                if not all(torch.equal(x, y) for x, y in zip(out["de"], want)):
                    raise RuntimeError(f"{entry} {tick} tick copy not bit-equal to the L2 kernel")
                wave.svdt_split_set(None, 1, 1)
                bar_ms = median_ms(lambda: run_wave(tick, dl))
                stamps = torch.zeros((T, ROW), dtype=torch.int64, device="cuda")
                wave.svdt_split_set(stamps.data_ptr(), 1, 0)
                run_wave(tick, dl)
                torch.cuda.synchronize()
                wave.svdt_split_set(None, 1, 0)
                split, per_tick, ran, mhz = phase_split(stamps.cpu().numpy(),
                                                        DL_PHASES if dl else PHASES)
                print(f"[split] {entry} {tick} tick n={n} b={b}: {ms:.3f} ms on {out['ctas']} "
                      f"CTAs ({T} ticks, {ms / T * 1e3:.2f} us a tick), (d, e) bit-equal to the "
                      f"L2 kernel; grid barriers only {bar_ms:.3f} ms", flush=True)
                print(f"[split] {entry} {tick} tick n={n} b={b}, CTA 1 (lane 1), {ran} ticks with "
                      f"a slot, {per_tick:.2f} us a tick at {mhz:.0f} MHz: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " (us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
