#!/usr/bin/env python3
"""Where the time of the pipelined chase's pass goes (one CUDA card).

Run from the repository root: ``python3 tools/superstep_split.py``.  Each
pass of ``PASSES`` runs on a buffer sliced from the Stage I band of a
uniform [0, 5) matrix as ``local_buffer`` seeds it (``chip_smoke.
pass_buffer``), every design on the same buffer, restored before each run:

* "fresh": both designs in turns (shared-memory, first, first,
  shared-memory), CUDA-event medians of 5 around the wrapper call, as
  ``chip_smoke.py`` times them: the host's work in the wrapper counts
  where the card waits for it;
* "device": the same with a sleep kernel queued first, so the wrapper's
  host work runs while the card is busy and the events time the card's own
  work (the barrier counter's memset and the kernel);
* "host": the wrapper call's host microseconds while the card is busy;
* "barriers": the shared-memory design with every pair skipped (a copy of
  ``csrc/band_chase_superstep.cu`` with a switch), its launch and grid
  barriers alone;
* a per-tick phase split of one lane (CTA 0): thread 0 stamps
  ``clock64()`` at the phase marks of ``csrc/chase_tma.cuh`` and the
  kernel (copy-in wait, right reflector, right apply, left reflector, left
  partials, left apply, stores, grid barrier), the global timer at each
  tick's start turning cycles into microseconds (``tools/chase_split.py``'s
  prelude).

The copies run through ``build/superstep_split/``; a run with skipped pairs
computes a wrong buffer, every other run is held ``torch.equal`` to the
first design's.  The shipped kernel is not changed.  Every line carries the
card's name and power limit.
"""

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from chase_split import PHASES, ROW, SPLIT_PRELUDE, SPLIT_SETTER, patch, phase_split  # noqa: E402
from svdsolver_tpu_torch.ops.chase_schedule import superstep_pairs  # noqa: E402
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, panel_qr  # noqa: E402
from svdsolver_tpu_torch.parallel.distributed import pipeline_geometry  # noqa: E402

OUT = ROOT / "build" / "superstep_split"
# (n, band, tp, sweeps_per_group, group) of rank 0's pass
PASSES = ((1024, 32, 4, None, 0), (1024, 32, 1, 1, 0), (1024, 32, 1, 2, 0),
          (1024, 32, 1, None, 0), (3840, 32, 4, None, 0), (3840, 32, 1, None, 0))
SLEEP = 20_000_000  # cycles of the sleep kernel queued before a device-timed run
REPS = 5


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stamped_library():
    """band_chase_superstep.cu with the phase marks defined and a switch
    that skips every pair, built with the package's flags."""
    s = (_build.CSRC / "band_chase_superstep.cu").read_text()
    s = patch(s, "u < lanes; u += G)", "u < lanes && !g_split_skip; u += G)")
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "superstep_split.cu", OUT / "libsuperstep_split.so"
    src.write_text(SPLIT_PRELUDE + s + SPLIT_SETTER)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    V, I = ctypes.c_void_p, ctypes.c_int
    out.svdt_band_chase_superstep_wave.argtypes = [V] + [I] * 11 + [V, I, V, V]
    out.svdt_split_set.argtypes = [V, I, I]
    return out


def events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def fresh_ms(fn, restore):
    times = []
    for rep in range(REPS + 1):
        restore()
        start, stop = events()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_ms(fn, restore):
    """(device ms, host us) of ``fn()`` queued behind a sleep kernel."""
    times, host = [], []
    for rep in range(REPS + 1):
        restore()
        torch.cuda.synchronize()
        start, stop = events()
        torch.cuda._sleep(SLEEP)
        start.record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            times.append(start.elapsed_time(stop))
            host.append((t1 - t0) * 1e6)
    return statistics.median(times), statistics.median(host)


def main():
    if not torch.cuda.is_available():
        print("superstep_split: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    lib = stamped_library()
    stream = torch.cuda.current_stream().cuda_stream
    for n, b, tp, lg, g in PASSES:
        Ab = panel_qr.dense_to_band_fused(chip_smoke.uniform_matrix(n, seed=22), band=b)
        geo = pipeline_geometry(n, b, tp, lg)
        L0 = chip_smoke.pass_buffer(Ab, geo, 0)
        args = (n, b, g * geo.LG, geo.LG, 0, geo.U, geo.m, tp == 1, geo.s_chase)
        sched = superstep_pairs(*args[:5], *args[6:], geo.Np)
        ticks = len({p.t for p in sched})
        span = max(p.t for p in sched) - min(p.t for p in sched) + 1
        label = (f"[superstep] n={n} b={b} tp={tp} LG={geo.LG} group {g} ({len(sched)} pairs, "
                 f"{ticks} ticks) on {name}:")
        want = band_chase.superstep(L0.clone(), *args, _design="l2")
        L = L0.clone()

        def restore():
            L.copy_(L0)

        def run(design):
            return lambda: band_chase.superstep(L, *args, _design=design)

        fresh = [fresh_ms(run(d), restore) for d in ("wave", "l2", "l2", "wave")]
        dev = {d: device_ms(run(d), restore) for d in ("wave", "l2")}
        print(f"{label} fresh: shared-memory {fresh[0]:.4f} / {fresh[3]:.4f} ms, first design "
              f"{fresh[1]:.4f} / {fresh[2]:.4f} ms; device: shared-memory {dev['wave'][0]:.4f}"
              f" ms, first design {dev['l2'][0]:.4f} ms; host: {dev['wave'][1]:.1f} / "
              f"{dev['l2'][1]:.1f} us a call ({band_chase.last_superstep_ctas} CTAs)")
        ctr = torch.zeros((1,), dtype=torch.int32, device="cuda")
        got = ctypes.c_int(0)
        stamps = torch.zeros(span * ROW, dtype=torch.int64, device="cuda")
        rows, Np = L.shape

        def stamped(skip):
            restore()
            stamps.zero_()
            _build.raise_on_error(lib.svdt_split_set(stamps.data_ptr(), 0, int(skip)), "split")
            start, stop = events()
            start.record()
            err = lib.svdt_band_chase_superstep_wave(
                L.data_ptr(), Np, rows, *args[:7], int(args[7]), args[8], ctr.data_ptr(), 0,
                ctypes.addressof(got), stream)
            stop.record()
            _build.raise_on_error(err, "superstep_split")
            torch.cuda.synchronize()
            return start.elapsed_time(stop)

        bare = statistics.median(stamped(True) for _ in range(REPS))
        total = stamped(False)
        if not torch.equal(L, want):
            raise RuntimeError(f"{label} the stamped build is not bit-equal to the first design")
        st = stamps.view(span, ROW).cpu().numpy()
        st = st[st[:, 0] > 0]  # the kernel's ticks: from its first pair with work to its last
        split, tick_us, busy, mhz = phase_split(st, PHASES)
        parts = ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        print(f"{label} barriers alone {bare:.4f} ms; stamped run {total:.4f} ms; lane 0 ran a "
              f"pair in {busy} of {len(st)} ticks, {tick_us:.2f} us a tick ({mhz:.0f} MHz): "
              f"{parts} us")
        lib.svdt_split_set(None, 0, 0)
        del L, L0, Ab, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
