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
* wavefront kernel: in full, and its grid barriers alone (no pair runs).

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


def wave_source():
    s = (_build.CSRC / "band_chase_wave.cu").read_text()
    s = patch(s, "using namespace svdt;\n", "using namespace svdt;\nint g_skip = 0;\n")
    s = patch(s, "Ring ring, Records rec) {", "Ring ring, Records rec, int skip) {")
    s = patch(s, "u <= L; u += G)", "u <= L && !skip; u += G)")
    s = patch(s, "&ctr, &ring, &rec};", "&ctr, &ring, &rec, &g_skip};")
    return s + '\nextern "C" void svdt_set_skip(int v) { g_skip = v; }\n'


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
    wave.svdt_set_skip.argtypes = [I]
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

        def run_wave():
            W = Ab.clone()
            d, e = torch.empty(n, device="cuda"), torch.empty(n - 1, device="cuda")
            ctr = torch.zeros(1, dtype=torch.int32, device="cuda")
            got = ctypes.c_int(0)
            err = wave.svdt_band_chase_wave(W.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                                            ctr.data_ptr(), 0, ctypes.addressof(got), stream())
            if err:
                raise RuntimeError(f"wave launch failed: {err}")
            out["ctas"] = got.value

        for skip, label in ((0, "full"), (1, "grid barriers only")):
            wave.svdt_set_skip(skip)
            ms = median_ms(run_wave)
            print(f"[split] wave n={n} b={b} {label}: {ms:.3f} ms on {out['ctas']} CTAs",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
