#!/usr/bin/env python3
"""The packed chase's TMA design (K12) at each lookahead, on one CUDA card.

Run from the repository root: ``python3 tools/packed_chase_khops.py``.  On
the Stage I band of a uniform [0, 5) matrix at n = 1024 (b = 64) and 3840
(b = 128) it calls the entry ``svdt_band_chase_vmem_tma`` directly at
every lookahead K that fits shared memory up to 5 (``band_chase.
staged_khops``: 1 to 5 at b = 64, 1 at b = 128), holds each (d, e)
bit-equal to the L2 kernel's, and times them in turns (K ascending, then
descending; CUDA events, medians of 5 at 1024 and 2 at 3840) beside the
L2 packed kernel and the sequential chase's staged design on the dense
matrix.  The package runs K = 1 (``band_chase_vmem.STORE_KHOPS``); this
says what a deeper ring would gain.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from svdsolver_tpu_torch.ops.chase_schedule import store_floats  # noqa: E402
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_vmem, panel_qr  # noqa: E402

SHAPES = ((1024, 64, 5), (3840, 128, 2))  # (n, band, timing reps)


def store_chase(Ab, b, K):
    """One call of the TMA design on a fresh band store at lookahead K."""
    n = Ab.shape[0]
    St = torch.empty(store_floats(n, b), device=Ab.device)
    d = torch.empty(n, device=Ab.device)
    e = torch.empty(n - 1, device=Ab.device)
    lib = _build.load("band_chase_staged", band_chase_vmem._TMA_ENTRIES)
    err = lib.svdt_band_chase_vmem_tma(Ab.data_ptr(), St.data_ptr(), d.data_ptr(),
                                       e.data_ptr(), n, b, K, _build.stream_of(Ab))
    _build.raise_on_error(err, "band_chase_vmem_tma")
    return d, e


def main():
    if not torch.cuda.is_available():
        print("packed_chase_khops: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    cs.phase_device()
    for n, b, reps in SHAPES:
        Ab = panel_qr.dense_to_band_fused(cs.uniform_matrix(n), band=b)
        want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        ks = list(range(1, band_chase.staged_khops(b, 5) + 1))
        calls = {f"store K={K}": (lambda K=K: store_chase(Ab, b, K)) for K in ks}
        for name, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            cs.require(all(torch.equal(x, y) for x, y in zip(got, want)),
                       f"{name} n={n} b={b} bit-equal to the L2 kernel")
        calls["L2 packed kernel"] = lambda: band_chase_vmem._launch(Ab, b, "packed")
        calls["staged design, dense"] = lambda: band_chase.band_to_bidiagonal(Ab, band=b)
        times = {}
        for name in list(calls) + list(calls)[::-1]:
            times.setdefault(name, []).append(cs.cuda_ms(calls[name], reps))
        for name, (t1, t2) in times.items():
            cs.say(f"[times] packed chase n={n} b={b} {name}: {t1:.3f} / {t2:.3f} ms "
                   f"(medians of {reps}, in turns)")
        k1 = min(times["store K=1"])
        for K in ks[1:]:
            cs.say(f"[khops] n={n} b={b} K={K}: {100 * (1 - min(times[f'store K={K}']) / k1):.2f} "
                   "% faster than K=1")
        del Ab, want
        torch.cuda.empty_cache()
    print("[khops] every store lookahead bit-equal to the L2 kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
