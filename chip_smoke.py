#!/usr/bin/env python3
"""Bring-up check of svdsolver_tpu_torch on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  It

1. reports the card (name, power limit), torch, CUDA and nvcc;
2. builds the three hand-written kernels from ``svdsolver_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it;
4. drives the main path, ``svdvals`` on a uniform [0, 5) float32 matrix, at
   n = 3840, 1000 and 7680, checks that every kernel was launched and that
   the singular values agree with float64 ``torch.linalg.svdvals`` to
   1e-5 * sigma_max;
5. times ``svdvals``, its three stages and each kernel beside its plain
   version (median of 5, CUDA events), then profiles one ``svdvals`` call
   at n = 3840: device time by kernel and the card's busy share.

Any failure raises and exits non-zero.  The second-to-last line is the
kernel table as JSON, the last ``{"ok": true, "device": {...}}``.  With no
CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_SIGMA = 1e-5  # max |sigma - sigma_ref| / sigma_max against float64
SLICE_SIZES = (3840, 1000, 7680)
REPS = 5


def say(*parts):
    print(*parts, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events."""
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


def uniform_matrix(n, seed=0):
    """The bench's matrix: uniform [0, 5) float32 from ``default_rng(seed)``."""
    a = np.random.default_rng(seed).uniform(0, 5, (n, n)).astype(np.float32)
    return torch.from_numpy(a).cuda()


def bidiag_sigma(d, e):
    """Singular values of bidiag(d, e) in float64 on the card (oracle only)."""
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    return torch.linalg.svdvals(B)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    say("[device]", name)
    say(smi.splitlines()[0])
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    from svdsolver_tpu_torch.ops.cuda import _build
    say("[device] nvcc:", run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    return name, smi.splitlines()[0]


def phase_build():
    from svdsolver_tpu_torch.ops.cuda import _build

    for name in ("panel_qr", "band_chase", "bisect"):
        path, seconds, log = _build.build(name)
        say(f"[build] {name}: {seconds:.2f} s -> {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")


def phase_kernels(rng):
    """Each kernel against its plain version, same inputs, on the card."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr

    errs = {}
    # K1: the first QR panel at n = 3840, and an LQ-like panel whose last
    # pivots run past m (identity reflectors there).
    k1 = 0.0
    for b, m, r_off in ((128, 3840, 0), (128, 1920, 1920 - 64)):
        Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).cuda()
        got = panel_qr.panel_qr(Pt, r_off)
        want = panel_qr.panel_qr_plain(Pt, r_off)
        torch.cuda.synchronize()
        for label, g, w in zip("RVT", got, want):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            # sums over m = 3840 run in other orders in the two versions
            require(err <= 1e-4 * scale, f"panel_qr {label} {(b, m, r_off)}: "
                    f"{err:.3e} > 1e-4 * {scale:.3e}")
            k1 = max(k1, err)
            say(f"[kernels] panel_qr b={b} m={m} r_off={r_off} {label}: "
                f"max_abs_err {err:.3e} (scale {scale:.3e})")
    errs["panel_qr"] = k1

    # K3: chase of a Stage I band at n = 1024, b = 64.
    n, b = 1024, 64
    A = uniform_matrix(n, seed=1)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = band_chase.band_to_bidiagonal(Ab, band=b)
    dp, ep = band_chase.band_to_bidiagonal_plain(Ab, band=b)
    torch.cuda.synchronize()
    s_a = torch.linalg.svdvals(A.double())
    s_k, s_p = bidiag_sigma(d, e), bidiag_sigma(dp, ep)
    smax = float(s_a[0])
    for label, s in (("kernel", s_k), ("plain", s_p)):
        err = float((s - s_a).abs().max())
        say(f"[kernels] band_chase n={n} b={b} {label} spectrum vs float64 "
            f"sigma(A): {err / smax:.3e} * sigma_max")
        require(torch.allclose(s, s_a, rtol=2e-5, atol=1e-5 * smax),
                f"band_chase {label} spectrum")
    lead = float(((d.abs() - dp.abs())[:8].abs() / dp.abs()[:8]).max())
    say(f"[kernels] band_chase |d|[:8] rel diff kernel vs plain: {lead:.3e}")
    require(lead <= 1e-4, "band_chase leading |d| vs plain")
    errs["band_chase"] = float((s_k - s_p).abs().max())

    # K2: bisection at n = 1024 on that bidiagonal, probes 1 and 3.
    k2 = 0.0
    for probes in (1, 3):
        s = bisect.bisect_svdvals(d, e, probes=probes)
        sp = bisect.bisect_svdvals_plain(d, e, probes=probes)
        torch.cuda.synchronize()
        err = float((s - sp).abs().max())
        top = float(sp.abs().max())
        say(f"[kernels] bisect n={n} probes={probes}: max_abs_err {err:.3e} "
            f"(sigma_max {top:.3e})")
        require(torch.allclose(s, sp, rtol=1e-6, atol=1e-7 * top),
                f"bisect probes={probes} vs plain")
        require(torch.allclose(s.double(), s_k, rtol=2e-5, atol=1e-5 * top),
                f"bisect probes={probes} vs float64")
        k2 = max(k2, err)
    errs["bisect"] = k2
    return errs, (Ab, d, e)


def phase_slice():
    """The main path at each size; returns the launch counts at n = 3840."""
    from svdsolver_tpu_torch import svdvals
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr

    mods = {"panel_qr": panel_qr, "band_chase": band_chase, "bisect": bisect}
    counts_3840 = None
    for n in SLICE_SIZES:
        A = uniform_matrix(n)
        torch.cuda.synchronize()
        for mod in mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        s = svdvals(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: mod.launches for k, mod in mods.items()}
        say(f"[slice] n={n}: svdvals {seconds:.3f} s (host clock, first call "
            f"at this size) launches {counts}")
        for k, c in counts.items():
            require(c > 0, f"kernel {k} not launched by svdvals at n={n}")
        require(s.shape == (n,) and bool(torch.isfinite(s).all()),
                f"svdvals output at n={n}")
        ref = torch.linalg.svdvals(A.double())
        err = float((s.double() - ref).abs().max() / ref[0])
        say(f"[slice] n={n}: max|sigma - sigma_ref| / sigma_max = {err:.3e}")
        require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n}")
        if n == 3840:
            counts_3840 = counts
        del A, s, ref
        torch.cuda.empty_cache()
    return counts_3840


def phase_times(band_state):
    from svdsolver_tpu_torch import svdvals
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr

    n = 3840
    A = uniform_matrix(n)
    b = 128
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = band_chase.band_to_bidiagonal(Ab, band=b)
    t = {
        "svdvals_3840": cuda_ms(lambda: svdvals(A)),
        "stage1_3840": cuda_ms(lambda: panel_qr.dense_to_band_fused(A, band=b)),
        "chase_3840": cuda_ms(lambda: band_chase.band_to_bidiagonal(Ab, band=b)),
        "bisect_3840": cuda_ms(lambda: bisect.bisect_svdvals(d, e)),
    }
    for k, v in t.items():
        say(f"[times] {k}: {v:.3f} ms (median of {REPS})")

    rng = np.random.default_rng(2)
    Pt = torch.from_numpy(rng.normal(size=(128, 3840)).astype(np.float32)).cuda()
    Ab1, d1, e1 = band_state
    pairs = {
        "panel_qr": (lambda: panel_qr.panel_qr(Pt, 0),
                     lambda: panel_qr.panel_qr_plain(Pt, 0), "b=128 m=3840"),
        "band_chase": (lambda: band_chase.band_to_bidiagonal(Ab1, band=64),
                       lambda: band_chase.band_to_bidiagonal_plain(Ab1, band=64),
                       "n=1024 b=64"),
        "bisect": (lambda: bisect.bisect_svdvals(d1, e1),
                   lambda: bisect.bisect_svdvals_plain(d1, e1), "n=1024 probes=1"),
        "bisect_p3": (lambda: bisect.bisect_svdvals(d1, e1, probes=3),
                      lambda: bisect.bisect_svdvals_plain(d1, e1, probes=3),
                      "n=1024 probes=3"),
    }
    kt = {}
    for name, (kern, plain, shape) in pairs.items():
        # plain, kernel, kernel, plain: the two versions in turns
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        kt[name] = (min(k1, k2), min(p1, p2))
        say(f"[times] {name} {shape}: kernel {k1:.3f} / {k2:.3f} ms, "
            f"plain {p1:.3f} / {p2:.3f} ms (medians of {REPS})")
    return t, kt


def phase_profile(n=3840):
    """Device time by kernel over one ``svdvals`` call (``torch.profiler``),
    and the share of the call's wall time in which the card ran a kernel.
    Busy is not utilization: the chase and the panel kernel hold one SM."""
    from torch.profiler import ProfilerActivity, profile

    from svdsolver_tpu_torch import svdvals

    A = uniform_matrix(n)
    svdvals(A)  # warm: allocator and libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svdvals(A)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's device time repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    for ms, count, key in rows[:8]:
        say(f"[profile] {ms:10.3f} ms {count:4d} x {key[:72]}")
    busy = sum(r[0] for r in rows)
    say(f"[profile] svdvals n={n}: wall {wall_ms:.3f} ms (host clock, profiler "
        f"on), kernels {busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import svdsolver_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.cuda.set_device(0)
    name, _ = phase_device()
    t0 = time.perf_counter()
    phase_build()
    say(f"[build] total {time.perf_counter() - t0:.2f} s")
    errs, band_state = phase_kernels(np.random.default_rng(0))
    counts = phase_slice()
    _, kt = phase_times(band_state)
    phase_profile()

    source = "svdsolver_tpu_torch/csrc/{}.cu"
    replaces = {
        "panel_qr": "svdsolver_tpu/ops/pallas/panel_qr.py:30",
        "band_chase": "svdsolver_tpu/ops/pallas/band_chase.py:331 "
                      "+ band_chase_wave.py:687 + band_chase_stream.py:118",
        "bisect": "svdsolver_tpu/ops/pallas/bisect.py:44",
    }
    kernels = [
        {"name": k, "route": "cuda", "source": source.format(k),
         "replaces": replaces[k], "launches": counts[k],
         "max_abs_err": errs[k], "ms": kt[k][0], "plain_ms": kt[k][1]}
        for k in ("panel_qr", "band_chase", "bisect")
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
