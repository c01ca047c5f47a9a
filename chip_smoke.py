#!/usr/bin/env python3
"""Bring-up check of svdsolver_tpu_torch on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  It

1. reports the card (name, power limit), torch, CUDA and nvcc;
2. builds the seven kernel sources of ``svdsolver_tpu_torch/csrc`` (one
   ``nvcc`` each, all started together): the panel QR (one thread-block
   cluster), the sequential chase (plain and recording entries), the
   bisection, the TGK solve, the wavefront chase (plain, recording, and with
   deferred left applies), the staged chase and the packed chase;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the panel QR at (b, m, r_off) = (128,
   3840, 0), (128, 3840, 3776) (identity reflectors past m), (64, 1024, 0)
   and (128, 7680, 0) (the large-panel route), two launches bit-identical,
   Q = I - V T V^T orthogonal and Q R = P in float64; the recording chase's
   (d, e) bit-equal to the plain chase kernel's and its records rebuilding
   the band, the TGK solve's normalized columns within 64 eps; and drives
   the chase variants, every launch count set to 0 before each call and
   read after it: each variant's (d, e), and the recording wavefront's
   (d, e) and records, bit-equal to the sequential kernels' at n = 1024
   (b = 64), 3840 (b = 128) and, on capped CTAs, 2048 (b = 32); each
   variant against its plain version at 1024; each variant's sigma through
   the bisection kernel at 3840 against float64; the wavefront kernel's
   L2 tick (forced at b = 64, taken at b = 160 by both entries) bit-equal
   to the sequential kernels too;
4. drives the two main paths, with every launch count set to 0 just before
   each call and read just after: ``svdvals`` on a uniform [0, 5) float32
   matrix at n = 3840, 1000, 7680 and 256 (sigma against float64
   ``torch.linalg.svdvals`` to 1e-5 sigma_max), and ``svd`` at n = 3840
   (uniform), 2048 (Gaussian), 1000 and 256 (uniform): sigma to 1e-5
   sigma_max, reconstruction to 1e-4 sigma_max, orthogonality of U and Vh
   to 1e-4; the counts show the chase each routing predicate picked, and at
   3840 the routed chase is bit-equal to the sequential kernel on the same
   band;
5. times ``svdvals`` and ``svd`` at 3840 with their stages, each kernel
   beside its plain version and, where one exists, the PyTorch library
   call computing the same function (CUDA events), the panel QR at each
   Stage I panel length of n = 3840 with a split, the sequential and
   wavefront chases in turns at the routing shapes (outputs bit-equal,
   7680 included), each chase variant in turns with the chase kernel at
   3840, the wavefront kernel's shared-memory tick in turns with its L2
   tick at n = 1024, 3840 and 7680 (plain and recording), one CTA's copy
   rate for a chase window and the shared-memory tick's schedule bound,
   and computes each kernel's bound from its shapes;
6. profiles one ``svdvals`` and one ``svd`` call and one wavefront chase at
   n = 3840: device time by kernel and the card's busy share;
7. holds the redesigned kernels to their first designs: the bisection tree
   (K2, every group G of 4, 8, 16, 32 threads a sigma) bit-equal to the
   one-thread kernel at n = 1, 2, 33, 1024, 3840 and 7680 for probes 1 and
   3, the staged TGK solve (K9/K10) bit-equal to the first design at n =
   512, 1280, 3840 and at 997 and 250 lanes; drives ``svds`` at n = 1000,
   k = 250; times K2 at every G and both solve designs in turns at n =
   1024, 3840, 7680; and runs the scale net: the panel QR at m = 15,360
   and 23,040, ``svdvals`` at 15,360 (against float64 svdvals, timed) and
   23,040 (against a spectrum known by construction), ``svd`` at 7680 with
   its gates and its peak device memory.  Every main-path run shows the
   tree and the staged solve in the launch counts, never a first design.

Any failure raises and exits non-zero.  The second-to-last line is the
kernel table as JSON, the last ``{"ok": true, "device": {...}}``.  With no
CUDA device, or without the package beside it, it exits non-zero and
prints no result.  Every timing line stands under the card's name and power
limit, printed first.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL_SIGMA = 1e-5  # max |sigma - sigma_ref| / sigma_max against float64
TOL_RECON = 1e-4  # max |U diag(s) Vh - A| / sigma_max (JAX package's scale tests)
TOL_ORTH = 1e-4  # max |U^T U - I| and max |Vh Vh^T - I|
TOL_REBUILD = 1e-5  # chase records: max |L B R^T - Ab| / max |Ab|, |L^T L - I|
# n = 256 (band 64) has one chase lane: the predicates route it to the
# sequential kernels
SLICE_SIZES = (3840, 1000, 7680, 256)
SVD_CASES = ((3840, "uniform"), (2048, "gauss"), (1000, "uniform"), (256, "uniform"))
REPS = 5
SVD_REPS = 3
SOURCES = ("panel_qr", "band_chase", "bisect", "tridiag_solve",
           "band_chase_wave", "band_chase_staged", "band_chase_vmem")
VARIANTS = ("band_chase_wave", "band_chase_wave_dl", "band_chase_staged",
            "band_chase_vmem")
KERNELS = ("panel_qr", "band_chase", "band_chase_rec", "bisect",
           "tridiag_solve") + VARIANTS + ("band_chase_wave_rec",)
SVD_PATH = ("panel_qr", "bisect", "tridiag_solve")  # and the routed chase
# the wavefront entries count by tick: "band_chase_wave" and
# "band_chase_wave_rec" the shared-memory tick, "_l2" the L2 tick
CHASES = ("band_chase", "band_chase_rec", "band_chase_wave", "band_chase_wave_rec",
          "band_chase_wave_l2", "band_chase_wave_rec_l2")
# the two wavefront ticks in turns (n, band): the check band and the widest
# chases of the main paths
TICK_SHAPES = ((1024, 64), (3840, 128), (7680, 128))
# the redesigned K2 and K9/K10 against their first designs: bit-equality at
# these n (1 and 2: the smallest trees), times in turns at DESIGN_TIMES
K2_CHECK = (1, 2, 33, 1024, 3840, 7680)
TGK_CHECK = (512, 1280, 3840)
DESIGN_TIMES = (1024, 3840, 7680)
GROUPS = (1, 4, 8, 16, 32)  # K2's threads a sigma (1: the first design)
SVDS_CASE = (1000, 250)  # (n, k): k lanes not a multiple of 4
# the scale net: svdvals at SCALE_VALS (sigma against float64 svdvals at
# 15,360, against a spectrum known by construction at 23,040) and svd at
# SCALE_SVD with its gates and peak device memory
SCALE_VALS = (15360, 23040)
SCALE_SVD = 7680
WIDE_BAND = (640, 160)  # past the shared-memory tick's 128: the L2 tick
# K1 (b, m, r_off): the first Stage I panel at 3840, an LQ panel whose last
# 64 pivots lie past m, the first panel at 1000 (padded to 1024, b = 64) and
# the first at 7680, 15,360 and 23,040 (the large-panel route; past 12,544
# most of a CTA's columns stay in device memory)
K1_SHAPES = ((128, 3840, 0), (128, 3840, 3776), (64, 1024, 0), (128, 7680, 0),
             (128, 15360, 0), (128, 23040, 0))
TOL_K1 = 1e-4  # |kernel - plain| <= TOL_K1 max|plain|: sums over m in other orders
TOL_Q = 1e-5  # |Q^T Q - I| and |Q R - P|_F / |P|_F, float64 from the kernel's V, T, R
# the chase's routing shapes (n, band): svdvals/svd at 1000, svd at 2048,
# both paths at 3840, svdvals at 7680, and a one-lane shape (n = 256)
ROUTE_SHAPES = ((1024, 64), (2048, 128), (3840, 128), (7680, 128), (256, 64))
# the chase variants' shapes: (n, band, khops) of the check against the plain
# versions (phase_kernels' band), of the slice at full width, and (n, band,
# CTAs) of the wavefront kernels with lanes striding over capped CTAs
VAR_CHECK = (1024, 64, 3)
VAR_PATH = (3840, 128, 4)
VAR_CTAS = (2048, 32, 4)
# published H100 SXM peaks (NVIDIA's data sheet, 700 W): float32 outside
# the tensor cores, and HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
DEV = "cuda"


CARD = ""  # the card's name and power limit, as nvidia-smi gives them
TIMED = ("[times]", "[route]", "[profile]", "[slice]", "[svd]", "[ticks]", "[scale]")


def say(*parts):
    """Print a line; a line with a time carries the card and its limit."""
    line = " ".join(str(p) for p in parts)
    if CARD and line.startswith(TIMED):
        line += f" | {CARD}"
    print(line, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps=REPS, warm=True):
    """Median milliseconds of ``fn()`` over ``reps`` runs (after one warm-up
    unless ``warm`` is false), each bracketed by CUDA events."""
    if warm:
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


def in_turns(kern, plain):
    """Kernel and plain version timed in turns (plain, kernel, kernel); the
    plain version, a slow launch-bound loop, once."""
    p1 = cuda_ms(plain, 1, warm=False)
    k1 = cuda_ms(kern)
    k2 = cuda_ms(kern)
    return (k1, k2), p1


def uniform_matrix(n, seed=0):
    """The bench's matrix: uniform [0, 5) float32 from ``default_rng(seed)``."""
    a = np.random.default_rng(seed).uniform(0, 5, (n, n)).astype(np.float32)
    return torch.from_numpy(a).to(DEV)


def gauss_matrix(n, seed=0):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return torch.from_numpy(a).to(DEV)


def bidiag_sigma(d, e):
    """Singular values of bidiag(d, e) in float64 on the card (oracle only)."""
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    return torch.linalg.svdvals(B)


def _counters():
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_vmem,
                                              band_chase_wave, bisect, panel_qr,
                                              tridiag_solve)

    return {"panel_qr": (panel_qr, "launches"),
            "band_chase": (band_chase, "launches"),
            "band_chase_rec": (band_chase, "launches_rec"),
            "bisect": (bisect, "launches"),
            "bisect_thread": (bisect, "launches_thread"),
            "tridiag_solve": (tridiag_solve, "launches"),
            "tridiag_solve_lane": (tridiag_solve, "launches_lane"),
            "band_chase_wave": (band_chase_wave, "launches"),
            "band_chase_wave_dl": (band_chase_wave, "launches_dl"),
            "band_chase_wave_rec": (band_chase_wave, "launches_rec"),
            "band_chase_wave_l2": (band_chase_wave, "launches_l2"),
            "band_chase_wave_rec_l2": (band_chase_wave, "launches_rec_l2"),
            "band_chase_staged": (band_chase, "launches_staged"),
            "band_chase_vmem": (band_chase_vmem, "launches")}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


# ---- work of each kernel, from its shapes (for its bound) ----

def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of float32 operations over the peak
    rate and bytes over the HBM rate."""
    t_ops = flops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def work_panel_qr(b, m, r_off):
    """Householder QR of the (b, m) transposed panel with the larft T:
    per column j with L = m - p active entries, its norm and scaling (3L),
    the update of the b-j-1 later rows (4L each), V^T v (2Lj) and T w (j^2).
    Bytes: Pt in; Rt, Vt, Tt out."""
    flops = 0
    for j in range(b):
        L = max(m - (r_off + j), 0)
        flops += 3 * L + 4 * L * (b - j - 1) + 2 * L * j + j * j
    return flops, 4 * (3 * b * m + b * b)


def work_chase(n, b, record):
    """Every pair of the schedule: a reflector from b entries (3b) applied
    to the window rows it reaches (4 per entry), on each side, clipped at n.
    Bytes: the band's n (b + 1) entries in, d and e out, and with
    ``record`` the v and tau of every reflector (the slots the schedule
    fills)."""
    from svdsolver_tpu_torch.ops.chase_schedule import nc_of_static

    def pair(r0, c0, wr, lr0):
        if c0 >= n:
            return 0
        cols = min(b, n - c0)
        rl = r0 + lr0
        return (3 * b + 4 * min(wr, n - r0) * cols
                + 3 * b + 4 * max(min(b, n - rl), 0) * min(2 * b, n - c0))

    flops = pairs = 0
    for i in range(n - 1):
        flops += pair(i, i + 1, b + 1, 1)
        for k in range(nc_of_static(i, n, b)):
            r = i + 1 + k * b
            flops += pair(r, r + b, 2 * b, b)
        pairs += 1 + nc_of_static(i, n, b)
    nbytes = 4 * (n * (b + 1) + 2 * n)
    if record:  # each pair's two reflectors: b entries and tau each
        nbytes += 4 * 2 * pairs * (b + 1)
    return flops, nbytes


def work_bisect(n, iters, probes):
    """Each Sturm count: n steps of two divisions and two subtractions."""
    return 4 * n * n * iters * probes, 4 * 3 * n


def work_tgk(N, k):
    """Per row and lane: forward one division, three products, three
    differences; backward one division, two products, two differences.
    Bytes: rhs in, x out, z and lam."""
    return 12 * N * k, 4 * (2 * N * k + N + k)


# ---- phases ----

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    global CARD
    say("[device]", name)
    say(smi.splitlines()[0])
    CARD = smi.splitlines()[0].strip()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    from svdsolver_tpu_torch.ops.cuda import _build
    say("[device] nvcc:", run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    return name, smi.splitlines()[0]


def phase_build():
    from svdsolver_tpu_torch.ops.cuda import _build

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = [pool.submit(_build.build, name) for name in SOURCES]
    failed = []
    for name, job in zip(SOURCES, built):
        try:
            path, seconds, log = job.result()
        except RuntimeError as exc:  # report every source that fails
            say(f"[build] {name}: FAILED\n{exc}")
            failed.append(name)
            continue
        say(f"[build] {name}: {seconds:.2f} s -> {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")
    require(not failed, f"kernel sources failed to build: {failed}")


def check_records(label, Ab, b, rec):
    """The chase records rebuild the band: L B R^T = Ab with L, R built by
    the rank-1 reference back-transform on the identity, both orthogonal."""
    from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors

    d, e, VL, TL, VR, TR = rec
    n = Ab.shape[0]
    eye = torch.eye(n, device=Ab.device)
    L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
    R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
    B = torch.diag(d) + torch.diag(e, 1)
    rebuild = float((L @ B @ R.T - Ab).abs().max() / Ab.abs().max())
    orth_l = float((L.T @ L - eye).abs().max())
    orth_r = float((R.T @ R - eye).abs().max())
    say(f"[kernels] records n={n} b={b} {label}: |L B R^T - Ab| / |Ab| "
        f"{rebuild:.3e}, |L^T L - I| {orth_l:.3e}, |R^T R - I| {orth_r:.3e}")
    require(rebuild <= TOL_REBUILD, f"{label} records rebuild the band at n={n}")
    require(max(orth_l, orth_r) <= TOL_REBUILD, f"{label} L, R orthogonal at n={n}")


def tgk_problem(rng, n):
    """The recipe of the JAX package's tgk-solve parity test, on the card."""
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 5).to(DEV)
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32) * 5).to(DEV)
    z = torch.zeros(2 * n - 1, device=DEV)
    z[0::2] = d
    z[1::2] = e
    sig = torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)).contiguous()
    eps = torch.finfo(torch.float32).eps
    pivmin = torch.clamp_min(sig.abs().max() * eps * eps, torch.finfo(torch.float32).tiny)
    big = torch.tensor(torch.finfo(torch.float32).max ** 0.5 / 16.0, device=DEV)
    rhs = torch.from_numpy(rng.normal(size=(2 * n, n)).astype(np.float32)).to(DEV)
    return z, sig, rhs, pivmin, big


def chase_entry(n, b, record):
    """The chase the main path takes for an (n, n) band ``b``: (launch
    counter name, entry point), by the routing predicates."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    if record:
        if band_chase_wave.wave_chase_accum_preferred(n, b):
            return "band_chase_wave_rec", band_chase_wave.band_to_bidiagonal_wave_accum
        return "band_chase_rec", band_chase.band_to_bidiagonal_accum
    if band_chase_wave.wave_chase_preferred(n, b):
        return "band_chase_wave", band_chase_wave.band_to_bidiagonal_wave
    return "band_chase", band_chase.band_to_bidiagonal


def path_band(n):
    """(padded n, band) of the main paths' Stage I for an (n, n) input."""
    from svdsolver_tpu_torch.models.svd import _auto_block

    b = _auto_block(n)
    while b >= n and b > 2:
        b //= 2
    return -(-n // b) * b, b


def check_panel_qr(rng):
    """K1 against its plain version at K1_SHAPES: outputs within TOL_K1,
    exact zeros and ones of the contract, identity reflectors past m, two
    launches bit-identical, Q = I - V T V^T orthogonal and Q R = P within
    TOL_Q (float64).  Returns the largest |kernel - plain|."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    k1 = 0.0
    for b, m, r_off in K1_SHAPES:
        plan = panel_qr.cluster_plan(b, m)
        Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).to(DEV)
        panel_qr.launches = 0
        got = panel_qr.panel_qr(Pt, r_off)
        again = panel_qr.panel_qr(Pt, r_off)
        torch.cuda.synchronize()
        require(panel_qr.launches == 2, "panel_qr counts its launches")
        shape = f"b={b} m={m} r_off={r_off}"
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"panel_qr {shape}: two launches bit-identical")
        say(f"[kernels] panel_qr {shape}: one cluster of {plan.ctas} CTAs x "
            f"{plan.width} columns ({plan.smem_cols} in shared memory"
            f"{', the rest in device memory' if plan.spill else ''}), "
            f"{plan.smem} B shared memory a CTA; two launches bit-identical")
        want = panel_qr.panel_qr_plain(Pt, r_off)
        torch.cuda.synchronize()
        for label, g, w in zip("RVT", got, want):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            require(err <= TOL_K1 * scale, f"panel_qr {label} {shape}: "
                    f"{err:.3e} > {TOL_K1} * {scale:.3e}")
            k1 = max(k1, err)
            say(f"[kernels] panel_qr {shape} {label}: max_abs_err {err:.3e} "
                f"(scale {scale:.3e})")
        Rt, Vt, Tt = got
        cols = torch.arange(m, device=DEV)[None, :]
        piv = r_off + torch.arange(b, device=DEV)[:, None]
        require(bool((Rt[cols > piv] == 0).all()), f"panel_qr {shape}: R zero past the pivot")
        require(bool((Vt[cols < piv] == 0).all()), f"panel_qr {shape}: V zero before the pivot")
        live = max(0, min(b, m - r_off))
        require(bool((Vt[:live].gather(1, piv[:live]) == 1).all()),
                f"panel_qr {shape}: V one at the pivot")
        if live < b:
            require(bool((Tt[live:] == 0).all()) and bool((Vt[live:] == 0).all()),
                    f"panel_qr {shape}: identity reflectors past m")
            say(f"[kernels] panel_qr {shape}: {b - live} identity reflectors: "
                "tau 0, zero T rows, zero V rows")
        V, T = Vt.double().T, Tt.double().T
        R, P = Rt.double().T, Pt.double().T
        Q = torch.eye(m, dtype=torch.float64, device=DEV) - V @ T @ V.T
        orth = float((Q.T @ Q - torch.eye(m, dtype=torch.float64, device=DEV)).abs().max())
        rebuild = float(torch.linalg.norm(Q @ R - P) / torch.linalg.norm(P))
        say(f"[kernels] panel_qr {shape}: |Q^T Q - I| {orth:.3e}, "
            f"|Q R - P|_F / |P|_F {rebuild:.3e} (tolerance {TOL_Q})")
        require(orth <= TOL_Q and rebuild <= TOL_Q, f"panel_qr {shape}: Q R = P, Q orthogonal")
        del Q, V, T, R, P
    torch.cuda.empty_cache()
    return k1


def check_bisect_tree(rng, d1024, e1024):
    """K2's tree against the one-thread design: sigma bit-equal at every n of
    K2_CHECK (the chase's bidiagonal at 1024, uniform [0, 5) entries
    elsewhere), probes 1 and 3, for the routed group and every other."""
    from svdsolver_tpu_torch.ops.cuda import bisect

    for n in K2_CHECK:
        if n == 1024:
            d, e = d1024, e1024
        else:
            d = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32)).to(DEV)
            e = torch.from_numpy(rng.uniform(0, 5, n - 1).astype(np.float32)).to(DEV)
        for probes in (1, 3):
            want = bisect.bisect_svdvals(d, e, probes=probes, _group=1)
            routed = None
            for group in (None,) + GROUPS[1:]:
                bisect.last_group = None  # n = 1 launches nothing
                got = bisect.bisect_svdvals(d, e, probes=probes, _group=group)
                routed = routed or bisect.last_group
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"bisect tree n={n} probes={probes} "
                        f"G={bisect.last_group}: {int((got != want).sum())} bit-unequal")
            say(f"[kernels] bisect tree n={n} probes={probes}: routed G={routed} and "
                f"G={', '.join(map(str, GROUPS[1:]))} bit-equal to the one-thread design")


def phase_kernels(rng):
    """Each kernel against its plain version, same inputs, on the card."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr, tridiag_solve

    errs = {}
    errs["panel_qr"] = check_panel_qr(rng)

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

    # K6-K8: the recording chase on the same band, and at n = 3840, b = 128.
    rec = band_chase.band_to_bidiagonal_accum(Ab, band=b)
    rec_p = band_chase.band_to_bidiagonal_accum_plain(Ab, band=b)
    require(torch.equal(rec[0], d) and torch.equal(rec[1], e),
            "recording chase (d, e) bit-equal to the chase kernel at n=1024")
    require(torch.equal(rec_p[0], dp) and torch.equal(rec_p[1], ep),
            "plain recording chase (d, e) bit-equal to the plain chase")
    say(f"[kernels] band_chase_rec n={n} b={b}: (d, e) bit-equal to band_chase")
    check_records("kernel", Ab, b, rec)
    check_records("plain", Ab, b, rec_p)
    errs["band_chase_rec"] = float((bidiag_sigma(rec[0], rec[1])
                                    - bidiag_sigma(rec_p[0], rec_p[1])).abs().max())
    del rec, rec_p
    n3, b3 = 3840, 128
    Ab3 = panel_qr.dense_to_band_fused(uniform_matrix(n3), band=b3)
    rec = band_chase.band_to_bidiagonal_accum(Ab3, band=b3)
    d3, e3 = band_chase.band_to_bidiagonal(Ab3, band=b3)
    require(torch.equal(rec[0], d3) and torch.equal(rec[1], e3),
            "recording chase (d, e) bit-equal to the chase kernel at n=3840")
    say(f"[kernels] band_chase_rec n={n3} b={b3}: (d, e) bit-equal to band_chase")
    check_records("kernel", Ab3, b3, rec)
    del rec, Ab3
    torch.cuda.empty_cache()

    # K2: bisection at n = 1024 on the chase's bidiagonal, probes 1 and 3:
    # the tree kernel against the plain version, and against the
    # one-thread design at K2_CHECK for every group
    k2 = 0.0
    for probes in (1, 3):
        s = bisect.bisect_svdvals(d, e, probes=probes)
        sp = bisect.bisect_svdvals_plain(d, e, probes=probes)
        torch.cuda.synchronize()
        err = float((s - sp).abs().max())
        top = float(sp.abs().max())
        say(f"[kernels] bisect n={n} probes={probes} (G={bisect.last_group}): "
            f"max_abs_err {err:.3e} (sigma_max {top:.3e}), {int((s != sp).sum())} "
            f"of {n} bit-unequal to the plain version")
        require(torch.allclose(s, sp, rtol=1e-6, atol=1e-7 * top),
                f"bisect probes={probes} vs plain")
        require(torch.allclose(s.double(), s_k, rtol=2e-5, atol=1e-5 * top),
                f"bisect probes={probes} vs float64")
        k2 = max(k2, err)
    errs["bisect"] = k2
    check_bisect_tree(rng, d, e)

    # K9 + K10: the TGK solve, normalized columns within 64 eps of the
    # plain version, bit-equal to the first design (also at svds' lane
    # counts, not multiples of 4)
    eps = torch.finfo(torch.float32).eps
    k9 = 0.0
    for nt, kt in [(nt, None) for nt in TGK_CHECK] + [(SVDS_CASE[0], 997), (SVDS_CASE[0], 250)]:
        z, sig, rhs, pivmin, big = tgk_problem(rng, nt)
        if kt is not None:
            sig, rhs = sig[:kt].contiguous(), rhs[:, :kt].contiguous()
        args = (z, sig, rhs, pivmin, big)
        tridiag_solve.launches = tridiag_solve.launches_lane = 0
        x = tridiag_solve.tgk_solve(*args)
        old = tridiag_solve.tgk_solve(*args, _staged=False)
        torch.cuda.synchronize()
        require((tridiag_solve.launches, tridiag_solve.launches_lane) == (1, 1),
                "tridiag_solve counts each design's launches")
        shape = f"n={nt} ({2 * nt} rows, {sig.shape[0]} lanes)"
        require(torch.equal(x, old), f"tridiag_solve {shape}: staged bit-equal to the first design")
        if kt is not None:
            say(f"[kernels] tridiag_solve {shape}: staged kernel bit-equal to the first design")
            continue
        xp = tridiag_solve.tgk_solve_plain(*args)
        torch.cuda.synchronize()
        unequal = int((x != xp).sum())
        err = float((x / x.norm(dim=0) - xp / xp.norm(dim=0)).abs().max())
        say(f"[kernels] tridiag_solve {shape}: staged kernel bit-equal to the first "
            f"design; normalized max_abs_err {err:.3e} against the plain version "
            f"(64 eps = {64 * eps:.3e}), {unequal} of {x.numel()} entries bit-unequal")
        require(err < 64 * eps, f"tridiag_solve n={nt} vs plain")
        k9 = max(k9, err)
    errs["tridiag_solve"] = k9
    return errs, (Ab, d, e, dp, ep)


def variant_calls(b, khops):
    """The chase variants' entry points at band ``b``: call name -> (launch
    counter it moves, call on a band)."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_vmem, band_chase_wave

    return {
        "wave": ("band_chase_wave",
                 lambda A: band_chase_wave.band_to_bidiagonal_wave(A, band=b)),
        "wavefront=True": ("band_chase_wave",
                           lambda A: band_chase.band_to_bidiagonal(A, band=b, wavefront=True)),
        "wave_dl": ("band_chase_wave_dl",
                    lambda A: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=b)),
        "pipelined=True": ("band_chase_staged",
                           lambda A: band_chase.band_to_bidiagonal(A, band=b, pipelined=True)),
        f"mega=True khops={khops}": (
            "band_chase_staged",
            lambda A: band_chase.band_to_bidiagonal(A, band=b, mega=True, khops=khops)),
        "vmem": ("band_chase_vmem",
                 lambda A: band_chase_vmem.band_to_bidiagonal_vmem(A, band=b)),
    }


def require_bit_equal(label, got, want):
    d, e = got
    require(torch.equal(d, want[0]) and torch.equal(e, want[1]),
            f"{label}: (d, e) bit-equal to the chase kernel's")


def check_wave_rec(label, Ab, b, ctas=None):
    """The recording wavefront chase against the sequential recording chase
    on one band: (d, e) and all four records bit-equal."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    want = band_chase.band_to_bidiagonal_accum(Ab, band=b)
    got = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b, _ctas=ctas)
    torch.cuda.synchronize()
    if ctas is not None:
        require(band_chase_wave.last_ctas == ctas, "the _ctas cap holds")
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        require(torch.equal(g, w), f"wave_accum {label}: {name} bit-equal to band_chase_rec's")
    say(f"[variants] wave_accum {label} on {band_chase_wave.last_ctas} CTAs: (d, e) "
        "and VL, TL, VR, TR bit-equal to band_chase_rec")


def phase_variants(band_state):
    """The chase variants, the third path (K11-K15): every entry point on
    the band of ``phase_kernels`` (VAR_CHECK), on the Stage I kernel's band
    at the slice's full width (VAR_PATH) and, for the wavefront kernels on
    capped CTAs, at VAR_CTAS; each one's (d, e) bit-equal to the chase
    kernel's on the same band.  Returns the launch counts of the full-width
    run, each kernel's max spectrum difference from its plain version and
    the plain versions' times (VAR_CHECK), and the kernels' times."""
    from svdsolver_tpu_torch.models import two_stage
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_vmem,
                                              band_chase_wave, bisect, panel_qr)

    def drive(label, calls, A, want):
        """Each call once, every count set to 0 just before and read just
        after; returns the outputs and the counts."""
        torch.cuda.synchronize()
        reset_counts()
        outs = {name: fn(A) for name, (_, fn) in calls.items()}
        torch.cuda.synchronize()
        counts = read_counts()
        say(f"[variants] {label}: launches {counts}, staged khops "
            f"{band_chase.last_khops}, wave CTAs {band_chase_wave.last_ctas}")
        for name in calls:
            require_bit_equal(f"{name} {label}", outs[name], want)
        for k in VARIANTS:
            require(counts[k] >= 1, f"{k} not launched at {label}")
        require(counts["band_chase"] == 0 and counts["band_chase_rec"] == 0,
                f"a variant took the sequential kernel at {label}")
        say(f"[variants] {label}: {', '.join(calls)}: (d, e) bit-equal to band_chase")
        return outs, counts

    # each kernel against the chase kernel and against its plain version
    # (spectrum, leading |d|), each plain version once
    n1, b1, khops1 = VAR_CHECK
    Ab1, d1, e1, dp1, ep1 = band_state
    outs, _ = drive(f"n={n1} b={b1}", variant_calls(b1, khops1), Ab1, (d1, e1))
    check_wave_rec(f"n={n1} b={b1}", Ab1, b1)
    require(band_chase.last_khops == band_chase.staged_khops(b1, khops1) == khops1,
            f"mega khops={khops1} at b={b1} runs {khops1} pairs a window")
    plains = {
        "band_chase_wave": ("wave", band_chase_wave.band_to_bidiagonal_wave_plain),
        "band_chase_wave_dl": ("wave_dl", band_chase_wave.band_to_bidiagonal_wave_dl_plain),
        "band_chase_vmem": ("vmem", band_chase_vmem.band_to_bidiagonal_vmem_plain),
    }
    errs, plain_ms = {}, {}
    for k, (name, plain) in plains.items():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dp, ep = plain(Ab1, band=b1)
        stop.record()
        torch.cuda.synchronize()
        plain_ms[k] = start.elapsed_time(stop)
        same = torch.equal(dp, dp1) and torch.equal(ep, ep1)
        say(f"[variants] {k} plain version n={n1} b={b1}: {plain_ms[k]:.3f} ms "
            f"(one run), (d, e) {'bit-equal' if same else 'not bit-equal'} to "
            "the plain chase's")
        plains[k] = (name, (dp, ep))
    plains["band_chase_staged"] = ("pipelined=True", (dp1, ep1))  # its plain version
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    rec_p = band_chase_wave.band_to_bidiagonal_wave_accum_plain(Ab1, band=b1)
    stop.record()
    torch.cuda.synchronize()
    plain_ms["band_chase_wave_rec"] = start.elapsed_time(stop)
    rec_k = band_chase_wave.band_to_bidiagonal_wave_accum(Ab1, band=b1)
    seq_p = band_chase.band_to_bidiagonal_accum_plain(Ab1, band=b1)
    same = all(torch.equal(x, y) for x, y in zip(rec_p, seq_p))
    say(f"[variants] band_chase_wave_rec plain version n={n1} b={b1}: "
        f"{plain_ms['band_chase_wave_rec']:.3f} ms (one run), (d, e) and records "
        f"{'bit-equal' if same else 'not bit-equal'} to the plain recording chase's")
    check_records("wave_accum kernel", Ab1, b1, rec_k)
    errs["band_chase_wave_rec"] = float((bidiag_sigma(rec_k[0], rec_k[1])
                                         - bidiag_sigma(rec_p[0], rec_p[1])).abs().max())
    del rec_p, rec_k, seq_p
    # the L2 tick of both entries (off the path at b <= 128) on the same band
    for k, fn in (("band_chase_wave_l2", band_chase_wave.band_to_bidiagonal_wave),
                  ("band_chase_wave_rec_l2", band_chase_wave.band_to_bidiagonal_wave_accum)):
        got = fn(Ab1, band=b1, _tick="l2")
        torch.cuda.synchronize()
        require_bit_equal(f"{k} n={n1} b={b1}", got[:2], (d1, e1))
        errs[k] = float((bidiag_sigma(got[0], got[1]) - bidiag_sigma(dp1, ep1)).abs().max())
        say(f"[variants] {k} n={n1} b={b1}: (d, e) bit-equal to band_chase; spectrum vs "
            f"the plain chase {errs[k]:.3e}")
    s_a = torch.linalg.svdvals(Ab1.double())
    smax = float(s_a[0])
    for k, (name, (dp, ep)) in plains.items():
        d, e = outs[name]
        s_k, s_p = bidiag_sigma(d, e), bidiag_sigma(dp, ep)
        errs[k] = float((s_k - s_p).abs().max())
        lead = float(((d.abs() - dp.abs())[:8].abs() / dp.abs()[:8]).max())
        say(f"[variants] {k} n={n1} b={b1}: spectrum kernel vs plain "
            f"{errs[k]:.3e} (vs float64 sigma(Ab): kernel "
            f"{float((s_k - s_a).abs().max()) / smax:.3e}, plain "
            f"{float((s_p - s_a).abs().max()) / smax:.3e} * sigma_max), "
            f"|d|[:8] rel diff {lead:.3e}")
        require(torch.allclose(s_k, s_p, rtol=2e-5, atol=1e-5 * smax),
                f"{k} spectrum vs plain")
        require(lead <= 1e-4, f"{k} leading |d| vs plain")

    # the wavefront kernels with more lanes than CTAs: lanes stride over them
    n2, b2, ctas = VAR_CTAS
    A2 = panel_qr.dense_to_band_fused(uniform_matrix(n2, seed=2), band=b2)
    want2 = band_chase.band_to_bidiagonal(A2, band=b2)
    for name, fn in (("wave", band_chase_wave.band_to_bidiagonal_wave),
                     ("wave_dl", band_chase_wave.band_to_bidiagonal_wave_dl)):
        got = fn(A2, band=b2, _ctas=ctas)
        torch.cuda.synchronize()
        require(band_chase_wave.last_ctas == ctas, "the _ctas cap holds")
        require_bit_equal(f"{name} n={n2} b={b2} on {ctas} CTAs", got, want2)
        lanes = two_stage.wave_lanes(n2, b2, defer_left=name == "wave_dl") + 1
        say(f"[variants] {name} n={n2} b={b2}: {lanes} lanes (the head's "
            f"included) on {ctas} CTAs, (d, e) bit-equal to band_chase")
    check_wave_rec(f"n={n2} b={b2}", A2, b2, ctas=ctas)
    del A2

    # past b = 128 both wavefront entries take the L2 tick (the deferred-left
    # entry always does: its count is its own)
    nw, bwide = WIDE_BAND
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(nw, nw)).astype(np.float32)).to(DEV)
    Aw = torch.triu(torch.tril(g, bwide)).contiguous()
    torch.cuda.synchronize()
    reset_counts()
    got = band_chase_wave.band_to_bidiagonal_wave(Aw, band=bwide)
    got_rec = band_chase_wave.band_to_bidiagonal_wave_accum(Aw, band=bwide)
    torch.cuda.synchronize()
    wide = read_counts()
    require(wide["band_chase_wave_l2"] == 1 and wide["band_chase_wave_rec_l2"] == 1
            and wide["band_chase_wave"] == 0 and wide["band_chase_wave_rec"] == 0,
            f"b={bwide} takes the L2 tick: {wide}")
    require_bit_equal(f"wave n={nw} b={bwide} (L2 tick)", got,
                      band_chase.band_to_bidiagonal(Aw, band=bwide))
    require(all(torch.equal(x, y) for x, y in
                zip(got_rec, band_chase.band_to_bidiagonal_accum(Aw, band=bwide))),
            f"wave_accum n={nw} b={bwide} (L2 tick) bit-equal to band_chase_rec")
    say(f"[variants] n={nw} b={bwide}: both wavefront entries took the L2 tick "
        f"(launches {wide}); (d, e) and records bit-equal to the sequential kernels")
    del Aw, g, got, got_rec

    # the slice at full width: every entry point once, on the Stage I band
    n, b, khops = VAR_PATH
    A = uniform_matrix(n)
    Ab3 = panel_qr.dense_to_band_fused(A, band=b)
    want3 = band_chase.band_to_bidiagonal(Ab3, band=b)
    outs3, counts = drive(f"n={n} b={b}", variant_calls(b, khops), Ab3, want3)
    check_wave_rec(f"n={n} b={b}", Ab3, b)
    require(band_chase.last_khops == band_chase.staged_khops(b, khops),
            f"mega khops={khops} at b={b} runs the largest window that fits")
    s_ref = torch.linalg.svdvals(A.double())
    for name, (d, e) in outs3.items():
        s = bisect.bisect_svdvals(d, e)
        err = float((s.double() - s_ref).abs().max() / s_ref[0])
        say(f"[variants] {name} n={n}: bisection sigma vs float64 sigma(A) "
            f"{err:.3e} * sigma_max")
        require(err <= TOL_SIGMA, f"{name} sigma at n={n}")
    del outs3, s_ref

    # times: every variant in turns with the chase kernel (A B C .. C B A),
    # at full width and on the check band (the kernel table's shape)
    timed = {
        "band_chase": lambda A, b: band_chase.band_to_bidiagonal(A, band=b),
        "band_chase_wave": lambda A, b: band_chase_wave.band_to_bidiagonal_wave(A, band=b),
        "band_chase_wave_l2": lambda A, b: band_chase_wave.band_to_bidiagonal_wave(
            A, band=b, _tick="l2"),
        "band_chase_wave_dl": lambda A, b: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=b),
        "band_chase_staged": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, pipelined=True),
        "band_chase_vmem": lambda A, b: band_chase_vmem.band_to_bidiagonal_vmem(A, band=b),
    }
    times = {}
    for label, Ab_, n_, b_ in (("path", Ab3, n, b), ("check", Ab1, n1, b1)):
        got = {}
        for k in list(timed) + list(timed)[::-1]:
            got.setdefault(k, []).append(cuda_ms(lambda: timed[k](Ab_, b_), SVD_REPS))
        for k, (t1, t2) in got.items():
            times[k, label] = min(t1, t2)
            say(f"[times] {k} n={n_} b={b_}: {t1:.3f} / {t2:.3f} ms (medians "
                f"of {SVD_REPS}, in turns)")
    phase_profile(f"wave chase n={n}",
                  lambda: band_chase_wave.band_to_bidiagonal_wave(Ab3, band=b))
    del Ab3, A
    torch.cuda.empty_cache()
    return counts, errs, plain_ms, times


def require_route(label, counts, record):
    """The run launched the path's kernels and, of the chase entries, only
    the one the routing predicates pick (``record``: the recording ones)."""
    n, b = label
    chase, _ = chase_entry(n, b, record)
    for k in CHASES:
        if k == chase:
            require(counts[k] == 1, f"{k} launched once at n={n} b={b}")
        else:
            require(counts[k] == 0, f"{k} launched at n={n} b={b}, the route is {chase}")
    for k in VARIANTS:
        if k != chase:
            require(counts[k] == 0, f"{k} launched at n={n} b={b}")
    return chase


def require_routed_bit_equal(label, A, record):
    """At ``A``'s size: the routed chase and the sequential one on the same
    Stage I band give the same (d, e) (and records) bit for bit."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr

    n, b = path_band(A.shape[0])
    chase, fn = chase_entry(n, b, record)
    seq = band_chase.band_to_bidiagonal_accum if record else band_chase.band_to_bidiagonal
    Ab = (panel_qr.dense_to_band_rec_fused(A, band=b)[0] if record
          else panel_qr.dense_to_band_fused(A, band=b))
    got, want = fn(Ab, band=b), seq(Ab, band=b)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{label}: the routed {chase} bit-equal to the sequential kernel")
    say(f"{label}: the routed {chase} gives {'(d, e) and records' if record else '(d, e)'} "
        f"bit-equal to {'band_chase_rec' if record else 'band_chase'} on the same band")


def phase_slice():
    """svdvals, the first main path, at each size; returns the launch counts
    at each n."""
    from svdsolver_tpu_torch import svdvals
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by_n = {}
    for n in SLICE_SIZES:
        A = uniform_matrix(n)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = svdvals(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        say(f"[slice] n={n}: svdvals {seconds:.3f} s (host clock, first call "
            f"at this size) launches {counts}")
        for k in ("panel_qr", "bisect"):
            require(counts[k] > 0, f"kernel {k} not launched by svdvals at n={n}")
        require(counts["bisect_thread"] == 0, f"svdvals at n={n} took the one-thread K2")
        say(f"[slice] n={n}: K2 took the tree, G={bisect.last_group}")
        chase = require_route(path_band(n), counts, record=False)
        say(f"[slice] n={n}: the chase took {chase} (wave_chase_preferred"
            f"{path_band(n)} = {chase == 'band_chase_wave'})")
        require(s.shape == (n,) and bool(torch.isfinite(s).all()),
                f"svdvals output at n={n}")
        ref = torch.linalg.svdvals(A.double())
        err = float((s.double() - ref).abs().max() / ref[0])
        say(f"[slice] n={n}: max|sigma - sigma_ref| / sigma_max = {err:.3e}")
        require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n}")
        if n == 3840:
            require_routed_bit_equal(f"[slice] n={n}", A, record=False)
        counts_by_n[n] = counts
        del A, s, ref
        torch.cuda.empty_cache()
    return counts_by_n


def phase_svd():
    """svd, the second main path, at each case; returns the launch counts
    at each n."""
    from svdsolver_tpu_torch import svd
    from svdsolver_tpu_torch.models import vectors
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by_n = {}
    eps = torch.finfo(torch.float32).eps
    for n, kind in SVD_CASES:
        A = uniform_matrix(n) if kind == "uniform" else gauss_matrix(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        U, s, Vh = svd(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        say(f"[svd] n={n} {kind}: svd {seconds:.3f} s (host clock, first call "
            f"at this size) launches {counts}")
        for k in SVD_PATH:
            require(counts[k] > 0, f"kernel {k} not launched by svd at n={n}")
        require(counts["tridiag_solve"] == 2, "two TGK solves (iters = 2)")
        require(counts["bisect_thread"] == 0 and counts["tridiag_solve_lane"] == 0,
                f"svd at n={n} took a first design of K2 or K9/K10")
        say(f"[svd] n={n}: K2 took the tree (G={bisect.last_group}), K9/K10 the "
            f"staged solve; peak device memory {peak / 2**30:.3f} GiB "
            f"({peak / (4 * n * n):.2f} floats per n^2)")
        chase = require_route(path_band(n), counts, record=True)
        say(f"[svd] n={n}: the chase took {chase} (wave_chase_accum_preferred"
            f"{path_band(n)} = {chase == 'band_chase_wave_rec'})")
        require(U.shape == (n, n) and s.shape == (n,) and Vh.shape == (n, n),
                f"svd shapes at n={n}")
        require(all(bool(torch.isfinite(t).all()) for t in (U, s, Vh)),
                f"svd output finite at n={n}")
        ref = torch.linalg.svdvals(A.double())
        smax = float(ref[0])
        sig_err = float((s.double() - ref).abs().max()) / smax
        Ud, Vd = U.double(), Vh.double()
        recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / smax
        eye = torch.eye(n, dtype=torch.float64, device=DEV)
        orth_u = float((Ud.T @ Ud - eye).abs().max())
        orth_v = float((Vd @ Vd.T - eye).abs().max())
        rid, start, end = vectors._cluster_bounds(s, 64 * eps)
        width = end - start + 1
        clustered = width > 1
        n_clusters = int(torch.unique(rid[clustered]).numel())
        widest = int(width.max())
        dense = bool(vectors._has_wide_cluster(s, 64 * eps))
        say(f"[svd] n={n} {kind}: sigma err {sig_err:.3e}, |U S Vh - A| "
            f"{recon:.3e} (both / sigma_max), |U^T U - I| {orth_u:.3e}, "
            f"|Vh Vh^T - I| {orth_v:.3e}")
        say(f"[svd] n={n} {kind}: {n_clusters} clusters over "
            f"{int(clustered.sum())} values, widest {widest}; dense cluster "
            f"orthogonalization {'taken' if dense else 'not taken'}")
        require(sig_err <= TOL_SIGMA, f"svd sigma error at n={n}")
        require(recon <= TOL_RECON, f"svd reconstruction at n={n}")
        require(max(orth_u, orth_v) <= TOL_ORTH, f"svd orthogonality at n={n}")
        del U, s, Vh, Ud, Vd, ref, eye
        if n == 3840:
            require_routed_bit_equal(f"[svd] n={n}", A, record=True)
        counts_by_n[n] = counts
        del A
        torch.cuda.empty_cache()
    return counts_by_n


def phase_svds():
    """svds, the partial path, at SVDS_CASE (k lanes not a multiple of 4):
    the top-k sigma against float64, |A Vh^T - U diag(s)| / sigma_max and
    the orthogonality of U and Vh; returns the launch counts."""
    from svdsolver_tpu_torch import svds

    n, k = SVDS_CASE
    A = uniform_matrix(n, seed=4)
    torch.cuda.synchronize()
    reset_counts()
    U, s, Vh = svds(A, k)
    torch.cuda.synchronize()
    counts = read_counts()
    say(f"[svd] svds n={n} k={k}: launches {counts}")
    for k_ in SVD_PATH:
        require(counts[k_] > 0, f"kernel {k_} not launched by svds")
    require(counts["tridiag_solve"] == 2 and counts["tridiag_solve_lane"] == 0
            and counts["bisect_thread"] == 0, "svds took the staged solve and the tree")
    require(U.shape == (n, k) and s.shape == (k,) and Vh.shape == (k, n), "svds shapes")
    ref = torch.linalg.svdvals(A.double())
    smax = float(ref[0])
    sig_err = float((s.double() - ref[:k]).abs().max()) / smax
    Ud, Vd = U.double(), Vh.double()
    resid = float((A.double() @ Vd.T - Ud * s.double()).abs().max()) / smax
    eye = torch.eye(k, dtype=torch.float64, device=DEV)
    orth = max(float((Ud.T @ Ud - eye).abs().max()), float((Vd @ Vd.T - eye).abs().max()))
    say(f"[svd] svds n={n} k={k}: sigma err {sig_err:.3e}, |A Vh^T - U S| {resid:.3e} "
        f"(both / sigma_max), orthogonality {orth:.3e}")
    require(sig_err <= TOL_SIGMA and resid <= TOL_RECON and orth <= TOL_ORTH,
            f"svds gates at n={n} k={k}")
    return counts


def known_spectrum_matrix(n, seed=5):
    """A float32 (n, n) matrix Q1 diag(sigma) Q2^T with Q1, Q2 the float64
    QR factors of Gaussian matrices drawn on the card from ``seed`` and
    sigma = 100 * 10**(-4 i / (n - 1)) (100 down to 0.01): its singular
    values are known by construction, to the float32 rounding of A (an
    oracle where float64 svdvals would take minutes)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    q1, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=DEV))
    sig = 100.0 * 10.0 ** (-4.0 * torch.arange(n, dtype=torch.float64, device=DEV) / (n - 1))
    q1 *= sig
    q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=DEV))
    A = (q1 @ q2.T).float()
    del q1, q2
    torch.cuda.empty_cache()
    return A, sig


def phase_scale():
    """The scale net: svdvals at SCALE_VALS (past the first Stage I panel's
    old limit of 12,544) and svd at SCALE_SVD, each with the counts set to 0
    just before and read just after; returns the counts, the host-clock
    seconds of each call and the svd's peak device memory."""
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by, seconds_by = {}, {}
    for n in SCALE_VALS:
        if n == 15360:
            A = uniform_matrix(n)
            t0 = time.perf_counter()
            ref = torch.linalg.svdvals(A.double())
            torch.cuda.synchronize()
            oracle = f"float64 torch.linalg.svdvals ({time.perf_counter() - t0:.1f} s)"
        else:
            t0 = time.perf_counter()
            A, ref = known_spectrum_matrix(n)
            torch.cuda.synchronize()
            oracle = (f"sigma known by construction, Q1 diag(sigma) Q2^T "
                      f"({time.perf_counter() - t0:.1f} s to build)")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = svdvals(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        say(f"[scale] svdvals n={n}: {seconds:.3f} s (host clock, first call at this "
            f"size) launches {counts}")
        for k in ("panel_qr", "bisect"):
            require(counts[k] > 0, f"kernel {k} not launched by svdvals at n={n}")
        require(counts["bisect_thread"] == 0, f"svdvals at n={n} took the one-thread K2")
        require_route(path_band(n), counts, record=False)
        require(s.shape == (n,) and bool(torch.isfinite(s).all()), f"svdvals output at n={n}")
        err = float((s.double() - ref).abs().max() / ref[0])
        say(f"[scale] svdvals n={n}: max|sigma - sigma_ref| / sigma_max = {err:.3e} "
            f"(oracle: {oracle}; K2 G={bisect.last_group})")
        require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n}")
        t0 = time.perf_counter()
        svdvals(A)
        torch.cuda.synchronize()
        seconds_by[n] = (seconds, time.perf_counter() - t0)
        say(f"[scale] svdvals n={n}: second call {seconds_by[n][1]:.3f} s (host clock)")
        counts_by[n] = counts
        del A, s, ref
        torch.cuda.empty_cache()

    n = SCALE_SVD
    A = uniform_matrix(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    U, s, Vh = svd(A)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    say(f"[scale] svd n={n}: {seconds:.3f} s (host clock, first call at this size) "
        f"launches {counts}; peak device memory {peak / 2**30:.3f} GiB beyond A "
        f"({peak / (4 * n * n):.2f} floats per n^2)")
    for k in SVD_PATH:
        require(counts[k] > 0, f"kernel {k} not launched by svd at n={n}")
    require(counts["tridiag_solve"] == 2 and counts["tridiag_solve_lane"] == 0
            and counts["bisect_thread"] == 0, f"svd at n={n} took the new designs")
    require_route(path_band(n), counts, record=True)
    require(all(bool(torch.isfinite(t).all()) for t in (U, s, Vh)), f"svd finite at n={n}")
    ref = torch.linalg.svdvals(A.double())
    smax = float(ref[0])
    sig_err = float((s.double() - ref).abs().max()) / smax
    Ud, Vd = U.double(), Vh.double()
    recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / smax
    eye = torch.eye(n, dtype=torch.float64, device=DEV)
    orth_u = float((Ud.T @ Ud - eye).abs().max())
    orth_v = float((Vd @ Vd.T - eye).abs().max())
    say(f"[scale] svd n={n}: sigma err {sig_err:.3e}, |U S Vh - A| {recon:.3e} (both / "
        f"sigma_max), |U^T U - I| {orth_u:.3e}, |Vh Vh^T - I| {orth_v:.3e}")
    require(sig_err <= TOL_SIGMA, f"svd sigma error at n={n}")
    require(recon <= TOL_RECON, f"svd reconstruction at n={n}")
    require(max(orth_u, orth_v) <= TOL_ORTH, f"svd orthogonality at n={n}")
    counts_by["svd", n] = counts
    seconds_by["svd", n] = seconds
    del U, s, Vh, Ud, Vd, ref, eye, A
    torch.cuda.empty_cache()
    return counts_by, seconds_by, peak


def phase_design_times():
    """K2 for each group of GROUPS (1: the one-thread design) and K9/K10's
    staged and first designs, in turns (A B .. B A), at DESIGN_TIMES on the
    main path's inputs: K2 on the routed chase's bidiagonal of the uniform
    matrix, the solve on the tgk-solve parity recipe (2n rows, n lanes)."""
    from svdsolver_tpu_torch.ops.cuda import bisect, panel_qr, tridiag_solve

    rng = np.random.default_rng(6)
    k2, tgk = {}, {}
    for n in DESIGN_TIMES:
        b = path_band(n)[1]
        Ab = panel_qr.dense_to_band_fused(uniform_matrix(n), band=b)
        d, e = chase_entry(n, b, record=False)[1](Ab, band=b)
        del Ab
        got = {}
        for g in GROUPS + GROUPS[::-1]:
            got.setdefault(g, []).append(
                cuda_ms(lambda: bisect.bisect_svdvals(d, e, _group=g)))
        bisect.bisect_svdvals(d, e)
        routed = bisect.last_group
        for g, (t1, t2) in got.items():
            k2[n, g] = min(t1, t2)
            say(f"[times] bisect n={n} G={g}{' (one thread: first design)' if g == 1 else ''}"
                f"{' (routed)' if g == routed else ''}: {t1:.3f} / {t2:.3f} ms "
                f"(medians of {REPS}, in turns)")
        args = tgk_problem(rng, n)
        require(torch.equal(tridiag_solve.tgk_solve(*args), tridiag_solve.tgk_solve(
            *args, _staged=False)), f"tridiag_solve n={n}: staged bit-equal to the first design")
        l1 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args, _staged=False))
        s1 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args))
        s2 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args))
        l2 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args, _staged=False))
        tgk[n] = (min(s1, s2), min(l1, l2))
        say(f"[times] tridiag_solve n={n} ({2 * n} rows, {n} lanes): staged {s1:.3f} / "
            f"{s2:.3f} ms, first design {l1:.3f} / {l2:.3f} ms (medians of {REPS}, in turns; "
            "x bit-equal)")
        del args, d, e
        torch.cuda.empty_cache()
    return k2, tgk


def stage1_widths(n, b):
    """The panel lengths m of Stage I's segments at n (one per segment)."""
    from svdsolver_tpu_torch.models.two_stage import segment_bounds
    from svdsolver_tpu_torch.ops.cuda.panel_qr import _auto_segments

    bounds = segment_bounds(n // b, _auto_segments(n, b))
    return [n - k * b for k in bounds[:-1]]


def phase_k1_times():
    """K1 at (128, 3840) and each Stage I panel length at 3840, in turns with
    its plain version, beside torch.geqrf; the cluster sizes 8 and 16 at
    3840; and a split: the load and store alone (r_off = m: no column), a
    zero panel (every column an identity reflector: one cluster barrier and
    the reflector each) and the full panel."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    rng = np.random.default_rng(2)
    out = {}
    for m in stage1_widths(3840, 128):
        Pt = torch.from_numpy(rng.normal(size=(128, m)).astype(np.float32)).to(DEV)
        (k1, k2), p1 = in_turns(lambda: panel_qr.panel_qr(Pt, 0),
                                lambda: panel_qr.panel_qr_plain(Pt, 0))
        panel = Pt.T.contiguous()
        lib = cuda_ms(lambda: torch.geqrf(panel))
        plan = panel_qr.cluster_plan(128, m)
        out[m] = (min(k1, k2), p1, lib)
        say(f"[times] panel_qr b=128 m={m} ({plan.ctas} CTAs): kernel {k1:.3f} / "
            f"{k2:.3f} ms (medians of {REPS}), plain {p1:.3f} ms (one run), "
            f"torch.geqrf ({m}, 128) {lib:.3f} ms")
        if m == 3840:
            for C in (8, 16, 8):
                t = cuda_ms(lambda: panel_qr.panel_qr(Pt, 0, _cluster=C))
                say(f"[times] panel_qr b=128 m=3840 on a cluster of {C}: {t:.3f} ms")
            zero = torch.zeros_like(Pt)
            split = {"load and store only (r_off = m)": lambda: panel_qr.panel_qr(Pt, m),
                     "zero panel (identity reflectors)": lambda: panel_qr.panel_qr(zero, 0),
                     "full panel": lambda: panel_qr.panel_qr(Pt, 0)}
            for label, fn in split.items():
                say(f"[times] panel_qr split b=128 m=3840 {label}: {cuda_ms(fn):.3f} ms")
    for m in SCALE_VALS:  # the first Stage I panel past the old limit
        Pt = torch.from_numpy(rng.normal(size=(128, m)).astype(np.float32)).to(DEV)
        (k1, k2), p1 = in_turns(lambda: panel_qr.panel_qr(Pt, 0),
                                lambda: panel_qr.panel_qr_plain(Pt, 0))
        panel = Pt.T.contiguous()
        lib = cuda_ms(lambda: torch.geqrf(panel))
        plan = panel_qr.cluster_plan(128, m)
        out[m] = (min(k1, k2), p1, lib)
        say(f"[times] panel_qr b=128 m={m} ({plan.ctas} CTAs, {plan.smem_cols} of "
            f"{plan.width} columns a CTA in shared memory): kernel {k1:.3f} / {k2:.3f} "
            f"ms (medians of {REPS}), plain {p1:.3f} ms (one run), torch.geqrf "
            f"({m}, 128) {lib:.3f} ms")
        del Pt, panel
    return out


def phase_route_times():
    """The predicates' evidence: at each ROUTE_SHAPES band (Stage I's), the
    sequential and wavefront chases in turns (seq, wave, wave, seq; at 7680
    seq, wave, wave), plain and recording entries."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave, panel_qr

    entries = {
        False: (band_chase.band_to_bidiagonal, band_chase_wave.band_to_bidiagonal_wave),
        True: (band_chase.band_to_bidiagonal_accum, band_chase_wave.band_to_bidiagonal_wave_accum),
    }
    out = {}
    for n, b in ROUTE_SHAPES:
        Ab = panel_qr.dense_to_band_fused(uniform_matrix(n), band=b)
        reps = 1 if n > 4000 else SVD_REPS
        for record, (seq, wave) in entries.items():
            res = {}

            def run_seq():
                res["seq"] = seq(Ab, band=b)

            def run_wave():
                res["wave"] = wave(Ab, band=b)

            s1 = cuda_ms(run_seq, reps, warm=n <= 4000)
            w1 = cuda_ms(run_wave, reps)
            w2 = cuda_ms(run_wave, reps)
            # at 7680 the sequential kernel's 3.4 s runs once
            s2 = cuda_ms(run_seq, reps, warm=False) if n <= 4000 else s1
            out[n, b, record] = (min(w1, w2), min(s1, s2))
            same = all(torch.equal(x, y) for x, y in zip(res["wave"], res["seq"]))
            require(same, f"n={n} b={b}: the wavefront chase bit-equal to the sequential one")
            del res
            say(f"[route] n={n} b={b} {'recording' if record else 'plain'}: "
                f"sequential {s1:.3f} / {s2:.3f} ms, wavefront {w1:.3f} / "
                f"{w2:.3f} ms (medians of {reps}, in turns, "
                f"{band_chase_wave.last_ctas} CTAs, {band_chase_wave.last_tick} tick; "
                f"outputs bit-equal); the predicate takes the "
                f"{'wavefront' if chase_entry(n, b, record)[0].startswith('band_chase_wave') else 'sequential'}")
        del Ab
        torch.cuda.empty_cache()
    return out


def schedule_bytes(n, b):
    """Bytes the shared-memory tick's copies move on its critical path: at
    each tick the most any one pair moves (its boxes of b rows x b + 4
    columns in and out, the head pair's window row both ways too)."""
    from svdsolver_tpu_torch.ops.chase_schedule import wave_pairs

    box = 4 * b * (b + 4)
    most = {}
    for p in wave_pairs(n, b):
        nbytes = (len(p.loads) + len(p.stores)) * box + (16 * b if p.s == 0 else 0)
        most[p.t] = max(most.get(p.t, 0), nbytes)
    return sum(most.values())


def phase_tick_times(band_state):
    """The wavefront kernel's two ticks in turns (L2, shared memory, shared
    memory, L2) at TICK_SHAPES, plain and recording entries; one CTA's copy
    rate for a chase window at b = 128 (three b x (b + 4) boxes into shared
    memory and back, 1000 times); and the shared-memory tick's schedule
    bound, its critical path's copy bytes over that rate."""
    from svdsolver_tpu_torch.ops.chase_schedule import wave_ticks
    from svdsolver_tpu_torch.ops.cuda import band_chase_wave as bw, panel_qr

    out, sched = {}, {}
    rate = None
    for n, b in TICK_SHAPES:
        Ab = (band_state[0] if (n, b) == VAR_CHECK[:2]
              else panel_qr.dense_to_band_fused(uniform_matrix(n), band=b))
        reps = 1 if n > 4000 else SVD_REPS
        for record in (False, True):
            fn = bw.band_to_bidiagonal_wave_accum if record else bw.band_to_bidiagonal_wave
            l1 = cuda_ms(lambda: fn(Ab, band=b, _tick="l2"), reps)
            s1 = cuda_ms(lambda: fn(Ab, band=b, _tick="smem"), reps)
            s2 = cuda_ms(lambda: fn(Ab, band=b, _tick="smem"), reps)
            l2 = cuda_ms(lambda: fn(Ab, band=b, _tick="l2"), reps)
            out[n, b, record] = (min(s1, s2), min(l1, l2))
            say(f"[ticks] n={n} b={b} {'recording' if record else 'plain'}: shared-memory "
                f"tick {s1:.3f} / {s2:.3f} ms, L2 tick {l1:.3f} / {l2:.3f} ms (medians of "
                f"{reps}, in turns, {bw.last_ctas} CTAs, {wave_ticks(n, b)} ticks: "
                f"{min(s1, s2) / wave_ticks(n, b) * 1e3:.2f} against "
                f"{min(l1, l2) / wave_ticks(n, b) * 1e3:.2f} us a tick)")
        if b == 128 and rate is None:
            reps_copy = 1000
            r = n // 2
            t = cuda_ms(lambda: bw.window_copy(Ab, b, r, r + b, reps_copy))
            moved = 6 * 4 * b * (b + 4)
            rate = moved * reps_copy / t  # bytes a millisecond
            say(f"[ticks] one CTA's window copy b={b}: {t / reps_copy * 1e3:.3f} us for "
                f"{moved} bytes in and out, {rate / 1e6:.2f} GB/s (median of {REPS} runs of "
                f"{reps_copy})")
        del Ab
        torch.cuda.empty_cache()
    for n, b in TICK_SHAPES:
        nbytes = schedule_bytes(n, b)
        sched[n, b] = nbytes / rate
        say(f"[ticks] schedule bound n={n} b={b}: {nbytes:.4g} bytes on the critical "
            f"path over {rate / 1e6:.2f} GB/s = {sched[n, b]:.3f} ms (shared-memory tick "
            f"{out[n, b, False][0]:.3f} ms)")
    return out, sched, rate


def phase_times(band_state):
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.models import vectors
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr, tridiag_solve

    n, b = 3840, 128
    A = uniform_matrix(n)
    _, chase = chase_entry(n, b, record=False)
    _, chase_rec = chase_entry(n, b, record=True)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = chase(Ab, band=b)
    t = {
        "svdvals_3840": cuda_ms(lambda: svdvals(A)),
        "stage1_3840": cuda_ms(lambda: panel_qr.dense_to_band_fused(A, band=b)),
        "chase_3840": cuda_ms(lambda: chase(Ab, band=b)),
        "bisect_3840": cuda_ms(lambda: bisect.bisect_svdvals(d, e)),
    }
    for k, v in t.items():
        say(f"[times] {k}: {v:.3f} ms (median of {REPS})")

    # svd at 3840 and its split, each stage on the previous one's outputs
    Abr, Vq, Tq, Vl, Tl = panel_qr.dense_to_band_rec_fused(A, band=b)
    dr, er, VL, TL, VR, TR = chase_rec(Abr, band=b)
    sig = bisect.bisect_svdvals(dr, er)
    Ub, Vb = vectors.tgk_vectors(dr, er, sig)
    LU, RV = vectors._apply_chase_reflectors_wy_pair(VL, TL, VR, TR, Ub, Vb, b)
    split = {
        "svd_3840": lambda: svd(A),
        "stage1_rec_3840": lambda: panel_qr.dense_to_band_rec_fused(A, band=b),
        "chase_rec_3840": lambda: chase_rec(Abr, band=b),
        "bisect_svd_3840": lambda: bisect.bisect_svdvals(dr, er),
        "tgk_vectors_3840": lambda: vectors.tgk_vectors(dr, er, sig),
        "chase_backtransform_3840": lambda: vectors._apply_chase_reflectors_wy_pair(
            VL, TL, VR, TR, Ub, Vb, b),
        "stage1_backtransform_3840": lambda: vectors._apply_stage1_reflectors_pair(
            Vq, Tq, Vl, Tl, LU, RV),
    }
    for k, fn in split.items():
        t[k] = cuda_ms(fn, SVD_REPS)
        say(f"[times] {k}: {t[k]:.3f} ms (median of {SVD_REPS})")
    parts = sum(v for k, v in t.items() if k in split and k != "svd_3840")
    say(f"[times] svd split sums to {parts:.3f} ms of {t['svd_3840']:.3f} ms")
    del Vq, Tq, Vl, Tl, VL, TL, VR, TR, Ub, Vb, LU, RV

    # the cost of recording: the routed plain and recording entries on one
    # band, in turns
    c1 = cuda_ms(lambda: chase(Ab, band=b), SVD_REPS)
    r1 = cuda_ms(lambda: chase_rec(Ab, band=b), SVD_REPS)
    r2 = cuda_ms(lambda: chase_rec(Ab, band=b), SVD_REPS)
    c2 = cuda_ms(lambda: chase(Ab, band=b), SVD_REPS)
    say(f"[times] routed chase n=3840 b=128: plain entry {c1:.3f} / {c2:.3f} ms, "
        f"recording entry {r1:.3f} / {r2:.3f} ms (medians of {SVD_REPS})")

    rng = np.random.default_rng(2)
    Ab1, d1, e1 = band_state[:3]
    tgk = {nt: tgk_problem(rng, nt) for nt in (1024, 3840)}
    pairs = {
        "band_chase": (lambda: band_chase.band_to_bidiagonal(Ab1, band=64),
                       lambda: band_chase.band_to_bidiagonal_plain(Ab1, band=64),
                       "n=1024 b=64"),
        "band_chase_rec": (
            lambda: band_chase.band_to_bidiagonal_accum(Ab1, band=64),
            lambda: band_chase.band_to_bidiagonal_accum_plain(Ab1, band=64),
            "n=1024 b=64"),
        "bisect": (lambda: bisect.bisect_svdvals(d1, e1),
                   lambda: bisect.bisect_svdvals_plain(d1, e1), "n=1024 probes=1"),
        "bisect_p3": (lambda: bisect.bisect_svdvals(d1, e1, probes=3),
                      lambda: bisect.bisect_svdvals_plain(d1, e1, probes=3),
                      "n=1024 probes=3"),
        "tridiag_solve": (lambda: tridiag_solve.tgk_solve(*tgk[3840]),
                          lambda: tridiag_solve.tgk_solve_plain(*tgk[3840]),
                          "n=3840 (7680 rows, 3840 lanes)"),
        "tridiag_solve_1024": (lambda: tridiag_solve.tgk_solve(*tgk[1024]),
                               lambda: tridiag_solve.tgk_solve_plain(*tgk[1024]),
                               "n=1024 (2048 rows, 1024 lanes)"),
    }
    kt = {}
    for name, (kern, plain, shape) in pairs.items():
        (k1, k2), p1 = in_turns(kern, plain)
        kt[name] = (min(k1, k2), p1, shape)
        say(f"[times] {name} {shape}: kernel {k1:.3f} / {k2:.3f} ms (medians of "
            f"{REPS}), plain {p1:.3f} ms (one run)")

    # library calls computing the same function, timed beside the kernels
    # (never called by the port)
    lib = {
        "bisect": cuda_ms(lambda: torch.linalg.svdvals(
            torch.diag(d1) + torch.diag(e1, 1))),
    }
    lib_3840 = cuda_ms(lambda: torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)))
    say(f"[times] library: torch.linalg.svdvals of the dense bidiagonal n=1024 "
        f"{lib['bisect']:.3f} ms, n=3840 {lib_3840:.3f} ms (medians of {REPS})")
    k1 = phase_k1_times()
    kt["panel_qr"] = (k1[3840][0], k1[3840][1], "b=128 m=3840")
    lib["panel_qr"] = k1[3840][2]
    return t, kt, lib, k1


def phase_profile(label, fn):
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    and the share of the call's wall time in which the card ran a kernel.
    Busy is not utilization: the panel kernel holds one cluster of up to 16
    SMs, the wavefront chase one SM a lane, the sequential chase one SM."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: allocator and libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's device time repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    for ms, count, key in rows[:10]:
        say(f"[profile] {label}: {ms:10.3f} ms {count:5d} x {key[:72]}")
    busy = sum(r[0] for r in rows)
    say(f"[profile] {label}: wall {wall_ms:.3f} ms (host clock, profiler on), "
        f"kernels {busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall")


# the TPU kernels (K1-K15 of PERF.md) each row's kernel stands for
TPU_KERNELS = {
    "panel_qr": ["K1"], "band_chase": ["K3", "K5"], "band_chase_rec": ["K6", "K8"],
    "bisect": ["K2"], "tridiag_solve": ["K9", "K10"],
    "band_chase_wave": ["K4", "K5", "K13"], "band_chase_wave_dl": ["K11"],
    "band_chase_staged": ["K14", "K15"], "band_chase_vmem": ["K12"],
    "band_chase_wave_rec": ["K7", "K8"], "band_chase_wave_l2": ["K4", "K13"],
    "band_chase_wave_rec_l2": ["K7"],
}


def kernel_table(errs, counts_vals, counts_svd, kt, lib, variants, route, k1, ticks,
                 designs):
    from svdsolver_tpu_torch.models import two_stage
    from svdsolver_tpu_torch.models.diagonalize import default_bisect_iters

    counts_var, errs_var, plain_var, times_var = variants
    k2_ms, tgk_ms = designs
    tick_ms, sched, rate = ticks
    src = "svdsolver_tpu_torch/csrc/{}.cu"
    replaces = {
        "panel_qr": "svdsolver_tpu/ops/pallas/panel_qr.py:30",
        "band_chase": "svdsolver_tpu/ops/pallas/band_chase.py:331 "
                      "+ band_chase_stream.py:118",
        "band_chase_rec": "svdsolver_tpu/ops/pallas/band_chase.py:191 "
                          "+ band_chase_stream.py:118 (rec=True)",
        "bisect": "svdsolver_tpu/ops/pallas/bisect.py:44",
        "tridiag_solve": "svdsolver_tpu/ops/pallas/tridiag_solve.py:41 "
                         "+ tridiag_solve.py:124",
    }
    work = {  # the shapes of each kernel's "ms" in kt
        "panel_qr": work_panel_qr(128, 3840, 0),
        "band_chase": work_chase(1024, 64, record=False),
        "band_chase_rec": work_chase(1024, 64, record=True),
        "bisect": work_bisect(1024, default_bisect_iters(torch.float32), 1),
        "tridiag_solve": work_tgk(2 * 3840, 3840),
    }
    rows = []
    svd_side = ("band_chase_rec", "tridiag_solve", "band_chase_wave_rec")
    for k in work:
        b_ms, b_by = bound(*work[k])
        # every main-path run of svdvals, or of svd and svds; K2 runs on both
        sides = ((counts_svd,) if k in svd_side else
                 (counts_vals, counts_svd) if k == "bisect" else (counts_vals,))
        launches = sum(c[k] for side in sides for c in side.values())
        say(f"[bound] {k} ({kt[k][2]}): {work[k][0]:.4g} flops, {work[k][1]:.4g} "
            f"bytes -> {b_ms:.4f} ms, bound by {b_by}")
        rows.append({
            "name": k, "route": "cuda",
            "source": src.format("band_chase" if k == "band_chase_rec" else k),
            "replaces": replaces[k], "launches": launches,
            "max_abs_err": errs[k], "ms": kt[k][0], "plain_ms": kt[k][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib.get(k),
            "shape": kt[k][2],
        })
        if k in ("band_chase", "band_chase_rec"):
            side = counts_svd if k in svd_side else counts_vals
            rows[-1]["path_launches"] = {n: c[k] for n, c in side.items()}
    # K2 and K9/K10: each group's and each design's times in turns
    iters = default_bisect_iters(torch.float32)
    row = rows[3]
    row["groups_ms"] = {f"n={n}": {f"G={g}": k2_ms[n, g] for g in GROUPS}
                        for n in DESIGN_TIMES}
    row["earlier_design_ms"] = {f"n={n}": k2_ms[n, 1] for n in DESIGN_TIMES}
    row["path_ms"] = min(v for (n, g), v in k2_ms.items() if n == 3840 and g > 1)
    row["path_bound_ms"] = bound(*work_bisect(3840, iters, 1))[0]
    row["path_launches"] = {f"svdvals {n}": c["bisect"] for n, c in counts_vals.items()}
    row["path_launches"].update({n if isinstance(n, str) else f"svd {n}": c["bisect"]
                                 for n, c in counts_svd.items()})
    row = rows[4]
    row["staged_ms"] = {f"n={n}": tgk_ms[n][0] for n in DESIGN_TIMES}
    row["earlier_design_ms"] = {f"n={n}": tgk_ms[n][1] for n in DESIGN_TIMES}
    rows[0]["widths"] = {  # K1 at each Stage I panel length of n = 3840,
        # and the first panels at SCALE_VALS
        m: {"ms": km, "plain_ms": pm, "library_ms": lm,
            "bound_ms": bound(*work_panel_qr(128, m, 0))[0]}
        for m, (km, pm, lm) in k1.items()}
    at_path = {  # where the ms above were taken at a smaller n
        "band_chase": work_chase(3840, 128, record=False),
        "band_chase_rec": work_chase(3840, 128, record=True),
        "bisect": work_bisect(3840, iters, 1),
    }
    for k, w in at_path.items():
        b_ms, b_by = bound(*w)
        say(f"[bound] {k} at the path's n=3840: {w[0]:.4g} flops, {w[1]:.4g} "
            f"bytes -> {b_ms:.4f} ms, bound by {b_by}")

    # the chase variants: the chase's work; the packed kernel also writes P
    replaces.update({
        "band_chase_wave": "svdsolver_tpu/ops/pallas/band_chase.py:676 "
                           "+ band_chase_wave.py:687",
        "band_chase_wave_dl": "svdsolver_tpu/ops/pallas/band_chase_wave.py:581",
        "band_chase_staged": "svdsolver_tpu/ops/pallas/band_chase.py:405 "
                             "+ band_chase.py:541",
        "band_chase_vmem": "svdsolver_tpu/ops/pallas/band_chase_vmem.py:180",
    })
    (n1, b1, _), (n3, b3, _) = VAR_CHECK, VAR_PATH
    for k in VARIANTS:
        bounds = {}
        for label, n, b in (("check", n1, b1), ("path", n3, b3)):
            flops, nbytes = work_chase(n, b, record=False)
            if k == "band_chase_vmem":
                nbytes += 4 * two_stage.packed_rows(n, b) * two_stage.PACK_WIDTH
            bounds[label] = bound(flops, nbytes)
            say(f"[bound] {k} (n={n} b={b}): {flops:.4g} flops, {nbytes:.4g} "
                f"bytes -> {bounds[label][0]:.4f} ms, bound by {bounds[label][1]}")
        on_path = k == "band_chase_wave"
        rows.append({
            "name": k, "route": "cuda",
            "source": src.format("band_chase_wave" if k == "band_chase_wave_dl" else k),
            "replaces": replaces[k],
            "launches": (sum(c[k] for c in counts_vals.values()) if on_path
                         else counts_var[k]),
            "max_abs_err": errs_var[k], "ms": times_var[k, "check"],
            # the staged kernel's plain version is the plain chase
            "plain_ms": (kt["band_chase"][1] if k == "band_chase_staged"
                         else plain_var[k]),
            "bound_ms": bounds["check"][0], "bound_by": bounds["check"][1],
            "library_ms": None, "shape": f"n={n1} b={b1}",
            "path_shape": f"n={n3} b={b3}", "path_ms": times_var[k, "path"],
            "path_bound_ms": bounds["path"][0],
            "band_chase_path_ms": times_var["band_chase", "path"],
        })
        if on_path:
            rows[-1]["variant_launches"] = counts_var[k]
            rows[-1]["path_launches"] = {n: c[k] for n, c in counts_vals.items()}
            rows[-1].update(tick_keys(tick_ms, sched, rate, record=False))

    # the recording wavefront entry (svd's chase): ms at the check band from
    # the routing evidence, in turns with the sequential recording entry
    k = "band_chase_wave_rec"
    b_chk, b_path = (bound(*work_chase(n, b, record=True)) for n, b in ((n1, b1), (n3, b3)))
    rows.append({
        "name": k, "route": "cuda", "source": src.format("band_chase_wave"),
        "replaces": "svdsolver_tpu/ops/pallas/band_chase_wave.py:959",
        "launches": sum(c[k] for c in counts_svd.values()), "max_abs_err": errs_var[k],
        "ms": route[n1, b1, True][0], "plain_ms": plain_var[k],
        "bound_ms": b_chk[0], "bound_by": b_chk[1], "library_ms": None,
        "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
        "path_ms": route[n3, b3, True][0], "path_bound_ms": b_path[0],
        "band_chase_rec_path_ms": route[n3, b3, True][1],
        "path_launches": {n: c[k] for n, c in counts_svd.items()},
        **tick_keys(tick_ms, sched, rate, record=True),
    })

    # the L2 tick of both entries: off the main paths for b <= 128, kept for
    # wider bands; ms from the ticks in turns at the check band
    b_path_plain = bound(*work_chase(n3, b3, record=False))
    for k, record in (("band_chase_wave_l2", False), ("band_chase_wave_rec_l2", True)):
        b_k = b_chk if record else bound(*work_chase(n1, b1, record=False))
        side = counts_svd if record else counts_vals
        rows.append({
            "name": k, "route": "cuda", "source": src.format("band_chase_wave"),
            "replaces": ("svdsolver_tpu/ops/pallas/band_chase_wave.py:959" if record else
                         replaces["band_chase_wave"]),
            "launches": sum(c[k] for c in side.values()),
            "max_abs_err": errs_var[k], "ms": tick_ms[n1, b1, record][1],
            "plain_ms": plain_var["band_chase_wave_rec" if record else "band_chase_wave"],
            "bound_ms": b_k[0], "bound_by": b_k[1], "library_ms": None,
            "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
            "path_ms": tick_ms[n3, b3, record][1],
            "path_bound_ms": (b_path if record else b_path_plain)[0],
            "variant_launches": counts_var[k],
        })
    for row in rows:
        row["tpu"] = TPU_KERNELS[row["name"]]
    covered = {t for row in rows for t in row["tpu"]}
    require(covered == {f"K{i}" for i in range(1, 16)}, f"the rows cover K1-K15: {covered}")
    return rows


def tick_keys(tick_ms, sched, rate, record):
    """The two ticks of a wavefront entry in turns at TICK_SHAPES, and the
    shared-memory tick's schedule bound."""
    return {
        "ticks_ms": {f"n={n} b={b}": {"smem": tick_ms[n, b, record][0],
                                      "l2": tick_ms[n, b, record][1],
                                      "schedule_bound_ms": sched[n, b]}
                     for n, b in TICK_SHAPES},
        "window_copy_gb_s": rate / 1e6,
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import svdsolver_tpu_torch  # noqa: F401  (fails outside the repository)
    from svdsolver_tpu_torch import svd, svdvals

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the oracles' GEMMs too
    t_start = time.perf_counter()
    name, _ = phase_device()
    t0 = time.perf_counter()
    phase_build()
    say(f"[build] total {time.perf_counter() - t0:.2f} s")
    errs, band_state = phase_kernels(np.random.default_rng(0))
    variants = phase_variants(band_state)
    counts_vals = phase_slice()
    counts_svd = phase_svd()
    counts_svd[f"svds {SVDS_CASE[0]}"] = phase_svds()
    scale_counts, _, _ = phase_scale()
    for key, c in scale_counts.items():
        if isinstance(key, tuple):
            counts_svd[key[1]] = c
        else:
            counts_vals[key] = c
    _, kt, lib, k1 = phase_times(band_state)
    designs = phase_design_times()
    route = phase_route_times()
    ticks = phase_tick_times(band_state)
    A = uniform_matrix(3840)
    phase_profile("svdvals n=3840", lambda: svdvals(A))
    phase_profile("svd n=3840", lambda: svd(A))
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    rows = kernel_table(errs, counts_vals, counts_svd, kt, lib, variants, route, k1, ticks,
                        designs)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
