"""Tracing and per-stage timing (twin of ``svdsolver_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) to ``logdir``;
* :func:`stage_timings`: the two-stage pipeline's seconds a stage: Stage I,
  the chase and the diagonalization, each the function ``svdvals(A,
  method=..., diag=...)`` runs for that stage on ``A``'s device (on a
  float32 CUDA tensor the panel kernel or the tiled Stage I's kernels,
  the routed chase kernel and the bisection kernel).
"""

import contextlib
import os
import time
from pathlib import Path

import torch

DEFAULT_LOGDIR = Path(__file__).resolve().parents[2] / "build" / "svdsolver_tpu_torch" / "trace"


@contextlib.contextmanager
def trace(logdir=DEFAULT_LOGDIR):
    """Profile the block: ``with trace(dir) as prof: run()``.  CPU
    activity, and the card's where one is present; on exit the Chrome
    trace goes to ``<logdir>/trace.json`` (``prof.key_averages()`` holds the
    sums by operation and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def stage_timings(A, band=None, method="tpu2", diag="bisect", warmup=True, reps=5):
    """Seconds a call of each stage of the two-stage pipeline on square
    ``A`` (a tensor, on its device); returns a dict.

    Stages: ``stage1_dense_to_band_s``, ``stage2_band_to_bidiagonal_s``,
    ``diagonalization_s`` (and ``total_s``, ``band``).  ``method``:
    ``tpu2``, ``multicore`` or ``tpu1`` (:func:`models.svd.two_stage_fns`);
    ``diag`` as ``svdvals`` takes it.  Each stage runs ``reps`` times back
    to back; on a CUDA tensor between CUDA events (device time), on the CPU
    by the host clock.  ``warmup=True`` first runs the pipeline once (the
    kernels build at their first call).
    """
    from svdsolver_tpu_torch.models.svd import (_auto_block, _pad_to_multiple,
                                                diagonalizer, two_stage_fns)

    band = int(band or _auto_block(A.shape[0]))
    A, _ = _pad_to_multiple(A, band)
    stage1, stage2 = two_stage_fns(method, A)
    solver = diagonalizer(method, diag, A)
    reps = max(1, int(reps))

    def pipeline():
        d, e = stage2(stage1(A, band=band), band=band)
        return solver(d, e)

    if warmup:
        pipeline()
    Ab = stage1(A, band=band)
    d, e = stage2(Ab, band=band)
    out = {
        "stage1_dense_to_band_s": _loop_seconds(lambda: stage1(A, band=band), reps, A),
        "stage2_band_to_bidiagonal_s": _loop_seconds(lambda: stage2(Ab, band=band), reps, A),
        "diagonalization_s": _loop_seconds(lambda: solver(d, e), reps, A),
    }
    out["total_s"] = sum(out.values())
    out["band"] = band
    return out


def _loop_seconds(fn, reps, like):
    """Seconds a call of ``fn`` over ``reps`` back-to-back calls."""
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps
