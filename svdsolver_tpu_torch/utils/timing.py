"""Benchmark timing harness (twin of ``svdsolver_tpu/utils/timing.py``).

PyTorch returns from a CUDA call before the device finishes, so every timed
call ends in :func:`sync`; the first call may be excluded (it builds the
kernels).
"""

import time

import torch


def sync(out=None):
    """Wait for the device work that produced ``out``; returns ``out``.

    ``torch.cuda.synchronize()`` on a CUDA machine (a no-op otherwise: CPU
    ops have finished when they return).
    """
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def benchmark(fn, instances, *args, warmup=True):
    """Mean seconds per call of ``fn(instance, *args)`` over ``instances``.

    ``warmup=True`` runs the first instance once beforehand (uncounted), so
    kernel builds and allocator growth are excluded.
    """
    if warmup and len(instances) > 0:
        sync(fn(instances[0], *args))
    t0 = time.perf_counter()
    for inst in instances:
        sync(fn(inst, *args))
    return (time.perf_counter() - t0) / max(len(instances), 1)


def benchmark_each(fn, instances, *args, warmup=True):
    """Per-instance variant of :func:`benchmark`: returns ``(mean_seconds,
    list_of_seconds)``."""
    if warmup and len(instances) > 0:
        sync(fn(instances[0], *args))
    times = []
    for inst in instances:
        t0 = time.perf_counter()
        sync(fn(inst, *args))
        times.append(time.perf_counter() - t0)
    return sum(times) / max(len(times), 1), times
