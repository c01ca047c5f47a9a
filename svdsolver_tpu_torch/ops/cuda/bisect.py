"""Kernel 2: bidiagonal singular values by parallel multisection
(``csrc/bisect.cu``); twin of ``svdsolver_tpu/ops/pallas/bisect.py``.

The count is the twisted Sturm count: forward pivots from the top and
backward pivots from the bottom of the Golub-Kahan tridiagonal meet at the
twist n+1, halving the sequential depth of a count against the one-sided
count of ``models/diagonalize.bisect_svdvals``.  ``probes=k`` probes k
equispaced interior points per bracket per sweep (log2(k+1) bits a sweep).
On a CPU tensor :func:`bisect_svdvals` runs :func:`bisect_svdvals_plain`.
"""

import torch

from svdsolver_tpu_torch.models.diagonalize import (
    default_bisect_iters,
    tgk_z2_and_bound,
)
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by bisect_svdvals since the last reset

_ENTRIES = {
    "svdt_bisect": [_build.VOIDP] * 4 + [_build.INT] * 3 + [_build.VOIDP],
}


def _prepare(d, e, iters, probes):
    """The wrapper math of the reference: the two z^2 streams, the bound and
    the sweep count.  ``z2f[s] = z2[s]``; ``z2r`` is a leading zero, then
    ``z2[2n-2], ..., z2[n]``, so both chains read left to right."""
    probes = int(probes)
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    if iters is None:
        iters = default_bisect_iters(d.dtype, probes)
    n = d.shape[0]
    z2, bound = tgk_z2_and_bound(d, e)
    z2f = z2[:n].contiguous()
    z2r = torch.cat([z2.new_zeros((1,)), z2[n:].flip(0)])
    return z2f, z2r, bound, int(iters), probes


def _check_de(d, e):
    if d.ndim != 1 or e.ndim != 1 or e.shape[0] != max(d.shape[0] - 1, 0):
        raise ValueError(
            f"need d (n,) and e (n-1,), got {tuple(d.shape)} and {tuple(e.shape)}"
        )
    if d.device != e.device or d.dtype != e.dtype:
        raise ValueError("d and e must share device and dtype")


def bisect_svdvals_plain(d, e, iters=None, probes=1):
    """Plain PyTorch version of the kernel: the twisted count vectorized over
    the n lanes (and the probes), singular values descending."""
    _check_de(d, e)
    n = d.shape[0]
    if n == 1:
        return torch.abs(d)
    z2f, z2r, bound, iters, probes = _prepare(d, e, iters, probes)
    zf, zr = z2f.unbind(), z2r.unbind()  # 0-d views: no indexing op per step
    ks = torch.arange(n, device=d.device)
    jp1 = torch.arange(1, probes + 1, device=d.device, dtype=d.dtype)[:, None]
    lo = d.new_zeros((n,))
    hi = bound.expand(n).clone()
    for _ in range(iters):
        h = (hi - lo) / (probes + 1)
        lam = lo + jp1 * h  # (probes, n), ascending in the probe index
        p = -lam
        q = -lam
        cnt = (p < 0).to(torch.int32)
        for s in range(n):
            p = -lam - zf[s] / p
            q = -lam - zr[s] / q
            cnt += (p < 0).to(torch.int32) + (q < 0).to(torch.int32)
        gamma = p + q + lam
        cnt = cnt - (p < 0).to(torch.int32) - (q < 0).to(torch.int32)
        cnt += (gamma < 0).to(torch.int32)
        na = ((cnt - n) <= ks).sum(0).to(d.dtype)  # probes below sigma
        lo = lo + na * h
        hi = torch.where(na >= probes, hi, lo + h)
    return (0.5 * (lo + hi)).flip(0)


def bisect_svdvals(d, e, iters=None, probes=1):
    """Singular values of the bidiagonal {d, e}, descending.

    CUDA float32 ``d``, ``e`` launch the kernel; CPU tensors run the plain
    version.  ``iters`` defaults to
    ``ceil((-log2 eps + 12) / log2(probes + 1))`` sweeps.
    """
    global launches
    _check_de(d, e)
    on_card = _build.check_input(d, "d", 1)
    _build.check_input(e, "e", 1)
    if not on_card:
        return bisect_svdvals_plain(d, e, iters=iters, probes=probes)
    n = d.shape[0]
    if n == 1:
        return torch.abs(d)
    if 8 * n > _build.MAX_SMEM:
        raise ValueError(f"n={n} exceeds the kernel's shared-memory z^2 streams")
    z2f, z2r, bound, iters, probes = _prepare(d, e, iters, probes)
    bound = bound.reshape(1)
    out = torch.empty((n,), dtype=d.dtype, device=d.device)
    lib = _build.load("bisect", _ENTRIES)
    with torch.cuda.device(d.device):
        err = lib.svdt_bisect(
            z2f.data_ptr(), z2r.data_ptr(), bound.data_ptr(), out.data_ptr(),
            n, iters, probes, _build.stream_of(d),
        )
    _build.raise_on_error(err, "bisect")
    launches += 1
    return out
