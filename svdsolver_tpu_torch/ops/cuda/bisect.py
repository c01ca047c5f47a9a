"""Kernel 2: bidiagonal singular values by parallel multisection
(``csrc/bisect.cu``); twin of ``svdsolver_tpu/ops/pallas/bisect.py``.

The count is the twisted Sturm count: forward pivots from the top and
backward pivots from the bottom of the Golub-Kahan tridiagonal meet at the
twist n+1, halving the sequential depth of a count against the one-sided
count of ``models/diagonalize.bisect_svdvals``.  ``probes=k`` probes k
equispaced interior points per bracket per sweep (log2(k+1) bits a sweep).

On the card a group of ``GROUP`` threads serves one singular value and
resolves ``tree_levels(probes, GROUP)`` sweeps with one count chain (the
bisection tree of the kernel's header); :func:`bisect_svdvals_tree_plain`
is that tree in PyTorch, bit-equal to :func:`bisect_svdvals_plain`.  On a
CPU tensor :func:`bisect_svdvals` runs :func:`bisect_svdvals_plain`.
"""

import torch

from svdsolver_tpu_torch.models.diagonalize import (
    default_bisect_iters,
    tgk_z2_and_bound,
)
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # tree-kernel launches by bisect_svdvals since the last reset
launches_thread = 0  # one-thread-a-sigma launches (_group=1, probes > 32)

GROUP = 16  # threads a singular value of the tree twin's default (the kernel's at n = 3840)
SMEM_PER_SM = 228 * 1024  # shared memory of one H100 SM
WARPS_PER_SM = 16  # resident warps that hide a count chain's latency
last_group = None  # threads a singular value of the last launch (1: one thread)

_ENTRIES = {
    "svdt_bisect": [_build.VOIDP] * 4 + [_build.INT] * 3 + [_build.VOIDP],
    "svdt_bisect_tree": [_build.VOIDP] * 4 + [_build.INT] * 6 + [_build.VOIDP],
}
_sms = {}  # device index -> multiprocessor count


def tree_levels(probes, group):
    """Sweeps one round of the tree resolves: the largest T with
    ``(probes + 1)**T - 1 <= group`` probe points (0: no tree fits)."""
    T = 0
    while (probes + 1) ** (T + 1) - 1 <= group:
        T += 1
    return T


def tree_group(n, probes, sms=132):
    """The threads a singular value on a card of ``sms`` SMs, by shape.

    The largest of 32, 16, 8, 4 whose tree fits and whose ``n * G / 32``
    warps stay within ``WARPS_PER_SM`` an SM: past that the SMs' issue
    rate, not the chain's latency, bounds the kernel, and a larger tree
    only adds probes (on the H100: 1.01 ms at G = 32 against 1.14 at 16 for
    n = 1024; 3.91 at 16 against 5.18 at 32 for 3840; 9.75 at 8 against
    11.56 at 16 for 7680).  So at probes = 1: 32 up to n = 2,112, 16 up to
    4,224, 8 up to 8,448, 4 beyond; the smallest group of the same depth
    is taken.  Past 32 probes no tree fits: the one-thread kernel (1)."""
    fits = [g for g in (32, 16, 8, 4) if tree_levels(probes, g) >= 1]
    if not fits:
        return 1
    group = next((g for g in fits if n * g <= 32 * WARPS_PER_SM * sms), fits[-1])
    while group // 2 in fits and tree_levels(probes, group // 2) == tree_levels(probes, group):
        group //= 2
    return group


def tree_block(n, group, sms=132):
    """Threads a block of the tree kernel: the least of 128, 256, 512, 1024
    that puts the whole grid on the card in one wave, as many blocks an SM
    as the 8n bytes of z^2 streams let it (at G = 16 / 8 / 4: 128 at
    n = 3840, 256 at 7680, 512 at 15,360, 1024 at 23,040)."""
    per_sm = max(1, SMEM_PER_SM // (8 * n + 1024))
    for threads in (128, 256, 512, 1024):
        if -(-n * group // threads) <= sms * min(per_sm, 2048 // threads, 32):
            return threads
    return 1024


def _sm_count(device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


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
        lam = lo + jp1 * ((hi - lo) / (probes + 1))  # (probes, n), ascending
        na = _twisted_below(zf, zr, lam, ks, n).sum(0).to(d.dtype)  # probes below sigma
        lo, hi = _sweep(lo, hi, na, probes)
    return (0.5 * (lo + hi)).flip(0)


def _twisted_below(zf, zr, lam, ks, n):
    """The plain version's count for every probe point ``lam`` (..., n):
    True where the probe lies below the lane's singular value."""
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
    return (cnt - n) <= ks


def _sweep(lo, hi, na, probes):
    """One sweep's bracket update for the digits ``na`` (probes below)."""
    h = (hi - lo) / (probes + 1)
    lo = lo + na * h
    return lo, torch.where(na >= probes, hi, lo + h)


def bisect_svdvals_tree_plain(d, e, iters=None, probes=1, group=GROUP):
    """The tree kernel's schedule in PyTorch, bit-equal to
    :func:`bisect_svdvals_plain`: each round builds the brackets of every
    node of a ``(probes + 1)``-ary tree ``T = tree_levels(probes, group)``
    levels deep from the lanes' brackets (the same roundings as a sweep),
    counts all ``(probes + 1)**T - 1`` probe points in one chain, then walks
    the tree, each level's digit the sum over its node's probes; the last
    round is a partial tree when T does not divide ``iters``."""
    _check_de(d, e)
    n = d.shape[0]
    if n == 1:
        return torch.abs(d)
    z2f, z2r, bound, iters, probes = _prepare(d, e, iters, probes)
    T = tree_levels(probes, int(group))
    if T < 1:
        raise ValueError(f"no tree of {probes} probes fits a group of {group}")
    zf, zr = z2f.unbind(), z2r.unbind()
    ks = torch.arange(n, device=d.device)
    P, P1 = probes, probes + 1
    jp1 = torch.arange(1, P + 1, device=d.device, dtype=d.dtype)[:, None]
    digits = torch.arange(P1, device=d.device, dtype=d.dtype)[None, :, None]
    lo = d.new_zeros((n,))
    hi = bound.expand(n).clone()
    done = 0
    while done < iters:
        R = min(T, iters - done)
        nlo, nhi, lams = lo[None], hi[None], []  # level 0: the root
        for lv in range(R):
            h = (nhi - nlo) / P1
            lams.append((nlo[:, None] + jp1 * h[:, None]).reshape(-1, n))
            if lv + 1 < R:  # the children, digit by digit, root first
                clo = nlo[:, None] + digits * h[:, None]
                chi = torch.where(digits >= P, nhi[:, None], clo + h[:, None])
                nlo, nhi = clo.reshape(-1, n), chi.reshape(-1, n)
        below = _twisted_below(zf, zr, torch.cat(lams), ks, n)
        off, node, lw = 0, torch.zeros_like(ks), P
        for lv in range(R):
            rows = off + node[None, :] * P + torch.arange(P, device=d.device)[:, None]
            na = below.gather(0, rows).sum(0)
            lo, hi = _sweep(lo, hi, na.to(d.dtype), P)
            off, lw, node = off + lw, lw * P1, node * P1 + na
        done += R
    return (0.5 * (lo + hi)).flip(0)


def bisect_svdvals(d, e, iters=None, probes=1, _group=None):
    """Singular values of the bidiagonal {d, e}, descending.

    CUDA float32 ``d``, ``e`` launch the tree kernel with
    ``tree_group(n, probes)`` threads a singular value (counted by
    ``launches``) or, past 32 probes, the one-thread kernel (counted by
    ``launches_thread``); every group gives the same bits.  ``_group``
    forces a group for timings in turns (1: the one-thread kernel).  The kernels
    keep both z^2 streams in shared memory, so n is at most 29,056.  CPU
    tensors run the plain version.  ``iters`` defaults to
    ``ceil((-log2 eps + 12) / log2(probes + 1))`` sweeps.
    """
    global launches, launches_thread, last_group
    _check_de(d, e)
    if _group is not None:
        group = int(_group)
        if group not in (1, 4, 8, 16, 32):
            raise ValueError(f"_group must be 1, 4, 8, 16 or 32, got {_group}")
        if group > 1 and tree_levels(int(probes), group) < 1:
            raise ValueError(f"no tree of {probes} probes fits a group of {group}")
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
    sms = _sm_count(d.device)
    if _group is None:
        group = tree_group(n, probes, sms)
    bound = bound.reshape(1)
    out = torch.empty((n,), dtype=d.dtype, device=d.device)
    lib = _build.load("bisect", _ENTRIES)
    ptrs = (z2f.data_ptr(), z2r.data_ptr(), bound.data_ptr(), out.data_ptr())
    with torch.cuda.device(d.device):
        if group == 1:
            err = lib.svdt_bisect(*ptrs, n, iters, probes, _build.stream_of(d))
        else:
            err = lib.svdt_bisect_tree(*ptrs, n, iters, probes, group,
                                       tree_levels(probes, group),
                                       tree_block(n, group, sms), _build.stream_of(d))
    _build.raise_on_error(err, "bisect")
    last_group = group
    if group == 1:
        launches_thread += 1
    else:
        launches += 1
    return out
