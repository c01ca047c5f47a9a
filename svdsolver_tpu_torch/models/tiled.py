"""Tiled Stage I dense -> band reduction, the ``multicore`` rung's schedule
(twin of ``svdsolver_tpu/models/tiled.py``), plain PyTorch.

Tile column ``k`` (columns ``[c, c + t)``, ``c = k t``) is factored as in
the reference's ``brd_p1``: the diagonal slab (rows ``[c, c + t)``, all n
columns), then each sub-diagonal tile row ``i`` as a TS step on the
``(2t, n)`` stack of the diagonal slab and tile row ``i``.  Every
Householder step (:func:`_slab_factor_step`) is applied to all n columns,
so the reference's "apply across the tile row" is fused into it.  The LQ
mirror runs on the transpose with pivots at band offset ``c + t``; the
last tile column has no LQ sweep.  The result is an upper band of width
``t``: the same band class as the panel-sweep ``dense_to_band``, with
other entries (another reflector order) and the same singular values.

These are the plain versions.  ``ops/cuda/tiled_slab.py`` runs one slab
factorization (the ``t`` steps) as one kernel launch and holds the public
``dense_to_band_tiled``, which picks the kernel or this code by the
input's device.
"""

import torch

from svdsolver_tpu_torch.ops.precision import pdot


def _slab_factor_step(S, col, piv_row):
    """One Householder step on slab ``S`` (rows, n), in place: the
    reflector of column ``col`` with its pivot at local row ``piv_row`` and
    a contiguous tail below it, applied to every column.

    The reflector is this function's own, not ``householder_vector``'s:
    ``sign = +1 if pivot >= 0``, ``beta = -sign ||x[piv:]||``; a zero tail
    (``sigma2 == 0``) gives ``tau = 0``; ``v[piv] = 1`` only where
    ``piv_row < rows``.
    """
    rows = S.shape[0]
    zero = S.new_zeros(())
    one = S.new_ones(())
    x = S[:, col]
    tail = torch.arange(rows, device=S.device) > piv_row
    xt = torch.where(tail, x, zero)
    pc = min(piv_row, rows - 1)
    pivot = x[pc].clone()
    sigma2 = torch.sum(xt * xt)
    norm = torch.sqrt(pivot * pivot + sigma2)
    sign = torch.where(pivot >= 0, one, -one)
    beta = -sign * norm
    trivial = sigma2 == 0
    denom = torch.where(trivial, one, pivot - beta)
    v = torch.where(tail, xt / denom, zero)
    if piv_row < rows:
        v[pc] = 1
    safe_beta = torch.where(beta == 0, one, beta)
    tau = torch.where(trivial, zero, (beta - pivot) / safe_beta)
    S -= tau * torch.outer(v, pdot(v, S))
    return S


def _factor_slab(A, top, pc, t, bot=None):
    """The ``t`` steps of one slab factorization, in place on ``A``: the
    slab is rows ``[top, top + t)`` of ``A`` and, for a TS step, rows
    ``[bot, bot + t)`` stacked below them; step ``j`` pivots at column
    ``pc + j``, local row ``j``.  ``A`` may be a transposed view (the LQ
    half)."""
    if bot is None:
        S = A[top : top + t]
        for j in range(t):
            _slab_factor_step(S, pc + j, j)
        return A
    S = torch.cat([A[top : top + t], A[bot : bot + t]])
    for j in range(t):
        _slab_factor_step(S, pc + j, j)
    A[top : top + t] = S[:t]
    A[bot : bot + t] = S[t:]
    return A


def _factor_1slab(A, c, t):
    """factor_1tile + apply_1tile: QR of the diagonal tile ``(c, c)`` with
    the tile row's update fused (rows ``[c, c + t)``, every column)."""
    return _factor_slab(A, c, c, t)


def _factor_2slab(A, c, ri, t):
    """factor_2tile + apply_2tile: TS-factor tile ``(ri, c)`` against the
    diagonal R, the updates fused across both tile rows.  The pivot is R's
    diagonal (local row ``j``); the zeros of R below it make the contiguous
    tail TS-shaped."""
    return _factor_slab(A, c, c, t, bot=ri)


def check_tiled(A, t):
    n = A.shape[0]
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("dense_to_band_tiled expects a square matrix")
    if t < 1 or n % t != 0:
        raise ValueError(f"n={n} must be divisible by band={t}")


def tile_sweeps(A, t, factor, transpose):
    """The tiled schedule on ``A`` in place: for each tile column ``k``,
    ``factor(M, top, pc, t, bot)`` on the QR slabs of ``A``, then (but for
    the last) on the LQ slabs of ``transpose(A)``, a matrix whose rows are
    ``A``'s columns, written back by ``transpose`` once a sweep.  Returns
    ``A``.  The slabs run in the reference's order: QR ``(c, c)``, then
    ``(c, i t)`` for ``i > k``; LQ ``(c + t, c)``, then ``(c + t, i t)``
    for ``i > k + 1``."""
    nbt = A.shape[0] // t
    for k in range(nbt):
        c = k * t
        factor(A, c, c, t, None)
        for i in range(k + 1, nbt):
            factor(A, c, c, t, i * t)
        if k < nbt - 1:
            At = transpose(A)
            factor(At, c + t, c, t, None)
            for i in range(k + 2, nbt):
                factor(At, c + t, c, t, i * t)
            A = transpose(At)
    return A


def dense_to_band_tiled_plain(A, band=32):
    """Tiled Stage I: reduce square ``A`` to upper-band form with ``band``
    superdiagonals by tile QR/LQ sweeps (``n % band == 0``).  Returns a new
    tensor; the LQ half works on a transposed view, no copy."""
    t = int(band)
    check_tiled(A, t)
    return tile_sweeps(A.clone(), t, _factor_slab, lambda M: M.T)
