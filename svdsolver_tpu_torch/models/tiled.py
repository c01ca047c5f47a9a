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

These are the plain versions.  A half-sweep (a tile column's slabs, QR
or LQ) splits into a chain and an apply: :func:`chain_plain` factors the
pivot-block column through the slabs and returns the reflectors (v, tau),
:func:`apply_plain` applies them to every other column, each column in the
schedule's order.  ``ops/cuda/tiled_slab.py`` runs each as one kernel
launch a half-sweep (its first design, one launch a slab, stays as the
bitwise oracle and as the route for wide bands) and holds the public
``dense_to_band_tiled``, which picks the kernels or this code by the
input's device.
"""

import torch

from svdsolver_tpu_torch.ops.precision import pdot


def _reflector(x, piv_row):
    """The reflector of column ``x`` with its pivot at row ``piv_row`` and a
    contiguous tail below it: ``(v, tau)``.

    It is this module's own, not ``householder_vector``'s:
    ``sign = +1 if pivot >= 0``, ``beta = -sign ||x[piv:]||``; a zero tail
    (``sigma2 == 0``) gives ``tau = 0``; ``v[piv] = 1`` only where
    ``piv_row < rows``.
    """
    rows = x.shape[0]
    zero = x.new_zeros(())
    one = x.new_ones(())
    tail = torch.arange(rows, device=x.device) > piv_row
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
    return v, tau


def _slab_factor_step(S, col, piv_row):
    """One Householder step on slab ``S`` (rows, n), in place: the
    reflector (:func:`_reflector`) of column ``col`` with its pivot at local
    row ``piv_row``, applied to every column."""
    v, tau = _reflector(S[:, col], piv_row)
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


def sweep_slabs(n, top, t):
    """The slabs of half-sweep ``top`` of an ``n``-row matrix: ``None`` (the
    1-slab on rows ``[top, top + t)``), then the first row of each TS slab's
    tile row below it."""
    return [None] + list(range(top + t, n, t))


def tile_sweeps(A, t, sweep, transpose):
    """The tiled schedule on ``A`` in place: for each tile column ``k``
    (``c = k t``), the QR half-sweep ``sweep(A, c, c, t)``, then (but for
    the last) the LQ half-sweep ``sweep(At, c + t, c, t)`` on
    ``At = transpose(A)``, a matrix whose rows are ``A``'s columns, written
    back by ``transpose`` once a sweep.  Returns ``A``.  A half-sweep
    ``(top, pc)`` factors the slabs of :func:`sweep_slabs` in order with
    pivot columns ``[pc, pc + t)``: the reference's QR ``(c, c)``, then
    ``(c, i t)`` for ``i > k``; LQ ``(c + t, c)``, then ``(c + t, i t)``
    for ``i > k + 1``."""
    nbt = A.shape[0] // t
    for k in range(nbt):
        c = k * t
        sweep(A, c, c, t)
        if k < nbt - 1:
            At = transpose(A)
            sweep(At, c + t, c, t)
            A = transpose(At)
    return A


def slab_sweep(factor):
    """A half-sweep as the reference runs it: ``factor(M, top, pc, t,
    bot)`` on each slab of :func:`sweep_slabs` in turn."""

    def sweep(M, top, pc, t):
        for bot in sweep_slabs(M.shape[0], top, t):
            factor(M, top, pc, t, bot)
        return M

    return sweep


def _slab_rows(top, t, bot, device):
    rows = torch.arange(top, top + t, device=device)
    return rows if bot is None else torch.cat([rows, torch.arange(bot, bot + t, device=device)])


def chain_plain(M, top, pc, t):
    """The pivot-block column of half-sweep ``(top, pc)`` (the chain kernel's
    function): columns ``[pc, pc + t)`` of square ``M`` through every slab
    of the half-sweep, each step's reflector from its pivot column and
    applied to those columns only, in place.  Returns the history ``(V,
    tau)``: ``V[s, j, :R]`` is slab ``s``'s reflector ``j`` on its ``R``
    rows (``t`` for the 1-slab, ``2t`` for a TS slab; zeros past),
    ``tau[s, j]`` its tau."""
    slabs = sweep_slabs(M.shape[0], top, t)
    V = M.new_zeros((len(slabs), t, 2 * t))
    tau = M.new_zeros((len(slabs), t))
    cols = torch.arange(pc, pc + t, device=M.device)
    for s, bot in enumerate(slabs):
        rows = _slab_rows(top, t, bot, M.device)
        S = M[rows[:, None], cols]
        for j in range(t):
            v, tau[s, j] = _reflector(S[:, j], j)
            S -= tau[s, j] * torch.outer(v, pdot(v, S))
            V[s, j, : len(rows)] = v
        M[rows[:, None], cols] = S
    return V, tau


def apply_plain(M, top, pc, t, V, tau):
    """The history of half-sweep ``(top, pc)`` (:func:`chain_plain`'s ``V``,
    ``tau``; ``V`` may be wider than ``2t``) applied to every column of
    square ``M`` outside ``[pc, pc + t)`` (the apply kernel's function), in
    place: slab by slab, each slab's reflectors in order on its rows."""
    n = M.shape[0]
    cols = torch.cat([torch.arange(pc, device=M.device),
                      torch.arange(pc + t, n, device=M.device)])
    for s, bot in enumerate(sweep_slabs(n, top, t)):
        rows = _slab_rows(top, t, bot, M.device)
        S = M[rows[:, None], cols]
        for j in range(t):
            v = V[s, j, : len(rows)]
            S -= tau[s, j] * torch.outer(v, pdot(v, S))
        M[rows[:, None], cols] = S
    return M


def half_sweep_plain(M, top, pc, t):
    """Half-sweep ``(top, pc)`` of square ``M`` in place as a chain and an
    apply: :func:`chain_plain`, then :func:`apply_plain` of its history.
    The same reflectors in the same order as ``slab_sweep(_factor_slab)``;
    each column's sums may run in another order."""
    V, tau = chain_plain(M, top, pc, t)
    return apply_plain(M, top, pc, t, V, tau)


def dense_to_band_tiled_plain(A, band=32):
    """Tiled Stage I: reduce square ``A`` to upper-band form with ``band``
    superdiagonals by tile QR/LQ sweeps (``n % band == 0``).  Returns a new
    tensor; the LQ half works on a transposed view, no copy."""
    t = int(band)
    check_tiled(A, t)
    return tile_sweeps(A.clone(), t, slab_sweep(_factor_slab), lambda M: M.T)
