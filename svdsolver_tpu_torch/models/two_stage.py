"""Two-stage bidiagonalization, plain PyTorch (twin of a subset of
``svdsolver_tpu/models/two_stage.py``).

Stage I  (dense -> band): panel QR/LQ with compact-WY block reflectors and
GEMM trailing updates.  Stage II (band -> bidiagonal): Householder bulge
chasing over fixed-size windows of a zero-padded matrix.

This is the CPU path of ``svdvals`` and ``svd`` (and of the ``tpu1`` method
on any device), and the oracle the CUDA Stage I loop and chase kernels are
held against.  The ``_rec`` / ``_accum`` variants also return the
reflectors, for the singular-vector back-transforms of ``models/vectors.py``.
"""

import torch

from svdsolver_tpu_torch.ops.chase_schedule import (
    nc_of_static,
    s_max_of,
    staged_copies,
    staged_pairs,
    store_floats,
    store_pitch,
    store_range,
    superstep_pairs,
    wave_pairs,
)
from svdsolver_tpu_torch.ops.householder import householder_vector
from svdsolver_tpu_torch.ops.precision import pdot


def _panel_qr_step(A, c0, r_off, b):
    """Factor panel columns ``[c0, c0+b)`` with pivot row ``r_off + j`` for
    panel column ``j``; apply the aggregated block reflector to the trailing
    matrix.  ``r_off == c0`` gives a QR panel; calling on ``A.T`` with
    ``r_off == c0 + b`` gives the LQ row step.  Returns ``(A, V, T)``: the
    updated ``A`` (a new tensor; the input is not modified) and the block
    reflector ``Q = I - V T V^T`` (V (m, b), zero columns for identity
    reflectors; T upper triangular by the larft forward recurrence).
    """
    m = A.shape[0]
    P = A[:, c0 : c0 + b].clone()
    V = A.new_zeros((m, b))
    T = A.new_zeros((b, b))
    ridx = torch.arange(m, device=A.device)
    zero = A.new_zeros(())
    for j in range(b):
        p = r_off + j
        v, tau, beta = householder_vector(P[:, j], p)
        P = P - tau * torch.outer(v, pdot(v, P))
        # Exact column j: zeros strictly below the pivot, beta at the pivot.
        colj = torch.where(ridx > p, zero, P[:, j])
        if p < m:
            colj[p] = beta
        P[:, j] = colj
        # larft update: T[:, j] = -tau * T @ (V^T v);  T[j, j] = tau.
        w = pdot(V.T, v)  # zero at indices >= j (those V columns are still zero)
        T[:, j] = -tau * pdot(T, w)
        T[j, j] = tau
        V[:, j] = torch.where(tau != 0, v, zero)
    # Trailing update A <- (I - V T V^T)^T A; the panel itself is overwritten
    # with its factored form.
    W = pdot(V.T, A)
    A = A - pdot(V, pdot(T.T, W))
    A[:, c0 : c0 + b] = P
    return A, V, T


def segment_bounds(nb, segments):
    """Panel-index boundaries splitting ``nb`` panels into ``segments``
    roughly equal runs (for shrinking the trailing matrix)."""
    segments = max(1, min(int(segments), nb))
    return [nb * s // segments for s in range(segments + 1)]


def _check_stage1(A, b, name):
    n = A.shape[0]
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"{name} expects a square matrix, got {tuple(A.shape)}")
    if b < 1 or n % b != 0:
        raise ValueError(f"n={n} must be divisible by band={b}")


def dense_to_band(A, band=32, segments=1):
    """Stage I: reduce square ``A`` to upper-band form (``band`` superdiagonals).

    Requires ``n % band == 0``; callers pad otherwise (zero padding only
    appends zero singular values).  ``segments``: the trailing updates run on
    the sub-block ``A[s0:, s0:]`` per segment of panels — exact, since a
    panel at column ``c >= s0`` only reads and writes rows and columns
    ``>= s0``.
    """
    b = int(band)
    _check_stage1(A, b, "dense_to_band")
    n = A.shape[0]
    A = A.clone()  # segments are written back in place into this copy
    bounds = segment_bounds(n // b, segments)
    for s in range(len(bounds) - 1):
        k0, k1 = bounds[s], bounds[s + 1]
        if k0 == k1:
            continue
        s0 = k0 * b
        sub = A[s0:, s0:]
        for k in range(k1 - k0):
            c = k * b
            sub = _panel_qr_step(sub, c, c, b)[0]  # QR on panel columns
            sub = _panel_qr_step(sub.T, c, c + b, b)[0].T  # LQ on panel rows
        A[s0:, s0:] = sub
    return A


def dense_to_band_uv(A, band=32):
    """Stage I accumulating the orthogonal factors (twin of the JAX
    ``dense_to_band_uv``): returns ``(Ab, U1, V1)`` with ``A = U1 @ Ab @
    V1^T``.  Per QR panel ``U1 <- U1 (I - V T V^T)``, per LQ panel ``V1 <-
    V1 (I - V2 T2 V2^T)``, compact-WY GEMMs; identity reflectors are zero
    columns of ``V``.  Full width, no segments.
    """
    b = int(band)
    _check_stage1(A, b, "dense_to_band_uv")
    n = A.shape[0]
    U1 = torch.eye(n, dtype=A.dtype, device=A.device)
    V1 = U1.clone()
    for k in range(n // b):
        c = k * b
        A, V, T = _panel_qr_step(A, c, c, b)
        U1 = U1 - pdot(pdot(pdot(U1, V), T), V.T)
        At, V2, T2 = _panel_qr_step(A.T, c, c + b, b)
        A = At.T
        V1 = V1 - pdot(pdot(pdot(V1, V2), T2), V2.T)
    return A, U1, V1


def dense_to_band_rec(A, band=32):
    """Stage I recording the panel block reflectors (twin of the JAX
    ``dense_to_band_rec``).  Full width, no segments.

    Returns ``(Ab, Vq, Tq, Vl, Tl)``: with ``p = n // band`` panels, ``Vq``
    (p, b, n) and ``Tq`` (p, b, b) hold the QR panels' ``V_k^T`` and
    ``T_k^T``, ``Vl`` / ``Tl`` the LQ panels' likewise, so that
    ``A = Q_0 ... Q_{p-1} @ Ab @ (P_0 ... P_{p-1})^T`` with
    ``Q_k = I - V_k T_k V_k^T``.
    """
    b = int(band)
    _check_stage1(A, b, "dense_to_band_rec")
    n = A.shape[0]
    p = n // b
    Vq, Vl = A.new_zeros((p, b, n)), A.new_zeros((p, b, n))
    Tq, Tl = A.new_zeros((p, b, b)), A.new_zeros((p, b, b))
    for k in range(p):
        c = k * b
        A, V, T = _panel_qr_step(A, c, c, b)
        At, V2, T2 = _panel_qr_step(A.T, c, c + b, b)
        A = At.T
        Vq[k], Tq[k], Vl[k], Tl[k] = V.T, T.T, V2.T, T2.T
    return A, Vq, Tq, Vl, Tl


def _right_elim(W, w):
    """Right elimination of a window: the reflector of row 0 over columns
    ``[0, w-1)``, applied to every row of ``W`` in place; returns it."""
    v, tau, _ = householder_vector(W[0, : w - 1], 0)
    Wr = W[:, : w - 1]
    Wr -= tau * torch.outer(pdot(Wr, v), v)
    return v, tau


def _left_reflector(W, left_r0):
    """The left reflector of column 0 over rows ``[left_r0, ...)``."""
    v2, tau2, _ = householder_vector(W[left_r0:, 0], 0)
    return v2, tau2


def _left_apply(W, left_r0, v2, tau2):
    """Apply a left reflector of :func:`_left_reflector` to rows
    ``[left_r0, ...)`` of ``W``, every column, in place."""
    Ws = W[left_r0:, :]
    Ws -= tau2 * torch.outer(v2, pdot(v2, Ws))


def make_window_pairs(w, record=False):
    """The two Stage-II window eliminations for window parameter ``w``
    (= band + 1).  ``top_pair`` opens a sweep (right-elim row 0 over cols
    ``[0, w-1)``, then left-elim rows ``[1, w)``); ``chase_pair`` advances
    the bulge (right-elim row 0 over cols ``[0, w-1)``, then left-elim rows
    ``[w-1, 2w-2)``).  Both update the window ``W`` in place (a view into
    the padded matrix, so no window is copied out and back) and return it;
    with ``record=True`` they return ``(W, v_right, tau_right, v_left,
    tau_left)``, each ``v`` of length ``w - 1``.
    """

    def _pair(W, left_r0):
        v, tau = _right_elim(W, w)
        v2, tau2 = _left_reflector(W, left_r0)
        _left_apply(W, left_r0, v2, tau2)
        if record:
            return W, v, tau, v2, tau2
        return W

    def top_pair(W):
        return _pair(W, 1)

    def chase_pair(W):
        return _pair(W, w - 1)

    return top_pair, chase_pair


def _chase(A, band, record):
    """The sequential chase schedule over a zero-padded copy of ``A``;
    returns ``(d, e)`` and, with ``record``, the reflector records."""
    n = A.shape[0]
    w = int(band) + 1
    step = w - 1
    # Zero-pad so every window lies inside the matrix: the JAX package pads
    # 2w+2 and relies on dynamic_slice clamping the last sweeps' windows,
    # where torch slicing would truncate them instead.  Windows over the pad
    # see zero tails, so their reflectors are the identity.
    pad = 3 * w
    Ap = A.new_zeros((n + pad, n + pad))
    Ap[:n, :n] = A
    ww = 2 * w - 2
    top_pair, chase_pair = make_window_pairs(w, record=record)
    if record:
        s_max = s_max_of(n, step)
        VL, VR = A.new_zeros((2, n - 1, s_max, step))
        TL, TR = A.new_zeros((2, n - 1, s_max))
    for i in range(n - 1):
        out = top_pair(Ap[i : i + w, i + 1 : i + 1 + ww])
        if record:
            _, VR[i, 0], TR[i, 0], VL[i, 0], TL[i, 0] = out
        for k in range(nc_of_static(i, n, step)):
            r = i + 1 + k * step
            c = r + step
            out = chase_pair(Ap[r : r + ww, c : c + ww])
            if record:  # chase pair k fills slot k + 1
                _, VR[i, k + 1], TR[i, k + 1], VL[i, k + 1], TL[i, k + 1] = out
    B = Ap[:n, :n]
    d, e = torch.diagonal(B).clone(), torch.diagonal(B, 1).clone()
    return (d, e, VL, TL, VR, TR) if record else (d, e)


def chase_superstep(L, n, band, i0, LG, R0, U, m, last, s_chase):
    """One rank's pass of one superstep of the pipelined chase
    (``parallel.distributed.band_to_bidiagonal_pipelined``), in place on
    its local buffer ``L`` (``U + m + 4 band`` rows of ``Np`` columns, row
    0 at global row ``R0 - U`` of the padded band): the sweeps ``i = i0 + l``, ``l < LG``, in
    order, each one's head pair if its row lies in ``[lo, hi)`` and then
    its chase pairs whose start row does (at most ``s_chase`` of them),
    ``lo = R0 - 3 band l``, ``hi = R0 + m - 3 band l`` (``Np`` on the
    ``last`` rank).  The windows and their pairs are :func:`_chase`'s
    (:func:`make_window_pairs` on views of ``L``), at local row ``r - R0 +
    U``.  Returns ``L``.  The plain version of the pass's first design,
    the L2 superstep kernel (``ops/cuda/band_chase.superstep`` with
    ``_design="l2"``)."""
    b = int(band)
    w = b + 1
    ww = 2 * b
    Np = L.shape[1]
    top_pair, chase_pair = make_window_pairs(w)
    for l in range(LG):
        i = i0 + l
        if i > n - 2:
            break
        lo = R0 - 3 * b * l
        hi = Np if last else R0 + m - 3 * b * l
        if lo <= i < hi:
            r = i - R0 + U
            top_pair(L[r : r + w, i + 1 : i + 1 + ww])
        k0 = max(0, (lo - i - 1 + b - 1) // b)
        for k in range(k0, min(k0 + s_chase, nc_of_static(i, n, b))):
            r = i + 1 + k * b
            if r >= hi:
                break
            lr = r - R0 + U
            chase_pair(L[lr : lr + ww, r + b : r + b + ww])
    return L


def chase_superstep_wavefront(L, n, band, i0, LG, R0, U, m, last, s_chase):
    """:func:`chase_superstep` in the order of the pass's wavefront: the
    same pairs on the same windows of ``L`` (:func:`make_window_pairs`),
    taken by global tick (``chase_schedule.superstep_pairs``: sweep ``i``'s
    head pair at tick ``3 i``, its chase pair ``k`` at ``3 i + k + 1``) and
    by lane within a tick.  The JAX body staggers a pass's sweeps by ``3
    band`` rows, so pairs of one tick touch disjoint rows and pairs whose
    windows meet run in :func:`chase_superstep`'s order: ``L`` comes out
    bit-equal to it.  Returns ``L``.  The oracle of the tick order of the
    pass's wavefront kernel (``ops/cuda/band_chase.superstep``), whose
    plain version is :func:`chase_superstep`."""
    b = int(band)
    w = b + 1
    ww = 2 * b
    top_pair, chase_pair = make_window_pairs(w)
    for p in superstep_pairs(n, b, i0, LG, R0, m, last, s_chase, L.shape[1]):
        if p.k < 0:
            r = p.i - R0 + U
            top_pair(L[r : r + w, p.i + 1 : p.i + 1 + ww])
        else:
            r = p.i + 1 + p.k * b
            lr = r - R0 + U
            chase_pair(L[lr : lr + ww, r + b : r + b + ww])
    return L


def band_to_bidiagonal(A, band=32):
    """Stage II: bulge-chase an upper-band matrix (``band`` superdiagonals)
    down to bidiagonal.  Returns ``(d, e)``.

    For each column ``i`` a row elimination + column elimination open the
    sweep, then window pairs chase the bulge off the band, each advancing
    ``w - 1`` rows/cols (``w = band + 1``), ``nc_of_static(i, n, band)``
    pairs per sweep.
    """
    if A.shape[0] < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    return _chase(A, band, record=False)


def band_to_bidiagonal_accum(A, band=32):
    """Stage II that also records every reflector (twin of the JAX
    ``band_to_bidiagonal_accum``); same schedule and arithmetic as
    :func:`band_to_bidiagonal`, so ``(d, e)`` are bit-equal to it.

    Returns ``(d, e, VL, TL, VR, TR)``.  Reflector ``(i, s)`` of sweep ``i``
    at slot ``s`` (0: the head pair, s >= 1: chase pair s-1) has ``band``
    entries with support ``[i+1+s*band, i+1+(s+1)*band)``: rows for the left
    ones ``VL`` (taus ``TL``), columns for the right ones ``VR``/``TR``.
    Records are ``(n-1, s_max, band)`` with ``s_max = s_max_of(n, band)``;
    slots the schedule never fills stay zero with tau 0.  The band factors
    as ``A = L @ bidiag(d, e) @ R^T`` with ``L`` the left reflectors' and
    ``R^T`` the right reflectors' products in creation order.
    """
    if A.shape[0] < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    return _chase(A, band, record=True)


def wave_lanes(n, band, defer_left=False):
    """Chase lanes of the wavefront schedule: sweep ``i`` runs slot ``s``
    (0: head pair, ``1 <= s <= S``) at tick ``3 i + s``, so at most
    ``ceil(S / 3)`` sweeps chase at once; ``S = nc_of(0)``, one more with
    ``defer_left`` (the flush of the last pending left)."""
    S = nc_of_static(0, n, int(band)) + (1 if defer_left else 0)
    return -(-S // 3)


def band_to_bidiagonal_wavefront(A, band=32, defer_left=False, record=False):
    """Stage II on the wavefront schedule (twin of the JAX
    ``band_to_bidiagonal_wavefront``); returns ``(d, e)``, and with
    ``record`` ``(d, e, VL, TL, VR, TR)`` as :func:`band_to_bidiagonal_accum`.

    Sweep ``i`` runs slot ``s`` (0: the head pair, ``s >= 1``: chase pair
    ``s - 1``) at tick ``t = 3 i + s``.  Window corners advance ``band`` rows
    a slot, so the windows of one tick lie ``3 band - 1 >= 2 band`` rows
    apart: disjoint.  Each tick runs the head pair, then every active lane's
    pair (the same :func:`make_window_pairs`) in lane order, one window at a
    time (a batched product would change the reduction order), so ``(d, e)``
    are bit-equal to :func:`band_to_bidiagonal`'s.  Lanes past a sweep's
    ``nc_of`` pairs run nothing (the JAX package aims them at a zero corner).

    ``defer_left=True`` runs the order of the deferred-left kernel: a pair's
    left apply runs at the next tick, before that sweep's next right
    elimination, and one more tick a sweep flushes the last one.  No other
    pair touches those rows in between, so ``(d, e)`` are bit-equal again.

    ``record=True`` (the plain version of the recording wavefront kernel)
    stores each pair's reflectors in its slot ``(i, s)`` as they are made,
    in wavefront order; every pair computes what the sequential schedule's
    does, so the records are bit-equal to :func:`band_to_bidiagonal_accum`'s.
    It does not combine with ``defer_left``.
    """
    n = A.shape[0]
    if record and defer_left:
        raise ValueError("record=True runs without defer_left")
    if n < 2:
        if record:
            raise ValueError("band_to_bidiagonal_accum needs n >= 2")
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    w = int(band) + 1
    b = w - 1
    ww = 2 * w - 2
    Ap = A.new_zeros((n + 3 * w, n + 3 * w))  # as _chase: windows stay inside
    Ap[:n, :n] = A
    top_pair, chase_pair = make_window_pairs(w, record=record)
    if record:
        s_max = s_max_of(n, b)
        VL, VR = A.new_zeros((2, n - 1, s_max, b))
        TL, TR = A.new_zeros((2, n - 1, s_max))
    extra = 1 if defer_left else 0
    S = nc_of_static(0, n, b) + extra
    lanes = wave_lanes(n, b, defer_left)
    pending = {}  # sweep -> (window, left_r0, v, tau) of its deferred left
    for t in range(3 * (n - 2) + S + 1):
        i = t // 3
        if t % 3 == 0 and i <= n - 2:  # the head pair of sweep i
            W = Ap[i : i + w, i + 1 : i + 1 + ww]
            if defer_left:
                _right_elim(W, w)
                pending[i] = (W, 1) + _left_reflector(W, 1)
            elif record:
                _, VR[i, 0], TR[i, 0], VL[i, 0], TL[i, 0] = top_pair(W)
            else:
                top_pair(W)
        q = (t - 1) // 3  # newest sweep past its head
        for lane in range(lanes):
            i = q - lane
            s = t - 3 * i
            if i < 0 or i > n - 2 or s > nc_of_static(i, n, b) + extra:
                continue
            r = i + 1 + (s - 1) * b
            W = Ap[r : r + ww, r + b : r + b + ww]
            if record:
                _, VR[i, s], TR[i, s], VL[i, s], TL[i, s] = chase_pair(W)
                continue
            if not defer_left:
                chase_pair(W)
                continue
            _left_apply(*pending.pop(i))
            if s <= nc_of_static(i, n, b):
                _right_elim(W, w)
                pending[i] = (W, b) + _left_reflector(W, b)
    B = Ap[:n, :n]
    d, e = torch.diagonal(B).clone(), torch.diagonal(B, 1).clone()
    return (d, e, VL, TL, VR, TR) if record else (d, e)


def _box_in(M, r, c, h, w):
    """An ``h x w`` box of ``M`` at ``(r, c)``; zero past ``M``'s edge (the
    TMA copy's out-of-bounds fill)."""
    n = M.shape[0]
    box = M.new_zeros((h, w))
    rh, cw = max(0, min(h, n - r)), max(0, min(w, n - c))
    box[:rh, :cw] = M[r : r + rh, c : c + cw]
    return box


def _box_out(M, box, r, c):
    """Write ``box`` back at ``(r, c)``, dropping what lies past the edge."""
    n = M.shape[0]
    h, w = box.shape
    rh, cw = max(0, min(h, n - r)), max(0, min(w, n - c))
    M[r : r + rh, c : c + cw] = box[:rh, :cw]


def band_to_bidiagonal_wavefront_tiles(A, band=32, record=False, carry=True,
                                       defer_left=False):
    """The shared-memory tick of the wavefront chase kernel, plain: each
    pair of :func:`~svdsolver_tpu_torch.ops.chase_schedule.wave_pairs` copies
    its boxes out of an unpadded copy of ``A`` (zeros past ``n``), runs the
    one pair of :func:`make_window_pairs` on a window built from them, and
    writes back only the boxes the kernel writes back: a chase lane keeps
    its ``(r + b, c + b)`` tile for its next pair (``carry=True``), which
    then loads two tiles, not three.  Writes past ``n`` are dropped.
    Returns what :func:`band_to_bidiagonal_wavefront` returns, bit-equal.

    ``defer_left=True``: the deferred-left entry's tick (the slots of
    ``wave_pairs(defer_left=True)``), bit-equal to
    ``band_to_bidiagonal_wavefront(defer_left=True)``; it does not combine
    with ``record``.
    """
    n = A.shape[0]
    if record and defer_left:
        raise ValueError("record=True runs without defer_left")
    if n < 2:
        if record:
            raise ValueError("band_to_bidiagonal_accum needs n >= 2")
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    b = int(band)
    if defer_left:
        M = _wavefront_dl_tiles(A, b, carry)
        return torch.diagonal(M).clone(), torch.diagonal(M, 1).clone()
    M = A.clone()
    top_pair, chase_pair = make_window_pairs(b + 1, record=record)
    if record:
        s_max = s_max_of(n, b)
        VL, VR = A.new_zeros((2, n - 1, s_max, b))
        TL, TR = A.new_zeros((2, n - 1, s_max))
    kept = {}  # lane -> the tile it carries to its next pair
    for p in wave_pairs(n, b, carry=carry):
        if p.s == 0:
            W = _box_in(M, p.r, p.c, b + 1, 2 * b)
            out = top_pair(W)
            _box_out(M, W, p.r, p.c)
        else:
            W = A.new_zeros((2 * b, 2 * b))  # (r, c + b) is never touched
            W[:b, :b] = kept.pop(p.unit) if p.carry_in else _box_in(M, p.r, p.c, b, b)
            W[b:, :b] = _box_in(M, p.r + b, p.c, b, b)
            W[b:, b:] = _box_in(M, p.r + b, p.c + b, b, b)
            out = chase_pair(W)
            for rr, cc in p.stores:
                _box_out(M, W[rr - p.r : rr - p.r + b, cc - p.c : cc - p.c + b], rr, cc)
            if p.carry_out:
                kept[p.unit] = W[b:, b:].clone()
        if record:
            _, VR[p.i, p.s], TR[p.i, p.s], VL[p.i, p.s], TL[p.i, p.s] = out
    if record:  # pairs past n run nothing: the plain records' identity, e_0
        for i in range(n - 1):
            for s in range(1, nc_of_static(i, n, b) + 1):
                if i + 1 + s * b >= n:
                    VL[i, s, 0] = VR[i, s, 0] = 1
    d, e = torch.diagonal(M).clone(), torch.diagonal(M, 1).clone()
    return (d, e, VL, TL, VR, TR) if record else (d, e)


def _wavefront_dl_tiles(A, b, carry):
    """The deferred-left tick over an unpadded copy of ``A``; returns it.
    Each slot applies its pending left reflector to a ``b x 2b`` window
    built from tiles ``(r, c - b)`` and ``(r, c)``, then (``c < n``) the
    right elimination of pair ``(i, s)`` to a ``2b x 2b`` window whose left
    half is tiles ``(r, c)`` and ``(r + b, c)``, and takes the new left
    reflector from its column 0, rows ``[b, 2b)``: the shapes the plain
    wavefront's windows give the same steps, so every entry is bit-equal
    to it.  Pending reflectors of every sweep sit in one dict, the device
    ring and the lanes' shared memory alike (the arithmetic does not
    depend on where they are kept); the tiles move as the kernel moves
    them."""
    n = A.shape[0]
    M = A.clone()
    kept = {}  # lane -> the (r + b, c) tile it carries to its next slot
    pending = {}  # sweep -> (v, tau) of its pending left reflector
    for p in wave_pairs(n, b, carry=carry, defer_left=True):
        if p.s == 0:  # the head: its right elimination, its left reflector pending
            W = A.new_zeros((b + 1, 2 * b))  # (i, i + 1 + b) is never touched
            W[:, :b] = _box_in(M, p.r, p.c, b + 1, b)
            _right_elim(W, b + 1)
            pending[p.i] = _left_reflector(W, 1)
            _box_out(M, W[:, :b], p.r, p.c)
            continue
        r, c = p.r, p.c
        P = A.new_zeros((b, 2 * b))  # rows [r, r + b) x columns [c - b, c + b)
        P[:, :b] = kept.pop(p.unit) if p.carry_in else _box_in(M, r, c - b, b, b)
        right = c < n
        if right:
            P[:, b:] = _box_in(M, r, c, b, b)
        _left_apply(P, 0, *pending.pop(p.i))
        tiles = {(r, c - b): P[:, :b]}
        if right:
            W = A.new_zeros((2 * b, 2 * b))  # (r, c + b) and (r + b, c + b): not read
            W[:b, :b] = P[:, b:]
            W[b:, :b] = _box_in(M, r + b, c, b, b)
            _right_elim(W, b + 1)
            pending[p.i] = _left_reflector(W, b)
            tiles[r, c], tiles[r + b, c] = W[:b, :b], W[b:, :b]
            if p.carry_out:
                kept[p.unit] = W[b:, :b].clone()
        for rc in p.stores:
            _box_out(M, tiles[rc], *rc)
    return M


def band_to_bidiagonal_staged_tiles(A, band=32, khops=1, record=False):
    """The staged chase kernel's TMA route, plain: the steps of
    :func:`~svdsolver_tpu_torch.ops.chase_schedule.staged_copies` on a ring
    of ``2 khops + 1`` tile slots of ``(band + 1) x (band + 4)`` over an
    unpadded copy of ``A`` (``band`` a multiple of 4).  Loads read the
    matrix when issued and stores write it when issued (the schedule never
    lets a load or a store meet a store in flight); the pairs are
    :func:`make_window_pairs`' steps on windows built from the slots (a
    tile found at its row in the box its slot holds), the right elimination
    on A and B, the left one on B and C, and the 4 columns two boxes of a
    row band share are copied across after each pair, as the kernel's
    ``share_overlap`` does.  Returns ``(d, e)``, bit-equal to
    :func:`band_to_bidiagonal`'s; with ``record`` (the recording entry)
    ``(d, e, VL, TL, VR, TR)``, each pair's reflectors in its slot as
    they are made, bit-equal to :func:`band_to_bidiagonal_accum`'s.
    """
    n = A.shape[0]
    if n < 2:
        if record:
            raise ValueError("band_to_bidiagonal_accum needs n >= 2")
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    M = A.clone()
    out = _staged_tiles(A, int(band), int(khops), record,
                        lambda r, c, h, w: _box_in(M, r, c, h, w),
                        lambda box, r, c: _box_out(M, box, r, c))
    d, e = torch.diagonal(M).clone(), torch.diagonal(M, 1).clone()
    return (d, e, *out) if record else (d, e)


def _staged_tiles(A, b, khops, record, box_in, box_out):
    """The steps of the staged kernel's TMA route over the matrix that
    ``box_in(r, c, h, w)`` and ``box_out(box, r, c)`` copy boxes of;
    returns the records ``(VL, TL, VR, TR)`` with ``record``, else ()."""
    n = A.shape[0]
    w = b + 1
    if record:
        s_max = s_max_of(n, b)
        VL, VR = A.new_zeros((2, n - 1, s_max, b))
        TL, TR = A.new_zeros((2, n - 1, s_max))
    slots = [A.new_zeros((b + 1, b + 4)) for _ in range(2 * khops + 1)]
    box_row = [0] * len(slots)  # the first matrix row of the box a slot holds

    def share_overlap(lo, hi, delta, rows):
        hi[:rows, :delta] = lo[:rows, b : b + delta]
        lo[:rows, b + delta : b + 4] = hi[:rows, delta:4]

    def tile(s, r, dl):  # the b x b tile of rows [r, r + b) in slot s
        o = r - box_row[s]
        return slots[s][o : o + b, dl : dl + b]

    W = None
    for op in staged_copies(n, b, khops):
        if op.kind == "load":
            slots[op.slot][: op.rows] = box_in(op.r, op.c, op.rows, b + 4)
            box_row[op.slot] = op.r
        elif op.kind == "store":
            box_out(slots[op.slot][: op.rows], op.r, op.c)
        elif op.kind == "head":
            dl = op.c & 3
            h0, h1 = (slots[s] for s in op.slots)
            W = torch.cat((h0[:, dl : dl + b], h1[:, dl : dl + b]), dim=1)
            right = _right_elim(W, w)
            left = _left_reflector(W, 1)
            _left_apply(W, 1, *left)
            if record:  # the head's slot 0
                (VR[op.r, 0], TR[op.r, 0]), (VL[op.r, 0], TL[op.r, 0]) = right, left
            h0[:, dl : dl + b], h1[:, dl : dl + b] = W[:, :b], W[:, b:]
            share_overlap(h0, h1, dl, b + 1)
        elif op.kind == "right":
            dl = op.c & 3
            sA, sB, _ = op.slots
            W = A.new_zeros((2 * b, 2 * b))  # (r, c + b) is never touched
            W[:b, :b], W[b:, :b] = tile(sA, op.r, dl), tile(sB, op.r + b, dl)
            right = _right_elim(W, w)
            if record:  # chase pair k's slot k + 1
                i, k = op.pair
                VR[i, k + 1], TR[i, k + 1] = right
            tile(sA, op.r, dl)[:], tile(sB, op.r + b, dl)[:] = W[:b, :b], W[b:, :b]
        elif op.kind == "left":
            dl = op.c & 3
            _, sB, sC = op.slots
            W[b:, b:] = tile(sC, op.r + b, dl)
            left = _left_reflector(W, b)
            _left_apply(W, b, *left)
            if record:
                i, k = op.pair
                VL[i, k + 1], TL[i, k + 1] = left
            tile(sB, op.r + b, dl)[:], tile(sC, op.r + b, dl)[:] = W[b:, :b], W[b:, b:]
            share_overlap(slots[sB], slots[sC], dl, b)
    if not record:
        return ()
    for i in range(n - 1):  # pairs past n run nothing: the plain records' identity, e_0
        for k in range(staged_pairs(i, n, b), nc_of_static(i, n, b)):
            VL[i, k + 1, 0] = VR[i, k + 1, 0] = 1
    return VL, TL, VR, TR


def pack_store(A, band):
    """The band store of the packed chase's TMA design (``csrc/
    band_chase_staged.cu``): a flat buffer of ``store_floats(n, band)``
    floats holding ``A[g, j]`` at ``store_pitch(band) * g + j`` for
    ``j - g`` in :func:`~svdsolver_tpu_torch.ops.chase_schedule.
    store_range`, zero at every other address."""
    n = A.shape[0]
    S = store_pitch(band)
    lo, hi = store_range(band)
    St = A.new_zeros((store_floats(n, band),))
    for t in range(lo, hi + 1):  # diagonal t's rows [g0, g1) at (S + 1) g + t
        g0, g1 = max(0, -t), min(n, n - t)
        if g0 < g1:
            St[(S + 1) * g0 + t:(S + 1) * (g1 - 1) + t + 1:S + 1] = torch.diagonal(A, t)
    return St


def band_to_bidiagonal_store_tiles(A, band=32, khops=1):
    """The packed chase's TMA design, plain: :func:`pack_store`, then the
    steps of :func:`band_to_bidiagonal_staged_tiles` with every box copied
    out of and into the store (row ``g`` of a box at ``store_pitch * g``;
    zero past ``n``, writes past ``n`` dropped), each box's entries
    checked to lie in the store's range; ``(d, e)`` read from the store.
    Bit-equal to :func:`band_to_bidiagonal`."""
    n = A.shape[0]
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    b = int(band)
    S = store_pitch(b)
    lo, hi = store_range(b)
    St = pack_store(A, b)

    def view(r, c, h, w):  # the box's entries inside the matrix, in the store
        rh, cw = max(0, min(h, n - r)), max(0, min(w, n - c))
        if rh and cw and not (lo <= c - (r + rh - 1) and c + cw - 1 - r <= hi):
            raise AssertionError(f"box ({r}, {c}) leaves the store's range")
        return St.as_strided((rh, cw), (S, 1), S * r + c)

    def box_in(r, c, h, w):
        box = A.new_zeros((h, w))
        part = view(r, c, h, w)
        box[: part.shape[0], : part.shape[1]] = part
        return box

    def box_out(box, r, c):
        part = view(r, c, *box.shape)
        part.copy_(box[: part.shape[0], : part.shape[1]])

    _staged_tiles(A, b, int(khops), False, box_in, box_out)
    d = St.as_strided((n,), (S + 1,), 0).clone()
    e = St.as_strided((n - 1,), (S + 1,), 1).clone()
    return d, e


def bidiagonalize_two_stage(A, band=32, wavefront=False):
    """Full two-stage reduction, dense -> band -> bidiagonal; returns
    ``(d, e)``.  ``wavefront=True`` runs Stage II on the wavefront schedule
    (bit-equal to the sequential one)."""
    A = dense_to_band(A, band=band)
    if wavefront:
        return band_to_bidiagonal_wavefront(A, band=band)
    return band_to_bidiagonal(A, band=band)


PACK_WIDTH = 512  # packed lanes a row: the chase stays in [1, 511) for band <= 128


def packed_rows(n, band):
    """Rows of the packed band: ``ceil((n + 3 band + 8) / 128) * 128``."""
    return -(-(n + 3 * int(band) + 8) // 128) * 128


def _pack_blocks(n, Npad):
    """Per 128-row block: rows ``[r0, r1)`` and the matrix columns
    ``[cs, cs + cw)`` it holds at lanes ``[l0, l0 + cw)``."""
    for r0 in range(0, min(n, Npad), 128):
        c0 = r0 - 128
        l0 = max(0, -c0)
        cs = c0 + l0
        cw = min(PACK_WIDTH - l0, n - cs)
        if cw > 0:
            yield r0, min(r0 + 128, n), cs, cw, l0


def pack_band(A, band):
    """The block-packed band of the packed chase (the layout of the JAX
    ``band_chase_vmem``): ``P[row, l] = A[row, 128 * (row // 128) - 128 + l]``
    for ``l < 512``, zero where that column is outside ``[0, n)`` and in the
    rows past ``n``; ``packed_rows(n, band)`` rows.  For ``band <= 128``
    every window of the chase stays in lanes ``[1, 511)``."""
    n = A.shape[0]
    P = A.new_zeros((packed_rows(n, band), PACK_WIDTH))
    for r0, r1, cs, cw, l0 in _pack_blocks(n, P.shape[0]):
        P[r0:r1, l0 : l0 + cw] = A[r0:r1, cs : cs + cw]
    return P


def unpack_band(P, n):
    """The (n, n) matrix whose packed lanes ``P`` holds (inverse of
    :func:`pack_band` on every entry the layout keeps; zero elsewhere)."""
    A = P.new_zeros((n, n))
    for r0, r1, cs, cw, l0 in _pack_blocks(n, P.shape[0]):
        A[r0:r1, cs : cs + cw] = P[r0:r1, l0 : l0 + cw]
    return A
