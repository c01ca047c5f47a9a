"""Kernel 1: compact-WY panel QR (``csrc/panel_qr.cu``), and the Stage I
loop around it.

Twin of ``svdsolver_tpu/ops/pallas/panel_qr.py``: up to b = 256 the panel
factorization runs in one launch on the card, one thread-block cluster
whose CTAs each hold a slab of the panel's columns in shared memory
(:func:`cluster_plan`).  Past it the panel is blocked
(:func:`block_plan`): sub-panels of :data:`BLOCK_NB` rows of ``Pt``, each
one launch of the same kernel, and between them the block reflector's
update of the rows still to factor (one cluster launch of
``csrc/panel_products.cu``'s ``svdt_panel_update`` a sub-panel,
:func:`update_plan`) and T's compact-WY merge (one launch of its
``svdt_panel_merge``).  ``_design="gemm"`` runs the first design of those
products instead, ``panel_qr.cu``'s ``svdt_panel_gemm`` and
``svdt_panel_sum`` (four launches an update, two a merge): the bitwise
oracle, which the main path never takes.  The Stage I's trailing updates
are plain ``torch.matmul`` GEMMs (fp32, TF32 off), as they are XLA GEMMs
outside the kernel in the reference.  On a CPU tensor :func:`panel_qr`
runs :func:`panel_qr_plain`, the same column loop in PyTorch;
:func:`panel_qr_blocked_plain` is the blocked order in PyTorch.
"""

import ctypes
from typing import NamedTuple

import torch

from svdsolver_tpu_torch.models.two_stage import _check_stage1, segment_bounds
from svdsolver_tpu_torch.ops.cuda import _build, tiled_slab
from svdsolver_tpu_torch.ops.householder import householder_vector
from svdsolver_tpu_torch.ops.precision import pdot

launches = 0  # launches of the panel kernel (a panel, or a blocked panel's sub-panel)
launches_update = 0  # svdt_panel_update: a blocked panel's Gram and row update, one a sub-panel
launches_merge = 0  # svdt_panel_merge: a blocked panel's T merge, one a sub-panel
# the first design of the products (the oracle, _design="gemm"): launches of
# svdt_panel_gemm and svdt_panel_sum for the update, of svdt_panel_gemm for the merge
launches_update_gemm = 0
launches_merge_gemm = 0

_P, _I, _L = _build.VOIDP, _build.INT, _build.LONG
_F = ctypes.c_float
_ENTRIES = {
    "svdt_panel_qr": [_P] * 4 + [_I] * 13 + [_P],
    "svdt_panel_qr_clusters": [_I] * 3 + [_P],
    "svdt_panel_gemm": [_P, _P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _L, _I, _I, _I, _I,
                        _F, _F, _P],
    "svdt_panel_sum": [_P, _I, _L, _P, _L, _P, _P],
}
_PRODUCT_ENTRIES = {
    "svdt_panel_update": [_P] * 4 + [_I] * 10 + [_P],
    "svdt_panel_merge": [_P, _P, _I, _I, _I, _P],
}
THREADS = 1024  # a CTA of the kernel
MAX_CLUSTER = 16  # CTAs a cluster at most (non-portable above 8)
NARROW_BAND = 256  # b <= THREADS / 4: 4 lanes a row or more, T in shared memory
CTA_TARGET = 64 * 1024  # slab bytes a CTA aims at: C grows until it is met
# past NARROW_BAND: sub-panels of BLOCK_NB rows, each a cluster of about
# LEAF_COLS columns a CTA (the leaf sweep, chip_smoke.time_k1_leaves: on the
# H100 nb = 64 at 128 columns a CTA took 5.3 us a column at m = 2048 and
# 5.1 at m = 1024, the least of every nb in 32-256 and C in 1-16)
BLOCK_NB = 64
LEAF_COLS = 128
GEMM_TILE = 64  # the first design's product tile of C
GEMM_SPLIT_K = 128  # the Gram's columns a split at least
# svdt_panel_update's layout, read from its source (csrc/panel_products.cu),
# which defines it once: the columns of its copy boxes (BLOCK_NB rows each),
# box slots a CTA at most, the shared-memory bytes beside the boxes (the
# partial Gram, G, Z^T, T_k, alignment) and the dynamic shared memory it takes
_UPDATE = _build.constants("panel_products")
UPDATE_BOX = _UPDATE["kBox"]
UPDATE_MAX_STAGES = _UPDATE["kMaxStages"]
UPDATE_FIXED = _UPDATE["kFixedBytes"]
_resident = {}  # (ctas, smem, spill) -> clusters that fit on the card


class ClusterPlan(NamedTuple):
    """How the kernel cuts a (b, m) panel: ``ctas`` CTAs of one cluster,
    ``width`` columns each, ``smem_cols`` of them in shared memory with row
    stride ``ld`` (the rest, if any, in device memory: the large-panel
    route), ``tcols`` columns of T each (row stride ``tld`` in shared
    memory), ``groups`` lanes a row in the dot and update passes, ``smem``
    bytes a CTA."""

    ctas: int
    width: int
    smem_cols: int
    ld: int
    tcols: int
    tld: int
    groups: int
    smem: int

    @property
    def spill(self):
        return self.smem_cols < self.width


def _cdiv(a, b):
    return -(-a // b)


def cluster_plan(b, m, ctas=None):
    """The cluster launch of the panel kernel for a (b, m) panel, b up to
    :data:`NARROW_BAND` (wider panels are blocked: :func:`block_plan`).

    ``ctas=None`` takes the fewest CTAs (a power of two, at most 16) whose
    slabs are at most ``CTA_TARGET`` bytes, else 16.  Each CTA's slab of
    ``width = ceil(m / ctas)`` columns (a multiple of 4) goes to shared
    memory with a row stride equal to ``groups`` mod 32 (the warp's rows on
    distinct banks); where it does not fit ``_build.MAX_SMEM`` beside v, the
    CTA's T columns and the exchange arrays, the columns past what fits stay
    in device memory, in the CTA's own columns of ``Rt`` (the large-panel
    route: at b = 128 every m above 6,784, e.g. 1,048 of 1,440 columns a
    CTA at m = 23,040).  ``groups`` is the largest power of two up to 32
    with ``groups * b <= THREADS``: 4 or more lanes a row.  Raises
    ``ValueError`` for ``b < 1``, ``m < 1`` or ``b`` past
    :data:`NARROW_BAND`, and for a panel so long that v and the exchange
    arrays leave the slab no shared memory (m past ~860,000 at b = 128).
    """
    b, m = int(b), int(m)
    if b < 1:
        raise ValueError(f"panel width b={b} must be >= 1")
    if b > NARROW_BAND:
        raise ValueError(f"panel width b={b} past the cluster kernel's limit of "
                         f"{NARROW_BAND}: block_plan cuts wider panels")
    if m < 1:
        raise ValueError(f"panel length m={m} must be >= 1")
    if ctas is None:
        C = next((c for c in (1, 2, 4, 8) if 4 * b * _cdiv(m, c) <= CTA_TARGET), MAX_CLUSTER)
    else:
        C = int(ctas)
        if not 1 <= C <= MAX_CLUSTER:
            raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} CTAs, not {ctas}")
    W = 4 * _cdiv(_cdiv(m, C), 4)
    G = 1 << (min(32, THREADS // b).bit_length() - 1)
    tc = _cdiv(b, C)
    tld = tc + 1 if tc % 2 == 0 else tc
    other = W + b * tld + 2 * (MAX_CLUSTER + 1) + C * b  # floats beside the slab
    room = _build.MAX_SMEM // 4 - other  # slab floats that fit
    ld = W + (G - W) % 32  # the smallest stride >= W that is = G (mod 32)
    if b * ld <= room:
        ws = W
    else:
        if room // b < G:
            raise ValueError(
                f"panel (b={b}, m={m}) past the kernel's limit: v and the exchange "
                f"arrays of {W} columns leave no shared memory for the slab"
            )
        ld = room // b - (room // b - G) % 32  # the largest that fits
        ws = ld
    return ClusterPlan(C, W, ws, ld, tc, tld, G, 4 * (b * ld + other))


def _check_resident(lib, plan):
    """Raise unless one cluster of the plan fits on the card."""
    key = (plan.ctas, plan.smem, plan.spill)
    if key not in _resident:
        got = ctypes.c_int(0)
        err = lib.svdt_panel_qr_clusters(plan.ctas, plan.smem, int(plan.spill),
                                         ctypes.addressof(got))
        _build.raise_on_error(err, "cudaOccupancyMaxActiveClusters (panel_qr)")
        _resident[key] = got.value
    if _resident[key] < 1:
        raise ValueError(
            f"a cluster of {plan.ctas} CTAs with {plan.smem} bytes of shared "
            "memory each cannot be resident on this card "
            "(cudaOccupancyMaxActiveClusters = 0)"
        )


def panel_qr_plain(Pt, r_off):
    """Plain PyTorch version of the kernel: factor the transposed panel
    ``Pt`` (b, m) whose row j is panel column j, pivot at ``r_off + j``.
    Returns ``(Rt, Vt, Tt)``: R transposed with exact zeros beyond each
    pivot and ``beta`` at it, the reflectors as rows, and ``T^T``."""
    b, m = Pt.shape
    Rt = Pt.clone()
    Vt = Pt.new_zeros((b, m))
    Tt = Pt.new_zeros((b, b))
    cols = torch.arange(m, device=Pt.device)
    zero = Pt.new_zeros(())
    for j in range(b):
        p = r_off + j
        v, tau, beta = householder_vector(Rt[j], p)
        Rt = Rt - tau * torch.outer(pdot(Rt, v), v)
        rowj = torch.where(cols > p, zero, Rt[j])
        if p < m:
            rowj[p] = beta
        Rt[j] = rowj
        w = pdot(Vt, v)  # zero at rows >= j
        Tt[j] = -tau * pdot(w, Tt)
        Tt[j, j] = tau
        Vt[j] = v
    return Rt, Vt, Tt


class BlockPlan(NamedTuple):
    """How a (b, m) panel past :data:`NARROW_BAND` is blocked: ``panels``
    sub-panels of ``nb`` rows of ``Pt`` (the last ``b - (panels - 1) nb``),
    each launched under ``leaf`` (the plan of a full sub-panel)."""

    nb: int
    panels: int
    leaf: ClusterPlan


def leaf_ctas(m):
    """CTAs of a sub-panel's cluster on a panel of length ``m``: the least
    power of two with at most :data:`LEAF_COLS` columns a CTA, at most
    :data:`MAX_CLUSTER`."""
    return min(MAX_CLUSTER, 1 << (_cdiv(int(m), LEAF_COLS) - 1).bit_length())


def block_plan(b, m, ctas=None):
    """The blocked panel of a (b, m) panel: sub-panels of :data:`BLOCK_NB`
    rows, each one cluster of ``ctas`` (default :func:`leaf_ctas`) CTAs
    under :func:`cluster_plan`."""
    C = leaf_ctas(m) if ctas is None else ctas
    return BlockPlan(BLOCK_NB, _cdiv(int(b), BLOCK_NB), cluster_plan(BLOCK_NB, m, C))


def blocked_launches(b, m, r_off, nb=BLOCK_NB):
    """``(sub-panels, updates, merges)``: the launches of one blocked
    (b, m) panel with pivots from ``r_off`` (:func:`panel_qr_blocked`):
    every sub-panel on the panel kernel; each sub-panel with a pivot below
    m one update, and one merge where it is not the first."""
    live = [r0 for r0 in range(0, int(b), nb) if r_off + r0 < m]
    return _cdiv(int(b), nb), len(live), sum(r0 > 0 for r0 in live)


def stage1_pairs(n, b, segments=None):
    """``(s0, c)``: the panel pairs of the fused Stage I (:func:`_stage1_fused`)
    on an n x n matrix at band b, in order: each pair's segment starts at
    row and column ``s0`` and its QR panel at column ``c`` of the segment's
    trailing block ``A[s0:, s0:]``.  ``segments=None`` picks
    :func:`_auto_segments`."""
    if segments is None:
        segments = _auto_segments(n, b)
    bounds = segment_bounds(n // b, segments)
    for k0, k1 in zip(bounds, bounds[1:]):
        for k in range(k1 - k0):
            yield k0 * b, k * b


def stage1_panels(n, b):
    """``(m, r_off)`` of every panel the fused Stage I factors on an n x n
    matrix (n padded to a multiple of b) at band b: the QR and the LQ panel
    of each of :func:`stage1_pairs`, on the segment's trailing block."""
    n = _cdiv(int(n), b) * b
    for s0, c in stage1_pairs(n, b):
        yield n - s0, c
        yield n - s0, c + b


def panel_qr_blocked_plain(Pt, r_off, nb=BLOCK_NB):
    """Plain PyTorch version of the blocked panel: the transposed panel
    ``Pt`` (b, m) factored in sub-panels of ``nb`` rows, each by
    :func:`panel_qr_plain` with pivots at ``r_off + r0 + j``; after each,
    the rows below take its block reflector, ``Pt_rest -= ((Pt_rest
    Vt_k^T) T_k) Vt_k`` with ``T_k = Tt_kk^T``, and T's block row k comes
    from the compact-WY merge ``Tt_{k,0:k} = -Tt_kk ((Vt_k Vt_{0:k}^T)
    Tt_{0:k,0:k})``.  A sub-panel whose pivots all lie at or past ``m`` is
    identity reflectors and updates nothing.  Returns ``(Rt, Vt, Tt)`` as
    :func:`panel_qr_plain` (the same maths; sums in another order)."""
    b, m = Pt.shape
    nb = int(nb)
    W = Pt.clone()
    Rt = torch.empty_like(Pt)
    Vt = torch.empty_like(Pt)
    Tt = Pt.new_zeros((b, b))
    for r0 in range(0, b, nb):
        r1, p0 = min(b, r0 + nb), r_off + r0
        Rt[r0:r1], Vt[r0:r1], Tt[r0:r1, r0:r1] = panel_qr_plain(W[r0:r1], p0)
        if p0 < m:
            update_plain(W, Vt, Tt, r0, r1, p0)
            merge_plain(Vt, Tt, r0, r1, p0)
    return Rt, Vt, Tt


def update_plain(W, Vt, Tt, r0, r1, p0):
    """Plain version of sub-panel ``[r0, r1)``'s update (the product
    kernel's Gram, sum and two products): ``W_{r1:b, p0:} -= ((W Vt_k^T)
    T_k) Vt_k`` in place, pivots from ``p0``."""
    Vk, Tk = Vt[r0:r1, p0:], Tt[r0:r1, r0:r1]
    W[r1:, p0:] -= pdot(pdot(pdot(W[r1:, p0:], Vk.T), Tk.T), Vk)
    return W


def merge_plain(Vt, Tt, r0, r1, p0):
    """Plain version of sub-panel ``[r0, r1)``'s T merge, its Gram
    included: ``Tt_{k,0:r0} = -Tt_kk ((Vt_k Vt_{0:r0}^T) Tt_{0:r0,0:r0})``
    in place."""
    return merge_gram_plain(pdot(Vt[:r0, p0:], Vt[r0:r1, p0:].T), Tt, r0, r1)


def merge_gram_plain(G, Tt, r0, r1):
    """Plain version of :func:`_merge` (the product kernel's two merge
    products) on the Gram's rows ``G = Vt_{0:r0} Vt_k^T`` (r0, k):
    ``Tt_{k,0:r0} = -Tt_kk (G^T Tt_{0:r0,0:r0})`` in place."""
    Tt[r0:r1, :r0] = -pdot(Tt[r0:r1, r0:r1], pdot(G.T, Tt[:r0, :r0]))
    return Tt


def panel_qr(Pt, r_off, _cluster=None, _design="cluster"):
    """Householder QR of the transposed panel ``Pt`` (b, m), pivots at
    ``r_off + j``; returns ``(Rt, Vt, Tt)`` as :func:`panel_qr_plain`.

    A CUDA tensor must be contiguous float32.  Up to b = 256
    (:data:`NARROW_BAND`) it launches the kernel as one cluster under
    :func:`cluster_plan` (``_cluster`` fixes its CTA count); past it, the
    blocked panel (:func:`panel_qr_blocked`; ``_cluster`` fixes the
    leaves' CTAs, ``_design`` its products).  A shape past the plans'
    limits, or a cluster the card cannot hold, raises ``ValueError``.  A
    CPU tensor runs the plain version.  Pivots at or past ``m`` give
    identity reflectors (``tau = 0``, ``v = 0``).
    """
    global launches
    r_off = int(r_off)
    if r_off < 0:
        raise ValueError(f"r_off must be >= 0, got {r_off}")
    if not _build.check_input(Pt, "Pt", 2):
        return panel_qr_plain(Pt, r_off)
    b, m = Pt.shape
    if b > NARROW_BAND:
        return panel_qr_blocked(Pt, r_off, block_plan(b, m, _cluster), _design)
    out = _launch(Pt, r_off, cluster_plan(b, m, _cluster))
    launches += 1
    return out


def panel_qr_blocked(Pt, r_off, plan, _design="cluster"):
    """The blocked panel on float32 CUDA ``Pt`` (b, m) under ``plan``
    (:func:`block_plan`), in :func:`panel_qr_blocked_plain`'s order: each
    sub-panel one launch of the panel kernel, straight into its rows of
    ``Rt`` and ``Vt`` and T's diagonal block, then its Gram and the update
    of the rows below (:func:`_update`, one cluster launch) on the caller's
    stream, writing the Gram's rows of the panel above it into a scratch of
    its own; its T merge (:func:`_merge`) from those rows, which no later
    sub-panel waits for, on a second stream, under the next sub-panel.  The
    first sub-panel reads ``Pt`` itself and is launched before the rest is
    set up.  ``_design="gemm"`` takes the first design's products
    (:func:`_update_gemm`, :func:`_merge_gemm`) with their scratch: the
    Gram's splits, its rows below, Z and Y.  Returns ``(Rt, Vt, Tt)``."""
    if _design not in ("cluster", "gemm"):
        raise ValueError(f"the blocked panel's products are 'cluster' or 'gemm', not {_design!r}")
    b, m = Pt.shape
    nb = plan.nb
    Rt = torch.empty_like(Pt)
    Vt = torch.empty_like(Pt)
    Tt = torch.zeros((b, b), dtype=Pt.dtype, device=Pt.device)
    subs = [(r0, min(b, r0 + nb)) for r0 in range(0, b, nb)]
    _leaf(Pt, r_off, plan, subs[0], (Rt, Vt, Tt))
    W = Pt.clone()  # the rows still to factor, updated in place
    sms = tiled_slab._sms(Pt.device)
    gemm = _design == "gemm"
    # the Grams' rows above each sub-panel (the merges read them while the
    # next sub-panel runs); the first design's scratch before them
    most = 0
    if gemm:
        splits = [_gram_splits(b - (r1 - r0), r1 - r0, m - r_off - r0, sms) for r0, r1 in subs]
        most = max((b - (r1 - r0)) * (r1 - r0) * z for (r0, r1), z in zip(subs, splits))
        most += 3 * b * nb
    scratch = torch.empty(most + sum(r0 * (r1 - r0) for r0, r1 in subs),
                          dtype=Pt.dtype, device=Pt.device)
    above = _ptr(scratch, 0, most)
    if gemm:  # the Gram's splits, its rows below, Z (rows below x k), Y (k x rows above)
        parts, below, Z, Y = (_ptr(scratch, 0, o) for o in (
            0, most - 3 * b * nb, most - 2 * b * nb, most - b * nb))
    main, side = _streams(Pt.device)
    for r0, r1 in subs:
        p0 = r_off + r0
        if r0:
            _leaf(W, r_off, plan, (r0, r1), (Rt, Vt, Tt))
        if p0 < m and r1 - r0 < b:
            if gemm:
                _update_gemm(W, Vt, Tt, r0, r1, p0, splits[r0 // nb], parts, (above, below),
                             Z, main)
            else:
                _update(W, Vt, Tt, r0, r1, p0, update_plan(b, m, r0, r1, p0, sms), above, main)
            if r0:
                side.wait_stream(main)
                if gemm:
                    _merge_gemm(above, Tt, r0, r1, Y, side)
                else:
                    _merge(above, Tt, r0, r1, side)
        above += r0 * (r1 - r0) * Pt.element_size()
    main.wait_stream(side)
    return Rt, Vt, Tt


def _leaf(src, r_off, plan, sub, out):
    """Sub-panel ``sub = (r0, r1)`` of ``src``'s rows on the panel kernel,
    pivots from ``r_off + r0``, into its rows of ``Rt``, ``Vt`` and T's
    diagonal block."""
    global launches
    (r0, r1), (Rt, Vt, Tt) = sub, out
    leaf = plan.leaf if r1 - r0 == plan.nb else cluster_plan(r1 - r0, src.shape[1],
                                                             plan.leaf.ctas)
    _launch(src[r0:r1], r_off + r0, leaf, (Rt[r0:r1], Vt[r0:r1], Tt[r0:r1, r0:r1]))
    launches += 1


_sides = {}


def _streams(device):
    """The caller's stream on ``device`` and the blocked panel's second
    stream there (made once)."""
    key = torch.device(device).index
    if key not in _sides:
        _sides[key] = torch.cuda.Stream(device)
    return torch.cuda.current_stream(device), _sides[key]


def _gram_splits(rows, cols, K, sms):
    """Splits of the Gram's K so that its tiles fill the ``sms``
    multiprocessors about twice."""
    tiles = _cdiv(rows, GEMM_TILE) * _cdiv(cols, GEMM_TILE)
    return max(1, min(_cdiv(K, GEMM_SPLIT_K), 2 * sms // tiles))


class UpdatePlan(NamedTuple):
    """How ``svdt_panel_update`` cuts a sub-panel's update: ``clusters``
    clusters (one a 64-row block of the Gram's rows) of ``splits`` CTAs,
    ``chunk`` columns a CTA, read in at most ``boxes`` copy boxes of
    :data:`UPDATE_BOX` columns through ``stages`` box slots (each a box of
    the block's rows and one of V_k's), ``smem`` bytes of dynamic shared
    memory a CTA."""

    clusters: int
    splits: int
    chunk: int
    boxes: int
    stages: int
    smem: int

    @property
    def spill(self):
        """The slots cannot hold every box: the update reads them again."""
        return self.stages < self.boxes


def update_plan(b, m, r0, r1, p0, sms):
    """The launch of ``svdt_panel_update`` for sub-panel ``[r0, r1)`` of a
    (b, m) blocked panel, pivots from ``p0 < m``, on a card of ``sms``
    multiprocessors.  The splits are the first design's
    (:func:`_gram_splits`) up to :data:`MAX_CLUSTER` (a cluster holds the
    splits of one block), so the sums run in its order; CTA z takes
    columns ``[p0 + z chunk, p0 + (z + 1) chunk)`` and reads them in boxes
    from its first column rounded down to a multiple of 4 (16 bytes).
    Every box of the widest CTA gets a slot where they all fit
    ``_build.MAX_SMEM`` beside the fixed arrays (:data:`UPDATE_FIXED`);
    past that (~280 columns a CTA) as many slots as fit, and the boxes
    stream through them (the spill instance)."""
    k, rest, K = r1 - r0, b - r1, m - p0
    if not (0 < k <= BLOCK_NB and r0 % BLOCK_NB == 0 and 0 <= p0 < m):
        raise ValueError(f"no update for sub-panel [{r0}, {r1}) from p0={p0} of (b={b}, m={m})")
    S = min(MAX_CLUSTER, _gram_splits(b - k, k, K, sms))
    chunk = _cdiv(K, S)
    boxes = 0
    for z in range(S):
        s, e = p0 + min(K, z * chunk), p0 + min(K, (z + 1) * chunk)
        if e > s:
            boxes = max(boxes, _cdiv(4 * _cdiv(e, 4) - (s - s % 4), UPDATE_BOX))
    slot = 2 * _UPDATE["kBoxFloats"] * 4
    room = (_UPDATE["kMaxDynSmem"] - UPDATE_FIXED) // slot
    stages = min(boxes, room, UPDATE_MAX_STAGES)
    clusters = r0 // BLOCK_NB + _cdiv(rest, BLOCK_NB)
    return UpdatePlan(clusters, S, chunk, boxes, stages, UPDATE_FIXED + stages * slot)


def _ptr(t, i=0, j=0):
    """Address of element (i, j) of row-major ``t``."""
    return t.data_ptr() + t.element_size() * (i * t.stride(0) + j)


def _update(W, Vt, Tt, r0, r1, p0, plan, above, stream):
    """Sub-panel ``[r0, r1)``'s Gram and update on ``stream``, pivots from
    ``p0``, one launch of ``svdt_panel_update`` under ``plan``
    (:func:`update_plan`): ``G = [Vt_{0:r0}; W_{r1:b}] Vt_k^T`` over
    columns ``[p0, m)``, its rows ``[0, r0)`` (r0 x k, row-major) to
    address ``above``, and ``W_{r1:b} -= (G_{r1:b} T_k) Vt_k``, ``T_k(j,
    c) = Tt[r0 + c, r0 + j]``."""
    global launches_update
    b, m = W.shape
    # the copy engine takes rows of whole 16-byte units at 16-byte bases
    tma = int(m % 4 == 0 and W.data_ptr() % 16 == 0 and Vt.data_ptr() % 16 == 0)
    _launch_update(stream, (W.data_ptr(), Vt.data_ptr(), Tt.data_ptr(), above),
                   (b, m, r0, r1, p0), plan, tma)
    launches_update += 1


def _merge(G, Tt, r0, r1, stream):
    """T's block row of sub-panel ``[r0, r1)`` on ``stream`` from its Gram
    (the r0 x k rows ``Vt_{0:r0} Vt_k^T`` at address ``G``): ``Tt_{k,0:r0}
    = -Tt_kk (G^T Tt_{0:r0,0:r0})``, one launch of ``svdt_panel_merge``."""
    global launches_merge
    _launch_merge(stream, G, Tt, r0, r1)
    launches_merge += 1


def _update_gemm(W, Vt, Tt, r0, r1, p0, splits, parts, G, Z, stream):
    """The first design of :func:`_update` (the oracle): the Gram over
    columns ``[p0, m)`` (``r0 + b - r1`` rows, ``k = r1 - r0`` columns) in
    ``splits`` splits at ``parts``, added in order (``svdt_panel_sum``)
    into ``G = (above, below)``: its rows ``[0, r0)`` (the merge's) at
    address ``above``, the rest at ``below``; then ``W_{r1:b} -= (G_below
    T_k) Vt_k`` through ``Z``.  Each a launch of the product kernel but
    the sum."""
    global launches_update_gemm
    b, m = W.shape
    k, rest = r1 - r0, b - r1
    rows = r0 + rest
    above, below = G
    # A's rows [0, r0) are V's, rows [r0, rows) W's rows [r1, b)
    _launch_gemm(stream, rows, k, m - p0, (_ptr(Vt, 0, p0), _ptr(W, r1 - r0, p0), m, 1, r0),
                 (_ptr(Vt, r0, p0), 1, m), (parts, k, 1, rows * k), splits=splits)
    _launch_sum(stream, parts, splits, rows * k, above, r0 * k, below)
    launches_update_gemm += 2
    if rest:
        _launch_gemm(stream, rest, k, k, (below, 0, k, 1, rest),
                     (_ptr(Tt, r0, r0), 1, b), (Z, k, 1, 0))
        _launch_gemm(stream, rest, m - p0, k, (Z, 0, k, 1, rest), (_ptr(Vt, r0, p0), m, 1),
                     (_ptr(W, r1, p0), m, 1, 0), alpha=-1.0, beta=1.0)
        launches_update_gemm += 2


def _merge_gemm(G, Tt, r0, r1, Y, stream):
    """The first design of :func:`_merge` (the oracle): ``Y = G^T
    Tt_{0:r0,0:r0}`` into ``Y``, then ``Tt_{k,0:r0} = -Tt_kk Y``, two
    launches of the product kernel."""
    global launches_merge_gemm
    b, k = Tt.shape[0], r1 - r0
    _launch_gemm(stream, k, r0, r0, (G, 0, 1, k, k), (Tt.data_ptr(), b, 1), (Y, r0, 1, 0))
    _launch_gemm(stream, k, r0, k, (_ptr(Tt, r0, r0), 0, b, 1, k), (Y, r0, 1),
                 (_ptr(Tt, r0, 0), b, 1, 0), alpha=-1.0)
    launches_merge_gemm += 2


_lib = None  # the panel kernel's library, once loaded


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load("panel_qr", _ENTRIES)
    return _lib


_plib = None  # the products' library (csrc/panel_products.cu), once loaded


def _products():
    global _plib
    if _plib is None:
        _plib = _build.load("panel_products", _PRODUCT_ENTRIES)
    return _plib


def _launch_update(stream, ptrs, shape, plan, tma):
    """One launch of ``svdt_panel_update`` on ``stream``: ``ptrs = (W, Vt,
    Tt, above)`` addresses, ``shape = (b, m, r0, r1, p0)``, ``plan`` an
    :class:`UpdatePlan`, ``tma`` whether the copy engine loads the boxes.
    Raises if the launch fails (also where the card cannot hold a cluster
    of the plan's CTAs)."""
    lib = _products()
    with torch.cuda.device(stream.device):
        err = lib.svdt_panel_update(*ptrs, *shape, plan.splits, plan.chunk, plan.stages,
                                    plan.smem, tma, stream.cuda_stream)
    _build.raise_on_error(err, "panel_update")


def _launch_merge(stream, G, Tt, r0, r1):
    """One launch of ``svdt_panel_merge`` on ``stream``: T's block row of
    sub-panel ``[r0, r1)`` from the Gram's rows at address ``G``.  Raises
    if the launch fails."""
    lib = _products()
    with torch.cuda.device(stream.device):
        err = lib.svdt_panel_merge(G, Tt.data_ptr(), Tt.shape[0], r0, r1 - r0,
                                   stream.cuda_stream)
    _build.raise_on_error(err, "panel_merge")


def _launch_gemm(stream, M, N, K, a, b, c, alpha=1.0, beta=0.0, splits=1):
    """One launch of the first design's product kernel on ``stream``:
    ``C_z = alpha A B (+ beta C)``.  ``a = (ptr, ptr2, si, sk, split)``:
    A(i, k) at ptr (ptr2 from row ``split`` on) + 4 (i si + k sk); ``b =
    (ptr, sk, sj)``; ``c = (ptr, si, sj, sz)``, split z of K at ptr + 4 z
    sz.  Raises if the launch fails."""
    pa, pa2, a_si, a_sk, a_split = a
    lib = _library()
    with torch.cuda.device(stream.device):
        err = lib.svdt_panel_gemm(pa, pa2 or pa, a_si, a_sk, a_split, *b, *c, M, N, K,
                                  splits, alpha, beta, stream.cuda_stream)
    _build.raise_on_error(err, "panel_gemm")


def _launch_sum(stream, parts, splits, count, out, split, out2):
    """The sum of the ``splits`` slices of ``count`` floats at ``parts``,
    in order, on ``stream``: its first ``split`` floats at ``out``, the
    rest at ``out2``."""
    lib = _library()
    with torch.cuda.device(stream.device):
        err = lib.svdt_panel_sum(parts, splits, count, out, split, out2, stream.cuda_stream)
    _build.raise_on_error(err, "panel_sum")


def _launch(Pt, r_off, plan, out=None):
    """One launch of the kernel on ``Pt`` under ``plan``: ``(Rt, Vt, Tt)``,
    into ``out`` where given (row-contiguous views; ``Tt`` a block of a
    larger T, its row stride passed on); raises if the card cannot hold
    the cluster or the launch fails."""
    b, m = Pt.shape
    if out is None:
        out = (torch.empty_like(Pt), torch.empty_like(Pt),
               torch.empty((b, b), dtype=Pt.dtype, device=Pt.device))
    Rt, Vt, Tt = out
    # 16-byte loads into the slab need rows of whole quads: a row stride
    # = groups (mod 32), groups >= 4 (b <= 256)
    vec = int(m % 4 == 0 and Pt.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(Pt.device):
        _check_resident(lib, plan)
        err = lib.svdt_panel_qr(
            Pt.data_ptr(), Rt.data_ptr(), Vt.data_ptr(), Tt.data_ptr(),
            b, m, r_off, plan.ctas, plan.width, plan.smem_cols, plan.ld,
            plan.tcols, plan.tld, plan.groups, vec, plan.smem, Tt.stride(0),
            _build.stream_of(Pt),
        )
    _build.raise_on_error(err, "panel_qr")
    return Rt, Vt, Tt


def _auto_segments(n, b):
    """Trailing-update segment count: more segments the more panels there
    are (the sub-block shrinks per segment)."""
    return max(4, min(12, (n // b) // 8))


def _fused_panel_pair_step(b, S, c):
    """One QR+LQ panel pair at column ``c`` of ``S`` with the fused two-sided
    trailing update (twin of the reference's ``_fused_panel_pair_step``):

        W  = V^T S;   C1 = T^T W
        Sl = S[c:c+b, :] - Vr C1        (the LQ panel's input rows)
        factor LQ panel -> V2, T2
        Y  = S V2^T;  AV = Y - V (C1 V2^T);  Z = AV T2^T
        S -= [V | Z] @ [[C1], [V2]]     (one K=2b GEMM)

    ``S`` is updated in place (it is a view of the Stage I matrix, so no
    copy of the trailing matrix is made).  Returns ``(S, (Vt, Tt, Vt2,
    Tt2))``: the pair's QR and LQ block reflectors as the kernel gives them.
    """
    Pt = S[:, c : c + b].T.contiguous()
    Rt, Vt, Tt = panel_qr(Pt, c)
    W = pdot(Vt, S)  # (b, m)
    C1 = pdot(Tt, W)  # (b, m); Tt = T^T
    # LQ panel input rows [c, c+b) of the left-updated S; its panel-block
    # columns [c, c+b) carry the exact R.
    Sl = S[c : c + b, :] - pdot(Vt[:, c : c + b].T, C1)
    Sl[:, c : c + b] = Rt[:, c : c + b].T
    Rt2, Vt2, Tt2 = panel_qr(Sl, c + b)
    Y = pdot(S, Vt2.T)  # (m, b); pre-update S
    D = pdot(C1, Vt2.T)  # (b, b)
    AV = Y - pdot(Vt.T, D)  # == (S - V C1) V2^T
    Z = pdot(AV, Tt2.T)  # (m, b)
    U2 = torch.cat([Vt.T, Z], dim=1)  # (m, 2b)
    C2 = torch.cat([C1, Vt2], dim=0)  # (2b, m)
    S -= pdot(U2, C2)
    S[:, c : c + b] = Rt.T
    S[c : c + b, :] = Rt2
    return S, (Vt, Tt, Vt2, Tt2)


def _stage1_fused(A, b, segments, record):
    """The fused Stage I loop; with ``record`` also the panel records."""
    _check_stage1(A, b, "dense_to_band_fused")
    n = A.shape[0]
    # every pair updates a view of this copy in place
    A = A.clone(memory_format=torch.contiguous_format)
    if record:
        p = n // b
        Vq, Vl = A.new_zeros((2, p, b, n))
        Tq, Tl = A.new_zeros((2, p, b, b))
    for s0, c in stage1_pairs(n, b, segments):
        _, recs = _fused_panel_pair_step(b, A[s0:, s0:], c)
        if record:
            # A reflector of this segment pivots at or past s0, so it is
            # zero above s0: embed the (b, n - s0) rows at column s0.
            # Identity reflectors (tau 0) are recorded as zero rows.
            i = (s0 + c) // b
            for V, T, (Vt, Tt) in ((Vq, Tq, recs[:2]), (Vl, Tl, recs[2:])):
                live = torch.diagonal(Tt) != 0
                V[i, :, s0:] = torch.where(live[:, None], Vt, 0.0)
                T[i] = Tt
    return (A, Vq, Tq, Vl, Tl) if record else A


def dense_to_band_fused(A, band=128, segments=None):
    """Stage I through the panel kernel (twin of ``dense_to_band_pallas``):
    reduce square ``A`` to upper-band form with fused panel pairs, the
    trailing updates restricted to ``A[s0:, s0:]`` per segment.
    ``segments=None`` picks :func:`_auto_segments`.  Returns a new tensor.
    """
    return _stage1_fused(A, int(band), segments, record=False)


def dense_to_band_rec_fused(A, band=128, segments=None):
    """Stage I through the panel kernel, recording the panel block
    reflectors (twin of ``dense_to_band_rec_pallas``).  Returns ``(Ab, Vq,
    Tq, Vl, Tl)`` under the contract of ``models.two_stage.
    dense_to_band_rec``: ``Vq[k] = V_k^T`` (b, n), ``Tq[k] = T_k^T``, QR
    then LQ per panel.  The segmented trailing update is kept (see
    :func:`dense_to_band_fused`).
    """
    return _stage1_fused(A, int(band), segments, record=True)


def dense_to_band_uv_fused(A, band=128):
    """Stage I through the panel kernel accumulating the orthogonal factors
    (twin of ``dense_to_band_uv_pallas``): returns ``(Ab, U1, V1)`` with
    ``A = U1 @ Ab @ V1^T``.  Full width, no segments: every step is
    :func:`_fused_panel_pair_step` on the whole matrix, then ``U1 <- U1 -
    ((U1 Vt^T) Tt^T) Vt`` and ``V1 <- V1 - ((V1 Vt2^T) Tt2^T) Vt2`` on the
    kernel's transposed outputs.  ``Ab`` is bit-equal to
    :func:`dense_to_band_fused` with ``segments=1``.
    """
    b = int(band)
    _check_stage1(A, b, "dense_to_band_uv_fused")
    n = A.shape[0]
    A = A.clone(memory_format=torch.contiguous_format)
    U1 = torch.eye(n, dtype=A.dtype, device=A.device)
    V1 = U1.clone()
    for k in range(n // b):
        _, (Vt, Tt, Vt2, Tt2) = _fused_panel_pair_step(b, A, k * b)
        U1 = U1 - pdot(pdot(pdot(U1, Vt.T), Tt.T), Vt)
        V1 = V1 - pdot(pdot(pdot(V1, Vt2.T), Tt2.T), Vt2)
    return A, U1, V1
