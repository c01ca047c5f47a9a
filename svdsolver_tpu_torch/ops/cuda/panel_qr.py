"""Kernel 1: compact-WY panel QR (``csrc/panel_qr.cu``), and the Stage I
loop around it.

Twin of ``svdsolver_tpu/ops/pallas/panel_qr.py``: the panel factorization
runs in one launch on the card, one thread-block cluster whose CTAs each
hold a slab of the panel's columns in shared memory (:func:`cluster_plan`),
and the trailing updates are plain ``torch.matmul`` GEMMs (fp32, TF32 off),
as they are XLA GEMMs outside the kernel in the reference.  On a CPU tensor
:func:`panel_qr` runs :func:`panel_qr_plain`, the same column loop in
PyTorch.
"""

import ctypes
from typing import NamedTuple

import torch

from svdsolver_tpu_torch.models.two_stage import _check_stage1, segment_bounds
from svdsolver_tpu_torch.ops.cuda import _build
from svdsolver_tpu_torch.ops.householder import householder_vector
from svdsolver_tpu_torch.ops.precision import pdot

launches = 0  # kernel launches by panel_qr since the last reset

_ENTRIES = {
    "svdt_panel_qr": [_build.VOIDP] * 4 + [_build.INT] * 12 + [_build.VOIDP],
    "svdt_panel_qr_clusters": [_build.INT] * 4 + [_build.VOIDP],
}
THREADS = 1024  # a CTA of the kernel
MAX_CLUSTER = 16  # CTAs a cluster at most (non-portable above 8)
NARROW_BAND = 256  # b <= THREADS / 4: 4 lanes a row or more, T in shared memory
CTA_TARGET = 64 * 1024  # slab bytes a CTA aims at: C grows until it is met
_resident = {}  # (ctas, smem, spill, tdev) -> clusters that fit on the card


class ClusterPlan(NamedTuple):
    """How the kernel cuts a (b, m) panel: ``ctas`` CTAs of one cluster,
    ``width`` columns each, ``smem_cols`` of them in shared memory with row
    stride ``ld`` (the rest, if any, in device memory: the large-panel
    route), ``tcols`` columns of T each (row stride ``tld`` in shared
    memory; ``tld = 0``: in device memory, the CTA's own columns of the
    output T), ``groups`` lanes a row in the dot and update passes,
    ``smem`` bytes a CTA."""

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

    @property
    def tdev(self):
        return self.tld == 0


def _cdiv(a, b):
    return -(-a // b)


def cluster_plan(b, m, ctas=None):
    """The cluster launch of the panel kernel for a (b, m) panel.

    ``ctas=None`` takes the fewest CTAs (a power of two, at most 16) whose
    slabs are at most ``CTA_TARGET`` bytes, else 16.  Each CTA's slab of
    ``width = ceil(m / ctas)`` columns (a multiple of 4) goes to shared
    memory with a row stride equal to ``groups`` mod 32 (the warp's rows on
    distinct banks); where it does not fit ``_build.MAX_SMEM`` beside v, the
    CTA's T columns and the exchange arrays, the columns past what fits stay
    in device memory, in the CTA's own columns of ``Rt`` (the large-panel
    route: at b = 128 every m above 6,784, e.g. 1,048 of 1,440 columns a
    CTA at m = 23,040).  ``groups`` is the largest power of two up to 32
    with ``groups * b <= THREADS``, at least 1: 4 or more lanes a row up to
    b = 256, 2 up to 512, 1 past it (a thread then loops over rows).  Past
    b = 256 the T columns stay in device memory (``tld = 0``: the CTA's own
    columns of the output), and ``ctas=None`` halves the cluster while the
    exchanged dots (``ctas * b`` floats) would take more than half of the
    shared memory; the plans of ``b <= 256`` are unchanged by either.
    Raises ``ValueError`` for ``b < 1`` or ``m < 1``, and for a panel so
    long or wide that v and the exchange arrays leave the slab no shared
    memory (m past ~860,000 at b = 128; b past ~19,000 at m = b).
    """
    b, m = int(b), int(m)
    if b < 1:
        raise ValueError(f"panel width b={b} must be >= 1")
    if m < 1:
        raise ValueError(f"panel length m={m} must be >= 1")
    if ctas is None:
        C = next((c for c in (1, 2, 4, 8) if 4 * b * _cdiv(m, c) <= CTA_TARGET), MAX_CLUSTER)
        while C > 1 and 4 * C * b > _build.MAX_SMEM // 2:
            C //= 2
    else:
        C = int(ctas)
        if not 1 <= C <= MAX_CLUSTER:
            raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} CTAs, not {ctas}")
    W = 4 * _cdiv(_cdiv(m, C), 4)
    G = 1 << (max(1, min(32, THREADS // b)).bit_length() - 1)
    tc = _cdiv(b, C)
    tld = 0 if b > NARROW_BAND else (tc + 1 if tc % 2 == 0 else tc)
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
    key = (plan.ctas, plan.smem, plan.spill, plan.tdev)
    if key not in _resident:
        got = ctypes.c_int(0)
        err = lib.svdt_panel_qr_clusters(plan.ctas, plan.smem, int(plan.spill),
                                         int(plan.tdev), ctypes.addressof(got))
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


def panel_qr(Pt, r_off, _cluster=None):
    """Householder QR of the transposed panel ``Pt`` (b, m), pivots at
    ``r_off + j``; returns ``(Rt, Vt, Tt)`` as :func:`panel_qr_plain`.

    A CUDA tensor must be contiguous float32 and launches the kernel as one
    cluster under :func:`cluster_plan` (``_cluster`` fixes its CTA count),
    at any width ``b`` the plan holds; a shape past the plan's limits, or a
    cluster the card cannot hold, raises ``ValueError``.  A CPU tensor runs
    the plain version.  Pivots at or past ``m`` give identity reflectors
    (``tau = 0``, ``v = 0``).
    """
    global launches
    r_off = int(r_off)
    if r_off < 0:
        raise ValueError(f"r_off must be >= 0, got {r_off}")
    if not _build.check_input(Pt, "Pt", 2):
        return panel_qr_plain(Pt, r_off)
    b, m = Pt.shape
    out = _launch(Pt, r_off, cluster_plan(b, m, _cluster))
    launches += 1
    return out


def _launch(Pt, r_off, plan):
    """One launch of the kernel on ``Pt`` under ``plan``: ``(Rt, Vt, Tt)``;
    raises if the card cannot hold the cluster or the launch fails."""
    b, m = Pt.shape
    Rt = torch.empty_like(Pt)
    Vt = torch.empty_like(Pt)
    Tt = torch.empty((b, b), dtype=Pt.dtype, device=Pt.device)
    # 16-byte loads into the slab need rows of whole quads: a row stride
    # = groups (mod 32) is one where groups >= 4 (b <= 256)
    vec = int(m % 4 == 0 and Pt.data_ptr() % 16 == 0 and plan.groups >= 4)
    lib = _build.load("panel_qr", _ENTRIES)
    with torch.cuda.device(Pt.device):
        _check_resident(lib, plan)
        err = lib.svdt_panel_qr(
            Pt.data_ptr(), Rt.data_ptr(), Vt.data_ptr(), Tt.data_ptr(),
            b, m, r_off, plan.ctas, plan.width, plan.smem_cols, plan.ld,
            plan.tcols, plan.tld, plan.groups, vec, plan.smem,
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
    if segments is None:
        segments = _auto_segments(n, b)
    # every pair updates a view of this copy in place
    A = A.clone(memory_format=torch.contiguous_format)
    if record:
        p = n // b
        Vq, Vl = A.new_zeros((2, p, b, n))
        Tq, Tl = A.new_zeros((2, p, b, b))
    bounds = segment_bounds(n // b, segments)
    for s in range(len(bounds) - 1):
        k0, k1 = bounds[s], bounds[s + 1]
        s0 = k0 * b
        sub = A[s0:, s0:]
        for k in range(k1 - k0):
            _, recs = _fused_panel_pair_step(b, sub, k * b)
            if record:
                # A reflector of this segment pivots at or past s0, so it is
                # zero above s0: embed the (b, n - s0) rows at column s0.
                # Identity reflectors (tau 0) are recorded as zero rows.
                for V, T, (Vt, Tt) in ((Vq, Tq, recs[:2]), (Vl, Tl, recs[2:])):
                    live = torch.diagonal(Tt) != 0
                    V[k0 + k, :, s0:] = torch.where(live[:, None], Vt, 0.0)
                    T[k0 + k] = Tt
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
