"""Sharded multi-rank SVD (twin of ``svdsolver_tpu/parallel/distributed.py``).

Two mesh axes, as in the JAX package:

* ``dp`` (data parallel): independent matrices of a batch; no communication
  until the results are gathered.
* ``tp`` (tensor parallel): the columns of one matrix split over the ranks,
  so the Stage I trailing updates run on column blocks with a collective
  or two a panel (:func:`dense_to_band_shardmap`).

The JAX package is single-controller (``shard_map`` bodies over a device
mesh); the port is SPMD on ``torch.distributed`` (``parallel/mesh.py``):
every rank calls an entry with the same global input, takes its own block,
and gets the global result back: sigma replicated, U and V gathered.  On a
float32 CUDA rank the local stages run the port's kernels where the
single-card path runs them (``models.svd.use_kernels``): K1 for every
panel of the sharded Stage I, the routed chase and the bisection kernel,
the recording chase and the TGK solve for the vectors, and the superstep
kernel for the pipelined chase; elsewhere their plain versions.  The GEMMs
are ``torch.matmul`` at the package's precision (``ops/precision.pdot``).
"""

from typing import NamedTuple

import numpy as np
import torch

from svdsolver_tpu_torch.models import two_stage, vectors
from svdsolver_tpu_torch.models.svd import (
    diagonalizer,
    routed_chase_accum,
    two_stage_fns,
    use_kernels,
)
from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr
from svdsolver_tpu_torch.ops.precision import pdot
from svdsolver_tpu_torch.parallel.mesh import spawn


def _tensor(A, mesh):
    """``A`` (a tensor, or a numpy array or array-like, dtype kept) on the
    rank's device."""
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A))
    return A.to(mesh.device)


def _check_shape(n, b, tp):
    if n % b != 0 or n % tp != 0:
        raise ValueError(f"n={n} must divide by band={b} and tp={tp}")


def _panel_factor(Pt, r_off):
    """Householder QR of the transposed panel ``Pt`` (b, n), pivots at
    ``r_off + j``: ``(Rt, Vt, Tt)``.  K1 on a float32 CUDA tensor,
    ``panel_qr_plain`` elsewhere."""
    if use_kernels(Pt):
        return panel_qr.panel_qr(Pt.contiguous(), r_off)
    return panel_qr.panel_qr_plain(Pt, r_off)


def _factor_all(Pts, r_off):
    """:func:`_panel_factor` of each panel of the batch ``Pts`` (B, b, n),
    stacked."""
    outs = [_panel_factor(P, r_off) for P in Pts]
    return tuple(torch.stack(x) for x in zip(*outs))


def _stage1_local(mesh, A_loc, n, b, uv=False):
    """One rank's Stage I on the column blocks ``A_loc`` (B, n, n/tp) of a
    batch: the panel-sweep schedule of ``models/two_stage.dense_to_band``
    with the collectives the JAX body places (its ``_stage1_local``).  Per
    panel step:

    * QR: the owner's panel columns broadcast by a ``psum`` of masked local
      contributions (the panel transposed, (b, n)); every rank factors it
      (K1 or its plain version), updates its columns (``W = V^T A_loc``,
      no communication) and the owner writes R back;
    * LQ: the (b, n) row slab assembled by an ``all_gather``, factored as
      it is (its rows are the panel's columns), the right update through
      a ``psum`` of ``A_loc V_loc`` (n, b), the factored rows written back.

    With ``uv`` the factors accumulate as column blocks too, one ``psum``
    of (n, b) a factor a panel (``U1 V_loc``, ``V1 Vl_loc``).  Returns
    ``A_loc``, or ``(A_loc, U1_loc, V1_loc)``."""
    tp = mesh.shape["tp"]
    n_loc = n // tp
    col0 = mesh.axis_index("tp") * n_loc
    B = A_loc.shape[0]
    A_loc = A_loc.clone()
    own = slice(col0, col0 + n_loc)  # this rank's global columns
    if uv:
        gcol = torch.arange(n_loc, device=A_loc.device) + col0
        eye = (torch.arange(n, device=A_loc.device)[:, None] == gcol[None, :]).to(A_loc.dtype)
        U1 = eye.expand(B, n, n_loc).clone()
        V1 = U1.clone()
    for k in range(n // b):
        c = k * b
        lo, hi = max(c, col0), min(c + b, col0 + n_loc)  # panel columns this rank owns
        part = A_loc.new_zeros((B, b, n))
        if lo < hi:
            part[:, lo - c : hi - c] = A_loc[:, :, lo - col0 : hi - col0].transpose(1, 2)
        Rt, Vt, Tt = _factor_all(mesh.psum(part, "tp"), c)
        W = pdot(Vt, A_loc)  # V^T A_loc
        A_loc = A_loc - pdot(Vt.transpose(1, 2), pdot(Tt, W))
        if lo < hi:
            A_loc[:, :, lo - col0 : hi - col0] = Rt[:, lo - c : hi - c].transpose(1, 2)
        if uv:
            V_loc = Vt[:, :, own].transpose(1, 2)  # (B, n_loc, b)
            UV = mesh.psum(pdot(U1, V_loc), "tp")
            U1 = U1 - pdot(pdot(UV, Tt.transpose(1, 2)), V_loc.transpose(1, 2))
        slab = mesh.all_gather(A_loc[:, c : c + b, :], "tp", dim=2)  # (B, b, n)
        Rl, Vl, Tl = _factor_all(slab, c + b)
        Vl_loc = Vl[:, :, own].transpose(1, 2)  # (B, n_loc, b)
        AV = mesh.psum(pdot(A_loc, Vl_loc), "tp")  # (B, n, b)
        A_loc = A_loc - pdot(pdot(AV, Tl.transpose(1, 2)), Vl_loc.transpose(1, 2))
        A_loc[:, c : c + b, :] = Rl[:, :, own]
        if uv:
            V1V = mesh.psum(pdot(V1, Vl_loc), "tp")
            V1 = V1 - pdot(pdot(V1V, Tl.transpose(1, 2)), Vl_loc.transpose(1, 2))
    return (A_loc, U1, V1) if uv else A_loc


def _band_index(n, b, col0, n_loc, device):
    """Rows ``col0 + j - q`` of the band entries ``(q, j)``, ``q <= b``, of
    local columns ``j``, and where they lie inside the matrix."""
    rows = (torch.arange(n_loc, device=device)[None, :] + col0
            - torch.arange(b + 1, device=device)[:, None])
    return rows, rows >= 0


def _gather_band(mesh, A_loc, n, b):
    """The upper band of the column blocks ``A_loc`` (B, n, n/tp) as (B, n,
    n) on every rank of the ``tp`` axis.  Only the band moves: each rank
    packs its ``b + 1`` diagonals, (B, b + 1, n/tp), one ``all_gather``
    assembles (B, b + 1, n).  Stage I leaves exact zeros off the band, so
    the matrix is the one the JAX package's gather of whole blocks gives."""
    B, _, n_loc = A_loc.shape
    rows, inside = _band_index(n, b, mesh.axis_index("tp") * n_loc, n_loc, A_loc.device)
    packed = torch.gather(A_loc, 1, rows.clamp(min=0).expand(B, b + 1, n_loc))
    packed = torch.where(inside, packed, torch.zeros((), dtype=A_loc.dtype,
                                                     device=A_loc.device))
    full = mesh.all_gather(packed, "tp", dim=2)  # (B, b + 1, n)
    rows, inside = _band_index(n, b, 0, n, A_loc.device)
    cols = torch.arange(n, device=A_loc.device).expand(b + 1, n)
    Ab = A_loc.new_zeros((B, n, n))
    Ab[:, rows[inside], cols[inside]] = full[:, inside]
    return Ab


def _column_block(A, mesh):
    """This rank's columns of the global (n, n) ``A``, on its device."""
    n = A.shape[-1]
    n_loc = n // mesh.shape["tp"]
    col0 = mesh.axis_index("tp") * n_loc
    return A[..., col0 : col0 + n_loc].to(mesh.device).contiguous()


def dense_to_band_shardmap(A, mesh, band=32):
    """Stage I with explicit collectives over the ``tp`` axis (twin of the
    JAX ``dense_to_band_shardmap``): each rank holds an (n, n/tp) column
    block and runs :func:`_stage1_local` on it, three (n, b)-sized
    collectives a panel step (the panel's ``psum``, the LQ slab's
    ``all_gather``, the ``psum`` of ``A V``).  SPMD: every rank passes the
    global ``A`` (n, n) and gets the global band matrix back (the band
    gathered by :func:`_gather_band`).  Raises ``ValueError`` unless ``n``
    divides by ``band`` and by ``tp``."""
    A = _tensor(A, mesh)
    n = A.shape[0]
    b = int(band)
    _check_shape(n, b, mesh.shape["tp"])
    Ab_loc = _stage1_local(mesh, _column_block(A, mesh)[None], n, b)
    return _gather_band(mesh, Ab_loc, n, b)[0]


def dense_to_band_sharded(A, mesh, band=32):
    """Stage I of one matrix over the mesh's ``tp`` axis.  The JAX package
    annotates a row sharding and lets XLA place the collectives; torch has
    no sharding propagation, so this runs the explicit-collective body of
    :func:`dense_to_band_shardmap` (same contract)."""
    return dense_to_band_shardmap(A, mesh, band=band)


def _bisect(d, e):
    """The bisection of ``svdvals``' ``tpu2`` route (``models.svd.
    diagonalizer``): its kernel on float32 CUDA (d, e), the plain bisection
    elsewhere."""
    return diagonalizer("tpu2", "bisect", d)(d, e)


def _svdvals_of_band(Ab, b):
    """Stage II and the bisection of one replicated band, as ``svdvals``'
    ``tpu2`` route runs them (``models.svd.two_stage_fns``): the routed
    chase kernel on a float32 CUDA tensor, the plain chase elsewhere."""
    chase = two_stage_fns("tpu2", Ab)[1]
    return _bisect(*chase(Ab, band=b))


def svdvals_batch_sharded(As, mesh, band=32):
    """Singular values of a batch of square matrices over the mesh (twin of
    the JAX entry): ``As`` (batch, n, n); the batch splits over ``dp`` and
    each matrix's columns over ``tp``.  Stage I runs with explicit
    collectives (:func:`_stage1_local`, the batch in the same collectives),
    the bands are gathered once (their ``b + 1`` diagonals only: no
    collective moves more than an n (b + 1) block a matrix), then Stage II
    and the bisection run on each rank of the dp group.  SPMD: every rank
    passes the global batch and gets (batch, n) back (gathered over
    ``dp``).  Raises ``ValueError`` unless ``n`` divides by ``band`` and
    ``tp`` and ``batch`` by ``dp``."""
    if not isinstance(As, torch.Tensor):
        As = torch.as_tensor(np.asarray(As))
    batch, n, _ = As.shape
    b = int(band)
    dp = mesh.shape["dp"]
    _check_shape(n, b, mesh.shape["tp"])
    if batch % dp != 0:
        raise ValueError(f"batch={batch} must divide by dp={dp}")
    bl = batch // dp
    i = mesh.axis_index("dp")
    A_loc = _column_block(As[i * bl : (i + 1) * bl], mesh)
    Ab = _gather_band(mesh, _stage1_local(mesh, A_loc, n, b), n, b)
    sig = torch.stack([_svdvals_of_band(M, b)[:n] for M in Ab])
    return mesh.all_gather(sig, "dp", dim=0)


def svdvals_batch_sharded_gspmd(As, mesh, band=32):
    """The JAX package's GSPMD variant of the batch path (shardings
    annotated, XLA places the collectives, and measurably replicates A at
    some program points).  torch has no sharding propagation, so this runs
    the explicit-collective body of :func:`svdvals_batch_sharded`: same
    contract and the same sigma."""
    return svdvals_batch_sharded(As, mesh, band=band)


class Pipeline(NamedTuple):
    """The geometry of the pipelined chase (:func:`pipeline_geometry`)."""

    n: int
    b: int
    tp: int
    LG: int
    U: int
    m: int
    Np: int
    NG: int
    T: int
    s_chase: int


def pipeline_geometry(n, band, tp, sweeps_per_group=None):
    """The JAX body's geometry for ``tp`` ranks: ``m`` rows a rank, ``LG``
    sweeps a group (bounded so the staggered frontiers and one window fit a
    rank's rows, at most 64, unless ``sweeps_per_group`` is given, which
    may inflate ``m``), the upper halo ``U = 3 b (LG - 1)``, ``Np = tp m``
    padded columns, ``NG`` groups, ``T = 2 NG + tp - 1`` supersteps and
    ``s_chase`` chase slots a sweep on one rank."""
    b = int(band)
    w = b + 1
    ww = 2 * b
    m_base = -(-(n + 2 * w + 2) // tp)
    if sweeps_per_group is None:
        LG = max(1, min((m_base - ww) // (3 * b) + 1, 64))
    else:
        LG = max(1, int(sweeps_per_group))
    U = 3 * b * (LG - 1)
    m = max(m_base, U + ww)
    NG = -(-(n - 1) // LG)
    return Pipeline(n, b, tp, LG, U, m, tp * m, NG, 2 * NG + tp - 1,
                    (m + U + 2 * w + 2) // b + 2)


def active(t, rank, NG):
    """Whether ``rank`` runs a group at superstep ``t``: group ``g < NG``
    runs on rank ``d`` at superstep ``2 g + d``, so neighbours never run
    together."""
    q = t - rank
    return q >= 0 and q % 2 == 0 and q // 2 < NG


def local_buffer(A, mesh, geo):
    """This rank's buffer of the pipelined chase of the band ``A`` (n, n)
    under the geometry ``geo``: ``U + m + 4 b`` rows of ``Np`` columns, its
    own ``m`` padded rows at row ``U``, the halos (``U`` rows above, ``2 b``
    below) from the neighbours' own rows by the JAX body's seeding
    ``ppermute``s, zero past the band and in the dummy zone."""
    n, b, tp, U, m, Np = geo.n, geo.b, geo.tp, geo.U, geo.m, geo.Np
    ww = 2 * b
    R0 = mesh.axis_index("tp") * m
    own = A.new_zeros((m, Np))
    rows = max(0, min(m, n - R0))
    own[:rows, :n] = A[R0 : R0 + rows]
    L = A.new_zeros((U + m + 2 * ww, Np))
    L[U : U + m] = own
    if tp > 1:
        L[U + m : U + m + ww] = mesh.ppermute(own[:ww], "tp",
                                              [(i + 1, i) for i in range(tp - 1)])
        if U > 0:
            L[:U] = mesh.ppermute(own[m - U :], "tp", [(i, i + 1) for i in range(tp - 1)])
    return L


def band_to_bidiagonal_pipelined(A, mesh, band=32, sweeps_per_group=None):
    """Stage II over row-sharded ranks (twin of the JAX entry): a pipelined
    bulge chase.  Returns ``(d, e)`` of a valid bidiagonal reduction of the
    band ``A`` whose spectrum matches the sequential chase's; the entries
    are not the sequential chase's where ranks interleave sweeps (the
    staggered frontiers reorder the eliminations), and are on one rank.

    Geometry, frontiers and exchange are the JAX body's
    (:func:`pipeline_geometry`): rank ``d`` owns padded rows ``[d m, (d +
    1) m)`` at full width ``Np`` with an upper halo of ``U`` rows and a
    lower one of ``2 band`` (then ``2 band`` rows of dummy zone); within a
    pass the ``l``-th sweep of a group stops at row ``(d + 1) m - 3 band
    l``; group ``g`` runs on rank ``d`` at superstep ``2 g + d``; after
    each superstep the boundary blocks of ``U + 2 band`` full-width rows
    move to the neighbours by ``ppermute``.  A rank runs its pass only at
    the supersteps it is active in (the JAX body's masked passes elsewhere
    aim every window at the dummy zone: no-ops), by the superstep kernel on
    a float32 CUDA rank and ``two_stage.chase_superstep`` elsewhere.  A
    block goes only from a rank that was active in the superstep (the
    receiver keeps its own rows otherwise, as the JAX body selects).

    SPMD: every rank passes the global band; ``(d, e)`` are gathered from
    the owners' rows onto every rank.  With ``tp = 1`` one pass runs every
    sweep whole and in order, so ``(d, e)`` are the sequential chase's
    (bit-equal to ``two_stage.band_to_bidiagonal`` on the CPU and to the
    sequential L2 kernel, ``svdt_band_chase``, on the card).
    """
    A = _tensor(A, mesh)
    n = A.shape[0]
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    tp = mesh.shape["tp"]
    geo = pipeline_geometry(n, band, tp, sweeps_per_group)
    b, LG, U, m, Np = geo.b, geo.LG, geo.U, geo.m, geo.Np
    ww = 2 * b
    rank = mesh.axis_index("tp")
    R0 = rank * m
    last = rank == tp - 1
    L = local_buffer(A, mesh, geo)
    step = band_chase.superstep if use_kernels(L) else band_chase.superstep_plain
    blk = U + ww
    for t in range(geo.T):
        act = [active(t, r, geo.NG) for r in range(tp)]
        if act[rank]:
            step(L, n, b, ((t - rank) // 2) * LG, LG, R0, U, m, last, geo.s_chase)
        if tp == 1:
            continue
        down = mesh.ppermute(L[m : m + blk], "tp", [(i, i + 1) for i in range(tp - 1) if act[i]])
        up = mesh.ppermute(L[:blk], "tp", [(i + 1, i) for i in range(tp - 1) if act[i + 1]])
        if rank >= 1 and act[rank - 1]:
            L[:blk] = down
        if rank <= tp - 2 and act[rank + 1]:
            L[m : m + blk] = up
    idx = torch.arange(m, device=L.device)
    cols = torch.clamp(R0 + idx, max=Np - 1)
    d_loc = L[U + idx, cols]
    e_loc = L[U + idx, torch.clamp(cols + 1, max=Np - 1)]
    d_full = mesh.all_gather(d_loc, "tp")
    e_full = mesh.all_gather(e_loc, "tp")
    return d_full[:n], e_full[: n - 1]


def svdvals_sharded(A, mesh, band=32, stage2="local"):
    """Singular values of one square matrix over the mesh (twin of the JAX
    entry).  Stage I runs over ``tp`` with explicit collectives
    (:func:`dense_to_band_shardmap`), the band is gathered once, and Stage
    II and the bisection run on every rank (the routed chase and the
    bisection kernel on a float32 CUDA rank).  ``stage2="pipelined"`` runs
    Stage II over the ranks instead (:func:`band_to_bidiagonal_pipelined`).
    SPMD: every rank passes the global ``A`` and gets all of sigma back."""
    if stage2 not in ("local", "pipelined"):
        raise ValueError(f"stage2 must be 'local' or 'pipelined', got {stage2!r}")
    n = np.shape(A)[0]
    b = int(band)
    Ab = dense_to_band_shardmap(A, mesh, band=b)
    if stage2 == "pipelined":
        d, e = band_to_bidiagonal_pipelined(Ab, mesh, band=b)
        return _bisect(d, e)[:n]
    return _svdvals_of_band(Ab, b)[:n]


def svd_sharded(A, mesh, band=32):
    """Full SVD of one square matrix over the mesh (twin of the JAX entry):
    ``(U, s, Vh)`` with ``A ~= U @ diag(s) @ Vh``.

    Stage I with U1 and V1 accumulated as column blocks over ``tp``
    (:func:`_stage1_local`, ``uv=True``); the band gathered once; the
    recording chase, the bisection and ``models.vectors.tgk_vectors`` on
    every rank, routed as ``models.vectors.svd_two_stage`` routes them
    (``models.svd.routed_chase_accum``, K2 and the TGK solve on a float32
    CUDA rank); the chase back-transforms on the rank's column blocks of
    U_b and V_b (``_apply_chase_reflectors_wy_pair``: row operators, no
    communication); then ``U = U1 (L U_b)`` as the JAX body forms it: the
    blocks all-gathered, this rank's rows contracted with ``U1``'s columns,
    and the partial products summed by one ``psum``.  The JAX body sums
    them by a ``psum_scatter`` that leaves U and V sharded; with the result
    replicated on every rank, that ``psum_scatter`` and an ``all_gather``
    amount to this ``psum``.  SPMD: every rank passes the global ``A``; sigma is
    replicated and U, V are on every rank.  Raises ``ValueError`` unless
    ``n`` divides by ``band`` and ``tp``."""
    A = _tensor(A, mesh)
    n = A.shape[0]
    b = int(band)
    tp = mesh.shape["tp"]
    _check_shape(n, b, tp)
    Ab_loc, U1, V1 = _stage1_local(mesh, _column_block(A, mesh)[None], n, b, uv=True)
    Ab = _gather_band(mesh, Ab_loc, n, b)[0]
    chase = routed_chase_accum if use_kernels(Ab) else two_stage.band_to_bidiagonal_accum
    d, e, VL, TL, VR, TR = chase(Ab, band=b)
    s = _bisect(d, e)
    U_b, V_b = vectors.tgk_vectors(d, e, s)
    n_loc = n // tp
    rows = slice(mesh.axis_index("tp") * n_loc, (mesh.axis_index("tp") + 1) * n_loc)
    LU, RV = vectors._apply_chase_reflectors_wy_pair(VL, TL, VR, TR, U_b[:, rows],
                                                     V_b[:, rows], b)
    U_part = pdot(U1[0], mesh.all_gather(LU, "tp", dim=1)[rows])
    V_part = pdot(V1[0], mesh.all_gather(RV, "tp", dim=1)[rows])
    U = mesh.psum(U_part, "tp")
    V = mesh.psum(V_part, "tp")
    return U, s[:n], V.T


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _dryrun_rank(mesh):
    """The steps of :func:`dryrun` on one rank; returns its report line."""
    import sys

    from svdsolver_tpu_torch.parallel.jacobi import svd_jacobi_sharded

    _check("jax" not in sys.modules, "a rank of the port imported jax")
    batch = 2 * mesh.shape["dp"]
    n, band = 32, 8
    rng = np.random.default_rng(0)
    A0 = rng.normal(size=(n, n)).astype(np.float32)
    s_ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    Ab = dense_to_band_shardmap(A0, mesh, band=band)
    s_band = np.linalg.svd(Ab.cpu().double().numpy(), compute_uv=False)
    _check(np.max(np.abs(s_band - s_ref)) / s_ref[0] < 1e-4, "shard_map stage I")
    sig1 = svdvals_sharded(A0, mesh, band=band).cpu().numpy()
    err1 = float(np.max(np.abs(sig1 - s_ref)) / s_ref[0])
    _check(err1 < 1e-4, f"svdvals_sharded mismatch vs LAPACK: {err1}")
    sig2 = svdvals_sharded(A0, mesh, band=band, stage2="pipelined").cpu().numpy()
    err2 = float(np.max(np.abs(sig2 - s_ref)) / s_ref[0])
    _check(err2 < 1e-4, f"pipelined stage-II mismatch vs LAPACK: {err2}")
    U, sv, Vh = (x.cpu().numpy() for x in svd_sharded(A0, mesh, band=band))
    errv = float(np.abs(U @ np.diag(sv) @ Vh - A0).max() / np.abs(A0).max())
    _check(errv < 1e-4, f"svd_sharded reconstruction: {errv}")
    if mesh.shape["tp"] >= 2:  # two column blocks a rank
        Uj, sj, Vhj = (x.cpu().numpy() for x in svd_jacobi_sharded(A0, mesh))
        errj = float(np.abs(Uj @ np.diag(sj) @ Vhj - A0).max() / np.abs(A0).max())
        _check(errj < 1e-3, f"svd_jacobi_sharded reconstruction: {errj}")
    As = rng.uniform(0.0, 5.0, (batch, n, n)).astype(np.float32)
    sig = svdvals_batch_sharded(As, mesh, band=band)
    _check(tuple(sig.shape) == (batch, n), f"shape {tuple(sig.shape)}")
    _check(bool(torch.isfinite(sig).all()), "non-finite singular values")
    ref = np.linalg.svd(As.astype(np.float64), compute_uv=False)
    err = float(np.max(np.abs(sig.cpu().numpy() - ref) / ref[:, :1]))
    _check(err < 1e-4, f"sharded svd mismatch vs LAPACK: {err}")
    return (f"dryrun_multichip OK: mesh={dict(mesh.shape)} batch={batch} n={n} "
            f"band={band} max_rel_err={err:.2e}")


def dryrun(n_devices, device=None):
    """Run one of every sharded step at tiny shapes on ``n_devices`` ranks
    (:func:`~svdsolver_tpu_torch.parallel.mesh.spawn`, the default mesh
    shape), with the JAX package's checks: Stage I's spectrum, the local
    and pipelined ``svdvals_sharded`` and ``svd_sharded`` against LAPACK,
    ``svd_jacobi_sharded`` where ``tp >= 2``, and the batch entry; n = 32,
    band = 8.  ``device="cpu"`` runs on the CPU, else the ranks share the
    card(s).  Raises if a check fails; prints rank 0's report."""
    print(spawn(_dryrun_rank, n_devices, device=device, timeout=300))


__all__ = [
    "band_to_bidiagonal_pipelined",
    "dense_to_band_shardmap",
    "dense_to_band_sharded",
    "dryrun",
    "svd_sharded",
    "svdvals_batch_sharded",
    "svdvals_batch_sharded_gspmd",
    "svdvals_sharded",
]
