"""Singular vectors: the full SVD (twin of a subset of
``svdsolver_tpu/models/vectors.py``).

* :func:`bidiagonal_svd`: singular values of the bidiagonal {d, e} by
  bisection, then vectors by inverse iteration on the Golub-Kahan
  tridiagonal, every shift lane at once (:func:`tgk_vectors`), with
  cluster re-orthogonalization and a Newton-Schulz polar polish.
* :func:`svd_two_stage`: the two-stage pipeline with reflector recording
  (Stage I panels, chase reflectors) and the back-transforms
  ``U = U1 (L Ub)``, ``V = V1 (R Vb)`` as GEMM walks over the records.
* :func:`bidiagonalize_blocked_uv`: the one-stage blocked reduction with
  the orthogonal factors accumulated per panel (``U <- U (I - V T
  V^T)``, ``T`` in closed form), the ``singlecore`` path of :func:`svd`.
* :func:`svd`, :func:`svds`, :func:`svd_batch`: the public entry points.

On float32 CUDA tensors the path runs four hand-written kernels: the panel
QR (Stage I), the recording chase (the wavefront kernel or the sequential
chase's staged TMA design, by
``band_chase_wave.wave_chase_accum_preferred``), the bisection and the TGK
solve.  The back-transforms and cluster orthogonalization are GEMMs,
batched Cholesky and triangular solves (``torch.matmul``,
``torch.linalg.cholesky_ex``, ``torch.linalg.solve_triangular``), full
float32 with TF32 off, as they are XLA ops outside any Pallas kernel in the
reference.  Any other input takes the plain PyTorch versions.

Host syncs: :func:`tgk_vectors` reads three flags (any cluster, any
near-zero cluster, any cluster wider than 64 columns) in one device-to-host
copy, where the reference takes ``lax.cond``; a call of :func:`svd` makes
that one sync and no other.
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.models.blocked import labrd_step, panel_buffers
from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.jacobi import svd_jacobi
from svdsolver_tpu_torch.models.svd import (
    _auto_block,
    _pad_to_multiple,
    as_batch,
    as_input,
    routed_chase_accum,
    use_kernels,
)
from svdsolver_tpu_torch.ops.chase_schedule import nc_of_static
from svdsolver_tpu_torch.ops.cuda import bisect, panel_qr, tridiag_solve
from svdsolver_tpu_torch.ops.precision import pdot

TW = 128  # tile width of the tiled cluster orthogonalization
_HALF = TW // 2  # clusters up to this width fit a tile of one of two covers


_PERTURB_TOL = 4  # eps sig_max: adjacent shifts closer than this are spread


def _perturbed_shifts(sig, smax, eps):
    """The inverse-iteration shifts of ``sig`` (sorted descending):
    dstein-style, the j-th value of a multiplet becomes
    ``sig * (1 + 4 eps j)``, so the lanes of a multiplet are amplified
    toward different split vectors.  A multiplet is a run of values within
    ``_PERTURB_TOL`` eps sig_max of their neighbours (the shifts' own
    resolution), not a whole 64-eps cluster as in the JAX package: counting
    positions over a cluster moves the shifts of a long chain of close
    values many spacings off (uniform n = 7680: the bulk is one cluster of
    7446 values, its last shift moved by 3.5e-3 relative, some ten
    spacings), the lanes collapse onto shared vectors and U loses its
    orthogonality (0.56 on the H100).  Exact multiplets spread as there."""
    k = sig.shape[0]
    dup = torch.abs(sig[1:] - sig[:-1]) <= _PERTURB_TOL * eps * smax
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=sig.device), ~dup])
    idx = torch.arange(k, device=sig.device)
    pic = idx - torch.cummax(torch.where(is_start, idx, 0), 0).values
    return sig * (1 + 4 * eps * pic.to(sig.dtype))


def _larft_closed_form(V, taus):
    """Forward compact-WY ``T`` from reflectors (batched over leading
    dims): ``T^{-1} = striu(V^T V) + diag(1/tau)``.  Columns with tau == 0
    must already be zero in ``V``."""
    b = taus.shape[-1]
    safe = torch.where(taus == 0, torch.ones_like(taus), taus)
    Tinv = torch.triu(pdot(V.transpose(-1, -2), V), 1) + torch.diag_embed(1.0 / safe)
    eye = torch.eye(b, dtype=V.dtype, device=V.device).expand_as(Tinv)
    return torch.linalg.solve_triangular(Tinv, eye, upper=True)


def bidiagonalize_blocked_uv(A, panel=32):
    """Blocked one-stage bidiagonalization accumulating the orthogonal
    factors: returns ``(d, e, U, V)`` with ``A = U @ bidiag(d, e) @ V.T``
    (square ``A``).  The panel loop of ``models/blocked.py`` with the
    reference's masks for this variant (``v`` kept where ``tau != 0``,
    ``u`` where ``tau_r != 0``), then per panel ``U <- U - ((U V) T_L)
    V^T`` and ``V <- V - ((V U_p) T_R) U_p^T`` with each ``T`` in closed
    form (:func:`_larft_closed_form`).  No host sync.
    """
    m, n = A.shape
    if m != n:
        raise ValueError("bidiagonalize_blocked_uv expects a square matrix")
    b = int(panel)
    d = A.new_zeros((n,))
    e = A.new_zeros((n,))
    Uacc = torch.eye(n, dtype=A.dtype, device=A.device)
    Vacc = Uacc.clone()
    for k in range(-(-n // b)):
        V, Y, X, U = panel_buffers(A, b)
        tl = A.new_zeros((b,))
        tr = A.new_zeros((b,))
        for j in range(b):
            tl[j], tr[j] = labrd_step(A, V, Y, X, U, d, e, k * b + j, j, uv=True)
        A = A - pdot(V, Y.T) - pdot(X, U.T)
        Uacc = Uacc - pdot(pdot(pdot(Uacc, V), _larft_closed_form(V, tl)), V.T)
        Vacc = Vacc - pdot(pdot(pdot(Vacc, U), _larft_closed_form(U, tr)), U.T)
    return d, e[: n - 1], Uacc, Vacc


def _cluster_bounds(sig, ctol):
    """Per-column cluster id and inclusive ``[start, end]`` column bounds of
    the contiguous close-sigma clusters (``sig`` sorted)."""
    n = sig.shape[0]
    smax = torch.max(torch.abs(sig))
    linked = torch.abs(sig[1:] - sig[:-1]) <= ctol * smax
    true = torch.ones((1,), dtype=torch.bool, device=sig.device)
    is_start = torch.cat([true, ~linked])
    rid = torch.cumsum(is_start.to(torch.int64), 0) - 1
    idx = torch.arange(n, device=sig.device)
    start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    is_end = torch.cat([~linked, true])
    end = torch.cummin(torch.where(is_end, idx, n - 1).flip(0), 0).values.flip(0)
    return rid, start, end


def _has_wide_cluster(sig, ctol):
    """0-d bool tensor: some cluster spans more than 64 columns."""
    _, start, end = _cluster_bounds(sig, ctol)
    return torch.any((start != end) & (end - start > _HALF))


def _normalize_columns(x, tiny):
    nrm = torch.sqrt(torch.clamp_min(torch.sum(x * x, dim=0), tiny))
    return x / nrm[None, :]


def _cholesky_qr(y, mask, shift):
    """One masked (shifted) CholeskyQR pass over the batched column blocks
    ``y`` (..., K, W): ``y L^{-T}`` with ``L = chol(Gc)``, where
    ``Gc = M o (y^T y) + (1 + shift) I - M o I``.  Columns of a block whose
    Cholesky fails (``info != 0``, where the reference's factor is NaN) keep
    their input, as do columns whose result is not finite."""
    W = y.shape[-1]
    eye = torch.eye(W, dtype=y.dtype, device=y.device)
    G = pdot(y.transpose(-1, -2), y)
    Gc = torch.where(mask, G, 0.0) + ((1 + shift) * eye - torch.where(mask, eye, 0.0))
    L, info = torch.linalg.cholesky_ex(Gc)
    ynew = torch.linalg.solve_triangular(
        L, y.transpose(-1, -2), upper=False
    ).transpose(-1, -2)
    bad = ~torch.isfinite(torch.sum(ynew * ynew, dim=-2)) | (info != 0)[..., None]
    return torch.where(bad[..., None, :], y, ynew)


def _cluster_orthogonalize(x, sig, ctol, passes=2, wide=None):
    """Cluster-blocked CholeskyQR, tiled: orthonormalize ``x`` (K, n) within
    clusters of close singular values.

    Columns are tiled at width 128 under two covers (offsets 0 and 64): a
    cluster of at most 64 columns lies wholly inside a tile of one cover,
    so each pass is a batched (ntiles, 128, 128) masked Gram, Cholesky and
    triangular solve.  The two covers correct disjoint column sets.  When a
    cluster is wider than 64 columns (``wide``; computed here, with a host
    sync, when not given), the dense :func:`_cluster_orthogonalize_dense`
    runs instead.
    """
    if wide is None:
        wide = bool(_has_wide_cluster(sig, ctol))
    if wide:
        return _cluster_orthogonalize_dense(x, sig, ctol, passes)
    K, n = x.shape
    dtype, dev = x.dtype, x.device
    rid, start, end = _cluster_bounds(sig, ctol)
    in_cluster = start != end
    tiny = torch.finfo(dtype).tiny
    shift = 4 * n * torch.finfo(dtype).eps
    x = _normalize_columns(x, tiny)
    full_a = start // TW == end // TW
    full_b = (start + _HALF) // TW == (end + _HALF) // TW
    corr = {0: in_cluster & full_a, _HALF: in_cluster & full_b & ~full_a}

    def cover(x, off):
        npad = -(-(n + off) // TW) * TW
        nt = npad // TW
        pads = (off, npad - n - off)
        xp = torch.nn.functional.pad(x, pads)
        pidx = torch.arange(npad, device=dev)
        # padded columns get unique negative cluster ids: singletons
        rid_p = torch.where(
            (pidx < off) | (pidx >= off + n),
            -(pidx + 1),
            torch.nn.functional.pad(rid + 1, pads),
        )
        ok_p = torch.nn.functional.pad(corr[off], pads)
        rid_t = rid_p.reshape(nt, TW)
        ok_t = ok_p.reshape(nt, TW)
        mask = (rid_t[:, :, None] == rid_t[:, None, :]) & (
            ok_t[:, :, None] & ok_t[:, None, :]
        )
        y3 = xp.reshape(K, nt, TW).permute(1, 0, 2)  # (nt, K, TW)
        for p in range(int(passes)):
            y3 = _cholesky_qr(y3, mask, shift if p == 0 else 0.0)
        yp = y3.permute(1, 0, 2).reshape(K, npad)[:, off : off + n]
        return torch.where(corr[off][None, :], yp, x)

    x = cover(x, 0)
    x = cover(x, _HALF)
    return _normalize_columns(x, tiny)


def _cluster_orthogonalize_dense(x, sig, ctol, passes=2):
    """Orthonormalize ``x`` (K, n) within clusters of close singular
    values by cluster-masked CholeskyQR over all n columns at once: the
    masked Gram ``Gc = I + M o (X^T X - I)`` is block-diagonal SPD, so
    ``X L^{-T}`` orthonormalizes every cluster and leaves singletons alone.
    The first pass is shifted by ``4 n eps`` (shifted CholeskyQR3
    schedule), the later ones not.  Width-unlimited."""
    n = x.shape[1]
    dtype = x.dtype
    rid, _, _ = _cluster_bounds(sig, ctol)
    tiny = torch.finfo(dtype).tiny
    shift = 4 * n * torch.finfo(dtype).eps
    x = _normalize_columns(x, tiny)
    mask = rid[:, None] == rid[None, :]
    for p in range(int(passes)):
        x = _cholesky_qr(x, mask, shift if p == 0 else 0.0)
    return _normalize_columns(x, tiny)


def _col_norm(x, tiny):
    return torch.clamp_min(torch.linalg.vector_norm(x, dim=0, keepdim=True), tiny)


def tgk_vectors(d, e, sig, iters=None, polish=None, x0=None):
    """Singular vectors of the bidiagonal {d, e} for the values ``sig``
    (sorted descending; any contiguous subset of the spectrum) by inverse
    iteration on the Golub-Kahan tridiagonal, all lanes at once.

    Returns ``(U_b, V_b)`` with ``bidiag(d, e) @ V_b ~= U_b * sig``.
    ``iters`` and ``polish`` default to 2 and 2 for float32, 3 and 4
    otherwise.  ``x0`` (2n, k) is the start block; by default it is drawn
    from a ``torch.Generator`` seeded 0 on ``d``'s device (the reference
    draws ``jax.random.normal(PRNGKey(0))``, which a caller may pass here).

    The shifted solves run the TGK solve kernel on float32 CUDA tensors and
    its plain version otherwise.  Clusters (gaps <= 64 eps sig_max) are
    re-coupled every iteration: v-parts orthogonalized within the cluster,
    u rebuilt as B v / sigma (near-zero clusters orthogonalize u directly).
    """
    n = d.shape[0]
    N = 2 * n
    k = sig.shape[0]
    dtype, dev = d.dtype, d.device
    f32 = dtype == torch.float32
    iters = (2 if f32 else 3) if iters is None else int(iters)
    polish = (2 if f32 else 4) if polish is None else int(polish)
    fi = torch.finfo(dtype)
    eps, tiny = fi.eps, fi.tiny
    z = d.new_zeros((N - 1,))
    z[0::2] = d
    z[1::2] = e
    smax = torch.max(torch.abs(sig))
    pivmin = torch.clamp_min(smax * eps * eps, tiny)
    big = torch.tensor(fi.max ** 0.5 / 16.0, dtype=dtype, device=dev)
    if x0 is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        x = torch.randn((N, k), generator=gen, dtype=dtype, device=dev)
    else:
        x = torch.as_tensor(x0, dtype=dtype, device=dev).contiguous()
        if x.shape != (N, k):
            raise ValueError(f"x0 must be {(N, k)}, got {tuple(x.shape)}")

    ctol = 64 * eps
    linked = torch.abs(sig[1:] - sig[:-1]) <= ctol * smax
    in_cluster = torch.zeros((k,), dtype=torch.bool, device=dev)
    in_cluster[1:] = linked
    in_cluster[:-1] |= linked
    lam = _perturbed_shifts(sig, smax, eps).contiguous()
    usable = in_cluster & (sig > 1e-3 * smax)
    # the one host sync: the reference's three lax.cond predicates
    has_cluster, need_un, wide = torch.stack([
        torch.any(linked),
        torch.any(in_cluster & ~usable),
        _has_wide_cluster(sig, ctol),
    ]).tolist()

    if use_kernels(d):
        def solve(rhs):
            return tridiag_solve.tgk_solve(z, lam, rhs, pivmin, big)
    else:
        def solve(rhs):
            return tridiag_solve.tgk_solve_plain(z, lam, rhs, pivmin, big)

    def couple_clusters(x):
        v, u = x[0::2], x[1::2]
        Vc = _cluster_orthogonalize(v, sig, ctol, wide=wide)
        Vc = Vc / _col_norm(Vc, tiny)
        Bv = d[:, None] * Vc
        Bv[:-1] += e[:, None] * Vc[1:]
        Uc = Bv / torch.maximum(sig, smax * eps + tiny)[None, :]
        Uc = Uc / _col_norm(Uc, tiny)
        Un = u
        if need_un:
            Un = _cluster_orthogonalize(u, sig, ctol, wide=wide)
            Un = Un / _col_norm(Un, tiny)
        v = torch.where(in_cluster[None, :], Vc, v)
        u = torch.where(usable[None, :], Uc, torch.where(in_cluster[None, :], Un, u))
        x = torch.stack([v, u], dim=1).reshape(N, k)  # row 2i = v[i], 2i+1 = u[i]
        return x / _col_norm(x, tiny)

    for _ in range(iters):
        x = solve(x)
        # near-singular solves reach ~1/sqrt(tiny): scale by the max first
        x = x / torch.clamp_min(torch.amax(torch.abs(x), dim=0, keepdim=True), tiny)
        x = x / torch.linalg.vector_norm(x, dim=0, keepdim=True)
        if has_cluster:
            x = couple_clusters(x)

    # Newton-Schulz polar polish of the u- and v-parts, stacked
    u = x[1::2]
    v = x[0::2]
    uv = torch.stack([u / _col_norm(u, tiny), v / _col_norm(v, tiny)])
    eye = torch.eye(k, dtype=dtype, device=dev)
    for _ in range(polish):
        G = pdot(uv.transpose(-1, -2), uv)
        uv = pdot(uv, 1.5 * eye - 0.5 * G)
    return uv[0], uv[1]


def bidiagonal_svd(d, e, k=None):
    """SVD of the bidiagonal {d, e}: returns ``(U_b, sig, V_b)``.

    ``k``: vectors (and the returned sig) for the top-``k`` values only;
    bisection still resolves the whole spectrum.  Float32 CUDA tensors run
    the bisection kernel, others the plain bisection.
    """
    if use_kernels(d):
        sig = bisect.bisect_svdvals(d.contiguous(), e.contiguous())
    else:
        sig = bisect_svdvals(d, e)
    if k is not None:
        sig = sig[: min(int(k), sig.shape[0])]
    U_b, V_b = tgk_vectors(d, e, sig)
    return U_b, sig, V_b


def _apply_chase_reflectors(V, T, M, band, reverse):
    """Apply the chase reflector product (records of
    ``band_to_bidiagonal_accum``) to the rows of ``M``, one rank-1 update
    per reflector, batched per sweep (the supports of one sweep's slots are
    disjoint).  ``reverse=False`` walks sweeps in creation order (``R @ M``
    for the right records), ``reverse=True`` in reverse (``L @ M``).  The
    reference form the WY walks are held against.
    """
    n_sweeps, s_max, b = V.shape
    ncols = M.shape[1]
    P = s_max * b
    Mp = M.new_zeros((n_sweeps + P + 1, ncols))
    Mp[: M.shape[0]] = M
    order = range(n_sweeps - 1, -1, -1) if reverse else range(n_sweeps)
    for i in order:
        seg3 = Mp[i + 1 : i + 1 + P].view(s_max, b, ncols)
        v = V[i]
        tv = (T[i][:, None] * v)[:, None, :]  # (s_max, 1, b)
        coef = pdot(tv, seg3)  # (s_max, 1, ncols)
        seg3 -= v[:, :, None] * coef
    return Mp[: M.shape[0]]


def _wy_blocks(V, T, fold):
    """Per (group, slot) compact-WY blocks of the chase records, batched
    over a leading record-set dim: ``V`` (B, n_sweeps, s_max, b) ->
    ``Vb`` (B, ng, s_max, G+b, G), the G = b sweeps of a group staggered
    one row apart, and ``Tb`` (or ``Vb @ Tb`` when ``fold``)."""
    B, n_sweeps, s_max, b = V.shape
    G = b
    n_groups = -(-n_sweeps // G)
    pad_s = n_groups * G - n_sweeps
    Vp = torch.nn.functional.pad(V, (0, 0, 0, 0, 0, pad_s))
    Tp = torch.nn.functional.pad(T, (0, 0, 0, pad_s))
    Vg = Vp.reshape(B, n_groups, G, s_max, b).transpose(2, 3)
    Tg = Tp.reshape(B, n_groups, G, s_max).transpose(2, 3)
    # identity reflectors must vanish from V for the closed-form T
    Vg = torch.where(Tg[..., None] == 0, 0.0, Vg)
    rows = torch.arange(G, device=V.device)[:, None]
    cols = torch.arange(b, device=V.device)[None, :] + rows
    F = V.new_zeros((B, n_groups, s_max, G, G + b))
    F[..., rows, cols] = Vg  # column j of Vb at local rows [j, j+b)
    Vb = F.transpose(-1, -2)
    Tb = _larft_closed_form(Vb, Tg)
    return Vb, (pdot(Vb, Tb) if fold else Tb), n_groups


def _wy_walk(V, T, M, fold, trim):
    """The grouped compact-WY walk computing ``L @ M`` (creation-order
    product) for a batch of record sets: groups of G = b sweeps in
    descending order, slots ascending, each step two GEMMs on the rows
    ``[g G + 1 + s b, +G+b)`` of ``M``, updated in place.  Regrouping is
    valid because within a group an overlapping later reflector sits at
    the same or a lower slot (see the reference's
    ``_apply_chase_reflectors_wy``).  ``fold`` uses ``seg - (V T)(V^T
    seg)``; ``trim`` skips each group's slots past the schedule's hop count
    (they hold only tau = 0).  In-place rows make the reference's
    overlap carry implicit."""
    B, n_sweeps, s_max, b = V.shape
    ncols = M.shape[-1]
    G = b
    Vb, Xb, n_groups = _wy_blocks(V, T, fold)
    P = n_groups * G + s_max * b + 1
    Mp = M.new_zeros((B, P + G + b, ncols))
    Mp[:, : M.shape[1]] = M
    n_prob = n_sweeps + 1  # dimension of the band the records came from
    for g in range(n_groups - 1, -1, -1):
        s_g = min(s_max, nc_of_static(g * G, n_prob, b) + 1) if trim else s_max
        for s in range(s_g):
            r0 = g * G + 1 + s * b
            seg = Mp[:, r0 : r0 + G + b]
            Vs, Xs = Vb[:, g, s], Xb[:, g, s]
            coef = pdot(Vs.transpose(-1, -2), seg)
            if not fold:
                coef = pdot(Xs, coef)
                Xs = Vs
            seg -= pdot(Xs, coef)
    return Mp[:, : M.shape[1]]


def _apply_chase_reflectors_wy(V, T, M, band):
    """Grouped compact-WY form of :func:`_apply_chase_reflectors`
    (``reverse=True``): ``L @ M`` in (n/b) * s_max GEMM steps."""
    return _wy_walk(V[None], T[None], M[None], fold=False, trim=False)[0]


def _apply_chase_reflectors_wy_carry(V, T, M, band):
    """:func:`_apply_chase_reflectors_wy` with ``V T`` folded (two GEMMs a
    step) and each group's walk stopped at its last live slot, as the
    reference's overlap-carry form (whose carried rows are the in-place
    rows here)."""
    return _wy_walk(V[None], T[None], M[None], fold=True, trim=True)[0]


def _apply_chase_reflectors_wy_pair(VL, TL, VR, TR, ML, MR, band):
    """Both chase back-transforms, ``L @ ML`` and ``R @ MR``, in one walk
    batched over the two record sets (same shape and slot schedule)."""
    out = _wy_walk(
        torch.stack([VL, VR]), torch.stack([TL, TR]), torch.stack([ML, MR]),
        fold=True, trim=True,
    )
    return out[0], out[1]


def _apply_stage1_reflectors_pair(Vq, Tq, Vl, Tl, MU, MV):
    """``U1 @ MU`` and ``V1 @ MV`` in one batched backward walk over the
    Stage I records (``Vq[k] = V_k^T``, ``Tq[k] = T_k^T``, ``Q_k = I - V_k
    T_k V_k^T``; ``U1 = Q_0 ... Q_{p-1}``, ``V1`` likewise from Vl/Tl)."""
    V2 = torch.stack([Vq, Vl], dim=1)  # (p, 2, b, n)
    T2 = torch.stack([Tq, Tl], dim=1)  # (p, 2, b, b)
    M2 = torch.stack([MU, MV])  # (2, n, k)
    for k in range(V2.shape[0] - 1, -1, -1):
        Vt, Tt = V2[k], T2[k]
        W = pdot(Vt, M2)  # (2, b, k)
        M2 = M2 - pdot(Vt.transpose(1, 2), pdot(Tt.transpose(1, 2), W))
    return M2[0], M2[1]


def svd_two_stage(A, band=None, k=None):
    """Full SVD of square ``A`` through the two-stage pipeline:
    ``A = U diag(s) V^T`` via the recording Stage I (``A = U1 Ab V1^T``),
    the recording chase (``Ab = L B R^T``), bisection and inverse iteration
    (``B = Ub diag(s) Vb^T``), then ``U = U1 (L Ub)``, ``V = V1 (R Vb)``.
    For float32 CUDA input the recording chase is the wavefront kernel
    where ``band_chase_wave.wave_chase_accum_preferred`` holds, else the
    sequential one (``band_chase.band_to_bidiagonal_accum``); both give the
    same records bit for bit.

    ``band=None`` picks the band by size, halved while ``band >= n``; the
    matrix is zero-padded to a multiple of it.  ``k``: only the top-``k``
    triplets (inverse iteration and the back-transforms on k lanes).
    Returns ``(U, s, Vh)``.  The chase records are exactly
    ``s_max_of(n, band)`` slots wide, so the reference's trim of padded
    record slots has nothing to cut here.
    """
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError("svd_two_stage expects a square matrix; use svd()")
    b = int(band) if band else _auto_block(n)
    while b >= n and b > 2:  # tiny inputs: the chase needs band < n
        b //= 2
    pad = (-n) % b
    if pad:
        A = torch.nn.functional.pad(A, (0, pad, 0, pad))
    if use_kernels(A):
        Ab, Vq, Tq, Vl, Tl = panel_qr.dense_to_band_rec_fused(A, band=b)
        d, e, VL, TL, VR, TR = routed_chase_accum(Ab, b)
    else:
        Ab, Vq, Tq, Vl, Tl = two_stage.dense_to_band_rec(A, band=b)
        d, e, VL, TL, VR, TR = two_stage.band_to_bidiagonal_accum(Ab, band=b)
    U_b, s, V_b = bidiagonal_svd(d, e, k=k)
    kout = n if k is None else min(int(k), n)
    LU, RV = _apply_chase_reflectors_wy_pair(VL, TL, VR, TR, U_b, V_b, b)
    U, V = _apply_stage1_reflectors_pair(Vq, Tq, Vl, Tl, LU, RV)
    return U[:n, :kout], s[:kout], V[:n, :kout].T


_TWO_STAGE = ("tpu2", "tpu1", "multicore")


def svd(A, panel=32, method="tpu2", band=None):
    """Full (thin) SVD: ``(U, s, Vh)`` with ``A ~= U @ diag(s) @ Vh``, s
    descending; for (m, n) input U is (m, k) and Vh (k, n), k = min(m, n).

    ``A``: a tensor runs on its own device (float32 CUDA through the
    kernels); a numpy array or array-like goes to the CUDA card as float32
    and raises when there is none.  ``method``: ``tpu2``, ``tpu1`` and
    ``multicore`` run :func:`svd_two_stage`; ``jacobi`` runs
    ``models.jacobi.svd_jacobi(A)`` (one-sided block Jacobi, its default
    block); every other name (``singlecore``, ``base``) runs the one-stage path, as
    the reference does: :func:`bidiagonalize_blocked_uv` with panel width
    ``panel``, then :func:`bidiagonal_svd` (the bisection and TGK solve
    kernels on the card), then ``U = Ug U_b``, ``V = Vg V_b``.  A
    rectangular input is reduced by a reduced QR first.  A complex input
    (a complex tensor, a numpy complex array) runs
    :func:`~svdsolver_tpu_torch.models.complex_svd.svd_c` and takes only
    ``method="tpu2"``.
    """
    from svdsolver_tpu_torch.models import complex_svd

    if complex_svd.is_complex_input(A):
        if method != "tpu2":
            raise ValueError(
                "complex input supports only the default pipeline (got "
                f"method={method!r}); call "
                "svdsolver_tpu_torch.models.complex_svd.svd_c directly"
            )
        return complex_svd.svd_c(A)
    A = as_input(A)
    if method == "jacobi":
        return svd_jacobi(A)
    m, n = A.shape
    if m < n:
        U, s, Vh = svd(A.T, panel=panel, method=method, band=band)
        return Vh.T, s, U.T
    if m > n:
        Q, R = torch.linalg.qr(A, mode="reduced")  # (m, n), (n, n)
        Ur, s, Vh = svd(R, panel=panel, method=method, band=band)
        return pdot(Q, Ur), s, Vh
    if method in _TWO_STAGE:
        return svd_two_stage(A, band=band)
    d, e, Ug, Vg = bidiagonalize_blocked_uv(A, panel=panel)
    U_b, s, V_b = bidiagonal_svd(d, e)
    return pdot(Ug, U_b), s, pdot(Vg, V_b).T


def svds(A, k, band=None):
    """Top-``k`` partial SVD: ``(U, s, Vh)`` with U (m, k), s (k,)
    descending, Vh (k, n) and ``A @ Vh.T ~= U * s``.  The reduction and
    bisection run in full; inverse iteration, the polish and the
    back-transforms run on ``k`` lanes.  Input placement as :func:`svd`.
    """
    A = as_input(A)
    m, n = A.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {tuple(A.shape)}")
    if m < n:
        U, s, Vh = svds(A.T, k, band=band)
        return Vh.T, s, U.T
    if m > n:
        Q, R = torch.linalg.qr(A, mode="reduced")
        Ur, s, Vh = svds(R, k, band=band)
        return pdot(Q, Ur), s, Vh
    return svd_two_stage(A, band=band, k=k)


def svd_batch(As, block=None):
    """Full SVD of a batch of square matrices: (B, n, n) -> (U (B, n, n),
    s (B, n) descending, Vh (B, n, n)).

    A loop over the batch (``jax.vmap``, which the reference batches with,
    has no counterpart over the hand-written kernels), each matrix through
    the reference's own sequence: zero-pad to a multiple of the band (by
    size, halved while it is ``>= n``); Stage I accumulating ``U1``, ``V1``
    (``panel_qr.dense_to_band_uv_fused`` on float32 CUDA input,
    ``two_stage.dense_to_band_uv`` elsewhere); the recording chase (on the
    card routed by ``band_chase_wave.wave_chase_accum_preferred``); the
    bisection and :func:`tgk_vectors`; the two chase back-transforms
    (:func:`_apply_chase_reflectors_wy`); ``U = U1 (L U_b)``, ``V = V1 (R
    V_b)``.  Input placement as :func:`as_input`, for (B, n, n).
    """
    As = as_batch(As, "svd_batch")
    n = As.shape[-1]
    b = int(block) if block else _auto_block(n)
    while b >= n and b > 2:
        b //= 2
    out = [_svd_one(A, n, b) for A in As]
    return tuple(torch.stack(x) for x in zip(*out))


def _svd_one(A, n, b):
    """One matrix of :func:`svd_batch`: ``(U, s, Vh)``, each ``n`` wide."""
    Ap, _ = _pad_to_multiple(A, b)
    if use_kernels(A):
        Ab, U1, V1 = panel_qr.dense_to_band_uv_fused(Ap, band=b)
        d, e, VL, TL, VR, TR = routed_chase_accum(Ab, b)
        sig = bisect.bisect_svdvals(d.contiguous(), e.contiguous())
    else:
        Ab, U1, V1 = two_stage.dense_to_band_uv(Ap, band=b)
        d, e, VL, TL, VR, TR = two_stage.band_to_bidiagonal_accum(Ab, band=b)
        sig = bisect_svdvals(d, e)
    U_b, V_b = tgk_vectors(d, e, sig)
    U = pdot(U1, _apply_chase_reflectors_wy(VL, TL, U_b, b))
    V = pdot(V1, _apply_chase_reflectors_wy(VR, TR, V_b, b))
    return U[:n, :n], sig[:n], V[:n, :n].T
