"""One-sided block-Jacobi SVD (twin of ``svdsolver_tpu/models/jacobi.py``).

Hestenes one-sided Jacobi, blocked: the columns of ``W = A`` (or ``A^T``
when its rows are graded wider than its columns) are split into blocks of
``b``; each sweep is a round-robin tournament that pairs every block with
every other once, and each round rotates all its disjoint pairs at once:
a batched ``(2b, 2b)`` Gram of the pair, an accumulated product ``J`` of
scalar Jacobi rotations that nearly diagonalizes it (one parallel-ordered
inner sweep), and ``[Wp Wq] <- [Wp Wq] J``, ``[Vp Vq] <- [Vp Vq] J``.  The
sweeps stop when no pair visited in a sweep was coupled beyond ``tol``, or
when the coupling sits at the noise floor two sweeps running.  Then
``sigma_i = ||W[:, i]||``, ``U = W / sigma``, ``Vh = V^T``.  On graded
matrices the sigma keep ~eps RELATIVE accuracy, which no
bidiagonalization method reaches; the module docstring of the JAX package
has the algorithm's measurements and its rank-deficiency contract (the
vectors of numerically zero sigma come back as zero columns).

The reference has no Pallas kernel here: every step is an XLA batched
GEMM, gather or loop.  So this port runs on PyTorch ops: the contractions
through ``ops/precision.peinsum`` (float32 with TF32 off; float64 native on
the card), the schedules as index tensors on the input's device made once
a call, the inner rounds of the rotation solve and the tournament rounds
as host loops of batched launches (on a CUDA device one round captured
once a solve as a CUDA graph and replayed for every round: :class:`_Rounds`),
and the sweep loop with one host read a sweep (whether any matrix is
still active).  Every function carries a
leading batch dimension, so :func:`svd_jacobi_batch` runs the batch in the
same launches and stops each matrix at its own sweep, as the reference's
batched ``while_loop`` does.  Sorts are stable, as ``jnp.argsort`` is.
"""

import math

import numpy as np
import torch

from svdsolver_tpu_torch.models.svd import as_batch, as_input
from svdsolver_tpu_torch.ops.precision import pdot, peinsum

__all__ = ["svd_jacobi", "svd_jacobi_batch", "svd_jacobi_pre"]

last_sweeps = None  # the sweeps of each matrix of the last solve (a device tensor)


def _tournament(nb):
    """Round-robin schedule: (nb-1, nb) block orderings, pairs adjacent.

    Circle method: block 0 is pinned, blocks 1..nb-1 rotate.  Round r pairs
    (0, rot[0]) and (rot[i], rot[nb-1-i]); the row lists the 2i and 2i+1
    slots of pair i consecutively, so columns grouped by the row order
    reshape to (npairs, 2b) pair groups directly.
    """
    assert nb % 2 == 0 and nb >= 2
    rounds = np.empty((nb - 1, nb), dtype=np.int32)
    others = list(range(1, nb))
    for r in range(nb - 1):
        rot = others[r:] + others[:r]
        row = [0, rot[0]]
        for i in range(1, nb // 2):
            row += [rot[i], rot[nb - 1 - i]]
        rounds[r] = row
    return rounds


def _schedule_cols(n_pad, b, device):
    """Column permutations (nb-1, n_pad) of the tournament and their
    inverses, as int64 index tensors on ``device``."""
    nb = n_pad // b
    rounds = _tournament(nb)
    base = np.arange(n_pad, dtype=np.int64).reshape(nb, b)
    perms = base[rounds].reshape(nb - 1, n_pad)
    iperms = np.argsort(perms, axis=1, kind="stable")
    return (torch.as_tensor(perms, device=device),
            torch.as_tensor(iperms, device=device))


def _rotation_params(app, aqq, apq, eps):
    """Stable scalar Jacobi (c, s) zeroing G[p, q]; the identity (c = 1,
    s = 0) where ``|apq| <= eps sqrt(app aqq)``, so converged pairs are
    bitwise fixed points.  Rutishauser's tau = (aqq - app) / (2 apq),
    t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with sqrt(1 + tau^2) formed
    from a ratio <= 1 (|tau| sqrt(1 + tau^-2) for |tau| >= 1: tau ~ 1/apq
    near convergence would overflow tau^2; inf gives t = 0, the limit),
    c = 1 / sqrt(1 + t^2), s = t c."""
    one = torch.ones((), dtype=app.dtype, device=app.device)
    small = apq.abs() <= eps * torch.sqrt(torch.clamp(app * aqq, min=0.0))
    denom = torch.where(apq == 0, one, 2.0 * apq)
    tau = (aqq - app) / denom
    sgn = torch.where(tau >= 0, one, -one)
    at = tau.abs()
    big = at >= 1.0
    r = torch.where(big, one / torch.clamp(at, min=1.0), at)
    root = torch.sqrt(1.0 + r * r)
    t = sgn / (at + torch.where(big, at * root, root))
    t = torch.where(small, torch.zeros_like(t), t)
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def _local_rotations(G, perms, iperms):
    """The accumulated rotation ``J`` of a batch of pair Grams ``G`` (P, w,
    w): one parallel-ordered scalar-Jacobi sweep, w - 1 rounds of w / 2
    disjoint rotations batched over P and the round, ``G <- R^T G R``,
    ``J <- J R``.  ``J`` is a product of rotations and goes to I as
    offdiag(G) goes to 0, which makes the outer iteration converge."""
    P, w, _ = G.shape
    h = w // 2
    eps = torch.finfo(G.dtype).eps
    J = torch.eye(w, dtype=G.dtype, device=G.device).expand(P, w, w)
    for r in range(perms.shape[0]):
        perm, iperm = perms[r], iperms[r]
        # rows and columns permuted so this round's pairs are adjacent
        Gp = G.index_select(1, perm).index_select(2, perm)
        blk = torch.diagonal(Gp.reshape(P, h, 2, h, 2), dim1=1, dim2=3)  # (P, 2, 2, h)
        c, s = _rotation_params(blk[:, 0, 0], blk[:, 1, 1], blk[:, 0, 1], eps)
        # R[k] = [[c, s], [-s, c]], applied as G' = R^T G R a pair
        R = torch.stack([torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)], dim=-2)
        Gc = peinsum("pmki,pkia->pmka", Gp.reshape(P, w, h, 2), R)
        Gr = peinsum("pkim,pkia->pkam", Gc.reshape(P, h, 2, w), R).reshape(P, w, w)
        G = Gr.index_select(1, iperm).index_select(2, iperm)
        Jc = peinsum("pmki,pkia->pmka", J.index_select(2, perm).reshape(P, w, h, 2), R)
        J = Jc.reshape(P, w, w).index_select(2, iperm)
    return J


def _jacobi_round(W, V, perm, iperm, in_perms, in_iperms, b, eps):
    """One tournament round of disjoint pair rotations on ``W`` (B, m,
    n_pad) and ``V`` (B, n_pad, n_pad).  Returns the new ``(W, V)`` and each
    matrix's largest relative cross-block coupling before the rotations
    (B,), over live columns only: a column whose squared norm is at most
    ``eps^2 n_pad max|G_ii|`` carries no signal (its sigma rounds to zero),
    so rank-deficient inputs terminate."""
    B, m, n_pad = W.shape
    npairs = n_pad // (2 * b)

    def group(M):  # columns -> (B, npairs, rows, 2b), pairs adjacent under perm
        rows = M.shape[1]
        return M.index_select(2, perm).reshape(B, rows, npairs, 2 * b).permute(0, 2, 1, 3)

    def ungroup(Mp):
        rows = Mp.shape[2]
        return Mp.permute(0, 2, 1, 3).reshape(B, rows, n_pad).index_select(2, iperm)

    Wp, Vp = group(W), group(V)
    G = peinsum("bpmi,bpmj->bpij", Wp, Wp)
    w = 2 * b
    J = _local_rotations(G.reshape(B * npairs, w, w), in_perms, in_iperms)
    J = J.reshape(B, npairs, w, w)
    Wp = peinsum("bpmi,bpij->bpmj", Wp, J)
    Vp = peinsum("bpmi,bpij->bpmj", Vp, J)

    dg = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1), min=0.0)  # (B, npairs, 2b)
    floor = (eps * eps) * n_pad * dg.amax(dim=(1, 2))  # squared dead-column floor
    denom = torch.sqrt(dg[..., :b, None] * dg[..., None, b:])
    alive = torch.minimum(dg[..., :b, None], dg[..., None, b:]) > floor[:, None, None, None]
    cross = G[..., :b, b:].abs()
    rel = torch.where(alive, cross / torch.clamp(denom, min=1e-30), torch.zeros_like(cross))
    return ungroup(Wp), ungroup(Vp), rel.amax(dim=(1, 2, 3))


def _eps_eff(dtype):
    """Machine epsilon of the compute path: ``finfo(dtype).eps``.  (The
    reference raises it to 2^-44 for float64 on a TPU, whose float64 is
    emulated; the card's float64 is native, as the reference's CPU run.)"""
    return float(torch.finfo(dtype).eps)


class _Rounds:
    """The tournament rounds of one solve.  On a CUDA device one round is
    captured once as a CUDA graph (``torch.cuda.CUDAGraph``) over static
    buffers: the state (W, V) and the round's column permutation and its
    inverse, which each round copies in before it replays the graph.  A
    round is ~6,400 launches of small kernels (2b - 1 inner rounds of the
    rotation solve); replayed, it costs its kernels, not their host
    launches.  On the CPU the rounds run eagerly."""

    def __init__(self, W, V, sched, b, eps):
        self.perms, self.iperms, in_perms, in_iperms = sched
        self.args = (in_perms, in_iperms, b, eps)
        self.graph = None
        if not W.is_cuda:
            return
        self.W, self.V = W.clone(), V.clone()
        self.perm, self.iperm = self.perms[0].clone(), self.iperms[0].clone()

        def round_():
            return _jacobi_round(self.W, self.V, self.perm, self.iperm, *self.args)

        side = torch.cuda.Stream(W.device)
        side.wait_stream(torch.cuda.current_stream(W.device))
        with torch.cuda.stream(side):
            round_()  # warm-up: the libraries' handles and workspaces
        torch.cuda.current_stream(W.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = round_()

    def sweep(self, W, V):
        """Every round once: ``(W, V, off)``, ``off`` each matrix's largest
        coupling over the sweep (B,)."""
        off = W.new_zeros((W.shape[0],))
        if self.graph is None:
            for r in range(self.perms.shape[0]):
                W, V, rel = _jacobi_round(W, V, self.perms[r], self.iperms[r], *self.args)
                off = torch.maximum(off, rel)
            return W, V, off
        Wo, Vo, rel = self.out
        self.W.copy_(W)
        self.V.copy_(V)
        for r in range(self.perms.shape[0]):
            self.perm.copy_(self.perms[r])
            self.iperm.copy_(self.iperms[r])
            self.graph.replay()
            self.W.copy_(Wo)
            self.V.copy_(Vo)
            off = torch.maximum(off, rel)
        return self.W.clone(), self.V.clone(), off


def _svd_jacobi_square(A, b, max_sweeps, tol, eps_eff):
    """The Jacobi solve of a batch of square matrices ``A`` (B, n, n):
    ``(U, s, Vh, sweeps)``, ``sweeps`` (B,) the sweeps each matrix ran.
    Each matrix stops at its own sweep (its state frozen from there), as
    the reference's ``while_loop`` under ``vmap``; the loop reads one flag
    from the device a sweep."""
    B, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    # Grading flip: the column metric converges fast on graded COLUMN
    # norms, slowly on graded row norms; solve the transpose where the rows
    # spread wider, swap U and V at the end.
    tiny = torch.finfo(dtype).tiny

    def spread(v):
        return v.amax(dim=-1) / torch.clamp(v.amin(dim=-1), min=tiny)

    flip = spread(torch.linalg.vector_norm(A, dim=-1)) > spread(
        torch.linalg.vector_norm(A, dim=-2))
    A = torch.where(flip[:, None, None], A.transpose(-1, -2), A)
    # gesvj-style scaling to max|A| ~ 1: the Gram entries and the skip and
    # coupling tests form products of squared column norms, which overflow
    # float32 for entries ~1e10 (every rotation then silently skipped)
    scale = A.abs().amax(dim=(-1, -2))
    scale = torch.where((scale == 0) | ~torch.isfinite(scale), torch.ones_like(scale), scale)
    A = A / scale[:, None, None]

    n_pad = -(-n // (2 * b)) * (2 * b)
    W = torch.nn.functional.pad(A, (0, n_pad - n))
    V = torch.eye(n_pad, dtype=dtype, device=dev).expand(B, n_pad, n_pad).contiguous()
    rounds = _Rounds(W, V, _schedule_cols(n_pad, b, dev) + _schedule_cols(2 * b, 1, dev), b,
                     eps_eff)

    off = torch.full((B,), math.inf, dtype=dtype, device=dev)
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    sweeps = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    while bool(active.any()):  # the sweep's one host read
        W1, V1, off1 = rounds.sweep(W, V)
        # noise-floor bookkeeping: the max coupling of cyclic Jacobi is not
        # monotone, so only the second non-improving sweep in a row at a
        # collapsed (< 1e-2) coupling stops the iteration
        bounced = (off1 < 1e-2) & (off1 >= off)
        stall1 = torch.where(bounced, stall + 1, torch.zeros_like(stall))
        W = torch.where(active[:, None, None], W1, W)
        V = torch.where(active[:, None, None], V1, V)
        off = torch.where(active, off1, off)
        stall = torch.where(active, stall1, stall)
        sweeps = sweeps + active.to(torch.int32)
        active = (sweeps < max_sweeps) & (off > tol) & (stall < 2)

    global last_sweeps
    last_sweeps = sweeps
    U, s, Vh = _finalize(W, V, n, flip, eps_eff)
    return U, s * scale[:, None], Vh, sweeps


def _finalize(W, V, n, flip, eps_eff):
    """Sort by descending column norm (stable), normalize, zero the vectors
    of numerically zero sigma, and undo the grading flip: (W, V) with
    W ~= A_pad V -> (U, s, Vh), batched."""
    B = W.shape[0]
    s_all = torch.linalg.vector_norm(W, dim=-2)
    order = torch.argsort(-s_all, dim=-1, stable=True)[:, :n]
    s = torch.gather(s_all, 1, order)
    cols = order[:, None, :]
    L = torch.gather(W, 2, cols.expand(B, W.shape[1], n))[:, :n] / torch.clamp(
        s, min=torch.finfo(W.dtype).tiny)[:, None, :]
    R = torch.gather(V[:, :n], 2, cols.expand(B, n, n))
    # the threshold sqrt(n) eps_eff sigma_max: above the zero-sigma noise,
    # below any sigma the compute path resolves (in float64, as the
    # reference forms it with a float64 sqrt(n))
    thr = (eps_eff * torch.clamp(s[:, :1], min=0.0)).double() * np.sqrt(n)
    dead = (s.double() <= thr)[:, None, :]
    L = torch.where(dead, torch.zeros_like(L), L)
    R = torch.where(dead, torch.zeros_like(R), R)
    U = torch.where(flip[:, None, None], R, L)
    Vc = torch.where(flip[:, None, None], L, R)
    return U, s, Vc.transpose(-1, -2)


def _block_of(block, n):
    return int(max(2, min(int(block), -(-n // 2))))


def _tol_of(tol, n, eps_eff):
    return float(np.sqrt(n)) * eps_eff if tol is None else float(tol)


def svd_jacobi(A, block=64, max_sweeps=30, tol=None):
    """Full SVD by one-sided block Jacobi: ``A ~= U @ diag(s) @ Vh``, s
    descending; for (m, n) input U is (m, k), Vh (k, n), k = min(m, n).

    ``block`` is the column-block width (pairs of ``2 block`` columns);
    ``tol`` the largest relative cross-block coupling at which a sweep
    declares convergence (default ``sqrt(n) eps``).  A wide input runs on
    its transpose, a tall one on the triangular factor of a reduced QR.
    ``A``: a tensor runs on its own device and dtype; a numpy array or
    array-like goes to the CUDA card as float32.
    """
    A = as_input(A)
    m, n = A.shape
    if m < n:
        U, s, Vh = svd_jacobi(A.T, block=block, max_sweeps=max_sweeps, tol=tol)
        return Vh.T, s, U.T
    if m > n:
        Q, R = torch.linalg.qr(A, mode="reduced")
        Ur, s, Vh = svd_jacobi(R, block=block, max_sweeps=max_sweeps, tol=tol)
        return pdot(Q, Ur), s, Vh
    eps_eff = _eps_eff(A.dtype)
    U, s, Vh, _ = _svd_jacobi_square(A[None], _block_of(block, n), int(max_sweeps),
                                     _tol_of(tol, n, eps_eff), eps_eff)
    return U[0], s[0], Vh[0]


def svd_jacobi_batch(As, block=16, max_sweeps=30, tol=None):
    """Batched full SVD by one-sided block Jacobi: (B, n, n) -> ``(U (B, n,
    n), s (B, n), Vh (B, n, n))``.

    Every round's Grams, rotation solves and updates batch over the pairs
    and the matrices in the same launches.  Each matrix stops at its own
    sweep (the reference's ``vmap`` of its ``while_loop`` keeps a finished
    lane's state), so matrix ``i`` gets what :func:`svd_jacobi` gives it at
    the same ``block``.  Input placement as ``models.svd.as_batch``.
    """
    As = as_batch(As, "svd_jacobi_batch")
    n = As.shape[-1]
    eps_eff = _eps_eff(As.dtype)
    U, s, Vh, _ = _svd_jacobi_square(As, _block_of(block, n), int(max_sweeps),
                                     _tol_of(tol, n, eps_eff), eps_eff)
    return U, s, Vh


def _svd_jacobi_pre_square(A, b, max_sweeps, tol, eps_eff):
    """Drmac's preconditioning of a (m, n), m >= n, matrix: columns sorted by
    descending norm (stable), ``A P = Q1 R1``, ``R1^T = Q2 R2``, Jacobi on
    ``R2^T``; returns ``(U, s, Vh, sweeps)``."""
    cn = torch.linalg.vector_norm(A, dim=0)
    order = torch.argsort(-cn, stable=True)
    iorder = torch.argsort(order, stable=True)
    Q1, R1 = torch.linalg.qr(A[:, order], mode="reduced")
    Q2, R2 = torch.linalg.qr(R1.T, mode="reduced")
    Ux, s, Vhx, sweeps = _svd_jacobi_square(R2.T[None], b, max_sweeps, tol, eps_eff)
    U = pdot(Q1, Ux[0])
    Vh = pdot(Vhx[0], Q2.T)
    return U, s[0], Vh[:, iorder], sweeps[0]


def svd_jacobi_pre(A, block=16, max_sweeps=30, tol=None):
    """Preconditioned one-sided Jacobi (LAPACK dgejsv class): ``A ~= U @
    diag(s) @ Vh`` with Jacobi's relative sigma accuracy in fewer sweeps.

    Drmac's preconditioning (the reference's): sort the columns by norm,
    QR factor, QR factor the transposed triangular factor again, and run
    one-sided Jacobi on the doubly condensed ``R2^T``; ``U = Q1 Ux``,
    ``Vh = (Q2 Vhx^T)^T P^T``.  A wide input runs on its transpose.  Input
    placement as :func:`svd_jacobi`.
    """
    A = as_input(A)
    m, n = A.shape
    if m < n:
        U, s, Vh = svd_jacobi_pre(A.T, block=block, max_sweeps=max_sweeps, tol=tol)
        return Vh.T, s, U.T
    eps_eff = _eps_eff(A.dtype)
    U, s, Vh, _ = _svd_jacobi_pre_square(A, _block_of(block, n), int(max_sweeps),
                                         _tol_of(tol, n, eps_eff), eps_eff)
    return U, s, Vh
