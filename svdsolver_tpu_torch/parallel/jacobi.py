"""Multi-rank one-sided block-Jacobi SVD: a systolic tournament (twin of
``svdsolver_tpu/parallel/jacobi.py``).

The single-card block Jacobi (``models/jacobi.py``) pairs column blocks
round-robin; every round's pairs are independent.  Here each rank of the
mesh's ``tp`` axis owns two column blocks of width ``b`` (its pair) of W
and of V, the Brent-Luk way: a round is one local pair step (a (2b, 2b)
Gram, the accumulated rotation of one parallel-ordered inner sweep,
``models.jacobi._local_rotations``, and the two GEMMs ``W J``, ``V J``),
then the tournament's re-pairing as a neighbour-only exchange (one
``ppermute`` up, one down, W's and V's blocks in one message each way).
Convergence reads a ``pmax`` of each rank's coupling.  SPMD: every rank
passes the global ``A`` and gets ``(U, s, Vh)`` back; the finalization
(sort, normalize, the flip) runs on every rank on the gathered W and V.

No kernel of its own, as in the JAX package (XLA ops there).  On a CUDA
rank the rotation solve of a round, ~50 launches for each of its 2b - 1
inner rounds, is captured once as a CUDA graph and replayed every round
(:class:`_RotationSolve`); the collectives stay outside the graph.
"""

import numpy as np
import torch

from svdsolver_tpu_torch.models.jacobi import (
    _eps_eff,
    _finalize,
    _local_rotations,
    _schedule_cols,
)
from svdsolver_tpu_torch.ops.precision import pdot

__all__ = ["svd_jacobi_sharded"]


def _round_robin_exchange(mesh, top, bot):
    """One circle-method rotation of each rank's (top, bottom) blocks (the
    JAX package's ``_round_robin_exchange``): rank 0's top block is
    pinned, every other block moves one slot along ``a_1 -> a_2 -> ... ->
    a_{P-1} -> b_{P-1} -> ... -> b_0 -> a_1``.  Two nearest-neighbour
    ``ppermute``s: up (rank 0 sends its bottom block, the others their
    top) and down (bottom blocks); the ring's two ends resolve locally."""
    tp = mesh.shape["tp"]
    me = mesh.axis_index("tp")
    recv_up = mesh.ppermute(bot if me == 0 else top, "tp", [(i, i + 1) for i in range(tp - 1)])
    recv_dn = mesh.ppermute(bot, "tp", [(i, i - 1) for i in range(1, tp)])
    new_top = top if me == 0 else recv_up
    new_bot = top if me == tp - 1 else recv_dn
    return new_top, new_bot


class _RotationSolve:
    """``J`` of one pair Gram ``G`` (w, w): ``_local_rotations`` on the
    in-pair schedule.  On a CUDA device the solve is captured once as a
    ``torch.cuda.CUDAGraph`` over a static ``G`` (copied in before each
    replay); on the CPU it runs eagerly."""

    def __init__(self, w, dtype, device):
        self.sched = _schedule_cols(w, 1, device)
        self.graph = None
        if torch.device(device).type != "cuda":
            return
        self.G = torch.eye(w, dtype=dtype, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._solve(self.G)  # warm-up: the libraries' handles and workspaces
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.J = self._solve(self.G)

    def _solve(self, G):
        return _local_rotations(G[None], *self.sched)[0]

    def __call__(self, G):
        if self.graph is None:
            return self._solve(G)
        self.G.copy_(G)
        self.graph.replay()
        return self.J.clone()


def svd_jacobi_sharded(A, mesh, max_sweeps=30, tol=None):
    """Full SVD of one square matrix by multi-rank block Jacobi: ``(U, s,
    Vh)`` with ``A ~= U @ diag(s) @ Vh``, Jacobi's accuracy class (~eps
    relative sigma error on graded spectra), as the JAX entry.

    The grading flip (solve ``A^T`` where the rows spread wider than the
    columns) and the scaling to ``max |A| = 1`` run on every rank; ``A``
    is zero-padded to ``2 tp b`` columns, ``b = ceil(n / (2 tp))``, and rank
    ``t`` takes columns ``[2 t b, 2 (t + 1) b)`` of W (and of V = I).  A
    sweep is ``2 tp - 1`` rounds (:mod:`module docstring <svdsolver_tpu_torch.
    parallel.jacobi>`); the sweeps stop at ``max_sweeps``, when the
    largest relative coupling of a sweep is at most ``tol`` (default
    ``sqrt(n) eps``), or at the second bounce in a row at a coupling below
    1e-2.  SPMD: every rank passes the global ``A`` and gets the result.
    Raises ``ValueError`` for a non-square ``A`` or ``tp < 2``."""
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A))
    A = A.to(mesh.device)
    m, n = A.shape
    if m != n:
        raise ValueError(f"square input required, got {tuple(A.shape)}")
    tp = mesh.shape["tp"]
    if tp < 2:
        raise ValueError("need tp >= 2; use models.jacobi.svd_jacobi on one device")
    dtype, dev = A.dtype, A.device
    eps_eff = _eps_eff(dtype)
    tol = float(np.sqrt(n)) * eps_eff if tol is None else float(tol)

    tiny = float(torch.finfo(dtype).tiny)

    def spread(v):
        return float(v.max()) / max(float(v.min()), tiny)

    flip = spread(torch.linalg.vector_norm(A, dim=1)) > spread(torch.linalg.vector_norm(A, dim=0))
    if flip:
        A = A.T
    scale = A.abs().max()
    scale = torch.where((scale == 0) | ~torch.isfinite(scale), torch.ones_like(scale), scale)
    A = A / scale

    b = -(-n // (2 * tp))
    n_pad = 2 * tp * b
    cols = slice(2 * b * mesh.axis_index("tp"), 2 * b * (mesh.axis_index("tp") + 1))
    Ap = torch.nn.functional.pad(A, (0, n_pad - n, 0, n_pad - n))
    # W and V travel together: WV[0] = W, WV[1] = V, each (n_pad, 2b)
    WV = torch.stack([Ap[:, cols], torch.eye(n_pad, dtype=dtype, device=dev)[:, cols]])
    solve = _RotationSolve(2 * b, dtype, dev)
    floor_scale = (eps_eff * eps_eff) * n_pad
    off_prev, stall, sweeps = float("inf"), 0, 0
    while sweeps < max_sweeps:
        off = torch.zeros((1,), dtype=dtype, device=dev)
        for _ in range(2 * tp - 1):
            W = WV[0]
            G = pdot(W.T, W)  # the pair's (2b, 2b) Gram
            dg = torch.clamp(torch.diagonal(G), min=0.0)
            floor = floor_scale * mesh.pmax(dg.max().reshape(1), "tp")
            cross = G[:b, b:].abs()
            denom = torch.sqrt(dg[:b, None] * dg[None, b:])
            alive = torch.minimum(dg[:b, None], dg[None, b:]) > floor
            rel = torch.where(alive, cross / torch.clamp(denom, min=1e-30), torch.zeros_like(cross))
            off = torch.maximum(off, mesh.pmax(rel.max().reshape(1), "tp"))
            WV = pdot(WV, solve(G))
            top, bot = _round_robin_exchange(mesh, WV[..., :b].contiguous(),
                                             WV[..., b:].contiguous())
            WV = torch.cat([top, bot], dim=2)
        sweeps += 1
        off = float(off)  # the sweep's one host read; the same on every rank
        # two consecutive bounces at a collapsed coupling stop the sweeps
        stall = stall + 1 if off < 1e-2 and off >= off_prev else 0
        off_prev = off
        if off <= tol or stall >= 2:
            break
    W = mesh.all_gather(WV[0], "tp", dim=1)  # (n_pad, n_pad), blocks in rank order
    V = mesh.all_gather(WV[1], "tp", dim=1)
    flip_t = torch.tensor([flip], device=dev)
    U, s, Vh = _finalize(W[None], V[None], n, flip_t, eps_eff)
    return U[0], s[0] * scale, Vh[0]
