"""Blocked one-stage bidiagonalization, the ``singlecore`` rung (twin of
``svdsolver_tpu/models/blocked.py``).

Panel-wise compact-WY bidiagonal reduction: each panel accumulates ``V, Y,
X, U`` so that the trailing matrix is updated once a panel as ``A <- A - V
Y^T - X U^T`` (two GEMMs).  Within a panel the current column and row are
formed lazily from the low-rank correction (LAPACK ``labrd``), so the
panel loop is GEMV-sized.  All reflectors are full-length masked vectors
and the panel loop runs over global column indices, so any ``n`` works:
panel columns past ``n`` are identity reflectors (``g_ok`` is a Python
bool here, where the reference masks a traced one).  The loop makes no
host sync.
"""

import torch

from svdsolver_tpu_torch.ops.householder import householder_vector
from svdsolver_tpu_torch.ops.precision import pdot


def labrd_step(A, V, Y, X, U, d, e, g, j, uv=False):
    """Column ``j`` of a panel, global index ``g``: the column reflector of
    the lazily formed ``A_hat = A - V Y^T - X U^T`` (pivot ``g``), then the
    row reflector of row ``g`` of ``A_hat`` with the column reflector
    applied (pivot ``g + 1``); both identities for ``g >= n``.  Writes
    ``d[g]``, ``e[g]`` and column ``j`` of ``V, Y, X, U`` in place; returns
    ``(tau, tau_r)``.

    The masks of ``V`` and ``U`` are those of the two references:
    ``bidiagonalize_blocked`` keeps ``v`` and ``u`` where ``g < n``;
    ``bidiagonalize_blocked_uv`` (``uv=True``) keeps ``v`` where ``g < n``
    and ``tau != 0``, and ``u`` where ``tau_r != 0``.
    """
    n = A.shape[1]
    g_ok = g < n
    gc = min(g, n - 1)
    col = A[:, gc] - pdot(V, Y[gc, :]) - pdot(X, U[gc, :])
    v, tau, beta = householder_vector(col, g)
    if g_ok:
        d[gc] = beta
    else:
        tau = torch.zeros_like(tau)
    # y = tau * A_hat^T v  (the left update's row for the trailing matrix)
    Y[:, j] = tau * (pdot(A.T, v) - pdot(Y, pdot(V.T, v)) - pdot(U, pdot(X.T, v)))
    if g_ok:
        V[:, j] = torch.where(tau != 0, v, 0.0) if uv else v
    row = A[gc, :] - pdot(Y, V[gc, :]) - pdot(U, X[gc, :])
    u, tau_r, beta_r = householder_vector(row, g + 1)
    if g_ok:
        e[gc] = beta_r
    else:
        tau_r = torch.zeros_like(tau_r)
    # x = tau_r * A_hat u  (the right update's column)
    X[:, j] = tau_r * (pdot(A, u) - pdot(V, pdot(Y.T, u)) - pdot(X, pdot(U.T, u)))
    if uv:
        U[:, j] = torch.where(tau_r != 0, u, 0.0)
    elif g_ok:
        U[:, j] = u
    return tau, tau_r


def panel_buffers(A, b):
    """The zeroed ``V (m, b), Y (n, b), X (m, b), U (n, b)`` of a panel."""
    m, n = A.shape
    return A.new_zeros((m, b)), A.new_zeros((n, b)), A.new_zeros((m, b)), A.new_zeros((n, b))


def bidiagonalize_blocked(A, panel=32):
    """Reduce ``A`` (m x n, m >= n) to upper-bidiagonal form; returns
    ``(d, e)``.  ``panel`` is the block width.  ``A`` is not modified."""
    m, n = A.shape
    if m < n:
        raise ValueError("bidiagonalize_blocked requires m >= n")
    b = int(panel)
    d = A.new_zeros((n,))
    e = A.new_zeros((n,))  # slot n-1 is scratch
    for k in range(-(-n // b)):
        V, Y, X, U = panel_buffers(A, b)
        for j in range(b):
            labrd_step(A, V, Y, X, U, d, e, k * b + j, j)
        # deferred trailing update: two GEMMs
        A = A - pdot(V, Y.T) - pdot(X, U.T)
    return d, e[: n - 1]
