"""Golub-Kahan bidiagonal reduction, the ``base`` rung (twin of
``svdsolver_tpu/models/golub_kahan.py``).

One host loop over the columns; each step is a pair of masked rank-1
updates on the whole matrix (a column reflector, then a row reflector),
built by :func:`~svdsolver_tpu_torch.ops.householder.householder_vector`
on full-length vectors.  The pivots are Python ints, so the loop makes no
host sync.  On the card every step is a handful of PyTorch launches: the
reference's ``fori_loop`` body, with no kernel of its own.
"""

import torch

from svdsolver_tpu_torch.ops.householder import householder_vector
from svdsolver_tpu_torch.ops.precision import pdot


def bidiagonalize_gk(A):
    """Reduce ``A`` (m x n, m >= n) to upper-bidiagonal form.

    Returns ``(d, e)``: the diagonal (length n) and superdiagonal (length
    n-1) of ``B = U^T A V``.  Signs are reflector-dependent; singular values
    are ``|.|``-invariant.  ``A`` is not modified.
    """
    m, n = A.shape
    if m < n:
        raise ValueError("bidiagonalize_gk requires m >= n; pass A.T instead")
    A = A.clone()
    d = A.new_zeros((n,))
    e = A.new_zeros((n,))  # slot n-1 is scratch, sliced off on return
    for j in range(n):
        # column reflector: eliminate below the diagonal in column j
        v, tau, beta = householder_vector(A[:, j], j)
        A -= tau * torch.outer(v, pdot(v, A))
        d[j] = beta
        # row reflector: eliminate right of the superdiagonal in row j
        u, tau_r, beta_r = householder_vector(A[j, :], j + 1)
        A -= tau_r * torch.outer(pdot(A, u), u)
        e[min(j, n - 1)] = beta_r
    return d, e[: n - 1]
