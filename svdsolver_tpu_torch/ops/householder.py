"""Householder reflector primitives (twin of ``svdsolver_tpu/ops/householder.py``).

A reflector is only ever the pair ``(v, tau)`` and is applied as a rank-1
update ``A - tau * v (v^T A)``.  Reflectors are computed over full-length
vectors: ``v`` is zero at indices ``< p``, one at the pivot ``p``, and the
tail holds the scaled input, so applying it to the whole matrix leaves the
inactive rows/columns untouched.
"""

import torch

from svdsolver_tpu_torch.ops.precision import pdot


def householder_vector(x, p):
    """Householder reflector for the tail ``x[p:]`` of the 1-D tensor ``x``.

    Returns ``(v, tau, beta)`` (``tau`` and ``beta`` 0-d tensors) with
    ``H = I - tau v v^T`` mapping ``x[p:]`` to ``beta e_p``; ``v[p] == 1``
    and ``v[i] == 0`` for ``i < p``.  LAPACK ``larfg`` scaling with the
    reference's sign rule: ``sign = +1 if x[p] >= 0``, ``beta = -sign *
    ||x[p:]||``.  A zero tail (including ``p >= len(x) - 1``) gives the
    identity (``tau == 0``); ``p >= len(x)`` gives ``v == 0`` as well.
    """
    p = int(p)
    if p < 0:
        raise ValueError(f"pivot must be >= 0, got {p}")
    L = x.shape[0]
    zero = x.new_zeros(())
    one = x.new_ones(())
    tail = torch.arange(L, device=x.device) > p
    xt = torch.where(tail, x, zero)
    pivot = x[p] if p < L else zero
    sigma2 = torch.sum(xt * xt)
    norm = torch.sqrt(pivot * pivot + sigma2)
    sign = torch.where(pivot >= 0, one, -one)
    beta = -sign * norm
    trivial = sigma2 == 0
    denom = torch.where(trivial, one, pivot - beta)
    v = torch.where(tail, xt / denom, zero)
    if p < L:
        v[p] = 1
    safe_beta = torch.where(beta == 0, one, beta)
    tau = torch.where(trivial, zero, (beta - pivot) / safe_beta)
    beta_out = torch.where(trivial, pivot, beta)
    return v, tau, beta_out


def apply_left(A, v, tau):
    """``A <- (I - tau v v^T) A`` as a rank-1 update (rows with v==0 untouched)."""
    w = pdot(v, A)
    return A - tau * torch.outer(v, w)


def apply_right(A, v, tau):
    """``A <- A (I - tau v v^T)`` as a rank-1 update (cols with v==0 untouched)."""
    w = pdot(A, v)
    return A - tau * torch.outer(w, v)
