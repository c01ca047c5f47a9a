"""Bidiagonal singular values by parallel bisection, plain PyTorch (twin of
``bisect_svdvals`` in ``svdsolver_tpu/models/diagonalize.py``).

The QR and dqds diagonalizers of the JAX package are not ported yet
(ROADMAP queue 1, item 7).
"""

import math

import torch


def tgk_z2_and_bound(d, e):
    """Squared Golub-Kahan off-diagonals and the Gershgorin bound.

    The TGK tridiagonal of the bidiagonal {d, e} has zero diagonal and
    off-diagonals ``z = (d1, e1, d2, e2, ..., d_n)``; its eigenvalues are
    ``+/- sigma``.  Returns ``(z2, bound)`` with ``z2 = max(z*z, tiny)`` (the
    ``tiny`` floor decouples exact splits safely) and ``bound`` a 0-d tensor
    above every sigma.
    """
    n = d.shape[0]
    dtype = d.dtype
    z = d.new_zeros((2 * n - 1,))
    z[0::2] = d
    z[1::2] = e
    z2 = torch.clamp_min(z * z, torch.finfo(dtype).tiny)
    azp = torch.nn.functional.pad(torch.abs(z), (1, 1))
    bound = torch.max(azp[:-1] + azp[1:]) * (1 + 4 * torch.finfo(dtype).eps)
    return z2, bound


def default_bisect_iters(dtype, probes=1):
    """Sweeps for eps-plus-12-bit absolute resolution of the bound:
    ``ceil((-log2 eps + 12) / log2(probes + 1))``."""
    bits = math.ceil(-math.log2(torch.finfo(dtype).eps)) + 12
    return math.ceil(bits / math.log2(probes + 1))


def bisect_svdvals(d, e, iters=None):
    """Singular values of the bidiagonal {d, e} by parallel bisection,
    descending.

    All ``n`` values are bisected simultaneously on the Golub-Kahan
    tridiagonal: one step evaluates a one-sided Sturm pivot count
    ``p <- -lam - z_i^2 / p`` over ``2n - 1`` steps for the n shifts at once.
    Accuracy is absolute, ``~||B|| * 2**-iters``.  Relies on IEEE division
    (a zero pivot gives ``-inf``, counted negative, and the next step
    recovers), so no pivot guard is needed.
    """
    n = d.shape[0]
    if n == 1:
        return torch.abs(d)
    if iters is None:
        iters = default_bisect_iters(d.dtype)
    z2, bound = tgk_z2_and_bound(d, e)
    zs = z2.unbind()  # 0-d views: no indexing op per recurrence step
    lo = d.new_zeros((n,))
    hi = bound.expand(n).clone()
    ks = torch.arange(n, device=d.device)  # lane j targets the j-th smallest
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        p = -mid
        cnt = (p < 0).to(torch.int32)
        for i in range(1, 2 * n):
            p = -mid - zs[i - 1] / p
            cnt += p < 0
        above = (cnt - n) > ks  # TGK eigs below mid minus the n negative ones
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    return (0.5 * (lo + hi)).flip(0)
