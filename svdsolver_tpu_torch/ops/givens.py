"""Stable Givens rotation parameters, branchless (twin of
``svdsolver_tpu/ops/givens.py``).

The reference's three-branch ``rotate()`` (svd_serial.h:277-297) computed
with ``torch.where`` selects, in the inputs' dtype.  ``csrc/givens.cuh``
is the kernels' twin: the same cases, guards and order of operations, so a
kernel's rotation is bit-equal to this one on the same inputs.
"""

import torch


def givens(f, g):
    """Return ``(c, s, r)`` with ``[c s; -s c]^T [f; g] = [r; 0]``.

    Branches (matching svd_serial.h:277):
      * ``f == 0``          -> (0, 1, g)
      * ``|f| > |g|``       -> t = g/f, tt = sqrt(1+t^2); (1/tt, t/tt, f*tt)
      * otherwise           -> t = f/g, tt = sqrt(1+t^2); (t/tt, 1/tt, g*tt)

    ``f`` and ``g`` are tensors (any matching shape) or numbers; numbers
    take the default dtype.
    """
    f = torch.as_tensor(f)
    g = torch.as_tensor(g, device=f.device)
    dtype = torch.promote_types(f.dtype, g.dtype)
    f, g = f.to(dtype), g.to(dtype)
    one = torch.ones((), dtype=dtype, device=f.device)
    return rotation(f, g, one, one - one)


def rotation(f, g, one, zero):
    """:func:`givens` on tensors ``f``, ``g`` of one dtype, with that
    dtype's ``one`` and ``zero`` given (the sweeps' inner step)."""
    f_dom = torch.abs(f) > torch.abs(g)
    f_zero = f == 0

    safe_f = torch.where(f_zero, one, f)
    safe_g = torch.where(g == 0, one, g)

    # |f| > |g| branch
    t1 = g / safe_f
    tt1 = torch.sqrt(t1 * t1 + 1)
    c1, s1, r1 = one / tt1, t1 / tt1, f * tt1

    # |g| >= |f| branch
    t2 = f / safe_g
    tt2 = torch.sqrt(t2 * t2 + 1)
    c2, s2, r2 = t2 / tt2, one / tt2, g * tt2

    c = torch.where(f_dom, c1, c2)
    s = torch.where(f_dom, s1, s2)
    r = torch.where(f_dom, r1, r2)

    # f == 0 branch (covers g == 0 too: -> (0, 1, 0))
    c = torch.where(f_zero, zero, c)
    s = torch.where(f_zero, one, s)
    r = torch.where(f_zero, g, r)
    return c, s, r
