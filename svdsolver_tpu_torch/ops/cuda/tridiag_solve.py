"""The shifted Golub-Kahan tridiagonal solve of inverse iteration in one
launch (``csrc/tridiag_solve.cu``).

One Hopper kernel stands for the TPU's forward and backward kernels,
``svdsolver_tpu/ops/pallas/tridiag_solve.py`` ``_fwd_kernel`` (LU with
partial pivoting, factor rows to device memory) and ``_bwd_kernel`` (back
substitution with the growth clip).  :func:`tgk_solve_plain` is its plain
version, the twin of ``tgk_solve_xla`` (``models/vectors.py``); on a CPU
tensor :func:`tgk_solve` runs that.
"""

import torch

from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by tgk_solve since the last reset

_ENTRIES = {
    "svdt_tgk_solve": [_build.VOIDP] * 10 + [_build.INT] * 2 + [_build.VOIDP],
}


def tgk_solve_plain(z, lam, rhs, pivmin, big):
    """``(TGK - diag-per-lane(lam)) x = rhs`` for all lanes at once:
    tridiagonal LU with partial pivoting (band-2 upper factor), then back
    substitution with the solution clipped to ``[-big, big]``.

    ``z`` (N-1,): TGK off-diagonals; ``lam`` (k,): per-lane shifts; ``rhs``
    (N, k); ``pivmin``, ``big``: 0-d tensors or floats.  Pivots below
    ``pivmin`` in magnitude are floored to it with their sign.  The generic
    elimination's third carry is identically zero for a tridiagonal, so only
    ``p2 = swap ? z[r+1] : 0`` is kept, as the TPU kernel does.  The last
    factor row is ``(clamped b, 0, 0, y)``.
    """
    N, k = rhs.shape
    pivmin = torch.as_tensor(pivmin, dtype=rhs.dtype, device=rhs.device)
    big = torch.as_tensor(big, dtype=rhs.dtype, device=rhs.device)
    one = rhs.new_ones(())
    zero = rhs.new_zeros((k,))

    def floor(p):
        sign = torch.where(p < 0, -one, one)
        return torch.where(torch.abs(p) < pivmin, sign * pivmin, p)

    bi = -lam
    b, cc, y = -lam, z[0].expand(k), rhs[0]
    U0, U1, U2, R = (rhs.new_empty((N, k)) for _ in range(4))
    zs = z.unbind()
    for r in range(N - 1):
        ai = zs[r]
        ci = zs[r + 1] if r + 1 < N - 1 else rhs.new_zeros(())
        yi = rhs[r + 1]
        swap = torch.abs(ai) > torch.abs(b)
        p0 = torch.where(swap, ai, b)
        p1 = torch.where(swap, bi, cc)
        p2 = torch.where(swap, ci, zero)
        py = torch.where(swap, yi, y)
        q0 = torch.where(swap, b, ai)
        q1 = torch.where(swap, cc, bi)
        q2 = torch.where(swap, zero, ci)
        qy = torch.where(swap, y, yi)
        safe = floor(p0)
        mlt = q0 / safe
        b, cc, y = q1 - mlt * p1, q2 - mlt * p2, qy - mlt * py
        U0[r], U1[r], U2[r], R[r] = safe, p1, p2, py
    U0[N - 1], U1[N - 1], U2[N - 1], R[N - 1] = floor(b), zero, zero, y
    x = rhs.new_empty((N, k))
    s1 = s2 = zero
    for r in range(N - 1, -1, -1):
        v = (R[r] - U1[r] * s1 - U2[r] * s2) / U0[r]
        v = torch.clamp(v, -big, big)  # propagates NaN, as jnp.clip does
        x[r] = v
        s1, s2 = v, s1
    return x


def tgk_solve(z, lam, rhs, pivmin, big):
    """The shifted TGK solve of :func:`tgk_solve_plain`, in one launch.

    CUDA tensors must be contiguous float32: ``z`` (N-1,), ``lam`` (k,),
    ``rhs`` (N, k), and ``pivmin``, ``big`` 0-d or one-element tensors on
    the same device (kept there: no host sync).  CPU tensors run the plain
    version.
    """
    global launches
    on_card = _build.check_input(rhs, "rhs", 2)
    _build.check_input(z, "z", 1)
    _build.check_input(lam, "lam", 1)
    N, k = rhs.shape
    if z.shape[0] != N - 1 or lam.shape[0] != k:
        raise ValueError(
            f"need z ({N - 1},) and lam ({k},) for rhs {tuple(rhs.shape)}, "
            f"got {tuple(z.shape)} and {tuple(lam.shape)}"
        )
    if z.device != rhs.device or lam.device != rhs.device:
        raise ValueError("z, lam and rhs must share a device")
    if not on_card:
        return tgk_solve_plain(z, lam, rhs, pivmin, big)
    if N < 2:
        raise ValueError("the TGK solve needs N >= 2 rows")
    scal = [
        torch.as_tensor(t, dtype=rhs.dtype, device=rhs.device).reshape(1)
        for t in (pivmin, big)
    ]
    U0, U1, U2, R = torch.empty((4, N, k), dtype=rhs.dtype, device=rhs.device)
    x = torch.empty_like(rhs)
    lib = _build.load("tridiag_solve", _ENTRIES)
    with torch.cuda.device(rhs.device):
        err = lib.svdt_tgk_solve(
            z.data_ptr(), lam.data_ptr(), rhs.data_ptr(), scal[0].data_ptr(),
            scal[1].data_ptr(), U0.data_ptr(), U1.data_ptr(), U2.data_ptr(),
            R.data_ptr(), x.data_ptr(), N, k, _build.stream_of(rhs),
        )
    _build.raise_on_error(err, "tridiag_solve")
    launches += 1
    return x
