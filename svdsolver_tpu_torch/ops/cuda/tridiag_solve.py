"""The shifted Golub-Kahan tridiagonal solve of inverse iteration in one
launch (``csrc/tridiag_solve.cu``).

One Hopper kernel stands for the TPU's forward and backward kernels,
``svdsolver_tpu/ops/pallas/tridiag_solve.py`` ``_fwd_kernel`` (LU with
partial pivoting, factor rows to device memory) and ``_bwd_kernel`` (back
substitution with the growth clip).  On the card one block serves a warp
of 32 lanes and stages the factor rows through shared memory in chunks of
``ROWS`` rows, ``SLOTS`` of them resident, U2 rebuilt from a per-row swap
word; :func:`tgk_solve_staged_plain` is that layout in PyTorch, bit-equal
to :func:`tgk_solve_plain`, the plain version and twin of
``tgk_solve_xla`` (``models/vectors.py``).  On a CPU tensor
:func:`tgk_solve` runs :func:`tgk_solve_plain`.
"""

import torch

from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # staged-kernel launches by tgk_solve since the last reset
launches_lane = 0  # launches of the first design (_staged=False)

ROWS = 32  # rows a chunk of the staged kernel (kRows)
SLOTS = 6  # chunks of factor rows its shared memory holds (kSlots)
LANES = 32  # lanes a block: one warp

_ENTRIES = {
    "svdt_tgk_solve": [_build.VOIDP] * 10 + [_build.INT] * 2 + [_build.VOIDP],
    "svdt_tgk_solve_staged": [_build.VOIDP] * 8 + [_build.INT] * 2 + [_build.VOIDP],
}


def _floor_pivot(p, pivmin):
    """Pivots below ``pivmin`` in magnitude become ``+-pivmin``."""
    sign = torch.where(p < 0, -torch.ones_like(pivmin), torch.ones_like(pivmin))
    return torch.where(torch.abs(p) < pivmin, sign * pivmin, p)


def _elimination_row(b, cc, y, bi, ai, ci, yi, pivmin):
    """One row of the forward pass: the partial-pivoting choice between the
    carried row (b, cc, y) and the next TGK row (ai, bi, ci, yi).  Returns
    the new carry and the factor row ``(U0, U1, U2, R)`` with ``swap``."""
    zero = torch.zeros_like(b)
    swap = torch.abs(ai) > torch.abs(b)
    p0 = torch.where(swap, ai, b)
    p1 = torch.where(swap, bi, cc)
    p2 = torch.where(swap, ci, zero)
    py = torch.where(swap, yi, y)
    q0 = torch.where(swap, b, ai)
    q1 = torch.where(swap, cc, bi)
    q2 = torch.where(swap, zero, ci)
    qy = torch.where(swap, y, yi)
    safe = _floor_pivot(p0, pivmin)
    mlt = q0 / safe
    carry = (q1 - mlt * p1, q2 - mlt * p2, qy - mlt * py)
    return carry, (safe, p1, p2, py), swap


def _back_row(R, U1, U2, U0, s1, s2, big):
    """One row of the back substitution, clipped to ``[-big, big]``
    (``torch.clamp`` keeps a NaN, as ``jnp.clip`` does)."""
    return torch.clamp((R - U1 * s1 - U2 * s2) / U0, -big, big)


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
    zero = rhs.new_zeros((k,))
    bi = -lam
    carry = (-lam, z[0].expand(k), rhs[0])
    U0, U1, U2, R = (rhs.new_empty((N, k)) for _ in range(4))
    zs = z.unbind()
    for r in range(N - 1):
        ci = zs[r + 1] if r + 1 < N - 1 else rhs.new_zeros(())
        carry, row, _ = _elimination_row(*carry, bi, zs[r], ci, rhs[r + 1], pivmin)
        U0[r], U1[r], U2[r], R[r] = row
    b, _, y = carry
    U0[N - 1], U1[N - 1], U2[N - 1], R[N - 1] = _floor_pivot(b, pivmin), zero, zero, y
    x = rhs.new_empty((N, k))
    s1 = s2 = zero
    for r in range(N - 1, -1, -1):
        x[r] = _back_row(R[r], U1[r], U2[r], U0[r], s1, s2, big)
        s1, s2 = x[r], s1
    return x


def tgk_solve_staged_plain(z, lam, rhs, pivmin, big, rows=ROWS, slots=SLOTS):
    """The staged kernel's layout in PyTorch, bit-equal to
    :func:`tgk_solve_plain`: the lanes padded to warps of ``LANES``; the
    forward pass keeps U0, U1 and R of each chunk of ``rows`` rows, and in
    place of U2 one swap word a row and warp (bit j: lane j pivoted on the
    next row); every chunk but the last ``slots`` goes to a scratch laid
    out (array, warp, row, lane); the backward pass reads the resident
    chunks, then the scratch, and rebuilds U2 as ``swap ? z[r+1] : 0``."""
    N, k = rhs.shape
    W = -(-k // LANES)
    kp = W * LANES
    pivmin = torch.as_tensor(pivmin, dtype=rhs.dtype, device=rhs.device)
    big = torch.as_tensor(big, dtype=rhs.dtype, device=rhs.device)
    zero = rhs.new_zeros((kp,))
    lam = torch.nn.functional.pad(lam, (0, kp - k))
    rhs = torch.nn.functional.pad(rhs, (0, kp - k))
    bitpos = torch.arange(LANES, device=rhs.device, dtype=torch.int64)

    def pack(swap):  # the __ballot_sync of each warp
        return (swap.reshape(W, LANES).to(torch.int64) << bitpos).sum(1)

    def unpack(word):
        return ((word[:, None] >> bitpos) & 1).bool().reshape(kp)

    C = -(-N // rows)
    resident_from = max(0, C - slots)
    F = rhs.new_empty((3, W, N, LANES))  # device-memory scratch
    S = torch.empty((W, N), dtype=torch.int64, device=rhs.device)
    kept = {}  # chunk -> its rows (U0, U1, R, swap word, zn), as in shared memory
    zs = z.unbind()
    bi = -lam
    carry = (-lam, z[0].expand(kp), rhs[0])
    for c in range(C):
        chunk = []
        for r in range(c * rows, min((c + 1) * rows, N)):
            if r == N - 1:
                b, _, y = carry
                chunk.append((_floor_pivot(b, pivmin), zero, y, pack(zero != zero),
                              rhs.new_zeros(())))
                continue
            ci = zs[r + 1] if r + 1 < N - 1 else rhs.new_zeros(())
            carry, (safe, p1, _, py), swap = _elimination_row(
                *carry, bi, zs[r], ci, rhs[r + 1], pivmin)
            chunk.append((safe, p1, py, pack(swap), ci))
        if c >= resident_from:
            kept[c] = chunk
        else:  # stored, and read back by the backward pass
            for i, (u0, u1, R, word, _) in enumerate(chunk):
                r = c * rows + i
                F[0, :, r], F[1, :, r], F[2, :, r] = (
                    t.reshape(W, LANES) for t in (u0, u1, R))
                S[:, r] = word
    x = rhs.new_empty((N, kp))
    s1 = s2 = zero
    for c in range(C - 1, -1, -1):
        if c in kept:
            chunk = kept.pop(c)
        else:
            chunk = []
            for r in range(c * rows, min((c + 1) * rows, N)):
                zn = zs[r + 1] if r + 1 < N - 1 else rhs.new_zeros(())
                chunk.append((F[0, :, r].reshape(kp), F[1, :, r].reshape(kp),
                              F[2, :, r].reshape(kp), S[:, r], zn))
        for i in range(len(chunk) - 1, -1, -1):
            u0, u1, R, word, zn = chunk[i]
            u2 = torch.where(unpack(word), zn, zero)
            x[c * rows + i] = _back_row(R, u1, u2, u0, s1, s2, big)
            s1, s2 = x[c * rows + i], s1
    return x[:, :k]


def tgk_solve(z, lam, rhs, pivmin, big, _staged=True):
    """The shifted TGK solve of :func:`tgk_solve_plain`, in one launch.

    CUDA tensors must be contiguous float32: ``z`` (N-1,), ``lam`` (k,),
    ``rhs`` (N, k), and ``pivmin``, ``big`` 0-d or one-element tensors on
    the same device (kept there: no host sync).  They launch the staged
    kernel (counted by ``launches``), any k; ``_staged=False`` launches the
    first design, for timings in turns (``launches_lane``).  Both give the
    same bits.  CPU tensors run the plain version.
    """
    global launches, launches_lane
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
    x = torch.empty_like(rhs)
    lib = _build.load("tridiag_solve", _ENTRIES)
    head = (z.data_ptr(), lam.data_ptr(), rhs.data_ptr(), scal[0].data_ptr(),
            scal[1].data_ptr())
    with torch.cuda.device(rhs.device):
        if _staged:
            W = -(-k // LANES)
            F = torch.empty((3, W, N, LANES), dtype=rhs.dtype, device=rhs.device)
            S = torch.empty((W, N), dtype=torch.int32, device=rhs.device)
            err = lib.svdt_tgk_solve_staged(
                *head, F.data_ptr(), S.data_ptr(), x.data_ptr(), N, k,
                _build.stream_of(rhs))
        else:
            U0, U1, U2, R = torch.empty((4, N, k), dtype=rhs.dtype, device=rhs.device)
            err = lib.svdt_tgk_solve(
                *head, U0.data_ptr(), U1.data_ptr(), U2.data_ptr(), R.data_ptr(),
                x.data_ptr(), N, k, _build.stream_of(rhs))
    _build.raise_on_error(err, "tridiag_solve")
    if _staged:
        launches += 1
    else:
        launches_lane += 1
    return x
