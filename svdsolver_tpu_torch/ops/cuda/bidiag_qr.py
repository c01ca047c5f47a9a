"""The QR diagonalizer on the card (``csrc/bidiag_qr.cu``): implicit-shift
QR with deflation on a bidiagonal, each loop in one launch.

It stands for no TPU kernel: the JAX package's ``zero_shift_sweep``,
``shifted_sweep``, ``diag_reduce_fixed_iter``, ``convergence_threshold``
and the ``lax.while_loop`` of ``_qr_diag_chunk``
(``svdsolver_tpu/models/diagonalize.py:27-226``) are loops XLA compiles to
one device program; in PyTorch only a kernel keeps them on the card.  Two
entries: :func:`sweeps` (``n_iter`` zero-shift sweeps or one shifted sweep
on ``[lo, hi]``: :func:`zero_shift_sweep`, :func:`shifted_sweep`,
:func:`diag_reduce_fixed_iter`) and the converged driver
(:func:`converge`: :func:`bidiagonal_svdvals`,
:func:`convergence_threshold`), which computes the threshold in its
prologue and runs the deflation loop to convergence or ``max_sweeps``.
These public functions take the JAX package's names and signatures, and
this module is where the device choice is made.

The kernel takes float32 and float64 CUDA tensors, wider than the main
paths' ``use_kernels`` (float32 only): the diagonalizers are sequential
scalar recurrences, so the plain version on a CUDA tensor costs a launch an
operation in any dtype.  d and e live in shared memory where they fit
(:func:`memory_instance`), in device memory otherwise, with the same bits.
CPU tensors run the plain versions of ``models/diagonalize.py``.
:func:`chain_ns` times a sweep's dependent chain alone (the chain bound,
:func:`chain_bound_ms`).
"""

import torch

from svdsolver_tpu_torch.models import diagonalize as dg
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # converged-driver launches (bidiagonal_svdvals, threshold)
launches_sweeps = 0  # sweep-entry launches (the sweeps, diag_reduce_fixed_iter)

THREADS = 256  # the converged driver's block: the passes between sweeps
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L, _D = _build.VOIDP, _build.INT, _build.LONG, _build.DOUBLE
_ENTRIES = {
    **{f"svdt_bidiag_qr_sweeps_{s}": [_P, _P, _I, _I, _I, _I, _P, _I, _P]
       for s in _DTYPES.values()},
    **{f"svdt_bidiag_qr_converge_{s}": [_P, _P, _I, _P, _I, _D, _I, _P, _I, _P]
       for s in _DTYPES.values()},
    **{f"svdt_bidiag_qr_chain_{s}": [_P, _L, _I, _P] for s in _DTYPES.values()},
}
CHAINS = ("zero", "shifted")  # the chain entry's kinds: zero-shift and shifted steps


def memory_instance(n, dtype, reduction=True):
    """``"smem"`` where d, e and (for the converged driver, ``reduction``)
    the threshold's reduction (2 values a thread of ``THREADS``) fit one
    block's shared memory beside the kernel's static shared variables, else
    ``"global"``: n <= 28,672 in float32 and 14,208 in float64."""
    size = torch.finfo(dtype).bits // 8
    fits = size * (2 * n + 2 * THREADS * reduction) + _build.STATIC_SMEM <= _build.MAX_SMEM
    return "smem" if fits else "global"


def _smem(n, dtype, reduction, memory):
    if memory is None:
        memory = memory_instance(n, dtype, reduction)
    if memory not in ("smem", "global"):
        raise ValueError(f"memory must be 'smem' or 'global', got {memory!r}")
    if memory == "smem" and memory_instance(n, dtype, reduction) != "smem":
        raise ValueError(f"n={n} does not fit shared memory in {dtype}")
    return int(memory == "smem")


def _launch(entry, d, *args):
    """Launch ``entry`` (``"sweeps"`` or ``"converge"``) of the kernel for
    d's dtype on d's device and stream, tensors passed as their pointers;
    raises if the launch fails."""
    lib = _build.load("bidiag_qr", _ENTRIES)
    fn = getattr(lib, f"svdt_bidiag_qr_{entry}_{_DTYPES[d.dtype]}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in (d, *args)]
    with torch.cuda.device(d.device):
        err = fn(*ptrs, _build.stream_of(d))
    _build.raise_on_error(err, f"bidiag_qr {entry}")


def sweeps(d, e, lo=None, hi=None, n_iter=1, shift=None, _memory=None):
    """``n_iter`` zero-shift sweeps on ``d[lo:hi+1]`` (default the full
    range), or with ``shift`` one shifted sweep; returns new ``(d, e)``.
    CUDA: one launch of the sweep entry; CPU: the plain sweeps."""
    global launches_sweeps
    on_card = _build.check_bidiagonal(d, e, tuple(_DTYPES))
    n = d.shape[0]
    lo = 0 if lo is None else int(lo)
    hi = n - 1 if hi is None else int(hi)
    if not 0 <= lo <= n - 1 or not 0 <= hi <= n - 1:
        raise ValueError(f"need 0 <= lo, hi <= {n - 1}, got lo={lo} hi={hi}")
    if not on_card:
        if shift is not None:
            return dg.shifted_sweep_plain(d, e, lo, hi, shift)
        d, e = d.clone(), e.clone()
        for _ in range(int(n_iter)):
            d, e = dg.zero_shift_sweep_plain(d, e, lo, hi)
        return d, e
    d, e = d.contiguous().clone(), e.contiguous().clone()
    if hi <= lo or (shift is None and int(n_iter) < 1):
        return d, e
    if shift is not None:
        shift = torch.as_tensor(shift, dtype=d.dtype, device=d.device).reshape(1).contiguous()
    smem = _smem(n, d.dtype, False, _memory)
    _launch("sweeps", d, e, n, lo, hi, int(n_iter), shift, smem)
    launches_sweeps += 1
    return d, e


def zero_shift_sweep(d, e, lo=None, hi=None):
    """One implicit zero-shift QR sweep over ``d[lo:hi+1]`` (default the full
    range); returns new ``(d, e)``.  CUDA: one launch of the sweep entry;
    CPU: :func:`~svdsolver_tpu_torch.models.diagonalize.zero_shift_sweep_plain`."""
    return sweeps(d, e, lo, hi)


def shifted_sweep(d, e, lo, hi, shift):
    """One implicit-shift QR sweep (LAPACK ``dbdsqr``'s shifted forward path)
    on ``d[lo:hi+1]``; returns new ``(d, e)``.  CUDA: one launch of the
    sweep entry; CPU: the plain sweep."""
    return sweeps(d, e, lo, hi, shift=shift)


def diag_reduce_fixed_iter(d, e, n_iter=200):
    """``n_iter`` unconditional full zero-shift sweeps (reference:
    svd_serial.h:348-353); benchmark-only, use :func:`bidiagonal_svdvals`
    for convergence.  CUDA: one launch of the sweep entry."""
    return sweeps(d, e, n_iter=n_iter)


def _check_n(d):
    if d.shape[0] < 2:
        raise ValueError(f"the threshold needs n >= 2 (an e entry), got n={d.shape[0]}")


def converge(d, e, max_sweeps=None, chunk_sweeps=None, tol_factor=100.0, _memory=None):
    """The converged driver on CUDA tensors (n >= 2): returns ``(d, e,
    thresh, info)`` with ``info = [sweeps, converged, zero-shift steps,
    shifted steps]`` (int64 on the card; a step is one Givens pair of a
    sweep).  One launch runs up to ``max_sweeps`` (default ``30 n``) sweeps;
    ``chunk_sweeps`` splits them into launches of at most that many, each
    resuming where the last stopped (one host sync a launch, to stop at
    convergence)."""
    global launches
    _check_n(d)
    n = d.shape[0]
    max_sweeps = 30 * n if max_sweeps is None else int(max_sweeps)
    chunk = max_sweeps if chunk_sweeps is None else max(int(chunk_sweeps), 1)
    smem = _smem(n, d.dtype, True, _memory)
    d, e = d.contiguous().clone(), e.contiguous().clone()
    thresh = torch.empty((1,), dtype=d.dtype, device=d.device)
    info = torch.zeros((4,), dtype=torch.int64, device=d.device)
    done = 0
    while True:
        k = min(chunk, max_sweeps - done)
        _launch("converge", d, e, n, thresh, int(done == 0), float(tol_factor), k, info, smem)
        launches += 1
        done += k
        if done >= max_sweeps or bool(info[1]):
            return d, e, thresh.reshape(()), info


def chain_ns(dtype, kind, steps=1 << 20):
    """ns a step of a QR sweep's dependent chain alone on the card
    (``svdt_bidiag_qr_chain_*``: one thread, operands in registers, no
    memory); ``kind`` ``"zero"`` (zero-shift steps, rot1's chain overlapping
    rot2's) or ``"shifted"``, timed over ``steps`` steps (rounded down to a
    multiple of 8); float32 or float64."""
    lib = _build.load("bidiag_qr", _ENTRIES)
    fn = getattr(lib, f"svdt_bidiag_qr_chain_{_DTYPES[dtype]}")
    return _build.chain_ns(fn, dtype, steps - steps % 8, CHAINS.index(kind))


def chain_bound_ms(steps_zero, steps_shift, ns_zero, ns_shift):
    """The chain bound of a run, in ms: its zero-shift and shifted steps
    (``converge``'s ``info[2]``, ``info[3]``), each times its own ns a
    step."""
    return (steps_zero * ns_zero + steps_shift * ns_shift) / 1e6


def convergence_threshold(d, e, tol_factor=100.0, _memory=None):
    """Demmel-Kahan deflation threshold with the absolute floor
    (:func:`~svdsolver_tpu_torch.models.diagonalize.convergence_threshold_plain`),
    a 0-d tensor: the driver's prologue on CUDA tensors (a launch with no
    sweep), the plain version on CPU tensors.  Needs n >= 2."""
    _check_n(d)
    if not _build.check_bidiagonal(d, e, tuple(_DTYPES)):
        return dg.convergence_threshold_plain(d, e, tol_factor)
    return converge(d, e, max_sweeps=0, tol_factor=tol_factor, _memory=_memory)[2]


def bidiagonal_svdvals(d, e, max_sweeps=None, chunk_sweeps=None, _memory=None):
    """Singular values of the bidiagonal {d, e}, sorted descending.

    Convergent QR diagonalization with deflation, the reference's ``qrd``
    (svd_serial.h:367-422): negligible ``|e[i]| <= threshold`` entries are
    hard-zeroed, the bottom-most unreduced block ``[lo, hi]`` located, and
    one shifted (or zero-shift) sweep run on it, until nothing is live or
    ``max_sweeps`` (default ``30 n``) sweeps ran.

    A CUDA tensor (float32 or float64) runs the whole loop in one launch
    (:func:`converge`); ``chunk_sweeps`` splits it into launches of at most
    that many sweeps (the JAX package chunks to keep each TPU program under
    a worker watchdog; no such limit is known on the card), with the same
    result.  A CPU tensor runs the plain version.
    """
    if not _build.check_bidiagonal(d, e, tuple(_DTYPES)):
        return dg.bidiagonal_svdvals_plain(d, e, max_sweeps, chunk_sweeps)
    if d.shape[0] == 1:
        return torch.abs(d)
    d, *_ = converge(d, e, max_sweeps, chunk_sweeps, _memory=_memory)
    return torch.sort(torch.abs(d)).values.flip(0)
