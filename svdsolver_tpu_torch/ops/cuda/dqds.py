"""The dqds diagonalizer on the card (``csrc/dqds.cu``): the state machine
of ``dqds_svdvals`` (split, dlasq3 deflation, CBIAS flip, dlasq4 shifts,
failure retries, stuck guard) in one launch.

It stands for no TPU kernel: the JAX package's ``dqds_svdvals`` is a
``lax.while_loop`` (``svdsolver_tpu/models/diagonalize.py:280``, the loop
at :958) that XLA compiles to one device program.  The wrapper scales
{d, e} to the qd arrays and turns the kernel's eigenvalue estimates into
singular values with the plain version's own torch ops
(``dqds_prepare``, ``dqds_finish``), so its result is bit-equal to
:func:`~svdsolver_tpu_torch.models.diagonalize.dqds_svdvals_plain`.

The kernel returns the estimates, ``hi`` (below 0 when every eigenvalue
deflated), the sweep count and the shift-type histogram.  The wrapper
reads them (one sync); when ``hi >= 0`` the run ended unconverged and the
algorithm's own safety net, the bisection on the same {d, e}, gives the
values (``dqds_finish``, counted by ``diagonalize.safety_nets``; on a
float32 tensor the ``bisect`` kernel, else the plain bisection).  It
takes float32 and float64 CUDA tensors (dqds exists for float64 relative
accuracy).  The kernel keeps two (q, E) pairs, a sweep reading one and
writing the other, and the accumulated shifts: 5n values, in shared
memory where they fit (:func:`memory_instance`: n <= 11,571 in float32,
5,785 in float64), else in a device workspace the wrapper allocates, with
the same code and the same bits.  CPU tensors run the plain version.
:func:`chain_ns` times the sweep's dependent chain alone (the chain
bound, :func:`chain_bound_ms`).
"""

import torch

from svdsolver_tpu_torch.models import diagonalize as dg
from svdsolver_tpu_torch.ops.cuda import _build, bisect

launches = 0  # dqds kernel launches since the last reset

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L = _build.VOIDP, _build.INT, _build.LONG
_ENTRIES = {
    **{f"svdt_dqds_{s}": [_P] * 4 + [_I, _I, _P, _I, _P] for s in _DTYPES.values()},
    **{f"svdt_dqds_chain_{s}": [_P, _L, _P] for s in _DTYPES.values()},
}
FOOTPRINT = 5  # values an entry: the two (q, E) pairs and the accumulated shifts


def memory_instance(n, dtype):
    """``"smem"`` where the kernel's 5n values fit one block's shared
    memory beside its static shared variables: n <= 11,571 in float32 and
    5,785 in float64; else ``"global"``."""
    size = torch.finfo(dtype).bits // 8
    fits = size * FOOTPRINT * n + _build.STATIC_SMEM <= _build.MAX_SMEM
    return "smem" if fits else "global"


def _launch(q, *args):
    """Launch the kernel for q's dtype on q's device and stream, tensors
    passed as their pointers; raises if the launch fails."""
    lib = _build.load("dqds", _ENTRIES)
    fn = getattr(lib, f"svdt_dqds_{_DTYPES[q.dtype]}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in (q, *args)]
    with torch.cuda.device(q.device):
        err = fn(*ptrs, _build.stream_of(q))
    _build.raise_on_error(err, "dqds")


last_steps = 0  # dqds steps (window entries swept, retries included) of the last launch


def dqds_loop(q, E, max_sweeps, _memory=None):
    """One launch of the loop on the scaled qd arrays (CUDA tensors):
    returns ``(out, hi, sweeps, histogram)``, ``hi``, ``sweeps`` and the 19
    bins read to the host (the steps to ``last_steps``)."""
    global launches, last_steps
    n = q.shape[0]
    memory = memory_instance(n, q.dtype) if _memory is None else _memory
    if memory not in ("smem", "global"):
        raise ValueError(f"memory must be 'smem' or 'global', got {memory!r}")
    if memory == "smem" and memory_instance(n, q.dtype) != "smem":
        raise ValueError(f"n={n} does not fit shared memory in {q.dtype}")
    q, E = q.contiguous(), E.contiguous()  # read only: the kernel works on its own pairs
    out = torch.zeros_like(q)
    work = None if memory == "smem" else q.new_empty((FOOTPRINT * n,))
    info = torch.zeros((3 + dg.HIST_BINS,), dtype=torch.int64, device=q.device)
    _launch(q, E, out, work, n, int(max_sweeps), info, int(memory == "smem"))
    launches += 1
    info = info.tolist()
    last_steps = info[2]
    return out, info[0], info[1], info[3:]


def chain_ns(dtype, steps=1 << 22):
    """ns a step of the dqds sweep's dependent chain alone on the card
    (``svdt_dqds_chain_*``: ``dd <- dd * (q / (dd + E)) - tau`` on one
    thread from registers, no memory), timed over ``steps`` steps (rounded
    down to a multiple of 8); float32 or float64."""
    lib = _build.load("dqds", _ENTRIES)
    fn = getattr(lib, f"svdt_dqds_chain_{_DTYPES[dtype]}")
    return _build.chain_ns(fn, dtype, steps - steps % 8)


def chain_bound_ms(steps, ns):
    """The chain bound of a run: its dqds steps (every sweep run, retries
    included) times ``ns`` a step, in ms."""
    return steps * ns / 1e6


def dqds_svdvals(d, e, max_sweeps=None, with_info=False, _memory=None):
    """Singular values by differential qd with shifts (Fernando-Parlett
    dqds, the LAPACK ``dlasq`` class), sorted descending; high RELATIVE
    accuracy on graded spectra.

    Works on scaled ``q = d^2``, ``E = e^2``.  Each iteration: hard-zero
    negligible E and SPLIT at the bottom-most zero (dlasq2), run dlasq3's
    deflation loop (one eigenvalue, or the trailing 2x2 exactly), flip a
    window with its large values at the bottom (dlasq2's CBIAS), pick the
    shift with dlasq4's battery (cases 2-11 and their Rayleigh-residual
    loops, the case-6 G history), run one sweep; a sweep that loses
    positivity is retried at ``tau + dmin``, then at 0.  No deflation in 60
    sweeps, a failed zero-shift sweep, or ``max_sweeps`` (default ``60 n``)
    ends the loop unconverged, and the bisection gives the values (the
    normwise safety net, counted by ``diagonalize.safety_nets``).  The JAX
    package's docstring (``diagonalize.py:281-346``) has the measurements.

    ``with_info=True`` returns ``(sigma, sweeps)``; ``"debug"`` adds the
    histogram of dlasq4 shift types (19 bins, indexed by ``-ttype``: 18 the
    corrected retries, 0 the zero-shift fallbacks).  A CUDA tensor (float32
    or float64) runs the loop in one launch of the kernel; a CPU tensor
    :func:`~svdsolver_tpu_torch.models.diagonalize.dqds_svdvals_plain`.  At
    n = 1 the info is 0 sweeps and an empty histogram (the JAX package
    returns only sigma there).
    """
    if not _build.check_bidiagonal(d, e, tuple(_DTYPES)):
        return dg.dqds_svdvals_plain(d, e, max_sweeps, with_info)
    n = d.shape[0]
    if n == 1:
        return dg.dqds_svdvals_plain(d, e, max_sweeps, with_info)
    max_sweeps = 60 * n if max_sweeps is None else int(max_sweeps)
    q0, E0, scale = dg.dqds_prepare(d, e)
    out, hi, sweeps, th = dqds_loop(q0, E0, max_sweeps, _memory)
    net = bisect.bisect_svdvals if d.dtype == torch.float32 else dg.bisect_svdvals
    sig = dg.dqds_finish(d, e, out, hi, scale, net)
    return dg.dqds_result(sig, sweeps, th, d, with_info)
