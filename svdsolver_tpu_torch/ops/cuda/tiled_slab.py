"""The tiled Stage I's slab factorization on the card
(``csrc/tiled_slab.cu``), and the public ``dense_to_band_tiled``.

It stands for no TPU kernel: the JAX package's ``_factor_1slab`` and
``_factor_2slab`` (``svdsolver_tpu/models/tiled.py:59``, ``:72``) are a
``lax.fori_loop`` over ``_slab_factor_step`` (``:33``) that XLA compiles
to one device program; as plain PyTorch launches a step is ~20 of them.
:func:`factor_slab` runs the ``t`` steps of one slab in one launch on a
float32 CUDA tensor and the plain version (``models/tiled._factor_slab``)
on a CPU tensor.  :func:`dense_to_band_tiled` runs the tiled schedule
(``models/tiled.tile_sweeps``) on either: on the card ``(n / t)^2``
launches (the LQ half on a transposed contiguous copy, made once a tile
sweep), on the CPU the plain version.  The kernel's plan
(:func:`slab_plan`) is plain Python; a ``t`` whose pivot block does not fit
one block's shared memory raises ``ValueError`` before any launch.
"""

from typing import NamedTuple

import torch

from svdsolver_tpu_torch.models import tiled
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by factor_slab since the last reset

ROWS_PER_LANE = (1, 2, 4, 8, 11)  # the kernel's instances: rows of a column a lane holds
_P, _I = _build.VOIDP, _build.INT
_ENTRIES = {"svdt_tiled_slab": [_P] + [_I] * 10 + [_P, _P]}


class SlabPlan(NamedTuple):
    """How the kernel cuts a slab of ``rows`` rows: ``width`` columns a CTA
    beside the pivot block, ``ctas`` CTAs, ``rpl`` rows a lane (its
    instance), ``smem`` dynamic shared-memory bytes a CTA."""

    width: int
    ctas: int
    rpl: int
    smem: int


def _smem_bytes(t, rows, width):
    """The pivot block and the chunk, column stride rows + 1, and two (v,
    tau) buffers."""
    return 4 * ((t + width) * (rows + 1) + 2 * rows + 2)


def slab_plan(n, t, rows, sms):
    """The kernel's launch for a slab of ``rows`` (``t`` or ``2t``) rows and
    ``n`` columns on a card of ``sms`` multiprocessors: chunks of
    ``ceil((n - t) / sms)`` columns (at least 1, at most what fits), one CTA
    each.  Raises ``ValueError`` when the pivot
    block (``rows x t`` floats) and one chunk column leave the shared-memory
    limit (``_build.MAX_SMEM`` less ``_build.STATIC_SMEM``): ``t`` above 168
    for a TS slab (``2t`` rows), above 238 for a diagonal one."""
    n, t, rows = int(n), int(t), int(rows)
    if not 1 <= t <= n or rows not in (t, 2 * t):
        raise ValueError(f"slab of {rows} rows, t={t}, n={n}: need 1 <= t <= n, rows t or 2t")
    room = _build.MAX_SMEM - _build.STATIC_SMEM
    wmax = (room // 4 - 2 * rows - 2) // (rows + 1) - t
    if wmax < 1:
        raise ValueError(
            f"t={t}: the pivot block of {rows} x {t} floats ({4 * rows * t} bytes) and a "
            f"chunk column pass the {room}-byte shared-memory limit of one block "
            f"(MAX_SMEM {_build.MAX_SMEM} less {_build.STATIC_SMEM} static)")
    other = n - t
    width = max(1, min(wmax, -(-other // max(int(sms), 1))))
    ctas = max(1, -(-other // width))
    rpl = next(r for r in ROWS_PER_LANE if 32 * r >= rows)
    return SlabPlan(width, ctas, rpl, _smem_bytes(t, rows, width))


_sm_count = {}
_counters = {}  # (device, stream) -> the kernel's counter there


def _sms(device):
    """Multiprocessors of the card holding ``device``."""
    key = torch.device(device).index
    if key not in _sm_count:
        _sm_count[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[key]


def _launch(A, top, pc, t, bot, plan):
    """Launch the kernel on A's device and stream; raises if it fails.  The
    kernel's counter (one int32, 0 between launches: the launch's last CTA
    wraps it back) is made once for each device and stream, so launches
    that may overlap never share one."""
    lib = _build.load("tiled_slab", _ENTRIES)
    stream = _build.stream_of(A)
    key = (A.device, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        err = lib.svdt_tiled_slab(
            A.data_ptr(), A.stride(0), A.shape[1], top, -1 if bot is None else bot, t, pc,
            plan.width, plan.ctas, plan.rpl, plan.smem, _counters[key].data_ptr(), stream)
    _build.raise_on_error(err, "tiled_slab")


def _check_slab(A, top, pc, t, bot):
    nrows, n = A.shape
    if not (0 <= top and top + t <= nrows and 0 <= pc and pc + t <= n):
        raise ValueError(f"slab rows [{top}, {top + t}) or pivot columns [{pc}, {pc + t}) "
                         f"outside A {tuple(A.shape)}")
    if bot is not None and not (0 <= bot and bot + t <= nrows
                                and (bot + t <= top or bot >= top + t)):
        raise ValueError(f"TS rows [{bot}, {bot + t}) outside A or overlapping [{top}, "
                         f"{top + t})")


def factor_slab(A, top, pc, t, bot=None):
    """The ``t`` steps of one slab factorization, in place on ``A``: rows
    ``[top, top + t)`` and, for a TS step, ``[bot, bot + t)``; step ``j``
    pivots at column ``pc + j``, local row ``j`` (``models/tiled.
    _factor_slab``).  A CUDA ``A`` must be contiguous float32 and launches
    the kernel once; a CPU ``A`` runs the plain version.  Returns ``A``."""
    global launches
    top, pc, t = int(top), int(pc), int(t)
    bot = None if bot is None else int(bot)
    _check_slab(A, top, pc, t, bot)
    if not _build.check_input(A, "A", 2):
        return tiled._factor_slab(A, top, pc, t, bot)
    plan = slab_plan(A.shape[1], t, t if bot is None else 2 * t, _sms(A.device))
    _launch(A, top, pc, t, bot, plan)
    launches += 1
    return A


def dense_to_band_tiled(A, band=32):
    """Tiled Stage I (the reference's ``brd_p1``, the ``multicore`` rung):
    reduce square ``A`` to upper-band form with ``band`` superdiagonals
    (``n % band == 0``).  A float32 CUDA tensor runs every slab through the
    kernel, ``(n / band)^2`` launches, after checking that both slab shapes
    fit (``ValueError`` before any launch); a CPU tensor runs
    ``models/tiled.dense_to_band_tiled_plain``.  Returns a new tensor."""
    t = int(band)
    tiled.check_tiled(A, t)
    A = A.clone(memory_format=torch.contiguous_format)
    if not _build.check_input(A, "A", 2):
        return tiled.dense_to_band_tiled_plain(A, t)
    n = A.shape[0]
    sms = _sms(A.device)
    slab_plan(n, t, t, sms)
    if n > t:
        slab_plan(n, t, 2 * t, sms)
    At = torch.empty_like(A)

    def transpose(M):
        other = At if M is A else A
        return other.copy_(M.T)

    return tiled.tile_sweeps(A, t, factor_slab, transpose)

