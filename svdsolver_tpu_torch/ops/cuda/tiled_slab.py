"""The tiled Stage I on the card, and the public ``dense_to_band_tiled``.

It stands for no TPU kernel: the JAX package's ``_factor_1slab`` and
``_factor_2slab`` (``svdsolver_tpu/models/tiled.py:59``, ``:72``) are a
``lax.fori_loop`` over ``_slab_factor_step`` (``:33``) that XLA compiles
to one device program; as plain PyTorch launches a step is ~20 of them.

A half-sweep (a tile column's slabs, ``models/tiled.sweep_slabs``) runs
as two kernels: :func:`factor_sweep` (``csrc/tiled_chain.cu``, one CTA)
factors the pivot-block column through every slab and leaves the (v, tau)
history; :func:`apply_sweep` (``csrc/tiled_apply.cu``, every SM) applies
it to the other columns.  Both give the first design's bits.  The first
design, :func:`factor_slab` (``csrc/tiled_slab.cu``, one launch a slab),
stays as their bitwise oracle and runs the bands they do not take.  The
wide instance runs a half-sweep at any band, again with the first
design's bits: :func:`wide_chain`, up to t = 512 (:data:`WIDE_CHAIN_MAX`)
one thread-block cluster that holds the pivot block in registers
(``csrc/tiled_wide_cluster.cu``, :func:`wide_chain_plan`), past it the
pivot block by column in device memory (``csrc/tiled_wide.cu``, one CTA;
also the cluster's bitwise oracle), then :func:`wide_apply`, the apply
kernel's wide instances up to t = 512 (:data:`WIDE_APPLY_MAX`: the
columns in registers, the tile rows staged) and past it
:func:`wide_apply_cols` (``csrc/tiled_wide.cu``, a warp a column in
device memory; also the wide apply's bitwise oracle).

:func:`dense_to_band_tiled` picks by shape (:func:`tiled_route`): bands up
to 128 run the two kernels, ``2 (2 n / t - 1)`` launches (the LQ half on
a transposed contiguous copy, made once a tile sweep); bands up to 168
(238 for a single tile) the first design, ``(n / t)^2`` launches; every
wider band up to ``n`` the wide instance, again two launches a
half-sweep.  On a CPU tensor every entry runs its plain version
(``models/tiled``).  The plans (:func:`slab_plan`, :func:`chain_plan`,
:func:`apply_plan`) are plain Python.
"""

from typing import NamedTuple

import torch

from svdsolver_tpu_torch.models import tiled
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by factor_slab (the first design) since the last reset
launches_chain = 0  # by the chain kernel (factor_sweep)
launches_apply = 0  # by the apply kernel (apply_sweep)
launches_wide_chain = 0  # by the wide instance's cluster chain (wide_chain, t <= 512)
launches_wide_chain_dev = 0  # by its device-memory chain (past 512, or _device_block)
launches_wide_apply = 0  # by the apply kernel on the wide route (wide_apply)
launches_wide_apply_cols = 0  # by the wide instance's column apply (wide_apply_cols)

ROWS_PER_LANE = (1, 2, 4, 8, 11)  # the slab kernel's instances: rows of a column a lane holds
SWEEP_RPL = (1, 2, 4, 8)  # the chain's and the apply's: rows a lane (the chain: columns a warp)
APPLY_RPL = SWEEP_RPL + (16, 32)  # the apply's instances: 16 and 32 for the wide route
WIDE_APPLY_MAX = 16 * APPLY_RPL[-1]  # the widest band the apply kernel takes
APPLY_COLS = 2  # columns a warp of the apply kernel (its kCols)
APPLY_WIDTH = 32  # most columns an apply CTA takes (16 warps; 8 at rpl = 32)
WIDE_CHAIN_MAX = WIDE_APPLY_MAX  # the widest band the cluster chain takes
WIDE_CHAIN_WARPS = 16  # warps a CTA of the cluster chain
WIDE_CHAIN_MAX_CTAS = 16  # CTAs a cluster at most (non-portable above 8)
# the cluster chain's instances: rows a lane -> columns a warp (its x takes
# cols * rpl of a thread's 128 registers at 512 threads; 64 at most, with
# v); the package's build holds 2 columns a warp, 1 and 4 only the timing
# build of tools/tiled_split.py --wide --plans, the choices 2 was taken from
WIDE_CHAIN_INSTANCES = {16: (1, 2, 4), 32: (2,)}
WIDE_CHAIN_COLS = 2  # columns a warp: 32 a CTA
WIDE_CHAIN_SLOTS = 8  # reflector slots of the ring by default
_P, _I = _build.VOIDP, _build.INT
_ENTRIES = {"svdt_tiled_slab": [_P] + [_I] * 10 + [_P, _P]}
_CHAIN_ENTRIES = {e: [_P] + [_I] * 5 + [_P, _P, _I, _I, _P]
                  for e in ("svdt_tiled_chain", "svdt_tiled_chain_alone")}
_APPLY_ENTRIES = {"svdt_tiled_apply": [_P] + [_I] * 11 + [_P, _P, _P]}
_WIDE_ENTRIES = {"svdt_tiled_wide_chain": [_P] + [_I] * 5 + [_P, _P, _I, _P, _P],
                 "svdt_tiled_wide_apply": [_P] + [_I] * 6 + [_P, _P, _I, _P]}
_CLUSTER_ENTRIES = {e: [_P] + [_I] * 5 + [_P, _P] + [_I] * 6 + [_P]
                    for e in ("svdt_tiled_wide_chain_cluster",
                              "svdt_tiled_wide_chain_cluster_alone")}


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


class ChainPlan(NamedTuple):
    """The chain kernel's instance (``rpl`` rows a lane, columns a warp) and
    its dynamic shared-memory bytes."""

    rpl: int
    smem: int


class ApplyPlan(NamedTuple):
    """How the apply kernel cuts the columns outside the pivot block:
    ``width`` columns a CTA, ``ctas`` CTAs of ``threads`` threads, ``rpl``
    rows a lane, ``smem`` dynamic bytes a CTA (two tile-row chunks)."""

    width: int
    ctas: int
    threads: int
    rpl: int
    smem: int


def _room():
    return _build.MAX_SMEM - _build.STATIC_SMEM


def chain_plan(t):
    """The chain kernel for bands of ``t``: 16 warps, ``rpl`` the least of
    :data:`SWEEP_RPL` with ``16 rpl >= t`` (a warp's columns and a lane's
    rows of the 2t-row stack); shared memory for the slab's t reflectors
    (32 rpl floats each), their barriers and taus, and the prefetched
    t x (t + 1) tile.
    Raises ``ValueError`` past t = 128 (no instance) or the limit."""
    t = int(t)
    rpl = next((r for r in SWEEP_RPL if 16 * r >= t), None)
    if t < 1 or rpl is None:
        raise ValueError(f"t={t}: the chain kernel takes bands of 1 to {16 * SWEEP_RPL[-1]}")
    smem = 8 * t + 4 * (t * 32 * rpl + t + t * (t + 1))
    if smem > _room():
        raise ValueError(f"t={t}: the chain's {smem} bytes pass the {_room()}-byte "
                         "shared-memory limit of one block")
    return ChainPlan(rpl, smem)


def apply_plan(n, t, sms):
    """The apply kernel's launch for ``n`` columns and bands of ``t`` on a
    card of ``sms`` multiprocessors: the ``n - t`` columns outside the pivot
    block in chunks of ``ceil((n - t) / sms)`` (1 to :data:`APPLY_WIDTH`,
    half that at rpl = 32), a warp for every :data:`APPLY_COLS` of them,
    ``rpl`` the least of :data:`APPLY_RPL` with ``16 rpl >= t`` (up to
    t = 128 :func:`chain_plan`'s).  Raises ``ValueError`` past
    :data:`WIDE_APPLY_MAX`."""
    n, t = int(n), int(t)
    rpl = _apply_rpl(t)
    if t < 1 or rpl is None:
        raise ValueError(f"t={t}: the apply kernel takes bands of 1 to {WIDE_APPLY_MAX}")
    other = n - t
    most = APPLY_WIDTH if rpl <= 16 else APPLY_WIDTH // 2
    width = max(1, min(most, -(-other // max(int(sms), 1))))
    ctas = max(1, -(-other // width))
    threads = 32 * -(-width // APPLY_COLS)
    return ApplyPlan(width, ctas, threads, rpl, 4 * 2 * t * (width | 1))


class WideChainPlan(NamedTuple):
    """The cluster chain's launch: ``ctas`` CTAs of one cluster, each of
    ``warps`` warps holding ``cols`` columns a warp (16 cols a CTA) at
    ``rpl`` rows a lane, ``slots`` reflector slots in each CTA's ring,
    ``smem`` dynamic shared-memory bytes a CTA."""

    ctas: int
    warps: int
    cols: int
    rpl: int
    slots: int
    smem: int


def wide_chain_plan(t, cols=None, slots=None):
    """The cluster chain (``csrc/tiled_wide_cluster.cu``) for bands of
    ``t``: ``rpl`` 16 up to t = 256, 32 up to :data:`WIDE_CHAIN_MAX` (a
    lane's rows of the 2t-row stack); ``cols`` columns a warp (default
    :data:`WIDE_CHAIN_COLS`), so ``ceil(t / (16 cols))`` CTAs; ``slots``
    ring slots (default :data:`WIDE_CHAIN_SLOTS`, at least 2).  Shared
    memory a CTA: the ring's barriers and wait counts (5 slots floats,
    rounded up to 32), the slots (32 rpl + 4 floats each) and the staging
    tile (t x (16 cols + 1) floats).  Raises ``ValueError`` past
    :data:`WIDE_CHAIN_MAX`, for a ``cols`` the instance does not hold in
    its registers (:data:`WIDE_CHAIN_INSTANCES`), a cluster past
    :data:`WIDE_CHAIN_MAX_CTAS` CTAs, or shared memory past the limit."""
    t = int(t)
    if not 1 <= t <= WIDE_CHAIN_MAX:
        raise ValueError(f"t={t}: the cluster chain takes bands of 1 to {WIDE_CHAIN_MAX}")
    rpl = 16 if t <= 256 else 32
    cols = WIDE_CHAIN_COLS if cols is None else int(cols)
    slots = WIDE_CHAIN_SLOTS if slots is None else int(slots)
    if cols not in WIDE_CHAIN_INSTANCES[rpl]:
        raise ValueError(f"t={t}: {cols} columns a warp at {rpl} rows a lane pass the register "
                         f"budget of the instances (columns a warp {WIDE_CHAIN_INSTANCES[rpl]})")
    width = WIDE_CHAIN_WARPS * cols
    ctas = -(-t // width)
    if ctas > WIDE_CHAIN_MAX_CTAS:
        raise ValueError(f"t={t}: {ctas} CTAs of {width} columns pass the cluster's "
                         f"{WIDE_CHAIN_MAX_CTAS}")
    if slots < 2:
        raise ValueError(f"the ring needs 2 slots at least, not {slots}")
    smem = 4 * ((5 * slots + 31) // 32 * 32 + slots * (32 * rpl + 4) + t * (width + 1))
    if smem > _room():
        raise ValueError(f"t={t}: the cluster chain's {smem} bytes a CTA pass the "
                         f"{_room()}-byte shared-memory limit of one block")
    return WideChainPlan(ctas, WIDE_CHAIN_WARPS, cols, rpl, slots, smem)


def tiled_route(n, t, sms):
    """Which design runs ``dense_to_band_tiled`` at ``(n, t)``: ``"sweeps"``
    (the chain and the apply kernels, two launches a half-sweep) for every
    band :func:`chain_plan` takes (t <= 128); else ``"slabs"`` (the first
    design, a launch a slab) where :func:`slab_plan` takes both slab shapes
    (t <= 168; 238 when ``n == t``); else ``"wide"`` (the wide instance,
    two launches a half-sweep: :func:`wide_chain`, then
    :func:`wide_apply`).  Raises
    ``ValueError`` only for a band outside ``[1, n]``."""
    n, t = int(n), int(t)
    if not 1 <= t <= n:
        raise ValueError(f"band t={t} outside [1, n={n}]")
    if t <= 16 * SWEEP_RPL[-1]:
        return "sweeps"
    try:
        slab_plan(n, t, t, sms)
        if n > t:
            slab_plan(n, t, 2 * t, sms)
    except ValueError:
        return "wide"
    return "slabs"


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


def _launch_chain(M, top, pc, t, m, V, tau, plan):
    lib = _build.load("tiled_chain", _CHAIN_ENTRIES)
    with torch.cuda.device(M.device):
        err = lib.svdt_tiled_chain(M.data_ptr(), M.stride(0), top, pc, t, m, V.data_ptr(),
                                   tau.data_ptr(), plan.rpl, plan.smem, _build.stream_of(M))
    _build.raise_on_error(err, "tiled_chain")


def _launch_apply(M, top, pc, t, m, V, tau, plan):
    lib = _build.load("tiled_apply", _APPLY_ENTRIES)
    with torch.cuda.device(M.device):
        err = lib.svdt_tiled_apply(
            M.data_ptr(), M.stride(0), M.shape[1], top, pc, t, m, plan.width, plan.ctas,
            plan.threads, plan.rpl, plan.smem, V.data_ptr(), tau.data_ptr(),
            _build.stream_of(M))
    _build.raise_on_error(err, "tiled_apply")


def _check_sweep(M, top, pc, t):
    """A half-sweep ``(top, pc)`` of square ``M``: its slabs fill rows
    ``[top, n)``; returns the number of TS slabs."""
    n = M.shape[0]
    if M.shape[1] != n or not (0 <= top and top + t <= n and (n - top) % t == 0
                               and 0 <= pc and pc + t <= n):
        raise ValueError(f"half-sweep from row {top}, pivots [{pc}, {pc + t}): needs a square "
                         f"M whose rows from {top} on are whole tiles, got {tuple(M.shape)}")
    return (n - top) // t - 1


def _history(M, t, slabs, rpl):
    """The chain's (v, tau) history: ``slabs`` x ``t`` reflectors of 32
    ``rpl`` floats (every slot written whole by the kernel)."""
    return (torch.empty((slabs, t, 32 * rpl), dtype=M.dtype, device=M.device),
            torch.empty((slabs, t), dtype=M.dtype, device=M.device))


def factor_sweep(M, top, pc, t):
    """The pivot-block column of half-sweep ``(top, pc)`` of square ``M``,
    in place (``models/tiled.chain_plain``): columns ``[pc, pc + t)``,
    rows ``[top, n)``.  Returns the history ``(V, tau)`` for
    :func:`apply_sweep`.  A CUDA ``M`` (contiguous float32, ``t`` <= 128)
    launches the chain kernel once (``V`` 32 rpl floats a reflector, zeros
    past its rows); a CPU ``M`` runs the plain version."""
    global launches_chain
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        return tiled.chain_plain(M, top, pc, t)
    plan = chain_plan(t)
    V, tau = _history(M, t, m + 1, plan.rpl)
    _launch_chain(M, top, pc, t, m, V, tau, plan)
    launches_chain += 1
    return V, tau


def apply_sweep(M, top, pc, t, V, tau):
    """Half-sweep ``(top, pc)``'s history (:func:`factor_sweep`'s) on the
    columns of square ``M`` outside ``[pc, pc + t)``, rows ``[top, n)``, in
    place (``models/tiled.apply_plain``).  A CUDA ``M`` launches the apply
    kernel once (``V`` as the chain kernel leaves it); a CPU ``M`` runs the
    plain version.  Returns ``M``."""
    global launches_apply
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        return tiled.apply_plain(M, top, pc, t, V, tau)
    plan = apply_plan(M.shape[0], t, _sms(M.device))
    if tuple(V.shape) != (m + 1, t, 32 * plan.rpl) or tuple(tau.shape) != (m + 1, t):
        raise ValueError(f"history of shape {tuple(V.shape)}, {tuple(tau.shape)}: want "
                         f"{(m + 1, t, 32 * plan.rpl)}, {(m + 1, t)}")
    _build.check_input(V, "V", 3)
    _build.check_input(tau, "tau", 2)
    if V.device != M.device or tau.device != M.device:
        raise ValueError("the history must lie on M's device")
    _launch_apply(M, top, pc, t, m, V, tau, plan)
    launches_apply += 1
    return M


def _apply_rpl(t):
    """The apply kernel's rows a lane for bands of ``t``: the least of
    :data:`APPLY_RPL` with ``16 rpl >= t``, None past them."""
    return next((r for r in APPLY_RPL if 16 * r >= t), None)


def wide_vld(t):
    """Floats a reflector of the wide instance's history: ``32 rpl`` of
    :func:`apply_plan` up to :data:`WIDE_APPLY_MAX` (the apply kernel's
    slots), ``2 t`` past it."""
    rpl = _apply_rpl(int(t))
    return 32 * rpl if rpl else 2 * int(t)


def _wide_history(M, t, slabs):
    """The wide instance's history: ``slabs`` x ``t`` reflectors of
    :func:`wide_vld` floats (``models/tiled.chain_plain``'s layout, zero
    padded; the kernel writes every entry, zeros past a slab's rows) and
    their taus."""
    return (torch.empty((slabs, t, wide_vld(t)), dtype=M.dtype, device=M.device),
            torch.empty((slabs, t), dtype=M.dtype, device=M.device))


def _launch_wide_chain(M, top, pc, t, m, V, tau, _device_block=False):
    """The wide route's chain: the cluster chain up to
    :data:`WIDE_CHAIN_MAX`, the device-memory chain past it (or forced by
    ``_device_block``)."""
    if t <= WIDE_CHAIN_MAX and not _device_block:
        _launch_wide_cluster(M, top, pc, t, m, V, tau, wide_chain_plan(t))
    else:
        _launch_wide_dev(M, top, pc, t, m, V, tau)


def _cluster_args(M, top, pc, t, m, V, tau, plan):
    return (M.data_ptr(), M.stride(0), top, pc, t, m, V.data_ptr(), tau.data_ptr(), V.shape[2],
            plan.ctas, plan.cols, plan.rpl, plan.slots, plan.smem, _build.stream_of(M))


def _launch_wide_cluster(M, top, pc, t, m, V, tau, plan):
    global launches_wide_chain
    lib = _build.load("tiled_wide_cluster", _CLUSTER_ENTRIES)
    with torch.cuda.device(M.device):
        err = lib.svdt_tiled_wide_chain_cluster(*_cluster_args(M, top, pc, t, m, V, tau, plan))
    _build.raise_on_error(err, "tiled_wide_chain_cluster")
    launches_wide_chain += 1


def _launch_wide_dev(M, top, pc, t, m, V, tau):
    global launches_wide_chain_dev
    lib = _build.load("tiled_wide", _WIDE_ENTRIES)
    block = torch.empty((t, 2 * t), dtype=M.dtype, device=M.device)  # the pivot block, by column
    with torch.cuda.device(M.device):
        err = lib.svdt_tiled_wide_chain(M.data_ptr(), M.stride(0), top, pc, t, m, V.data_ptr(),
                                        tau.data_ptr(), V.shape[2], block.data_ptr(),
                                        _build.stream_of(M))
    _build.raise_on_error(err, "tiled_wide_chain")
    launches_wide_chain_dev += 1


def _launch_wide_apply(M, top, pc, t, m, V, tau):
    """The wide route's apply: the apply kernel up to
    :data:`WIDE_APPLY_MAX`, the column apply past it."""
    global launches_wide_apply
    if t > WIDE_APPLY_MAX:
        _launch_wide_apply_cols(M, top, pc, t, m, V, tau)
        return
    _launch_apply(M, top, pc, t, m, V, tau, apply_plan(M.shape[0], t, _sms(M.device)))
    launches_wide_apply += 1


def _launch_wide_apply_cols(M, top, pc, t, m, V, tau):
    global launches_wide_apply_cols
    lib = _build.load("tiled_wide", _WIDE_ENTRIES)
    with torch.cuda.device(M.device):
        err = lib.svdt_tiled_wide_apply(M.data_ptr(), M.stride(0), M.shape[1], top, pc, t, m,
                                        V.data_ptr(), tau.data_ptr(), V.shape[2],
                                        _build.stream_of(M))
    _build.raise_on_error(err, "tiled_wide_apply")
    launches_wide_apply_cols += 1


def wide_chain(M, top, pc, t, _device_block=False):
    """:func:`factor_sweep` at any band: the pivot-block column of
    half-sweep ``(top, pc)`` in place, and its history ``(V, tau)`` in
    ``models/tiled.chain_plain``'s layout (:func:`wide_vld` floats a
    reflector, zeros past its rows).  A CUDA ``M`` launches the cluster
    chain (``csrc/tiled_wide_cluster.cu``, :func:`wide_chain_plan`) up to
    :data:`WIDE_CHAIN_MAX`, past it (or with ``_device_block``, the card
    checks' handle on the bitwise oracle) the device-memory chain
    (``csrc/tiled_wide.cu``, one CTA, the pivot block by column in device
    memory); both give the same bits.  A CPU ``M`` runs ``chain_plain``."""
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        return tiled.chain_plain(M, top, pc, t)
    V, tau = _wide_history(M, t, m + 1)
    _launch_wide_chain(M, top, pc, t, m, V, tau, _device_block)
    return V, tau


def _check_wide_history(M, t, m, V, tau, widths):
    if tuple(V.shape[:2]) != (m + 1, t) or V.shape[2] not in widths \
            or tuple(tau.shape) != (m + 1, t):
        raise ValueError(f"history of shape {tuple(V.shape)}, {tuple(tau.shape)}: want "
                         f"{(m + 1, t)} x {widths[0]}, {(m + 1, t)}")
    _build.check_input(V, "V", 3)
    _build.check_input(tau, "tau", 2)
    if V.device != M.device or tau.device != M.device:
        raise ValueError("the history must lie on M's device")


def wide_apply(M, top, pc, t, V, tau):
    """:func:`apply_sweep` on the wide route's apply (up to
    :data:`WIDE_APPLY_MAX` the apply kernel's wide instances, then
    :func:`wide_apply_cols`'s kernel), the history as :func:`wide_chain`
    leaves it.  A CPU ``M`` runs ``apply_plain``.  Returns ``M``."""
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        return tiled.apply_plain(M, top, pc, t, V, tau)
    _check_wide_history(M, t, m, V, tau, (wide_vld(t),))
    _launch_wide_apply(M, top, pc, t, m, V, tau)
    return M


def wide_apply_cols(M, top, pc, t, V, tau):
    """:func:`apply_sweep` on the wide instance's column apply
    (``csrc/tiled_wide.cu``: a warp a column outside ``[pc, pc + t)``, read
    from device memory at every step), at any band: the route past
    :data:`WIDE_APPLY_MAX` and the wide apply's bitwise oracle.  ``V`` may
    be :func:`wide_chain`'s or ``2 t`` wide.  A CPU ``M`` runs
    ``apply_plain``.  Returns ``M``."""
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        return tiled.apply_plain(M, top, pc, t, V, tau)
    _check_wide_history(M, t, m, V, tau, (wide_vld(t), 2 * t))
    _launch_wide_apply_cols(M, top, pc, t, m, V, tau)
    return M


def chain_alone_ms(M, top, pc, t):
    """ms of the chain alone on half-sweep ``(top, pc)`` of float32 CUDA
    ``M`` (``svdt_tiled_chain_alone``: the waits, pivot-column updates,
    reflectors and slab hand-overs of the chain kernel, no other column's
    apply), one launch between CUDA events.  The chain's latency bound;
    uncounted, and it leaves ``M`` as no half-sweep does."""
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        raise ValueError("chain_alone_ms times the kernel: M must be a CUDA tensor")
    plan = chain_plan(t)
    V, tau = _history(M, t, m + 1, plan.rpl)
    lib = _build.load("tiled_chain", _CHAIN_ENTRIES)
    args = (M.data_ptr(), M.stride(0), top, pc, t, m, V.data_ptr(), tau.data_ptr(), plan.rpl,
            plan.smem, _build.stream_of(M))
    with torch.cuda.device(M.device):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.svdt_tiled_chain_alone(*args)
        stop.record()
    _build.raise_on_error(err, "tiled_chain_alone")
    torch.cuda.synchronize(M.device)
    return start.elapsed_time(stop)


def wide_chain_alone_ms(M, top, pc, t):
    """ms of the cluster chain alone on half-sweep ``(top, pc)`` of float32
    CUDA ``M`` (``svdt_tiled_wide_chain_cluster_alone``: the waits,
    pivot-column updates, reflectors, broadcasts and slab hand-overs, no
    other column's apply) under :func:`wide_chain_plan`, one launch between
    CUDA events.  The wide chain's latency bound;
    uncounted, and it leaves ``M`` as no half-sweep does."""
    top, pc, t = int(top), int(pc), int(t)
    m = _check_sweep(M, top, pc, t)
    if not _build.check_input(M, "M", 2):
        raise ValueError("wide_chain_alone_ms times the kernel: M must be a CUDA tensor")
    plan = wide_chain_plan(t)
    V, tau = _wide_history(M, t, m + 1)
    lib = _build.load("tiled_wide_cluster", _CLUSTER_ENTRIES)
    with torch.cuda.device(M.device):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.svdt_tiled_wide_chain_cluster_alone(
            *_cluster_args(M, top, pc, t, m, V, tau, plan))
        stop.record()
    _build.raise_on_error(err, "tiled_wide_chain_cluster_alone")
    torch.cuda.synchronize(M.device)
    return start.elapsed_time(stop)


def _transposer(A):
    """``transpose`` of ``models/tiled.tile_sweeps`` on the card: the other
    of two contiguous buffers takes ``M.T``."""
    At = torch.empty_like(A)

    def transpose(M):
        other = At if M is A else A
        return other.copy_(M.T)

    return transpose


def dense_to_band_slabs(A, band):
    """The first design's tiled Stage I on float32 CUDA ``A`` in place: every
    slab through :func:`factor_slab`, ``(n / band)^2`` launches, after
    checking that both slab shapes fit (``ValueError`` before any launch).
    The bitwise oracle of the two-kernel design and of the wide instance,
    and the route for bands 128 < t <= 168.  Returns ``A``."""
    t = int(band)
    n = A.shape[0]
    sms = _sms(A.device)
    slab_plan(n, t, t, sms)
    if n > t:
        slab_plan(n, t, 2 * t, sms)
    return tiled.tile_sweeps(A, t, tiled.slab_sweep(factor_slab), _transposer(A))


def dense_to_band_wide(A, band, _device_block=False):
    """The tiled Stage I on float32 CUDA ``A`` in place with every
    half-sweep through the wide instance (:func:`wide_chain`, then
    :func:`wide_apply` of its history; ``_device_block``: the device-memory
    chain at any band, the design before the cluster chain, kept to hold
    and time it against), ``2 (2 n / band - 1)`` launches (no apply at
    ``band = n``): the route for bands past the first design's, and at any
    band bit-equal to it and to the two-kernel design.  Returns ``A``."""
    t = int(band)
    n = A.shape[0]
    V, tau = _wide_history(A, t, n // t)

    def sweep(M, top, pc, t):
        m = (n - top) // t - 1
        _launch_wide_chain(M, top, pc, t, m, V, tau, _device_block)
        if n > t:
            _launch_wide_apply(M, top, pc, t, m, V, tau)

    return tiled.tile_sweeps(A, t, sweep, _transposer(A))


def dense_to_band_tiled(A, band=32):
    """Tiled Stage I (the reference's ``brd_p1``, the ``multicore`` rung):
    reduce square ``A`` to upper-band form with ``band`` superdiagonals
    (``n % band == 0``).  A float32 CUDA tensor takes :func:`tiled_route`'s
    design: bands up to 128 run each half-sweep as one chain and one apply
    launch, ``2 (2 n / band - 1)`` launches; bands up to 168 the first
    design, ``(n / band)^2``; every wider band the wide instance, two
    launches a half-sweep.  All three give the same bits.  A CPU tensor runs
    ``models/tiled.dense_to_band_tiled_plain``.  Returns a new tensor."""
    t = int(band)
    tiled.check_tiled(A, t)
    A = A.clone(memory_format=torch.contiguous_format)
    if not _build.check_input(A, "A", 2):
        return tiled.dense_to_band_tiled_plain(A, t)
    n = A.shape[0]
    route = tiled_route(n, t, _sms(A.device))
    if route == "slabs":
        return dense_to_band_slabs(A, t)
    if route == "wide":
        return dense_to_band_wide(A, t)
    chain, apply = chain_plan(t), apply_plan(n, t, _sms(A.device))
    V, tau = _history(A, t, n // t, chain.rpl)

    def sweep(M, top, pc, t):
        global launches_chain, launches_apply
        m = (n - top) // t - 1
        _launch_chain(M, top, pc, t, m, V, tau, chain)
        launches_chain += 1
        _launch_apply(M, top, pc, t, m, V, tau, apply)
        launches_apply += 1

    return tiled.tile_sweeps(A, t, sweep, _transposer(A))
