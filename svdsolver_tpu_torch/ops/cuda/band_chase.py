"""The band -> bidiagonal bulge chase in one launch, plain and recording,
on the sequential schedule, and the routes of its flags.

Three Hopper kernels run the sequential chase, each walking the schedule
of ``models/two_stage``, whose ``band_to_bidiagonal`` and
``band_to_bidiagonal_accum`` are their plain versions (on a CPU tensor the
wrappers run those):

* the staged TMA design (``csrc/band_chase_staged.cu``, one CTA): each pair's tiles
  copied by TMA into a ring of shared-memory slots ``khops`` pairs ahead;
  it runs wherever :func:`staged_tma_takes` holds (4 <= band <= 128, band
  and n multiples of 4, A 16-byte aligned: every band of the main paths);
* the L2 kernel (``csrc/band_chase.cu``, one CTA): each pair on the matrix
  through L2.  It runs every other shape up to b = 256 and the bands past
  :func:`wide_chase_plan`'s range (on the wide pair of
  ``csrc/chase_pair.cuh``), and is the bitwise oracle of the chase family
  (:func:`band_to_bidiagonal_l2`, :func:`band_to_bidiagonal_accum_l2`).

Past b = 256 a third kernel runs the sequential chase wherever
:func:`wide_chase_plan` takes the band: the cluster kernel
(``csrc/band_chase_cluster.cu``, entries ``svdt_band_chase_cluster`` and
``_cluster_rec``), one thread-block cluster walking the schedule, each pair
the wide pair split over the cluster's CTAs (``csrc/chase_cluster.cuh``),
bit-equal to the L2 kernel.  :func:`staged_route` and :func:`wide_route`
pick the kernel by shape before launch.  So
:func:`band_to_bidiagonal` stands for the TPU's ``band_chase._chase_kernel``
(K3), ``_chase_kernel_pipelined`` (K14, ``pipelined``) and
``_chase_kernel_megapipe`` (K15, ``mega``), and :func:`band_to_bidiagonal_accum`
for ``_chase_kernel_rec`` (K6); both give the same ``(d, e)`` and records
bit for bit on every kernel.  The main paths take them wherever
``band_chase_wave.wave_chase_preferred`` (``svdvals``) or
``wave_chase_accum_preferred`` (``svd``, ``svds``) is false, and so stand
for ``band_chase_stream._stream_chase_kernel`` (K5, K8) there; elsewhere
the wavefront kernel (``band_chase_wave``) runs.  ``wavefront`` sends
:func:`band_to_bidiagonal` to the wavefront kernel too.  The TMA design's
plain version is ``two_stage.band_to_bidiagonal_staged_tiles`` (the copies
of ``chase_schedule.staged_copies``).

:func:`superstep` is one rank's pass of one superstep of the pipelined chase
(``parallel.distributed.band_to_bidiagonal_pipelined``) in one launch.  It
stands for no TPU kernel: the JAX package runs that pass as XLA windows.
Two designs run it, chosen by shape before launch (:func:`superstep_design`):
the pass as a wavefront over its sweeps on the shared-memory tick
(``csrc/band_chase_superstep.cu``, one CTA a sweep, each pair's tiles
copied by TMA; ``two_stage.chase_superstep_wavefront`` is the same pass
in its tick order, the oracle of that schedule) wherever
:func:`superstep_takes` holds and LG >= 2, and the first design
(``svdt_band_chase_superstep`` in ``csrc/band_chase.cu``: one CTA walking
the pass in order, each pair the L2 kernel's on the buffer) elsewhere and
for LG = 1 passes, its bitwise oracle.  Both leave the buffer bit-equal
to the plain version ``two_stage.chase_superstep``, which a CPU tensor
runs.
"""

import ctypes
from typing import NamedTuple

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build, band_chase_wave

# Launches since the last reset, by the kernel that ran (not the entry
# that was called)
launches = 0  # the L2 kernel
launches_rec = 0  # the L2 kernel's recording entry
launches_staged = 0  # the staged TMA design
launches_staged_rec = 0  # the staged TMA design's recording entry
last_khops = 0  # pairs the copies of the last staged launch ran ahead
launches_superstep = 0  # the pipelined chase's pass on the shared-memory tick
launches_superstep_l2 = 0  # the pass's first design (the L2 kernel's pair)
last_superstep_ctas = 0  # CTAs of the last pass on the shared-memory tick (0: no work)
_counters = {}  # (device, stream) -> the pass's grid barrier counter
SUPERSTEP_LANES = 2  # the least LG (sweeps a group) that takes the shared-memory design
launches_cluster = 0  # the cluster kernel (b > 256)
launches_cluster_rec = 0  # the cluster kernel's recording entry

_ENTRIES = {
    "svdt_band_chase": [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP],
    "svdt_band_chase_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP]
    ),
    "svdt_band_chase_superstep": [_build.VOIDP] + [_build.INT] * 10 + [_build.VOIDP],
}
_SUPERSTEP_ENTRIES = {
    "svdt_band_chase_superstep_wave": (
        [_build.VOIDP] + [_build.INT] * 11 + [_build.VOIDP, _build.INT, _build.VOIDP,
                                              _build.VOIDP]
    ),
}
# the TMA design's static shared memory: v, col (SMEM_BAND each), vg
# (2 SMEM_BAND), partial sums (512), 2 taus, and an 8-byte mbarrier for each
# of up to STAGED_MAX_SLOTS ring slots (one parity bit each in a 32-bit mask)
STAGED_MAX_SLOTS = 31
STAGED_STATIC_SMEM = 4 * (4 * band_chase_wave.SMEM_BAND + 512 + 2) + 8 * STAGED_MAX_SLOTS

_PLAN_ARGS = [_build.INT] * 6  # C, cols, rchunk, lchunk, stage, smem
_CLUSTER_ENTRIES = {
    "svdt_band_chase_cluster": [_build.VOIDP] * 3 + [_build.INT] * 2 + _PLAN_ARGS
    + [_build.VOIDP],
    "svdt_band_chase_cluster_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4 + [_build.INT]
        + _PLAN_ARGS + [_build.VOIDP]
    ),
    "svdt_band_chase_wave_cluster": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] + _PLAN_ARGS
        + [_build.INT] + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_cluster_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4 + [_build.INT]
        + [_build.VOIDP] + _PLAN_ARGS + [_build.INT] + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_cluster_fit": [_build.INT] * 4 + [_build.VOIDP],
}
CLUSTER_MAX_CTAS = 16  # a cluster past 8 CTAs is non-portable; the H100 holds 16
CLUSTER_THREADS = 512  # a CTA's threads: the left apply's columns a CTA at most
# the widest band a cluster of 16 takes: 2b columns over 16 CTAs of 512 threads
CLUSTER_MAX_BAND = CLUSTER_MAX_CTAS * CLUSTER_THREADS // 2
_resident = {}  # (C, smem, wave, record) -> cudaOccupancyMaxActiveClusters

_STAGED_ENTRIES = {
    "svdt_band_chase_staged": [_build.VOIDP] * 3 + [_build.INT] * 3 + [_build.VOIDP],
    "svdt_band_chase_staged_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT] * 2 + [_build.VOIDP]
    ),
}

band_to_bidiagonal_plain = two_stage.band_to_bidiagonal
band_to_bidiagonal_accum_plain = two_stage.band_to_bidiagonal_accum
superstep_plain = two_stage.chase_superstep


def staged_slot_floats(band):
    """Floats of one ring slot of the staged kernel: a TMA box of ``band``
    rows of ``band + 4`` columns and one more row, rounded up to 128 bytes
    (``tile_floats`` of ``csrc/chase_tma.cuh``)."""
    b = int(band)
    return ((b + 1) * (b + 4) + 31) & ~31


def staged_khops(band, khops):
    """The largest lookahead ``K <= khops`` whose ring of ``2K + 1`` slots
    (:func:`staged_slot_floats`, plus 128 bytes of alignment) fits the
    card's shared memory beside the kernel's static arrays, with at most
    ``STAGED_MAX_SLOTS`` slots (0: none fits)."""
    fit = (_build.MAX_SMEM - STAGED_STATIC_SMEM - 128) // (4 * staged_slot_floats(band))
    return max(0, min(int(khops), (min(fit, STAGED_MAX_SLOTS) - 1) // 2))


def staged_tma_takes(A, band):
    """Whether the staged kernel's TMA design takes ``A`` with ``band``: the
    rule of the wavefront's shared-memory tick (``band_chase_wave.
    smem_tick_takes``: 4 <= band <= 128, band and n multiples of 4, ``A``
    16-byte aligned)."""
    return band_chase_wave.smem_tick_takes(A, band)


def staged_route(A, band, khops=1):
    """The lookahead the sequential chase of ``A`` with ``band`` runs at,
    decided by shape before launch: the largest ``K <= khops`` that fits
    (:func:`staged_khops`) where the staged TMA design takes the shape
    (:func:`staged_tma_takes`), 0 where the L2 kernel runs it."""
    if int(khops) < 1:
        raise ValueError(f"khops must be >= 1, got {khops}")
    return staged_khops(band, khops) if staged_tma_takes(A, band) else 0


class WideChasePlan(NamedTuple):
    """How the cluster kernels split a wide pair (``csrc/chase_cluster.cuh``).

    ``ctas``: C, the CTAs of a cluster.  ``cols``: the left apply's window
    columns a CTA takes at most, and the right apply's window rows
    (``ceil(2b / C)``; :func:`cluster_share` deals them).  ``whole``: a
    CTA's slice (``cols x b`` and ``b x cols`` floats) is staged in shared
    memory whole; else it streams through the stage, ``rchunk`` rows of
    ``b`` floats and ``lchunk`` rows of ``cols`` floats a chunk.  ``stage``: the stage's floats; ``smem``: a CTA's
    dynamic shared memory in bytes (v and the left apply's factors, each
    rounded up to 32 floats, then the stage)."""

    ctas: int
    cols: int
    whole: bool
    rchunk: int
    lchunk: int
    stage: int
    smem: int


def cluster_share(count, ctas, q):
    """CTA ``q``'s block ``[lo, hi)`` of ``count`` window rows or columns
    dealt to ``ctas`` CTAs in contiguous blocks of ``ceil(count / ctas)``
    (``cluster_share`` of ``csrc/chase_cluster.cuh``)."""
    per = -(-int(count) // int(ctas))
    lo = min(int(count), int(q) * per)
    return lo, min(int(count), lo + per)


def _pad32(x):
    return (int(x) + 31) & ~31


def stage_ld(w):
    """The row stride of a staged tile of ``w`` columns (``stage_ld`` of
    ``csrc/chase_cluster.cuh``): the 16-byte aligned span of any row, at
    most ``w + 3`` floats rounded up to 4."""
    return (int(w) + 6) & ~3


def wide_chase_plan(n, band):
    """The plan of the cluster kernels for an (n, n) band of ``band`` past
    256 (:class:`WideChasePlan`): ``CLUSTER_MAX_CTAS`` CTAs a cluster, a
    CTA's slices staged whole where they fit ``_build.MAX_SMEM`` less the
    static shared memory, else streamed in the largest chunks that fit.
    Both kernels take these 16 CTAs a cluster: the sequential kernel's one
    cluster, and the wavefront's cluster a work unit, which at one to four
    lanes ran fastest on 16 against 4 and 8 (``band_chase_wave.
    wave_lanes_needed``'s table; ``tools/chase_cluster_split.py --lanes``
    times the others by setting ``CLUSTER_MAX_CTAS``).

    It takes every band with ``256 < band <= band_chase_wave.band_range(n)``
    up to ``256 C`` (``CLUSTER_MAX_BAND = 4096`` on 16 CTAs: a CTA's
    left-apply columns are its threads, at most 512), and raises
    ``ValueError`` past it, or where a CTA's v, factors and one row of
    either side do not fit (never below 4096); the L2 kernel and the
    wavefront's L2 tick take those bands.  On 16 CTAs the slices are whole
    up to band 648 (at 512: 64 rows or columns a CTA, 136 KB with each
    staged row's 16-byte aligned span, :func:`stage_ld`)."""
    n, b, C = int(n), int(band), CLUSTER_MAX_CTAS
    top = band_chase_wave.band_range(n)
    if not band_chase_wave.NARROW_BAND < b <= top:
        raise ValueError(f"band={b} outside the cluster kernels' range "
                         f"({band_chase_wave.NARROW_BAND}, {top}] for n={n}")
    per = -(-2 * b // C)
    if per > CLUSTER_THREADS:
        raise ValueError(f"band={b} on {C} CTAs: {per} left-apply columns a CTA, past its "
                         f"{CLUSTER_THREADS} threads")
    head = _pad32(b) + _pad32(per)
    room = (_build.MAX_SMEM - _build.STATIC_SMEM) // 4 - head
    whole = max(per * stage_ld(b), b * stage_ld(per))
    if whole <= room:
        return WideChasePlan(C, per, True, per, b, whole, 4 * (head + whole))
    rchunk, lchunk = min(per, room // stage_ld(b)), min(b, room // stage_ld(per))
    if rchunk < 1:
        raise ValueError(f"band={b}: v, the factors and one row leave no shared memory")
    return WideChasePlan(C, per, False, rchunk, lchunk, room, 4 * (head + room))


def wide_route(n, band):
    """The cluster kernels' plan for an (n, n) band of ``band`` where they
    take it (:func:`wide_chase_plan`), else None (b <= 256, or a band past
    the plan's range: the L2 kernels)."""
    if int(band) <= band_chase_wave.NARROW_BAND:
        return None
    try:
        return wide_chase_plan(n, band)
    except ValueError:
        return None


def check_resident(lib, plan, wave, record):
    """Raise ``ValueError`` unless one cluster of ``plan`` fits on the card
    (``cudaOccupancyMaxActiveClusters`` of the kernel the launch takes)."""
    key = (plan.ctas, plan.smem, bool(wave), bool(record))
    if key not in _resident:
        got = ctypes.c_int(0)
        err = lib.svdt_band_chase_cluster_fit(plan.ctas, plan.smem, int(bool(wave)),
                                              int(bool(record)), ctypes.addressof(got))
        _build.raise_on_error(err, "cudaOccupancyMaxActiveClusters (band_chase_cluster)")
        _resident[key] = got.value
    if _resident[key] < 1:
        raise ValueError(
            f"a cluster of {plan.ctas} CTAs with {plan.smem} bytes of shared memory each "
            "cannot be resident on this card (cudaOccupancyMaxActiveClusters = 0)")


def plan_args(plan):
    """The plan as the cluster entries take it: C, cols, rchunk, lchunk,
    stage, smem."""
    return [plan.ctas, plan.cols, plan.rchunk, plan.lchunk, plan.stage, plan.smem]


def _records(n, b, like):
    """Zeroed records (VL, TL, VR, TR) and ``s_max``: the kernels write only
    the slots the schedule reaches."""
    s_max = s_max_of(n, b)
    VL, VR = torch.zeros((2, n - 1, s_max, b), dtype=like.dtype, device=like.device)
    TL, TR = torch.zeros((2, n - 1, s_max), dtype=like.dtype, device=like.device)
    return [VL, TL, VR, TR], s_max


def _launch_cluster(A, b, plan, record):
    """One launch of the cluster kernel on a copy of the CUDA ``A`` under
    ``plan``; counted.  Returns ``(d, e)``, and with ``record`` the records
    after them."""
    global launches_cluster, launches_cluster_rec
    n = A.shape[0]
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    args = [work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b]
    recs = []
    if record:
        recs, s_max = _records(n, b, A)
        args += [t.data_ptr() for t in recs] + [s_max]
    kernel = "band_chase_cluster" + ("_rec" if record else "")
    with torch.cuda.device(A.device):
        lib = _build.load("band_chase_cluster", _CLUSTER_ENTRIES)
        check_resident(lib, plan, False, record)
        err = getattr(lib, f"svdt_{kernel}")(*args, *plan_args(plan), _build.stream_of(A))
    _build.raise_on_error(err, kernel)
    if record:
        launches_cluster_rec += 1
    else:
        launches_cluster += 1
    return (d, e, *recs)


def _launch(A, b, K, record):
    """One launch of the sequential chase on a copy of the CUDA ``A``: the
    staged TMA design at lookahead ``K``, or the L2 kernel for ``K = 0``;
    counted by the kernel that ran.  Returns ``(d, e)``, and with
    ``record`` the records after them (zeroed first: the kernels write
    only the slots the schedule reaches)."""
    global launches, launches_rec, launches_staged, launches_staged_rec, last_khops
    n = A.shape[0]
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    args = [work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b]
    recs = []
    if record:
        recs, s_max = _records(n, b, A)
        args += [t.data_ptr() for t in recs] + [s_max]
    kernel = ("band_chase_staged" if K else "band_chase") + ("_rec" if record else "")
    with torch.cuda.device(A.device):
        if K:
            lib = _build.load("band_chase_staged", _STAGED_ENTRIES)
            err = getattr(lib, f"svdt_{kernel}")(*args, K, _build.stream_of(A))
        else:
            lib = _build.load("band_chase", _ENTRIES)
            err = getattr(lib, f"svdt_{kernel}")(*args, _build.stream_of(A))
    _build.raise_on_error(err, kernel)
    if K:
        last_khops = K
        if record:
            launches_staged_rec += 1
        else:
            launches_staged += 1
    elif record:
        launches_rec += 1
    else:
        launches += 1
    return (d, e, *recs)


def _sequential(A, b, khops, record, l2=False):
    """The sequential chase of ``A``: the plain version on the CPU, else one
    launch of the kernel the shape takes: the cluster kernel past b = 256
    where :func:`wide_route` takes the band, else the kernel
    :func:`staged_route` picks (the L2 kernel with ``l2``)."""
    on_card = _build.check_input(A, "A", 2)
    n = band_chase_wave.check_band(A, b)
    K = 0 if l2 else staged_route(A, b, khops)
    if record and n < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    if not on_card:
        plain = band_to_bidiagonal_accum_plain if record else band_to_bidiagonal_plain
        return plain(A, band=b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    plan = None if l2 else wide_route(n, b)
    if plan is not None:
        return _launch_cluster(A, b, plan, record)
    return _launch(A, b, K, record)


def band_to_bidiagonal(A, band=128, wavefront=False, pipelined=False,
                       mega=False, khops=4):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal; returns ``(d, e)``.

    A CUDA tensor must be contiguous float32 with a band ``band_chase_wave.
    band_range`` takes (any band up to 256; up to n past it, where the
    cluster kernel runs the wide pair wherever :func:`wide_route` takes the
    band, and the L2 kernel past that) and launches a kernel on a copy of
    ``A`` (the chase runs in place on it); a CPU tensor runs the plain
    version.  ``wavefront`` runs the wavefront kernel
    (``band_chase_wave``).  Every other call up to b = 256 runs the
    sequential chase on the kernel :func:`staged_route` picks by shape: the staged
    TMA design with its copies one pair ahead (no flag, and ``pipelined``),
    or up to ``khops`` pairs ahead with ``mega`` (the largest that fits
    shared memory, recorded in ``last_khops``); the L2 kernel for the
    shapes the TMA design does not take (a band above 128 among them), as
    the TPU sends bands that are not multiples of 128 to its sequential
    kernel (its 128-lane gates are alignment rules the card does not
    have).  Every route gives the same ``(d, e)``, bit for bit; on the CPU
    ``wavefront`` runs the plain wavefront schedule and the others the
    plain sequential chase.
    """
    if int(khops) < 1:
        raise ValueError(f"khops must be >= 1, got {khops}")
    if wavefront:
        return band_chase_wave.band_to_bidiagonal_wave(A, band=int(band))
    return _sequential(A, int(band), khops if mega and not pipelined else 1, record=False)


def band_to_bidiagonal_accum(A, band=128):
    """Bulge-chase the upper-band ``A`` to bidiagonal, recording every
    reflector; returns ``(d, e, VL, TL, VR, TR)`` as
    ``models.two_stage.band_to_bidiagonal_accum``.

    A CUDA tensor must be contiguous float32 with ``n >= 2`` and a band
    ``band_chase_wave.band_range`` takes; it launches the recording entry
    of the kernel :func:`staged_route` picks (the staged TMA design, its copies one pair
    ahead, or the L2 kernel), or past b = 256 of the cluster kernel where
    :func:`wide_route` takes the band, on a copy of ``A``.  Its
    ``(d, e)`` are bit-equal to :func:`band_to_bidiagonal`'s, its records
    to either kernel's.  The kernels store identity reflectors (and slots
    past the schedule) as zero rows with tau 0, where the plain version
    keeps ``v = e_0``; the back-transforms treat both alike.  A CPU tensor
    runs the plain version.
    """
    return _sequential(A, int(band), 1, record=True)


def band_to_bidiagonal_l2(A, band=128):
    """:func:`band_to_bidiagonal` on the L2 kernel at every shape (past
    b = 256 too, where the route takes the cluster kernel): the bitwise
    oracle of the chase family, for the card's checks and timings.  A CPU
    tensor runs the plain version."""
    return _sequential(A, int(band), 1, record=False, l2=True)


def band_to_bidiagonal_accum_l2(A, band=128):
    """:func:`band_to_bidiagonal_accum` on the L2 kernel's recording entry
    at every shape (the oracle of the recording chases)."""
    return _sequential(A, int(band), 1, record=True, l2=True)


def superstep_takes(L, n, band):
    """Whether the pass's shared-memory design takes the local buffer ``L``
    of an (n, n) band of ``band``: ``band_chase_wave.tma_shape_takes(n,
    band)`` (4 <= band <= 128, band and n multiples of 4), a row pitch
    ``Np`` that is a multiple of 4, and ``L`` 16-byte aligned.  Every
    pipelined geometry of the main paths has ``Np % 4 == 0``."""
    return (band_chase_wave.tma_shape_takes(n, band) and L.shape[1] % 4 == 0
            and L.data_ptr() % 16 == 0)


def superstep_design(L, n, band, LG, design=None):
    """The design a pass of ``LG`` sweeps on ``L`` takes, by shape before
    launch: "wave" (the pass's wavefront on the shared-memory tick) where
    :func:`superstep_takes` holds and ``LG >= SUPERSTEP_LANES``, else "l2"
    (the first design); or the one ``design`` names ("wave" raises where
    the shape is not taken).  A card-only choice: a CPU tensor runs the
    plain version whatever this says.

    LG = 1 passes (each sweep whole and in order on one CTA) take the first
    design: there a tick of the shared-memory design (a pair, its stores
    drained and a grid barrier: 5.44 us at b = 32) costs more than the
    first design's pair (~4.1 us).  The test reads LG, not the lanes that
    have pairs: a pass with LG >= 2 in which one sweep alone has pairs
    (the last groups near n, a rank's edge) takes the shared-memory design
    and pays that one-lane cost on its few pairs (the first row below) to
    keep the route free of a host-side count of the pass's pairs.  Rank
    0's group 0 pass at n = 1024, b = 32
    (one NVIDIA H100 80GB HBM3 at 700 W, ``tools/superstep_split.py``: the
    designs in turns, CUDA-event medians of 5, ms):

    ==========  ==  =====  =====  =============  =============
    LG (lanes)  tp  pairs  ticks  shared-memory  first design
    ==========  ==  =====  =====  =============  =============
    1           1   32     32     0.178 / 0.177  0.159 / 0.159
    2           1   64     35     0.215 / 0.211  0.303 / 0.300
    3           4   21     10     0.105 / 0.097  0.129 / 0.128
    11          1   352    62     0.384 / 0.343  1.443 / 1.449
    ==========  ==  =====  =====  =============  =============
    """
    if design not in (None, "wave", "l2"):
        raise ValueError(f"_design must be None, 'wave' or 'l2', got {design!r}")
    takes = superstep_takes(L, n, band)
    if design == "wave" and not takes:
        raise ValueError(f"the pass's shared-memory design does not take n={n}, "
                         f"band={band}, Np={L.shape[1]}")
    return design or ("wave" if takes and int(LG) >= SUPERSTEP_LANES else "l2")


def _barrier_counter(device, stream):
    """The grid barrier's counter of the pass's launches on ``device`` and
    ``stream``: one int32 kept for the process, which the C entry sets to
    zero on that stream before each launch (launches on one stream run in
    order, so they never share it at once)."""
    key = (device, stream)
    if key not in _counters:
        _counters[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _counters[key]


def _launch_superstep_wave(L, n, b, i0, LG, R0, U, m, last, s_chase):
    """One launch of the pass's wavefront kernel on the CUDA ``L``, in
    place; counted where it launched (a pass with no pair with work
    launches nothing)."""
    global launches_superstep, last_superstep_ctas
    rows, Np = L.shape
    stream = _build.stream_of(L)
    ctr = _barrier_counter(L.device, stream)
    got = ctypes.c_int(0)
    lib = _build.load("band_chase_superstep", _SUPERSTEP_ENTRIES)
    with torch.cuda.device(L.device):
        err = lib.svdt_band_chase_superstep_wave(
            L.data_ptr(), Np, rows, int(n), b, int(i0), int(LG), int(R0), int(U), int(m),
            int(bool(last)), int(s_chase), ctr.data_ptr(), 0, ctypes.addressof(got), stream)
    _build.raise_on_error(err, "band_chase_superstep_wave")
    last_superstep_ctas = got.value
    if got.value:
        launches_superstep += 1


def superstep(L, n, band, i0, LG, R0, U, m, last, s_chase, _design=None):
    """One rank's pass of one superstep of the pipelined chase, in place on
    its local buffer ``L`` (``U + m + 4 band`` rows, ``Np`` columns; the
    arguments are those of ``two_stage.chase_superstep``).  A CUDA tensor
    must be contiguous float32 with ``band <= band_chase_wave.
    band_range(n)``; it launches the design :func:`superstep_design` picks
    (``_design`` forces one): the pass's wavefront kernel, one CTA a sweep
    of the pass, the pairs by global tick with a grid barrier between
    ticks, each pair's window staged in shared memory by TMA; or the first
    design, one CTA walking the pass in order, every pair the L2 kernel's
    on the buffer through the accessor of local row ``r - R0 + U``.  Both
    read zero past ``n`` and drop writes there, and leave ``L`` bit-equal.
    A CPU tensor runs the plain version (``two_stage.chase_superstep``).
    Returns ``L``."""
    global launches_superstep_l2
    b = int(band)
    if not _build.check_input(L, "L", 2):
        return superstep_plain(L, n, b, i0, LG, R0, U, m, last, s_chase)
    rows, Np = L.shape
    if not 1 <= b <= band_chase_wave.band_range(n):
        raise ValueError(f"band={b} out of range for n={n}")
    if rows < U + m + 2 * b or Np < n:
        raise ValueError(f"local buffer {tuple(L.shape)} too small for U={U}, m={m}, n={n}")
    if superstep_design(L, n, b, LG, _design) == "wave":
        _launch_superstep_wave(L, n, b, i0, LG, R0, U, m, last, s_chase)
        return L
    lib = _build.load("band_chase", _ENTRIES)
    with torch.cuda.device(L.device):
        err = lib.svdt_band_chase_superstep(
            L.data_ptr(), Np, int(n), b, int(i0), int(LG), int(R0), int(U), int(m),
            int(bool(last)), int(s_chase), _build.stream_of(L))
    _build.raise_on_error(err, "band_chase_superstep")
    launches_superstep_l2 += 1
    return L
