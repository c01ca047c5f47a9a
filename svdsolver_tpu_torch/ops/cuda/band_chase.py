"""The band -> bidiagonal bulge chase in one launch, plain and recording,
on the sequential schedule, and the routes of its flags.

Two Hopper kernels run the sequential chase, both walking the schedule of
``models/two_stage`` on one CTA, whose ``band_to_bidiagonal`` and
``band_to_bidiagonal_accum`` are their plain versions (on a CPU tensor the
wrappers run those):

* the staged TMA design (``csrc/band_chase_staged.cu``): each pair's tiles
  copied by TMA into a ring of shared-memory slots ``khops`` pairs ahead;
  it runs wherever :func:`staged_tma_takes` holds (4 <= band <= 128, band
  and n multiples of 4, A 16-byte aligned: every band of the main paths);
* the L2 kernel (``csrc/band_chase.cu``): each pair on the matrix through
  L2.  It runs every other shape (bands past 256 on the wide pair of
  ``csrc/chase_pair.cuh``, bit-equal to the wavefront's L2 tick there), and
  is the bitwise oracle of the chase family (:func:`band_to_bidiagonal_l2`,
  :func:`band_to_bidiagonal_accum_l2`).

:func:`staged_route` picks between them by shape before launch.  So
:func:`band_to_bidiagonal` stands for the TPU's ``band_chase._chase_kernel``
(K3), ``_chase_kernel_pipelined`` (K14, ``pipelined``) and
``_chase_kernel_megapipe`` (K15, ``mega``), and :func:`band_to_bidiagonal_accum`
for ``_chase_kernel_rec`` (K6); both give the same ``(d, e)`` and records
bit for bit on either kernel.  The main paths take them wherever
``band_chase_wave.wave_chase_preferred`` (``svdvals``) or
``wave_chase_accum_preferred`` (``svd``, ``svds``) is false, and so stand
for ``band_chase_stream._stream_chase_kernel`` (K5, K8) there; elsewhere
the wavefront kernel (``band_chase_wave``) runs.  ``wavefront`` sends
:func:`band_to_bidiagonal` to the wavefront kernel too.  The TMA design's
plain version is ``two_stage.band_to_bidiagonal_staged_tiles`` (the copies
of ``chase_schedule.staged_copies``).
"""

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

_ENTRIES = {
    "svdt_band_chase": [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP],
    "svdt_band_chase_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP]
    ),
}
# the TMA design's static shared memory: v, col (SMEM_BAND each), vg
# (2 SMEM_BAND), partial sums (512), 2 taus, and an 8-byte mbarrier for each
# of up to STAGED_MAX_SLOTS ring slots (one parity bit each in a 32-bit mask)
STAGED_MAX_SLOTS = 31
STAGED_STATIC_SMEM = 4 * (4 * band_chase_wave.SMEM_BAND + 512 + 2) + 8 * STAGED_MAX_SLOTS

_STAGED_ENTRIES = {
    "svdt_band_chase_staged": [_build.VOIDP] * 3 + [_build.INT] * 3 + [_build.VOIDP],
    "svdt_band_chase_staged_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT] * 2 + [_build.VOIDP]
    ),
}

band_to_bidiagonal_plain = two_stage.band_to_bidiagonal
band_to_bidiagonal_accum_plain = two_stage.band_to_bidiagonal_accum


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
        s_max = s_max_of(n, b)
        VL, VR = torch.zeros((2, n - 1, s_max, b), dtype=A.dtype, device=A.device)
        TL, TR = torch.zeros((2, n - 1, s_max), dtype=A.dtype, device=A.device)
        recs = [VL, TL, VR, TR]
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
    launch of the kernel :func:`staged_route` picks (the L2 kernel with
    ``l2``)."""
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
    return _launch(A, b, K, record)


def band_to_bidiagonal(A, band=128, wavefront=False, pipelined=False,
                       mega=False, khops=4):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal; returns ``(d, e)``.

    A CUDA tensor must be contiguous float32 with a band ``band_chase_wave.
    band_range`` takes (any band up to 256; up to n past it, where the L2
    kernel runs the wide pair) and launches a kernel on a copy of ``A``
    (the chase runs in place on it); a CPU tensor runs the plain version.  ``wavefront`` runs the wavefront
    kernel (``band_chase_wave``).  Every other call runs the sequential
    chase, on the kernel :func:`staged_route` picks by shape: the staged
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
    ahead, or the L2 kernel) on a copy of ``A``.  Its
    ``(d, e)`` are bit-equal to :func:`band_to_bidiagonal`'s, its records
    to either kernel's.  The kernels store identity reflectors (and slots
    past the schedule) as zero rows with tau 0, where the plain version
    keeps ``v = e_0``; the back-transforms treat both alike.  A CPU tensor
    runs the plain version.
    """
    return _sequential(A, int(band), 1, record=True)


def band_to_bidiagonal_l2(A, band=128):
    """:func:`band_to_bidiagonal` on the L2 kernel at every shape: the
    bitwise oracle of the chase family, for the card's checks and timings.
    A CPU tensor runs the plain version."""
    return _sequential(A, int(band), 1, record=False, l2=True)


def band_to_bidiagonal_accum_l2(A, band=128):
    """:func:`band_to_bidiagonal_accum` on the L2 kernel's recording entry
    at every shape (the oracle of the recording chases)."""
    return _sequential(A, int(band), 1, record=True, l2=True)
