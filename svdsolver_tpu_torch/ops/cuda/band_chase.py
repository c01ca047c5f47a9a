"""The band -> bidiagonal bulge chase in one launch
(``csrc/band_chase.cu``), plain and recording, and the routes of its flags.

The sequential chase: one block walks the schedule of ``models/two_stage``,
whose ``band_to_bidiagonal`` and ``band_to_bidiagonal_accum`` are its plain
versions (on a CPU tensor the wrappers run those).  It is the bitwise
oracle of every chase kernel of the port.  With the wavefront kernel of
``band_chase_wave`` it stands for the TPU's ``band_chase._chase_kernel``,
``band_chase_wave._wave_chase_kernel`` and ``band_chase_stream.
_stream_chase_kernel`` (``rec=False``); its recording entry, with
``band_chase_wave.band_to_bidiagonal_wave_accum``, for their recording
twins ``_chase_kernel_rec``, ``_wave_chase_rec_kernel`` and
``_stream_chase_kernel`` with ``rec=True``.  The main paths take it
wherever ``band_chase_wave.wave_chase_preferred`` (``svdvals``) or
``wave_chase_accum_preferred`` (``svd``, ``svds``) is false, and the
wavefront kernel elsewhere; both give the same ``(d, e)`` and records bit
for bit.

The flags of :func:`band_to_bidiagonal` are those of the JAX package's
``band_to_bidiagonal_pallas``: ``wavefront`` runs the wavefront kernel
(``band_chase_wave``), ``pipelined`` and ``mega`` the staged kernel
(``csrc/band_chase_staged.cu``, TPU ``_chase_kernel_pipelined`` and
``_chase_kernel_megapipe``), which holds its windows in shared memory: one
CTA in the sequential order, each tile copied by TMA ``khops`` pairs ahead,
where :func:`staged_tma_takes` holds; other shapes take the sequential
kernel (:func:`staged_design`).  The TMA design's plain version is
``two_stage.band_to_bidiagonal_staged_tiles`` (the copies of
``chase_schedule.staged_copies``).
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build, band_chase_wave

launches = 0  # kernel launches by band_to_bidiagonal since the last reset
launches_rec = 0  # kernel launches by band_to_bidiagonal_accum likewise
launches_staged = 0  # staged-kernel launches, TMA design, likewise
launches_staged_v1 = 0  # staged-kernel launches, first design (``_design="v1"``), likewise
last_khops = 0  # pairs the copies of the last staged launch ran ahead

_ENTRIES = {
    "svdt_band_chase": [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP],
    "svdt_band_chase_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP]
    ),
}
MAX_BAND = 256  # the kernel's 2b window columns map onto its 512 threads
STAGED_MAX_BAND = 128  # the staged kernel's tiles fit shared memory up to here
# the TMA design's static shared memory: v, col (128 each), vg (256),
# partial sums (512), 2 taus, and an 8-byte mbarrier for each of up to
# STAGED_MAX_SLOTS ring slots (one parity bit each in a 32-bit mask)
STAGED_MAX_SLOTS = 31
STAGED_STATIC_SMEM = 4 * (4 * STAGED_MAX_BAND + 512 + 2) + 8 * STAGED_MAX_SLOTS

_STAGED_ENTRIES = {
    "svdt_band_chase_staged": [_build.VOIDP] * 3 + [_build.INT] * 4 + [_build.VOIDP],
}

band_to_bidiagonal_plain = two_stage.band_to_bidiagonal
band_to_bidiagonal_accum_plain = two_stage.band_to_bidiagonal_accum


def _check_band(A, b):
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if not 1 <= b <= MAX_BAND:
        raise ValueError(f"band={b} outside the kernel's range [1, {MAX_BAND}]")
    return n


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
    copy engine moves boxes of whole 16-byte rows, so ``band`` and ``n`` are
    multiples of 4 and ``A`` is 16-byte aligned, ``4 <= band <= 128``."""
    b, n = int(band), A.shape[0]
    return (4 <= b <= STAGED_MAX_BAND and b % 4 == 0 and n % 4 == 0
            and A.data_ptr() % 16 == 0)


def staged_design(A, band, pipelined=False, mega=False, khops=4, _design=None):
    """The staged kernel's design that :func:`band_to_bidiagonal`'s flags
    and ``A``'s shape pick, before launch: ``"tma"`` where the staged
    flags are set and :func:`staged_tma_takes` holds, ``"v1"`` (the first
    design: plain copies between block barriers) only when ``_design`` asks
    for it, ``None`` (the sequential kernel) for every other shape and
    flag.  The first design is slower than the sequential kernel at every
    shape timed, so it is kept only to time the two designs in turns;
    ``_design="tma"`` raises where the TMA design cannot run."""
    b = int(band)
    if _design not in (None, "tma", "v1"):
        raise ValueError(f"_design must be None, 'tma' or 'v1', got {_design!r}")
    if not (pipelined or (mega and khops > 1)) or b > STAGED_MAX_BAND:
        return None
    if _design == "v1":
        return "v1"
    if staged_tma_takes(A, b):
        return "tma"
    if _design == "tma":
        raise ValueError(f"the staged TMA design does not take n={A.shape[0]}, band={b}")
    return None


def band_to_bidiagonal(A, band=128, wavefront=False, pipelined=False,
                       mega=False, khops=4, _design=None):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal; returns ``(d, e)``.

    A CUDA tensor must be contiguous float32 with ``1 <= band <= 256`` and
    launches a kernel on a copy of ``A`` (the chase runs in place on it);
    a CPU tensor runs the plain version.  The flags pick the kernel in the
    JAX package's order: ``wavefront`` (the wavefront kernel,
    ``band_chase_wave``), then ``pipelined`` (the staged kernel, one pair a
    window), then ``mega`` with ``khops > 1`` (the staged kernel, up to
    ``khops`` pairs ahead: the largest that fits shared memory, recorded
    in ``last_khops``), else the sequential kernel.  The staged kernel runs
    its TMA design where :func:`staged_tma_takes` holds; ``_design="v1"``
    forces its first design, for timing the two in turns
    (:func:`staged_design`).  These routes are decided by shape before
    launch: a shape the TMA design does not take, and a band above 128,
    take the sequential kernel under ``pipelined`` or ``mega``, as the TPU
    sends bands that are not multiples of 128 to its sequential kernel (its
    128-lane gates are alignment rules the card does not have).  Every
    route gives the same ``(d, e)``, bit for bit; on the CPU ``wavefront``
    runs the plain wavefront schedule and the others the plain sequential
    chase.
    """
    global launches, launches_staged, launches_staged_v1, last_khops
    b = int(band)
    if int(khops) < 1:
        raise ValueError(f"khops must be >= 1, got {khops}")
    if wavefront:
        return band_chase_wave.band_to_bidiagonal_wave(A, band=b)
    design = staged_design(A, b, pipelined, mega, khops, _design)
    staged = design is not None
    if not _build.check_input(A, "A", 2):
        _check_band(A, b)
        return band_to_bidiagonal_plain(A, band=b)
    n = _check_band(A, b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        if staged:
            K = 1 if pipelined else staged_khops(b, khops)
            lib = _build.load("band_chase_staged", _STAGED_ENTRIES)
            err = lib.svdt_band_chase_staged(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, K,
                int(design == "v1"), _build.stream_of(A),
            )
        else:
            lib = _build.load("band_chase", _ENTRIES)
            err = lib.svdt_band_chase(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                _build.stream_of(A),
            )
    _build.raise_on_error(err, "band_chase_staged" if staged else "band_chase")
    if staged:
        if design == "tma":
            launches_staged += 1
        else:
            launches_staged_v1 += 1
        last_khops = K
    else:
        launches += 1
    return d, e


def band_to_bidiagonal_accum(A, band=128):
    """Bulge-chase the upper-band ``A`` to bidiagonal, recording every
    reflector; returns ``(d, e, VL, TL, VR, TR)`` as
    ``models.two_stage.band_to_bidiagonal_accum``.

    A CUDA tensor must be contiguous float32 with ``n >= 2`` and
    ``1 <= band <= 256``; it launches the recording kernel on a copy of
    ``A``, whose ``(d, e)`` are bit-equal to :func:`band_to_bidiagonal`'s.
    The kernel stores identity reflectors (and slots past the schedule) as
    zero rows with tau 0, where the plain version keeps ``v = e_0``; the
    back-transforms treat both alike.  A CPU tensor runs the plain version.
    """
    global launches_rec
    b = int(band)
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_accum_plain(A, band=b)
    n = _check_band(A, b)
    if n < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    s_max = s_max_of(n, b)
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    # zeros: the kernel writes only the slots the schedule reaches
    VL, VR = torch.zeros((2, n - 1, s_max, b), dtype=A.dtype, device=A.device)
    TL, TR = torch.zeros((2, n - 1, s_max), dtype=A.dtype, device=A.device)
    lib = _build.load("band_chase", _ENTRIES)
    with torch.cuda.device(A.device):
        err = lib.svdt_band_chase_rec(
            work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
            VL.data_ptr(), TL.data_ptr(), VR.data_ptr(), TR.data_ptr(),
            s_max, _build.stream_of(A),
        )
    _build.raise_on_error(err, "band_chase_rec")
    launches_rec += 1
    return d, e, VL, TL, VR, TR
