"""The band -> bidiagonal chase on the wavefront schedule, one CTA a lane
(``csrc/band_chase_wave.cu``): plain, recording, and with deferred left
applies.

``band_to_bidiagonal_wave`` stands for the TPU's ``band_chase_wave.
_wave_chase_kernel`` and ``band_chase._wavefront_kernel`` (the
``wavefront=True`` route of ``band_to_bidiagonal_pallas``, which
:func:`band_chase.band_to_bidiagonal` sends here too) and is the
counterpart of the JAX package's ``band_to_bidiagonal_pallas_wave``.
``band_to_bidiagonal_wave_accum`` stands for ``band_chase_wave.
_wave_chase_rec_kernel`` (``band_to_bidiagonal_pallas_wave_accum``): it also
records every reflector, bit-equal to the sequential recording chase's.
``band_to_bidiagonal_wave_dl`` stands for ``band_chase_wave.
_wave_chase_dl_kernel``: each pair's left apply is deferred one tick and
fused into the same sweep's next right apply.  All give ``(d, e)``
bit-equal to the sequential chase kernel's.  Their plain versions are
``models.two_stage.band_to_bidiagonal_wavefront`` (``record``,
``defer_left``); a CPU tensor runs those.

The wavefront runs sweeps three slots apart at once, each lane on its own
CTA of a cooperative launch with a grid barrier between ticks.  The main
paths route by :func:`wave_chase_preferred` (``svdvals``) and
:func:`wave_chase_accum_preferred` (``svd``, ``svds``), measured on the
card; elsewhere they take the sequential kernel (``band_chase``).
"""

import ctypes

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by band_to_bidiagonal_wave since the last reset
launches_dl = 0  # kernel launches by band_to_bidiagonal_wave_dl likewise
launches_rec = 0  # kernel launches by band_to_bidiagonal_wave_accum likewise
last_ctas = 0  # CTAs of the last launch (lanes stride over them)

MAX_BAND = 256  # the one chase pair's 2b window columns on 512 threads

_ENTRIES = {
    "svdt_band_chase_wave": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP, _build.INT]
        + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP, _build.INT] + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_dl": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 3
        + [_build.INT] * 2 + [_build.VOIDP] * 2
    ),
}


def band_to_bidiagonal_wave_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band)


def band_to_bidiagonal_wave_accum_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band, record=True)


def band_to_bidiagonal_wave_dl_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band, defer_left=True)


def _check_band(A, b):
    """``n`` of a square ``A`` whose band ``b`` the wave kernel takes."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if not 1 <= b <= MAX_BAND:
        raise ValueError(f"band={b} outside the kernel's range [1, {MAX_BAND}]")
    return A.shape[0]


def _launch(A, b, defer_left, ctas, record=False):
    global last_ctas
    n = A.shape[0]
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    ctr = torch.zeros((1,), dtype=torch.int32, device=A.device)  # grid barrier
    got = ctypes.c_int(0)
    max_ctas = 0 if ctas is None else int(ctas)
    if ctas is not None and max_ctas < 1:
        raise ValueError(f"_ctas must be >= 1, got {ctas}")
    lib = _build.load("band_chase_wave", _ENTRIES)
    with torch.cuda.device(A.device):
        if record:
            s_max = s_max_of(n, b)
            # zeros: the kernel writes only the slots the schedule reaches
            VL, VR = torch.zeros((2, n - 1, s_max, b), dtype=A.dtype, device=A.device)
            TL, TR = torch.zeros((2, n - 1, s_max), dtype=A.dtype, device=A.device)
            err = lib.svdt_band_chase_wave_rec(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                VL.data_ptr(), TL.data_ptr(), VR.data_ptr(), TR.data_ptr(),
                s_max, ctr.data_ptr(), max_ctas, ctypes.addressof(got),
                _build.stream_of(A),
            )
        elif defer_left:
            slots = two_stage.wave_lanes(n, b, defer_left=True) + 2
            ring_v = torch.zeros((slots, b), dtype=A.dtype, device=A.device)
            ring_t = torch.zeros((slots,), dtype=A.dtype, device=A.device)
            err = lib.svdt_band_chase_wave_dl(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                ctr.data_ptr(), ring_v.data_ptr(), ring_t.data_ptr(), slots,
                max_ctas, ctypes.addressof(got), _build.stream_of(A),
            )
        else:
            err = lib.svdt_band_chase_wave(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                ctr.data_ptr(), max_ctas, ctypes.addressof(got),
                _build.stream_of(A),
            )
    name = "_rec" if record else "_dl" if defer_left else ""
    _build.raise_on_error(err, "band_chase_wave" + name)
    last_ctas = got.value
    return (d, e, VL, TL, VR, TR) if record else (d, e)


def band_to_bidiagonal_wave(A, band=128, _ctas=None):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal on the wavefront schedule; returns ``(d, e)``, bit-equal to
    the sequential chase's.

    A CUDA tensor must be contiguous float32 with ``1 <= band <= 256``; it
    launches the kernel on a copy of ``A`` over as many CTAs as lanes, or as
    fit on the card at once (``_ctas`` caps them; lanes stride over CTAs).
    A CPU tensor runs the plain version.
    """
    global launches
    b = int(band)
    n = _check_band(A, b)
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_wave_plain(A, band=b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    out = _launch(A, b, False, _ctas)
    launches += 1
    return out


def band_to_bidiagonal_wave_dl(A, band=128, _ctas=None):
    """As :func:`band_to_bidiagonal_wave`, each pair's left apply deferred
    one tick and fused into the same sweep's next right apply (two passes
    over a pair's rows instead of three); ``(d, e)`` bit-equal to
    :func:`band_to_bidiagonal_wave`'s.  A CPU tensor runs the plain
    version (``band_to_bidiagonal_wavefront(defer_left=True)``).
    """
    global launches_dl
    b = int(band)
    n = _check_band(A, b)
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_wave_dl_plain(A, band=b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    out = _launch(A, b, True, _ctas)
    launches_dl += 1
    return out


def band_to_bidiagonal_wave_accum(A, band=128, _ctas=None):
    """As :func:`band_to_bidiagonal_wave`, recording every reflector;
    returns ``(d, e, VL, TL, VR, TR)`` as ``band_chase.
    band_to_bidiagonal_accum``, whose kernel fills the same slots with the
    same values, bit for bit (zero rows with tau 0 for identity reflectors
    and the slots the schedule never reaches).  Counterpart of the JAX
    ``band_to_bidiagonal_pallas_wave_accum``.  A CPU tensor runs the plain
    version (``band_to_bidiagonal_wavefront(record=True)``, whose records
    keep ``v = e_0`` for identity reflectors, as the plain sequential
    chase's do).
    """
    global launches_rec
    b = int(band)
    n = _check_band(A, b)
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_wave_accum_plain(A, band=b)
    if n < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    out = _launch(A, b, False, _ctas, record=True)
    launches_rec += 1
    return out


def wave_chase_preferred(n, band):
    """Whether ``svdvals`` takes the wavefront chase for an (n, n) band of
    ``band``: where its sweeps run in two lanes or more
    (``two_stage.wave_lanes(n, band) >= 2``).  With one lane the head pair
    and the one chase lane cannot hide the grid barrier a tick.

    Measured on one NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``,
    ``phase_route_times``: Stage I bands of a uniform matrix, the two
    kernels in turns), ms:

    ==========  =====  ==========  =========  ======
    n / band    lanes  sequential  wavefront  routed
    ==========  =====  ==========  =========  ======
    256 / 64    1      2.883       4.495      sequential
    1024 / 64   5      43.576      22.820     wavefront
    2048 / 128  5      239.883     116.476    wavefront
    3840 / 128  10     849.720     228.468    wavefront
    7680 / 128  20     3409.467    473.094    wavefront
    ==========  =====  ==========  =========  ======
    """
    return two_stage.wave_lanes(int(n), int(band)) >= 2


def wave_chase_accum_preferred(n, band):
    """Whether ``svd`` and ``svds`` take the recording wavefront chase: the
    rule of :func:`wave_chase_preferred`, two lanes or more.

    Measured as there (recording entries, ms):

    ==========  =====  ==========  =========  ======
    n / band    lanes  sequential  wavefront  routed
    ==========  =====  ==========  =========  ======
    256 / 64    1      3.123       4.790      sequential
    1024 / 64   5      46.521      24.034     wavefront
    2048 / 128  5      244.518     121.407    wavefront
    3840 / 128  10     865.095     237.936    wavefront
    7680 / 128  20     3469.747    490.250    wavefront
    ==========  =====  ==========  =========  ======
    """
    return two_stage.wave_lanes(int(n), int(band)) >= 2
