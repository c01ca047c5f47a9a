"""The band -> bidiagonal bulge chase in one launch
(``csrc/band_chase.cu``), plain and recording.

One Hopper kernel stands for the three chase kernels the TPU routes by where
the band fits: ``band_chase._chase_kernel``, ``band_chase_wave.
_wave_chase_kernel`` and ``band_chase_stream._stream_chase_kernel``
(``rec=False``).  Its recording entry stands for their recording twins,
``band_chase._chase_kernel_rec``, ``band_chase_wave._wave_chase_rec_kernel``
and ``_stream_chase_kernel`` with ``rec=True``.  Both walk the sequential
schedule of ``models/two_stage``, whose ``band_to_bidiagonal`` and
``band_to_bidiagonal_accum`` are their plain versions: on a CPU tensor the
wrappers run those.
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by band_to_bidiagonal since the last reset
launches_rec = 0  # kernel launches by band_to_bidiagonal_accum likewise

_ENTRIES = {
    "svdt_band_chase": [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP],
    "svdt_band_chase_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP]
    ),
}
MAX_BAND = 256  # the kernel's 2b window columns map onto its 512 threads

band_to_bidiagonal_plain = two_stage.band_to_bidiagonal
band_to_bidiagonal_accum_plain = two_stage.band_to_bidiagonal_accum


def _check_band(A, b):
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if not 1 <= b <= MAX_BAND:
        raise ValueError(f"band={b} outside the kernel's range [1, {MAX_BAND}]")
    return n


def band_to_bidiagonal(A, band=128):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal; returns ``(d, e)``.

    A CUDA tensor must be contiguous float32 with ``1 <= band <= 256`` and
    launches the kernel on a copy of ``A`` (the chase runs in place on it);
    a CPU tensor runs the plain version.
    """
    global launches
    b = int(band)
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_plain(A, band=b)
    n = _check_band(A, b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    lib = _build.load("band_chase", _ENTRIES)
    with torch.cuda.device(A.device):
        err = lib.svdt_band_chase(
            work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
            _build.stream_of(A),
        )
    _build.raise_on_error(err, "band_chase")
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
