"""Kernel 3: the band -> bidiagonal bulge chase in one launch
(``csrc/band_chase.cu``).

One Hopper kernel stands for the three chase kernels the TPU routes by where
the band fits: ``band_chase._chase_kernel``, ``band_chase_wave.
_wave_chase_kernel`` and ``band_chase_stream._stream_chase_kernel``
(``rec=False``).  It walks the sequential schedule of
``models/two_stage.band_to_bidiagonal``, which is its plain version: on a
CPU tensor :func:`band_to_bidiagonal` runs that.
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by band_to_bidiagonal since the last reset

_ENTRIES = {
    "svdt_band_chase": [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP],
}
MAX_BAND = 256  # the kernel's 2b window columns map onto its 512 threads

band_to_bidiagonal_plain = two_stage.band_to_bidiagonal


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
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if not 1 <= b <= MAX_BAND:
        raise ValueError(f"band={b} outside the kernel's range [1, {MAX_BAND}]")
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
