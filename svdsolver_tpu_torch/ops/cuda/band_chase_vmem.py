"""The band -> bidiagonal chase on the block-packed band
(``csrc/band_chase_vmem.cu``).

It stands for the TPU's ``band_chase_vmem._vmem_chase_kernel``: the
sequential chase on ``P[row, l] = A[row, 128 * (row // 128) - 128 + l]``
(``l < 512``; ``models.two_stage.pack_band``), d and e read out of ``P``.
On the TPU the packing is where the band lived: whole in VMEM, under a
14 MB gate.  The card keeps ``P`` in device memory, where at 8.9 MB for
n = 3840, band 128 it stays resident in the 50 MB L2, so there is no size
gate; the band gate ``band <= 128`` is the bound under which every window
stays in ``P``'s 512 lanes.  ``(d, e)`` are bit-equal to the sequential
chase kernel's.  The plain version packs, unpacks and runs the sequential
plain chase; a CPU tensor runs it.
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.cuda import _build

launches = 0  # kernel launches by band_to_bidiagonal_vmem since the last reset

MAX_BAND = 128  # windows stay in the packed lanes [1, 511)

_ENTRIES = {
    "svdt_band_chase_vmem": [_build.VOIDP] * 4 + [_build.INT] * 3 + [_build.VOIDP],
}


def vmem_chase_supported(n, band):
    """True when the packed chase takes an (n, n) band of ``band``."""
    return n >= 1 and 1 <= int(band) <= MAX_BAND


def band_to_bidiagonal_vmem_plain(A, band=128):
    n = A.shape[0]
    P = two_stage.pack_band(A, band)
    return two_stage.band_to_bidiagonal(two_stage.unpack_band(P, n), band=band)


def band_to_bidiagonal_vmem(A, band=128):
    """Bulge-chase the upper-band ``A`` (n, n) to bidiagonal through its
    packed band; returns ``(d, e)``, bit-equal to the sequential chase's.

    A CUDA tensor must be contiguous float32 with ``1 <= band <= 128``; it
    launches the pack and the chase on a packed copy (``A`` is not
    modified).  A CPU tensor runs the plain version.
    """
    global launches
    b = int(band)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    n = A.shape[0]
    if not vmem_chase_supported(n, b):
        raise ValueError(f"band={b} outside the packed chase's range [1, {MAX_BAND}]")
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_vmem_plain(A, band=b)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    Npad = two_stage.packed_rows(n, b)
    P = torch.empty((Npad, two_stage.PACK_WIDTH), dtype=A.dtype, device=A.device)
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    lib = _build.load("band_chase_vmem", _ENTRIES)
    with torch.cuda.device(A.device):
        err = lib.svdt_band_chase_vmem(
            A.data_ptr(), P.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, Npad,
            _build.stream_of(A),
        )
    _build.raise_on_error(err, "band_chase_vmem")
    launches += 1
    return d, e
