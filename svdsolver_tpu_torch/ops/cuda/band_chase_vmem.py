"""The band -> bidiagonal chase on a compact band store: the port of the
TPU's ``band_chase_vmem._vmem_chase_kernel`` (K12,
``svdsolver_tpu/ops/pallas/band_chase_vmem.py:180``).

The TPU kernel chases the band block-packed into VMEM
(``P[row, l] = A[row, 128 * (row // 128) - 128 + l]``, ``l < 512``;
``models.two_stage.pack_band``) and reads d and e out of it.  The packing
lined up VMEM lanes; the port keeps its own layouts, and two kernels run
the chase, chosen by shape before launch (:func:`vmem_route`):

* ``"tma"``, for ``4 <= band <= 128`` with ``band % 4 == 0`` and any n:
  ``svdt_band_chase_vmem_tma`` (``csrc/band_chase_staged.cu``) packs the
  band into the skewed band store (entry ``(g, j)`` at ``(3 band + 8) g +
  j``; ``two_stage.pack_store``) and runs the staged TMA design of the
  sequential chase on it, each pair's tiles copied by TMA one pair ahead.
  Its plain twin is ``two_stage.band_to_bidiagonal_store_tiles``.
* ``"packed"``, for the other bands up to 128: ``svdt_band_chase_vmem``
  (``csrc/band_chase_vmem.cu``) packs the band as the TPU does and walks
  the chase through L2.

Each allocates its store and ``(d, e)``, nothing of n x n: ``A`` is read,
not modified.  Both give ``(d, e)`` bit-equal to the sequential chase's
(``band_chase.band_to_bidiagonal_l2``).  Nothing falls back: a failed
launch raises.  A CPU tensor runs the plain version.
"""

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import store_floats
from svdsolver_tpu_torch.ops.cuda import _build

# Launches by band_to_bidiagonal_vmem since the last reset, by the kernel
# that ran
launches = 0  # the L2 packed kernel
launches_tma = 0  # the staged TMA design on the band store

MAX_BAND = 128  # the packed kernel's windows stay in lanes [1, 511); the TMA design's boxes
STORE_KHOPS = 1  # the TMA design's lookahead (the ring of 3 slots fits at b = 128)

_ENTRIES = {
    "svdt_band_chase_vmem": [_build.VOIDP] * 4 + [_build.INT] * 3 + [_build.VOIDP],
}
_TMA_ENTRIES = {
    "svdt_band_chase_vmem_tma": [_build.VOIDP] * 4 + [_build.INT] * 3 + [_build.VOIDP],
}


def vmem_chase_supported(n, band):
    """True when the packed chase takes an (n, n) band of ``band``."""
    return n >= 1 and 1 <= int(band) <= MAX_BAND


def vmem_route(A, band):
    """The kernel that chases ``A`` with ``band``, by shape before launch:
    ``"tma"`` (the staged TMA design on the band store) where ``4 <= band
    <= 128`` and ``band % 4 == 0``, ``"packed"`` (the L2 packed kernel) for
    the other bands the packed chase takes.  The store's pitch is set by
    the band, so n and ``A``'s address do not enter."""
    b = int(band)
    if not vmem_chase_supported(A.shape[0], b):
        raise ValueError(f"band={b} outside the packed chase's range [1, {MAX_BAND}]")
    return "tma" if b >= 4 and b % 4 == 0 else "packed"


def band_to_bidiagonal_vmem_plain(A, band=128):
    n = A.shape[0]
    P = two_stage.pack_band(A, band)
    return two_stage.band_to_bidiagonal(two_stage.unpack_band(P, n), band=band)


def _launch(A, b, route):
    """One launch of the kernel ``route`` names on the CUDA ``A``, counted
    by that kernel; returns ``(d, e)``."""
    global launches, launches_tma
    n = A.shape[0]
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        if route == "tma":
            St = torch.empty((store_floats(n, b),), dtype=A.dtype, device=A.device)
            lib = _build.load("band_chase_staged", _TMA_ENTRIES)
            err = lib.svdt_band_chase_vmem_tma(
                A.data_ptr(), St.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                STORE_KHOPS, _build.stream_of(A))
        else:
            Npad = two_stage.packed_rows(n, b)
            P = torch.empty((Npad, two_stage.PACK_WIDTH), dtype=A.dtype, device=A.device)
            lib = _build.load("band_chase_vmem", _ENTRIES)
            err = lib.svdt_band_chase_vmem(
                A.data_ptr(), P.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, Npad,
                _build.stream_of(A))
    _build.raise_on_error(err, "band_chase_vmem_tma" if route == "tma" else "band_chase_vmem")
    if route == "tma":
        launches_tma += 1
    else:
        launches += 1
    return d, e


def band_to_bidiagonal_vmem(A, band=128):
    """Bulge-chase the upper-band ``A`` (n, n) to bidiagonal through a
    compact copy of its band; returns ``(d, e)``, bit-equal to the
    sequential chase's.

    A CUDA tensor must be contiguous float32 with ``1 <= band <= 128``; it
    launches the kernel :func:`vmem_route` picks.  A CPU tensor runs the
    plain version.
    """
    b = int(band)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    route = vmem_route(A, b)  # checks the band
    if not _build.check_input(A, "A", 2):
        return band_to_bidiagonal_vmem_plain(A, band=b)
    if A.shape[0] < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    return _launch(A, b, route)
