"""svdsolver_tpu_torch — the PyTorch/CUDA port of svdsolver_tpu for one
NVIDIA H100.

Three slices are ported: ``svdvals(A)`` (two-stage reduction and
bisection), the full SVD ``svd(A)`` / ``svds(A, k)`` (recording
reduction, bisection, TGK inverse iteration, back-transforms), and the
chase variants (``bidiagonalize_two_stage``, the wavefront schedule, the
flags of ``ops.cuda.band_chase.band_to_bidiagonal`` and the packed and
deferred-left chases of ``ops.cuda``).  They are plain PyTorch functions
on tensors, with hand-written CUDA kernels (``csrc/``) for float32 tensors
on the card: the Stage I panel QR, the band -> bidiagonal chase (plain,
recording, wavefront with and without deferred left applies, staged in
shared memory, packed), the bisection and the TGK tridiagonal solve.  Names and signatures follow ``svdsolver_tpu`` for what
is ported.  This package imports torch and never jax.
"""

from svdsolver_tpu_torch.ops.householder import (
    householder_vector,
    apply_left,
    apply_right,
)
from svdsolver_tpu_torch.models.two_stage import (
    dense_to_band,
    band_to_bidiagonal,
    bidiagonalize_two_stage,
)
from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.svd import svdvals, Bidiagonal
from svdsolver_tpu_torch.models.vectors import svd, svds, bidiagonal_svd

__version__ = "0.1.0"

__all__ = [
    "householder_vector",
    "apply_left",
    "apply_right",
    "dense_to_band",
    "band_to_bidiagonal",
    "bidiagonalize_two_stage",
    "bisect_svdvals",
    "svdvals",
    "Bidiagonal",
    "svd",
    "svds",
    "bidiagonal_svd",
]
