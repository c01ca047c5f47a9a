"""svdsolver_tpu_torch — the PyTorch/CUDA port of svdsolver_tpu for one
NVIDIA H100.

Two slices are ported: ``svdvals(A)`` (two-stage reduction and
bisection) and the full SVD ``svd(A)`` / ``svds(A, k)`` (recording
reduction, bisection, TGK inverse iteration, back-transforms).  They are
plain PyTorch functions on tensors, with hand-written CUDA kernels
(``csrc/``) for float32 tensors on the card: the Stage I panel QR, the
band -> bidiagonal chase (plain and recording), the bisection and the TGK
tridiagonal solve.  Names and signatures follow ``svdsolver_tpu`` for what
is ported.  This package imports torch and never jax.
"""

from svdsolver_tpu_torch.ops.householder import (
    householder_vector,
    apply_left,
    apply_right,
)
from svdsolver_tpu_torch.models.two_stage import dense_to_band, band_to_bidiagonal
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
    "bisect_svdvals",
    "svdvals",
    "Bidiagonal",
    "svd",
    "svds",
    "bidiagonal_svd",
]
