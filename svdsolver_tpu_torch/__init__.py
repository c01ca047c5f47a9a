"""svdsolver_tpu_torch — the PyTorch/CUDA port of svdsolver_tpu for one
NVIDIA H100.

Ported: ``svdvals(A)`` with all three diagonalizers (bisection, QR with
deflation, dqds) on every rung of the ladder (``base``: Golub-Kahan
``bidiagonalize_gk``; ``singlecore``: the blocked ``bidiagonalize_blocked``;
``multicore``: the tiled Stage I; ``tpu1``, ``tpu2``: two-stage), the full
SVD ``svd(A)`` / ``svds(A, k)`` (recording reduction, bisection, TGK
inverse iteration, back-transforms; ``svd(method="singlecore")`` the
one-stage reduction with factors; ``svd(method="jacobi")``, one-sided
block Jacobi: ``svd_jacobi``, ``svd_jacobi_batch``, ``svd_jacobi_pre``, on
PyTorch ops), the batch entries ``svdvals_batch`` and
``svd_batch`` (a loop over the batch), the chase
variants (``bidiagonalize_two_stage``, the wavefront schedule, the flags of
``ops.cuda.band_chase.band_to_bidiagonal`` and the packed and
deferred-left chases of ``ops.cuda``), the bidiagonal diagonalizers
themselves (``givens``, the QR sweeps and driver, ``dqds_svdvals``) and the
SVD applications of ``linalg`` (``pinv``, ``lstsq``, ``matrix_rank``,
``cond``, ``norm2``, ``lowrank``, ``rsvd``, ``polar``, ``eigh``, ``orth``,
``null_space``), complex SVD on torch complex dtypes (``svd_c``,
``svdvals_c``; ``svdvals``, ``svd`` and ``linalg.eigh`` dispatch complex
input to them), successive band reduction (``models.sbr``), the utilities
(``utils``: fixtures, CSV, timing, profiling, the native C++ oracle's
loader), the command line (``python -m svdsolver_tpu_torch``) and the
sharded entries of ``parallel`` on ``torch.distributed`` (the mesh and its
collectives, ``spawn``, ``svdvals_sharded``, ``svd_sharded``, the batch
entries, the pipelined chase, ``svd_jacobi_sharded``, ``dryrun``).  They
are plain PyTorch functions on tensors, with
hand-written CUDA kernels (``csrc/``) on the card: for float32 tensors the
Stage I panel QR, the band -> bidiagonal chase (plain, recording, wavefront
with and without deferred left applies, staged in shared memory, packed),
the bisection, the TGK tridiagonal solve and the tiled Stage I (a chain
and an apply kernel a half-sweep) and the pipelined chase's superstep;
for float32 and float64
tensors the QR and dqds diagonalizers, each loop in one launch.  Names and
signatures follow ``svdsolver_tpu`` for what is ported.  This package
imports torch and never jax.
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
from svdsolver_tpu_torch.ops.givens import givens
from svdsolver_tpu_torch.models.golub_kahan import bidiagonalize_gk
from svdsolver_tpu_torch.models.blocked import bidiagonalize_blocked
from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.ops.cuda.bidiag_qr import (
    zero_shift_sweep,
    shifted_sweep,
    diag_reduce_fixed_iter,
    bidiagonal_svdvals,
    convergence_threshold,
)
from svdsolver_tpu_torch.ops.cuda.dqds import dqds_svdvals
from svdsolver_tpu_torch.models.svd import svdvals, svdvals_batch, Bidiagonal
from svdsolver_tpu_torch.models.vectors import svd, svds, svd_batch, bidiagonal_svd
from svdsolver_tpu_torch.models.complex_svd import svd_c, svdvals_c
from svdsolver_tpu_torch.models.jacobi import (
    svd_jacobi,
    svd_jacobi_batch,
    svd_jacobi_pre,
)
from svdsolver_tpu_torch.linalg import (
    pinv,
    lstsq,
    matrix_rank,
    cond,
    norm2,
    lowrank,
    rsvd,
    polar,
    eigh,
    orth,
    null_space,
)

__version__ = "0.1.0"

__all__ = [
    "householder_vector",
    "apply_left",
    "apply_right",
    "givens",
    "bidiagonalize_gk",
    "bidiagonalize_blocked",
    "dense_to_band",
    "band_to_bidiagonal",
    "bidiagonalize_two_stage",
    "zero_shift_sweep",
    "shifted_sweep",
    "diag_reduce_fixed_iter",
    "bidiagonal_svdvals",
    "bisect_svdvals",
    "dqds_svdvals",
    "convergence_threshold",
    "svdvals",
    "svdvals_batch",
    "Bidiagonal",
    "svd",
    "svds",
    "svd_batch",
    "bidiagonal_svd",
    "svd_c",
    "svdvals_c",
    "svd_jacobi",
    "svd_jacobi_batch",
    "svd_jacobi_pre",
    "pinv",
    "lstsq",
    "matrix_rank",
    "cond",
    "norm2",
    "lowrank",
    "rsvd",
    "polar",
    "eigh",
    "orth",
    "null_space",
]
