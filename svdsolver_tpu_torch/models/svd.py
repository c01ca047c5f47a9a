"""Top-level singular-value entry points (twin of
``svdsolver_tpu/models/svd.py``): the capability ladder ``base``,
``singlecore``, ``multicore``, ``tpu1``, ``tpu2`` and the batch entry.

``tpu2``: Stage I through the panel kernel, the chase routed by
``band_chase_wave.wave_chase_preferred`` to the wavefront or the
sequential chase (whose staged TMA design takes every band of this path).
``multicore``: the tiled Stage I (``ops/cuda/tiled_slab.py``: a chain
and an apply kernel launch a half-sweep) and the same routed chase.  ``base`` (Golub-Kahan) and
``singlecore`` (blocked one-stage) reduce straight to (d, e) in PyTorch
ops.  ``tpu1``: the plain two-stage path.  The kernels run for float32
CUDA tensors (:func:`use_kernels`), and there every method but ``tpu1``
diagonalizes with the bisection kernel; any other device or dtype takes the
plain path, chosen by the input and never as a fallback on failure.  All
three diagonalizers are ported: ``bisect``, ``qr`` and ``dqds`` (the last
two run their ``bidiag_qr`` / ``dqds`` kernel on any CUDA tensor).
"""

from typing import NamedTuple

import numpy as np
import torch

from svdsolver_tpu_torch.models.blocked import bidiagonalize_blocked
from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.golub_kahan import bidiagonalize_gk
from svdsolver_tpu_torch.models.tiled import dense_to_band_tiled_plain
from svdsolver_tpu_torch.models.two_stage import band_to_bidiagonal, dense_to_band
from svdsolver_tpu_torch.ops.cuda import (
    band_chase,
    band_chase_wave,
    bidiag_qr,
    bisect,
    dqds,
    panel_qr,
    tiled_slab,
)

METHODS = ("base", "singlecore", "multicore", "tpu1", "tpu2")


def as_input(A):
    """The real matrix an entry point works on.  A tensor keeps its device
    and dtype.  A numpy array or array-like goes to the CUDA card as float32
    (the JAX package's default placement and dtype); with no card this
    raises, it never runs on the CPU.  Complex input is taken by
    ``svdvals``, ``svd``, ``svd_c``, ``svdvals_c`` and ``linalg.eigh``
    only; any other entry raises ``TypeError`` on it."""
    A = _real(placed(A))
    if A.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    return A


def as_batch(As, name):
    """The (B, n, n) batch entry ``name`` works on, placed as
    :func:`as_input` places a matrix; any other shape raises."""
    As = _real(placed(As))
    if As.ndim != 3 or As.shape[-1] != As.shape[-2]:
        raise ValueError(f"{name} expects (B, n, n), got {tuple(As.shape)}")
    return As


def placed(A):
    """``A`` as a tensor: a tensor as it is; a numpy array or array-like on
    the CUDA card, as complex64 if it is complex and float32 otherwise;
    with no card this raises."""
    if isinstance(A, torch.Tensor):
        return A
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a numpy or array-like input runs on the CUDA card, and none "
            "is available; pass a torch.Tensor to run on its device"
        )
    dtype = np.complex64 if np.iscomplexobj(A) else np.float32
    return torch.as_tensor(np.asarray(A, dtype=dtype), device="cuda")


def _real(A):
    if A.is_complex():
        raise TypeError(
            "complex input is taken by svdvals, svd, svd_c, svdvals_c and "
            "linalg.eigh; this entry takes real input"
        )
    return A


def use_kernels(t):
    """The hand-written kernels take float32 tensors on a CUDA device."""
    return t.is_cuda and t.dtype == torch.float32


class Bidiagonal(NamedTuple):
    """Bidiagonal factor {d, e}."""

    d: torch.Tensor
    e: torch.Tensor


def _pad_to_multiple(A, b):
    n = A.shape[0]
    r = (-n) % b
    if r == 0:
        return A, n
    return torch.nn.functional.pad(A, (0, r, 0, r)), n


def _auto_block(n):
    """Band/panel width: wider bands shrink the sequential chase (n^2/b
    pairs) and fatten the Stage I GEMMs."""
    if n >= 1024:
        return 128
    if n >= 256:
        return 64
    return 32


def bidiagonalize(A, method="tpu2", block=None):
    """Reduce square ``A`` to bidiagonal form; returns :class:`Bidiagonal`.

    ``base``: Golub-Kahan, unblocked (the reference's ``brd``).
    ``singlecore``: blocked one-stage compact-WY, panel width ``block``
    (``block_brd``).  ``multicore``: the tiled Stage I (``brd_p1``), tiles
    of ``block``, through the chain and apply kernels for float32 CUDA input.
    ``tpu2``: Stage I through the panel kernel for float32 CUDA input.
    ``multicore`` and ``tpu2`` then take the chase kernel routed by
    :func:`band_chase_wave.wave_chase_preferred` (the wavefront kernel from
    n = 641, else the sequential chase, with the same ``(d, e)`` bit for
    bit); other input runs the plain versions.  ``tpu1``: the plain
    two-stage reduction.  ``block=None`` picks the band width by size.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    if block is None:
        block = _auto_block(A.shape[0])
    if method == "base":
        return Bidiagonal(*bidiagonalize_gk(A))
    if method == "singlecore":
        return Bidiagonal(*bidiagonalize_blocked(A, panel=block))
    Ap, n = _pad_to_multiple(A, block)
    stage1, stage2 = two_stage_fns(method, A)
    d, e = stage2(stage1(Ap, band=block), band=block)
    return Bidiagonal(d[:n], e[: n - 1])


def two_stage_fns(method, A):
    """``(stage1, stage2)``, each ``f(A, band=b)``: the Stage I and the
    chase :func:`bidiagonalize` runs for ``method`` (``multicore``,
    ``tpu1`` or ``tpu2``) on ``A``'s device and dtype.  For float32 CUDA
    input and a method other than ``tpu1``: the tiled Stage I's kernels
    (``multicore``) or the panel kernel (``tpu2``), then
    :func:`routed_chase`; otherwise the plain versions."""
    if method not in ("multicore", "tpu1", "tpu2"):
        raise ValueError(f"{method!r} is no two-stage method")
    on_card = method != "tpu1" and use_kernels(A)
    if method == "multicore":
        stage1 = tiled_slab.dense_to_band_tiled if on_card else dense_to_band_tiled_plain
    else:
        stage1 = panel_qr.dense_to_band_fused if on_card else dense_to_band
    return stage1, (routed_chase if on_card else band_to_bidiagonal)


def routed_chase(Ab, band):
    """The chase kernel for the band ``Ab``, picked by
    :func:`band_chase_wave.wave_chase_preferred`: the wavefront kernel from
    n = 641, else the sequential chase (the same ``(d, e)`` bit for bit)."""
    if band_chase_wave.wave_chase_preferred(Ab.shape[0], band):
        return band_chase_wave.band_to_bidiagonal_wave(Ab, band=band)
    return band_chase.band_to_bidiagonal(Ab, band=band)


def routed_chase_accum(Ab, band):
    """The recording chase kernel for the band ``Ab``, picked by
    :func:`band_chase_wave.wave_chase_accum_preferred`: the recording
    wavefront, else the recording sequential chase.  Returns ``(d, e, VL,
    TL, VR, TR)``."""
    if band_chase_wave.wave_chase_accum_preferred(Ab.shape[0], band):
        return band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=band)
    return band_chase.band_to_bidiagonal_accum(Ab, band=band)


def diagonalizer(method, diag, d):
    """The function ``f(d, e)`` :func:`svdvals` diagonalizes the bidiagonal
    ``{d, e}`` of ``method`` with: ``diag="qr"`` / ``"dqds"`` their
    wrappers (the kernels on any CUDA tensor); ``"bisect"`` the bisection
    kernel for float32 CUDA input and a method other than ``tpu1``, the
    plain bisection otherwise."""
    if diag == "qr":
        return bidiag_qr.bidiagonal_svdvals
    if diag == "dqds":
        return dqds.dqds_svdvals
    if diag != "bisect":
        raise ValueError(f"unknown diag {diag!r}; 'bisect', 'qr' or 'dqds'")
    if method != "tpu1" and use_kernels(d):
        return lambda d, e: bisect.bisect_svdvals(d.contiguous(), e.contiguous())
    return bisect_svdvals


def svdvals(A, method="tpu2", block=None, diag="bisect"):
    """Singular values of ``A`` (any shape), sorted descending.

    Bidiagonalize with the chosen method, then diagonalize: ``diag``
    'bisect' (default, parallel bisection), 'qr' (implicit-shift QR with
    deflation, the reference's ``qrd``) or 'dqds' (high relative accuracy,
    with the bisection as its safety net).  A rectangular input is first
    reduced to its square triangular factor by QR (sigma-preserving).
    ``A``: a tensor runs on its own device; a numpy array or array-like goes
    to the CUDA card as float32 (:func:`as_input`).
    A complex input (a complex tensor, a numpy complex array) runs
    :func:`~svdsolver_tpu_torch.models.complex_svd.svdvals_c` and takes
    only the defaults ``method="tpu2"``, ``diag="bisect"``.
    """
    from svdsolver_tpu_torch.models import complex_svd

    if complex_svd.is_complex_input(A):
        if method != "tpu2" or diag != "bisect":
            raise ValueError(
                "complex input supports only method='tpu2', diag='bisect' "
                f"(got method={method!r}, diag={diag!r}); call "
                "svdsolver_tpu_torch.models.complex_svd.svdvals_c directly"
            )
        return complex_svd.svdvals_c(A)
    A = as_input(A)
    if diag not in ("bisect", "qr", "dqds"):
        raise ValueError(f"unknown diag {diag!r}; 'bisect', 'qr' or 'dqds'")
    m, n = A.shape
    if m != n:
        if m < n:
            A = A.T
            m, n = n, m
        A = torch.linalg.qr(A, mode="r")[1][:n, :n].contiguous()
    B = bidiagonalize(A, method=method, block=block)
    return diagonalizer(method, diag, B.d)(B.d, B.e)[:n]


def svdvals_batch(As, block=None):
    """Singular values of a batch of square matrices: (B, n, n) -> (B, n).

    A loop over the batch, one :func:`svdvals` call a matrix (``jax.vmap``,
    which the reference batches with, has no counterpart over the
    hand-written kernels): on float32 CUDA input each matrix runs the panel
    kernel, the routed chase and the bisection kernel, elsewhere the plain
    path.  ``block=None`` takes ``_auto_block(n)`` as the reference does,
    with no halving when it reaches ``n``.  Input placement as
    :func:`as_input`, for (B, n, n).
    """
    As = as_batch(As, "svdvals_batch")
    n = As.shape[-1]
    block = _auto_block(n) if block is None else block
    return torch.stack([svdvals(A, block=block) for A in As])
