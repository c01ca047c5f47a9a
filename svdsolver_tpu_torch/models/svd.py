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
    """The matrix an entry point works on.  A tensor keeps its device and
    dtype.  A numpy array or array-like goes to the CUDA card as float32
    (the JAX package's default placement and dtype); with no card this
    raises, it never runs on the CPU.  Complex input is not ported."""
    A = _placed(A)
    if A.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    return A


def as_batch(As, name):
    """The (B, n, n) batch entry ``name`` works on, placed as
    :func:`as_input` places a matrix; any other shape raises."""
    As = _placed(As)
    if As.ndim != 3 or As.shape[-1] != As.shape[-2]:
        raise ValueError(f"{name} expects (B, n, n), got {tuple(As.shape)}")
    return As


def _placed(A):
    if isinstance(A, torch.Tensor):
        if A.is_complex():
            _complex()
        return A
    if np.iscomplexobj(A):
        _complex()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a numpy or array-like input runs on the CUDA card, and none "
            "is available; pass a torch.Tensor to run on its device"
        )
    return torch.as_tensor(np.asarray(A, dtype=np.float32), device="cuda")


def _complex():
    raise NotImplementedError(
        "complex input is not ported yet: ROADMAP queue 1, item 12"
    )


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
    on_card = method != "tpu1" and use_kernels(A)
    if method == "multicore":
        Ab = (tiled_slab.dense_to_band_tiled(Ap, band=block) if on_card
              else dense_to_band_tiled_plain(Ap, band=block))
    elif on_card:
        Ab = panel_qr.dense_to_band_fused(Ap, band=block)
    else:
        Ab = dense_to_band(Ap, band=block)
    if not on_card:
        d, e = band_to_bidiagonal(Ab, band=block)
    elif band_chase_wave.wave_chase_preferred(Ab.shape[0], block):
        d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=block)
    else:
        d, e = band_chase.band_to_bidiagonal(Ab, band=block)
    return Bidiagonal(d[:n], e[: n - 1])


def svdvals(A, method="tpu2", block=None, diag="bisect"):
    """Singular values of ``A`` (any shape), sorted descending.

    Bidiagonalize with the chosen method, then diagonalize: ``diag``
    'bisect' (default, parallel bisection), 'qr' (implicit-shift QR with
    deflation, the reference's ``qrd``) or 'dqds' (high relative accuracy,
    with the bisection as its safety net).  A rectangular input is first
    reduced to its square triangular factor by QR (sigma-preserving).
    ``A``: a tensor runs on its own device; a numpy array or array-like goes
    to the CUDA card as float32 (:func:`as_input`).
    """
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
    if diag == "qr":
        return bidiag_qr.bidiagonal_svdvals(B.d, B.e)[:n]
    if diag == "dqds":
        return dqds.dqds_svdvals(B.d, B.e)[:n]
    if method != "tpu1" and use_kernels(A):
        return bisect.bisect_svdvals(B.d.contiguous(), B.e.contiguous())[:n]
    return bisect_svdvals(B.d, B.e)[:n]


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
