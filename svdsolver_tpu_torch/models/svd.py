"""Top-level singular-value entry points (twin of a subset of
``svdsolver_tpu/models/svd.py``).

Ported methods: ``tpu2`` (Stage I through the panel kernel, the chase
routed by ``band_chase_wave.wave_chase_preferred`` to the wavefront or the
sequential chase, whose staged TMA design takes every band of this path,
the bisection kernel) and ``tpu1`` (the plain
PyTorch path).  The kernels run for float32 CUDA tensors (:func:`use_kernels`); any other
device or dtype takes the plain path, chosen by the input and never as a
fallback on failure.  All three diagonalizers are ported: ``bisect``,
``qr`` and ``dqds`` (the last two run their ``bidiag_qr`` / ``dqds``
kernel on any CUDA tensor).
"""

from typing import NamedTuple

import numpy as np
import torch

from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.two_stage import band_to_bidiagonal, dense_to_band
from svdsolver_tpu_torch.ops.cuda import (
    band_chase,
    band_chase_wave,
    bidiag_qr,
    bisect,
    dqds,
    panel_qr,
)

METHODS = ("base", "singlecore", "multicore", "tpu1", "tpu2")
_NOT_PORTED = {
    "base": "ROADMAP queue 1, item 9 (ladder rungs)",
    "singlecore": "ROADMAP queue 1, item 9 (ladder rungs)",
    "multicore": "ROADMAP queue 1, item 9 (ladder rungs)",
}


def as_input(A):
    """The matrix an entry point works on.  A tensor keeps its device and
    dtype.  A numpy array or array-like goes to the CUDA card as float32
    (the JAX package's default placement and dtype); with no card this
    raises, it never runs on the CPU.  Complex input is not ported."""
    if isinstance(A, torch.Tensor):
        if A.is_complex():
            _complex()
    else:
        if np.iscomplexobj(A):
            _complex()
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a numpy or array-like input runs on the CUDA card, and none "
                "is available; pass a torch.Tensor to run on its device"
            )
        A = torch.as_tensor(np.asarray(A, dtype=np.float32), device="cuda")
    if A.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    return A


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


def _not_ported(name):
    raise NotImplementedError(f"{name!r} is not ported yet: {_NOT_PORTED[name]}")


def bidiagonalize(A, method="tpu2", block=None):
    """Reduce square ``A`` to bidiagonal form; returns :class:`Bidiagonal`.

    ``tpu2``: Stage I through the panel kernel and the chase for float32
    CUDA input, else as ``tpu1``; the chase is the wavefront kernel where
    :func:`band_chase_wave.wave_chase_preferred` holds (its docstring has
    the card's times: from n = 641 on), else the sequential chase
    (``band_chase.band_to_bidiagonal``), with the same ``(d, e)`` bit for
    bit.  ``tpu1``: plain two-stage
    reduction.  ``block=None`` picks the band width by size.
    """
    if method in _NOT_PORTED:
        _not_ported(method)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    if block is None:
        block = _auto_block(A.shape[0])
    Ap, n = _pad_to_multiple(A, block)
    if method == "tpu2" and use_kernels(A):
        Ab = panel_qr.dense_to_band_fused(Ap, band=block)
        if band_chase_wave.wave_chase_preferred(Ab.shape[0], block):
            d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=block)
        else:
            d, e = band_chase.band_to_bidiagonal(Ab, band=block)
    else:
        Ab = dense_to_band(Ap, band=block)
        d, e = band_to_bidiagonal(Ab, band=block)
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
    if method == "tpu2" and use_kernels(A):
        return bisect.bisect_svdvals(B.d.contiguous(), B.e.contiguous())[:n]
    return bisect_svdvals(B.d, B.e)[:n]
