"""Complex SVD on native torch complex dtypes (twin of
``svdsolver_tpu/models/complex_svd.py``): a unitary bidiagonalization to a
REAL bidiagonal, then the real pipeline.

The JAX package carries complex arrays as ``(re, im)`` pairs of real
arrays because its TPU backend has no complex dtype; here every complex
value is a ``torch.complex64`` / ``complex128`` tensor and every complex
contraction one complex GEMM through ``ops.precision.pdot`` (TF32 off).
The pair form is still accepted at the API boundary: a pair in gives pairs
out.

Complex Householder reflectors use LAPACK zlarfg scaling, which gives a
REAL beta at every pivot, so the bidiagonal {d, e} of a complex matrix is
real by construction (of dtype ``A.real.dtype``) and the real
diagonalization applies unchanged: on a complex64 CUDA tensor the
bisection kernel and the TGK solve kernel (``models.vectors.
bidiagonal_svd``), on complex128 the float64 path real float64 takes.
Only the reduction and the back-transform GEMMs are complex.  The
reductions are host loops of PyTorch ops (the reference's are XLA
``fori_loop`` bodies, with no Pallas kernel).

Reflector conventions (as in the JAX package):

* column elimination: ``(v, tau, beta) = householder_vector_c(x, p)``
  gives unitary ``H = I - tau v v^H`` with ``H^H x = beta e_p`` (beta
  real); apply ``A <- H^H A = A - conj(tau) v (v^H A)`` and accumulate
  ``U <- U H = U - tau (U v) v^H``.  A zero tail still needs a reflector
  when the pivot has a nonzero imaginary part (it rotates the pivot onto
  the real axis).
* row elimination at row r: zlarfg on ``y = conj(A[r, :])``; then ``A <-
  A (I - tau u u^H)`` zeroes ``A[r, p+1:]`` with ``A[r, p]`` real, and the
  right factor accumulates as ``Vh <- (I - conj(tau) u u^H) Vh`` (the
  module keeps ``Vh = V^H`` itself, so ``A = U A_cur Vh`` holds
  throughout).

``.conj()`` and ``.mH`` are lazy views (a conjugate bit, no copy): the
results this module returns are resolved copies.
"""

import numpy as np
import torch

from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.svd import placed, use_kernels
from svdsolver_tpu_torch.ops.cuda import bisect
from svdsolver_tpu_torch.ops.precision import pdot

__all__ = ["bidiagonalize_gk_c", "bidiagonalize_blocked_c", "svdvals_c", "svd_c",
           "householder_vector_c"]

GK_MAX = 1536  # from this n on the blocked reduction (the reference's crossover)


def householder_vector_c(x, p):
    """Complex Householder reflector of ``x[p:]`` (zlarfg semantics).

    ``x``: a 1-D complex tensor, or a ``(re, im)`` pair of real ones (then
    ``v`` and ``tau`` come back as pairs too).  Returns ``(v, tau, beta)``:
    ``v`` full length, zero below the pivot and ``v[p] == 1``; ``tau`` a
    0-d complex tensor; ``beta`` a 0-d REAL tensor with ``(I - tau v
    v^H)^H x' = beta e_p`` (``x'``: ``x`` with the entries below ``p``
    ignored).  :func:`_reflector` on the slice ``x[p:]``; ``p >= len(x)``
    gives ``v == 0``, ``tau == 0`` and ``beta == 0``.
    """
    if isinstance(x, tuple):
        v, tau, beta = householder_vector_c(torch.complex(*x), p)
        return (v.real, v.imag), (tau.real, tau.imag), beta
    p = int(p)
    v = x.new_zeros(x.shape)
    if p >= x.shape[0]:
        return v, x.new_zeros(()), x.real.new_zeros(())
    v[p:], tau, beta = _reflector(x[p:])
    return v, tau, beta


def _reflector(x):
    """zlarfg of the 1-D complex ``x`` (pivot ``x[0]``): ``(v, tau,
    beta)`` with ``v[0] == 1``, as :func:`householder_vector_c` gives them
    at ``p = 0``.  The sign is ``+1`` where ``Re x[0] >= 0`` (``torch.sgn``
    would give 0 at 0); ``trivial`` (a zero tail and a real pivot) gives
    ``tau = 0`` and ``beta = Re x[0]``.  No host sync; ``x`` may be a
    conjugate view."""
    pivot = x[0]
    pr, pi = pivot.real, pivot.imag
    sigma2 = torch.vdot(x[1:], x[1:]).real
    norm = torch.sqrt(torch.vdot(x, x).real)
    beta = torch.where(pr >= 0, -norm, norm)
    trivial = torch.logical_and(sigma2 == 0, pi == 0)
    v = x / torch.where(trivial, 1, pivot - beta)
    v[0] = 1
    tau = torch.where(trivial, 0, (beta - pivot) / torch.where(beta == 0, 1, beta))
    return v, tau, torch.where(trivial, pr, beta)


def _gk_c(A, uv=False):
    """Complex Golub-Kahan, one host loop over the columns: ``(d, e)``
    real, and with ``uv`` also ``(U (m, m), Vh (n, n))`` unitary with ``A
    = U bidiag(d, e) Vh``.  ``m >= n``; ``A`` is not modified.  Each
    reflector acts on the trailing block it reaches (the JAX package's
    masks to full length, sliced): column j on ``A[j:, j:]``, row j on
    ``A[j:, j+1:]``."""
    m, n = A.shape
    if m < n:
        raise ValueError("internal: callers must pass m >= n")
    A = A.clone()
    d = A.real.new_zeros((n,))
    e = A.real.new_zeros((max(n - 1, 1),))
    if uv:
        U = torch.eye(m, dtype=A.dtype, device=A.device)
        Vh = torch.eye(n, dtype=A.dtype, device=A.device)
    for j in range(n):
        # column reflector: A <- H^H A zeroes A[j+1:, j], A[j, j] real
        v, tau, d[j] = _reflector(A[j:, j])
        S = A[j:, j:]
        S -= torch.outer(tau.conj() * v, pdot(v.conj(), S))
        if uv:
            Uj = U[:, j:]
            Uj -= torch.outer(pdot(Uj, v), tau * v.conj())
        if j == n - 1:
            break
        # row reflector on conj(A[j, j+1:]): zeroes A[j, j+2:], e_j real
        u, tau_r, e[j] = _reflector(A[j, j + 1:].conj())
        S = A[j:, j + 1:]
        S -= torch.outer(pdot(S, u), tau_r * u.conj())
        if uv:
            Vj = Vh[j + 1:]
            Vj -= torch.outer(tau_r.conj() * u, pdot(u.conj(), Vj))
    if uv:
        return d, e[: n - 1], U, Vh
    return d, e[: n - 1]


def bidiagonalize_gk_c(A):
    """Real bidiagonal ``(d, e)`` of a complex matrix (m >= n) by
    Golub-Kahan; ``A`` a complex tensor or a ``(re, im)`` pair."""
    return _gk_c(as_complex_input(A))


def _clarft(V, taus):
    """Forward compact-WY ``T`` ((b, b) upper triangular) of the product
    ``H_1 ... H_b = I - V T V^H`` (LAPACK zlarft): column j is ``-tau_j T
    (V^H v_j)`` above the diagonal and ``tau_j`` on it."""
    b = V.shape[1]
    T = V.new_zeros((b, b))
    for j in range(b):
        w = pdot(V[:, :j].mH, V[:, j])
        T[:j, j] = -taus[j] * pdot(T[:j, :j], w)
        T[j, j] = taus[j]
    return T


def _blocked_c(A, panel=32, uv=False):
    """Blocked complex bidiagonalization (zlabrd class): ``(d, e)`` real,
    and with ``uv`` ``(U (m, m), Vh (n, n))``.

    Lazy labrd panels over ``A_hat = A - V Y^H - X U^H``, the panel's
    column loop on the host, then the deferred trailing update as two
    complex GEMMs.  Row eliminations run zlarfg on the conjugated current
    row, so every e is real.  A column reflector lives on rows ``g:`` of
    ``V`` and a row reflector on rows ``g+1:`` of ``U`` (the JAX package's
    masks, sliced); columns past ``n`` (the last panel) and the row
    reflector of the last column are identities, left zero.
    """
    m, n = A.shape
    if m < n:
        raise ValueError("bidiagonalize_blocked_c requires m >= n")
    b = int(panel)
    d = A.real.new_zeros((n,))
    e = A.real.new_zeros((n,))  # slot n - 1 is scratch
    if uv:
        Uacc = torch.eye(m, dtype=A.dtype, device=A.device)
        Vh = torch.eye(n, dtype=A.dtype, device=A.device)
    for k in range(-(-n // b)):
        V, X = A.new_zeros((2, m, b))
        Y, U = A.new_zeros((2, n, b))
        tl, tr = A.new_zeros((2, b))
        for j in range(min(b, n - k * b)):
            g = k * b + j
            # rows g: of column g of A_hat: (V Y^H)[:, g] = V conj(Y[g, :])
            col = A[g:, g] - pdot(V[g:], Y[g].conj()) - pdot(X[g:], U[g].conj())
            v, tau, d[g] = _reflector(col)
            V[g:, j] = v
            # y = tau A_hat^H v: the left update is A_hat -= v y^H
            Y[:, j] = tau * (pdot(A[g:].mH, v) - pdot(Y, pdot(V[g:].mH, v))
                             - pdot(U, pdot(X[g:].mH, v)))
            tl[j] = tau
            if g == n - 1:
                break
            # conj(A_hat[g, g+1:]) with the column reflector applied
            row = (A[g, g + 1:].conj() - pdot(Y[g + 1:], V[g].conj())
                   - pdot(U[g + 1:], X[g].conj()))
            u, tau_r, e[g] = _reflector(row)
            U[g + 1:, j] = u
            # x = tau_r A_hat u: the right update is A_hat -= x u^H
            X[:, j] = tau_r * (pdot(A[:, g + 1:], u) - pdot(V, pdot(Y[g + 1:].mH, u))
                               - pdot(X, pdot(U[g + 1:].mH, u)))
            tr[j] = tau_r
        A = A - pdot(V, Y.mH) - pdot(X, U.mH)
        if uv:
            # U <- U (H_1 ... H_b) = U (I - V TL V^H)
            Uacc = Uacc - pdot(pdot(pdot(Uacc, V), _clarft(V, tl)), V.mH)
            # Vh <- (G_1 ... G_b)^H Vh = Vh - U TR^H (U^H Vh)
            Vh = Vh - pdot(pdot(U, _clarft(U, tr).mH), pdot(U.mH, Vh))
    if uv:
        return d, e[: n - 1], Uacc, Vh
    return d, e[: n - 1]


def bidiagonalize_blocked_c(A, panel=32):
    """Real bidiagonal ``(d, e)`` of a complex matrix (m >= n) by the
    blocked reduction; ``A`` a complex tensor or a ``(re, im)`` pair."""
    return _blocked_c(as_complex_input(A), panel=panel)


def _split(A):
    """A complex tensor as its ``(re, im)`` pair (resolved copies)."""
    return A.real.contiguous(), A.imag.contiguous()


def as_complex_input(A):
    """The complex matrix a complex entry works on: a ``(re, im)`` pair
    joined on its device; a tensor kept on its device, a real one made
    complex of its precision; a numpy or array-like input to the CUDA card
    as complex64 (``models.svd.placed``; with no card this raises)."""
    if isinstance(A, tuple):
        A = torch.complex(*A)
    A = placed(A)
    if A.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    if not A.is_complex():
        A = A.to(torch.complex128 if A.dtype == torch.float64 else torch.complex64)
    return A


def _reduce(A, uv):
    """The reduction by size: Golub-Kahan below ``GK_MAX`` columns, the
    blocked one from it on."""
    if A.shape[1] >= GK_MAX:
        return _blocked_c(A, uv=uv)
    return _gk_c(A, uv=uv)


def svdvals_c(A):
    """Singular values of a complex matrix, descending: a real tensor on
    ``A``'s device.

    ``A``: a complex tensor (kept on its device), a ``(re, im)`` pair of
    real tensors, or a numpy complex array (to the CUDA card as
    complex64).  The reduction to a real bidiagonal, then the bisection:
    its kernel on a complex64 CUDA tensor.
    """
    A = as_complex_input(A)
    m, n = A.shape
    if m < n:  # sigma(A^H) = sigma(A)
        A = A.mH
        m, n = n, m
    d, e = _reduce(A, uv=False)
    if use_kernels(d):
        return bisect.bisect_svdvals(d.contiguous(), e.contiguous())[:n]
    return bisect_svdvals(d, e)[:n]


def svd_c(A):
    """Thin SVD of a complex matrix: ``A ~= U @ diag(s) @ Vh``.

    ``A`` as :func:`svdvals_c` takes it.  U (m, k), s (k,) real and
    descending, Vh (k, n), k = min(m, n); tensors on ``A``'s device (the
    JAX package returns numpy here), U and Vh as ``(re, im)`` pairs when
    ``A`` was a pair.  The reduction with its factors, the real bidiagonal
    SVD (``models.vectors.bidiagonal_svd``: on a complex64 CUDA tensor the
    bisection and TGK solve kernels), then the complex back-transform GEMMs.
    """
    pairs_in = isinstance(A, tuple)
    U, s, Vh = _svd_c(as_complex_input(A))
    if pairs_in:
        return _split(U), s, _split(Vh)
    return U, s, Vh


def _svd_c(A):
    m, n = A.shape
    if m < n:  # A^H = U2 s Vh2  =>  A = Vh2^H s U2^H
        U2, s, Vh2 = _svd_c(A.mH)
        return Vh2.mH.resolve_conj(), s, U2.mH.resolve_conj()
    return _svd_c_core(A)


def _svd_c_core(A):
    from svdsolver_tpu_torch.models.vectors import bidiagonal_svd

    n = A.shape[1]
    d, e, U1, Vh1 = _reduce(A, uv=True)
    U_b, s, V_b = bidiagonal_svd(d, e)  # real factors of the bidiagonal
    U = pdot(U1[:, :n], U_b.to(A.dtype))
    Vh = pdot(V_b.T.to(A.dtype), Vh1)
    return U, s, Vh


def is_complex_input(A):
    """Whether an entry point's input is complex: a complex tensor, a
    numpy complex array or a ``(re, im)`` pair of tensors."""
    if isinstance(A, torch.Tensor):
        return A.is_complex()
    if isinstance(A, tuple):
        return len(A) == 2 and all(isinstance(x, torch.Tensor) for x in A)
    return np.iscomplexobj(A)
