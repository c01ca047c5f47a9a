"""SVD applications: pseudo-inverse, least squares, rank, condition number,
spectral norm, low-rank approximations, polar and symmetric eigen
decompositions, range and null-space bases (twin of
``svdsolver_tpu/linalg.py``).

Everything routes through the port's two-stage pipeline (``svd``,
``svds``, ``svdvals``), so a float32 CUDA input runs the hand-written
kernels, and every contraction goes through ``ops.precision.pdot`` (TF32
off).  Inputs are taken as ``models.svd.as_input`` takes them: a tensor
keeps its device and dtype; a numpy array or array-like goes to the CUDA
card as float32 (and raises when there is none).  ``method`` passes
through to ``svd`` (``jacobi`` included).  Complex input is taken by
``eigh`` (Hermitian, through ``complex_svd.svd_c``); the other functions
raise ``TypeError`` on it.
"""

import numpy as np
import torch

from svdsolver_tpu_torch.models.complex_svd import as_complex_input, is_complex_input, svd_c
from svdsolver_tpu_torch.models.svd import as_input, svdvals
from svdsolver_tpu_torch.models.vectors import svd, svds
from svdsolver_tpu_torch.ops.precision import pdot


def _default_rtol(A):
    """LAPACK-gelsd-style default relative cutoff: max(m, n) * eps."""
    return max(A.shape) * torch.finfo(A.dtype).eps


def _operand(b, A):
    """A right-hand side: a tensor as it is; anything else as a tensor of
    A's dtype on A's device."""
    if isinstance(b, torch.Tensor):
        return b
    return torch.as_tensor(np.asarray(b), dtype=A.dtype, device=A.device)


def _inverse_where(s, keep):
    return torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def pinv(A, rtol=None, method="tpu2"):
    """Moore-Penrose pseudo-inverse via the two-stage SVD.

    Singular values below ``rtol * sigma_max`` (default ``max(m,n)*eps``)
    are treated as zero, exactly as ``numpy.linalg.pinv``.
    """
    A = as_input(A)
    if rtol is None:
        rtol = _default_rtol(A)
    U, s, Vh = svd(A, method=method)
    sinv = _inverse_where(s, s > rtol * s[0])
    return pdot(Vh.T * sinv[None, :], U.T)


def lstsq(A, b, rtol=None, method="tpu2"):
    """Minimum-norm least-squares solution of ``A x ~= b`` via the SVD.

    ``b`` may be a vector (m,) or a block of right-hand sides (m, nrhs).
    Returns ``(x, resid_norm, rank)``: the solution, the Euclidean residual
    norm per right-hand side, and the numerical rank used (a 0-d tensor).
    """
    A = as_input(A)
    b = _operand(b, A)
    if rtol is None:
        rtol = _default_rtol(A)
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    U, s, Vh = svd(A, method=method)
    keep = s > rtol * s[0]
    x = pdot(Vh.T, _inverse_where(s, keep)[:, None] * pdot(U.T, B))
    r = pdot(A, x) - B
    resid = torch.sqrt(torch.sum(r * r, dim=0))
    rank = torch.sum(keep)
    if vec:
        return x[:, 0], resid[0], rank
    return x, resid, rank


def _square_factor(A):
    """A square matrix with A's singular values: A, or the R of A's (or
    A^T's) QR where A is not square."""
    m, n = A.shape
    if m < n:
        A = A.T
    if m != n:
        A = torch.linalg.qr(A, mode="r")[1]
    return A


def matrix_rank(A, rtol=None):
    """Numerical rank: number of singular values above ``rtol * sigma_max``."""
    A = as_input(A)
    if rtol is None:
        rtol = _default_rtol(A)
    s = svdvals(_square_factor(A))
    return torch.sum(s > rtol * s[0])


def cond(A):
    """Spectral condition number sigma_max / sigma_min."""
    A = as_input(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("cond expects a square matrix")
    s = svdvals(A)
    return s[0] / s[-1]


def norm2(A):
    """Spectral norm (largest singular value)."""
    A = as_input(A)
    return svdvals(_square_factor(A))[0]


def lowrank(A, k, band=None):
    """Best rank-``k`` approximation factors (Eckart-Young).

    Returns ``(L, R)`` with ``A ~= L @ R``, L (m, k), R (k, n): the
    truncated SVD with the singular values folded into ``L``.
    """
    U, s, Vh = svds(A, k, band=band)
    return U * s[None, :], Vh


def rsvd(A, k, oversample=8, power_iters=2, generator=None):
    """Randomized truncated SVD (Halko-Martinsson-Tropp): rank-``k`` factors
    of ``A`` at O(m n (k+p)) cost, all GEMMs plus one small exact SVD.

    Returns ``(U, s, Vh)`` with U (m, k), s (k,) descending, Vh (k, n).
    ``power_iters`` subspace-iteration passes (with QR re-orthonormalization)
    sharpen the range capture for slowly decaying spectra; use :func:`svds`
    when exact top-k triplets are required.  The sketch Omega is drawn
    standard normal in A's dtype on A's device from ``generator`` (default:
    a generator on A's device seeded with 0, so a call repeats itself); the
    JAX package draws it from a ``jax.random`` key, whose numbers differ.
    """
    A = as_input(A)
    m, n = A.shape
    k = int(k)
    if not 1 <= k <= min(m, n):
        raise ValueError(f"k={k} out of range for shape {tuple(A.shape)}")
    p = int(min(oversample + k, min(m, n)))
    if generator is None:
        generator = torch.Generator(device=A.device).manual_seed(0)
    Om = torch.randn((n, p), generator=generator, dtype=A.dtype, device=A.device)
    Q, _ = torch.linalg.qr(pdot(A, Om))
    for _ in range(int(power_iters)):
        Z, _ = torch.linalg.qr(pdot(A.T, Q))
        Q, _ = torch.linalg.qr(pdot(A, Z))
    B = pdot(Q.T, A)  # (p, n) sketch
    Ub, s, Vh = svd(B.T)  # tall (n, p): exact small SVD via the pipeline
    U = pdot(Q, Vh.T)
    return U[:, :k], s[:k], Ub.T[:k, :]


def polar(A, side="right", method="tpu2"):
    """Polar decomposition via the SVD (scipy.linalg.polar convention).

    ``side="right"``: ``A = W @ P`` with W orthonormal (m, n) and P (n, n)
    symmetric positive semi-definite; ``side="left"``: ``A = P @ W`` with
    P (m, m).  W is the nearest orthogonal matrix to A in Frobenius norm.
    """
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    U, s, Vh = svd(A, method=method)
    W = pdot(U, Vh)
    if side == "right":
        P = pdot(Vh.T * s[None, :], Vh)
    else:
        P = pdot(U * s[None, :], U.T)
    return W, P


def eigh(A, method="tpu2"):
    """Eigendecomposition of a symmetric (or Hermitian) matrix via the SVD.

    Returns ``(w, V)`` with eigenvalues ``w`` ascending and ``A @ V ~=
    V @ diag(w)`` (numpy.linalg.eigh convention).  Shift to positive
    definite (``B = A + c I`` with ``c = 1.25 ||A||_inf > ||A||_2``, so B's
    SVD is its eigendecomposition, no sign recovery needed), run the
    two-stage SVD, shift back.  A complex (Hermitian) input takes the same
    shift through ``complex_svd.svd_c`` (``method`` is ignored there, as in
    the JAX package) and returns a real ``w`` and a complex ``V``.
    """
    if is_complex_input(A):
        A = as_complex_input(A)
        n = A.shape[0]
        if A.shape[1] != n:
            raise ValueError(f"eigh expects a square Hermitian matrix, got {tuple(A.shape)}")
        A = 0.5 * (A + A.mH)
        c = (1.25 * torch.max(torch.sum(torch.abs(A), dim=1))
             + torch.finfo(A.real.dtype).tiny)
        U, s, _ = svd_c(A + c * torch.eye(n, dtype=A.dtype, device=A.device))
        return (s - c).flip(0), U.flip(1)
    A = as_input(A)
    m, n = A.shape
    if m != n:
        raise ValueError(f"eigh expects a square symmetric matrix, got {tuple(A.shape)}")
    A = 0.5 * (A + A.T)  # enforce exact symmetry of the compute input
    c = 1.25 * torch.max(torch.sum(torch.abs(A), dim=1)) + torch.finfo(A.dtype).tiny
    U, s, _ = svd(A + c * torch.eye(n, dtype=A.dtype, device=A.device), method=method)
    return (s - c).flip(0), U.flip(1)


def orth(A, rtol=None):
    """Orthonormal basis of the range of ``A``: (m, rank) columns.  The
    numerical rank is read to the host (the result's shape depends on it)."""
    A = as_input(A)
    if rtol is None:
        rtol = _default_rtol(A)
    U, s, _ = svd(A)
    r = int(torch.sum(s > rtol * s[0]))
    return U[:, :r]


def null_space(A, rtol=None):
    """Orthonormal basis of the null space of ``A``: (n, n - rank) columns;
    the rank is read to the host as in :func:`orth`."""
    A = as_input(A)
    if rtol is None:
        rtol = _default_rtol(A)
    m, n = A.shape
    if m < n:
        # thin Vh of a wide matrix only spans the row space; zero rows do
        # not change the null space but make Vh a full (n, n) basis
        A = torch.cat([A, A.new_zeros((n - m, n))], dim=0)
    _, s, Vh = svd(A)
    r = int(torch.sum(s > rtol * s[0]))
    N = Vh[r:].T
    if r == 0 or N.shape[1] == 0:
        return N
    # A degenerate zero-sigma cluster comes back from inverse iteration
    # full-rank but ill-conditioned; the leading r rows of Vh are accurate,
    # so project the row space out twice (twice is enough) and
    # re-orthonormalize what remains.
    Vr = Vh[:r].T
    for _ in range(2):
        N = N - pdot(Vr, pdot(Vr.T, N))
    Q, _ = torch.linalg.qr(N)
    return Q
