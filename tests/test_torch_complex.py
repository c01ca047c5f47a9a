"""Complex SVD in the port (``svdsolver_tpu_torch/models/complex_svd.py``,
native torch complex dtypes), held to the JAX package's split (re, im)
``models/complex_svd.py`` on the CPU.

The counterparts of ``tests/test_complex.py`` (its 8 tests, the same
shapes: n <= 80, so the JAX package's compiles are those its own tests
make) with the same gates, each also against the JAX function on the same
seeded input: zlarfg's ``(v, tau, beta)`` elementwise (a zero tail with an
imaginary pivot, a real pivot alone, a pivot past the end), sigma within
1e-5 sigma_max in complex64 and 1e-12 in complex128.  Then the dispatch
(``svdvals``, ``svd``, ``linalg.eigh``; the ``ValueError`` of the other
methods; ``TypeError`` from the real-only entries), the pair form, the
crossover to the blocked reduction, and the placement of a numpy complex
array (the CUDA card or a ``RuntimeError``).
"""

import numpy as np
import pytest
import torch

from svdsolver_tpu import linalg as jla
from svdsolver_tpu.models import complex_svd as jcs
from svdsolver_tpu_torch import eigh, svd, svd_c, svds, svdvals, svdvals_c
from svdsolver_tpu_torch.models import complex_svd
from svdsolver_tpu_torch.utils.convert import from_numpy, pair_from_numpy, to_numpy

TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}  # sigma / sigma_max
TOL_FAC = {torch.complex64: 1e-4, torch.complex128: 1e-10}  # recon., unitarity


def _cplx(rng, m, n, dtype=np.complex64):
    return (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))).astype(dtype)


def _lapack(A):
    return np.linalg.svd(np.asarray(A).astype(np.complex128), compute_uv=False)


def _np(x):
    return to_numpy(x) if isinstance(x, (torch.Tensor, tuple)) else np.asarray(x)


def _sig_err(s, ref):
    return np.max(np.abs(_np(s) - _np(ref))) / ref[0]


def _bidiag_sigma(d, e):
    B = np.diag(_np(d).astype(np.float64)) + np.diag(_np(e).astype(np.float64), 1)
    return np.linalg.svd(B, compute_uv=False)


def _factor_gates(A, U, s, Vh, tol):
    A, U, s, Vh = (_np(x) for x in (A, U, s, Vh))
    k = min(A.shape)
    assert U.shape == (A.shape[0], k) and Vh.shape == (k, A.shape[1])
    assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < tol
    assert np.abs(U.conj().T @ U - np.eye(k)).max() < tol
    assert np.abs(Vh @ Vh.conj().T - np.eye(k)).max() < tol


def test_householder_c_zlarfg(rng):
    # H^H x = beta e_p with beta REAL, H unitary; (v, tau, beta) equal to
    # the JAX package's; the rotation-only cases: a zero tail with an
    # imaginary pivot (a reflector), a real pivot alone (identity), a pivot
    # past the end (v = 0)
    x = _cplx(rng, 1, 12)[0]
    rot = np.zeros(12, np.complex64)
    rot[4] = 0.6 - 0.8j
    real = np.zeros(12, np.complex64)
    real[4] = -2.0
    for vec, p in ((x, 0), (x, 5), (x, 11), (rot, 4), (real, 4), (x, 12)):
        v, tau, beta = complex_svd.householder_vector_c(from_numpy(vec), p)
        jv, jt, jb = jcs.householder_vector_c(jcs._split(vec), p)
        vn, taun, bn = to_numpy(v), complex(to_numpy(tau)), float(beta)
        np.testing.assert_allclose(vn, np.asarray(jv[0]) + 1j * np.asarray(jv[1]),
                                   rtol=0, atol=1e-6)
        assert abs(taun - complex(float(jt[0]), float(jt[1]))) < 1e-6
        assert abs(bn - float(jb)) < 1e-6 * max(1.0, abs(bn))
        assert not torch.is_complex(beta)
        xm = np.where(np.arange(12) >= p, vec, 0)
        Hh = np.eye(12) - np.conj(taun) * np.outer(vn, np.conj(vn))
        tgt = np.zeros(12, np.complex128)
        if p < 12:
            tgt[p] = bn
        assert np.abs(Hh @ xm - tgt).max() < 1e-5
        H = np.eye(12) - taun * np.outer(vn, np.conj(vn))
        assert np.abs(np.conj(H.T) @ H - np.eye(12)).max() < 1e-5
    # the pivot-only rotation is a reflector; the real pivot alone is not
    assert complex(to_numpy(complex_svd.householder_vector_c(from_numpy(rot), 4)[1])) != 0
    assert complex(to_numpy(complex_svd.householder_vector_c(from_numpy(real), 4)[1])) == 0


def test_householder_c_pair_form(rng):
    x = _cplx(rng, 1, 9)[0]
    v, tau, beta = complex_svd.householder_vector_c(pair_from_numpy(x), 2)
    v2, tau2, beta2 = complex_svd.householder_vector_c(from_numpy(x), 2)
    assert isinstance(v, tuple) and isinstance(tau, tuple)
    assert np.array_equal(to_numpy(v), to_numpy(v2))
    assert complex(to_numpy(tau)) == complex(to_numpy(tau2)) and torch.equal(beta, beta2)


def test_bidiagonalize_c_real_output(rng):
    n = 32
    A = _cplx(rng, n, n)
    d, e = complex_svd.bidiagonalize_gk_c(from_numpy(A))
    # d, e are REAL (zgebrd class), of A.real's dtype, and sigma-preserving
    assert d.dtype == torch.float32 and e.dtype == torch.float32
    assert d.shape == (n,) and e.shape == (n - 1,)
    ref = _lapack(A)
    assert _sig_err(_bidiag_sigma(d, e), ref) < 1e-5
    jd, je = jcs.bidiagonalize_gk_c(*jcs._split(A))
    want = _bidiag_sigma(jd, je)
    assert np.max(np.abs(_bidiag_sigma(d, e) - want)) / ref[0] < 1e-5


def test_svdvals_c(rng):
    n = 48
    A = _cplx(rng, n, n)
    ref = _lapack(A)
    s = svdvals_c(from_numpy(A))
    assert s.dtype == torch.float32 and s.shape == (n,)
    assert _sig_err(s, ref) < 1e-5
    assert _sig_err(s, np.asarray(jcs.svdvals_c(A))) < 1e-5
    # transparent routing through the public svdvals
    assert _sig_err(svdvals(from_numpy(A)), ref) < 1e-5


def test_svd_c_square_and_rect(rng):
    n = 48
    A = _cplx(rng, n, n)
    U, s, Vh = svd(from_numpy(A))  # routes to svd_c
    _factor_gates(A, U, s, Vh, 1e-4)
    assert _sig_err(s, np.asarray(jcs.svd_c(A)[1])) < 1e-5
    # wide rectangular: the conjugate-transpose branch
    B = _cplx(rng, 24, 40)
    Ub, sb, Vhb = svd_c(from_numpy(B))
    assert Ub.shape == (24, 24) and Vhb.shape == (24, 40)
    assert not Ub.is_conj() and not Vhb.is_conj()
    assert _sig_err(sb, _lapack(B)) < 1e-4
    _factor_gates(B, Ub, sb, Vhb, 1e-4)
    assert _sig_err(sb, np.asarray(jcs.svd_c(B)[1])) < 1e-5


def test_svd_c_hermitian_and_real_input(rng):
    # Hermitian input: sigma = |eigenvalues|
    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = ((M + np.conj(M.T)) / 2).astype(np.complex64)
    s = svdvals_c(from_numpy(A))
    ref = np.sort(np.abs(np.linalg.eigvalsh(A.astype(np.complex128))))[::-1]
    assert _sig_err(s, ref) < 1e-5
    assert _sig_err(s, np.asarray(jcs.svdvals_c(A))) < 1e-5
    # a complex array with zero imaginary part matches the real pipeline;
    # a real tensor is taken as complex of its precision
    R = rng.normal(size=(n, n)).astype(np.float32)
    ref2 = np.linalg.svd(R.astype(np.float64), compute_uv=False)
    assert _sig_err(svdvals_c(from_numpy(R.astype(np.complex64))), ref2) < 1e-5
    assert _sig_err(svdvals_c(from_numpy(R)), ref2) < 1e-5
    assert _sig_err(svdvals(from_numpy(R)), ref2) < 1e-5


@pytest.mark.parametrize("m,n", [(63, 63), (80, 48)])
def test_bidiagonalize_blocked_c(rng, m, n):
    # blocked (zlabrd class) reduction: GK's sigma; odd n exercises the
    # ragged last panel
    A = _cplx(rng, m, n)
    d, e = complex_svd.bidiagonalize_blocked_c(from_numpy(A), panel=16)
    ref = _lapack(A)
    got = _bidiag_sigma(d, e)
    assert _sig_err(got, ref) < 1e-5
    jd, je = jcs.bidiagonalize_blocked_c(*jcs._split(A), panel=16)
    want = _bidiag_sigma(jd, je)
    assert np.max(np.abs(got - want)) / ref[0] < 1e-5


def test_eigh_hermitian_complex(rng):
    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = ((M + np.conj(M.T)) / 2).astype(np.complex64)
    w, V = eigh(from_numpy(A))
    assert not torch.is_complex(w) and torch.is_complex(V)
    w, V = to_numpy(w), to_numpy(V)
    ref = np.linalg.eigvalsh(A.astype(np.complex128))
    assert np.all(np.diff(w) >= -1e-3)
    assert np.max(np.abs(np.sort(w) - ref)) / np.abs(ref).max() < 1e-4
    assert np.abs(A @ V - V * w[None, :]).max() / np.abs(ref).max() < 1e-3
    assert np.abs(np.conj(V.T) @ V - np.eye(n)).max() < 1e-3
    wj, _ = jla.eigh(A)
    assert np.max(np.abs(w - np.asarray(wj))) / np.abs(ref).max() < 1e-4


def test_bidiagonalize_blocked_c_uv(rng):
    # the factor-accumulating blocked variant: A = U B Vh, unitary factors
    n = 48
    A = _cplx(rng, n, n)
    d, e, U, Vh = complex_svd._blocked_c(from_numpy(A), panel=16, uv=True)
    Un, Vhn = to_numpy(U), to_numpy(Vh)
    B = np.diag(to_numpy(d)) + np.diag(to_numpy(e), 1)
    assert np.abs(Un @ B @ Vhn - A).max() / np.abs(A).max() < 1e-5
    assert np.abs(np.conj(Un.T) @ Un - np.eye(n)).max() < 1e-5
    assert np.abs(Vhn @ np.conj(Vhn.T) - np.eye(n)).max() < 1e-5
    jd, je, _, _ = jcs._bidiagonalize_blocked_c(*jcs._split(A), panel=16, uv=True)
    want = _bidiag_sigma(jd, je)
    assert np.max(np.abs(_bidiag_sigma(d, e) - want)) / want[0] < 1e-5


@pytest.mark.parametrize("shape", [(32, 32), (20, 32)])
def test_complex128_matches_jax(rng, shape):
    # float64 arithmetic throughout (the path real float64 takes)
    A = _cplx(rng, *shape, dtype=np.complex128)
    At = from_numpy(A, dtype=torch.complex128)
    s = svdvals_c(At)
    assert s.dtype == torch.float64
    ref = _lapack(A)
    assert _sig_err(s, ref) < TOL[torch.complex128]
    assert _sig_err(s, np.asarray(jcs.svdvals_c(A))) < TOL[torch.complex128]
    U, s2, Vh = svd_c(At)
    _factor_gates(A, U, s2, Vh, TOL_FAC[torch.complex128])
    assert _sig_err(s2, np.asarray(jcs.svd_c(A)[1])) < TOL[torch.complex128]


def test_pair_form_in_gives_pairs_out(rng):
    A = _cplx(rng, 24, 16)
    pair = pair_from_numpy(A)
    U, s, Vh = svd_c(pair)
    assert isinstance(U, tuple) and isinstance(Vh, tuple)
    assert all(not torch.is_complex(x) for x in (*U, s, *Vh))
    U2, s2, Vh2 = svd_c(from_numpy(A))
    assert torch.equal(s, s2)
    assert np.array_equal(to_numpy(U), to_numpy(U2))
    assert np.array_equal(to_numpy(Vh), to_numpy(Vh2))
    assert torch.equal(svdvals_c(pair), svdvals_c(from_numpy(A)))
    _factor_gates(A, U, s, Vh, 1e-4)


def test_blocked_from_the_crossover(rng, monkeypatch):
    # from GK_MAX columns on the blocked reduction runs (1536 in the package)
    A = from_numpy(_cplx(rng, 40, 40))
    seen = []
    real = complex_svd._blocked_c
    monkeypatch.setattr(complex_svd, "_blocked_c",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    monkeypatch.setattr(complex_svd, "GK_MAX", 40)
    assert _sig_err(svdvals_c(A), _lapack(to_numpy(A))) < 1e-5
    U, s, Vh = svd_c(A)
    _factor_gates(A, U, s, Vh, 1e-4)
    assert len(seen) == 2


@pytest.mark.parametrize("call,err", [
    (lambda A: svdvals(A, method="base"), ValueError),
    (lambda A: svdvals(A, diag="qr"), ValueError),
    (lambda A: svd(A, method="jacobi"), ValueError),
    (lambda A: svds(A, 2), TypeError),
])
def test_complex_dispatch_errors(call, err):
    with pytest.raises(err, match="complex"):
        call(torch.eye(8, dtype=torch.complex64))


@pytest.mark.parametrize("entry", [svdvals, svd, svdvals_c, svd_c, eigh])
def test_numpy_complex_needs_a_card(entry, monkeypatch):
    # a numpy complex array goes to the CUDA card as complex64; with none
    # it raises, never running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(np.eye(8, dtype=np.complex128))
