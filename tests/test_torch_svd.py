"""The ported slice 2, ``svd`` / ``svds``, held to the JAX package and to
LAPACK on CPU (where the port takes its plain path), mirroring the JAX
package's tests/test_vectors.py.  Vectors are not unique (clusters,
signs), so they are held by singular values, reconstruction, residual and
orthogonality, with the JAX package's own limits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import vectors as jv
from svdsolver_tpu_torch import svd, svds, svdvals
from svdsolver_tpu_torch.models import vectors as tv


def _lapack(A):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)


def _port(fn, A, *args, **kw):
    return [t.numpy() for t in fn(torch.from_numpy(A), *args, **kw)]


def _orthogonal_pair(rng, n):
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return Q1, Q2


@pytest.mark.parametrize(
    "shape,band",
    [((64, 64), 16), ((100, 100), None), ((48, 20), None), ((20, 48), None)],
)
def test_svd_matches_jax_and_lapack(rng, shape, band):
    # square with b = 16; n = 100 pads to 128 (b = 32); tall and wide go
    # through the reduced QR.  sigma against JAX and LAPACK, and the JAX
    # package's reconstruction and orthogonality limits
    A = rng.normal(size=shape).astype(np.float32)
    U, s, Vh = _port(svd, A, band=band)
    k = min(shape)
    assert U.shape == (shape[0], k) and s.shape == (k,) and Vh.shape == (k, shape[1])
    want = _lapack(A)
    ref = np.asarray(jv.svd(jnp.asarray(A), band=band)[1])
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(s, ref, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(U @ np.diag(s) @ Vh, A, atol=3e-5 * want[0])
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=5e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=5e-5)


def test_svd_repeated_sigma(rng):
    # exactly multiple values (test_two_stage_svd_repeated_sigma)
    n = 96
    Q1, Q2 = _orthogonal_pair(rng, n)
    sv = np.sort(np.concatenate(
        [np.full(5, 3.0), np.full(4, 1.0), rng.uniform(0.1, 2.5, n - 9)]))[::-1]
    A = ((Q1 * sv) @ Q2.T).astype(np.float32)
    U, s, Vh = _port(svd, A, band=16)
    np.testing.assert_allclose(s, sv, rtol=0, atol=1e-5 * sv[0])
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - A).max() < 1e-4 * sv[0]


def test_svd_wide_cluster_takes_dense(rng, monkeypatch):
    # n/3 values within 1e-6 (test_two_stage_svd_wide_cluster): a cluster
    # wider than 64 columns, so the dense cluster orthogonalization runs
    n = 384
    Q1, Q2 = _orthogonal_pair(rng, n)
    sv = rng.uniform(0.1, 2.5, n)
    sv[: n // 3] = 3.0 + rng.normal(size=n // 3) * 1e-6
    A = ((Q1 * np.sort(sv)[::-1]) @ Q2.T).astype(np.float32)
    calls = []
    dense = tv._cluster_orthogonalize_dense
    monkeypatch.setattr(tv, "_cluster_orthogonalize_dense",
                        lambda *a, **k: calls.append(1) or dense(*a, **k))
    U, s, Vh = _port(svd, A, band=32)
    assert calls
    assert np.abs(U.T @ U - np.eye(n)).max() < 2e-5
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 2e-5
    assert np.abs(U @ np.diag(s) @ Vh - A).max() < 1e-4 * sv.max()


def test_svd_dense_spectrum(rng):
    # Gaussian n = 512 (test_two_stage_svd_large_dense_spectrum): ~1e2..1e3
    # eps relative gaps throughout the bulk
    n = 512
    A = rng.normal(size=(n, n)).astype(np.float32)
    U, s, Vh = _port(svd, A)
    assert np.isfinite(U).all() and np.isfinite(Vh).all()
    want = _lapack(A)
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-5 * want[0])
    assert np.abs(U @ np.diag(s) @ Vh - A).max() < 1e-4 * want[0]
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4


@pytest.mark.parametrize("shape,k", [((96, 96), 8), ((128, 128), 1), ((120, 72), 6),
                                     ((72, 120), 6)])
def test_svds_matches_jax_and_lapack(rng, shape, k):
    A = rng.normal(size=shape).astype(np.float32)
    U, s, Vh = _port(svds, A, k)
    assert U.shape == (shape[0], k) and s.shape == (k,) and Vh.shape == (k, shape[1])
    want = _lapack(A)
    np.testing.assert_allclose(s, want[:k], rtol=2e-5, atol=1e-5 * want[0])
    if shape == (96, 96):
        ref = np.asarray(jv.svds(jnp.asarray(A), k)[1])
        np.testing.assert_allclose(s, ref, rtol=2e-5, atol=1e-5 * want[0])
    assert np.abs(A @ Vh.T - U * s[None, :]).max() / want[0] < 3e-5
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=2e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=2e-5)


def test_svds_clustered_top(rng):
    # a 6-fold multiplet straddling the k = 7 boundary
    n = 64
    Q1, Q2 = _orthogonal_pair(rng, n)
    sig = np.linspace(3.0, 1.0, n)
    sig[4:10] = 2.0
    sig = np.sort(sig)[::-1]
    A = ((Q1 * sig[None, :]) @ Q2.T).astype(np.float32)
    U, s, Vh = _port(svds, A, 7)
    np.testing.assert_allclose(s, sig[:7], rtol=2e-5, atol=1e-5 * sig[0])
    assert np.abs(A @ Vh.T - U * s[None, :]).max() / sig[0] < 5e-5
    np.testing.assert_allclose(U.T @ U, np.eye(7), atol=5e-5)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(7), atol=5e-5)


def test_svd_f64_repeated(rng):
    n = 96
    Q1, Q2 = _orthogonal_pair(rng, n)
    sv = np.sort(np.concatenate([np.full(5, 3.0), rng.uniform(0.1, 2.5, n - 5)]))[::-1]
    A = (Q1 * sv) @ Q2.T
    U, s, Vh = _port(svd, A, band=16)
    assert s.dtype == np.float64
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-9
    assert np.abs(U @ np.diag(s) @ Vh - A).max() < 1e-9 * sv[0]


def test_svd_method_routing(rng):
    # tpu1 and multicore run the same two-stage pipeline as tpu2
    A = torch.from_numpy(rng.normal(size=(32, 32)).astype(np.float32))
    s2 = svd(A, band=8)[1]
    for method in ("tpu1", "multicore"):
        torch.testing.assert_close(svd(A, method=method, band=8)[1], s2, rtol=0, atol=0)
    assert tv.svd_two_stage(A[:5, :5])[0].shape == (5, 5)  # band halves to 4
    with pytest.raises(ValueError, match="square"):
        tv.svd_two_stage(A[:, :5])


def test_svd_singlecore_runs_the_one_stage_path(rng):
    # once refused: the one-stage reduction with factors, then the
    # bidiagonal SVD; sigma against LAPACK, the factors' gates
    A = rng.normal(size=(24, 24)).astype(np.float32)
    U, s, Vh = (x.astype(np.float64) for x in _port(svd, A, method="singlecore"))
    want = _lapack(A)
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    assert np.abs(U * s @ Vh - A).max() <= 1e-4 * want[0]
    assert np.abs(U.T @ U - np.eye(24)).max() <= 1e-4


@pytest.mark.parametrize(
    "call,err",
    [
        # complex input takes the default pipeline only (svd_c, svdvals_c)
        (lambda A: svd(A.to(torch.complex64), method="singlecore"), ValueError),
        (lambda A: svds(A.to(torch.complex64), 2), TypeError),
        (lambda A: svdvals(A.to(torch.complex64), method="tpu1"), ValueError),
    ],
)
def test_unported_options_raise(call, err):
    with pytest.raises(err, match="complex"):
        call(torch.eye(8))


def test_svds_rejects_bad_k():
    with pytest.raises(ValueError, match="out of range"):
        svds(torch.eye(8), 9)


@pytest.mark.parametrize("entry", ["svd", "svds", "svdvals"])
def test_numpy_input_needs_a_card(entry, monkeypatch):
    # a numpy array goes to the CUDA card; with none it raises, never
    # running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.eye(8, dtype=np.float32)
    call = {"svd": lambda: svd(A), "svds": lambda: svds(A, 2),
            "svdvals": lambda: svdvals(A)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    with pytest.raises(RuntimeError, match="CUDA"):
        svdvals(A.astype(np.complex64))
