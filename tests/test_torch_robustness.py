"""Robustness: degenerate and adversarial inputs through the port on the
CPU, the counterpart of ``tests/test_robustness.py``.

Each case of that file runs through the port on CPU tensors with the same
gates against LAPACK, and where the case holds the JAX package to numpy the
port is also held to the JAX function on the same seeded input, with the
same tolerance.  Cases that differ only in their matrix are parametrised
cases of one test.  ``test_jacobi_edge_cases`` has its counterpart in
``tests/test_torch_jacobi.py``.  ``test_entry_point_compiles`` has none: it
is a ``jax.jit`` of ``__graft_entry__``, which is the JAX package's entry
and no function of the port.  The same inputs on float32 CUDA tensors,
through the kernels, are ``tests/test_torch_cuda.py``'s robustness tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu import svd_batch as jax_svd_batch
from svdsolver_tpu.models import complex_svd as jcs
from svdsolver_tpu.models.svd import svdvals as jax_svdvals
from svdsolver_tpu_torch import (
    lowrank,
    lstsq,
    matrix_rank,
    pinv,
    svd,
    svd_batch,
    svd_c,
    svds,
    svdvals,
    svdvals_c,
)
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = torch.float64


def _orth_pair(rng, n):
    q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return q1, q2


def _case(name, rng):
    """The matrices of ``tests/test_robustness.py``'s LAPACK-checked cases,
    drawn from the seeded rng in the same order."""
    if name == "identity":
        return np.eye(24)
    if name == "rank_one":
        return rng.normal(size=(24, 1)) @ rng.normal(size=(1, 24))
    if name == "rank_deficient":
        return rng.normal(size=(32, 5)) @ rng.normal(size=(5, 32))
    if name == "duplicate_sigma":
        q1, q2 = _orth_pair(rng, 24)
        return q1 @ np.diag(np.repeat([5.0, 3.0, 1.0, 1e-6], 6)) @ q2
    if name == "already_bidiagonal":
        return np.diag(rng.normal(size=16)) + np.diag(rng.normal(size=15), 1)
    if name == "diagonal":
        return np.diag(rng.normal(size=24))
    raise ValueError(name)


def _check(got, want, rtol=1e-7):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9 * max(want[0], 1))


def test_zero_matrix():
    got = svdvals(torch.zeros((24, 24), dtype=F64), block=8)
    np.testing.assert_array_equal(to_numpy(got), np.zeros(24))


@pytest.mark.parametrize("name", ["identity", "rank_one", "rank_deficient",
                                  "duplicate_sigma", "already_bidiagonal", "diagonal"])
def test_degenerate_inputs(rng, name):
    A = _case(name, rng)
    got = to_numpy(svdvals(from_numpy(A, dtype=F64), block=8))
    _check(got, np.linalg.svd(A, compute_uv=False))
    _check(got, np.asarray(jax_svdvals(jnp.asarray(A), block=8)))


def test_wide_dynamic_range(rng):
    q1, q2 = _orth_pair(rng, 24)
    s = np.logspace(8, -8, 24)
    A = q1 @ np.diag(s) @ q2
    got = to_numpy(svdvals(from_numpy(A, dtype=F64), block=8))
    # absolute accuracy relative to sigma_max (fp arithmetic limit)
    np.testing.assert_allclose(got, s, atol=1e-12 * s[0], rtol=1e-8)
    np.testing.assert_allclose(got, np.asarray(jax_svdvals(jnp.asarray(A), block=8)),
                               atol=1e-12 * s[0], rtol=1e-8)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_sizes(rng, n):
    A = rng.normal(size=(n, n))
    got = to_numpy(svdvals(from_numpy(A, dtype=F64), method="base"))
    np.testing.assert_allclose(got, np.linalg.svd(A, compute_uv=False), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jax_svdvals(jnp.asarray(A), method="base")),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["base", "singlecore", "multicore", "tpu1", "tpu2"])
def test_fuzz_models_agree(method):
    """Every method gives the same singular values (multi-seed fuzz); the
    first seed also against the JAX package's same method."""
    for seed in range(4):
        A = np.random.default_rng(seed).normal(size=(32, 32))
        want = np.linalg.svd(A, compute_uv=False)
        got = to_numpy(svdvals(from_numpy(A, dtype=F64), method=method, block=8))
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9 * want[0],
                                   err_msg=f"seed={seed} method={method}")
        if seed == 0:
            jax_got = np.asarray(jax_svdvals(jnp.asarray(A), method=method, block=8))
            np.testing.assert_allclose(got, jax_got, rtol=1e-7, atol=1e-9 * want[0])


def test_svds_and_linalg_edge_cases(rng):
    n = 32
    # identity: all triplets trivial
    U, s, Vh = svds(torch.eye(n), 4)
    np.testing.assert_allclose(to_numpy(s), np.ones(4), atol=1e-5)
    # rank one: top triplet exact, k beyond the rank gives ~zero sigma
    u = rng.normal(size=(n, 1)).astype(np.float32)
    v = rng.normal(size=(1, n)).astype(np.float32)
    A = from_numpy(u @ v)
    U, s, Vh = svds(A, 3)
    want0 = np.linalg.norm(u) * np.linalg.norm(v)
    assert abs(float(s[0]) - want0) / want0 < 1e-4
    assert float(s[1]) < 1e-4 * want0 and float(s[2]) < 1e-4 * want0
    assert int(matrix_rank(A, rtol=1e-4)) == 1
    # pinv of rank one: A pinv(A) A = A
    P = to_numpy(pinv(A, rtol=1e-4))
    An = to_numpy(A)
    np.testing.assert_allclose(An @ P @ An, An, atol=2e-3 * np.abs(An).max())
    # lstsq with an inconsistent rhs: minimum-norm least squares
    x, resid, rank = lstsq(A, from_numpy(rng.normal(size=n)), rtol=1e-4)
    assert int(rank) == 1 and np.isfinite(float(resid))
    # lowrank of an exactly rank-k matrix rebuilds it
    r = 5
    B = from_numpy(rng.normal(size=(n, r)) @ rng.normal(size=(r, n)))
    L, R = lowrank(B, r)
    np.testing.assert_allclose(to_numpy(L) @ to_numpy(R), to_numpy(B),
                               atol=5e-4 * float(B.abs().max()))


def test_svd_batch_mixed_spectra(rng):
    """Batch entries with very different spectra (well conditioned,
    clustered, near singular) do not contaminate each other; the JAX
    package's batch gives the same sigma."""
    n = 32
    Q1, Q2 = _orth_pair(rng, n)
    specs = [
        np.linspace(2.0, 1.0, n),
        np.full(n, 1.5),
        np.concatenate([np.linspace(3, 1, n - 4), np.full(4, 1e-5)]),
    ]
    As = np.stack([(Q1 * sp[None, :]) @ Q2.T for sp in specs]).astype(np.float32)
    U, s, Vh = (to_numpy(x) for x in svd_batch(from_numpy(As)))
    _, js, _ = jax_svd_batch(jnp.asarray(As))
    for i, sp in enumerate(specs):
        want = np.sort(sp)[::-1]
        np.testing.assert_allclose(s[i], want, rtol=2e-4, atol=2e-5 * want[0])
        np.testing.assert_allclose(s[i], np.asarray(js[i]), rtol=2e-4, atol=2e-5 * want[0])
        np.testing.assert_allclose(U[i] @ np.diag(s[i]) @ Vh[i], As[i], atol=5e-5 * want[0])


@pytest.mark.parametrize("name", ["identity", "three_q"])
def test_svd_duplicate_sigma(rng, name):
    """``svd`` on exact multiplets (the identity, 3 Q): one cluster of n
    values through the cluster coupling; reconstruction and orthogonality
    within 1e-4 (the card tests run these through the kernels)."""
    n = 48
    A = (np.eye(n) if name == "identity"
         else 3 * np.linalg.qr(rng.normal(size=(n, n)))[0]).astype(np.float32)
    U, s, Vh = (to_numpy(x).astype(np.float64) for x in svd(from_numpy(A)))
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert np.abs(s - want).max() <= 1e-5 * want[0]
    assert np.abs(U * s @ Vh - A).max() <= 1e-4 * want[0]
    assert np.abs(U.T @ U - np.eye(n)).max() <= 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() <= 1e-4


def test_complex_edge_cases(rng):
    n = 24
    # zero matrix
    s = svdvals_c(torch.zeros((n, n), dtype=torch.complex64))
    assert torch.all(s == 0)
    # pure-imaginary matrix: sigma of the real matrix it scales
    R = rng.normal(size=(n, n))
    Ai = (1j * R).astype(np.complex64)
    s1 = to_numpy(svdvals_c(from_numpy(Ai)))
    ref = np.linalg.svd(R, compute_uv=False)
    assert np.max(np.abs(s1 - ref)) / ref[0] < 1e-5
    assert np.max(np.abs(s1 - np.asarray(jcs.svdvals_c(Ai)))) / ref[0] < 1e-5
    # rank-deficient complex
    u = rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    v = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    A = (u @ v).astype(np.complex64)
    U, s2, Vh = (to_numpy(x) for x in svd_c(from_numpy(A)))
    refr = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
    assert np.max(np.abs(s2 - refr)) / refr[0] < 1e-4
    assert np.abs(U @ np.diag(s2) @ Vh - A).max() / np.abs(A).max() < 1e-4
    # unitary diagonal phases: every sigma exactly 1
    ph = np.exp(1j * rng.uniform(0, 2 * np.pi, n)).astype(np.complex64)
    s3 = to_numpy(svdvals_c(from_numpy(np.diag(ph))))
    assert np.max(np.abs(s3 - 1)) < 1e-5


def test_qr_diagonalizer_zero_pivot_shared_with_reference(rng):
    """A zero diagonal entry with a zero superdiagonal entry elsewhere
    costs the QR diagonalizer its accuracy (sigma off by ~0.3 sigma_max
    here) in the JAX package and in the port alike: the port's values are
    the JAX package's; the bisection and dqds are right on the same
    (d, e).  Shared with the reference (ROADMAP section 3), not a fault of
    the port."""
    from svdsolver_tpu.models.diagonalize import bidiagonal_svdvals as jax_qr
    from svdsolver_tpu_torch import bidiagonal_svdvals, bisect_svdvals, dqds_svdvals

    d = rng.normal(size=24).astype(np.float32)
    e = rng.normal(size=23).astype(np.float32)
    d[5], e[10] = 0, 0
    want = np.linalg.svd(np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1),
                         compute_uv=False)
    got = to_numpy(bidiagonal_svdvals(from_numpy(d), from_numpy(e)))
    np.testing.assert_allclose(got, np.asarray(jax_qr(jnp.asarray(d), jnp.asarray(e))),
                               rtol=0, atol=1e-6 * want[0])
    for fn in (bisect_svdvals, dqds_svdvals):
        s = to_numpy(fn(from_numpy(d), from_numpy(e)))
        assert np.abs(s - want).max() <= 1e-5 * want[0]
