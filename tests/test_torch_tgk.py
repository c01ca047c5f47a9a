"""Inverse iteration on the Golub-Kahan tridiagonal: the TGK solve's plain
version, the cluster orthogonalization and ``tgk_vectors`` of the port,
held to the JAX package on CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import vectors as jv
from svdsolver_tpu_torch import bidiagonal_svd
from svdsolver_tpu_torch.models import vectors as tv
from svdsolver_tpu_torch.ops.cuda import tridiag_solve

EPS32 = np.finfo(np.float32).eps


def _tgk_problem(rng, n):
    """The recipe of the JAX package's test_pallas_tgk_solve_matches_xla."""
    N = 2 * n
    d = rng.normal(size=(n,)).astype(np.float32) * 5
    e = rng.normal(size=(n - 1,)).astype(np.float32) * 5
    z = np.zeros((N - 1,), np.float32)
    z[0::2] = d
    z[1::2] = e
    B = np.diag(d) + np.diag(e, 1)
    sig = np.linalg.svd(B, compute_uv=False).astype(np.float32)
    smax = float(np.abs(sig).max())
    pivmin = np.float32(max(smax * EPS32 * EPS32, np.finfo(np.float32).tiny))
    big = np.float32(float(np.finfo(np.float32).max) ** 0.5 / 16.0)
    rhs = rng.normal(size=(N, n)).astype(np.float32)
    return z, sig, rhs, pivmin, big


def _xla_solve(z, sig, rhs, pivmin, big):
    return np.asarray(jv.tgk_solve_xla(
        jnp.asarray(z), jnp.asarray(sig), jnp.asarray(rhs),
        jnp.float32(pivmin), jnp.float32(big)))


def _port_solve(fn, z, sig, rhs, pivmin, big):
    return fn(torch.from_numpy(z), torch.from_numpy(sig), torch.from_numpy(rhs),
              torch.tensor(pivmin), torch.tensor(big)).numpy()


@pytest.mark.parametrize("n", [64, 160])
@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_tgk_solve_matches_xla(rng, n, entry):
    # The normalized solutions (near-singular amplifications) of the port
    # and of tgk_solve_xla agree to 64 eps per column, times sigma_max/gap
    # for lanes whose shift has a close neighbour: XLA:CPU lets LLVM fuse
    # each q - m*p into an FMA inside the jitted scan, where the port (like
    # the card's kernel and the TPU) rounds the product, and inverse
    # iteration amplifies that rounding difference by sigma_max/gap.  A
    # near-singular column's sign follows the rounding of its tiny last
    # pivot, so signs are aligned first.  Unfused, the two are bit-equal
    # (next test).
    z, sig, rhs, pivmin, big = _tgk_problem(rng, n)
    fn = tridiag_solve.tgk_solve_plain if entry == "plain" else tridiag_solve.tgk_solve
    got = _port_solve(fn, z, sig, rhs, pivmin, big)
    want = _xla_solve(z, sig, rhs, pivmin, big)
    got = got / np.linalg.norm(got, axis=0)
    want = want / np.linalg.norm(want, axis=0)
    got = got * np.sign(np.sum(got * want, axis=0))
    gap = np.minimum(np.abs(np.diff(sig, prepend=np.inf)),
                     np.abs(np.diff(sig, append=-np.inf)))
    tol = 64 * EPS32 * np.maximum(1.0, sig[0] / gap)
    assert np.all(np.abs(got - want).max(axis=0) < tol)
    well = gap > 1e-2 * sig[0]  # well-separated lanes: 64 eps outright
    assert np.abs(got - want)[:, well].max() < 64 * EPS32


def test_tgk_solve_bitwise_unfused_xla(rng):
    # with jit disabled each jnp op of tgk_solve_xla runs as its own
    # computation, so nothing fuses into an FMA: the same pivoting
    # decisions and roundings as the port's plain solve, bit for bit
    # (n = 8: eager dispatch is slow)
    args = _tgk_problem(rng, 8)
    got = _port_solve(tridiag_solve.tgk_solve_plain, *args)
    with jax.disable_jit():
        want = _xla_solve(*args)
    np.testing.assert_array_equal(got, want)


def test_tgk_solve_clip_keeps_nan():
    # jnp.clip propagates NaN; so must the plain solve's clip
    z = torch.tensor([1.0, float("nan"), 1.0])
    x = tridiag_solve.tgk_solve_plain(z, torch.tensor([0.5]), torch.ones(4, 1),
                                      1e-30, 1e10)
    assert torch.isnan(x).any()


def test_tgk_solve_rejects_bad_shapes():
    with pytest.raises(ValueError, match="need z"):
        tridiag_solve.tgk_solve(torch.zeros(4), torch.zeros(3), torch.zeros(6, 3),
                                1e-30, 1.0)
    with pytest.raises(ValueError):
        tridiag_solve.tgk_solve(torch.zeros(5), torch.zeros(3), torch.zeros(6),
                                1e-30, 1.0)


def _cluster_sig(rng, n, kind):
    """The spectra of the JAX package's tiled-vs-dense test."""
    if kind == "narrow":
        parts = [np.full(5, 3.0), np.full(4, 1.0), rng.uniform(0.1, 2.5, n - 9)]
    else:  # one cluster wider than the 64-column tiled cover
        parts = [3.0 + rng.normal(size=80) * 1e-14, rng.uniform(0.1, 2.5, n - 80)]
    return np.sort(np.concatenate(parts))[::-1].copy()


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_cluster_orthogonalize_matches_jax(rng, kind):
    # tiled and dense against each other and each against the JAX package
    # (f64, 1e-10); wide clusters route the tiled form to the dense one
    n = 160
    sig = _cluster_sig(rng, n, kind)
    x = rng.normal(size=(2 * n, n))
    ctol = 64 * np.finfo(np.float64).eps
    xt, st = torch.from_numpy(x), torch.from_numpy(sig)
    dense = tv._cluster_orthogonalize_dense(xt, st, ctol).numpy()
    tiled = tv._cluster_orthogonalize(xt, st, ctol).numpy()
    np.testing.assert_allclose(tiled, dense, atol=1e-10)
    xj, sj, cj = jnp.asarray(x), jnp.asarray(sig), jnp.asarray(ctol)
    np.testing.assert_allclose(
        dense, np.asarray(jv._cluster_orthogonalize_dense(xj, sj, cj)), atol=1e-10)
    np.testing.assert_allclose(
        tiled, np.asarray(jv._cluster_orthogonalize(xj, sj, cj)), atol=1e-10)
    G = tiled.T @ tiled
    linked = np.abs(sig[1:] - sig[:-1]) <= ctol * np.abs(sig).max()
    assert linked.any()
    for i in np.where(linked)[0][:20]:
        assert abs(G[i, i + 1]) < 1e-10
    assert bool(tv._has_wide_cluster(st, ctol)) == (kind == "wide")


def test_cluster_bounds_match_jax(rng):
    sig = _cluster_sig(rng, 96, "narrow")
    ctol = 64 * np.finfo(np.float64).eps
    got = tv._cluster_bounds(torch.from_numpy(sig), ctol)
    want = jv._cluster_bounds(jnp.asarray(sig), jnp.asarray(ctol))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cholesky_failure_keeps_input():
    # a non-PD block (torch raises where JAX returns NaN): cholesky_ex's
    # info marks every column of that block bad, and they keep their input
    y = torch.tensor([[1.0, 1.0], [0.0, 0.0]], dtype=torch.float64)[None]
    mask = torch.ones(1, 2, 2, dtype=torch.bool)
    out = tv._cholesky_qr(y, mask, shift=-2.0)
    assert torch.equal(out, y)


@pytest.mark.parametrize("n", [48, 64])
def test_tgk_vectors_matches_jax(rng, n):
    # fp32, the JAX start block handed in as x0: U_b and V_b agree with the
    # JAX package's within 1e-4, and B V_b = U_b diag(sig) to 1e-5 sig_max
    d = rng.normal(size=n).astype(np.float32)
    e = rng.normal(size=n - 1).astype(np.float32)
    B = np.diag(d) + np.diag(e, 1)
    sig = np.sort(np.linalg.svd(B.astype(np.float64), compute_uv=False))[::-1]
    sig = sig.astype(np.float32)
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (2 * n, n), jnp.float32))
    Uj, Vj = (np.asarray(t) for t in jv.tgk_vectors(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(sig)))
    Ub, Vb = tv.tgk_vectors(torch.from_numpy(d), torch.from_numpy(e),
                            torch.from_numpy(sig), x0=torch.from_numpy(x0))
    Ub, Vb = Ub.numpy(), Vb.numpy()
    np.testing.assert_allclose(Ub, Uj, atol=1e-4)
    np.testing.assert_allclose(Vb, Vj, atol=1e-4)
    res = np.linalg.norm(B @ Vb - Ub * sig[None, :], axis=0)
    assert res.max() / sig[0] < 1e-5


def test_bidiagonal_svd_residuals_and_topk(rng):
    # the JAX package's test_bidiagonal_svd_residuals, plus top-k lanes and
    # the deterministic default start block
    n = 64
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32))
    U_b, s, V_b = bidiagonal_svd(d, e)
    B = (torch.diag(d) + torch.diag(e, 1)).numpy()
    res = np.linalg.norm(B @ V_b.numpy() - U_b.numpy() * s.numpy()[None, :], axis=0)
    assert res.max() / float(s[0]) < 1e-5
    U5, s5, V5 = bidiagonal_svd(d, e, k=5)
    assert U5.shape == (n, 5) and V5.shape == (n, 5)
    torch.testing.assert_close(s5, s[:5], rtol=0, atol=0)
    U_again, _, _ = bidiagonal_svd(d, e)
    assert torch.equal(U_again, U_b)
    with pytest.raises(ValueError, match="x0"):
        tv.tgk_vectors(d, e, s, x0=torch.zeros(3, 3))
