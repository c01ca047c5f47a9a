"""The SVD applications of the port (``svdsolver_tpu_torch/linalg.py``;
plain paths on CPU tensors) held to the JAX package's ``linalg`` on the
same inputs, at the shapes of ``tests/test_linalg.py``, compared on what
the maths fixes (singular vectors and bases are unique only up to signs
and rotations within clusters)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu import linalg as jla
from svdsolver_tpu_torch import (
    cond,
    eigh,
    lowrank,
    lstsq,
    matrix_rank,
    norm2,
    null_space,
    orth,
    pinv,
    polar,
    rsvd,
)
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(fn_port, fn_jax, A, *args, **kwargs):
    got = fn_port(from_numpy(A), *args, **kwargs)
    want = fn_jax(jnp.asarray(A), *args, **kwargs)
    return got, want


def test_pinv_matches_jax(rng):
    # square, and rank-deficient 80 x 48 of rank 12 at rtol 1e-5: the
    # pseudo-inverse is unique, so the two packages agree entrywise
    for A, rtol, tol in ((_f32(rng, (64, 64)), None, 5e-4),
                         (_f32(rng, (80, 12)) @ _f32(rng, (12, 48)), 1e-5, 2e-3)):
        P, Pj = _both(pinv, jla.pinv, A, rtol=rtol)
        P, Pj = to_numpy(P), np.asarray(Pj)
        assert P.shape == A.T.shape
        np.testing.assert_allclose(A @ P @ A, A, atol=tol * np.abs(A).max())
        np.testing.assert_allclose(P @ A @ P, P, atol=tol * np.abs(P).max())
        np.testing.assert_allclose(P, Pj, atol=tol * np.abs(Pj).max())


def test_lstsq_matches_jax(rng):
    # overdetermined with one right-hand side (exact solution), then three
    m, n = 96, 40
    A = _f32(rng, (m, n))
    x_true = _f32(rng, (n,))
    (x, resid, rank), (xj, rj, kj) = _both(lstsq, jla.lstsq, A, A @ x_true)
    np.testing.assert_allclose(to_numpy(x), x_true, atol=5e-4)
    np.testing.assert_allclose(to_numpy(x), np.asarray(xj), atol=5e-4)
    assert float(resid) < 1e-3 and float(rj) < 1e-3
    assert int(rank) == int(kj) == n
    A, B = _f32(rng, (64, 32)), _f32(rng, (64, 3))
    x, resid, rank = lstsq(from_numpy(A), from_numpy(B))
    xj, rj, _ = jla.lstsq(jnp.asarray(A), jnp.asarray(B))
    assert x.shape == (32, 3) and resid.shape == (3,)
    want, *_ = np.linalg.lstsq(A, B, rcond=None)
    np.testing.assert_allclose(to_numpy(x), want, atol=2e-3)
    np.testing.assert_allclose(to_numpy(x), np.asarray(xj), atol=2e-3)
    np.testing.assert_allclose(to_numpy(resid), np.asarray(rj), rtol=1e-4)
    # a numpy right-hand side follows A's device and dtype
    x2, _, _ = lstsq(from_numpy(A), B)
    np.testing.assert_allclose(to_numpy(x2), to_numpy(x), atol=1e-6)


def test_rank_cond_norm2_match_jax(rng):
    n, r = 64, 20
    L = _f32(rng, (n, r))
    A = L @ L.T
    assert int(matrix_rank(from_numpy(A), rtol=1e-4)) == int(jla.matrix_rank(
        jnp.asarray(A), rtol=1e-4)) == r
    B = _f32(rng, (n, n))
    want = np.linalg.svd(B.astype(np.float64), compute_uv=False)
    got_n, jn = _both(norm2, jla.norm2, B)
    got_c, jc = _both(cond, jla.cond, B)
    assert abs(float(got_n) - want[0]) / want[0] < 1e-5
    assert abs(float(got_n) - float(jn)) / want[0] < 1e-5
    assert abs(float(got_c) - want[0] / want[-1]) / (want[0] / want[-1]) < 1e-3
    assert abs(float(got_c) - float(jc)) / float(jc) < 1e-3
    # rectangular spectral norm and rank, both orientations
    C = _f32(rng, (48, 96))
    wc = np.linalg.svd(C.astype(np.float64), compute_uv=False)
    for M in (C, C.T):
        got_n, jn = _both(norm2, jla.norm2, M)
        assert abs(float(got_n) - wc[0]) / wc[0] < 1e-5
        assert abs(float(got_n) - float(jn)) / wc[0] < 1e-5
        assert int(matrix_rank(from_numpy(M))) == int(jla.matrix_rank(jnp.asarray(M))) == 48
    with pytest.raises(ValueError, match="square"):
        cond(from_numpy(C))


def test_lowrank_eckart_young_matches_jax(rng):
    n, k = 96, 10
    A = _f32(rng, (n, n))
    (L, R), (Lj, Rj) = _both(lowrank, jla.lowrank, A, k)
    assert L.shape == (n, k) and R.shape == (k, n)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    best = np.sqrt(np.sum(want[k:] ** 2))
    err = np.linalg.norm(to_numpy(L) @ to_numpy(R) - A)
    assert err <= best * (1 + 1e-3) + 1e-4 * want[0]
    # the best rank-k approximation is unique (sigma_k > sigma_k+1)
    prod_j = np.asarray(Lj) @ np.asarray(Rj)
    np.testing.assert_allclose(to_numpy(L) @ to_numpy(R), prod_j, atol=1e-3 * want[0])


def test_polar_right_left_match_jax(rng):
    A = _f32(rng, (48, 32))
    (W, P), (Wj, Pj) = _both(polar, jla.polar, A)
    Wn, Pn = to_numpy(W), to_numpy(P)
    assert np.abs(Wn.T @ Wn - np.eye(32)).max() < 1e-4
    assert np.abs(Pn - Pn.T).max() < 1e-4
    assert np.min(np.linalg.eigvalsh(Pn.astype(np.float64))) > -1e-3
    assert np.abs(Wn @ Pn - A).max() / np.abs(A).max() < 1e-4
    # the polar factors of a full-rank matrix are unique
    np.testing.assert_allclose(Wn, np.asarray(Wj), atol=1e-4)
    np.testing.assert_allclose(Pn, np.asarray(Pj), atol=1e-4 * np.abs(Pn).max())
    Wl, Pl = polar(from_numpy(A), side="left")
    assert np.abs(to_numpy(Pl) @ to_numpy(Wl) - A).max() / np.abs(A).max() < 1e-4
    with pytest.raises(ValueError, match="side"):
        polar(from_numpy(A), side="up")


def test_eigh_symmetric_indefinite_matches_jax(rng):
    n = 64
    M = rng.normal(size=(n, n))
    A = (M + M.T).astype(np.float32)
    (w, V), (wj, _) = _both(eigh, jla.eigh, A)
    wn, Vn = to_numpy(w), to_numpy(V)
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    assert np.all(np.diff(wn) >= -1e-3)  # ascending
    assert np.max(np.abs(wn - ref)) / np.abs(ref).max() < 1e-4
    assert np.max(np.abs(wn - np.asarray(wj))) / np.abs(ref).max() < 1e-4
    assert np.abs(A @ Vn - Vn * wn[None, :]).max() / np.abs(ref).max() < 1e-3
    assert np.abs(Vn.T @ Vn - np.eye(n)).max() < 1e-3


def test_eigh_complex_raises_item_12():
    # complex (Hermitian) input is taken since item 12; a non-square one
    # raises, and so does any other linalg entry given complex input
    A = np.ones((4, 3), dtype=np.complex64)
    for x in (A, torch.from_numpy(A)):
        with pytest.raises((ValueError, RuntimeError)):
            eigh(x)
    with pytest.raises(ValueError, match="square"):
        eigh(torch.from_numpy(A))
    with pytest.raises(TypeError, match="complex"):
        pinv(torch.eye(4, dtype=torch.complex64))


def test_pinv_jacobi_matches_jax(rng):
    # method="jacobi" passes through to svd's Jacobi dispatch (item 11,
    # once refused): the pseudo-inverse is unique, so the packages agree
    A = _f32(rng, (24, 24))
    got, want = _both(pinv, jla.pinv, A, method="jacobi")
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                               atol=5e-4 * np.abs(np.asarray(want)).max())


def test_polar_singlecore_matches_jax(rng):
    # method= passes through to svd's one-stage path, once refused: W and P
    # are unique for a full-rank A, so they agree with the JAX package's
    A = _f32(rng, (16, 16))
    (W, P), (Wj, Pj) = _both(polar, jla.polar, A, method="singlecore")
    W, P = to_numpy(W).astype(np.float64), to_numpy(P).astype(np.float64)
    np.testing.assert_allclose(W, np.asarray(Wj), atol=1e-4)
    np.testing.assert_allclose(P, np.asarray(Pj), atol=1e-4 * np.abs(P).max())
    assert np.abs(W @ P - A).max() <= 1e-4 * np.abs(A).max()
    assert np.abs(W.T @ W - np.eye(16)).max() <= 1e-4


def test_orth_null_space_match_jax(rng):
    # rank-deficient tall: 40 x 24 of rank 16; the subspaces are unique, so
    # the projectors of the two packages agree
    B = (rng.normal(size=(40, 16)) @ rng.normal(size=(16, 24))).astype(np.float32)
    Q, Qj = (np.asarray(x) for x in (to_numpy(orth(from_numpy(B))), jla.orth(jnp.asarray(B))))
    assert Q.shape == Qj.shape == (40, 16)
    assert np.abs(Q.T @ Q - np.eye(16)).max() < 1e-4
    assert np.abs(Q @ (Q.T @ B) - B).max() < 1e-3
    np.testing.assert_allclose(Q @ Q.T, Qj @ Qj.T, atol=1e-4)
    N = to_numpy(null_space(from_numpy(B)))
    Nj = np.asarray(jla.null_space(jnp.asarray(B)))
    assert N.shape == Nj.shape == (24, 8)
    assert np.abs(B @ N).max() < 1e-3
    assert np.abs(N.T @ N - np.eye(8)).max() < 1e-4
    np.testing.assert_allclose(N @ N.T, Nj @ Nj.T, atol=1e-3)
    # wide input: the null space needs the padded full basis
    Aw = _f32(rng, (16, 40))
    Nw = to_numpy(null_space(from_numpy(Aw)))
    Nwj = np.asarray(jla.null_space(jnp.asarray(Aw)))
    assert Nw.shape == Nwj.shape == (40, 24)
    assert np.abs(Aw @ Nw).max() < 1e-3
    assert np.abs(Nw.T @ Nw - np.eye(24)).max() < 1e-4
    np.testing.assert_allclose(Nw @ Nw.T, Nwj @ Nwj.T, atol=1e-3)


def _decaying(rng, m=96, n=64):
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s0 = np.power(10.0, -np.arange(n, dtype=np.float64) / 4)
    return (U0 * s0[None, :] @ V0.T).astype(np.float32), s0


def test_rsvd_matches_jax(rng):
    # fast-decaying spectrum: both sketches (different random numbers)
    # capture the top-k triplets; compare sigma and the rank-k product
    A, s0 = _decaying(rng)
    m, n, k = 96, 64, 8
    U, s, Vh = (to_numpy(x) for x in rsvd(from_numpy(A), k))
    Uj, sj, Vhj = (np.asarray(x) for x in jla.rsvd(jnp.asarray(A), k))
    assert U.shape == (m, k) and s.shape == (k,) and Vh.shape == (k, n)
    assert np.max(np.abs(s - s0[:k]) / s0[:k]) < 1e-3
    assert np.max(np.abs(s - sj) / sj) < 1e-3
    assert np.abs(U.T @ U - np.eye(k)).max() < 1e-3
    assert np.linalg.norm(U * s[None, :] @ Vh - A, 2) < 3 * s0[k]
    np.testing.assert_allclose(U * s[None, :] @ Vh, Uj * sj[None, :] @ Vhj, atol=3 * s0[k])
    s2 = to_numpy(rsvd(from_numpy(A), 4)[1])  # tiny k: the small-sketch tail
    assert np.max(np.abs(s2 - s0[:4]) / s0[:4]) < 1e-3
    with pytest.raises(ValueError, match="out of range"):
        rsvd(from_numpy(A), 65)


def test_rsvd_reproducible_from_one_generator(rng):
    A, _ = _decaying(rng)
    At = from_numpy(A)
    first = rsvd(At, 8, generator=torch.Generator().manual_seed(7))
    again = rsvd(At, 8, generator=torch.Generator().manual_seed(7))
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # the default generator is seeded with 0 on A's device
    for a, b in zip(rsvd(At, 8), rsvd(At, 8, generator=torch.Generator().manual_seed(0))):
        assert torch.equal(a, b)
