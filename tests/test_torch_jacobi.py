"""One-sided block Jacobi in the port (``svdsolver_tpu_torch/models/
jacobi.py``), held to the JAX package's ``models/jacobi.py`` on the CPU.

The counterparts of ``tests/test_jacobi.py`` (its 15 tests) and of
``test_jacobi_edge_cases`` (``tests/test_robustness.py``) with the same
gates (numpy LAPACK the oracle) at n <= 96 in place of 192, and the port
against the JAX package on the same seeded input, function by function: the schedules equal, the
rotation parameters equal on edge values, one rotation solve and one
tournament round within 1e-12 in float64 (the same arithmetic; the
contractions may sum in another order), the sweep counts equal, and the
whole solve's sigma, reconstruction and orthogonality.  The batch entry is
held matrix by matrix to the single solve.  The reference's CPU run takes
``finfo`` eps (its TPU-only raise of float64 eps does not apply), as the
port does on every device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import jacobi as jax_jacobi
from svdsolver_tpu_torch import svd, svd_jacobi, svd_jacobi_batch, svd_jacobi_pre
from svdsolver_tpu_torch.models import jacobi
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = 1e-12  # float64 against the JAX package (one round, one rotation solve)


def _t(x, dtype=torch.float64):
    return from_numpy(np.asarray(x), dtype=dtype)


def _full_check(A, U, s, Vh, tol_rec, tol_orth):
    """Reconstruction, orthogonality on the numerical range, descending s
    (``tests/test_jacobi.py``'s check)."""
    A, U, s, Vh = (to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
                   for x in (A, U, s, Vh))
    k = min(A.shape)
    assert U.shape == (A.shape[0], k) and Vh.shape == (k, A.shape[1])
    assert s.shape == (k,)
    assert np.all(np.diff(s) <= 1e-12 * max(s[0], 1e-300))
    rec = np.linalg.norm(U * s @ Vh - A) / max(np.linalg.norm(A), 1e-300)
    assert rec < tol_rec, f"reconstruction {rec:.2e}"
    alive = s > np.sqrt(k) * jacobi._eps_eff(torch.float64 if A.dtype == np.float64
                                             else torch.float32) * max(s[0], 0)
    ix = np.ix_(alive, alive)
    na = int(alive.sum())
    assert np.abs((U.T @ U)[ix] - np.eye(na)).max() < tol_orth
    assert np.abs((Vh @ Vh.T)[ix] - np.eye(na)).max() < tol_orth


def _rel_err(s, A, alive_only=False):
    sref = np.linalg.svd(np.asarray(A, dtype=np.float64), compute_uv=False)
    s = to_numpy(s)
    if not alive_only:
        return np.abs(s - sref).max() / sref[0]
    alive = sref > np.sqrt(len(sref)) * jacobi._eps_eff(torch.float64) * sref[0]
    return (np.abs(s - sref) / sref)[alive].max()


# ---- the port against the JAX package, function by function ----

@pytest.mark.parametrize("nb", [2, 4, 8, 16, 30])
def test_tournament_matches_jax_and_covers_all_pairs(nb):
    rounds = jacobi._tournament(nb)
    np.testing.assert_array_equal(rounds, jax_jacobi._tournament(nb))
    seen = set()
    for row in rounds:
        pairs = {tuple(sorted((row[2 * i], row[2 * i + 1]))) for i in range(nb // 2)}
        assert len(pairs) == nb // 2  # disjoint within a round
        seen |= pairs
    assert len(seen) == nb * (nb - 1) // 2  # every pair exactly once


@pytest.mark.parametrize("n_pad,b", [(32, 4), (128, 16), (16, 1)])
def test_schedule_cols_match_jax(n_pad, b):
    perms, iperms = jacobi._schedule_cols(n_pad, b, "cpu")
    jp, ji = jax_jacobi._schedule_cols(n_pad, b)
    assert perms.dtype == torch.int64 and perms.device.type == "cpu"
    np.testing.assert_array_equal(to_numpy(perms), np.asarray(jp))
    np.testing.assert_array_equal(to_numpy(iperms), np.asarray(ji))


def _edge_values(dtype):
    big = float(np.finfo(dtype).max) / 4
    tiny = float(np.finfo(dtype).tiny)
    # (app, aqq, apq): apq = 0, a negligible apq (skipped), tau = +inf and
    # -inf (overflowing (aqq - app) / 2 apq), huge and tiny entries, equal
    # diagonals (tau = 0), and ordinary values of both signs
    rows = [(1.0, 2.0, 0.0), (1.0, 1.0, 1e-30), (1.0, big, tiny), (big, 1.0, tiny),
            (big, big / 2, big / 8), (tiny, 2 * tiny, tiny), (3.0, 3.0, 0.5),
            (2.0, 5.0, -1.5), (5.0, 2.0, 1.5), (1e-20, 1e20, 1.0), (0.0, 0.0, 0.0)]
    return [np.asarray(c, dtype=dtype) for c in zip(*rows)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rotation_params_match_jax_on_edge_values(dtype):
    app, aqq, apq = _edge_values(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    eps = float(np.finfo(dtype).eps)
    c, s = jacobi._rotation_params(_t(app, tdt), _t(aqq, tdt), _t(apq, tdt), eps)
    cj, sj = jax_jacobi._rotation_params(jnp.asarray(app), jnp.asarray(aqq), jnp.asarray(apq),
                                         eps)
    assert c.dtype == tdt and s.dtype == tdt
    np.testing.assert_allclose(to_numpy(c), np.asarray(cj), rtol=4 * eps, atol=0)
    np.testing.assert_allclose(to_numpy(s), np.asarray(sj), rtol=4 * eps, atol=0)
    assert np.all(np.isfinite(to_numpy(c))) and np.all(np.isfinite(to_numpy(s)))
    # the skip rule: apq = 0 and a negligible apq give the identity exactly
    assert to_numpy(c)[0] == 1 and to_numpy(s)[0] == 0
    assert to_numpy(c)[1] == 1 and to_numpy(s)[1] == 0
    # tau = +-inf gives t = 0: the identity
    assert np.all(to_numpy(s)[2:4] == 0) and np.all(to_numpy(c)[2:4] == 1)


def test_local_rotations_match_jax(rng):
    P, w = 5, 8
    X = rng.normal(size=(P, 20, w))
    G = np.einsum("pmi,pmj->pij", X, X)
    perms, iperms = jacobi._schedule_cols(w, 1, "cpu")
    J = jacobi._local_rotations(_t(G), perms, iperms)
    jp, ji = jax_jacobi._schedule_cols(w, 1)
    Jj = jax_jacobi._local_rotations(jnp.asarray(G), jp, ji, jax_jacobi.get_lax_precision())
    np.testing.assert_allclose(to_numpy(J), np.asarray(Jj), rtol=0, atol=F64)
    Jn = to_numpy(J)
    assert np.abs(np.einsum("pji,pjk->pik", Jn, Jn) - np.eye(w)).max() < 1e-13
    # every rotation lowers the off-diagonal Frobenius norm: J^T G J is
    # closer to diagonal than G
    Gn = np.einsum("pji,pjk,pkl->pil", Jn, G, Jn)

    def off(M):
        return np.linalg.norm(M - np.einsum("pii->pi", M)[..., None] * np.eye(w), axis=(1, 2))

    assert np.all(off(Gn) < off(G))


def test_jacobi_round_matches_jax(rng):
    n, b = 48, 4
    W = rng.normal(size=(n, n))
    V = np.eye(n)
    eps = jacobi._eps_eff(torch.float64)
    perms, iperms = jacobi._schedule_cols(n, b, "cpu")
    ip, ii = jacobi._schedule_cols(2 * b, 1, "cpu")
    jp, ji = jax_jacobi._schedule_cols(n, b)
    jip, jii = jax_jacobi._schedule_cols(2 * b, 1)
    for r in (0, 5):
        Wt, Vt, rel = jacobi._jacobi_round(_t(W)[None], _t(V)[None], perms[r], iperms[r], ip,
                                           ii, b, eps)
        Wj, Vj, relj = jax_jacobi._jacobi_round(jnp.asarray(W), jnp.asarray(V), jp[r], ji[r],
                                                jip, jii, b, eps)
        scale = np.abs(W).max()
        np.testing.assert_allclose(to_numpy(Wt[0]), np.asarray(Wj), rtol=0, atol=F64 * scale)
        np.testing.assert_allclose(to_numpy(Vt[0]), np.asarray(Vj), rtol=0, atol=F64)
        np.testing.assert_allclose(float(rel[0]), float(relj), rtol=1e-10)


@pytest.mark.parametrize("kind,n,b", [("uniform", 96, 16), ("graded", 96, 8)])
def test_sweep_counts_and_result_match_jax(rng, kind, n, b):
    if kind == "uniform":
        A = rng.uniform(0.0, 5.0, size=(n, n))
    else:
        A = rng.standard_normal((n, n)) * np.logspace(0, -6, n)[None, :]
    eps = jacobi._eps_eff(torch.float64)
    tol = float(np.sqrt(n)) * eps
    U, s, Vh, sweeps = jacobi._svd_jacobi_square(_t(A)[None], b, 30, tol, eps)
    Uj, sj, Vhj, sweeps_j = jax_jacobi._svd_jacobi_square(jnp.asarray(A), b=b, max_sweeps=30,
                                                          tol=tol, eps_eff=eps)
    assert int(sweeps[0]) == int(sweeps_j)
    np.testing.assert_allclose(to_numpy(s[0]), np.asarray(sj), rtol=1e-10,
                               atol=1e-12 * float(sj[0]))
    _full_check(A, U[0], s[0], Vh[0], 1e-10, 1e-10)


# ---- the counterparts of tests/test_jacobi.py ----

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_random_square(rng, dtype):
    A = rng.uniform(0.0, 5.0, size=(96, 96))
    if dtype == "float32":
        A = A.astype(np.float32)
    U, s, Vh = svd_jacobi(_t(A, getattr(torch, dtype)), block=16)
    assert s.dtype == getattr(torch, dtype)
    if dtype == "float64":
        _full_check(A, U, s, Vh, 1e-10, 1e-10)
        assert _rel_err(s, A) < 1e-10
    else:
        _full_check(A, U, s, Vh, 5e-5, 5e-4)
        assert _rel_err(s, A) < 5e-5
        # the JAX package on the same float32 input: the same accuracy class
        sj = np.asarray(jax_jacobi.svd_jacobi(jnp.asarray(A), block=16)[1])
        np.testing.assert_allclose(to_numpy(s), sj, rtol=0, atol=2e-5 * sj[0])


@pytest.mark.parametrize("grading", ["columns", "rows"])
def test_graded_high_relative_accuracy(rng, grading):
    """Column grading over 10 decades, and row grading (the transpose
    flip): ~eps RELATIVE sigma accuracy."""
    n = 96
    G = rng.standard_normal((n, n))
    D = np.logspace(0, -10, n)
    A = G * D[None, :] if grading == "columns" else D[:, None] * G
    U, s, Vh = svd_jacobi(_t(A), block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    rel = _rel_err(s, A, alive_only=True)
    assert rel < 1e-8, f"relative sigma error {rel:.2e}"


def test_tall_and_wide(rng):
    A = rng.standard_normal((120, 64))
    U, s, Vh = svd_jacobi(_t(A), block=8)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    W = rng.standard_normal((64, 120))
    U, s, Vh = svd_jacobi(_t(W), block=8)
    _full_check(W, U, s, Vh, 1e-10, 1e-10)
    assert _rel_err(s, W) < 1e-10


def test_rank_deficient_zero_tail(rng):
    """Numerically zero sigma come back ~0 with ZERO vector columns."""
    n, r = 96, 7
    B = rng.standard_normal((n, r)) @ rng.standard_normal((r, n))
    U, s, Vh = (to_numpy(x) for x in svd_jacobi(_t(B), block=16))
    assert np.linalg.norm(U * s @ Vh - B) / np.linalg.norm(B) < 1e-10
    assert s[r:].max() < 1e-9 * s[0]
    assert np.abs(U[:, r:]).max() == 0.0
    sref = np.linalg.svd(B, compute_uv=False)
    assert np.abs(s[:r] - sref[:r]).max() / sref[0] < 1e-10


def test_nonsquare_block_edge(rng):
    """n not a multiple of 2 block: the padding."""
    A = rng.standard_normal((90, 90))
    U, s, Vh = svd_jacobi(_t(A), block=16)  # pad 90 -> 96
    _full_check(A, U, s, Vh, 1e-10, 1e-10)


def test_batch_matches_single(rng):
    As = rng.standard_normal((4, 64, 64))
    U, s, Vh = svd_jacobi_batch(_t(As), block=8)
    assert U.shape == (4, 64, 64) and s.shape == (4, 64) and Vh.shape == (4, 64, 64)
    srefs = np.linalg.svd(As, compute_uv=False)
    assert np.abs(to_numpy(s) - srefs).max() / srefs.max() < 1e-10
    for i in range(4):
        _full_check(As[i], U[i], s[i], Vh[i], 1e-10, 1e-10)


@pytest.mark.parametrize("shape", [(4, 8, 9), (8, 8)])
def test_batch_shape_validation(shape):
    with pytest.raises(ValueError):
        svd_jacobi_batch(torch.zeros(shape))


def test_sweep_count_terminates(rng):
    """Convergence, not max_sweeps exhaustion, on a clean random matrix."""
    n = 96
    A = rng.uniform(0.0, 5.0, size=(n, n))
    eps = jacobi._eps_eff(torch.float64)
    _, _, _, sweeps = jacobi._svd_jacobi_square(_t(A)[None], 16, 30,
                                                float(np.sqrt(n)) * eps, eps)
    assert 3 <= int(sweeps[0]) <= 20


@pytest.mark.parametrize("scale", [1e10, 1e-30])
def test_jacobi_large_and_tiny_entries(rng, scale):
    """The gesvj-style input scaling: entries ~1e10 would overflow the
    Gram products in float32 (every rotation skipped), ~1e-30 underflow."""
    n = 64
    A = (rng.normal(size=(n, n)) * scale).astype(np.float32)
    U, s, Vh = (to_numpy(x) for x in svd_jacobi(_t(A, torch.float32)))
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    if scale > 1:
        assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < 1e-4


def test_preconditioned_colgraded_relative_accuracy(rng):
    n = 96
    A = rng.standard_normal((n, n)) * np.logspace(0, -10, n)[None, :]
    U, s, Vh = svd_jacobi_pre(_t(A), block=16)
    _full_check(A, U, s, Vh, 1e-10, 1e-10)
    rel = _rel_err(s, A, alive_only=True)
    assert rel < 1e-8, f"relative sigma error {rel:.2e}"
    sj = np.asarray(jax_jacobi.svd_jacobi_pre(jnp.asarray(A), block=16)[1])
    np.testing.assert_allclose(to_numpy(s), sj, rtol=1e-9, atol=0)


def test_preconditioned_fp32_and_shapes(rng):
    A = rng.uniform(0.0, 5.0, size=(96, 96)).astype(np.float32)
    U, s, Vh = svd_jacobi_pre(_t(A, torch.float32), block=16)
    assert s.dtype == torch.float32
    _full_check(A, U, s, Vh, 5e-5, 5e-4)
    assert _rel_err(s, A) < 5e-5
    B = rng.standard_normal((64, 96))  # wide: through the transpose
    U, s, Vh = svd_jacobi_pre(_t(B), block=16)
    _full_check(B, U, s, Vh, 1e-10, 1e-10)


def test_preconditioned_converges_faster(rng):
    """Strictly fewer sweeps than standalone Jacobi on a graded input, and
    each count equal to the JAX package's."""
    n = 96
    A = rng.standard_normal((n, n)) * np.logspace(0, -6, n)[None, :]
    eps = jacobi._eps_eff(torch.float64)
    tol = float(np.sqrt(n)) * eps
    _, _, _, sweeps_std = jacobi._svd_jacobi_square(_t(A)[None], 16, 30, tol, eps)
    _, _, _, sweeps_pre = jacobi._svd_jacobi_pre_square(_t(A), 16, 30, tol, eps)
    assert int(sweeps_pre) < int(sweeps_std[0]), (int(sweeps_pre), int(sweeps_std[0]))
    _, _, _, jpre = jax_jacobi._svd_jacobi_pre_square(jnp.asarray(A), b=16, max_sweeps=30,
                                                      tol=tol, eps_eff=eps)
    assert int(sweeps_pre) == int(jpre)


# ---- test_jacobi_edge_cases (tests/test_robustness.py) ----

def test_jacobi_edge_cases(rng):
    n = 32
    U, s, Vh = (to_numpy(x) for x in svd_jacobi(torch.zeros((n, n))))
    assert np.all(s == 0)
    _, s1, _ = (to_numpy(x) for x in svd_jacobi(torch.eye(n)))
    assert np.max(np.abs(s1 - 1)) < 1e-5
    u = rng.normal(size=(n, 1))
    A = (u @ u.T).astype(np.float32)  # rank one
    U, s, Vh = (to_numpy(x) for x in svd_jacobi(_t(A, torch.float32)))
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < 1e-4
    # duplicate singular values (an orthogonal matrix scaled): the stable sorts
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    _, s2, _ = (to_numpy(x) for x in svd_jacobi(_t(3 * Q, torch.float32)))
    assert np.max(np.abs(s2 - 3)) < 1e-4


# ---- the dispatch and the batch, matrix by matrix ----

def test_svd_method_jacobi_dispatches_to_svd_jacobi(rng):
    A = rng.standard_normal((40, 40))
    got = svd(_t(A), method="jacobi")
    want = svd_jacobi(_t(A))  # the reference's dispatch: the default block
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _full_check(A, *got, 1e-10, 1e-10)
    Ut, st, Vht = svd(_t(rng.standard_normal((50, 30))), method="jacobi")
    assert Ut.shape == (50, 30) and st.shape == (30,) and Vht.shape == (30, 30)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_each_matrix_as_the_single_solve(rng, dtype):
    """Each matrix stops at its own sweep: a nearly diagonal matrix (few
    sweeps) beside random ones (more) in one batch, every matrix's result
    that of svd_jacobi at the same block."""
    n, b = 16, 4
    As = rng.standard_normal((3, n, n))
    As[1] = np.diag(np.linspace(1, 4, n)) + 1e-3 * rng.standard_normal((n, n))
    X = _t(As, dtype)
    eps = jacobi._eps_eff(dtype)
    tol = float(np.sqrt(n)) * eps
    _, _, _, sweeps = jacobi._svd_jacobi_square(X, b, 30, tol, eps)
    assert len(set(sweeps.tolist())) > 1, sweeps  # the batch holds different stops
    U, s, Vh = svd_jacobi_batch(X, block=b)
    for i in range(3):
        Ui, si, Vhi = svd_jacobi(X[i], block=b)
        atol = 1e-12 if dtype == torch.float64 else 1e-5
        np.testing.assert_allclose(to_numpy(s[i]), to_numpy(si), rtol=0,
                                   atol=atol * float(si[0]))
        np.testing.assert_allclose(to_numpy(U[i]), to_numpy(Ui), rtol=0, atol=10 * atol)
        np.testing.assert_allclose(to_numpy(Vh[i]), to_numpy(Vhi), rtol=0, atol=10 * atol)
        _, _, _, one = jacobi._svd_jacobi_square(X[i][None], b, 30, tol, eps)
        assert int(one[0]) == int(sweeps[i])
