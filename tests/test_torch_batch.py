"""The batch entries of the port (``svdvals_batch``, ``svd_batch``) and the
Stage I with accumulated factors they rest on (``dense_to_band_uv`` and
its fused twin on the panel kernel's wrapper), held to the JAX package on
the CPU, where the port takes its plain paths.

Tolerances: float64 against the JAX package 1e-10 of the matrix's scale
(the same arithmetic in another summation order); float32 singular values
2e-5 relative and 1e-5 sigma_max absolute, the reconstruction 1e-4
sigma_max and the orthogonality 1e-4, the JAX package's own bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import svd as jax_svd
from svdsolver_tpu.models import two_stage as jax_two_stage
from svdsolver_tpu.models import vectors as jax_vectors
from svdsolver_tpu_torch import svd_batch, svdvals, svdvals_batch
from svdsolver_tpu_torch.models import svd as svd_mod
from svdsolver_tpu_torch.models import two_stage, vectors
from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave, panel_qr
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = 1e-10


@pytest.mark.parametrize("n,b", [(32, 8), (48, 16)])
def test_dense_to_band_uv_matches_jax(rng, n, b):
    A = rng.normal(size=(n, n))
    got = two_stage.dense_to_band_uv(from_numpy(A, dtype=torch.float64), band=b)
    want = jax_two_stage.dense_to_band_uv(jnp.asarray(A), band=b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=F64 * np.abs(A).max())
    Ab, U1, V1 = (to_numpy(x) for x in got)
    assert np.abs(U1 @ Ab @ V1.T - A).max() < 1e-12 * np.abs(A).max()
    with pytest.raises(ValueError, match="divisible"):
        two_stage.dense_to_band_uv(from_numpy(A), band=b + 1)


@pytest.mark.parametrize("n,b", [(32, 8), (64, 16)])
def test_dense_to_band_uv_fused_matches_jax(rng, n, b):
    # the fused pair computes the reference's panels with the two-sided
    # update folded: the same band and factors as the JAX package's
    # dense_to_band_uv up to rounding; Ab bit-equal to the fused Stage I on
    # one segment
    A = rng.normal(size=(n, n))
    At = from_numpy(A, dtype=torch.float64)
    got = panel_qr.dense_to_band_uv_fused(At, band=b)
    want = jax_two_stage.dense_to_band_uv(jnp.asarray(A), band=b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0, atol=F64 * np.abs(A).max())
    assert torch.equal(got[0], panel_qr.dense_to_band_fused(At, band=b, segments=1))
    assert torch.equal(At, from_numpy(A, dtype=torch.float64))  # the input is kept


@pytest.mark.parametrize("B,n,block", [(3, 40, None), (3, 24, 8), (3, 20, None)])
def test_svdvals_batch_matches_jax(rng, B, n, block):
    # n = 20: the band by size (32) reaches n and is kept, no halving
    As = rng.normal(size=(B, n, n)).astype(np.float32)
    got = svdvals_batch(from_numpy(As), block=block)
    want = np.asarray(jax_svd.svdvals_batch(jnp.asarray(As), block=block))
    lapack = np.linalg.svd(As.astype(np.float64), compute_uv=False)
    assert got.shape == (B, n)
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-5, atol=1e-5 * lapack.max())
    np.testing.assert_allclose(to_numpy(got), lapack, rtol=2e-5, atol=1e-5 * lapack.max())
    for i in range(B):
        assert torch.equal(got[i], svdvals(from_numpy(As[i]), block=block))


def test_svdvals_batch_takes_no_halving(monkeypatch):
    seen = []
    monkeypatch.setattr(svd_mod, "svdvals", lambda A, block: seen.append(block) or A[0])
    svdvals_batch(torch.zeros((2, 20, 20)))
    assert seen == [32, 32]


@pytest.mark.parametrize("B,n,block", [(3, 48, None), (3, 40, 8), (2, 5, None)])
def test_svd_batch_matches_jax(rng, B, n, block):
    # vectors are not unique: sigma against the JAX package's, the
    # reconstruction and orthogonality of each matrix on their own
    As = rng.normal(size=(B, n, n)).astype(np.float32)
    U, s, Vh = (to_numpy(x).astype(np.float64) for x in svd_batch(from_numpy(As), block=block))
    sj = np.asarray(jax_vectors.svd_batch(jnp.asarray(As), block=block)[1])
    assert U.shape == (B, n, n) and s.shape == (B, n) and Vh.shape == (B, n, n)
    for i in range(B):
        want = np.linalg.svd(As[i].astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s[i], sj[i], rtol=2e-5, atol=1e-5 * want[0])
        np.testing.assert_allclose(s[i], want, rtol=2e-5, atol=1e-5 * want[0])
        assert np.abs(U[i] * s[i] @ Vh[i] - As[i]).max() <= 1e-4 * want[0]
        assert np.abs(U[i].T @ U[i] - np.eye(n)).max() <= 1e-4
        assert np.abs(Vh[i] @ Vh[i].T - np.eye(n)).max() <= 1e-4


def test_svd_batch_follows_the_reference_sequence(rng, monkeypatch):
    # use_kernels patched: a float32 CPU input takes the card's sequence
    # (the wrappers run their plain versions on it): the fused Stage I with
    # factors, then the recording chase the predicate picks, for every
    # matrix; n = 200 at band 16 routes to the wavefront, at 32 not
    calls = []
    monkeypatch.setattr(vectors, "use_kernels", lambda t: True)
    for mod, name in ((panel_qr, "dense_to_band_uv_fused"),
                      (band_chase, "band_to_bidiagonal_accum"),
                      (band_chase_wave, "band_to_bidiagonal_wave_accum")):
        fn = getattr(mod, name)

        def logged(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, logged)
    As = rng.normal(size=(2, 200, 200)).astype(np.float32)
    for block, chase in ((16, "band_to_bidiagonal_wave_accum"),
                         (32, "band_to_bidiagonal_accum")):
        calls.clear()
        U, s, Vh = svd_batch(from_numpy(As), block=block)
        assert calls == ["dense_to_band_uv_fused", chase] * 2
        want = np.linalg.svd(As.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(to_numpy(s), want, rtol=2e-5, atol=1e-5 * want.max())


@pytest.mark.parametrize("entry", [svd_batch, svdvals_batch])
def test_batch_entries_reject_other_shapes(entry):
    for shape in ((4, 4), (2, 4, 5), (1, 2, 3, 3)):
        with pytest.raises(ValueError, match=r"expects \(B, n, n\)"):
            entry(torch.zeros(shape))


@pytest.mark.parametrize("entry", [svd_batch, svdvals_batch])
def test_batch_numpy_input_needs_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        entry(np.zeros((2, 4, 4), dtype=np.float32))
    with pytest.raises(TypeError, match="complex"):
        entry(torch.zeros((2, 4, 4), dtype=torch.complex64))
