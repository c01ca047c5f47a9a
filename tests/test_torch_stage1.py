"""Stage I of the port (plain panel QR, plain and fused dense -> band) held
to the JAX package on CPU, where the port runs its plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import dense_to_band as jax_dense_to_band
from svdsolver_tpu.ops.householder import householder_vector as jax_hh
from svdsolver_tpu_torch.models.two_stage import dense_to_band, segment_bounds
from svdsolver_tpu_torch.ops.cuda import panel_qr
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


def _jax_panel_qr(A, roff):
    """The XLA panel loop, as the JAX package's Pallas test writes it."""
    m, b = A.shape
    P = jnp.asarray(A)
    V = jnp.zeros((m, b), jnp.float32)
    T = jnp.zeros((b, b), jnp.float32)
    ridx = jnp.arange(m)
    for j in range(b):
        p = roff + j
        v, tau, beta = jax_hh(P[:, j], p)
        P = P - tau * jnp.outer(v, v @ P)
        colj = jnp.where(ridx > p, 0.0, P[:, j]).at[p].set(beta)
        P = P.at[:, j].set(colj)
        w = V.T @ v
        T = T.at[:, j].set(-tau * (T @ w)).at[j, j].set(tau)
        V = V.at[:, j].set(v)
    return np.asarray(P), np.asarray(V), np.asarray(T)


@pytest.mark.parametrize(
    "m,b,roff",
    [(32, 8, 4), (96, 16, 16), (40, 16, 30)],  # last: pivots 40..45 past m
)
@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_panel_qr_matches_jax(rng, m, b, roff, entry):
    A = rng.normal(size=(m, b)).astype(np.float32)
    fn = panel_qr.panel_qr_plain if entry == "plain" else panel_qr.panel_qr
    Rt, Vt, Tt = fn(from_numpy(A.T), roff)
    P, V, T = _jax_panel_qr(A, roff)
    np.testing.assert_allclose(to_numpy(Rt).T, P, atol=2e-5)
    np.testing.assert_allclose(to_numpy(Vt).T, V, atol=2e-6)
    np.testing.assert_allclose(to_numpy(Tt).T, T, atol=2e-6)


def test_panel_qr_rejects_bad_input():
    with pytest.raises(ValueError):
        panel_qr.panel_qr(torch.zeros(8), 0)  # not 2-D
    with pytest.raises(ValueError):
        panel_qr.panel_qr(torch.zeros(4, 8), -1)
    with pytest.raises(ValueError):
        panel_qr.panel_qr(torch.zeros(4, 8, device="meta"), 0)  # not cpu/cuda
    with pytest.raises(TypeError):
        panel_qr.panel_qr(np.zeros((4, 8), np.float32), 0)


@pytest.mark.parametrize("n,b", [(64, 8), (96, 16)])
@pytest.mark.parametrize("path", ["plain", "fused"])
def test_dense_to_band_matches_jax(rng, n, b, path):
    A = rng.normal(size=(n, n)).astype(np.float32)
    if path == "plain":
        Ab = to_numpy(dense_to_band(from_numpy(A), band=b))
    else:
        Ab = to_numpy(panel_qr.dense_to_band_fused(from_numpy(A), band=b))
    ref = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))
    i, j = np.ogrid[:n, :n]
    outside = (j - i < 0) | (j - i > b)
    np.testing.assert_allclose(Ab[outside], 0, atol=1e-6)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    got = np.linalg.svd(Ab.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(Ab, ref, atol=1e-4 * np.abs(ref).max())


def test_fused_segments_agree(rng):
    # segment shrinking is exact in exact arithmetic: 1 segment and the
    # auto count agree up to the rounding of differently shaped GEMMs
    A = from_numpy(rng.normal(size=(96, 96)).astype(np.float32))
    one = panel_qr.dense_to_band_fused(A, band=16, segments=1)
    auto = panel_qr.dense_to_band_fused(A, band=16)
    torch.testing.assert_close(one, auto, rtol=0,
                               atol=1e-5 * float(one.abs().max()))
    assert segment_bounds(6, 4) == [0, 1, 3, 4, 6]
    assert panel_qr._auto_segments(3840, 128) == 4
    assert panel_qr._auto_segments(3200, 32) == 12


def test_dense_to_band_rejects_bad_shape():
    with pytest.raises(ValueError):
        dense_to_band(torch.zeros(8, 6), band=2)
    with pytest.raises(ValueError):
        panel_qr.dense_to_band_fused(torch.zeros(10, 10), band=4)
