"""The recording Stage I of the port (plain ``dense_to_band_rec`` and the
fused ``dense_to_band_rec_fused``, which on CPU runs the plain panel) held
to the JAX package's ``dense_to_band_rec``, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import dense_to_band_rec as jax_rec
from svdsolver_tpu.models.vectors import (
    _apply_stage1_reflectors_pair as jax_stage1_pair,
)
from svdsolver_tpu_torch.models.two_stage import dense_to_band, dense_to_band_rec
from svdsolver_tpu_torch.models.vectors import _apply_stage1_reflectors_pair
from svdsolver_tpu_torch.ops.cuda import panel_qr
from svdsolver_tpu_torch.utils.convert import records_from_numpy, to_numpy


def _rec(path, A, b, segments=None):
    if path == "plain":
        return dense_to_band_rec(A, band=b)
    return panel_qr.dense_to_band_rec_fused(A, band=b, segments=segments)


@pytest.mark.parametrize("n,b", [(64, 16), (48, 8)])
@pytest.mark.parametrize("path", ["plain", "fused"])
def test_stage1_rec_matches_jax(rng, n, b, path):
    # same factorization and record contract (Vq[k] = V_k^T, Tq[k] = T_k^T,
    # identity reflectors as zero rows): f64 to 1e-12; the fused path runs
    # its default segments, whose records are embedded at column s0
    A = rng.normal(size=(n, n))
    got = [to_numpy(t) for t in _rec(path, torch.from_numpy(A), b)]
    want = [np.asarray(t) for t in jax_rec(jnp.asarray(A), band=b)]
    for name, g, w in zip(("Ab", "Vq", "Tq", "Vl", "Tl"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_stage1_rec_reconstructs(rng, path):
    # U1 Ab V1^T = A with U1, V1 rebuilt from the records (the JAX test's
    # recipe, test_dense_to_band_rec_matches_uv), and the band is the
    # non-recording Stage I's
    n, b = 64, 16
    A = torch.from_numpy(rng.normal(size=(n, n)))
    Ab, Vq, Tq, Vl, Tl = _rec(path, A, b)
    eye = torch.eye(n, dtype=A.dtype)
    U1, V1 = _apply_stage1_reflectors_pair(Vq, Tq, Vl, Tl, eye, eye)
    torch.testing.assert_close(U1 @ Ab @ V1.T, A, rtol=0, atol=1e-12)
    torch.testing.assert_close(U1.T @ U1, eye, rtol=0, atol=1e-12)
    torch.testing.assert_close(V1.T @ V1, eye, rtol=0, atol=1e-12)
    torch.testing.assert_close(Ab, dense_to_band(A, band=b), rtol=0, atol=1e-12)


def test_fused_rec_segments_exact(rng):
    # the segmented trailing update embeds each (b, n - s0) record at column
    # s0 of a zero row: the records of 1, 2 and 6 segments agree with the
    # full-width plain recording Stage I
    n, b = 96, 16
    A = torch.from_numpy(rng.normal(size=(n, n)))
    want = dense_to_band_rec(A, band=b)
    for segments in (1, 2, 6):
        got = panel_qr.dense_to_band_rec_fused(A, band=b, segments=segments)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    assert panel_qr.dense_to_band_rec_fused(A, band=b)[1][-1, :, :80].abs().max() == 0


def test_stage1_pair_matches_jax(rng):
    # the port's backward Stage I walk on the JAX package's records
    n, b, k = 48, 8, 5
    A = rng.normal(size=(n, n))
    rec = [np.asarray(t) for t in jax_rec(jnp.asarray(A), band=b)]
    _, Vq, Tq, Vl, Tl = records_from_numpy(rec)
    MU, MV = rng.normal(size=(2, n, k))
    got = _apply_stage1_reflectors_pair(
        Vq, Tq, Vl, Tl, torch.from_numpy(MU), torch.from_numpy(MV)
    )
    want = jax_stage1_pair(*map(jnp.asarray, rec[1:]), jnp.asarray(MU),
                           jnp.asarray(MV))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_numpy(g), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())


def test_fused_pair_step_returns_records(rng):
    n, b = 32, 8
    S = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    out, recs = panel_qr._fused_panel_pair_step(b, S, 0)
    assert out is S
    Vt, Tt, Vt2, Tt2 = recs
    assert Vt.shape == Vt2.shape == (b, n) and Tt.shape == Tt2.shape == (b, b)


def test_records_from_numpy_checks_arity():
    with pytest.raises(ValueError, match="expected"):
        records_from_numpy((np.zeros(3),) * 4)
    d, e, VL, TL, VR, TR = records_from_numpy(
        (np.ones(3), np.ones(2), np.zeros((2, 1, 2)), np.zeros((2, 1)),
         np.zeros((2, 1, 2)), np.zeros((2, 1)))
    )
    assert d.dtype == torch.float64 and VL.shape == (2, 1, 2)
