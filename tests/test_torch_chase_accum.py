"""The recording chase of the port (plain ``band_to_bidiagonal_accum``;
the wrapper takes it on CPU) held to the JAX package's, and the records'
factorization ``Ab = L bidiag(d, e) R^T``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import (
    band_to_bidiagonal_accum as jax_accum,
    dense_to_band as jax_dense_to_band,
)
from svdsolver_tpu_torch.models.two_stage import (
    band_to_bidiagonal,
    band_to_bidiagonal_accum,
    make_window_pairs,
)
from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import band_chase


def _band(rng, n, b):
    A = jnp.asarray(rng.normal(size=(n, n)))
    return np.array(jax_dense_to_band(A, band=b))


@pytest.mark.parametrize("n,b", [(48, 8), (64, 16)])
@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_chase_accum_matches_jax(rng, n, b, entry):
    # same schedule and arithmetic as the JAX recording chase: f64 records
    # within 1e-10 (slot layout, the head/chase slot shift, the zero slots
    # past the schedule), (d, e) too
    Ab = _band(rng, n, b)
    fn = band_to_bidiagonal_accum if entry == "plain" else band_chase.band_to_bidiagonal_accum
    got = [t.numpy() for t in fn(torch.from_numpy(Ab), band=b)]
    want = [np.asarray(t) for t in jax_accum(jnp.asarray(Ab), band=b)]
    assert got[2].shape == (n - 1, s_max_of(n, b), b)
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("n,b", [(64, 16), (56, 8)])
def test_chase_accum_factorization_fp32(rng, n, b):
    # fp32: (d, e) bit-equal to the non-recording chase (one schedule, one
    # arithmetic); L and R from the records (rank-1 reference form on the
    # identity) are orthogonal and rebuild the band
    Ab = torch.from_numpy(_band(rng, n, b).astype(np.float32))
    d, e, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    d0, e0 = band_to_bidiagonal(Ab, band=b)
    assert torch.equal(d, d0) and torch.equal(e, e0)
    eye = torch.eye(n)
    L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
    R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
    B = torch.diag(d) + torch.diag(e, 1)
    scale = float(Ab.abs().max())
    assert float((L @ B @ R.T - Ab).abs().max()) <= 1e-5 * scale
    assert float((L.T @ L - eye).abs().max()) <= 1e-5
    assert float((R.T @ R - eye).abs().max()) <= 1e-5


def test_unfilled_slots_are_zero(rng):
    # sweep i fills slots 0..nc(i) only; the rest stay zero with tau 0
    n, b = 40, 8
    Ab = torch.from_numpy(_band(rng, n, b))
    _, _, VL, TL, VR, TR = band_to_bidiagonal_accum(Ab, band=b)
    last = n - 2  # nc = 1: slots 0 and 1
    for V, T in ((VL, TL), (VR, TR)):
        assert V[last, 2:].abs().max() == 0 and T[last, 2:].abs().max() == 0
        assert V[0, :, 0].min() == 1  # every filled slot of sweep 0 has v[0] = 1


def test_window_pairs_record_lengths():
    w = 5
    top, chase = make_window_pairs(w, record=True)
    Wt = torch.arange(w * (2 * w - 2), dtype=torch.float64).reshape(w, -1)
    _, vr, tr, vl, tl = top(Wt.clone())
    assert vr.shape == vl.shape == (w - 1,) and tr.ndim == tl.ndim == 0
    Wc = torch.arange((2 * w - 2) ** 2, dtype=torch.float64).reshape(2 * w - 2, -1)
    out = chase(Wc.clone())
    assert out[3].shape == (w - 1,)


def test_accum_rejects_tiny():
    with pytest.raises(ValueError, match="n >= 2"):
        band_to_bidiagonal_accum(torch.ones(1, 1), band=1)
    with pytest.raises(ValueError, match="n >= 2"):
        band_chase.band_to_bidiagonal_accum(torch.ones(1, 1), band=1)
