"""The chase back-transforms of the port (rank-1 reference form, grouped
compact-WY, its folded and trimmed form, and the paired walk) on the JAX
package's own records, held to each other and to the JAX package in
float64 (the tolerance of the JAX package's own tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import vectors as jv
from svdsolver_tpu.models.two_stage import (
    band_to_bidiagonal_accum as jax_accum,
    dense_to_band as jax_dense_to_band,
)
from svdsolver_tpu_torch.models import vectors as tv
from svdsolver_tpu_torch.utils.convert import records_from_numpy


def _jax_records(rng, n, b):
    A = jnp.asarray(rng.normal(size=(n, n)))
    rec = jax_accum(jax_dense_to_band(A, band=b), band=b)
    return [np.asarray(t) for t in rec]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# n=96/b=16 has a ragged last group, n=72/b=8 several full groups
@pytest.mark.parametrize("n,b", [(48, 8), (96, 16), (72, 8)])
def test_chase_wy_forms_match_rank1(rng, n, b):
    rec = _jax_records(rng, n, b)
    _, _, VL, TL, VR, TR = records_from_numpy(rec)
    M = torch.from_numpy(rng.normal(size=(n, n)))
    for V, T in ((VL, TL), (VR, TR)):
        want = tv._apply_chase_reflectors(V, T, M, b, reverse=True).numpy()
        _close(tv._apply_chase_reflectors_wy(V, T, M, b), want)
        _close(tv._apply_chase_reflectors_wy_carry(V, T, M, b), want)
        # slot-padded records (all-zero tau slots) are exact no-ops
        s_pad = -(-V.shape[1] // 8) * 8 + 8
        Vp = torch.nn.functional.pad(V, (0, 0, 0, s_pad - V.shape[1]))
        Tp = torch.nn.functional.pad(T, (0, s_pad - T.shape[1]))
        _close(tv._apply_chase_reflectors_wy_carry(Vp, Tp, M, b), want)


@pytest.mark.parametrize("n,b", [(48, 8), (96, 16)])
def test_chase_backtransforms_match_jax(rng, n, b):
    # each form of the port against the same form of the JAX package, on
    # the same records; and the paired walk against both single walks
    rec = _jax_records(rng, n, b)
    VL, TL, VR, TR = records_from_numpy(rec)[2:]
    jrec = [jnp.asarray(r) for r in rec[2:]]
    k = 7  # thin M, as svds hands the back-transforms
    ML, MR = rng.normal(size=(2, n, k))
    tML, tMR = torch.from_numpy(ML), torch.from_numpy(MR)
    _close(tv._apply_chase_reflectors(VR, TR, tMR, b, reverse=False),
           jv._apply_chase_reflectors(jrec[2], jrec[3], jnp.asarray(MR), b, False))
    _close(tv._apply_chase_reflectors_wy(VL, TL, tML, b),
           jv._apply_chase_reflectors_wy(jrec[0], jrec[1], jnp.asarray(ML), b))
    _close(tv._apply_chase_reflectors_wy_carry(VR, TR, tMR, b),
           jv._apply_chase_reflectors_wy_carry(jrec[2], jrec[3], jnp.asarray(MR), b))
    got_l, got_r = tv._apply_chase_reflectors_wy_pair(VL, TL, VR, TR, tML, tMR, b)
    want_l, want_r = jv._apply_chase_reflectors_wy_pair(
        *jrec, jnp.asarray(ML), jnp.asarray(MR), b)
    _close(got_l, want_l)
    _close(got_r, want_r)
    _close(got_l, tv._apply_chase_reflectors_wy_carry(VL, TL, tML, b).numpy())


def test_larft_closed_form_matches_jax(rng):
    # batched closed-form T against the JAX package's, one (G+b, G) block
    m, b = 24, 8
    V = np.tril(rng.normal(size=(m, b)), -1)
    V[np.arange(b), np.arange(b)] = 1.0
    taus = 2.0 / np.sum(V * V, axis=0)
    taus[3] = 0.0
    V[:, 3] = 0.0
    got = tv._larft_closed_form(torch.from_numpy(V)[None], torch.from_numpy(taus)[None])[0]
    _close(got, jv._larft_closed_form(jnp.asarray(V), jnp.asarray(taus)))
