"""The recording entry of the sequential chase's staged TMA design, on the
CPU: the plain twin of its copies with ``record=True``
(``two_stage.band_to_bidiagonal_staged_tiles``) held bit-equal to the
sequential recording chase and to the JAX package's.  The route that sends
each entry to it is tested in ``test_torch_staged_tma.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import (
    band_to_bidiagonal_accum as jax_accum,
    dense_to_band as jax_dense_to_band,
)
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import nc_of_static, s_max_of, staged_pairs

SHAPES = [(40, 8), (70, 8), (100, 32), (97, 32), (130, 64), (64, 64), (33, 4)]


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("K", [1, 5])
def test_recording_twin_bit_equal_to_recording_chase(rng, n, b, K):
    # each pair's reflectors in its slot (the head's 0, chase pair k's
    # k + 1) as the copies' order makes them; the pairs past n e_0, as the
    # plain chase leaves its identity reflectors there
    A = _band(rng, n, b)
    want = two_stage.band_to_bidiagonal_accum(A, band=b)
    got = two_stage.band_to_bidiagonal_staged_tiles(A, band=b, khops=K, record=True)
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        assert torch.equal(g, w), name
    assert got[2].shape == (n - 1, s_max_of(n, b), b)


@pytest.mark.parametrize("n,b", [(40, 8), (130, 64)])
def test_recording_twin_pairs_past_n(rng, n, b):
    # the slots of the pairs the kernel skips (corner column at or past n)
    # hold e_0 with tau 0 in the twin, zero rows with tau 0 on the card
    A = _band(rng, n, b)
    _, _, VL, TL, VR, TR = two_stage.band_to_bidiagonal_staged_tiles(A, band=b, record=True)
    skipped = 0
    for i in range(n - 1):
        for k in range(staged_pairs(i, n, b), nc_of_static(i, n, b)):
            for V, T in ((VL, TL), (VR, TR)):
                assert T[i, k + 1] == 0 and V[i, k + 1, 0] == 1
                assert not V[i, k + 1, 1:].any()
            skipped += 1
    assert skipped > 0


def test_recording_twin_rejects_one_row():
    with pytest.raises(ValueError, match="n >= 2"):
        two_stage.band_to_bidiagonal_staged_tiles(torch.ones((1, 1)), band=4, record=True)


@pytest.mark.parametrize("n,b", [(40, 8), (64, 16)])
def test_recording_twin_matches_jax_float64(rng, n, b):
    # the JAX package's recording chase on a Stage I band: f64 records and
    # (d, e) within 1e-10 (the slot layout, the head/chase slot shift, the
    # zero slots past the schedule)
    Ab = np.array(jax_dense_to_band(jnp.asarray(rng.normal(size=(n, n))), band=b))
    got = two_stage.band_to_bidiagonal_staged_tiles(torch.from_numpy(Ab), band=b, khops=2,
                                                    record=True)
    want = [np.asarray(t) for t in jax_accum(jnp.asarray(Ab), band=b)]
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10, err_msg=name)
