"""Successive band reduction in the port (``svdsolver_tpu_torch/models/
sbr.py``) on the CPU: the counterparts of ``tests/test_sbr.py`` (its 4
tests, parametrised as there, float64), each also held to the JAX
package's ``models/sbr.py`` on the same seeded input (the narrowed band
within 1e-12 of max |A| elementwise: the same reflectors in the same
order; sigma within 1e-12 sigma_max), the clamped windows of shapes whose
last windows run past the padding, and the narrow chase's route on the
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import sbr as jax_sbr
from svdsolver_tpu_torch.models import sbr
from svdsolver_tpu_torch.models.sbr import band_reduce_width, band_to_bidiagonal_sbr
from svdsolver_tpu_torch.models.two_stage import band_to_bidiagonal, dense_to_band
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = torch.float64


def _band_matrix(rng, n, b, dtype=np.float64):
    A = rng.normal(size=(n, n)).astype(dtype)
    i, j = np.indices((n, n), sparse=True)
    A *= ((j - i >= 0) & (j - i <= b)).astype(dtype)
    return A


def _sigma(d, e):
    d, e = (to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x) for x in (d, e))
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


@pytest.mark.parametrize(
    "n,b1,b2,nb",
    [
        (32, 8, 3, 3),
        (48, 12, 4, 4),
        (40, 8, 2, 2),
        (37, 10, 5, 3),  # nb < b2, n not a multiple of anything
        (96, 16, 8, 8),
        (20, 8, 7, 1),  # the last windows clamped back into the padding
    ],
)
def test_band_reduce_width_structure_and_spectrum(rng, n, b1, b2, nb):
    A = _band_matrix(rng, n, b1)
    Am = to_numpy(band_reduce_width(from_numpy(A, dtype=F64), b1=b1, b2=b2, nb=nb))
    i, j = np.indices((n, n), sparse=True)
    # exact band structure: zeros below the diagonal and beyond b2
    assert np.abs(Am[(j - i < 0)]).max() == 0.0
    assert np.abs(Am[(j - i > b2)]).max() == 0.0
    s0 = np.linalg.svd(A, compute_uv=False)
    s1 = np.linalg.svd(Am, compute_uv=False)
    assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-12
    want = np.asarray(jax_sbr.band_reduce_width(jnp.asarray(A), b1=b1, b2=b2, nb=nb))
    assert np.abs(Am - want).max() <= 1e-12 * np.abs(A).max()


def test_band_to_bidiagonal_sbr_matches_scalar_chase(rng):
    n, b1, b2 = 64, 16, 4
    A = _band_matrix(rng, n, b1)
    s = _sigma(*band_to_bidiagonal_sbr(from_numpy(A, dtype=F64), band=b1, mid=b2))
    s0 = _sigma(*band_to_bidiagonal(from_numpy(A, dtype=F64), band=b1))
    assert np.max(np.abs(s - s0)) / s0[0] < 1e-12
    jd, je = jax_sbr.band_to_bidiagonal_sbr(jnp.asarray(A), band=b1, mid=b2)
    sj = _sigma(jd, je)
    assert np.max(np.abs(s - sj)) / s0[0] < 1e-12


def test_sbr_full_pipeline_vs_lapack(rng):
    n, band, mid = 96, 16, 8
    A = rng.normal(size=(n, n))
    Ab = dense_to_band(from_numpy(A, dtype=F64), band=band)
    s = _sigma(*band_to_bidiagonal_sbr(Ab, band=band, mid=mid))
    ref = np.linalg.svd(A, compute_uv=False)
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-12


def test_band_reduce_width_validation(rng):
    A = from_numpy(_band_matrix(rng, 16, 4), dtype=F64)
    with pytest.raises(ValueError):
        band_reduce_width(A, b1=4, b2=4)
    with pytest.raises(ValueError):
        band_reduce_width(A, b1=4, b2=2, nb=3)  # nb > b2
    with pytest.raises(ValueError):
        band_reduce_width(torch.zeros((4, 5)), b1=2, b2=1)


def test_window_start_clamps_as_dynamic_slice():
    assert sbr.window_start(3, 5, 4, 4, 20) == (3, 5)
    assert sbr.window_start(18, 19, 4, 6, 20) == (16, 14)
    assert sbr.window_start(-2, 0, 4, 4, 20) == (0, 0)


def test_narrow_chase_routes_to_the_kernel(rng, monkeypatch):
    # a float32 CUDA tensor runs the routed chase kernel at mid (here a CPU
    # tensor stands in, use_kernels patched); the CPU takes the plain chase
    calls = []
    monkeypatch.setattr(sbr, "use_kernels", lambda t: True)
    monkeypatch.setattr(sbr, "routed_chase",
                        lambda Ab, band: calls.append(band) or band_to_bidiagonal(Ab, band=band))
    A = from_numpy(_band_matrix(rng, 40, 8), dtype=torch.float32)
    d, e = band_to_bidiagonal_sbr(A, band=8, mid=4)
    assert calls == [4]
    ref = np.linalg.svd(to_numpy(A).astype(np.float64), compute_uv=False)
    assert np.max(np.abs(_sigma(d, e) - ref)) / ref[0] < 1e-5
