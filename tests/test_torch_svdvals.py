"""The ported slice, ``svdvals``, held to the JAX package and to LAPACK on
CPU (where the port takes its plain path), plus its routing rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.svd import svdvals as jax_svdvals
from svdsolver_tpu_torch import Bidiagonal, svdvals
from svdsolver_tpu_torch.models import svd as port_svd
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


@pytest.mark.parametrize(
    "shape,block",
    [((64, 64), 16), ((200, 200), None), ((96, 64), None)],
)
def test_svdvals_matches_jax_and_lapack(rng, shape, block):
    A = rng.uniform(0, 5, shape).astype(np.float32)
    got = to_numpy(svdvals(from_numpy(A), block=block))
    ref = np.asarray(jax_svdvals(jnp.asarray(A), method="tpu2", block=block))
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert got.shape == (min(shape),)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])


def test_svdvals_wide_and_tpu1(rng):
    A = rng.normal(size=(40, 56)).astype(np.float32)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    for method in ("tpu1", "tpu2"):
        got = to_numpy(svdvals(from_numpy(A), method=method, block=8))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])


def test_bidiagonalize_pads_and_trims(rng):
    A = from_numpy(rng.normal(size=(30, 30)))
    B = port_svd.bidiagonalize(A, block=8)
    assert isinstance(B, Bidiagonal)
    assert B.d.shape == (30,) and B.e.shape == (29,)
    assert port_svd._auto_block(3840) == 128
    assert port_svd._auto_block(1000) == 64
    assert port_svd._auto_block(200) == 32


def test_use_kernels_is_cuda_float32_only():
    assert not port_svd.use_kernels(torch.zeros(2, dtype=torch.float32))
    assert not port_svd.use_kernels(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"method": "base"},
        {"method": "singlecore"},
        {"method": "multicore"},
        {"method": "base", "diag": "qr"},
        {"method": "multicore", "diag": "dqds"},
    ],
)
def test_svdvals_ladder_options_run(rng, kwargs):
    # the ladder rungs, once refused, run and agree with the JAX package
    # and LAPACK (n = 20: multicore pads to the band, 32)
    A = rng.normal(size=(20, 20)).astype(np.float32)
    got = to_numpy(svdvals(from_numpy(A), **kwargs))
    ref = np.asarray(jax_svdvals(jnp.asarray(A), **kwargs))
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])


@pytest.mark.parametrize(
    "kwargs,err",
    [
        ({"method": "nope"}, ValueError),
        ({"diag": "nope"}, ValueError),
    ],
)
def test_svdvals_unported_options_raise(kwargs, err):
    with pytest.raises(err, match="ROADMAP|unknown"):
        svdvals(torch.eye(4), **kwargs)


def test_svdvals_complex_raises():
    # complex input runs svdvals_c, which takes only the default diagonalizer
    with pytest.raises(ValueError, match="complex"):
        svdvals(torch.eye(4, dtype=torch.complex64), diag="dqds")
