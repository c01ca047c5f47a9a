"""The port's chase and bisection (plain versions, and the kernel wrappers
on CPU tensors) held to the JAX package on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.diagonalize import bisect_svdvals as jax_bisect
from svdsolver_tpu.models.two_stage import band_to_bidiagonal as jax_chase
from svdsolver_tpu.models.two_stage import dense_to_band as jax_dense_to_band
from svdsolver_tpu_torch.models.diagonalize import bisect_svdvals
from svdsolver_tpu_torch.models.two_stage import band_to_bidiagonal
from svdsolver_tpu_torch.ops.cuda import band_chase, bisect
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


@pytest.mark.parametrize("n,b", [(64, 8), (96, 16)])
def test_chase_matches_jax(rng, n, b):
    A = rng.normal(size=(n, n)).astype(np.float32)
    Ab = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))  # the JAX band
    d, e = band_to_bidiagonal(from_numpy(Ab), band=b)
    dj, ej = jax_chase(jnp.asarray(Ab), band=b)
    d, e = to_numpy(d), to_numpy(e)
    # d/e diverge elementwise past the leading entries (fp32 reduction order)
    np.testing.assert_allclose(
        np.abs(d)[:8], np.abs(np.asarray(dj))[:8], rtol=1e-4
    )
    B = np.diag(d) + np.diag(e, 1)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    got = np.linalg.svd(B.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])
    # the kernel wrapper on a CPU tensor is the plain chase
    dw, ew = band_chase.band_to_bidiagonal(from_numpy(Ab), band=b)
    np.testing.assert_array_equal(to_numpy(dw), d)
    np.testing.assert_array_equal(to_numpy(ew), e)


def test_chase_small_and_rejects():
    d, e = band_to_bidiagonal(torch.tensor([[-3.0]]), band=4)
    assert to_numpy(d).tolist() == [3.0] and e.shape == (0,)
    with pytest.raises(ValueError):
        band_chase.band_to_bidiagonal(torch.zeros(4, 4, device="meta"), band=2)


def _de(rng, n):
    d = rng.normal(size=n).astype(np.float32)
    e = rng.normal(size=n - 1).astype(np.float32)
    return d, e


@pytest.mark.parametrize("n", [8, 64, 200])
@pytest.mark.parametrize("probes", [1, 3])
def test_twisted_bisect_matches_jax(rng, n, probes):
    d, e = _de(rng, n)
    s_ref = np.asarray(jax_bisect(jnp.asarray(d), jnp.asarray(e)))
    s = to_numpy(bisect.bisect_svdvals_plain(from_numpy(d), from_numpy(e),
                                             probes=probes))
    # the twisted count transitions within an fp32 ulp of the one-sided one
    np.testing.assert_allclose(
        s, s_ref, rtol=1e-6, atol=float(np.max(np.abs(s_ref))) * 1e-7
    )
    # the kernel wrapper on CPU tensors is the plain version
    sw = to_numpy(bisect.bisect_svdvals(from_numpy(d), from_numpy(e),
                                        probes=probes))
    np.testing.assert_array_equal(sw, s)


@pytest.mark.parametrize("n", [8, 64, 200])
def test_one_sided_bisect_matches_jax(rng, n):
    d, e = _de(rng, n)
    s_ref = np.asarray(jax_bisect(jnp.asarray(d), jnp.asarray(e)))
    s = to_numpy(bisect_svdvals(from_numpy(d), from_numpy(e)))
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    B = np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1)
    want = np.linalg.svd(B, compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])


def test_bisect_iters_and_rejects(rng):
    d, e = _de(rng, 16)
    one = bisect.bisect_svdvals(from_numpy(d[:1]), from_numpy(e[:0]))
    assert to_numpy(one).tolist() == [abs(float(d[0]))]
    with pytest.raises(ValueError):
        bisect.bisect_svdvals(from_numpy(d), from_numpy(e), probes=0)
    with pytest.raises(ValueError):
        bisect.bisect_svdvals(from_numpy(d), from_numpy(e[:-1]))
    from svdsolver_tpu_torch.models.diagonalize import default_bisect_iters

    assert default_bisect_iters(torch.float32) == 35
    assert default_bisect_iters(torch.float32, probes=3) == 18
