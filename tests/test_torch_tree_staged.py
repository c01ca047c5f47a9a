"""The redesigned bisection (a bisection tree per singular value over a
thread group) and TGK solve (factor rows staged in chunks, U2 rebuilt from
swap words): their plain twins bit-equal to the plain versions of the first
designs, and held to the JAX package on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import vectors as jv
from svdsolver_tpu.models.diagonalize import bisect_svdvals as jax_bisect
from svdsolver_tpu_torch.ops.cuda import bisect, tridiag_solve
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

EPS32 = np.finfo(np.float32).eps


def _de(rng, n):
    d = rng.normal(size=n).astype(np.float32)
    e = rng.normal(size=max(n - 1, 0)).astype(np.float32)
    return from_numpy(d), from_numpy(e)


# (probes, iters): the default sweeps (35 at probes 1, 18 at probes 3) and
# a count that the tree's levels (4 and 2 at GROUP = 16) do or do not divide
@pytest.mark.parametrize("probes,iters", [(1, None), (1, 8), (3, None), (3, 7)])
@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_tree_twin_bit_equal_to_plain(rng, n, probes, iters):
    d, e = _de(rng, n)
    want = bisect.bisect_svdvals_plain(d, e, iters=iters, probes=probes)
    got = bisect.bisect_svdvals_tree_plain(d, e, iters=iters, probes=probes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", [4, 8, 32])
@pytest.mark.parametrize("probes", [1, 2, 3])
def test_tree_twin_every_group(rng, group, probes):
    d, e = _de(rng, 33)
    want = bisect.bisect_svdvals_plain(d, e, probes=probes)
    got = bisect.bisect_svdvals_tree_plain(d, e, probes=probes, group=group)
    assert torch.equal(got, want)


def test_tree_twin_matches_jax(rng):
    d, e = _de(rng, 64)
    s_ref = np.asarray(jax_bisect(jnp.asarray(to_numpy(d)), jnp.asarray(to_numpy(e))))
    s = to_numpy(bisect.bisect_svdvals_tree_plain(d, e))
    np.testing.assert_allclose(s, s_ref, rtol=1e-6, atol=float(np.abs(s_ref).max()) * 1e-7)


def test_tree_shape():
    assert [bisect.tree_levels(1, g) for g in (1, 4, 8, 16, 32)] == [1, 2, 3, 4, 5]
    assert [bisect.tree_levels(3, g) for g in (1, 4, 8, 16, 32)] == [0, 1, 1, 2, 2]
    assert bisect.tree_levels(16, 16) == 1 and bisect.tree_levels(17, 16) == 0
    # at most 16 warps an SM of 132, the smallest group of the same depth
    # (at n = 3840 the group of 32 would be 30 warps an SM)
    assert [bisect.tree_group(3840, p) for p in (1, 2, 3, 7, 16, 17, 32, 33)] == [
        16, 8, 16, 8, 16, 32, 32, 1]
    assert [bisect.tree_group(n, 1) for n in (2, 1024, 2112, 2113, 4224, 4225, 7680, 8449,
                                              23040)] == [32, 32, 32, 16, 16, 8, 8, 4, 4]
    assert [bisect.tree_group(n, 3) for n in (3840, 7680, 15360)] == [16, 4, 4]
    assert bisect.tree_group(7680, 1, sms=264) == 16
    # one wave of blocks, as many an SM as the z^2 streams let it
    assert [bisect.tree_block(n, g) for n, g in (
        (64, 16), (3840, 16), (7680, 8), (7680, 16), (15360, 4), (23040, 4))] == [
        128, 128, 256, 512, 512, 1024]


def test_tree_wrapper_checks_group(rng):
    d, e = _de(rng, 16)
    with pytest.raises(ValueError, match="_group"):
        bisect.bisect_svdvals(d, e, _group=6)
    with pytest.raises(ValueError, match="no tree"):
        bisect.bisect_svdvals(d, e, probes=7, _group=4)
    # on CPU tensors every group runs the plain version
    want = bisect.bisect_svdvals_plain(d, e)
    for group in (None, 1, 4, 32):
        assert torch.equal(bisect.bisect_svdvals(d, e, _group=group), want)


def _tgk_problem(rng, n, k=None):
    """The recipe of the JAX package's tgk-solve parity test; ``k`` keeps
    the top-k shifts (an svds-like lane count)."""
    N = 2 * n
    d = rng.normal(size=(n,)).astype(np.float32) * 5
    e = rng.normal(size=(n - 1,)).astype(np.float32) * 5
    z = np.zeros((N - 1,), np.float32)
    z[0::2] = d
    z[1::2] = e
    sig = np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False).astype(np.float32)
    sig = sig[: k or n]
    pivmin = np.float32(max(float(sig[0]) * EPS32 * EPS32, np.finfo(np.float32).tiny))
    big = np.float32(float(np.finfo(np.float32).max) ** 0.5 / 16.0)
    rhs = rng.normal(size=(N, sig.shape[0])).astype(np.float32)
    return z, sig, rhs, pivmin, big


def _torch(args):
    z, sig, rhs, pivmin, big = args
    return (from_numpy(z), from_numpy(sig), from_numpy(rhs), torch.tensor(pivmin),
            torch.tensor(big))


# (rows, slots): the kernel's chunks (every chunk resident at n = 8), and
# small ones that send most chunks through the scratch
@pytest.mark.parametrize("rows,slots", [(tridiag_solve.ROWS, tridiag_solve.SLOTS),
                                        (8, 2), (5, 3)])
@pytest.mark.parametrize("n,k", [(8, None), (64, None), (64, 5), (64, 37)])
def test_staged_twin_bit_equal_to_plain(rng, n, k, rows, slots):
    args = _torch(_tgk_problem(rng, n, k))
    want = tridiag_solve.tgk_solve_plain(*args)
    got = tridiag_solve.tgk_solve_staged_plain(*args, rows=rows, slots=slots)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_staged_twin_keeps_nan_and_clip(rng):
    # a NaN in rhs stays NaN down its lane, as the clip of the first design
    z, sig, rhs, pivmin, big = _tgk_problem(rng, 16)
    rhs[5, 3] = np.nan
    args = _torch((z, sig, rhs, pivmin, np.float32(1.0)))
    want = tridiag_solve.tgk_solve_plain(*args)
    got = tridiag_solve.tgk_solve_staged_plain(*args, rows=4, slots=2)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want[:, 3]).any()
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert float(want[~torch.isnan(want)].abs().max()) <= 1.0


def test_staged_twin_matches_jax(rng):
    # the normalized solutions within 64 eps of tgk_solve_xla's for well
    # separated lanes (XLA:CPU fuses q - m*p into an FMA: test_torch_tgk)
    args = _tgk_problem(rng, 64)
    z, sig, rhs, pivmin, big = args
    got = tridiag_solve.tgk_solve_staged_plain(*_torch(args), rows=8, slots=2).numpy()
    want = np.asarray(jv.tgk_solve_xla(jnp.asarray(z), jnp.asarray(sig), jnp.asarray(rhs),
                                       jnp.float32(pivmin), jnp.float32(big)))
    got = got / np.linalg.norm(got, axis=0)
    want = want / np.linalg.norm(want, axis=0)
    got = got * np.sign(np.sum(got * want, axis=0))
    gap = np.minimum(np.abs(np.diff(sig, prepend=np.inf)),
                     np.abs(np.diff(sig, append=-np.inf)))
    well = gap > 1e-2 * sig[0]
    assert well.sum() > 10
    assert np.abs(got - want)[:, well].max() < 64 * EPS32


def test_solve_wrapper_on_cpu_is_plain(rng):
    args = _torch(_tgk_problem(rng, 8))
    want = tridiag_solve.tgk_solve_plain(*args)
    for staged in (True, False):
        assert torch.equal(tridiag_solve.tgk_solve(*args, _staged=staged), want)
