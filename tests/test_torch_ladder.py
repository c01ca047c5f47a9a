"""The ladder rungs of the port (``base``: Golub-Kahan, ``singlecore``: the
blocked one-stage reduction, ``multicore``: the tiled Stage I) and the
one-stage ``svd``, held to the JAX package on the CPU, where the port takes
its plain paths; the tiled Stage I's wrappers and plans with their
launches patched out.

Tolerances: float64 comparisons with the JAX package (x64, jitted on the
CPU) take 1e-10 of the matrix's scale: the same arithmetic in another
summation order.  Float32 singular values take 2e-5 relative and 1e-5
sigma_max absolute, the JAX package's own tests' bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import blocked as jax_blocked
from svdsolver_tpu.models import golub_kahan as jax_gk
from svdsolver_tpu.models import svd as jax_svd
from svdsolver_tpu.models import tiled as jax_tiled
from svdsolver_tpu.models import vectors as jax_vectors
from svdsolver_tpu.ops import chase_schedule as jax_sched
from svdsolver_tpu_torch import bidiagonalize_blocked, bidiagonalize_gk, svd, svdvals
from svdsolver_tpu_torch.models import svd as svd_mod
from svdsolver_tpu_torch.models import tiled, vectors
from svdsolver_tpu_torch.ops import chase_schedule
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_wave, tiled_slab
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = 1e-10  # float64 against the JAX package, times the matrix's max |entry|


def _close(got, want, scale):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64 * scale)


@pytest.mark.parametrize("n,b", [(64, 8), (200, 32), (1024, 64), (3840, 128), (37, 4)])
def test_nc_of_on_tensors_matches_jax(n, b):
    i = np.arange(n - 1, dtype=np.int32)
    got = chase_schedule.nc_of(torch.from_numpy(i), n, b)
    want = np.asarray(jax_sched.nc_of(jnp.asarray(i), n, b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), want)
    assert int(chase_schedule.nc_of(torch.tensor(3), n, b)) == chase_schedule.nc_of_static(3, n, b)


@pytest.mark.parametrize("shape", [(24, 24), (30, 20)])
def test_bidiagonalize_gk_matches_jax(rng, shape):
    A = rng.normal(size=shape)
    d, e = bidiagonalize_gk(from_numpy(A, dtype=torch.float64))
    dj, ej = jax_gk.bidiagonalize_gk_jit(jnp.asarray(A))
    assert d.shape == (shape[1],) and e.shape == (shape[1] - 1,)
    scale = np.abs(A).max()
    _close(d, dj, scale)
    _close(e, ej, scale)
    if shape[0] > shape[1]:
        with pytest.raises(ValueError, match="m >= n"):
            bidiagonalize_gk(from_numpy(A.T))


@pytest.mark.parametrize("n,b", [(24, 8), (32, 8), (30, 8), (16, 16), (20, 7)])
def test_bidiagonalize_blocked_matches_jax(rng, n, b):
    # the JAX package's test cases (tests/test_models.py): panels that do
    # and do not divide n, one panel of the whole width
    A = rng.normal(size=(n, n))
    d, e = bidiagonalize_blocked(from_numpy(A, dtype=torch.float64), panel=b)
    dj, ej = jax_blocked.bidiagonalize_blocked(jnp.asarray(A), panel=b)
    scale = np.abs(A).max()
    _close(d, dj, scale)
    _close(e, ej, scale)


def test_bidiagonalize_blocked_rectangular_and_refusal(rng):
    A = rng.normal(size=(30, 20))
    d, e = bidiagonalize_blocked(from_numpy(A, dtype=torch.float64), panel=8)
    dj, ej = jax_blocked.bidiagonalize_blocked(jnp.asarray(A), panel=8)
    _close(d, dj, np.abs(A).max())
    _close(e, ej, np.abs(A).max())
    with pytest.raises(ValueError, match="m >= n"):
        bidiagonalize_blocked(from_numpy(A.T))


@pytest.mark.parametrize("n,t", [(32, 8), (64, 16)])
def test_slab_factorizations_match_jax(rng, n, t):
    # the diagonal slab of tile 1, then a TS slab of tile 1 over the last
    # tile row, each against the JAX package's, elementwise
    A = rng.normal(size=(n, n))
    At = from_numpy(A, dtype=torch.float64)
    c, ri = t, n - t
    tiled._factor_1slab(At, c, t)
    want = jax_tiled._factor_1slab(jnp.asarray(A), c, t)
    _close(At, want, np.abs(A).max())
    tiled._factor_2slab(At, c, ri, t)
    want = jax_tiled._factor_2slab(want, c, ri, t)
    _close(At, want, np.abs(A).max())


def test_slab_step_trivial_reflector():
    # a zero tail gives tau = 0: the step leaves the slab as it was
    S = torch.zeros((4, 6), dtype=torch.float64)
    S[1, 2] = -3.0
    S[0, :] = torch.arange(6.0)
    before = S.clone()
    tiled._slab_factor_step(S, 2, 1)
    assert torch.equal(S, before)


@pytest.mark.parametrize("n,t", [(32, 8), (64, 16)])
def test_dense_to_band_tiled_matches_jax(rng, n, t):
    A = rng.normal(size=(n, n))
    Ab = tiled_slab.dense_to_band_tiled(from_numpy(A, dtype=torch.float64), band=t)
    want = np.asarray(jax_tiled.dense_to_band_tiled(jnp.asarray(A), band=t))
    _close(Ab, want, np.abs(A).max())
    i, j = np.ogrid[:n, :n]
    outside = (j - i < 0) | (j - i > t)
    assert np.abs(to_numpy(Ab)[outside]).max() < 1e-12 * np.abs(A).max()
    assert torch.equal(Ab, tiled.dense_to_band_tiled_plain(from_numpy(A, dtype=torch.float64), t))
    with pytest.raises(ValueError, match="divisible"):
        tiled_slab.dense_to_band_tiled(from_numpy(A), band=t + 1)


@pytest.mark.parametrize("method", ["base", "singlecore", "multicore"])
def test_bidiagonalize_rungs_match_jax(rng, method):
    # n = 40 with block 16: multicore pads to 48
    A = rng.normal(size=(40, 40))
    B = svd_mod.bidiagonalize(from_numpy(A, dtype=torch.float64), method=method, block=16)
    Bj = jax_svd.bidiagonalize(jnp.asarray(A), method=method, block=16)
    assert B.d.shape == (40,) and B.e.shape == (39,)
    _close(B.d, Bj.d, np.abs(A).max())
    _close(B.e, Bj.e, np.abs(A).max())


@pytest.mark.parametrize("diag", ["bisect", "qr", "dqds"])
@pytest.mark.parametrize("method", ["base", "singlecore", "multicore"])
def test_svdvals_rungs_match_jax_and_lapack(rng, method, diag):
    A = rng.uniform(0, 5, (48, 48)).astype(np.float32)
    got = to_numpy(svdvals(from_numpy(A), method=method, diag=diag))
    ref = np.asarray(jax_svd.svdvals(jnp.asarray(A), method=method, diag=diag))
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert got.shape == (48,)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])


def test_bidiagonalize_blocked_uv_matches_jax(rng):
    A = rng.normal(size=(40, 40))
    got = vectors.bidiagonalize_blocked_uv(from_numpy(A, dtype=torch.float64), panel=16)
    want = jax_vectors.bidiagonalize_blocked_uv(jnp.asarray(A), panel=16)
    for g, w in zip(got, want):
        _close(g, w, np.abs(A).max())
    d, e, U, V = (to_numpy(x) for x in got)
    B = np.diag(d) + np.diag(e, 1)
    assert np.abs(U @ B @ V.T - A).max() < 1e-12 * np.abs(A).max()
    with pytest.raises(ValueError, match="square"):
        vectors.bidiagonalize_blocked_uv(from_numpy(A[:, :30]))


@pytest.mark.parametrize("method,shape", [("singlecore", (48, 48)), ("base", (48, 48)),
                                          ("singlecore", (56, 40))])
def test_one_stage_svd_matches_jax(rng, method, shape):
    # singular vectors are not unique: sigma against the JAX package's,
    # reconstruction and orthogonality on their own
    A = rng.normal(size=shape).astype(np.float32)
    U, s, Vh = (to_numpy(x).astype(np.float64) for x in svd(from_numpy(A), method=method))
    sj = np.asarray(jax_vectors.svd(jnp.asarray(A), method=method)[1])
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    k = min(shape)
    assert U.shape == (shape[0], k) and Vh.shape == (k, shape[1])
    np.testing.assert_allclose(s, sj, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    assert np.abs(U * s @ Vh - A).max() <= 1e-4 * want[0]
    assert np.abs(U.T @ U - np.eye(k)).max() <= 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(k)).max() <= 1e-4


def test_svd_one_stage_panel_is_passed(rng, monkeypatch):
    # svd(method="singlecore", panel=p) reduces with panels of p
    seen = []
    fn = vectors.bidiagonalize_blocked_uv
    monkeypatch.setattr(vectors, "bidiagonalize_blocked_uv",
                        lambda A, panel: seen.append(panel) or fn(A, panel=panel))
    svd(from_numpy(rng.normal(size=(20, 20))), method="singlecore", panel=6)
    assert seen == [6]


# ---- the slab kernel's wrapper, its launch patched out ----

@pytest.mark.parametrize("n,t,rows,want", [
    (3840, 128, 256, (29, 128, 8)), (3840, 128, 128, (29, 128, 4)),
    (1024, 64, 128, (8, 120, 4)), (1024, 64, 64, (8, 120, 2)), (3840, 32, 64, (29, 132, 2)),
    (64, 64, 64, (1, 1, 2)), (4096, 168, 336, (1, 3928, 11)),
])
def test_slab_plan_by_shape(n, t, rows, want):
    plan = tiled_slab.slab_plan(n, t, rows, 132)
    assert (plan.width, plan.ctas, plan.rpl) == want
    assert plan.smem <= _build.MAX_SMEM - _build.STATIC_SMEM
    assert plan.ctas * plan.width >= n - t and 32 * plan.rpl >= rows


@pytest.mark.parametrize("t,rows", [(169, 338), (239, 239), (256, 512)])
def test_slab_plan_refuses_past_shared_memory(t, rows):
    with pytest.raises(ValueError, match="shared-memory limit"):
        tiled_slab.slab_plan(4096, t, rows, 132)


@pytest.fixture
def launched(monkeypatch):
    """Send CPU tensors down the tiled Stage I's kernel paths and log each
    launch in place of running it: ("slab", top, pc, t, bot, ctas) for the
    first design, ("chain", top, pc, t, m) and ("apply", top, pc, t, m,
    ctas) for a half-sweep's two kernels."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    def launch(A, top, pc, t, bot, plan):
        calls.append(("slab", top, pc, t, bot, plan.ctas))

    def launch_chain(M, top, pc, t, m, V, tau, plan):
        calls.append(("chain", top, pc, t, m))

    def launch_apply(M, top, pc, t, m, V, tau, plan):
        calls.append(("apply", top, pc, t, m, plan.ctas))

    monkeypatch.setattr(tiled_slab, "_build", OnCard())
    monkeypatch.setattr(tiled_slab, "_launch", launch)
    monkeypatch.setattr(tiled_slab, "_launch_chain", launch_chain)
    monkeypatch.setattr(tiled_slab, "_launch_apply", launch_apply)
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    return calls


@pytest.mark.parametrize("n,t", [(64, 16), (96, 32), (256, 64), (32, 32)])
def test_dense_to_band_tiled_launches_per_slab(launched, n, t):
    # every band up to 128 runs two kernels a half-sweep, 2 (2 n / t - 1)
    # launches, in the reference's order of half-sweeps: QR (c, c), LQ
    # (c + t, c); each chain over the half-sweep's m TS slabs; no launch of
    # the first design
    before = (tiled_slab.launches, tiled_slab.launches_chain, tiled_slab.launches_apply)
    tiled_slab.dense_to_band_tiled(torch.zeros((n, n)), band=t)
    nbt = n // t
    assert len(launched) == 2 * (2 * nbt - 1)
    assert (tiled_slab.launches - before[0], tiled_slab.launches_chain - before[1],
            tiled_slab.launches_apply - before[2]) == (0, 2 * nbt - 1, 2 * nbt - 1)
    want = []
    for k in range(nbt):
        c = k * t
        sweeps = [(c, nbt - k - 1)] + ([(c + t, nbt - k - 2)] if k < nbt - 1 else [])
        for top, m in sweeps:
            want += [("chain", top, c, t, m), ("apply", top, c, t, m)]
    assert [x[:5] for x in launched] == want
    ctas = max(1, -(-(n - t) // max(1, min(32, -(-(n - t) // 132)))))
    assert all(x[5] == ctas for x in launched if x[0] == "apply")


def test_tile_past_the_limit_raises_before_any_launch(launched):
    # every band up to n has a design (the wide instance past 168); a band
    # past n raises before any launch
    with pytest.raises(ValueError, match="band=1024"):
        tiled_slab.dense_to_band_tiled(torch.zeros((512, 512)), band=1024)
    with pytest.raises(ValueError, match="outside"):
        tiled_slab.tiled_route(512, 1024, 132)
    assert launched == []


def test_failed_launch_raises_with_no_fallback(monkeypatch, launched):
    # each kernel's failure raises; nothing falls back to another path
    for name in ("tiled_slab", "tiled_chain", "tiled_apply"):
        def fail(*a, _name=name):
            _build.raise_on_error(2, _name)

        monkeypatch.setattr(tiled_slab, {"tiled_slab": "_launch", "tiled_chain": "_launch_chain",
                                         "tiled_apply": "_launch_apply"}[name], fail)
    with pytest.raises(RuntimeError, match="tiled_chain launch failed"):
        tiled_slab.dense_to_band_tiled(torch.zeros((64, 64)), band=16)
    with pytest.raises(RuntimeError, match="tiled_slab launch failed"):
        tiled_slab.factor_slab(torch.zeros((64, 64)), 0, 0, 16)
    with pytest.raises(RuntimeError, match="tiled_slab launch failed"):
        tiled_slab.dense_to_band_tiled(torch.zeros((272, 272)), band=136)
    V, tau = torch.zeros((2, 16, 32)), torch.zeros((2, 16))
    with pytest.raises(RuntimeError, match="tiled_apply launch failed"):
        tiled_slab.apply_sweep(torch.zeros((64, 64)), 32, 16, 16, V, tau)
    assert launched == []


def test_factor_slab_checks_its_rows():
    A = torch.zeros((64, 64))
    with pytest.raises(ValueError, match="overlapping"):
        tiled_slab.factor_slab(A, 16, 16, 16, bot=24)
    with pytest.raises(ValueError, match="outside"):
        tiled_slab.factor_slab(A, 56, 0, 16)


def test_multicore_takes_the_tiled_stage1_and_the_routed_chase(rng, monkeypatch):
    # use_kernels patched: a float32 CPU input takes the kernels' path (the
    # wrappers run their plain versions on it); n = 200 at band 16 has four
    # lanes (the wavefront), at band 32 two (the sequential chase)
    calls = []
    monkeypatch.setattr(svd_mod, "use_kernels", lambda t: True)
    for mod, name in ((band_chase, "band_to_bidiagonal"),
                      (band_chase_wave, "band_to_bidiagonal_wave"),
                      (tiled_slab, "dense_to_band_tiled")):
        fn = getattr(mod, name)

        def logged(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, logged)
    A = rng.uniform(0, 5, (200, 200)).astype(np.float32)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    for block, chase in ((16, "band_to_bidiagonal_wave"), (32, "band_to_bidiagonal")):
        calls.clear()
        s = svdvals(from_numpy(A), method="multicore", block=block)
        assert calls == ["dense_to_band_tiled", chase]
        np.testing.assert_allclose(to_numpy(s), want, rtol=2e-5, atol=1e-5 * want[0])
