"""The chases past b = 256 (the wide pair): the cluster kernels' plan and
the plain wide chase against the JAX package.

``band_chase.wide_chase_plan`` is plain Python: its row blocks, column
blocks and staged chunks are walked here over every window of the
schedule (``ops.chase_schedule``), windows clipped at n included, as the
cluster kernels (``csrc/chase_cluster.cuh``) deal them.  The kernels
themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.check_wide_chases``): there they are held bit for bit to the
L2 kernel, whose arithmetic they repeat.  Here the plain versions they are
held to on the card (``models/two_stage``) run at wide bands against the
JAX package's chases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import two_stage as jax_two_stage
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors
from svdsolver_tpu_torch.ops import chase_schedule
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_wave


def _windows(n, b):
    """The distinct clipped windows of the sequential schedule: (right rows,
    right columns, left rows, left columns) of every pair with work."""
    seen = set()
    for i in range(n - 1):
        pairs = [(i, i + 1, b + 1, 1)]
        pairs += [(i + 1 + k * b, i + 1 + (k + 1) * b, 2 * b, b)
                  for k in range(chase_schedule.nc_of_static(i, n, b))]
        for r0, c0, wr, lr0 in pairs:
            if c0 >= n:
                continue
            rl = r0 + lr0
            seen.add((min(wr, n - r0), min(b, n - c0), min(b, n - rl), min(2 * b, n - c0)))
    return seen


def _chunks(lo, hi, step):
    return [(x, min(hi, x + step)) for x in range(lo, hi, step)]


@pytest.mark.parametrize("b", [257, 288, 384, 512, 640, 1024])
@pytest.mark.parametrize("shape", ["b+1", "2b+64", "5b"])
def test_plan_covers_every_window_once(b, shape):
    n = {"b+1": b + 1, "2b+64": 2 * b + 64, "5b": 5 * b}[shape]
    plan = band_chase.wide_chase_plan(n, b)
    assert plan.ctas == 16 and plan.cols == -(-2 * b // 16)
    ld_right, ld_left = band_chase.stage_ld(b), band_chase.stage_ld(plan.cols)
    assert ld_right % 4 == 0 and ld_right >= b + 3 and ld_left >= plan.cols + 3
    assert plan.smem == 4 * ((b + 31 & ~31) + (plan.cols + 31 & ~31) + plan.stage)
    assert plan.smem <= _build.MAX_SMEM - _build.STATIC_SMEM
    assert plan.whole == (max(plan.cols * ld_right, b * ld_left) <= plan.stage)
    assert plan.rchunk * ld_right <= plan.stage and plan.lchunk * ld_left <= plan.stage
    if plan.whole:
        assert (plan.rchunk, plan.lchunk) == (plan.cols, b)
    for rr, rc, lr, lc in _windows(n, b):
        assert rr >= 1 and lr >= 1
        for count, most in ((rr, plan.cols), (lc, plan.cols)):
            blocks = [band_chase.cluster_share(count, plan.ctas, q) for q in range(plan.ctas)]
            covered = [x for lo, hi in blocks for x in range(lo, hi)]
            assert covered == list(range(count))  # each row / column once, in order
            assert all(hi - lo <= most for lo, hi in blocks)
            assert blocks[0][0] == 0 and blocks[0][1] > 0  # CTA 0 owns the pivot row / column
        for lo, hi in (band_chase.cluster_share(rr, plan.ctas, q) for q in range(plan.ctas)):
            chunks = _chunks(lo, hi, plan.rchunk)
            assert [x for a, z in chunks for x in range(a, z)] == list(range(lo, hi))
            assert all((z - a) * band_chase.stage_ld(rc) <= plan.stage for a, z in chunks)
        for lo, hi in (band_chase.cluster_share(lc, plan.ctas, q) for q in range(plan.ctas)):
            chunks = _chunks(0, lr, plan.lchunk)
            assert [x for a, z in chunks for x in range(a, z)] == list(range(lr))
            assert all((z - a) * band_chase.stage_ld(hi - lo) <= plan.stage
                       for a, z in chunks)
            assert len(chunks) == 1 or not plan.whole


@pytest.mark.parametrize("b,whole,chunks", [
    (512, True, (64, 512)), (648, True, (81, 648)), (649, False, (82, 648)),
    (1024, False, (55, 429)), (4096, False, (12, 103))])
def test_plan_stages_whole_slices_where_they_fit(b, whole, chunks):
    plan = band_chase.wide_chase_plan(2 * b, b)
    assert plan.whole is whole and (plan.rchunk, plan.lchunk) == chunks


@pytest.mark.parametrize("ctas,cols,whole", [(4, 256, False), (8, 128, False), (16, 64, True)])
def test_plan_at_each_cluster_size(monkeypatch, ctas, cols, whole):
    # the plan reads CLUSTER_MAX_CTAS when called (the timing tool sets it)
    monkeypatch.setattr(band_chase, "CLUSTER_MAX_CTAS", ctas)
    plan = band_chase.wide_chase_plan(2048, 512)
    assert (plan.ctas, plan.cols, plan.whole) == (ctas, cols, whole)
    assert band_chase.wide_route(2048, 512) == plan


def test_plan_raises_past_its_range(monkeypatch):
    with pytest.raises(ValueError, match="outside"):
        band_chase.wide_chase_plan(1000, 256)  # the narrow pair's band
    with pytest.raises(ValueError, match="outside"):
        band_chase.wide_chase_plan(600, 601)  # past n
    with pytest.raises(ValueError, match="threads"):
        band_chase.wide_chase_plan(10000, band_chase.CLUSTER_MAX_BAND + 1)
    assert band_chase.wide_chase_plan(10000, band_chase.CLUSTER_MAX_BAND).cols == 512
    with monkeypatch.context() as m:  # 2b columns over 4 CTAs of 512 threads
        m.setattr(band_chase, "CLUSTER_MAX_CTAS", 4)
        assert band_chase.wide_chase_plan(2048, 1024).cols == 512
        with pytest.raises(ValueError, match="threads"):
            band_chase.wide_chase_plan(2048, 1025)
    # the routes: None where the plan does not take the band
    assert band_chase.wide_route(10000, band_chase.CLUSTER_MAX_BAND + 1) is None
    assert band_chase.wide_route(1000, 256) is None
    assert band_chase.wide_route(1000, 300) == band_chase.wide_chase_plan(1000, 300)


def test_cluster_share_deals_contiguous_blocks():
    assert [band_chase.cluster_share(33, 16, q) for q in (0, 1, 15)] == [(0, 3), (3, 6),
                                                                         (33, 33)]
    assert [band_chase.cluster_share(1024, 16, q) for q in (0, 15)] == [(0, 64), (960, 1024)]


# ---- the plain wide chase against the JAX package ----

def _wide_band(n, b, seed):
    a = np.random.default_rng(seed).uniform(-1, 1, (n, n)).astype(np.float32)
    return np.triu(a) - np.triu(a, b + 1)


def _sigma(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


@pytest.mark.parametrize("n,b", [(600, 288), (530, 257)])
@pytest.mark.parametrize("entry", ["band_to_bidiagonal", "band_to_bidiagonal_accum",
                                   "band_to_bidiagonal_wavefront"])
def test_plain_wide_chase_matches_jax(n, b, entry):
    # the plain versions the cluster kernels are held to, at bands past 256:
    # the spectrum of (d, e) against the JAX package's chase and against
    # float64 sigma(Ab) within 1e-5 sigma_max; the records rebuild the band
    Ab = _wide_band(n, b, seed=b)
    got = getattr(two_stage, entry)(torch.from_numpy(Ab), band=b)
    want = getattr(jax_two_stage, entry)(jnp.asarray(Ab), band=b)
    ref = np.linalg.svd(Ab.astype(np.float64), compute_uv=False)
    smax = ref[0]
    s_got, s_want = _sigma(got[0], got[1]), _sigma(want[0], want[1])
    assert np.abs(s_got - ref).max() <= 1e-5 * smax
    assert np.abs(s_got - s_want).max() <= 1e-5 * smax
    if entry == "band_to_bidiagonal_accum":
        d, e, VL, TL, VR, TR = got
        assert VL.shape == (n - 1, chase_schedule.s_max_of(n, b), b)
        eye = torch.eye(n)
        L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
        R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
        B = torch.diag(d) + torch.diag(e, 1)
        scale = float(np.abs(Ab).max())
        assert float((L @ B @ R.T - torch.from_numpy(Ab)).abs().max()) <= 1e-5 * scale
        assert float((L.T @ L - eye).abs().max()) <= 1e-5
        assert float((R.T @ R - eye).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,b", [(600, 288), (530, 257)])
def test_wrappers_on_cpu_run_the_plain_wide_chase(n, b):
    # a CPU tensor takes the plain version whatever kernel the card would
    # take (the cluster kernel and the cluster tick at these shapes)
    A = torch.from_numpy(_wide_band(n, b, seed=1))
    assert band_chase.wide_route(n, b) is not None
    d, e = band_chase.band_to_bidiagonal(A, band=b)
    d0, e0 = two_stage.band_to_bidiagonal(A, band=b)
    assert torch.equal(d, d0) and torch.equal(e, e0)
    dw, ew = band_chase_wave.band_to_bidiagonal_wave(A, band=b)
    dw0, ew0 = two_stage.band_to_bidiagonal_wavefront(A, band=b)
    assert torch.equal(dw, dw0) and torch.equal(ew, ew0)


@pytest.mark.parametrize("n,b,wave", [(2048, 512, False), (1440, 288, True), (3840, 512, True),
                                      (6144, 512, True), (900, 257, False), (5 * 384, 384, True)])
def test_wide_route_follows_its_table(n, b, wave):
    # past b = 256 the cluster tick from two lanes on, the sequential
    # cluster kernel below: wave_lanes_needed's wide table (measured)
    assert band_chase.wide_route(n, b) is not None
    for pred in (band_chase_wave.wave_chase_preferred, band_chase_wave.wave_chase_accum_preferred):
        assert pred(n, b) is wave
    assert (two_stage.wave_lanes(n, b) >= 2) is wave
    if n in (2048, 1440, 3840, 6144):
        assert f"{n} / {b} " in band_chase_wave.wave_lanes_needed.__doc__
