"""The widths the card takes (F3's repair): every band the reference's XLA
path runs, 1 <= b <= n after padding, reaches a hand-written kernel.

On the CPU the wrappers' launches are patched out (fixture ``launched``:
``_build.check_input`` says "on the card", each ``_launch`` logs its call
and returns a stand-in of the right shape), and every plain version a
width route could fall back to is replaced by a function that fails the
test.  So these tests show which kernel entry each width reaches (K1's
cluster plan, the chase entry, the tiled Stage I's design), that none
reaches a ``*_plain`` function, and that a failed launch raises.  The
kernels' numbers are the card's checks (``chip_smoke.phase_wide``, the
card tests).  The plans of the narrow instances (b <= 256, t <= 168) are
held to their earlier values: those widths keep their kernels and bits.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from svdsolver_tpu_torch import svd, svdvals
from svdsolver_tpu_torch.models.svd import bidiagonalize
from svdsolver_tpu_torch.models import svd as svd_mod
from svdsolver_tpu_torch.models import tiled, two_stage, vectors
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_wave, panel_qr, tiled_slab
from svdsolver_tpu_torch.utils.convert import from_numpy

WIDE = (192, 256, 384, 512)


# ---- the plans, by shape ----

@pytest.mark.parametrize("b,m,want", [
    # b <= 256: the plans of the narrow instance, as they were
    (128, 3840, (16, 240, 240, 264, 8, 9, 8, 149064)),
    (64, 1024, (4, 256, 256, 272, 16, 17, 16, 76168)),
    (256, 1024, (16, 64, 64, 68, 16, 17, 4, 103816)),
    (192, 1152, (16, 72, 72, 100, 12, 13, 4, 99496)),
    # past 256 the blocked panel: sub-panels of 64 rows, each a cluster of
    # about 128 columns a CTA (16 lanes a row, T in shared memory)
    (384, 2304, (64, 6, (16, 144, 144, 144, 4, 5, 16, 42952))),
    (512, 2048, (64, 8, (16, 128, 128, 144, 4, 5, 16, 42888))),
    (1024, 1024, (64, 16, (8, 128, 128, 144, 8, 9, 16, 41864))),
])
def test_cluster_plan_by_width(b, m, want):
    if b > panel_qr.NARROW_BAND:
        got = panel_qr.block_plan(b, m)
        assert (got.nb, got.panels, tuple(got.leaf)) == want
        assert got.nb * got.panels >= b and got.leaf == panel_qr.cluster_plan(
            got.nb, m, panel_qr.leaf_ctas(m))
        got = got.leaf
        b = panel_qr.BLOCK_NB
    else:
        got = panel_qr.cluster_plan(b, m)
        assert tuple(got) == want
    assert got.smem <= _build.MAX_SMEM
    assert got.ctas * got.width >= m and got.ctas * got.tcols >= b
    assert got.tld >= got.tcols  # T in shared memory
    assert got.groups == max(1, min(32, 1 << (1024 // b).bit_length() - 1))
    assert got.ld % 32 == got.groups % 32  # a warp's rows on distinct banks


@pytest.mark.parametrize("n", [192, 256, 384, 512, 1024, 2048, 4096, 8192])
def test_cluster_plan_takes_block_n(n):
    """Stage I with block = n: one (n, n) panel; up to 256 one cluster,
    halved while the exchanged dots would take more than half the shared
    memory; past it the blocked panel, every sub-panel a narrow cluster."""
    if n > panel_qr.NARROW_BAND:
        got = panel_qr.block_plan(n, n)
        assert got.nb * got.panels >= n and got.leaf.ctas == panel_qr.leaf_ctas(n)
        assert got.leaf.ctas * got.leaf.width >= n
        plan, n = got.leaf, got.nb
    else:
        plan = panel_qr.cluster_plan(n, n)
        assert plan.ctas * plan.width >= n
    assert plan.smem <= _build.MAX_SMEM
    assert 4 * plan.ctas * n <= _build.MAX_SMEM // 2 or plan.ctas == 1


@pytest.mark.parametrize("n,t,want", [
    (1024, 128, "sweeps"), (1024, 160, "slabs"), (960, 192, "wide"), (1024, 256, "wide"),
    (1536, 384, "wide"), (2048, 512, "wide"), (256, 256, "wide"), (238, 238, "slabs"),
    (640, 640, "wide"),
])
def test_tiled_route_takes_every_band(n, t, want):
    assert tiled_slab.tiled_route(n, t, 132) == want


@pytest.mark.parametrize("n,defer_left,want", [
    (40, False, 256), (256, False, 256), (1024, False, 1024), (10 ** 6, False,
                                                                band_chase_wave.WIDE_MAX_BAND),
    (1024, True, 256),
])
def test_chase_band_range(n, defer_left, want):
    assert band_chase_wave.band_range(n, defer_left) == want


# ---- the launches, patched out ----

@pytest.fixture
def launched(monkeypatch):
    """CPU tensors down the kernel paths of K1, the chases and the tiled
    Stage I; each launch logged as (kernel, width, detail) and given a
    stand-in output; every plain version of those routes fails the test."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    for mod in (panel_qr, band_chase, band_chase_wave, tiled_slab):
        monkeypatch.setattr(mod, "_build", OnCard())
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    for mod in (svd_mod, vectors):
        monkeypatch.setattr(mod, "use_kernels", lambda t: t.dtype == torch.float32)

    def k1(Pt, r_off, plan, out=None):
        calls.append(("panel_qr", Pt.shape[0], plan.groups))
        b, m = Pt.shape
        if out is None:
            return Pt.clone(), Pt.new_zeros((b, m)), Pt.new_zeros((b, b))
        out[0].copy_(Pt)
        out[1].zero_()
        out[2].zero_()
        return out

    def gemm(stream, M, N, K, a, b, c, alpha=1.0, beta=0.0, splits=1):
        calls.append(("panel_gemm", M, (N, K, splits)))

    def add(stream, parts, splits, count, out, split, out2):
        calls.append(("panel_sum", splits, count))

    def update(stream, ptrs, shape, plan, tma):
        calls.append(("panel_update", shape, plan))

    def merge(stream, G, Tt, r0, r1):
        calls.append(("panel_merge", r0, r1))

    def chase(A, b, K, record):
        calls.append(("band_chase_staged" if K else "band_chase", b, record))
        return _stand_in(A, b, record)

    def chase_cluster(A, b, plan, record):
        calls.append(("band_chase_cluster", b, record))
        assert plan == band_chase.wide_chase_plan(A.shape[0], b)
        return _stand_in(A, b, record)

    def wave(A, b, defer_left, ctas, record=False, tick="l2", smem=None):
        calls.append(("band_chase_wave", b, (record, tick)))
        return _stand_in(A, b, record)

    def wide_cluster(M, top, pc, t, m, V, tau, plan):
        calls.append(("tiled_wide_chain", t, (top, pc, m), plan, tuple(V.shape)))
        V.zero_()
        tau.zero_()

    def wide_dev(M, top, pc, t, m, V, tau):
        calls.append(("tiled_wide_chain_dev", t, (top, pc, m)))
        V.zero_()
        tau.zero_()

    def apply(M, top, pc, t, m, V, tau, plan):
        calls.append(("tiled_apply", t, (top, pc, m, plan.rpl, V.shape[2])))

    def wide_apply_cols(M, top, pc, t, m, V, tau):
        calls.append(("tiled_wide_apply_cols", t, (top, pc, m)))

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"the plain route {name} was taken")
        return fn

    monkeypatch.setattr(panel_qr, "_launch", k1)
    monkeypatch.setattr(panel_qr, "_launch_gemm", gemm)
    monkeypatch.setattr(panel_qr, "_launch_sum", add)
    monkeypatch.setattr(panel_qr, "_launch_update", update)
    monkeypatch.setattr(panel_qr, "_launch_merge", merge)
    monkeypatch.setattr(panel_qr, "_streams", lambda device: (StandIn(), StandIn()))
    monkeypatch.setattr(band_chase, "_launch", chase)
    monkeypatch.setattr(band_chase, "_launch_cluster", chase_cluster)
    monkeypatch.setattr(band_chase_wave, "_launch", wave)
    monkeypatch.setattr(tiled_slab, "_launch_wide_cluster", wide_cluster)
    monkeypatch.setattr(tiled_slab, "_launch_wide_dev", wide_dev)
    monkeypatch.setattr(tiled_slab, "_launch_apply", apply)
    monkeypatch.setattr(tiled_slab, "_launch_wide_apply_cols", wide_apply_cols)
    for mod, names in (
            (panel_qr, ("panel_qr_plain", "panel_qr_blocked_plain")),
            (band_chase, ("band_to_bidiagonal_plain", "band_to_bidiagonal_accum_plain")),
            (band_chase_wave, ("band_to_bidiagonal_wave_plain",
                               "band_to_bidiagonal_wave_accum_plain",
                               "band_to_bidiagonal_wave_dl_plain",
                               "band_to_bidiagonal_wave_tiles_plain")),
            (tiled, ("dense_to_band_tiled_plain", "_factor_slab", "chain_plain", "apply_plain")),
            (svd_mod, ("dense_to_band_tiled_plain", "band_to_bidiagonal", "dense_to_band")),
            (two_stage, ("dense_to_band_rec", "band_to_bidiagonal_accum", "dense_to_band_uv"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse(f"{mod.__name__}.{name}"))
    return calls


class StandIn:
    """A stream for the blocked panel's host loop on CPU tensors."""

    def wait_stream(self, other):
        pass


def _stand_in(A, b, record):
    """The chase's outputs for a logged launch: the band's diagonal and
    superdiagonal, and zero records."""
    d, e = torch.diagonal(A).clone(), torch.diagonal(A, 1).clone()
    if not record:
        return d, e
    n = A.shape[0]
    s_max = s_max_of(n, b)
    return (d, e, A.new_zeros((n - 1, s_max, b)), A.new_zeros((n - 1, s_max)),
            A.new_zeros((n - 1, s_max, b)), A.new_zeros((n - 1, s_max)))


def _blocked_k1(launched, b):
    """The launches of K1's blocked panels of width b: every sub-panel on
    the narrow kernel (BLOCK_NB rows, 16 lanes a row, T in shared memory),
    ceil(b / nb) a panel, and product launches between them: an update
    (svdt_panel_update) and a merge (svdt_panel_merge) at most after each,
    never the first design's product kernel.  Returns the number of
    panels."""
    nb = panel_qr.BLOCK_NB
    k1 = [c for c in launched if c[0] in ("panel_qr", "panel_update", "panel_merge")]
    leaves = [c for c in k1 if c[0] == "panel_qr"]
    per = -(-b // nb)
    assert leaves and all(c[1:] == (nb, 16) for c in leaves)
    assert len(leaves) % per == 0 and len(k1) > len(leaves)
    # a panel: its first launch a sub-panel; after each at most one update,
    # after each but the first at most one merge
    assert k1[0][0] == "panel_qr"
    panels = len(leaves) // per
    assert len(k1) - len(leaves) <= panels * (2 * per - 1)
    assert not [c for c in launched if c[0] in ("panel_gemm", "panel_sum")]
    return panels


def _uniform(n, seed=0):
    return from_numpy(np.random.default_rng(seed).uniform(0, 5, (n, n)).astype(np.float32))


@pytest.mark.parametrize("b", WIDE)
def test_tpu2_reaches_k1_and_the_chase_at_every_width(launched, b):
    n = 2 * b + 64  # pads to 3b: one wavefront lane at most
    svdvals(_uniform(n), method="tpu2", block=b)
    k1 = [c for c in launched if c[0] == "panel_qr"]
    chases = [c for c in launched if c[0].startswith("band_chase")]
    if b > panel_qr.NARROW_BAND:  # the blocked panel
        assert _blocked_k1(launched, b) > 0
    else:
        assert k1 and all(c[1] == b for c in k1)
        assert all(c[2] == max(1, 1 << (1024 // b).bit_length() - 1) for c in k1)
        assert not [c for c in launched
                    if c[0] in ("panel_gemm", "panel_sum", "panel_update", "panel_merge")]
    # more lanes wanted than the band has: the sequential chase, on the L2
    # kernel up to 256 (the copy engine does not take the band) and on the
    # cluster kernel past it
    want = "band_chase_cluster" if b > band_chase_wave.NARROW_BAND else "band_chase"
    assert chases == [(want, b, False)]


@pytest.mark.parametrize("b", [384, 512])
def test_tpu2_takes_the_wavefront_l2_tick_with_two_lanes(launched, b):
    # past b = 256 two lanes take the wavefront, now on its cluster tick
    # (wave_lanes_needed's wide table); the L2 tick only by its handle
    n = 5 * b  # nc_of(0) = 4 chase pairs: two lanes
    assert band_chase_wave.wave_chase_preferred(n, b)
    assert band_chase_wave.wave_lanes_needed(n, b) == 2
    bidiagonalize(_uniform(n), method="tpu2", block=b)
    assert [c for c in launched if c[0].startswith("band_chase")] == [
        ("band_chase_wave", b, (False, "cluster"))]


@pytest.mark.parametrize("t", [192, 256])
def test_multicore_reaches_the_wide_tiled_instance(launched, t):
    n = 4 * t
    svdvals(_uniform(n), method="multicore", block=t)
    chains = [c for c in launched if c[0] == "tiled_wide_chain"]
    applies = [c for c in launched if c[0] == "tiled_apply"]
    assert len(chains) == len(applies) == 2 * (n // t) - 1
    # the apply kernel's wide instance, on the chain's history of 32 rpl
    assert all(c[2][3:] == (16, 512) for c in applies)
    assert [c[2][:3] for c in applies] == [c[2] for c in chains]
    assert not [c for c in launched if c[0] == "tiled_wide_chain_dev"]
    assert not [c for c in launched if c[0] == "tiled_wide_apply_cols"]
    # the reference's order of half-sweeps: QR (c, c), then LQ (c + t, c)
    want = []
    for k in range(n // t):
        c = k * t
        want.append((c, c, n // t - k - 1))
        if k < n // t - 1:
            want.append((c + t, c, n // t - k - 2))
    assert [c[2] for c in chains] == want
    assert not [c for c in launched if c[0] == "panel_qr"]
    assert [c[0] for c in launched if c[0].startswith("band_chase")] == ["band_chase"]


@pytest.mark.parametrize("method", ["tpu2", "multicore"])
def test_block_n_reaches_the_kernels(launched, method):
    n = 320
    svdvals(_uniform(n), method=method, block=n)
    if method == "tpu2":
        assert _blocked_k1(launched, n) > 0
    else:
        assert any(c[0] == "tiled_wide_chain" and c[1] == n for c in launched)
    assert [c for c in launched if c[0].startswith("band_chase")] == [
        ("band_chase_cluster", n, False)]


@pytest.mark.parametrize("band", [384, 512])
def test_svd_reaches_the_recording_chase_at_wide_bands(launched, band):
    n = 2 * band + 64  # svd keeps band < n; pads to 3 band
    svd(_uniform(n), band=band)
    assert _blocked_k1(launched, band) > 0
    assert [c for c in launched if c[0].startswith("band_chase")] == [
        ("band_chase_cluster", band, True)]


@pytest.mark.parametrize("n,t,want", [
    (1024, 512, ("tiled_apply", 32)), (1536, 384, ("tiled_apply", 32)),
    (960, 192, ("tiled_apply", 16)), (1280, 640, ("tiled_wide_apply_cols", None)),
    (512, 512, (None, 32)), (1024, 1024, (None, None))])
def test_wide_tiled_route_takes_the_apply_kernel_up_to_512(launched, n, t, want):
    # up to t = 512 the apply kernel's wide instances (rpl 16, 32) on a
    # history of 32 rpl floats a reflector; past it the column apply on one
    # of 2t; block = n has no column outside the pivot block: no apply
    tiled_slab.dense_to_band_tiled(torch.zeros((n, n)), band=t)
    chains = [c for c in launched if c[0].startswith("tiled_wide_chain")]
    applies = [c for c in launched if c[0].startswith("tiled_")
               and not c[0].startswith("tiled_wide_chain")]
    # the cluster chain up to t = 512, the device-memory chain past it
    assert {c[0] for c in chains} == {"tiled_wide_chain" if t <= 512 else "tiled_wide_chain_dev"}
    assert len(chains) == 2 * (n // t) - 1
    assert len(applies) == (len(chains) if n > t else 0)
    assert {c[0] for c in applies} == ({want[0]} if n > t else set())
    if want[1] and n > t:
        assert {c[2][3:] for c in applies} == {(want[1], 32 * want[1])}
    assert tiled_slab.wide_vld(t) == (32 * want[1] if want[1] else 2 * t)


@pytest.mark.parametrize("t", WIDE)
def test_multicore_reaches_the_cluster_chain(launched, t):
    # blocks 192-512: every half-sweep's chain on the cluster kernel under
    # wide_chain_plan(t), with the device-memory kernel's (top, pc, m), then
    # its apply: 2 (2 n / t - 1) launches in all
    n = 3 * t
    svdvals(_uniform(n), method="multicore", block=t)
    chains = [c for c in launched if c[0] == "tiled_wide_chain"]
    applies = [c for c in launched if c[0] == "tiled_apply"]
    half = 2 * (n // t) - 1
    assert len(chains) == len(applies) == half
    assert len(chains) + len(applies) == 2 * (2 * n // t - 1)
    assert all(c[3] == tiled_slab.wide_chain_plan(t) for c in chains)
    assert [c[2] for c in chains] == [c[2][:3] for c in applies]
    assert [c[2] for c in chains] == [(0, 0, 2), (t, 0, 1), (t, t, 1), (2 * t, t, 0),
                                      (2 * t, 2 * t, 0)]
    assert not [c for c in launched if c[0] in ("tiled_wide_chain_dev",
                                                "tiled_wide_apply_cols")]


def test_block_n_past_512_reaches_the_device_memory_chain(launched):
    # block = n = 640: one half-sweep of one slab, past the cluster chain's
    # 512: the device-memory chain, and no apply (no column outside)
    svdvals(_uniform(640), method="multicore", block=640)
    kernels = [c for c in launched if c[0].startswith("tiled_")]
    assert kernels == [("tiled_wide_chain_dev", 640, (0, 0, 0))]


@pytest.mark.parametrize("n,t", [(960, 192), (1024, 256), (1536, 384), (1024, 512)])
def test_the_cluster_chain_hands_the_apply_its_history(launched, n, t):
    # the history the cluster chain fills is the one the apply reads, in
    # the apply's layout: (n / t) slabs x t reflectors of wide_vld(t) =
    # 32 rpl floats, rpl the apply kernel's (16 up to 256, 32 past it)
    tiled_slab.dense_to_band_tiled(torch.zeros((n, n)), band=t)
    chains = [c for c in launched if c[0] == "tiled_wide_chain"]
    applies = [c for c in launched if c[0] == "tiled_apply"]
    rpl = 16 if t <= 256 else 32
    assert {c[4] for c in chains} == {(n // t, t, 32 * rpl)}
    assert {c[2][3:] for c in applies} == {(rpl, 32 * rpl)}
    assert all(c[3].rpl * 32 >= 32 * rpl for c in chains)


def test_the_device_memory_chain_is_forced_by_its_handle(launched):
    # wide_chain(..., _device_block=True): the bitwise oracle of the card
    # checks; the route without it takes the cluster
    M = torch.zeros((768, 768))
    V, tau = tiled_slab.wide_chain(M, 384, 0, 192, _device_block=True)
    assert V.shape == (2, 192, tiled_slab.wide_vld(192)) and tau.shape == (2, 192)
    tiled_slab.wide_chain(M, 384, 0, 192)
    assert [c[0] for c in launched] == ["tiled_wide_chain_dev", "tiled_wide_chain"]
    assert launched[0][2] == launched[1][2] == (384, 0, 1)


def test_tiled_stage1_keeps_its_narrow_routes(launched, monkeypatch):
    # t <= 128: the chain and apply kernels; 128 < t <= 168: the first
    # design; both logged here in place of running
    logged = []
    monkeypatch.setattr(tiled_slab, "_launch_chain", lambda *a: logged.append("chain"))
    monkeypatch.setattr(tiled_slab, "_launch_apply", lambda *a: logged.append("apply"))
    monkeypatch.setattr(tiled_slab, "_launch", lambda *a: logged.append("slab"))
    tiled_slab.dense_to_band_tiled(torch.zeros((256, 256)), band=128)
    assert logged == ["chain", "apply"] * 3
    logged.clear()
    tiled_slab.dense_to_band_tiled(torch.zeros((320, 320)), band=160)
    assert logged == ["slab"] * 4
    assert not [c for c in launched if c[0].startswith("tiled_wide")]


def test_failed_wide_launches_raise(launched, monkeypatch):
    """A failed launch raises: no width falls back to a plain version."""
    def fail(name):
        def fn(*a, **k):
            _build.raise_on_error(2, name)
        return fn

    monkeypatch.setattr(panel_qr, "_launch", fail("panel_qr"))
    with pytest.raises(RuntimeError, match="panel_qr launch failed"):
        svdvals(_uniform(640), method="tpu2", block=320)
    monkeypatch.setattr(panel_qr, "_launch", lambda Pt, r_off, plan, out=None: out)
    monkeypatch.setattr(panel_qr, "_launch_update", fail("panel_update"))
    with pytest.raises(RuntimeError, match="panel_update launch failed"):
        svdvals(_uniform(640), method="tpu2", block=320)
    monkeypatch.setattr(panel_qr, "_launch_update", lambda *a: None)
    monkeypatch.setattr(panel_qr, "_launch_merge", fail("panel_merge"))
    with pytest.raises(RuntimeError, match="panel_merge launch failed"):
        svdvals(_uniform(640), method="tpu2", block=320)
    monkeypatch.setattr(tiled_slab, "_launch_wide_cluster", fail("tiled_wide_chain_cluster"))
    with pytest.raises(RuntimeError, match="tiled_wide_chain_cluster launch failed"):
        svdvals(_uniform(768), method="multicore", block=384)
    monkeypatch.setattr(tiled_slab, "_launch_wide_dev", fail("tiled_wide_chain"))
    with pytest.raises(RuntimeError, match="tiled_wide_chain launch failed"):
        svdvals(_uniform(640), method="multicore", block=640)
    monkeypatch.setattr(tiled_slab, "_launch_wide_chain", lambda *a: None)
    monkeypatch.setattr(tiled_slab, "_launch_apply", fail("tiled_apply"))
    with pytest.raises(RuntimeError, match="tiled_apply launch failed"):
        svdvals(_uniform(768), method="multicore", block=384)
    monkeypatch.setattr(band_chase, "_launch_cluster", fail("band_chase_cluster"))
    with pytest.raises(RuntimeError, match="band_chase_cluster launch failed"):
        band_chase.band_to_bidiagonal(torch.zeros((640, 640)), band=320)
    monkeypatch.setattr(band_chase, "_launch", fail("band_chase"))
    with pytest.raises(RuntimeError, match="band_chase launch failed"):
        band_chase.band_to_bidiagonal_l2(torch.zeros((640, 640)), band=320)
    monkeypatch.setattr(band_chase_wave, "_launch", fail("band_chase_wave"))
    with pytest.raises(RuntimeError, match="band_chase_wave launch failed"):
        band_chase_wave.band_to_bidiagonal_wave_accum(torch.zeros((640, 640)), band=300)


def test_widths_past_the_range_raise_before_any_launch(launched):
    with pytest.raises(ValueError, match="band=641"):
        band_chase.band_to_bidiagonal(torch.zeros((640, 640)), band=641)
    with pytest.raises(ValueError, match="band=257"):
        band_chase_wave.band_to_bidiagonal_wave_dl(torch.zeros((640, 640)), band=257)
    with pytest.raises(ValueError, match="limit"):
        panel_qr.cluster_plan(20000, 20000)
    with pytest.raises(ValueError, match="outside"):
        tiled_slab.tiled_route(100, 101, 132)
    assert launched == []


def test_l2_handles_force_the_l2_kernels(launched):
    # band_to_bidiagonal_l2 / _accum_l2 and _tick="l2" keep the L2 kernels
    # past b = 256 (the cluster kernels' bitwise oracles); the routes take
    # the cluster kernels there
    A = torch.zeros((640, 640))
    band_chase.band_to_bidiagonal_l2(A, band=320)
    band_chase.band_to_bidiagonal_accum_l2(A, band=320)
    band_chase_wave.band_to_bidiagonal_wave(A, band=320, _tick="l2")
    band_chase_wave.band_to_bidiagonal_wave_accum(A, band=320, _tick="l2")
    band_chase.band_to_bidiagonal(A, band=320)
    band_chase.band_to_bidiagonal_accum(A, band=320)
    band_chase_wave.band_to_bidiagonal_wave(A, band=320)
    band_chase_wave.band_to_bidiagonal_wave_accum(A, band=320)
    assert launched == [
        ("band_chase", 320, False), ("band_chase", 320, True),
        ("band_chase_wave", 320, (False, "l2")), ("band_chase_wave", 320, (True, "l2")),
        ("band_chase_cluster", 320, False), ("band_chase_cluster", 320, True),
        ("band_chase_wave", 320, (False, "cluster")), ("band_chase_wave", 320, (True, "cluster"))]
    # past the cluster plan's range (and at narrow bands) the routes keep the L2 kernels
    assert band_chase.wide_route(8200, band_chase.CLUSTER_MAX_BAND + 1) is None
    with pytest.raises(ValueError, match="cluster tick does not take"):
        band_chase_wave.band_to_bidiagonal_wave(A, band=200, _tick="cluster")


class _ClusterLib:
    """The cluster entries as the card's library answers them: ``fit``
    clusters resident, each launch returning ``err``."""

    def __init__(self, fit, err):
        self.fit, self.err, self.calls = fit, err, []

    def svdt_band_chase_cluster_fit(self, C, smem, wave, rec, out):
        ctypes.c_int.from_address(out).value = self.fit
        return 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return self.err
        return entry


@pytest.mark.parametrize("fit,err,raises", [
    (1, 0, None), (1, 719, RuntimeError), (0, 0, ValueError)])
def test_cluster_launches_check_residency_and_raise(monkeypatch, fit, err, raises):
    # the wrappers' own launch code on CPU tensors, the library stood in
    # for: a refused or failed launch raises, and a plan the card cannot
    # hold raises before any launch; nothing falls back to a plain version
    lib = _ClusterLib(fit, err)

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def load(name, entries):
            assert name == "band_chase_cluster" and "svdt_band_chase_cluster" in entries
            return lib

        @staticmethod
        def stream_of(t):
            return 0

    monkeypatch.setattr(band_chase, "_build", OnCard())
    monkeypatch.setattr(band_chase_wave, "_build", OnCard())
    monkeypatch.setattr(band_chase, "_resident", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    A = torch.zeros((640, 640))
    plan = band_chase.wide_chase_plan(640, 320)
    for launch in (lambda: band_chase._launch_cluster(A, 320, plan, False),
                   lambda: band_chase._launch_cluster(A, 320, plan, True),
                   lambda: band_chase_wave._launch_cluster(A, 320, None, False),
                   lambda: band_chase_wave._launch_cluster(A, 320, None, True)):
        if raises is None:
            launch()
        else:
            with pytest.raises(raises, match="launch failed" if err else "resident"):
                launch()
    want = ["svdt_band_chase_cluster", "svdt_band_chase_cluster_rec",
            "svdt_band_chase_wave_cluster", "svdt_band_chase_wave_cluster_rec"]
    assert lib.calls == ([] if fit == 0 else want)
