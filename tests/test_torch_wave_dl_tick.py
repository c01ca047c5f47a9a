"""The deferred-left wavefront chase's shared-memory tick on the CPU: its
schedule (which lane runs which slot, which tiles a slot copies, which tile
and reflector a lane keeps, which hand-offs go through the device ring, the
flush and "pending only" slots past n) as plain Python at small n and at the
index arithmetic of 3840/b128 and 7680/b128; the plain twin of its copies
held bit-equal to the sequential chase, to the plain deferred-left
wavefront and to the JAX package; and the wrapper's tick by shape."""

from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import band_to_bidiagonal_wavefront as jax_wavefront
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import (
    nc_of_static,
    wave_copy_bytes,
    wave_pairs,
    wave_ticks,
    wave_units,
)
from svdsolver_tpu_torch.ops.cuda import _build, band_chase_wave
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

SHAPES = [(40, 8), (70, 8), (100, 32), (97, 32), (130, 64), (64, 64), (33, 4)]
FULL = [(3840, 128), (7680, 128)]  # the main paths' widest chases


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


def _pairs(n, b, carry=True):
    return list(wave_pairs(n, b, carry=carry, defer_left=True))


def _boxes(p, b):
    """The (row, col, rows, cols) boxes a slot reads or writes: the head's
    (b + 1) x b window, or the tiles it loads and the one it carries in."""
    if p.s == 0:
        return [(p.r, p.c, b + 1, b)]
    tiles = set(p.loads) | ({(p.r, p.c - b)} if p.carry_in else set())
    return [(r, c, b, b) for r, c in sorted(tiles)]


def _meet(x, y):
    return (x[0] < y[0] + y[2] and y[0] < x[0] + x[2]
            and x[1] < y[1] + y[3] and y[1] < x[1] + x[3])


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_slot_runs_in_its_lane_while_it_has_pending_columns(n, b):
    # lane u runs slots 3u - 2 .. 3u of one sweep, and the flush slot nc + 1
    # is one more; a slot runs while its pending columns [c - b, c + b)
    # start below n, its corner at (i + 1 + (s - 1) b, i + 1 + s b)
    units = wave_units(n, b, defer_left=True)
    assert units == two_stage.wave_lanes(n, b, defer_left=True) + 1
    seen = set()
    for p in _pairs(n, b):
        assert 0 <= p.t < wave_ticks(n, b, defer_left=True) and 0 <= p.unit < units
        assert p.t == 3 * p.i + p.s
        if p.unit == 0:
            assert p.s == 0 and p.t % 3 == 0 and (p.r, p.c) == (p.i, p.i + 1)
        else:
            assert p.i == (p.t - 1) // 3 - p.unit + 1
            assert p.s == 3 * p.unit - 2 + (p.t - 1) % 3
            assert (p.r, p.c) == (p.i + 1 + (p.s - 1) * b, p.i + 1 + p.s * b)
            assert 1 <= p.s <= nc_of_static(p.i, n, b) + 1 and p.c - b < n
        assert (p.t, p.unit) not in seen  # one slot a unit a tick
        seen.add((p.t, p.unit))
    assert wave_ticks(n, b, defer_left=True) == wave_ticks(n, b) + 1


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_windows_of_a_tick_are_disjoint(n, b):
    by_tick = defaultdict(list)
    for p in _pairs(n, b):
        by_tick[p.t].append(p)
    for t, ps in by_tick.items():
        boxes = [(p.unit, x) for p in ps for x in _boxes(p, b)]
        for k, (u, x) in enumerate(boxes):
            for v, y in boxes[k + 1:]:
                assert u == v or not _meet(x, y), (t, u, v)


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_carried_tile_lies_in_no_other_window(n, b):
    # a slot that carries out keeps (r + b, c): the lane's next slot takes it
    # as its (r, c - b) tile (its pending region's left half) without loading
    # it, and no other unit touches it at either tick
    by_tick = defaultdict(list)
    pairs = _pairs(n, b)
    for p in pairs:
        by_tick[p.t].append(p)
    carried = 0
    for p in pairs:
        if not p.carry_out:
            continue
        carried += 1
        tile = (p.r + b, p.c, b, b)
        assert p.c < n and p.s % 3 != 0 and (p.r + b, p.c) not in p.stores
        nxt = [q for q in by_tick[p.t + 1] if q.unit == p.unit]
        assert len(nxt) == 1 and nxt[0].carry_in
        assert (nxt[0].i, nxt[0].s, nxt[0].r, nxt[0].c - b) == (p.i, p.s + 1, p.r + b, p.c)
        assert (nxt[0].r, nxt[0].c - b) not in nxt[0].loads
        assert (nxt[0].r, nxt[0].c - b) in nxt[0].stores
        for q in by_tick[p.t] + by_tick[p.t + 1]:
            if q.unit != p.unit:
                assert not any(_meet(tile, x) for x in _boxes(q, b)), (p, q)
    assert carried == sum(p.carry_in for p in pairs)
    assert carried > 0 or n <= b + 1  # sweep 0's slot 1 makes a reflector past n = b + 1


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_ring_hand_offs(n, b):
    # with a CTA a unit, a pending reflector crosses the device ring only
    # from the head (slot 0 to 1) and from lane u's last slot 3u to lane
    # u + 1's first, 3u + 1; striding lanes hand every one over there
    pairs = _pairs(n, b)
    slots = {(p.i, p.s) for p in pairs}
    for p in pairs:
        if p.s >= 1 and not p.carry_in:  # reads the ring
            assert p.s % 3 == 1 and (p.i, p.s - 1) in slots
        if not p.carry_out and (p.i, p.s + 1) in slots:  # writes the ring for its next slot
            assert p.s % 3 == 0
    for p in _pairs(n, b, carry=False):
        assert not p.carry_in and not p.carry_out


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_each_sweep_ends_with_a_pending_only_slot(n, b):
    # a slot whose corner column is past n applies its pending reflector
    # alone: it copies only its (r, c - b) tile and makes no reflector; every
    # sweep's last slot is one, often the flush slot nc + 1
    last, flush = {}, 0
    for p in _pairs(n, b):
        if p.s == 0:
            assert p.loads == p.stores == ((p.i, p.i + 1),)
            continue
        last[p.i] = p
        window = {(r, c) for r, c, _, _ in _boxes(p, b)}
        if p.c >= n:
            assert window == {(p.r, p.c - b)} and not p.carry_out
            assert p.stores == ((p.r, p.c - b),) and len(p.loads) == (0 if p.carry_in else 1)
        else:
            assert window == {(p.r, p.c - b), (p.r, p.c), (p.r + b, p.c)}
        flush += p.s == nc_of_static(p.i, n, b) + 1
    assert sorted(last) == list(range(n - 1))
    for i, p in last.items():
        assert p.c >= n and p.s <= nc_of_static(i, n, b) + 1
    assert flush > 0 or n <= b + 1  # else every slot 1 is past n already


@pytest.mark.parametrize("n,b", [(1000, 128), (97, 32), (3840, 128)])
def test_boxes_past_n(n, b):
    # ragged and padded windows: boxes reaching past n exist (their copies
    # read zero and drop their writes there, as the twin's _box_in/_box_out)
    past = sum(r + h > n or c + w > n for p in _pairs(n, b) for r, c, h, w in _boxes(p, b))
    assert past > 0


def test_copy_bytes_of_the_schedule_bound():
    # the critical path's copy bytes (chip_smoke.py: over one CTA's copy
    # rate), recounted here from the slots' boxes
    for n, b in ((40, 8), (97, 32), (130, 64)):
        for defer_left in (False, True):
            most = defaultdict(int)
            for p in wave_pairs(n, b, defer_left=defer_left):
                row = (8 if defer_left else 16) * b if p.s == 0 else 0
                most[p.t] = max(most[p.t], 4 * b * (b + 4) * (len(p.loads) + len(p.stores)) + row)
            assert wave_copy_bytes(n, b, defer_left=defer_left) == sum(most.values())
    assert wave_copy_bytes(3840, 128) == 3_667_691_520
    assert wave_copy_bytes(3840, 128, defer_left=True) == 3_468_398_592
    assert wave_copy_bytes(1024, 64, defer_left=True) == 228_247_552


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", SHAPES + [(2, 1), (5, 4)])
def test_tile_twin_bit_equal(rng, dtype, n, b, carry):
    Ab = _band(rng, n, b, dtype)
    got = two_stage.band_to_bidiagonal_wavefront_tiles(Ab, band=b, carry=carry, defer_left=True)
    for want in (two_stage.band_to_bidiagonal(Ab, band=b),
                 two_stage.band_to_bidiagonal_wavefront(Ab, band=b, defer_left=True)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_numpy(g), to_numpy(w))


def test_tile_twin_matches_jax_float64(rng):
    n, b = 48, 8
    Ab = to_numpy(_band(rng, n, b, torch.float64))
    with jax.disable_jit():  # op by op: no fused FMAs (see test_torch_chase_variants)
        dj, ej = jax_wavefront(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_wavefront_tiles(from_numpy(Ab, dtype=torch.float64),
                                                        band=b, defer_left=True)
    np.testing.assert_allclose(to_numpy(d), np.asarray(dj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(to_numpy(e), np.asarray(ej), rtol=1e-12, atol=1e-13)


def test_tile_twin_refuses_records():
    with pytest.raises(ValueError, match="defer_left"):
        two_stage.band_to_bidiagonal_wavefront_tiles(torch.zeros(8, 8), band=4, record=True,
                                                     defer_left=True)


@pytest.fixture
def launched(monkeypatch):
    """Send CPU tensors down the deferred-left wrapper's kernel path and log
    each launch as (tick, CTAs) in place of running it."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    def launch(A, b, defer_left, ctas, record=False, tick="l2", smem=None):
        assert defer_left and not record
        calls.append((tick, ctas))
        return A.new_zeros(A.shape[0]), A.new_zeros(A.shape[0] - 1)

    monkeypatch.setattr(band_chase_wave, "_build", OnCard())
    monkeypatch.setattr(band_chase_wave, "_launch", launch)
    band_chase_wave.launches_dl = band_chase_wave.launches_dl_l2 = 0
    return calls


@pytest.mark.parametrize("n,b,want", [
    (3840, 128, "smem"), (1024, 64, "smem"), (2048, 32, "smem"), (256, 32, "smem"),
    (640, 160, "l2"),  # past the shared-memory tick's 128
    (1002, 64, "l2"),  # rows of n % 4 != 0 floats
    (256, 18, "l2"),  # a band the copy engine does not take
    (97, 32, "l2"),
])
def test_wrapper_takes_its_tick_by_shape(launched, n, b, want):
    band_chase_wave.band_to_bidiagonal_wave_dl(torch.zeros(n, n), band=b)
    assert launched == [(want, None)]
    assert (band_chase_wave.launches_dl, band_chase_wave.launches_dl_l2) == \
        ((1, 0) if want == "smem" else (0, 1))


def test_wrapper_forced_tick_and_failed_launch(launched, monkeypatch):
    A = torch.zeros(256, 256)
    band_chase_wave.band_to_bidiagonal_wave_dl(A, band=32, _tick="l2", _ctas=4)
    assert launched == [("l2", 4)]
    with pytest.raises(ValueError, match="does not take"):
        band_chase_wave.band_to_bidiagonal_wave_dl(torch.zeros(90, 90), band=16, _tick="smem")

    def refused(*args, **kwargs):
        raise RuntimeError("band_chase_wave_dl_smem failed")

    # a failed launch raises, counts nothing and takes no other tick
    monkeypatch.setattr(band_chase_wave, "_launch", refused)
    with pytest.raises(RuntimeError, match="dl_smem"):
        band_chase_wave.band_to_bidiagonal_wave_dl(A, band=32)
    assert (band_chase_wave.launches_dl, band_chase_wave.launches_dl_l2) == (0, 1)


def test_wrapper_on_cpu_takes_the_twin_of_its_tick(rng, monkeypatch):
    # a CPU tensor runs the plain version of the tick the card would take:
    # the tile twin (carry off when _ctas leaves lanes striding), or the
    # plain deferred-left wavefront where the shared-memory tick cannot run
    calls = []
    twin = two_stage.band_to_bidiagonal_wavefront_tiles
    wave = two_stage.band_to_bidiagonal_wavefront
    monkeypatch.setattr(two_stage, "band_to_bidiagonal_wavefront_tiles",
                        lambda *a, **k: calls.append(("tiles", k["carry"], k["defer_left"]))
                        or twin(*a, **k))
    monkeypatch.setattr(two_stage, "band_to_bidiagonal_wavefront",
                        lambda *a, **k: calls.append(("l2", None, k["defer_left"])) or wave(*a, **k))
    Ab = _band(rng, 96, 16)
    want = two_stage.band_to_bidiagonal(Ab, band=16)
    for kwargs in ({}, {"_ctas": 2}, {"_tick": "l2"}):
        got = band_chase_wave.band_to_bidiagonal_wave_dl(Ab, band=16, **kwargs)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kwargs
    got = band_chase_wave.band_to_bidiagonal_wave_dl(_band(rng, 90, 16), band=16)
    assert calls == [("tiles", True, True), ("tiles", False, True), ("l2", None, True),
                     ("l2", None, True)]
