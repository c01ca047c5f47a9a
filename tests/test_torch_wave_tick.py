"""The wavefront chase's shared-memory tick on the CPU: its schedule (which
lane runs which pairs, which tile a lane carries, which boxes reach past n)
as plain Python at small n and at the index arithmetic of 3840/b128 and
7680/b128, and the plain twin of its copies (tiles in, the pair on the
tiles, only the tiles the kernel writes back going back), held bit-equal
to the sequential chase and to the JAX package."""

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
    wave_pairs,
    wave_ticks,
    wave_units,
)
from svdsolver_tpu_torch.ops.cuda import band_chase_wave
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

SHAPES = [(40, 8), (70, 8), (100, 32), (97, 32), (130, 64), (64, 64), (33, 4)]
FULL = [(3840, 128), (7680, 128)]  # the main paths' widest chases


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


def _boxes(p, b):
    """The (row, col, rows, cols) boxes of a pair's window."""
    if p.s == 0:
        return [(p.r, p.c, b + 1, 2 * b)]
    return [(r, c, b, b) for r, c in ((p.r, p.c), (p.r + b, p.c), (p.r + b, p.c + b))]


def _meet(x, y):
    return (x[0] < y[0] + y[2] and y[0] < x[0] + x[2]
            and x[1] < y[1] + y[3] and y[1] < x[1] + x[3])


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_lane_runs_three_slots_of_one_sweep(n, b):
    # lane u runs slots 3u - 2, 3u - 1, 3u of sweep q - u + 1 at ticks
    # 3q + 1, 3q + 2, 3q + 3; the head (unit 0) slot 0 at ticks 3i
    units = wave_units(n, b)
    seen = set()
    for p in wave_pairs(n, b):
        assert 0 <= p.t < wave_ticks(n, b) and 0 <= p.unit < units
        assert p.t == 3 * p.i + p.s
        if p.unit == 0:
            assert p.s == 0 and p.t % 3 == 0
        else:
            q = (p.t - 1) // 3
            assert p.i == q - p.unit + 1
            assert p.s == 3 * p.unit - 2 + (p.t - 1) % 3
        assert 0 <= p.s <= nc_of_static(p.i, n, b) and p.c < n
        assert (p.t, p.unit) not in seen  # one pair a unit a tick
        seen.add((p.t, p.unit))


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_carried_tile_lies_in_no_other_window(n, b):
    by_tick = defaultdict(list)
    pairs = list(wave_pairs(n, b))
    for p in pairs:
        by_tick[p.t].append(p)
    carried = 0
    for p in pairs:
        if not p.carry_out:
            continue
        carried += 1
        tile = (p.r + b, p.c + b, b, b)
        nxt = [q for q in by_tick[p.t + 1] if q.unit == p.unit]
        # the lane's next pair takes it in, as its (r, c) tile
        assert len(nxt) == 1 and nxt[0].carry_in
        assert (nxt[0].i, nxt[0].s, nxt[0].r, nxt[0].c) == (p.i, p.s + 1, p.r + b, p.c + b)
        assert (nxt[0].r, nxt[0].c) not in nxt[0].loads
        for q in by_tick[p.t] + by_tick[p.t + 1]:
            if q.unit != p.unit:
                assert not any(_meet(tile, x) for x in _boxes(q, b)), (p, q)
    assert carried == sum(p.carry_in for p in pairs)
    assert carried > 0 or nc_of_static(0, n, b) < 2


@pytest.mark.parametrize("n,b", SHAPES + FULL)
def test_windows_of_a_tick_are_disjoint(n, b):
    by_tick = defaultdict(list)
    for p in wave_pairs(n, b):
        by_tick[p.t].append(p)
    for t, ps in by_tick.items():
        boxes = [(p.unit, x) for p in ps for x in _boxes(p, b)]
        for k, (u, x) in enumerate(boxes):
            for v, y in boxes[k + 1:]:
                assert u == v or not _meet(x, y), (t, u, v)


def test_copies_without_carry_move_whole_windows():
    for p in wave_pairs(130, 16, carry=False):
        assert not p.carry_in and not p.carry_out
        assert len(p.loads) == len(p.stores) == (2 if p.s == 0 else 3)


@pytest.mark.parametrize("n,b", [(1000, 128), (97, 32), (3840, 128)])
def test_boxes_past_n_read_zero_and_drop_writes(n, b):
    # ragged and padded windows: boxes reaching past n exist, and the copies the twin makes of them read
    # zeros there and write nothing back there, as chase_pair's masks do
    past = sum(r + h > n or c + w > n for p in wave_pairs(n, b) for r, c, h, w in _boxes(p, b))
    assert past > 0
    M = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    box = two_stage._box_in(M, n - 3, n - 5, b, b)
    assert torch.equal(box[:3, :5], M[n - 3 :, n - 5 :])
    assert not box[3:].any() and not box[:, 5:].any()
    before = M.clone()
    two_stage._box_out(M, torch.full((b, b), -1.0), n - 3, n - 5)
    assert bool((M[n - 3 :, n - 5 :] == -1).all())
    M[n - 3 :, n - 5 :] = before[n - 3 :, n - 5 :]
    assert torch.equal(M, before)
    assert not two_stage._box_in(M, n, n + 3, b, b).any()


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", SHAPES + [(2, 1)])
def test_tile_twin_bit_equal_to_sequential_chase(rng, dtype, n, b, carry):
    Ab = _band(rng, n, b, dtype)
    got = two_stage.band_to_bidiagonal_wavefront_tiles(Ab, band=b, carry=carry)
    want = two_stage.band_to_bidiagonal(Ab, band=b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), to_numpy(w))


@pytest.mark.parametrize("n,b", [(40, 8), (97, 32), (130, 64)])
def test_recording_tile_twin_bit_equal(rng, n, b):
    Ab = _band(rng, n, b)
    got = two_stage.band_to_bidiagonal_wavefront_tiles(Ab, band=b, record=True)
    want = two_stage.band_to_bidiagonal_accum(Ab, band=b)
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        np.testing.assert_array_equal(to_numpy(g), to_numpy(w), err_msg=name)


def test_tile_twin_matches_jax_float64(rng):
    n, b = 48, 8
    Ab = to_numpy(_band(rng, n, b, torch.float64))
    with jax.disable_jit():  # op by op: no fused FMAs (see test_torch_chase_variants)
        dj, ej = jax_wavefront(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_wavefront_tiles(from_numpy(Ab, dtype=torch.float64),
                                                        band=b)
    np.testing.assert_allclose(to_numpy(d), np.asarray(dj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(to_numpy(e), np.asarray(ej), rtol=1e-12, atol=1e-13)


def test_smem_tick_takes():
    A = torch.zeros(64, 64)
    assert band_chase_wave.smem_tick_takes(A, 16)
    assert band_chase_wave.smem_tick_takes(A, 128)
    assert not band_chase_wave.smem_tick_takes(A, 160)  # past three tiles
    assert not band_chase_wave.smem_tick_takes(A, 18)  # rows of 72 bytes
    assert not band_chase_wave.smem_tick_takes(torch.zeros(66, 66), 16)
    assert not band_chase_wave.smem_tick_takes(A, 2)


@pytest.mark.parametrize("record", [False, True])
def test_wrapper_on_cpu_takes_the_twin_of_its_tick(rng, monkeypatch, record):
    # a CPU tensor runs the plain version of the tick the card would take:
    # the tile twin (carry off when _ctas leaves lanes striding), or the
    # L2 tick's plain wavefront where the shared-memory tick cannot run
    calls = []
    twin = two_stage.band_to_bidiagonal_wavefront_tiles
    wave = two_stage.band_to_bidiagonal_wavefront
    monkeypatch.setattr(two_stage, "band_to_bidiagonal_wavefront_tiles",
                        lambda *a, **k: calls.append(("tiles", k["carry"])) or twin(*a, **k))
    monkeypatch.setattr(two_stage, "band_to_bidiagonal_wavefront",
                        lambda *a, **k: calls.append(("l2", None)) or wave(*a, **k))
    fn = (band_chase_wave.band_to_bidiagonal_wave_accum if record
          else band_chase_wave.band_to_bidiagonal_wave)
    Ab = _band(rng, 96, 16)
    want = (two_stage.band_to_bidiagonal_accum if record else two_stage.band_to_bidiagonal)(Ab, band=16)
    for kwargs in ({}, {"_ctas": 2}, {"_tick": "l2"}):
        got = fn(Ab, band=16, **kwargs)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kwargs
    assert calls == [("tiles", True), ("tiles", False), ("l2", None)]
    with pytest.raises(ValueError, match="does not take"):
        fn(_band(rng, 90, 16), band=16, _tick="smem")
    with pytest.raises(ValueError, match="_tick"):
        fn(Ab, band=16, _tick="fast")
