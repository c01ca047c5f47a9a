"""The staged chase kernel's TMA design on the CPU: its copy schedule
(``chase_schedule.staged_copies``: which slot holds which tile, where each
load and store is issued and waited on) checked for hazards at small n and
at the index arithmetic of 3840/b128 and 1024/b64, and the plain twin of its
copies (``two_stage.band_to_bidiagonal_staged_tiles``) held bit-equal to
the sequential chase and to the JAX package; the lookahead that fits shared
memory, the route by shape (``band_chase.staged_route``) and the kernel
each entry and flag launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import band_to_bidiagonal as jax_band_to_bidiagonal
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import (nc_of_static, staged_copies,
                                                    staged_copy_bytes, staged_pairs)
from svdsolver_tpu_torch.ops.cuda import _build, band_chase
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

SHAPES = [(40, 8), (70, 8), (100, 32), (97, 32), (130, 64), (64, 64), (33, 4)]
FULL = [(3840, 128, 1), (1024, 64, 5)]  # the slice's staged shapes, largest K


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


def _region(op, n, b):
    """The entries of the matrix a copy touches (a box of op.rows rows of
    b + 4 columns), clipped to n: (row0, row1, col0, col1), or None when it
    lies wholly past n."""
    r1, c1 = min(op.r + op.rows, n), min(op.c + b + 4, n)
    return (op.r, r1, op.c, c1) if op.r < r1 and op.c < c1 else None


def _meet(x, y):
    return x[0] < y[1] and y[0] < x[1] and x[2] < y[3] and y[2] < x[3]


def _check_schedule(n, b, K):
    """Walk the schedule as the card runs it; return the counts of loads,
    stores and chase pairs.  Raises AssertionError on a hazard."""
    NS = 2 * K + 1
    inflight = []  # stores not yet written: (region, slot, pair, read)
    holds = {}  # slot -> (row, col, rows) of the box it holds
    unread = set()  # slots whose last load no step has read yet
    loads = stores = pairs = 0

    def has(slot, r, c):  # the slot's box holds the b x b tile at (r, c)
        br, bc, rows = holds[slot]
        return bc == c and br <= r and r + b <= br + rows

    for op in staged_copies(n, b, K):
        if op.kind in ("load", "store"):
            assert op.rows in (b, b + 1) and op.c % 4 == 0 and 0 <= op.slot < NS, op
            reg = _region(op, n, b)
        if op.kind == "load":
            loads += 1
            if reg is not None:  # no load reads what a store in flight writes
                assert not any(_meet(reg, s[0]) for s in inflight if s[0]), op
            # no slot is refilled before its store has read it, or before
            # its previous load was used
            assert not any(s[1] == op.slot and not s[3] for s in inflight), op
            assert op.slot not in unread, op
            holds[op.slot] = (op.r, op.c, op.rows)
            unread.add(op.slot)
        elif op.kind == "store":
            stores += 1
            assert holds.get(op.slot) == (op.r, op.c, op.rows), op  # the box it stores
            assert op.slot not in unread, op
            if reg is not None:
                # two stores in flight share entries only within one pair,
                # whose boxes share_overlap has made agree
                assert not any(_meet(reg, s[0]) and s[2] != op.pair
                               for s in inflight if s[0]), op
            inflight.append((reg, op.slot, op.pair, False))
        elif op.kind == "wait_read":
            inflight = [(s[0], s[1], s[2], True) for s in inflight]
        elif op.kind == "wait_all":
            inflight = []
        elif op.kind == "head":
            i, a = op.r, (op.r + 1) & ~3
            h0, h1 = op.slots
            assert holds[h0] == (i, a, b + 1) and holds[h1] == (i, a + b, b + 1), op
            unread -= {h0, h1}
        elif op.kind in ("right", "left"):  # the slots hold the pair's tiles
            sA, sB, sC = op.slots
            a = op.c & ~3
            assert has(sB, op.r + b, a), op
            if op.kind == "right":
                pairs += 1
                assert has(sA, op.r, a), op
                unread -= {sA, sB}
            else:
                assert has(sC, op.r + b, a + b), op
                unread.discard(sC)
    assert not inflight and not unread
    return loads, stores, pairs


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("K", [1, 2, 5])
def test_schedule_has_no_hazard_small(n, b, K):
    loads, stores, pairs = _check_schedule(n, b, K)
    nks = [staged_pairs(i, n, b) for i in range(n - 1)]
    assert pairs == sum(nks)
    # a head: 2 boxes in and out (the second out as pair 0's A); a sweep's
    # pairs: B and C in, B out each, A out from pair 1 on, C out at the last
    assert loads == 2 * (n - 1) + 2 * pairs
    assert stores == 2 * (n - 1) + 2 * pairs


@pytest.mark.parametrize("n,b,K", FULL)
def test_schedule_has_no_hazard_full(n, b, K):
    loads, stores, pairs = _check_schedule(n, b, K)
    assert pairs == sum(staged_pairs(i, n, b) for i in range(n - 1))
    assert loads == stores


@pytest.mark.parametrize("n,b,K", [(n, b, K) for n, b in SHAPES for K in (1, 3)] + FULL)
def test_copy_bytes_are_the_schedules(n, b, K):
    # a sweep moves its head's two boxes of b + 1 rows and each pair's B and
    # C (b rows) in, and as many rows out (pair 0's A is the head's second
    # box): nothing else, and the same at every lookahead
    P = sum(staged_pairs(i, n, b) for i in range(n - 1))
    want = 2 * 4 * (b + 4) * (2 * (b + 1) * (n - 1) + 2 * b * P)
    assert staged_copy_bytes(n, b, K) == want
    if K > 1:
        assert staged_copy_bytes(n, b, 1) == want


def test_copy_bytes_at_the_slice_shapes():
    # the schedule bound's bytes (chip_smoke.py: over one CTA's copy rate)
    assert staged_copy_bytes(3840, 128) == 16_090_396_608
    assert staged_copy_bytes(1024, 64) == 606_075_840


@pytest.mark.parametrize("n,b", [(3840, 128), (1024, 64), (40, 8), (97, 32)])
def test_staged_pairs_are_the_pairs_with_work(n, b):
    for i in range(n - 1):
        nk = staged_pairs(i, n, b)
        assert 0 <= nk <= nc_of_static(i, n, b)
        work = [k for k in range(nc_of_static(i, n, b)) if i + 1 + (k + 1) * b < n]
        assert work == list(range(nk))


@pytest.mark.parametrize("n,b", SHAPES)
def test_twin_bit_equal_to_sequential_chase(rng, n, b):
    A = _band(rng, n, b)
    want = two_stage.band_to_bidiagonal(A, band=b)
    for K in (1, band_chase.staged_khops(b, 99)):
        got = two_stage.band_to_bidiagonal_staged_tiles(A, band=b, khops=K)
        for g, w in zip(got, want):
            assert torch.equal(g, w), K


def test_twin_small_n():
    A = torch.tensor([[3.0]])
    d, e = two_stage.band_to_bidiagonal_staged_tiles(A, band=4)
    assert d.tolist() == [3.0] and e.numel() == 0
    A = torch.tensor([[1.0, 2.0], [0.0, 3.0]])
    got = two_stage.band_to_bidiagonal_staged_tiles(A, band=4)
    for g, w in zip(got, two_stage.band_to_bidiagonal(A, band=4)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,b", [(40, 8), (97, 32)])
def test_twin_matches_jax_float64(rng, n, b):
    Ab = to_numpy(_band(rng, n, b, torch.float64))
    # op by op, as the JAX package's own chase runs its steps (jitted,
    # XLA:CPU fuses the rank-1 updates into FMAs)
    with jax.disable_jit():
        dj, ej = jax_band_to_bidiagonal(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_staged_tiles(from_numpy(Ab, dtype=torch.float64),
                                                     band=b, khops=2)
    np.testing.assert_allclose(to_numpy(d), np.asarray(dj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(to_numpy(e), np.asarray(ej), rtol=1e-12, atol=1e-13)


def test_staged_khops_from_the_slot_size():
    # 2K + 1 slots of (b + 1) x (b + 4) floats (rounded to 128 bytes) beside
    # the static arrays in 227 KB: 3 slots at b = 128, 12 at b = 64
    assert band_chase.staged_slot_floats(128) == 17056
    assert band_chase.staged_slot_floats(64) == 4448
    assert band_chase.staged_khops(128, 4) == 1
    assert band_chase.staged_khops(64, 99) == 5
    assert band_chase.staged_khops(96, 99) == 2
    assert band_chase.staged_khops(32, 99) == 15  # the 31 mbarriers
    assert band_chase.staged_khops(64, 3) == 3
    for b in range(1, 129):
        K = band_chase.staged_khops(b, 99)
        assert K >= 1
        need = 4 * (2 * K + 1) * band_chase.staged_slot_floats(b) + 128
        assert need + band_chase.STAGED_STATIC_SMEM <= band_chase._build.MAX_SMEM
        assert 2 * K + 1 <= band_chase.STAGED_MAX_SLOTS


# (n, band, khops) -> the lookahead the route takes: the TMA design's K
# where the copy engine takes the shape, 0 (the L2 kernel) where not
ROUTES = [
    (3840, 128, 1, 1), (3840, 128, 4, 1), (1024, 64, 1, 1), (1024, 64, 5, 5),
    (1024, 64, 99, 5), (256, 64, 1, 1), (384, 64, 1, 1), (224, 32, 1, 1), (200, 8, 1, 1),
    (201, 8, 1, 0),  # n not a multiple of 4
    (150, 6, 1, 0), (200, 6, 1, 0),  # b not a multiple of 4
    (130, 128, 1, 0), (512, 132, 1, 0), (640, 160, 1, 0),  # n or b past the copy engine's
    (64, 2, 1, 0), (200, 2, 1, 0),  # b below 4
]


@pytest.mark.parametrize("n,b,khops,K", ROUTES)
def test_staged_route_by_shape(n, b, khops, K):
    A = torch.zeros((n, n))
    assert band_chase.staged_tma_takes(A, b) == (K > 0)
    assert band_chase.staged_route(A, b, khops) == K


def test_staged_route_misaligned():
    # a view one float into its storage: A's address is not 16-byte aligned
    A = torch.zeros(200 * 200 + 1)[1:].view(200, 200)
    assert band_chase.staged_route(A, 8) == 0
    assert band_chase.staged_route(torch.zeros((200, 200)), 8) == 1
    with pytest.raises(ValueError, match="khops"):
        band_chase.staged_route(A, 8, khops=0)


@pytest.fixture
def launched(monkeypatch):
    """Send CPU tensors down the wrappers' kernel path and log each launch
    as (kernel, lookahead, record) in place of running it."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    def launch(A, b, K, record):
        calls.append(("staged" if K else "l2", K, record))

    monkeypatch.setattr(band_chase, "_build", OnCard())
    monkeypatch.setattr(band_chase, "_launch", launch)
    return calls


ENTRIES = {
    "plain": band_chase.band_to_bidiagonal,
    "accum": band_chase.band_to_bidiagonal_accum,
    "l2": band_chase.band_to_bidiagonal_l2,
    "accum_l2": band_chase.band_to_bidiagonal_accum_l2,
}
TMA, TMA_REC, L2, L2_REC = ("staged", 1, False), ("staged", 1, True), ("l2", 0, False), \
    ("l2", 0, True)


@pytest.mark.parametrize("n,b,entry,flags,want", [
    (200, 8, "plain", {"pipelined": True}, TMA),
    (1024, 64, "plain", {"mega": True, "khops": 3}, ("staged", 3, False)),
    (1024, 64, "plain", {"mega": True, "khops": 99}, ("staged", 5, False)),  # the widest
    (1024, 64, "plain", {"mega": True, "pipelined": True, "khops": 99}, TMA),
    (3840, 128, "plain", {"mega": True, "khops": 4}, TMA),
    (201, 8, "plain", {"pipelined": True}, L2),  # n not a multiple of 4
    (200, 6, "plain", {"mega": True, "khops": 3}, L2),  # b not a multiple of 4
    (512, 132, "plain", {"pipelined": True}, L2),  # above the staged kernel's 128
    (200, 8, "plain", {}, TMA),  # no flag: the sequential chase, on the TMA design
    (200, 8, "plain", {"mega": True, "khops": 1}, TMA),  # mega with one pair ahead
    (256, 64, "plain", {}, TMA),  # the main paths' one-lane band
    (3840, 128, "plain", {}, TMA),
    (640, 160, "plain", {}, L2),  # a band the TMA design does not take
    (64, 2, "plain", {}, L2),
    # the recording entry: the TMA design one pair ahead where it takes the
    # shape, the L2 kernel's recording entry elsewhere
    (3840, 128, "accum", {}, TMA_REC), (1024, 64, "accum", {}, TMA_REC),
    (256, 64, "accum", {}, TMA_REC), (224, 32, "accum", {}, TMA_REC),
    (201, 8, "accum", {}, L2_REC), (150, 6, "accum", {}, L2_REC),
    (130, 128, "accum", {}, L2_REC), (640, 160, "accum", {}, L2_REC),
    # the oracle entries: the L2 kernel at every shape
    (3840, 128, "l2", {}, L2), (201, 8, "l2", {}, L2),
    (1024, 64, "accum_l2", {}, L2_REC), (150, 6, "accum_l2", {}, L2_REC),
])
def test_staged_design_by_shape(launched, n, b, entry, flags, want):
    # the kernel and lookahead an entry with its flags launches for A's
    # shape, decided before launch
    ENTRIES[entry](torch.zeros((n, n)), band=b, **flags)
    assert launched == [want]


def test_staged_design_argument(rng):
    # khops below 1 is refused on every route; on the CPU every entry and
    # flag runs the plain sequential chase
    A = _band(rng, 40, 8)
    for flags in ({}, {"pipelined": True}, {"mega": True}, {"wavefront": True}):
        with pytest.raises(ValueError, match="khops"):
            band_chase.band_to_bidiagonal(A, band=8, khops=0, **flags)
    want = two_stage.band_to_bidiagonal_accum(A, band=8)
    for flags in ({}, {"pipelined": True}, {"mega": True, "khops": 5}):
        got = band_chase.band_to_bidiagonal(A, band=8, **flags)
        assert all(torch.equal(g, w) for g, w in zip(got, want[:2]))
    assert all(torch.equal(g, w) for g, w in zip(band_chase.band_to_bidiagonal_l2(A, band=8),
                                                  want[:2]))
    for fn in (band_chase.band_to_bidiagonal_accum, band_chase.band_to_bidiagonal_accum_l2):
        assert all(torch.equal(g, w) for g, w in zip(fn(A, band=8), want))
    with pytest.raises(ValueError, match="n >= 2"):
        band_chase.band_to_bidiagonal_accum(torch.ones((1, 1)), band=4)
