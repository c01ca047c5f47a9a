"""The pipelined chase's pass as a wavefront over its sweeps (the design of
``csrc/band_chase_superstep.cu``), on the CPU.

* The schedule (``ops/chase_schedule.superstep_pairs``) at every pass of
  small pipeline geometries: exactly the pairs ``two_stage.chase_superstep``
  runs, pairs of one tick on disjoint windows, and every two pairs whose
  windows meet in the pass's order.  The windows are read off a stand-in
  buffer whose slices record their corners, so no arithmetic runs.
* The tick-order twin ``two_stage.chase_superstep_wavefront`` ``torch.equal`` to
  ``chase_superstep`` on random buffers of those geometries.
* The pipelined entry on four CPU ranks with the tick-order pass swapped
  in: ``(d, e)`` ``torch.equal`` to the entry's own, and the JAX package's
  pipelined chase's spectrum.
* The wrapper's route, refusals, argument types and launch counters, with
  the kernel library replaced by a stand-in.
"""

import contextlib
import ctypes
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from svdsolver_tpu.parallel import distributed as jd
from svdsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import superstep_copy_bytes, superstep_pairs
from svdsolver_tpu_torch.ops.cuda import band_chase
from svdsolver_tpu_torch.parallel import spawn
from svdsolver_tpu_torch.parallel.distributed import pipeline_geometry

GEOMETRIES = [(tp, n, b, lg) for tp in (1, 2, 4) for n in (96, 130, 257, 300)
              for b in (4, 8, 12, 32) for lg in (None, 1, 3, 5)]
# the pipelined entry on 4 CPU ranks: (n, band, sweeps_per_group, dtype)
PIPELINED = [(64, 8, None, np.float64), (64, 8, 2, np.float64), (96, 8, None, np.float32)]


def _passes(tp, n, b, lg):
    """Every pass of the pipelined chase at the geometry: each rank's
    groups (group g runs on rank d at superstep 2 g + d), as the arguments
    of ``chase_superstep`` and ``Np``."""
    geo = pipeline_geometry(n, b, tp, lg)
    for rank in range(tp):
        for g in range(geo.NG):
            yield geo, (n, b, g * geo.LG, geo.LG, rank * geo.m, geo.U, geo.m, rank == tp - 1,
                        geo.s_chase)


class _Corners:
    """A stand-in buffer: a slice gives its corner (local row, column)."""

    def __init__(self, rows, cols):
        self.shape = (rows, cols)

    def __getitem__(self, key):
        return key[0].start, key[1].start


def _windows(fn, geo, args, monkeypatch):
    """The windows ``fn`` (a pass of ``two_stage``) runs its pairs on, in
    order: (global corner row, column, head pair?)."""
    seen = []

    def pairs(w):
        return (lambda W: seen.append((*W, True)), lambda W: seen.append((*W, False)))

    monkeypatch.setattr(two_stage, "make_window_pairs", pairs)
    fn(_Corners(geo.U + geo.m + 4 * geo.b, geo.Np), *args)
    R0, U = args[4], args[5]
    return [(r + R0 - U, c, head) for r, c, head in seen]


def _corner(p, b):
    if p.k < 0:
        return p.i, p.i + 1, True
    r = p.i + 1 + p.k * b
    return r, r + b, False


def _rows(corner, b):
    """The rows of a pair's window: b + 1 for a head pair, 2b for a chase
    pair (columns: 2b from the corner for both)."""
    r, _, head = corner
    return r, r + (b + 1 if head else 2 * b)


@pytest.mark.parametrize("tp,n,b,lg", GEOMETRIES)
def test_pass_schedule_is_chase_superstep_s_pairs_by_tick(tp, n, b, lg, monkeypatch):
    """At every pass: the schedule's pairs are ``chase_superstep``'s, in
    its order by (lane, pair); ``chase_superstep_wavefront`` runs them by
    (tick, lane); a tick's windows are disjoint in rows; two pairs whose
    windows meet (rows and columns) keep the sequential order."""
    for geo, args in _passes(tp, n, b, lg):
        sched = superstep_pairs(*args[:5], *args[6:], geo.Np)
        corners = [_corner(p, b) for p in sched]
        seq = _windows(two_stage.chase_superstep, geo, args, monkeypatch)
        by_lane = sorted(range(len(sched)), key=lambda j: (sched[j].lane, sched[j].k))
        assert seq == [corners[j] for j in by_lane], args
        assert _windows(two_stage.chase_superstep_wavefront, geo, args, monkeypatch) == corners
        assert [(p.t, p.lane) for p in sched] == sorted((p.t, p.lane) for p in sched)
        assert all(p.t == 3 * p.i + p.k + 1 for p in sched)  # the head's k = -1
        order = {j: q for q, j in enumerate(by_lane)}  # position in the sequential pass
        for ticks in _by_tick(sched).values():
            spans = sorted(_rows(corners[j], b) for j in ticks)
            assert all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:])), args
        by_row = sorted(range(len(sched)), key=lambda j: corners[j][0])
        for a, j in enumerate(by_row):
            r1 = _rows(corners[j], b)[1]
            for q in (by_row[x] for x in range(a + 1, len(by_row))):
                if corners[q][0] >= r1:
                    break
                c0, c1 = corners[j][1], corners[q][1]
                if c0 < c1 + 2 * b and c1 < c0 + 2 * b:  # the windows meet
                    first, then = sorted((j, q), key=order.get)
                    assert sched[first].t < sched[then].t, (args, sched[first], sched[then])


def _by_tick(sched):
    ticks = {}
    for j, p in enumerate(sched):
        ticks.setdefault(p.t, []).append(j)
    return ticks


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("b", [4, 8, 12, 32])
def test_wavefront_pass_bit_equal_to_chase_superstep(tp, b):
    """``chase_superstep_wavefront`` ``torch.equal`` to ``chase_superstep``
    at n = 96, 130 (LG auto) and 257 (LG 3), on random float32 buffers (the
    whole buffer nonzero, so any pair out of order shows), at the first,
    the middle and the last group of every rank."""
    rng = np.random.default_rng(b + 10 * tp)
    for n, lg in ((96, None), (130, None), (257, 3)):
        passes = list(_passes(tp, n, b, lg))
        ng = pipeline_geometry(n, b, tp, lg).NG
        for geo, args in passes:
            if args[2] // geo.LG not in (0, ng // 2, ng - 1):
                continue
            L = torch.from_numpy(rng.uniform(-1, 1, (geo.U + geo.m + 4 * b, geo.Np))
                                 .astype(np.float32))
            want = two_stage.chase_superstep(L.clone(), *args)
            assert torch.equal(two_stage.chase_superstep_wavefront(L.clone(), *args), want), args


@pytest.mark.parametrize("b,k", [(4, 1), (8, 2), (12, 5), (32, 9)])
def test_copy_bytes_of_one_lane(b, k):
    """One lane (LG = 1, one rank) keeps its tile from pair to pair: a head
    pair's 4 boxes and its last row both ways, then a pass of k pairs with
    work moves 6 boxes (k = 1) or 5 + 4 (k - 2) + 5."""
    n = 2 + k * b + b // 2  # sweep 0's pairs with work: k
    geo = pipeline_geometry(n, b, 1, 1)
    box = 4 * b * (b + 4)
    want = 4 * box + 16 * b + (6 if k == 1 else 10 + 4 * (k - 2)) * box
    got = superstep_copy_bytes(n, b, 0, 1, 0, geo.m, True, geo.s_chase, geo.Np)
    assert got == want


def test_copy_bytes_take_the_largest_pair_of_a_tick():
    """At PAR_PIPE's timed pass (1024/b32, tp = 4, rank 0, group 0: 21
    pairs, 10 ticks, 3 lanes) the bytes are a tick's largest pair summed
    over the ticks, and lie between one box a tick and every pair's."""
    n, b = 1024, 32
    geo = pipeline_geometry(n, b, 4)
    args = (n, b, 0, geo.LG, 0, geo.m, False, geo.s_chase, geo.Np)
    sched = superstep_pairs(*args)
    assert (len(sched), len({p.t for p in sched})) == (21, 10)
    box = 4 * b * (b + 4)
    got = superstep_copy_bytes(*args)
    assert 10 * 4 * box < got < len(sched) * 6 * box + 16 * b


@pytest.fixture(scope="module")
def pipelined():
    """``(port, JAX)``: the pipelined entry on 4 CPU ranks, its own pass
    and the tick-order pass swapped in (``tests/torch_parallel_ranks.
    pipelined_tick_order``), while the JAX package's pipelined chase runs
    here on the same bands."""
    rng = np.random.default_rng(23)
    bands = {}
    for n, b, lg, dtype in PIPELINED:
        A = torch.from_numpy(rng.normal(size=(n, n)).astype(dtype))
        bands[(n, b, lg, np.dtype(dtype).name)] = two_stage.dense_to_band(A, band=b).numpy()
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, ranks.pipelined_tick_order, 4, dp=1, device="cpu",
                           args=(bands,), timeout=240)
        m4 = jax_mesh(4, dp=1, platform="cpu")
        jx = {key: tuple(np.asarray(x) for x in jd.band_to_bidiagonal_pipelined(
            jnp.asarray(Ab), m4, band=key[1], sweeps_per_group=key[2]))
            for key, Ab in bands.items()}
        return bands, port.result(), jx


def _sigma(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


@pytest.mark.parametrize("case", PIPELINED, ids=lambda c: f"{c[0]}/{c[1]} LG={c[2]} "
                         f"{np.dtype(c[3]).name}")
def test_pipelined_entry_with_the_tick_order_pass(pipelined, case):
    """On 4 CPU ranks: (d, e) of the pipelined entry with the tick-order
    pass ``torch.equal`` to the entry's own; against the JAX package's
    pipelined chase at the tolerances of ``test_torch_parallel.
    test_pipelined_chase_matches_jax_and_the_sequential_chase`` (float64:
    entries within 1e-10 |Ab|, the spectrum within 1e-13 of the sequential
    chase's; float32: the spectrum within 1e-5 sigma_max of JAX's)."""
    bands, port, jx = pipelined
    n, b, lg, dtype = case
    key = (n, b, lg, np.dtype(dtype).name)
    own, tick = port[key]
    assert torch.equal(tick[0], own[0]) and torch.equal(tick[1], own[1])
    d, e = (x.numpy() for x in tick)
    assert d.shape == (n,) and e.shape == (n - 1,) and d.dtype == dtype
    Ab = bands[key]
    d0, e0 = two_stage.band_to_bidiagonal(torch.from_numpy(Ab), band=b)
    s0, s1 = _sigma(d0.numpy(), e0.numpy()), _sigma(d, e)
    if dtype == np.float64:
        tol = 1e-10 * np.linalg.norm(Ab, 2)
        np.testing.assert_allclose(d, jx[key][0], atol=tol)
        np.testing.assert_allclose(e, jx[key][1], atol=tol)
        assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-13
    else:
        assert np.max(np.abs(s1 - _sigma(*jx[key])) / s0[0]) < 1e-5
    assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-5


# ---- the wrapper's route, with the kernel library replaced ----

class _Lib:
    """Stand-in for the two libraries: records each call and returns
    ``err``; the shared-memory entry reports ``ctas`` CTAs."""

    def __init__(self, ctas=3, err=0):
        self.calls, self.ctas, self.err = [], ctas, err

    def svdt_band_chase_superstep_wave(self, *args):
        self.calls.append(("wave", args))
        ctypes.c_int.from_address(args[14]).value = self.ctas
        return self.err

    def svdt_band_chase_superstep(self, *args):
        self.calls.append(("l2", args))
        return self.err


@pytest.fixture
def card(monkeypatch):
    """Route CPU tensors as CUDA ones, into a stand-in library."""
    lib = _Lib()
    monkeypatch.setattr(band_chase._build, "check_input", lambda *a, **k: True)
    monkeypatch.setattr(band_chase._build, "load", lambda *a, **k: lib)
    monkeypatch.setattr(band_chase._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(band_chase.torch.cuda, "device", lambda d: contextlib.nullcontext())
    return lib


def _buffer(n, b, tp=1, lg=None, offset=0):
    geo = pipeline_geometry(n, b, tp, lg)
    rows = geo.U + geo.m + 4 * b
    L = torch.zeros(rows * geo.Np + offset)[offset:].view(rows, geo.Np)
    return L, (n, b, 0, geo.LG, 0, geo.U, geo.m, tp == 1, geo.s_chase)


def test_route_takes_the_shared_memory_design_by_shape(card):
    """The shared-memory design wherever ``superstep_takes`` holds (its C
    entry with the buffer's pointer, pitch and rows, a zeroed counter and
    no CTA cap), counted where it launched; the first design with
    ``_design="l2"``; each counter apart."""
    L, args = _buffer(64, 8)
    before = band_chase.launches_superstep, band_chase.launches_superstep_l2
    assert band_chase.superstep_design(L, 64, 8, args[3]) == "wave"
    assert band_chase.superstep(L, *args) is L
    kind, got = card.calls[-1]
    rows, Np = L.shape
    assert kind == "wave" and got[:12] == (L.data_ptr(), Np, rows, *args[:7], 1, args[8])
    assert got[13] == 0 and got[15] == 0 and isinstance(got[12], int)
    assert len(band_chase._SUPERSTEP_ENTRIES["svdt_band_chase_superstep_wave"]) == len(got)
    assert band_chase.last_superstep_ctas == 3
    assert band_chase.launches_superstep == before[0] + 1
    card.ctas = 0  # a pass with no pair with work launches nothing
    band_chase.superstep(L, *args)
    assert band_chase.launches_superstep == before[0] + 1
    band_chase.superstep(L, *args, _design="l2")
    kind, got = card.calls[-1]
    assert kind == "l2" and got == (L.data_ptr(), Np, *args[:7], 1, args[8], 0)
    assert len(band_chase._ENTRIES["svdt_band_chase_superstep"]) == len(got)
    assert band_chase.launches_superstep_l2 == before[1] + 1
    assert band_chase.launches_superstep == before[0] + 1


@pytest.mark.parametrize("n,b,tp,offset,why", [
    (66, 8, 1, 0, "n not a multiple of 4"), (64, 6, 1, 0, "band not a multiple of 4"),
    (512, 132, 1, 0, "band past 128"), (64, 8, 1, 1, "buffer not 16-byte aligned"),
    (68, 8, 3, 0, "Np = 90 not a multiple of 4")])
def test_route_takes_the_first_design_elsewhere(card, n, b, tp, offset, why):
    L, args = _buffer(n, b, tp=tp, offset=offset)
    assert band_chase.superstep_design(L, n, b, args[3]) == "l2", why
    before = band_chase.launches_superstep_l2
    band_chase.superstep(L, *args)
    assert card.calls[-1][0] == "l2" and band_chase.launches_superstep_l2 == before + 1
    with pytest.raises(ValueError, match="does not take"):
        band_chase.superstep(L, *args, _design="wave")


def test_one_sweep_passes_take_the_first_design(card):
    """A pass of one sweep (LG = 1) takes the first design, where the
    shape alone would take the shared-memory one; ``_design="wave"`` still
    runs it there."""
    L, args = _buffer(64, 8, lg=1)
    assert args[3] == 1 and band_chase.superstep_takes(L, 64, 8)
    assert band_chase.superstep_design(L, 64, 8, 1) == "l2"
    assert band_chase.superstep_design(L, 64, 8, 2) == "wave"
    band_chase.superstep(L, *args)
    assert card.calls[-1][0] == "l2"
    band_chase.superstep(L, *args, _design="wave")
    assert card.calls[-1][0] == "wave"


def test_superstep_refusals(card):
    """A band out of range, a buffer too small, an unknown design, a
    buffer that is no 2-D tensor; a failed launch raises (nothing caught)."""
    L, args = _buffer(64, 8)
    with pytest.raises(ValueError, match="_design"):
        band_chase.superstep(L, *args, _design="smem")
    with pytest.raises(ValueError, match="out of range"):
        band_chase.superstep(L, 64, 0, *args[2:])
    with pytest.raises(ValueError, match="too small"):
        band_chase.superstep(L[:10], *args)
    card.err = 700
    before = band_chase.launches_superstep, band_chase.launches_superstep_l2
    for design in ("wave", "l2"):
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            band_chase.superstep(L, *args, _design=design)
    assert (band_chase.launches_superstep, band_chase.launches_superstep_l2) == before


def test_superstep_refuses_what_is_no_buffer():
    L, args = _buffer(64, 8)
    with pytest.raises(TypeError, match="torch.Tensor"):
        band_chase.superstep(L.numpy(), *args)
    with pytest.raises(ValueError, match="2-D"):
        band_chase.superstep(L.reshape(-1), *args)


def test_cpu_tensor_runs_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs ``superstep_plain`` in place with no
    launch counted, whatever the card would take: the route is not asked
    (an unaligned buffer with ``_design="wave"``, which the card refuses,
    runs it too)."""
    rng = np.random.default_rng(5)
    ran = []
    plain = band_chase.superstep_plain
    monkeypatch.setattr(band_chase, "superstep_plain", lambda *a: ran.append(a[4]) or plain(*a))
    monkeypatch.setattr(band_chase, "superstep_design", None)
    before = band_chase.launches_superstep, band_chase.launches_superstep_l2
    for offset, design in ((0, None), (1, "wave"), (0, "l2")):
        L, args = _buffer(64, 8, tp=1, offset=offset)
        L.copy_(torch.from_numpy(rng.uniform(-1, 1, L.shape).astype(np.float32)))
        want = two_stage.chase_superstep(L.clone(), *args)
        assert band_chase.superstep(L, *args, _design=design) is L and torch.equal(L, want)
    assert ran == [args[3]] * 3
    assert (band_chase.launches_superstep, band_chase.launches_superstep_l2) == before
