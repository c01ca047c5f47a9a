"""The packed chase (K12) on the band store, on the CPU: the store's pack
and unpack (``two_stage.pack_store``), the span of ``j - g`` every box of
``chase_schedule.staged_copies`` touches (inside the store's range, no two
entries at one address) at small n and at 1024/b64 and 3840/b128, the tile
twin on the store (``two_stage.band_to_bidiagonal_store_tiles``)
bit-equal to the sequential chase and held to the JAX package's spectrum,
and the kernel ``band_chase_vmem`` picks for each shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import band_to_bidiagonal as jax_band_to_bidiagonal
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import (staged_copies, store_floats,
                                                    store_pitch, store_range)
from svdsolver_tpu_torch.ops.cuda import _build, band_chase_vmem

SHAPES = [(37, 4), (96, 8), (130, 32), (257, 64)]  # odd n among them
FULL = [(1024, 64, 1), (1024, 64, 5), (3840, 128, 1)]  # the check band and the path's


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


def _kept(n, b):
    """(g, j, keep): the store's range of ``j - g`` as a mask over (n, n)."""
    g, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    lo, hi = store_range(b)
    return g, j, (j - g >= lo) & (j - g <= hi)


def _unpack_store(St, n, b):
    """The (n, n) matrix whose entries the band store holds, zero outside
    its range: entry (g, j) read at ``store_pitch(b) * g + j``."""
    g, j, keep = _kept(n, b)
    A = torch.zeros((n, n), dtype=St.dtype)
    A[torch.from_numpy(keep)] = St[torch.from_numpy(store_pitch(b) * g[keep] + j[keep])]
    return A


def _box_span(n, b, K):
    """Box by box: the least and greatest ``j - g`` over the entries
    (g, j), g, j < n, of every box ``staged_copies`` loads or stores."""
    lo, hi = None, None
    for op in staged_copies(n, b, K):
        if op.kind not in ("load", "store"):
            continue
        r1, c1 = min(op.r + op.rows, n) - 1, min(op.c + b + 4, n) - 1
        if r1 < op.r or c1 < op.c:  # wholly past n
            continue
        lo = op.c - r1 if lo is None else min(lo, op.c - r1)
        hi = c1 - op.r if hi is None else max(hi, c1 - op.r)
    return lo, hi


def _sigma(d, e):
    B = np.diag(np.asarray(d, np.float64)) + np.diag(np.asarray(e, np.float64), 1)
    return np.linalg.svd(B, compute_uv=False)


@pytest.mark.parametrize("n,b", SHAPES)
def test_store_round_trip(rng, n, b):
    A = _band(rng, n, b)
    St = two_stage.pack_store(A, b)
    assert St.shape == (store_floats(n, b),)
    assert torch.equal(_unpack_store(St, n, b), A)


@pytest.mark.parametrize("n,b", SHAPES)
def test_store_layout(rng, n, b):
    # entry (g, j) at S g + j for j - g in the store's range, every other
    # address zero; of a dense matrix the store keeps exactly that range
    A = torch.tensor(rng.normal(size=(n, n)), dtype=torch.float32)
    St = two_stage.pack_store(A, b)
    g, j, keep = _kept(n, b)
    addr = store_pitch(b) * g[keep] + j[keep]
    assert len(set(addr.tolist())) == addr.size  # one address an entry
    want = np.zeros(St.numel(), np.float32)
    want[addr] = A.numpy()[keep]
    assert np.array_equal(St.numpy(), want)
    assert torch.equal(_unpack_store(St, n, b),
                       torch.where(torch.from_numpy(keep), A, torch.zeros(())))


def test_store_sizes():
    # the pitch is 16 bytes a multiple wherever b is; 6.0 MB at 3840/b128
    for b in range(4, 129, 4):
        assert store_pitch(b) % 4 == 0 and store_pitch(b) == 3 * b + 8
        lo, hi = store_range(b)
        assert hi - lo + 1 == 3 * b + 7 < store_pitch(b) + 1
    assert 4 * store_floats(3840, 128) == 6_034_912
    assert 4 * store_floats(1024, 64) == 822_496
    assert store_floats(2, 4) == 22


def _touched(n, b, K):
    """Every entry (g, j), g, j < n, of every box the schedule copies."""
    out = set()
    for op in staged_copies(n, b, K):
        if op.kind in ("load", "store"):
            for g in range(op.r, min(op.r + op.rows, n)):
                out.update((g, j) for j in range(op.c, min(op.c + b + 4, n)))
    return out


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("K", [1, 3])
def test_boxes_stay_in_the_store_small(n, b, K):
    # entry by entry: each touched entry's offset inside the store's range,
    # and no two touched entries at one address
    touched = _touched(n, b, K)
    lo, hi = store_range(b)
    S = store_pitch(b)
    offs = [j - g for g, j in touched]
    assert lo <= min(offs) and max(offs) <= hi
    addr = {S * g + j for g, j in touched}
    assert len(addr) == len(touched)
    assert _box_span(n, b, K) == (min(offs), max(offs))


@pytest.mark.parametrize("n,b,K", FULL)
def test_boxes_stay_in_the_store_full(n, b, K):
    # box by box at the slice's shapes: the span reaches both ends of the
    # store's range, whose 3b + 7 offsets fit the address's period S + 1 =
    # 3b + 9, so no two touched entries share an address
    lo, hi = store_range(b)
    assert _box_span(n, b, K) == (lo, hi) == (-b - 2, 2 * b + 4)
    assert hi - lo + 1 <= store_pitch(b) + 1


@pytest.mark.parametrize("n,b", SHAPES + [(5, 4), (2, 4), (1002 // 8, 12)])
def test_store_twin_bit_equal_to_sequential_chase(rng, n, b):
    A = _band(rng, n, b)
    want = two_stage.band_to_bidiagonal(A, band=b)
    for K in (1, 2):
        got = two_stage.band_to_bidiagonal_store_tiles(A, band=b, khops=K)
        for g, w in zip(got, want):
            assert torch.equal(g, w), K


@pytest.mark.parametrize("n,b", [(37, 4), (130, 32)])
def test_store_twin_matches_jax(rng, n, b):
    # the same numpy band through the JAX package's chase (op by op, as its
    # own tests run it) and the store twin: spectra within 1e-5 sigma_max
    Ab = _band(rng, n, b).numpy()
    with jax.disable_jit():
        dj, ej = jax_band_to_bidiagonal(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_store_tiles(torch.from_numpy(Ab), band=b)
    sj, s = _sigma(np.asarray(dj), np.asarray(ej)), _sigma(d.numpy(), e.numpy())
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-5 * sj[0])
    want = np.linalg.svd(Ab.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-5 * want[0])


def test_store_twin_refuses_a_box_past_the_store(monkeypatch, rng):
    # a store one offset too narrow: the twin's range check fires
    monkeypatch.setattr(two_stage, "store_range", lambda b: (-b - 1, 2 * b + 4))
    with pytest.raises(AssertionError, match="range"):
        two_stage.band_to_bidiagonal_store_tiles(_band(rng, 40, 8), band=8)


@pytest.mark.parametrize("n", [99, 1000, 3840])
@pytest.mark.parametrize("b,route", [(3, "packed"), (4, "tma"), (6, "packed"),
                                     (64, "tma"), (128, "tma")])
def test_vmem_route_by_shape(n, b, route):
    assert band_chase_vmem.vmem_route(torch.zeros((n, n)), b) == route


def test_vmem_route_ignores_the_address():
    # the kernel allocates its store: A's own alignment does not enter
    A = torch.zeros(200 * 200 + 1)[1:].view(200, 200)
    assert band_chase_vmem.vmem_route(A, 8) == "tma"
    for b in (0, 129, 256):
        with pytest.raises(ValueError, match="band"):
            band_chase_vmem.vmem_route(A, b)


@pytest.fixture
def launched(monkeypatch):
    """Send CPU tensors down the wrapper's kernel path and log each launch
    as (n, band, kernel) in place of running it."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    def launch(A, b, route):
        calls.append((A.shape[0], b, route))

    monkeypatch.setattr(band_chase_vmem, "_build", OnCard())
    monkeypatch.setattr(band_chase_vmem, "_launch", launch)
    return calls


@pytest.mark.parametrize("n,b,want", [
    (1024, 64, "tma"), (1002, 64, "tma"), (3840, 128, "tma"), (256, 32, "tma"),
    (37, 4, "tma"), (96, 6, "packed"), (150, 3, "packed"), (200, 2, "packed"),
    (1001, 64, "tma"),
])
def test_vmem_kernel_by_shape(launched, n, b, want):
    band_chase_vmem.band_to_bidiagonal_vmem(torch.zeros((n, n)), band=b)
    assert launched == [(n, b, want)]


def test_vmem_wrapper_on_cpu(rng):
    # a CPU tensor runs the plain version on every band, bit-equal to the
    # sequential chase and to the store twin
    for n, b in ((40, 8), (41, 6)):
        A = _band(rng, n, b)
        want = two_stage.band_to_bidiagonal(A, band=b)
        got = band_chase_vmem.band_to_bidiagonal_vmem(A, band=b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if b % 4 == 0:
            twin = two_stage.band_to_bidiagonal_store_tiles(A, band=b)
            assert all(torch.equal(g, w) for g, w in zip(twin, want))


def test_load_sets_every_callers_entries(monkeypatch):
    # two modules load one library (band_chase_staged) for different entry
    # points: each call sets its own entries' argument types, whichever
    # loaded the library first
    class Fn:
        pass

    class Lib:
        svdt_a, svdt_b = Fn(), Fn()

    monkeypatch.setitem(_build._LIBS, "shared", Lib())
    _build.load("shared", {"svdt_a": [_build.VOIDP]})
    lib = _build.load("shared", {"svdt_b": [_build.VOIDP, _build.INT]})
    assert lib.svdt_a.argtypes == [_build.VOIDP]
    assert lib.svdt_b.argtypes == [_build.VOIDP, _build.INT]
    assert lib.svdt_b.restype is _build.INT
