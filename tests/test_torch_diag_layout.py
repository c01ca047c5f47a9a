"""The diagonalizer wrappers' host side (``ops/cuda/dqds.py``,
``ops/cuda/bidiag_qr.py``) on the CPU: the memory instance each shape
takes at the kernels' shared-memory limits, the refusals, what the dqds
wrapper hands its kernel (the two pairs and the accumulated shifts live in
shared memory or in a 5n device workspace), and the chain bound's
helpers.  Fixture ``on_card``: the wrappers' ``_build`` and ``_launch``
patched so CPU tensors take the kernel path and each launch is logged in
place of running."""

import pytest
import torch

from svdsolver_tpu_torch.models import diagonalize as dg
from svdsolver_tpu_torch.ops.cuda import _build, bidiag_qr, dqds

F64, F32 = torch.float64, torch.float32


def _largest_n(values_a_step, size, extra=0):
    """The largest n with size * (values_a_step * n + extra) beside the
    static room in one block's shared memory."""
    return (_build.MAX_SMEM - _build.STATIC_SMEM - size * extra) // (size * values_a_step)


@pytest.fixture
def on_card(monkeypatch):
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_bidiagonal(d, e, dtypes):
            return True

    def qr_launch(entry, d, *args):
        calls.append(("bidiag_qr", entry, d, args))
        if entry == "converge":
            args[6][1] = 1  # info: converged

    def dqds_launch(q, *args):
        calls.append(("dqds", "loop", q, args))
        args[5][0] = -1  # info: hi < 0, every eigenvalue deflated

    for mod in (bidiag_qr, dqds):
        monkeypatch.setattr(mod, "_build", OnCard())
    monkeypatch.setattr(bidiag_qr, "_launch", qr_launch)
    monkeypatch.setattr(dqds, "_launch", dqds_launch)
    return calls


@pytest.mark.parametrize("dtype,limit", [(F32, 11571), (F64, 5785)])
def test_dqds_memory_instance_limits(dtype, limit):
    # the two (q, E) pairs and the accumulated shifts: 5n values
    size = torch.finfo(dtype).bits // 8
    assert limit == _largest_n(dqds.FOOTPRINT, size)
    assert dqds.memory_instance(limit, dtype) == "smem"
    assert dqds.memory_instance(limit + 1, dtype) == "global"


@pytest.mark.parametrize("dtype,reduction,limit", [
    (F32, True, 28672), (F64, True, 14208),  # the converged driver: d, e, the reduction
    (F32, False, 28928), (F64, False, 14464),  # the sweep entry: d and e
])
def test_qr_memory_instance_limits(dtype, reduction, limit):
    size = torch.finfo(dtype).bits // 8
    assert limit == _largest_n(2, size, 2 * bidiag_qr.THREADS * reduction)
    assert bidiag_qr.memory_instance(limit, dtype, reduction) == "smem"
    assert bidiag_qr.memory_instance(limit + 1, dtype, reduction) == "global"


@pytest.mark.parametrize("dtype,n", [(F32, 11572), (F64, 5786)])
def test_dqds_smem_too_small_raises(on_card, dtype, n):
    q, E = torch.ones(n, dtype=dtype), torch.zeros(n, dtype=dtype)
    with pytest.raises(ValueError, match="does not fit shared memory"):
        dqds.dqds_loop(q, E, 4, "smem")
    with pytest.raises(ValueError, match="memory must be"):
        dqds.dqds_loop(q, E, 4, "texture")
    assert on_card == []
    dqds.dqds_loop(q, E, 4, "global")
    assert len(on_card) == 1


@pytest.mark.parametrize("dtype,n", [(F32, 28673), (F64, 14209)])
def test_qr_smem_too_small_raises(on_card, dtype, n):
    d, e = torch.ones(n, dtype=dtype), torch.zeros(n - 1, dtype=dtype)
    with pytest.raises(ValueError, match="does not fit shared memory"):
        bidiag_qr.converge(d, e, _memory="smem")
    with pytest.raises(ValueError, match="memory must be"):
        bidiag_qr.converge(d, e, _memory="texture")
    assert on_card == []
    # the sweep entry needs no reduction: 28,673 / 14,209 fit there
    bidiag_qr.sweeps(d, e, n_iter=2, _memory="smem")
    assert [c[1] for c in on_card] == ["sweeps"]


@pytest.mark.parametrize("memory", ["smem", "global"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_dqds_kernel_arguments(on_card, memory, dtype):
    # q and E go to the kernel as they are (it reads them only); the
    # pairs and the shifts live in shared memory, or in a 5n workspace
    n = 40
    q = torch.linspace(1.0, 2.0, n, dtype=dtype)
    E = torch.full((n,), 0.25, dtype=dtype)
    out, hi, sweeps, hist = dqds.dqds_loop(q, E, 9, memory)
    (_, _, q_k, (E_k, out_k, work, n_k, sweeps_k, info, smem)), = on_card
    assert q_k.data_ptr() == q.data_ptr() and E_k.data_ptr() == E.data_ptr()
    assert out_k is out and not bool(out.any())
    assert (n_k, sweeps_k, smem) == (n, 9, int(memory == "smem"))
    assert info.dtype == torch.int64 and info.shape == (3 + dg.HIST_BINS,)
    if memory == "smem":
        assert work is None
    else:
        assert work.shape == (dqds.FOOTPRINT * n,) and work.dtype == dtype
    assert hi == -1 and len(hist) == dg.HIST_BINS


def test_dqds_entries_have_no_backup():
    # (q, E, out, work, n, max_sweeps, info, smem, stream): no qb / Eb, no accv
    P, I, L = _build.VOIDP, _build.INT, _build.LONG
    for s in ("f32", "f64"):
        assert dqds._ENTRIES[f"svdt_dqds_{s}"] == [P, P, P, P, I, I, P, I, P]
        assert dqds._ENTRIES[f"svdt_dqds_chain_{s}"] == [P, L, P]
        assert bidiag_qr._ENTRIES[f"svdt_bidiag_qr_chain_{s}"] == [P, L, I, P]


@pytest.mark.parametrize("steps_zero,steps_shift,ns_zero,ns_shift,want", [
    (1000, 3000, 100.0, 200.0, 0.7),
    (8_356_000, 0, 150.0, 1e9, 1253.4),  # zero-shift steps take only their own ns
    (0, 8_356_000, 1e9, 180.0, 1504.08),
])
def test_qr_chain_bound_ms(steps_zero, steps_shift, ns_zero, ns_shift, want):
    got = bidiag_qr.chain_bound_ms(steps_zero, steps_shift, ns_zero, ns_shift)
    assert got == pytest.approx(want, rel=1e-12)


def test_dqds_chain_bound_ms():
    assert dqds.chain_bound_ms(21_300_000, 35.0) == pytest.approx(745.5, rel=1e-12)
    assert dqds.chain_bound_ms(0, 35.0) == 0.0


@pytest.mark.parametrize("dtype", [F32, F64])
def test_chain_ns_launches_the_chain_entries(monkeypatch, dtype):
    # each wrapper times its own chain entry, steps rounded down to the
    # entry's unrolling (8), the QR kind passed as its index
    timed = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load", lambda name, entries: Lib())
    monkeypatch.setattr(_build, "chain_ns",
                        lambda fn, dt, steps, *args: timed.append((fn, dt, steps, args)) or 1.0)
    s = {F32: "f32", F64: "f64"}[dtype]
    assert dqds.chain_ns(dtype, steps=1001) == 1.0
    assert bidiag_qr.chain_ns(dtype, "zero", steps=64) == 1.0
    assert bidiag_qr.chain_ns(dtype, "shifted", steps=70) == 1.0
    assert timed == [(f"svdt_dqds_chain_{s}", dtype, 1000, ()),
                     (f"svdt_bidiag_qr_chain_{s}", dtype, 64, (0,)),
                     (f"svdt_bidiag_qr_chain_{s}", dtype, 64, (1,))]
