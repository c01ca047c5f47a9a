"""The QR and dqds diagonalizers of the port (``ops/givens.py``,
``models/diagonalize.py``; plain versions on the CPU) held to the JAX
package and to LAPACK, and the kernel each entry launches for a CUDA-style
call (fixture ``launched``: the wrappers' ``_build`` and ``_launch``
patched so CPU tensors take the kernel path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import diagonalize as jdg
from svdsolver_tpu.models.svd import svdvals as jax_svdvals
from svdsolver_tpu.ops.givens import givens as jax_givens
from svdsolver_tpu_torch import (
    bidiagonal_svdvals,
    convergence_threshold,
    diag_reduce_fixed_iter,
    dqds_svdvals,
    givens,
    shifted_sweep,
    svdvals,
    zero_shift_sweep,
)
from svdsolver_tpu_torch.models import diagonalize as dg
from svdsolver_tpu_torch.ops.cuda import _build, bidiag_qr, dqds
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64, F32 = torch.float64, torch.float32


def _bidiag(rng, n, dtype=np.float64):
    return rng.normal(size=n).astype(dtype), rng.normal(size=n - 1).astype(dtype)


def _sigma(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


def _t(x, dtype=F64):
    return from_numpy(x, dtype=dtype)


def _stall_spectrum():
    g = np.random.default_rng(0)
    return g.standard_normal(120), g.standard_normal(119)


# ---- givens ------------------------------------------------------------------

@pytest.mark.parametrize("f,g", [
    (0.0, 0.0), (0.0, 2.5), (0.0, -1.0),  # f == 0: (0, 1, g)
    (3.0, 1.0), (-3.0, 2.0), (4.0, 0.0),  # |f| > |g|
    (1.0, 3.0), (2.0, -5.0), (1.5, 1.5), (-2.0, 2.0),  # |g| >= |f|
])
def test_givens_matches_jax(f, g):
    # each branch and the zeros, float64 and float32, against the JAX
    # package's eager ops to 4 eps: torch's CPU sqrt in float64 may round
    # one ulp off (sqrt(2) does on an AVX-512 build); the selected branch
    # and the exact cases (0, 1, g) are exact
    for dtype, jdtype in ((F64, jnp.float64), (F32, jnp.float32)):
        got = givens(torch.tensor(f, dtype=dtype), torch.tensor(g, dtype=dtype))
        want = jax_givens(jnp.asarray(f, jdtype), jnp.asarray(g, jdtype))
        eps = float(torch.finfo(dtype).eps)
        for a, b in zip(got, want):
            assert a.dtype == dtype
            assert abs(float(a) - float(b)) <= 4 * eps * abs(float(b)), (f, g, dtype)
            assert (float(a) == 0) == (float(b) == 0)
    c, s, r = (float(x) for x in givens(torch.tensor(f, dtype=F64), torch.tensor(g, dtype=F64)))
    np.testing.assert_allclose([c * f + s * g, -s * f + c * g], [r, 0.0], atol=1e-14)


def test_givens_broadcasts_and_numbers():
    f = torch.tensor([0.0, 3.0, 1.0], dtype=F64)
    c, s, r = givens(f, torch.tensor([2.0, 1.0, 3.0], dtype=F64))
    assert c.shape == (3,) and float(c[0]) == 0.0 and float(s[0]) == 1.0 and float(r[0]) == 2.0
    c, s, r = givens(3.0, 4.0)
    assert c.dtype == torch.get_default_dtype() and abs(float(r) - 5.0) < 1e-6


# ---- the sweeps ----------------------------------------------------------------

@pytest.mark.parametrize("dtype,jdtype,tol", [(F64, jnp.float64, 1e-13), (F32, jnp.float32, 2e-6)])
def test_zero_shift_sweep_matches_jax(rng, dtype, jdtype, tol):
    # full range and a sub-block: entries outside [3, 7] (d) and [3, 6] (e)
    # untouched, the block's singular values preserved; tolerance relative
    # to max|d| (XLA:CPU may contract a*b + c into one rounding)
    d, e = _bidiag(rng, 12)
    for lo, hi in ((None, None), (3, 7)):
        got = zero_shift_sweep(_t(d, dtype), _t(e, dtype), lo, hi)
        want = jax.jit(jdg.zero_shift_sweep)(jnp.asarray(d, jdtype), jnp.asarray(e, jdtype),
                                             lo, hi)
        scale = np.abs(d).max()
        for a, b in zip(got, want):
            assert a.dtype == dtype
            np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=0, atol=tol * scale)
    d2, e2 = (to_numpy(x) for x in zero_shift_sweep(_t(d), _t(e), 3, 7))
    np.testing.assert_array_equal(d2[:3], d[:3])
    np.testing.assert_array_equal(d2[8:], d[8:])
    np.testing.assert_array_equal(e2[:3], e[:3])
    np.testing.assert_array_equal(e2[7:], e[7:])
    np.testing.assert_allclose(np.sort(_sigma(d2[3:8], e2[3:7])),
                               np.sort(_sigma(d[3:8], e[3:7])), rtol=1e-10)


@pytest.mark.parametrize("lo,hi", [(0, 11), (2, 9), (4, 5), (10, 11)])
def test_shifted_sweep_matches_jax(rng, lo, hi):
    d, e = _bidiag(rng, 12)
    got = [to_numpy(x) for x in shifted_sweep(_t(d), _t(e), lo, hi, 0.3)]
    want = [np.asarray(x) for x in jax.jit(jdg.shifted_sweep)(
        jnp.asarray(d), jnp.asarray(e), lo, hi, 0.3)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13 * np.abs(d).max())
    np.testing.assert_array_equal(got[0][:lo], d[:lo])
    np.testing.assert_array_equal(got[0][hi + 1:], d[hi + 1:])
    np.testing.assert_array_equal(got[1][hi:], e[hi:])
    # a shifted QR step preserves the block's singular values
    np.testing.assert_allclose(np.sort(_sigma(got[0][lo:hi + 1], got[1][lo:hi])),
                               np.sort(_sigma(d[lo:hi + 1], e[lo:hi])), rtol=1e-10)


def test_diag_reduce_fixed_iter_matches_jax(rng):
    d, e = _bidiag(rng, 8)
    got = [to_numpy(x) for x in diag_reduce_fixed_iter(_t(d), _t(e), 200)]
    want = [np.asarray(x) for x in jax.jit(jdg.diag_reduce_fixed_iter, static_argnums=2)(
        jnp.asarray(d), jnp.asarray(e), 200)]
    # zero-shift sweeps drive e -> 0; d converges to +/- sigma
    assert np.max(np.abs(got[1])) < 1e-8 * np.max(np.abs(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(np.sort(np.abs(got[0])), np.sort(_sigma(d, e)), rtol=1e-10)


@pytest.mark.parametrize("dtype,jdtype,rtol", [(F64, jnp.float64, 1e-13), (F32, jnp.float32, 1e-5)])
@pytest.mark.parametrize("n", [2, 5, 20, 192])
def test_convergence_threshold_matches_jax(rng, dtype, jdtype, rtol, n):
    d, e = rng.uniform(0, 5, n), rng.uniform(0, 5, n - 1)
    got = convergence_threshold(_t(d, dtype), _t(e, dtype))
    want = jax.jit(jdg.convergence_threshold)(jnp.asarray(d, jdtype), jnp.asarray(e, jdtype))
    assert got.shape == () and got.dtype == dtype
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    # the absolute floor: never below 0.5 eps ||B|| (the regression of the
    # JAX package's test_qr_threshold_floor_converges_fast)
    assert float(got) >= 0.5 * float(torch.finfo(dtype).eps) * np.abs(d).max()


@pytest.mark.parametrize("dtype", [F64, F32])
def test_convergence_threshold_rejects_n1(dtype):
    # the threshold reads e: n = 1 raises on every device (the kernel's
    # prologue would read past an empty e), and the driver's svdvals at
    # n = 1 is |d| with no threshold
    d, e = torch.tensor([-2.0], dtype=dtype), torch.zeros(0, dtype=dtype)
    with pytest.raises(ValueError, match="n >= 2"):
        convergence_threshold(d, e)
    assert bidiagonal_svdvals(d, e).tolist() == [2.0]


@pytest.mark.parametrize("dtype,jdtype,rtol", [(F64, jnp.float64, 1e-8), (F32, jnp.float32, 2e-5)])
@pytest.mark.parametrize("n", [2, 5, 16, 64])
def test_bidiagonal_svdvals_matches_jax(rng, dtype, jdtype, rtol, n):
    d, e = _bidiag(rng, n)
    want = _sigma(d, e)
    got = to_numpy(bidiagonal_svdvals(_t(d, dtype), _t(e, dtype)))
    ref = np.asarray(jdg.bidiagonal_svdvals(jnp.asarray(d, jdtype), jnp.asarray(e, jdtype)))
    atol = (1e-12 if dtype == F64 else 1e-5) * want[0]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_bidiagonal_svdvals_exact_splits(rng, dtype):
    # exact zeros in e force independent blocks
    d, e = _bidiag(rng, 10)
    e[3] = e[7] = 0.0
    want = _sigma(d, e)
    got = to_numpy(bidiagonal_svdvals(_t(d, dtype), _t(e, dtype)))
    ref = np.asarray(jdg.bidiagonal_svdvals(jnp.asarray(d), jnp.asarray(e)))
    tol = 1e-8 if dtype == F64 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 1e-4 * want[0])
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * 1e-4 * want[0])


def test_qr_chunked_bit_equal_to_single_shot(rng):
    # the chunked driver resumes where each chunk stopped: the same bits
    n = 48
    d = _t(rng.uniform(0, 5, n), F32)
    e = _t(rng.uniform(0, 5, n - 1), F32)
    whole = bidiagonal_svdvals(d, e)
    for chunk in (1, 7, 16):
        assert torch.equal(bidiagonal_svdvals(d, e, chunk_sweeps=chunk), whole)
    want = _sigma(to_numpy(d), to_numpy(e))
    assert np.max(np.abs(to_numpy(whole) - want)) / want[0] < 1e-5
    # a sweep cap stops early with the same result whichever the chunking
    capped = bidiagonal_svdvals(d, e, max_sweeps=20)
    assert torch.equal(bidiagonal_svdvals(d, e, max_sweeps=20, chunk_sweeps=3), capped)


# ---- dqds ------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 48, 120])
def test_dqds_random_matches_jax(rng, n):
    d, e = _bidiag(rng, n)
    want = _sigma(d, e)
    got, sweeps = dqds_svdvals(_t(d), _t(e), with_info=True)
    ref, ref_sweeps = jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e), with_info=True)
    # full relative accuracy, every value; the sweep count within 2 % of
    # the JAX package's (XLA:CPU contracts dd * t - tau into an FMA, which
    # can decide a retry shift differently)
    rel = np.max(np.abs(to_numpy(got) - want) / want)
    assert rel < 1e-10, rel
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref), rtol=1e-10)
    assert abs(sweeps - int(ref_sweeps)) <= 0.02 * int(ref_sweeps) + 1, (sweeps, int(ref_sweeps))


def test_dqds_graded_relative_accuracy():
    n = 64
    d, e = np.logspace(0, -12, n), np.logspace(-1, -12, n - 1)
    want = _sigma(d, e)
    got = to_numpy(dqds_svdvals(_t(d), _t(e)))
    ref = np.asarray(jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e)))
    assert np.max(np.abs(got - want) / want) < 1e-11
    assert np.max(np.abs(got - ref) / ref) < 1e-11
    rel_bis = np.max(np.abs(to_numpy(dg.bisect_svdvals(_t(d), _t(e))) - want) / want)
    assert np.max(np.abs(got - want) / want) < rel_bis / 100


def test_dqds_fp32(rng):
    n = 48
    d, e = _bidiag(rng, n, np.float32)
    want = _sigma(d, e)
    got = dqds_svdvals(_t(d, F32), _t(e, F32))
    ref = np.asarray(jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e)))
    assert got.dtype == F32
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(to_numpy(got), ref, rtol=2e-5, atol=1e-5 * want[0])


def test_dqds_two_entry_window():
    d, e = np.array([3.0, 1e-6]), np.array([2.0])
    got, sweeps = dqds_svdvals(_t(d), _t(e), with_info=True)
    _, ref_sweeps = jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e), with_info=True)
    want = _sigma(d, e)
    assert np.max(np.abs(to_numpy(got) - want) / want) < 1e-12
    assert sweeps <= 6 and sweeps == int(ref_sweeps)


def test_dqds_interior_split():
    d = np.concatenate([np.linspace(2, 1, 30), np.linspace(0.5, 0.1, 30)])
    e = np.concatenate([np.linspace(1, 0.5, 29), [1e-200], np.linspace(0.2, 0.1, 29)])
    want = _sigma(d, e)
    got = to_numpy(dqds_svdvals(_t(d), _t(e)))
    ref = np.asarray(jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e)))
    assert np.max(np.abs(got - want) / want) < 1e-10
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_dqds_stall_spectrum_sweeps():
    # the recorded stall-class spectrum (random n = 120, seed 0): LAPACK
    # dlasq2 needs 877 iterations, the JAX package 865; the port's count
    # within 2 % of the JAX package's, at most 900, no safety net
    d, e = _stall_spectrum()
    nets = dg.safety_nets
    got, sweeps, hist = dqds_svdvals(_t(d), _t(e), with_info="debug")
    _, ref_sweeps = jdg.dqds_svdvals(jnp.asarray(d), jnp.asarray(e), with_info=True)
    want = _sigma(d, e)
    assert sweeps <= 900, sweeps
    assert abs(sweeps - int(ref_sweeps)) <= 0.02 * int(ref_sweeps), (sweeps, int(ref_sweeps))
    assert np.max(np.abs(to_numpy(got) - want) / want) < 1e-10
    assert dg.safety_nets == nets
    assert hist.shape == (dg.HIST_BINS,) and int(hist.sum()) <= sweeps


def test_dqds_safety_net_takes_bisection(rng):
    # a sweep cap that stops the run unconverged: the values come from the
    # bisection on the same {d, e}, and the run is counted
    d, e = _bidiag(rng, 16)
    nets = dg.safety_nets
    got, sweeps = dqds_svdvals(_t(d), _t(e), max_sweeps=3, with_info=True)
    assert sweeps == 3 and dg.safety_nets == nets + 1
    assert torch.equal(got, dg.bisect_svdvals(_t(d), _t(e)))


# ---- svdvals(diag=...) -------------------------------------------------------------

@pytest.mark.parametrize("diag", ["qr", "dqds"])
def test_svdvals_diag_end_to_end(rng, diag):
    A = rng.uniform(0, 5, (48, 48)).astype(np.float32)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    got = to_numpy(svdvals(from_numpy(A), diag=diag))
    ref = np.asarray(jax_svdvals(jnp.asarray(A), diag=diag))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5 * want[0])
    # rectangular input through the QR fold
    B = rng.normal(size=(40, 24))
    got = to_numpy(svdvals(from_numpy(B, dtype=F64), diag=diag, block=8))
    np.testing.assert_allclose(got, np.linalg.svd(B, compute_uv=False), rtol=1e-10)


# ---- the kernel each entry launches -------------------------------------------------

@pytest.fixture
def launched(monkeypatch):
    """Send CPU tensors down the wrappers' kernel path and log each launch
    as (kernel, entry, memory instance, dtype) in place of running it; the
    converged driver reports convergence, the dqds loop every eigenvalue
    deflated (hi = -1)."""
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_bidiagonal(d, e, dtypes):
            return True

    def qr_launch(entry, d, *args):
        smem = args[6] if entry == "sweeps" else args[7]
        calls.append(("bidiag_qr", entry, "smem" if smem else "global", d.dtype))
        if entry == "converge":
            args[6][1] = 1  # info: converged

    def dqds_launch(q, *args):
        calls.append(("dqds", "loop", "smem" if args[-1] else "global", q.dtype))
        args[5][0] = -1  # info: hi < 0, every eigenvalue deflated

    for mod in (bidiag_qr, dqds):
        monkeypatch.setattr(mod, "_build", OnCard())
    monkeypatch.setattr(bidiag_qr, "_launch", qr_launch)
    monkeypatch.setattr(dqds, "_launch", dqds_launch)
    return calls


@pytest.mark.parametrize("diag,kernel", [("qr", "bidiag_qr"), ("dqds", "dqds")])
def test_svdvals_diag_takes_the_kernel(launched, rng, diag, kernel):
    # a CUDA-style call runs its diagonalizer's kernel, one launch, and
    # never the plain loop
    loops = dg.plain_loops
    A = from_numpy(rng.uniform(0, 5, (40, 40)))
    s = svdvals(A, diag=diag)
    assert s.shape == (40,)
    assert [c[0] for c in launched] == [kernel]
    assert dg.plain_loops == loops


@pytest.mark.parametrize("n,dtype,memory", [
    (1000, F32, "smem"), (28672, F32, "smem"), (28673, F32, "global"),
    (3840, F64, "smem"), (14208, F64, "smem"), (14209, F64, "global"),
])
def test_qr_memory_instance_by_shape(launched, n, dtype, memory):
    assert bidiag_qr.memory_instance(n, dtype) == memory
    d, e = torch.ones(n, dtype=dtype), torch.zeros(n - 1, dtype=dtype)
    bidiagonal_svdvals(d, e)
    assert launched == [("bidiag_qr", "converge", memory, dtype)]


@pytest.mark.parametrize("n,dtype,memory", [
    (1000, F32, "smem"), (11571, F32, "smem"), (11572, F32, "global"),
    (3840, F64, "smem"), (5785, F64, "smem"), (5786, F64, "global"),
])
def test_dqds_memory_instance_by_shape(launched, n, dtype, memory):
    assert dqds.memory_instance(n, dtype) == memory
    d, e = torch.ones(n, dtype=dtype), torch.full((n - 1,), 0.5, dtype=dtype)
    dqds_svdvals(d, e)
    assert launched == [("dqds", "loop", memory, dtype)]


def test_qr_entries_and_chunks_launch(launched, rng):
    d, e = (_t(x) for x in _bidiag(rng, 64))
    zero_shift_sweep(d, e, 3, 7)
    shifted_sweep(d, e, 0, 63, 0.5)
    diag_reduce_fixed_iter(d, e, 200)
    convergence_threshold(d, e)
    assert launched == [("bidiag_qr", "sweeps", "smem", F64)] * 3 + [
        ("bidiag_qr", "converge", "smem", F64)]
    del launched[:]
    bidiagonal_svdvals(d, e, chunk_sweeps=16)  # converged after the first chunk
    assert launched == [("bidiag_qr", "converge", "smem", F64)]
    with pytest.raises(ValueError, match="shared memory"):
        bidiag_qr.bidiagonal_svdvals(torch.ones(20000, dtype=F64),
                                     torch.zeros(19999, dtype=F64), _memory="smem")


def test_failed_build_raises(monkeypatch):
    # a kernel that does not build raises: no fallback to the plain version
    monkeypatch.setattr(bidiag_qr._build, "check_input", lambda *a, **k: True)

    def load(name, entries):
        raise RuntimeError("nvcc failed on bidiag_qr.cu")

    monkeypatch.setattr(bidiag_qr._build, "load", load)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bidiag_qr.bidiagonal_svdvals(torch.ones(4, dtype=F64), torch.ones(3, dtype=F64))
    monkeypatch.setattr(dqds._build, "check_input", lambda *a, **k: True)
    monkeypatch.setattr(dqds._build, "load", load)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dqds.dqds_svdvals(torch.ones(4, dtype=F32), torch.ones(3, dtype=F32))


def test_build_flags_of_the_diagonalizers():
    # -fmad=false on both sources, in their build key and not in the others'
    assert _build._flags("bidiag_qr")[-1] == "-fmad=false"
    assert _build._flags("dqds")[-1] == "-fmad=false"
    assert "-fmad=false" not in _build._flags("bisect")
    assert _build._source_key("dqds") != _build._source_key("bisect")
