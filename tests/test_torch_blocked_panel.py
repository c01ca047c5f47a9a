"""K1's blocked panel (b > 256) held to the JAX package on the CPU.

``panel_qr_blocked_plain`` (sub-panels by the column loop, the block
updates and T's compact-WY merge in torch ops) factors a panel; its
``(I - V T V^T)^T`` on the trailing columns and its R columns give the
updated matrix that the JAX package's panel step (``_panel_qr_step``,
the XLA path) returns.  The card's host loop of the same order
(``panel_qr_blocked``) runs here with its launches emulated under both
designs of its products: ``svdt_panel_update`` / ``svdt_panel_merge``
and the first design's product kernel, each one's arithmetic on the raw
pointers it is given (numpy), each sub-panel by the plain column loop
into the views it is given.  ``update_plan`` is held at every sub-panel
of the card's blocked panels and Stage I shapes.
"""

import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import as_strided

from svdsolver_tpu.models.two_stage import _panel_qr_step
from svdsolver_tpu_torch.ops.cuda import _build, panel_qr, tiled_slab
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

# the updated matrix against the JAX step: both float32 Householder QR of
# the same panel, sums over m (up to 1024) in other orders; entry by entry
# within 1e-4 max|A| (TOL_K1 of chip_smoke.py)
TOL_STEP = 1e-4
TOL_Q = 1e-5  # |Q^T Q - I| and |Q R - P|_F / |P|_F in float64 from the outputs


@pytest.fixture(autouse=True)
def one_thread():
    """The column loops here are thousands of small torch ops: one thread
    each (under several test workers, a pool a worker oversubscribes the
    cores and each op waits on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _updated(A, c0, r_off, b, nb):
    """The port's panel step: the blocked plain panel of A's columns [c0,
    c0 + b), its block reflector on A, the panel columns replaced by R."""
    At = from_numpy(A)
    Pt = At[:, c0:c0 + b].T.contiguous()
    Rt, Vt, Tt = panel_qr.panel_qr_blocked_plain(Pt, r_off, nb)
    out = At - Vt.T @ (Tt @ (Vt @ At))
    out[:, c0:c0 + b] = Rt.T
    return to_numpy(out), (Pt, Rt, Vt, Tt)


def _q_checks(Pt, Rt, Vt, Tt):
    m = Pt.shape[1]
    V, T = Vt.double().T, Tt.double().T
    eye = torch.eye(m, dtype=torch.float64)
    Q = eye - V @ T @ V.T
    orth = float((Q.T @ Q - eye).abs().max())
    P = Pt.double().T
    rebuild = float(torch.linalg.norm(Q @ Rt.double().T - P) / torch.linalg.norm(P))
    return orth, rebuild


@pytest.mark.parametrize("shape,b,m,n,c0,r_off", [
    ("QR", 320, 1024, 704, 0, 0),
    ("QR", 384, 896, 896, 128, 128),
    ("LQ", 320, 1024, 1024, 0, 320),  # A.T with r_off = c0 + b: the LQ row step
    ("LQ", 384, 1024, 1024, 128, 512),
    ("QR", 384, 640, 768, 0, 448),  # pivots 448..831: the last 192 past m
])
def test_blocked_plain_matches_the_jax_panel_step(shape, b, m, n, c0, r_off):
    A = np.random.default_rng(b + m + r_off).uniform(0, 5, (m, n)).astype(np.float32)
    got, outs = _updated(A, c0, r_off, b, panel_qr.BLOCK_NB)
    want = np.asarray(_panel_qr_step(jnp.asarray(A), c0, r_off, b))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_STEP * float(np.abs(A).max()))
    orth, rebuild = _q_checks(*outs)
    assert orth <= TOL_Q and rebuild <= TOL_Q
    live = max(0, min(b, m - r_off))
    Vt, Tt = outs[2], outs[3]
    assert bool((Vt[live:] == 0).all()) and bool((Tt[live:] == 0).all())


@pytest.mark.parametrize("b,m,r_off,nb", [
    (320, 1024, 0, 64), (384, 1024, 640, 64), (300, 900, 400, 64), (384, 768, 0, 32),
    (257, 1024, 0, 64)])
def test_blocked_plain_agrees_with_the_column_loop(b, m, r_off, nb):
    # T is unique for given V, so the blocked merge rebuilds the column
    # loop's T; float32 sums in other orders, within TOL_STEP of each
    # output's scale (the last reflectors of a panel whose pivots end near
    # m act on tails of a few entries, which take the orders' rounding)
    Pt = from_numpy(np.random.default_rng(b + nb).normal(size=(b, m)).astype(np.float32))
    got = panel_qr.panel_qr_blocked_plain(Pt, r_off, nb)
    want = panel_qr.panel_qr_plain(Pt, r_off)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_STEP * float(w.abs().max()))


def _view(ptr, shape, strides):
    base = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=(1,))
    return as_strided(base, shape=shape, strides=tuple(4 * s for s in strides))


def _emulated_gemm(log):
    """svdt_panel_gemm's arithmetic on raw CPU pointers (float64 sums)."""
    def gemm(stream, M, N, K, a, b, c, alpha=1.0, beta=0.0, splits=1):
        pa, pa2, a_si, a_sk, a_split = a
        top = min(M, a_split)
        A = np.zeros((M, K))
        A[:top] = _view(pa, (top, K), (a_si, a_sk))
        if M > top:
            A[top:] = _view((pa2 or pa) + 4 * top * a_si, (M - top, K), (a_si, a_sk))
        B = _view(b[0], (K, N), b[1:])
        chunk = -(-K // splits)
        for z in range(splits):
            C = _view(c[0] + 4 * z * c[3], (M, N), c[1:3])
            y = alpha * (A[:, z * chunk:(z + 1) * chunk] @ B[z * chunk:(z + 1) * chunk])
            C[...] = y + beta * C if beta else y
        log.append((M, N, K, splits))
    return gemm


def _emulated_sum(log):
    """svdt_panel_sum on raw CPU pointers: the splits added in order."""
    def add(stream, parts, splits, count, out, split, out2):
        x = _view(parts, (splits, count), (count, 1))
        total = x[0].copy()
        for z in range(1, splits):
            total += x[z]
        if split:
            _view(out, (split,), (1,))[...] = total[:split]
        _view(out2, (count - split,), (1,))[...] = total[split:]
        log.append((splits, count))
    return add


def _emulated_update(log):
    """svdt_panel_update's arithmetic on raw CPU pointers (float64 sums):
    the Gram's rows from V (above the sub-panel) and W (below it), split
    by the plan, its V rows to ``above``, W's rows below updated."""
    def update(stream, ptrs, shape, plan, tma):
        W, Vt, Tt, above = ptrs
        b, m, r0, r1, p0 = shape
        k, rest, K = r1 - r0, b - r1, m - p0
        assert plan == panel_qr.update_plan(b, m, r0, r1, p0, 132)
        assert tma == (m % 4 == 0)
        X = np.concatenate([_view(Vt + 4 * p0, (r0, K), (m, 1)),
                            _view(W + 4 * (r1 * m + p0), (rest, K), (m, 1))])
        Vk = _view(Vt + 4 * (r0 * m + p0), (k, K), (m, 1)).astype(np.float64)
        G = np.zeros((r0 + rest, k))
        for z in range(plan.splits):
            cols = slice(z * plan.chunk, (z + 1) * plan.chunk)
            G += X[:, cols] @ Vk[:, cols].T
        if r0:
            _view(above, (r0, k), (k, 1))[...] = G[:r0]
        if rest:
            Tk = _view(Tt + 4 * (r0 * b + r0), (k, k), (1, b))  # T_k(c, j) = Tt[r0 + j, r0 + c]
            Wv = _view(W + 4 * (r1 * m + p0), (rest, K), (m, 1))
            Wv[...] = Wv - (G[r0:] @ Tk) @ Vk
        log.append(("update", r0, r1, plan.splits))
    return update


def _emulated_merge(log):
    """svdt_panel_merge on raw CPU pointers: T's block row from the Gram's
    V rows at address G."""
    def merge(stream, G, Tt, r0, r1):
        k = r1 - r0
        Gv = _view(G, (r0, k), (k, 1)).astype(np.float64)
        T = Tt.numpy()
        T[r0:r1, :r0] = -(T[r0:r1, r0:r1] @ (Gv.T @ T[:r0, :r0]))
        log.append(("merge", r0, r1))
    return merge


class StandIn:
    """A stream for the host loop on CPU tensors."""

    def wait_stream(self, other):
        pass


def _leaf(Pt, r_off, plan, out):
    for o, x in zip(out, panel_qr.panel_qr_plain(Pt, r_off)):
        o.copy_(x)
    return out


@pytest.mark.parametrize("design", ["gemm", "cluster"])
@pytest.mark.parametrize("b,m,r_off", [(320, 1024, 0), (384, 1024, 640), (300, 900, 400),
                                       (512, 1024, 768), (384, 768, 0)])
def test_blocked_loop_with_emulated_launches(monkeypatch, b, m, r_off, design):
    # the card's host loop: pointers, strides, splits and the Gram's two row
    # sources, on CPU tensors; against the plain blocked order
    log = []
    monkeypatch.setattr(panel_qr, "_launch", _leaf)
    monkeypatch.setattr(panel_qr, "_launch_gemm", _emulated_gemm(log))
    monkeypatch.setattr(panel_qr, "_launch_sum", _emulated_sum(log))
    monkeypatch.setattr(panel_qr, "_launch_update", _emulated_update(log))
    monkeypatch.setattr(panel_qr, "_launch_merge", _emulated_merge(log))
    monkeypatch.setattr(panel_qr, "_streams", lambda device: (StandIn(), StandIn()))
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    Pt = from_numpy(np.random.default_rng(b).normal(size=(b, m)).astype(np.float32))
    names = ("launches", "launches_update", "launches_merge", "launches_update_gemm",
             "launches_merge_gemm")
    before = [getattr(panel_qr, name) for name in names]
    plan = panel_qr.block_plan(b, m)
    got = panel_qr.panel_qr_blocked(Pt, r_off, plan, _design=design)
    want = panel_qr.panel_qr_blocked_plain(Pt, r_off, plan.nb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    # sub-panels with a pivot below m have products; the first no merge.
    # The cluster design: one update (the last sub-panel's only the Gram's
    # rows above it) and one merge a sub-panel; the first design: the Gram
    # and its sum, then Z and the update where rows lie below
    live = [r0 for r0 in range(0, b, plan.nb) if r_off + r0 < m]
    if design == "cluster":
        counts = (plan.panels, len(live), sum(r0 > 0 for r0 in live), 0, 0)
    else:
        counts = (plan.panels, 0, 0, sum(2 + 2 * (r0 + plan.nb < b) for r0 in live),
                  2 * sum(r0 > 0 for r0 in live))
    assert tuple(getattr(panel_qr, name) - x for name, x in zip(names, before)) == counts
    assert len(log) == sum(counts[1:])
    if design == "cluster":
        assert [e[1] for e in log if e[0] == "update"] == live
        assert [e[1] for e in log if e[0] == "merge"] == [r0 for r0 in live if r0]
    else:
        assert all(x >= 1 for entry in log for x in entry)


WIDE_K1 = ((257, 1024, 0), (384, 2048, 0), (512, 2048, 0), (512, 2048, 1792),
           (1024, 1024, 0), (1536, 1536, 0))


@pytest.mark.parametrize("shapes", [
    *[("panel", shape) for shape in WIDE_K1],
    ("stage1", (2048, 512)), ("stage1", (3840, 512)), ("stage1", (8192, 512))],
    ids=lambda x: str(x))
def test_update_plan_at_every_sub_panel(shapes):
    # svdt_panel_update's plan at every sub-panel with an update: one
    # cluster a 64-row block, the first design's splits up to 16 (its own
    # wherever they are at most 16), every CTA's boxes counted, the shared
    # memory within the card's, the spill instance exactly where the boxes
    # of both slices do not fit
    kind, shape = shapes
    if kind == "panel":
        b, m, r_off = shape
        panels = [(m, r_off)]
    else:
        n, b = shape
        panels = sorted(set(panel_qr.stage1_panels(n, b)))
    nb, box = panel_qr.BLOCK_NB, panel_qr.UPDATE_BOX
    limit = _build.MAX_SMEM - _build.STATIC_SMEM
    slot = 2 * nb * box * 4
    spilled = 0
    for m, r_off in panels:
        for r0 in range(0, b, nb):
            r1, p0 = min(b, r0 + nb), r_off + r0
            if p0 >= m:
                continue
            k, K = r1 - r0, m - p0
            plan = panel_qr.update_plan(b, m, r0, r1, p0, 132)
            first = panel_qr._gram_splits(b - k, k, K, 132)
            assert plan.splits == min(first, panel_qr.MAX_CLUSTER)
            assert plan.chunk == -(-K // plan.splits)
            assert plan.clusters == r0 // nb + -(-(b - r1) // nb)
            boxes = 0
            for z in range(plan.splits):  # CTA z's columns [s, e), boxes from s rounded down
                s, e = p0 + z * plan.chunk, p0 + min(K, (z + 1) * plan.chunk)
                if e > s:
                    boxes = max(boxes, -(-(-(-e // 4) * 4 - s // 4 * 4) // box))
            assert plan.boxes == boxes >= 1
            assert plan.smem == panel_qr.UPDATE_FIXED + plan.stages * slot <= limit
            fits = panel_qr.UPDATE_FIXED + plan.boxes * slot <= limit
            assert plan.spill == (not fits)
            assert plan.stages == (plan.boxes if fits else (limit - panel_qr.UPDATE_FIXED) // slot)
            spilled += plan.spill
    assert (spilled > 0) == (shapes == ("stage1", (8192, 512)))


class FailingLibrary:
    """The products' library with every launch refused (cudaError_t 2)."""

    def __init__(self, fail):
        self.fail = fail

    def svdt_panel_update(self, *args):
        return 2 if "update" in self.fail else 0

    def svdt_panel_merge(self, *args):
        return 2 if "merge" in self.fail else 0


@pytest.mark.parametrize("fail", ["update", "merge"])
def test_failed_product_launch_raises(monkeypatch, fail):
    # a refused launch raises, with no plain version to fall back to
    class Stream(StandIn):
        device, cuda_stream = None, 0

    def refuse(*a, **k):
        raise AssertionError("a plain version was taken")

    def leaf(Pt, r_off, plan, out):
        for o in out:
            o.zero_()
        return out

    monkeypatch.setattr(panel_qr, "_launch", leaf)
    monkeypatch.setattr(panel_qr, "_products", lambda: FailingLibrary(fail))
    monkeypatch.setattr(panel_qr, "_streams", lambda device: (Stream(), Stream()))
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for name in ("panel_qr_plain", "panel_qr_blocked_plain", "update_plain", "merge_plain",
                 "merge_gram_plain"):
        monkeypatch.setattr(panel_qr, name, refuse)
    before = (panel_qr.launches_update, panel_qr.launches_merge)
    Pt = torch.zeros((320, 1024))
    with pytest.raises(RuntimeError, match=f"panel_{fail} launch failed"):
        panel_qr.panel_qr_blocked(Pt, 0, panel_qr.block_plan(320, 1024))
    # the first merge follows the second sub-panel's update
    assert (panel_qr.launches_update - before[0], panel_qr.launches_merge - before[1]) == (
        (0, 0) if fail == "update" else (2, 0))


@pytest.mark.parametrize("n, b, segments", [(96, 8, None), (80, 16, 2), (64, 16, 1)])
def test_stage1_panels_are_the_panels_the_stage1_factors(monkeypatch, n, b, segments):
    # stage1_panels (the launch counts of chip_smoke's phase_wide and the
    # plan test above) lists the (m, r_off) of every panel the fused Stage I
    # hands the kernel, in order, and the recorded reflectors keep their rows
    factored, kernel = [], panel_qr.panel_qr

    def record(Pt, r_off, *args, **kwargs):
        factored.append((Pt.shape[1], r_off))
        return kernel(Pt, r_off, *args, **kwargs)

    A = torch.from_numpy(np.random.default_rng(7).normal(size=(n, n)).astype(np.float32))
    want = panel_qr.dense_to_band_rec_fused(A, band=b, segments=segments)
    monkeypatch.setattr(panel_qr, "panel_qr", record)
    got = panel_qr.dense_to_band_rec_fused(A, band=b, segments=segments)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if segments is None:
        assert factored == list(panel_qr.stage1_panels(n, b))
    pairs = list(panel_qr.stage1_pairs(n, b, segments))
    assert factored == [x for s0, c in pairs for x in ((n - s0, c), (n - s0, c + b))]
    assert len(pairs) == n // b


def test_source_constants(monkeypatch, tmp_path):
    # _build.constants reads a source's integer constexprs: literals,
    # earlier names and the four operations; it skips what it cannot
    # evaluate as C++ would (a name it does not know, a float, a negative
    # division)
    (tmp_path / "k.cu").write_text(
        "constexpr int kA = 36;  // a comment\n"
        "  constexpr int kB = 2 * (kA + 4) - 1;\n"
        "constexpr int kC = kB / 3;\n"
        "constexpr int kD = kUnknown * 2;\n"
        "constexpr float kE = 1.5f;\n"
        "constexpr int kF = (0 - 7) / 2;\n"
        "int kG = 3;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.constants("k") == {"kA": 36, "kB": 79, "kC": 26}


def test_update_layout_is_the_kernel_source():
    # the host's plan takes svdt_panel_update's layout from its source: box
    # columns, slots, the fixed arrays (the partial Gram, G and Z^T at row
    # stride kLd4, T_k at kLdP, 128 bytes of alignment) and the dynamic
    # shared memory the entry accepts, the card's less the static room
    c = _build.constants("panel_products")
    assert (panel_qr.UPDATE_BOX, panel_qr.UPDATE_MAX_STAGES) == (c["kBox"], c["kMaxStages"])
    assert c["kRows"] == panel_qr.BLOCK_NB and c["kBoxFloats"] == c["kRows"] * c["kBox"]
    assert panel_qr.UPDATE_FIXED == c["kFixedBytes"] == 4 * (
        3 * c["kRows"] * c["kLd4"] + c["kRows"] * c["kLdP"]) + 128
    assert c["kMaxDynSmem"] == _build.MAX_SMEM - _build.STATIC_SMEM
    assert c["kBox"] % 4 == 0 and c["kMaxCluster"] == panel_qr.MAX_CLUSTER
