"""K1's blocked panel (b > 256) held to the JAX package on the CPU.

``panel_qr_blocked_plain`` (sub-panels by the column loop, the block
updates and T's compact-WY merge in torch ops) factors a panel; its
``(I - V T V^T)^T`` on the trailing columns and its R columns give the
updated matrix that the JAX package's panel step (``_panel_qr_step``,
the XLA path) returns.  The card's host loop of the same order
(``panel_qr_blocked``) runs here with its launches emulated: the product
kernel's arithmetic on the raw pointers it is given (numpy), each
sub-panel by the plain column loop into the views it is given.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import as_strided

from svdsolver_tpu.models.two_stage import _panel_qr_step
from svdsolver_tpu_torch.ops.cuda import panel_qr, tiled_slab
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


class StandIn:
    """A stream for the host loop on CPU tensors."""

    def wait_stream(self, other):
        pass


def _leaf(Pt, r_off, plan, out):
    for o, x in zip(out, panel_qr.panel_qr_plain(Pt, r_off)):
        o.copy_(x)
    return out


@pytest.mark.parametrize("b,m,r_off", [(320, 1024, 0), (384, 1024, 640), (300, 900, 400),
                                       (512, 1024, 768), (384, 768, 0)])
def test_blocked_loop_with_emulated_launches(monkeypatch, b, m, r_off):
    # the card's host loop: pointers, strides, splits and the Gram's two row
    # sources, on CPU tensors; against the plain blocked order
    log = []
    monkeypatch.setattr(panel_qr, "_launch", _leaf)
    monkeypatch.setattr(panel_qr, "_launch_gemm", _emulated_gemm(log))
    monkeypatch.setattr(panel_qr, "_launch_sum", _emulated_sum(log))
    monkeypatch.setattr(panel_qr, "_streams", lambda device: (StandIn(), StandIn()))
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    Pt = from_numpy(np.random.default_rng(b).normal(size=(b, m)).astype(np.float32))
    before = (panel_qr.launches, panel_qr.launches_update, panel_qr.launches_merge)
    plan = panel_qr.block_plan(b, m)
    got = panel_qr.panel_qr_blocked(Pt, r_off, plan)
    want = panel_qr.panel_qr_blocked_plain(Pt, r_off, plan.nb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    # sub-panels with a pivot below m have products; the first no merge,
    # the last no update
    live = [r0 for r0 in range(0, b, plan.nb) if r_off + r0 < m]
    updates = sum(2 + 2 * (r0 + plan.nb < b) for r0 in live)
    merges = 2 * sum(r0 > 0 for r0 in live)
    assert panel_qr.launches - before[0] == plan.panels
    assert (panel_qr.launches_update - before[1], panel_qr.launches_merge - before[2]) == (
        updates, merges)
    assert len(log) == updates + merges
    assert all(x >= 1 for entry in log for x in entry)
