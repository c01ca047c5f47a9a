"""The wide tiled chain's cluster design on the CPU: its plan
(``ops/cuda/tiled_slab.wide_chain_plan``: CTAs, columns a warp, rows a
lane, ring slots, shared memory) at every band it takes and the bands it
refuses, the history layout it shares with the apply, and the wide entry
points on CPU tensors (their plain versions) against the JAX package.

The kernel itself (``csrc/tiled_wide_cluster.cu``) runs only on the card:
``tests/test_torch_cuda.py`` holds it ``torch.equal`` to the device-memory
chain, and ``chip_smoke.check_wide_tiled`` at the main path's shapes.

Tolerance: float64 against the JAX package takes 1e-10 of the matrix's
scale (the same reflectors, each column's sums in another order), as
``test_torch_tiled_sweep.py`` does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import tiled as jax_tiled
from svdsolver_tpu_torch.models import tiled
from svdsolver_tpu_torch.ops.cuda import _build, tiled_slab
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = 1e-10


@pytest.mark.parametrize("t", [169, 192, 256, 384, 512])
def test_wide_chain_plan_takes_the_wide_bands(t):
    plan = tiled_slab.wide_chain_plan(t)
    width = plan.warps * plan.cols
    # its CTAs cover the t columns, none of them idle, one cluster
    assert plan.ctas * width >= t > (plan.ctas - 1) * width
    assert plan.ctas <= tiled_slab.WIDE_CHAIN_MAX_CTAS
    assert plan.smem <= _build.MAX_SMEM - _build.STATIC_SMEM
    # a lane's rows hold the 2t-row stack; the columns a warp fit the
    # instance's registers
    assert 32 * plan.rpl >= 2 * t and plan.cols in tiled_slab.WIDE_CHAIN_INSTANCES[plan.rpl]
    assert (plan.warps, plan.cols, plan.slots) == (16, 2, 8)
    assert plan.rpl == (16 if t <= 256 else 32)


@pytest.mark.parametrize("t,want", [(256, 50560), (512, 100736), (192, 42112)])
def test_wide_chain_plan_counts_the_kernels_bytes(t, want):
    # the kernel's layout a CTA: 5 slots floats of barriers and wait counts
    # rounded up to 32 floats, the slots (32 rpl + 4 floats), the staging
    # tile (t x (16 cols + 1) floats)
    plan = tiled_slab.wide_chain_plan(t)
    head = (5 * plan.slots + 31) // 32 * 32
    assert plan.smem == 4 * (head + plan.slots * (32 * plan.rpl + 4)
                             + t * (16 * plan.cols + 1)) == want


@pytest.mark.parametrize("t,kw,match", [
    (513, {}, "bands of 1 to 512"), (640, {}, "bands of 1 to 512"),
    (1024, {}, "bands of 1 to 512"), (0, {}, "bands of 1 to 512"),
    (384, {"cols": 4}, "register budget"), (192, {"cols": 3}, "register budget"),
    (512, {"cols": 1}, "register budget"), (256, {"slots": 1}, "2 slots"),
    (512, {"slots": 64}, "shared-memory limit")])
def test_wide_chain_plan_refuses(t, kw, match):
    with pytest.raises(ValueError, match=match):
        tiled_slab.wide_chain_plan(t, **kw)


@pytest.mark.parametrize("cols,ctas", [(1, 16), (2, 8), (4, 4)])
def test_wide_chain_plan_by_columns_a_warp(cols, ctas):
    # the other instances at rpl 16 (the choices timed on the card)
    plan = tiled_slab.wide_chain_plan(256, cols=cols)
    assert (plan.ctas, plan.cols, plan.rpl) == (ctas, cols, 16)


def test_history_fits_every_instance():
    # the history the apply reads (wide_vld(t) floats a reflector: the
    # apply's 32 rpl) holds a TS slab's 2t rows and fits the cluster
    # chain's slots (32 rpl of its own instance): the kernel writes it whole
    for t in range(1, tiled_slab.WIDE_CHAIN_MAX + 1):
        plan = tiled_slab.wide_chain_plan(t)
        assert 2 * t <= tiled_slab.wide_vld(t) <= 32 * plan.rpl


def _wide_sweep(M, top, pc, t):
    V, tau = tiled_slab.wide_chain(M, top, pc, t)
    return tiled_slab.wide_apply(M, top, pc, t, V, tau)


@pytest.mark.parametrize("n,t", [(384, 192), (68, 34)])
def test_wide_entries_on_cpu_match_jax(rng, n, t):
    # the whole schedule through wide_chain and wide_apply on CPU tensors
    # (chain_plain, apply_plain), against the JAX package's tiled Stage I
    A = rng.normal(size=(n, n))
    before = (tiled_slab.launches_wide_chain, tiled_slab.launches_wide_chain_dev)
    got = tiled.tile_sweeps(from_numpy(A, dtype=torch.float64), t, _wide_sweep, lambda M: M.T)
    assert (tiled_slab.launches_wide_chain, tiled_slab.launches_wide_chain_dev) == before
    want = np.asarray(jax_tiled.dense_to_band_tiled(jnp.asarray(A), band=t))
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=F64 * np.abs(A).max())


def test_wide_chain_on_cpu_is_the_plain_chain(rng):
    # a CPU tensor runs chain_plain whichever chain the card would take
    A = from_numpy(rng.normal(size=(96, 96)), dtype=torch.float64)
    want = A.clone()
    hist = tiled.chain_plain(want, 32, 0, 32)
    for device_block in (False, True):
        got = A.clone()
        got_hist = tiled_slab.wide_chain(got, 32, 0, 32, _device_block=device_block)
        assert torch.equal(got, want)
        assert all(torch.equal(g, w) for g, w in zip(got_hist, hist))
    with pytest.raises(ValueError, match="whole tiles"):
        tiled_slab.wide_chain(A.clone(), 40, 0, 32)
