"""The tiled Stage I's two-kernel design on the CPU: the plain versions of
the chain (``models/tiled.chain_plain``: a half-sweep's pivot-block column
through its slabs) and of the apply (``apply_plain``: the history on the
other columns), composed over a half-sweep and over the whole schedule,
against the per-slab plain sequence and the JAX package; the plans and the
route by band (``ops/cuda/tiled_slab``), and the wrappers on CPU tensors.

Tolerance: float64 against the per-slab sequence and the JAX package takes
1e-10 of the matrix's scale (the same reflectors, each column's sums in
another order), as ``test_torch_ladder.py`` does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models import tiled as jax_tiled
from svdsolver_tpu_torch.models import tiled
from svdsolver_tpu_torch.ops.cuda import _build, tiled_slab
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy

F64 = 1e-10


def _close(got, want, scale):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0, atol=F64 * scale)


@pytest.mark.parametrize("n,t", [(32, 8), (64, 16), (48, 16)])
@pytest.mark.parametrize("half", ["qr", "lq"])
def test_chain_and_apply_compose_to_the_slab_sequence(rng, n, t, half):
    # a QR half-sweep (top = pc = t) and an LQ-shaped one (top = 2t, pivots
    # a tile left), on the same float64 matrix: chain + apply against the
    # reference's slab after slab
    A = from_numpy(rng.normal(size=(n, n)), dtype=torch.float64)
    top, pc = (t, t) if half == "qr" else (2 * t, t)
    want = tiled.slab_sweep(tiled._factor_slab)(A.clone(), top, pc, t)
    got = A.clone()
    V, tau = tiled.chain_plain(got, top, pc, t)
    m = (n - top) // t - 1
    assert V.shape == (m + 1, t, 2 * t) and tau.shape == (m + 1, t)
    assert torch.equal(V[0, :, t:], torch.zeros_like(V[0, :, t:]))  # the 1-slab has t rows
    # reflector j (V[s, j]) is zero above its pivot row j and 1 on it
    for s in range(m + 1):
        assert torch.equal(torch.tril(V[s, :, :t], -1), torch.zeros((t, t), dtype=V.dtype))
        assert torch.equal(V[s, torch.arange(t), torch.arange(t)], torch.ones(t, dtype=V.dtype))
    tiled.apply_plain(got, top, pc, t, V, tau)
    _close(got, want, float(A.abs().max()))
    keep = torch.ones(n, dtype=torch.bool)
    keep[top:] = False
    assert torch.equal(got[keep], A[keep])  # rows above the half-sweep untouched


@pytest.mark.parametrize("n,t", [(32, 8), (64, 16)])
def test_sweeps_match_jax_and_the_slab_sequence(rng, n, t):
    # the whole schedule through the chain and the apply, against the JAX
    # package and the per-slab plain version
    A = rng.normal(size=(n, n))
    got = tiled.tile_sweeps(from_numpy(A, dtype=torch.float64), t, tiled.half_sweep_plain,
                            lambda M: M.T)
    want = np.asarray(jax_tiled.dense_to_band_tiled(jnp.asarray(A), band=t))
    _close(got, want, np.abs(A).max())
    _close(got, to_numpy(tiled.dense_to_band_tiled_plain(from_numpy(A, dtype=torch.float64), t)),
           np.abs(A).max())


def test_sweep_wrappers_run_the_plain_versions_on_cpu(rng):
    A = from_numpy(rng.normal(size=(64, 64)), dtype=torch.float64)
    got, want = A.clone(), A.clone()
    before = (tiled_slab.launches_chain, tiled_slab.launches_apply)
    V, tau = tiled_slab.factor_sweep(got, 16, 0, 16)
    tiled_slab.apply_sweep(got, 16, 0, 16, V, tau)
    tiled.half_sweep_plain(want, 16, 0, 16)
    assert torch.equal(got, want)
    assert (tiled_slab.launches_chain, tiled_slab.launches_apply) == before
    with pytest.raises(ValueError, match="whole tiles"):
        tiled_slab.factor_sweep(got, 8, 0, 16)
    with pytest.raises(ValueError, match="whole tiles"):
        tiled_slab.apply_sweep(got, 16, 56, 16, V, tau)


@pytest.mark.parametrize("n,t,want", [
    (3840, 128, "sweeps"), (1024, 64, "sweeps"), (1024, 32, "sweeps"), (200, 8, "sweeps"),
    (40, 40, "sweeps"), (272, 136, "slabs"), (4032, 168, "slabs"), (200, 200, "slabs"),
    (238, 238, "slabs"), (338, 169, "wide"), (512, 256, "wide"), (239, 239, "wide"),
])
def test_tiled_route_by_band(n, t, want):
    # the two-kernel design takes every band up to 128; the first design the
    # wider ones it holds (168 with TS slabs, 238 for one tile); the wide
    # instance every band past those
    assert tiled_slab.tiled_route(n, t, 132) == want


@pytest.mark.parametrize("n,t", [(338, 339), (512, 0), (239, 240)])
def test_tiled_route_refuses_what_neither_design_takes(n, t):
    # no design takes a band outside [1, n]
    with pytest.raises(ValueError, match="outside"):
        tiled_slab.tiled_route(n, t, 132)


@pytest.mark.parametrize("t,rpl", [(1, 1), (16, 1), (17, 2), (32, 2), (64, 4), (100, 8),
                                   (128, 8)])
def test_chain_plan_by_band(t, rpl):
    plan = tiled_slab.chain_plan(t)
    assert plan.rpl == rpl and 16 * plan.rpl >= t
    assert plan.smem == 8 * t + 4 * (t * 32 * rpl + t + t * (t + 1))
    assert plan.smem <= _build.MAX_SMEM - _build.STATIC_SMEM


@pytest.mark.parametrize("t", [0, 129, 168])
def test_chain_plan_refuses_past_its_instances(t):
    with pytest.raises(ValueError, match="chain kernel"):
        tiled_slab.chain_plan(t)


@pytest.mark.parametrize("n,t,want", [
    (3840, 128, (29, 128, 480, 8)), (1024, 64, (8, 120, 128, 4)),
    (1024, 128, (7, 128, 128, 8)), (7680, 128, (32, 236, 512, 8)), (32, 32, (1, 1, 32, 2)),
])
def test_apply_plan_by_shape(n, t, want):
    plan = tiled_slab.apply_plan(n, t, 132)
    assert (plan.width, plan.ctas, plan.threads, plan.rpl) == want
    assert plan.ctas * plan.width >= n - t and plan.threads <= 512
    assert plan.smem == 4 * 2 * t * (plan.width | 1) <= _build.MAX_SMEM - _build.STATIC_SMEM


def test_dense_to_band_tiled_routes_wide_bands_to_the_first_design(monkeypatch):
    # t = 136: no chain instance, so every slab through the first design,
    # (n / t)^2 launches in the reference's order
    calls = []

    class OnCard:
        def __getattr__(self, k):
            return getattr(_build, k)

        @staticmethod
        def check_input(t, name, ndim):
            return True

    monkeypatch.setattr(tiled_slab, "_build", OnCard())
    monkeypatch.setattr(tiled_slab, "_launch",
                        lambda A, top, pc, t, bot, plan: calls.append(("slab", top, pc, bot)))
    monkeypatch.setattr(tiled_slab, "_launch_chain", lambda *a: calls.append(("chain",)))
    monkeypatch.setattr(tiled_slab, "_launch_apply", lambda *a: calls.append(("apply",)))
    monkeypatch.setattr(tiled_slab, "_sms", lambda device: 132)
    tiled_slab.dense_to_band_tiled(torch.zeros((408, 408)), band=136)
    assert calls == [("slab", 0, 0, None), ("slab", 0, 0, 136), ("slab", 0, 0, 272),
                     ("slab", 136, 0, None), ("slab", 136, 0, 272),
                     ("slab", 136, 136, None), ("slab", 136, 136, 272),
                     ("slab", 272, 136, None), ("slab", 272, 272, None)]
