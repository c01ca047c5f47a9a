"""The recording wavefront chase (plain, and its wrapper on CPU tensors) held
to the sequential recording chase and to the JAX package; the panel
kernel's cluster plan at every panel shape of the main paths; and the
chase routing predicates with the main paths that follow them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import (
    band_to_bidiagonal_accum as jax_accum,
    dense_to_band as jax_dense_to_band,
)
from svdsolver_tpu_torch.models import svd as svd_mod
from svdsolver_tpu_torch.models import two_stage, vectors
from svdsolver_tpu_torch.models.svd import _auto_block
from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_wave, panel_qr
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


def _band(rng, n, b, dtype=torch.float32):
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(2, 1), (40, 8), (70, 8), (100, 32), (97, 32), (130, 64), (64, 64)])
def test_plain_recording_wavefront_bit_equal(rng, dtype, n, b):
    # every pair of the wavefront order computes what the sequential one
    # does: (d, e) and the four records bit for bit (n % b != 0 included)
    Ab = _band(rng, n, b, dtype)
    got = two_stage.band_to_bidiagonal_wavefront(Ab, band=b, record=True)
    want = two_stage.band_to_bidiagonal_accum(Ab, band=b)
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(to_numpy(g), to_numpy(w), err_msg=name)


def test_recording_wavefront_rejects():
    with pytest.raises(ValueError, match="defer_left"):
        two_stage.band_to_bidiagonal_wavefront(torch.eye(8), band=2, record=True,
                                               defer_left=True)
    for fn in (lambda A: two_stage.band_to_bidiagonal_wavefront(A, band=1, record=True),
               lambda A: band_chase_wave.band_to_bidiagonal_wave_accum(A, band=1)):
        with pytest.raises(ValueError, match="n >= 2"):
            fn(torch.ones(1, 1))
    with pytest.raises(ValueError, match="band"):
        band_chase_wave.band_to_bidiagonal_wave_accum(torch.zeros(40, 40), band=300)


@pytest.mark.parametrize("n,b", [(64, 16), (56, 8)])
def test_wave_accum_wrapper_on_cpu(rng, n, b):
    # the wrapper on a CPU tensor: records rebuild the band with orthogonal
    # L, R, and sigma match the JAX package's recording chase on the same
    # numpy band within 2e-5 relative + 1e-5 sigma_max (fp32, other
    # reduction order)
    A = rng.normal(size=(n, n)).astype(np.float32)
    Ab = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))
    d, e, VL, TL, VR, TR = band_chase_wave.band_to_bidiagonal_wave_accum(from_numpy(Ab), band=b)
    At = from_numpy(Ab)
    eye = torch.eye(n)
    L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
    R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
    B = torch.diag(d) + torch.diag(e, 1)
    scale = float(At.abs().max())
    assert float((L @ B @ R.T - At).abs().max()) <= 1e-5 * scale
    assert float((L.T @ L - eye).abs().max()) <= 1e-5
    assert float((R.T @ R - eye).abs().max()) <= 1e-5
    dj, ej = (np.asarray(t) for t in jax_accum(jnp.asarray(Ab), band=b)[:2])

    def sigma(d, e):
        Bd = np.diag(np.asarray(d, np.float64)) + np.diag(np.asarray(e, np.float64), 1)
        return np.linalg.svd(Bd, compute_uv=False)

    want = sigma(dj, ej)
    np.testing.assert_allclose(sigma(to_numpy(d), to_numpy(e)), want, rtol=2e-5,
                               atol=1e-5 * want[0])


def _panel_shapes(n):
    """Every (b, m) panel the fused Stage I gives the kernel for an (n, n)
    input of the main paths: QR and LQ panels of each segment."""
    b = _auto_block(n)
    npad = -(-n // b) * b
    bounds = two_stage.segment_bounds(npad // b, panel_qr._auto_segments(npad, b))
    return b, [(b, npad - k * b) for k in bounds[:-1]]


@pytest.mark.parametrize("n", [1000, 2048, 3840, 7680])
def test_cluster_plan_main_path_shapes(n):
    b, shapes = _panel_shapes(n)
    assert shapes and b in (64, 128)
    for b_, m in shapes:
        plan = panel_qr.cluster_plan(b_, m)
        assert 1 <= plan.ctas <= 16
        assert plan.smem <= _build.MAX_SMEM
        assert plan.ctas * plan.width >= m and plan.width % 4 == 0
        assert plan.smem_cols % 4 == 0 and plan.ld >= plan.smem_cols
        assert plan.ld % 32 == plan.groups % 32  # a warp's rows on distinct banks
        assert plan.ctas * plan.tcols >= b_
        # the large-panel route only for the first segment at 7680
        assert plan.spill == (n == 7680 and m == 7680), (b_, m)
        if plan.spill:
            assert plan.width - plan.smem_cols <= plan.smem_cols


def test_cluster_plan_sizes():
    assert panel_qr.cluster_plan(128, 3840) == (16, 240, 240, 264, 8, 9, 8, 149064)
    assert panel_qr.cluster_plan(128, 1024).ctas == 8
    assert panel_qr.cluster_plan(64, 1024).ctas == 4
    assert panel_qr.cluster_plan(16, 96).ctas == 1
    assert panel_qr.cluster_plan(128, 3840, ctas=8).spill


def test_cluster_plan_limits():
    assert panel_qr.cluster_plan(128, 12544).spill
    # no cap on the device-memory share: the limit is where v and the
    # exchange arrays leave the slab no shared memory
    assert panel_qr.cluster_plan(128, 861000).spill
    with pytest.raises(ValueError, match="limit"):
        panel_qr.cluster_plan(128, 862000)
    # past b = 256 the cluster kernel takes no panel: block_plan cuts it
    # into sub-panels of the narrow plans
    with pytest.raises(ValueError, match="block_plan"):
        panel_qr.cluster_plan(257, 1024)
    with pytest.raises(ValueError, match="limit"):
        panel_qr.cluster_plan(20000, 20000)
    with pytest.raises(ValueError, match="b=0"):
        panel_qr.cluster_plan(0, 1024)
    with pytest.raises(ValueError, match="m="):
        panel_qr.cluster_plan(8, 0)
    with pytest.raises(ValueError, match="cluster"):
        panel_qr.cluster_plan(8, 64, ctas=17)


@pytest.mark.parametrize("m", [12545, 15360, 23040])
def test_cluster_plan_past_the_old_cap(m):
    """Stage I's first panel at n past 12,544: most of a CTA's columns in
    device memory (its own columns of Rt), the slab's quads whole."""
    plan = panel_qr.cluster_plan(128, m)
    assert plan.ctas == 16 and plan.spill
    assert plan.ctas * plan.width >= m and plan.width % 4 == 0
    assert plan.smem_cols % 4 == 0 and plan.width - plan.smem_cols > plan.smem_cols
    assert plan.ld % 32 == plan.groups % 32 and plan.smem <= _build.MAX_SMEM


# (n, band) -> routed to the wavefront: the table of wave_lanes_needed's
# docstring, measured on the card (the sequential chase on its staged TMA
# design): the main-path shapes of the route table and the lane counts on
# either side of the boundary at every band measured
ROUTES = {(1024, 64): True, (2048, 128): True, (3840, 128): True, (7680, 128): True,
          (256, 64): False, (384, 64): False, (512, 64): False, (224, 32): False,
          (256, 32): False, (640, 64): False, (704, 64): True, (1024, 128): True,
          (32, 4): False, (44, 4): True, (80, 8): False, (88, 8): True, (96, 12): False,
          (132, 12): True, (160, 16): False, (176, 16): True, (192, 24): False,
          (264, 24): True, (320, 32): False, (352, 32): True, (416, 32): True,
          (384, 48): False, (528, 48): True, (560, 80): True, (480, 96): True,
          (768, 96): True, (784, 112): True, (896, 128): False}


@pytest.mark.parametrize("pred", [band_chase_wave.wave_chase_preferred,
                                  band_chase_wave.wave_chase_accum_preferred])
def test_predicates_match_their_tables(pred):
    for (n, b), wave in ROUTES.items():
        assert pred(n, b) is wave, (n, b)
        doc_row = f"{n} / {b} "
        assert doc_row in band_chase_wave.wave_lanes_needed.__doc__, doc_row
    for n in range(2, 600, 7):
        for b in (8, 32, 64, 96, 128):
            assert isinstance(pred(n, b), bool)
            # where both chases stage their windows by TMA (n a multiple of
            # 4): four lanes up to b = 64, three at 128, two between; two
            # lanes elsewhere
            need = (4 if b <= 64 else 3 if b == 128 else 2) if n % 4 == 0 else 2
            assert pred(n, b) == (two_stage.wave_lanes(n, b) >= need)
    for n, b in ((200, 6), (640, 160), (201, 8)):  # the L2 kernels of both chases
        assert band_chase_wave.wave_lanes_needed(n, b) == 2


def test_main_paths_switch_at_641():
    # the main paths' bands (band by size, n padded to a multiple of it):
    # the sequential chase up to n = 640, the wavefront from 641 on
    for n in range(2, 2600):
        b = _auto_block(n)
        padded = -(-n // b) * b
        for pred in (band_chase_wave.wave_chase_preferred,
                     band_chase_wave.wave_chase_accum_preferred):
            assert pred(padded, b) is (n > 640), (n, padded, b)


@pytest.fixture
def routed(monkeypatch):
    """Send float32 CPU input down the kernels' path (the wrappers run their
    plain versions there) and log which chase entry each call takes."""
    calls = []
    monkeypatch.setattr(svd_mod, "use_kernels", lambda t: True)
    monkeypatch.setattr(vectors, "use_kernels", lambda t: True)
    for mod, name in ((band_chase, "band_to_bidiagonal"),
                      (band_chase, "band_to_bidiagonal_accum"),
                      (band_chase_wave, "band_to_bidiagonal_wave"),
                      (band_chase_wave, "band_to_bidiagonal_wave_accum")):
        fn = getattr(mod, name)

        def logged(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, logged)
    return calls


@pytest.mark.parametrize("n,band,wave", [(200, None, False), (200, 16, True),
                                         (64, None, False)])
def test_main_paths_follow_the_predicates(rng, routed, n, band, wave):
    # n = 200: band 32, padded to 224, two lanes: the sequential chase;
    # band 16 (padded to 208): four lanes, the wavefront; n = 64: one lane
    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32))
    want = np.linalg.svd(to_numpy(A).astype(np.float64), compute_uv=False)
    s = svd_mod.svdvals(A, block=band)
    U, s2, Vh = vectors.svd(A, band=band)
    assert routed == (["band_to_bidiagonal_wave", "band_to_bidiagonal_wave_accum"] if wave
                      else ["band_to_bidiagonal", "band_to_bidiagonal_accum"])
    for got in (s, s2):
        np.testing.assert_allclose(to_numpy(got), want, rtol=2e-5, atol=1e-5 * want[0])
    recon = (U * s2) @ Vh
    assert float((recon - A).abs().max()) <= 1e-4 * want[0]
