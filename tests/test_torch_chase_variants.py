"""The chase variants of the port held to the JAX package and to each other
on CPU: the wavefront schedule and its deferred-left order (plain), the
packed band layout, the two-stage driver, and the kernel wrappers of the
wavefront, staged and packed chases on CPU tensors (their plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.models.two_stage import (
    band_to_bidiagonal_wavefront as jax_wavefront,
    bidiagonalize_two_stage as jax_two_stage,
    dense_to_band as jax_dense_to_band,
)
from svdsolver_tpu_torch import bidiagonalize_two_stage
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.cuda import _build, band_chase, band_chase_vmem, band_chase_wave
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy


def _sigma(d, e):
    B = np.diag(np.asarray(d, np.float64)) + np.diag(np.asarray(e, np.float64), 1)
    return np.linalg.svd(B, compute_uv=False)


def _band(rng, n, b, dtype=torch.float32):
    """An upper band of b superdiagonals with Gaussian entries."""
    A = torch.tensor(rng.normal(size=(n, n)), dtype=dtype)
    return torch.triu(torch.tril(A, b)).contiguous()


def test_wavefront_matches_jax_float64(rng):
    n, b = 48, 8
    A = rng.normal(size=(n, n))
    Ab = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))
    # op by op: jitted, XLA:CPU fuses the rank-1 updates into FMAs, which
    # round once where the port (and the JAX package's own ops) round twice
    with jax.disable_jit():
        dj, ej = jax_wavefront(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_wavefront(from_numpy(Ab, dtype=torch.float64), band=b)
    np.testing.assert_allclose(to_numpy(d), np.asarray(dj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(to_numpy(e), np.asarray(ej), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n,b", [(64, 8), (96, 16)])
def test_wavefront_matches_jax_float32(rng, n, b):
    A = rng.normal(size=(n, n)).astype(np.float32)
    Ab = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))
    dj, _ = jax_wavefront(jnp.asarray(Ab), band=b)
    d, e = two_stage.band_to_bidiagonal_wavefront(from_numpy(Ab), band=b)
    d, e = to_numpy(d), to_numpy(e)
    # d/e diverge elementwise past the leading entries (fp32 reduction order)
    np.testing.assert_allclose(np.abs(d)[:8], np.abs(np.asarray(dj))[:8], rtol=1e-4)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(_sigma(d, e), want, rtol=2e-5, atol=1e-5 * want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(2, 1), (17, 3), (48, 8), (100, 7), (96, 32), (64, 64)])
def test_schedules_bit_equal(rng, dtype, n, b):
    # wavefront and deferred-left orders run the sequential chase's
    # operations on the same data: (d, e) equal bit for bit
    Ab = _band(rng, n, b, dtype)
    d0, e0 = two_stage.band_to_bidiagonal(Ab, band=b)
    for defer_left in (False, True):
        d, e = two_stage.band_to_bidiagonal_wavefront(Ab, band=b, defer_left=defer_left)
        np.testing.assert_array_equal(to_numpy(d), to_numpy(d0))
        np.testing.assert_array_equal(to_numpy(e), to_numpy(e0))


def test_pack_band_layout_and_round_trip(rng):
    n, b = 300, 64  # n not a multiple of 128
    A = _band(rng, n, b)
    P = two_stage.pack_band(A, b)
    Npad = -(-(n + 3 * b + 8) // 128) * 128
    assert P.shape == (Npad, 512) == (two_stage.packed_rows(n, b), two_stage.PACK_WIDTH)
    An, Pn = to_numpy(A), to_numpy(P)
    row, lane = np.meshgrid(np.arange(Npad), np.arange(512), indexing="ij")
    col = 128 * (row // 128) - 128 + lane
    inside = (row < n) & (col >= 0) & (col < n)
    want = np.where(inside, An[np.minimum(row, n - 1), np.clip(col, 0, n - 1)], 0)
    np.testing.assert_array_equal(Pn, want)
    np.testing.assert_array_equal(to_numpy(two_stage.unpack_band(P, n)), An)


def test_pack_band_keeps_the_window_lanes():
    # every entry a pair touches for band <= 128 lies in lanes [1, 511):
    # chase pair (r, c = r + b): rows [r, r + 2b) x [c, c + b) and
    # [r + b, r + 2b) x [c + b, c + 2b); head pair at row i: [i, i + b + 1) x
    # [i + 1, i + 1 + b) and [i + 1, i + b + 1) x [i + b + 1, i + 2b + 1)
    for b in (8, 64, 100, 128):
        for r in range(0, 260):
            c = r + b
            rows, cols = np.meshgrid(np.arange(2 * b), np.arange(2 * b), indexing="ij")
            chase = ~((rows < b) & (cols >= b))
            rows_h, cols_h = np.meshgrid(np.arange(b + 1), np.arange(2 * b), indexing="ij")
            head = ~((rows_h == 0) & (cols_h >= b))
            for r0, c0, R, C, m in ((r, c, rows, cols, chase), (r, r + 1, rows_h, cols_h, head)):
                row, col = (r0 + R)[m], (c0 + C)[m]
                lane = col - 128 * (row // 128) + 128
                assert lane.min() >= 1 and lane.max() < 511, (b, r)


WRAPPERS = [
    ("wavefront", lambda A, b: band_chase.band_to_bidiagonal(A, band=b, wavefront=True),
     two_stage.band_to_bidiagonal_wavefront),
    ("pipelined", lambda A, b: band_chase.band_to_bidiagonal(A, band=b, pipelined=True),
     two_stage.band_to_bidiagonal),
    ("mega", lambda A, b: band_chase.band_to_bidiagonal(A, band=b, mega=True, khops=3),
     two_stage.band_to_bidiagonal),
    ("vmem", band_chase_vmem.band_to_bidiagonal_vmem,
     band_chase_vmem.band_to_bidiagonal_vmem_plain),
    ("wave", band_chase_wave.band_to_bidiagonal_wave,
     band_chase_wave.band_to_bidiagonal_wave_plain),
    ("wave_dl", band_chase_wave.band_to_bidiagonal_wave_dl,
     band_chase_wave.band_to_bidiagonal_wave_dl_plain),
]


@pytest.mark.parametrize("name,wrapper,plain", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_wrappers_on_cpu_are_plain(rng, name, wrapper, plain):
    n, b = 80, 16
    A = rng.normal(size=(n, n)).astype(np.float32)
    Ab = np.asarray(jax_dense_to_band(jnp.asarray(A), band=b))
    d, e = wrapper(from_numpy(Ab), b)
    dp, ep = plain(from_numpy(Ab), band=b)
    np.testing.assert_array_equal(to_numpy(d), to_numpy(dp))
    np.testing.assert_array_equal(to_numpy(e), to_numpy(ep))
    # and every variant is the sequential chase, bit for bit
    ds, es = two_stage.band_to_bidiagonal(from_numpy(Ab), band=b)
    np.testing.assert_array_equal(to_numpy(d), to_numpy(ds))
    np.testing.assert_array_equal(to_numpy(e), to_numpy(es))


@pytest.mark.parametrize("wavefront", [False, True])
def test_two_stage_matches_jax(rng, wavefront):
    n, b = 48, 8
    A = rng.normal(size=(n, n)).astype(np.float32)
    d, e = bidiagonalize_two_stage(from_numpy(A), band=b, wavefront=wavefront)
    dj, ej = jax_two_stage(jnp.asarray(A), band=b, wavefront=wavefront)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    for s in (_sigma(to_numpy(d), to_numpy(e)), _sigma(np.asarray(dj), np.asarray(ej))):
        np.testing.assert_allclose(s, want, rtol=2e-5, atol=1e-5 * want[0])
    np.testing.assert_allclose(np.abs(to_numpy(d))[:8], np.abs(np.asarray(dj))[:8], rtol=1e-4)


def test_wrappers_reject_bad_arguments():
    sq, rect = torch.zeros(40, 40), torch.zeros(40, 30)
    with pytest.raises(ValueError, match="khops"):
        band_chase.band_to_bidiagonal(sq, band=8, mega=True, khops=0)
    with pytest.raises(ValueError, match="band"):
        band_chase.band_to_bidiagonal(sq, band=300, pipelined=True)
    with pytest.raises(ValueError, match="band"):
        band_chase_vmem.band_to_bidiagonal_vmem(sq, band=129)
    with pytest.raises(ValueError, match="band"):
        band_chase_wave.band_to_bidiagonal_wave(sq, band=0)
    with pytest.raises(ValueError, match="band"):
        band_chase.band_to_bidiagonal(sq, band=257, wavefront=True)
    for fn in (lambda A: band_chase.band_to_bidiagonal(A, band=8, pipelined=True),
               lambda A: band_chase.band_to_bidiagonal(A, band=8, wavefront=True),
               lambda A: band_chase_vmem.band_to_bidiagonal_vmem(A, band=8),
               lambda A: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=8)):
        with pytest.raises(ValueError, match="square"):
            fn(rect)
    assert not band_chase_vmem.vmem_chase_supported(3840, 256)
    assert band_chase_vmem.vmem_chase_supported(3840, 128)


def test_staged_khops_fit_shared_memory():
    # 2K + 1 slots of (b + 1) x (b + 4) floats in 227 KB: only K = 1 at b = 128
    assert band_chase.staged_khops(128, 4) == 1
    assert band_chase.staged_khops(64, 3) == 3
    assert band_chase.staged_khops(64, 99) == 5
    assert band_chase.staged_khops(32, 4) == 4


def test_wave_lanes():
    # sweeps three slots apart: ceil(S / 3) lanes, S = nc_of(0) (+1 deferred)
    assert two_stage.wave_lanes(3840, 128) == 10
    assert two_stage.wave_lanes(3840, 128, defer_left=True) == 10
    assert two_stage.wave_lanes(2048, 32) == 21
    assert two_stage.wave_lanes(15360, 32) == 160


def test_build_key_covers_headers(tmp_path, monkeypatch):
    # an edited shared header rebuilds every source (no nvcc needed)
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    keys = {name: _build._source_key(name) for name in ("band_chase", "bisect")}
    assert _build._source_key("band_chase") == keys["band_chase"]
    header = tmp_path / "chase_pair.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, key in keys.items():
        assert _build._source_key(name) != key
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert _build._source_key("bisect") != keys["bisect"]
