"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: these skip on a machine without a CUDA device.  On the
card run ``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
shared conftest imports jax, which the card's machine need not have);
``chip_smoke.py`` holds the kernels to the same checks at the main path's
full shapes.
"""

import numpy as np
import pytest
import torch

from svdsolver_tpu_torch import svd, svdvals
from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors
from svdsolver_tpu_torch.ops.cuda import (
    band_chase,
    band_chase_vmem,
    band_chase_wave,
    bisect,
    panel_qr,
    tridiag_solve,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(586)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_panel_qr_kernel_matches_plain(dev, rng):
    Pt = torch.from_numpy(rng.normal(size=(16, 96)).astype(np.float32)).to(dev)
    for r_off in (0, 90):
        for g, w in zip(panel_qr.panel_qr(Pt, r_off),
                        panel_qr.panel_qr_plain(Pt, r_off)):
            torch.testing.assert_close(g, w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("r_off", [0, 960])
def test_panel_qr_cluster_kernel(dev, rng, r_off):
    # one cluster of 8 CTAs at (128, 1024); at r_off = 960 the last 64
    # pivots lie past m (identity reflectors); two launches bit-identical
    b, m = 128, 1024
    Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).to(dev)
    assert panel_qr.cluster_plan(b, m).ctas == 8
    got = panel_qr.panel_qr(Pt, r_off)
    again = panel_qr.panel_qr(Pt, r_off)
    for g, a, w in zip(got, again, panel_qr.panel_qr_plain(Pt, r_off)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    Rt, Vt, Tt = got
    live = min(b, m - r_off)
    assert torch.equal(Tt[live:], torch.zeros_like(Tt[live:]))
    V, T = Vt.double().T, Tt.double().T
    Q = torch.eye(m, dtype=torch.float64, device=dev) - V @ T @ V.T
    assert float((Q.T @ Q - torch.eye(m, dtype=torch.float64, device=dev)).abs().max()) < 1e-5
    P = Pt.double().T
    assert float(torch.linalg.norm(Q @ Rt.double().T - P) / torch.linalg.norm(P)) < 1e-5


def test_chase_kernel_matches_plain(dev, rng):
    A = torch.from_numpy(rng.normal(size=(96, 96)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=16)
    d, e = band_chase.band_to_bidiagonal(Ab, band=16)
    dp, _ = band_chase.band_to_bidiagonal_plain(Ab, band=16)
    torch.testing.assert_close(d.abs()[:8], dp.abs()[:8], rtol=1e-4, atol=0)
    want = torch.linalg.svdvals(A.double())
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    torch.testing.assert_close(torch.linalg.svdvals(B), want, rtol=2e-5,
                               atol=1e-5 * float(want[0]))


def test_bisect_kernel_matches_plain(dev, rng):
    d = torch.from_numpy(rng.normal(size=200).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=199).astype(np.float32)).to(dev)
    for probes in (1, 3):
        s = bisect.bisect_svdvals(d, e, probes=probes)
        sp = bisect.bisect_svdvals_plain(d, e, probes=probes)
        torch.testing.assert_close(s, sp, rtol=1e-6,
                                   atol=1e-7 * float(sp.abs().max()))


def test_svdvals_goes_through_kernels(dev, rng):
    # n = 200: band 32, padded to 224, two chase lanes: the wavefront chase
    A = torch.from_numpy(rng.uniform(0, 5, (200, 200)).astype(np.float32)).to(dev)
    for mod in (panel_qr, band_chase, band_chase_wave, bisect):
        mod.launches = 0
    s = svdvals(A)
    assert panel_qr.launches and band_chase_wave.launches == 1 and bisect.launches
    assert band_chase.launches == 0
    want = torch.linalg.svdvals(A.double())
    torch.testing.assert_close(s.double(), want, rtol=2e-5,
                               atol=1e-5 * float(want[0]))


def test_kernels_reject_float64(dev):
    with pytest.raises(TypeError):
        panel_qr.panel_qr(torch.zeros(4, 8, dtype=torch.float64, device=dev), 0)


def test_chase_kernel_rejects_wide_band(dev):
    with pytest.raises(ValueError, match="band"):
        band_chase.band_to_bidiagonal(torch.zeros(600, 600, device=dev), band=300)


def test_recording_chase_matches_plain(dev, rng):
    # (d, e) bit-equal to the non-recording kernel; records rebuild the band
    # with orthogonal L, R, as the plain recording chase's do
    A = torch.from_numpy(rng.normal(size=(96, 96)).astype(np.float32)).to(dev)
    b = 16
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
    eye = torch.eye(96, device=dev)
    for fn in (band_chase.band_to_bidiagonal_accum,
               band_chase.band_to_bidiagonal_accum_plain):
        d, e, VL, TL, VR, TR = fn(Ab, band=b)
        if fn is band_chase.band_to_bidiagonal_accum:
            assert torch.equal(d, d0) and torch.equal(e, e0)
        L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
        R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
        B = torch.diag(d) + torch.diag(e, 1)
        assert float((L @ B @ R.T - Ab).abs().max()) <= 1e-5 * float(Ab.abs().max())
        assert float((L.T @ L - eye).abs().max()) <= 1e-5
        assert float((R.T @ R - eye).abs().max()) <= 1e-5


def test_tgk_solve_kernel_matches_plain(dev, rng):
    n = 160
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 5).to(dev)
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32) * 5).to(dev)
    z = torch.zeros(2 * n - 1, device=dev)
    z[0::2], z[1::2] = d, e
    sig = torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)).contiguous()
    rhs = torch.from_numpy(rng.normal(size=(2 * n, n)).astype(np.float32)).to(dev)
    pivmin = torch.tensor(float(sig[0]) * 2.0 ** -46, device=dev)
    big = torch.tensor(torch.finfo(torch.float32).max ** 0.5 / 16, device=dev)
    x = tridiag_solve.tgk_solve(z, sig, rhs, pivmin, big)
    xp = tridiag_solve.tgk_solve_plain(z, sig, rhs, pivmin, big)
    eps = torch.finfo(torch.float32).eps
    assert float((x / x.norm(dim=0) - xp / xp.norm(dim=0)).abs().max()) < 64 * eps


def test_svd_goes_through_kernels(dev, rng):
    # the svd path launches the panel QR, the recording chase, the
    # bisection and the TGK solve (twice: two inverse iterations)
    n = 200
    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    for mod, attr in ((panel_qr, "launches"), (band_chase, "launches_rec"),
                      (band_chase_wave, "launches_rec"), (bisect, "launches"),
                      (tridiag_solve, "launches")):
        setattr(mod, attr, 0)
    U, s, Vh = svd(A)
    # two chase lanes at n = 200 (band 32): the recording wavefront chase
    assert panel_qr.launches and band_chase_wave.launches_rec == 1 and bisect.launches
    assert band_chase.launches_rec == 0
    assert tridiag_solve.launches == 2
    want = torch.linalg.svdvals(A.double())
    smax = float(want[0])
    torch.testing.assert_close(s.double(), want, rtol=0, atol=1e-5 * smax)
    Ud, Vd = U.double(), Vh.double()
    assert float(((Ud * s.double()) @ Vd - A.double()).abs().max()) < 1e-4 * smax
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    assert float((Ud.T @ Ud - eye).abs().max()) < 1e-4
    assert float((Vd @ Vd.T - eye).abs().max()) < 1e-4


def test_numpy_input_goes_to_the_card(dev, rng):
    A = rng.uniform(0, 5, (64, 64))
    s = svdvals(A)
    assert s.is_cuda and s.dtype == torch.float32
    U, s2, Vh = svd(A)
    assert U.is_cuda and Vh.is_cuda


def _band(dev, rng, n, b):
    A = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32)).to(dev)
    return torch.triu(torch.tril(A, b)).contiguous()


VARIANTS = {
    "wave": lambda A, b: band_chase_wave.band_to_bidiagonal_wave(A, band=b),
    "wave_dl": lambda A, b: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=b),
    "wavefront": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, wavefront=True),
    "pipelined": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, pipelined=True),
    "mega": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, mega=True, khops=3),
    "vmem": lambda A, b: band_chase_vmem.band_to_bidiagonal_vmem(A, band=b),
}


@pytest.mark.parametrize("n,b", [(256, 32), (384, 64), (512, 128), (200, 8), (1000, 64)])
def test_chase_variants_bit_equal_to_chase_kernel(dev, rng, n, b):
    # every variant runs the one chase pair: (d, e) bit-equal to the
    # sequential kernel's
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
    for name, fn in VARIANTS.items():
        d, e = fn(Ab, b)
        torch.cuda.synchronize()
        assert torch.equal(d, d0) and torch.equal(e, e0), name
    want = torch.linalg.svdvals(Ab.double())
    B = torch.diag(d0.double()) + torch.diag(e0.double(), 1)
    torch.testing.assert_close(torch.linalg.svdvals(B), want, rtol=2e-5,
                               atol=1e-5 * float(want[0]))


def test_chase_variants_count_launches(dev, rng):
    Ab = _band(dev, rng, 128, 16)
    counters = ((band_chase_wave, "launches"), (band_chase_wave, "launches_dl"),
                (band_chase, "launches_staged"), (band_chase_vmem, "launches"),
                (band_chase, "launches"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    for fn in VARIANTS.values():
        fn(Ab, 16)
    got = [getattr(mod, attr) for mod, attr in counters]
    # wave + wavefront flag, wave_dl, pipelined + mega, vmem; no sequential
    assert got == [2, 1, 2, 1, 0]


def test_wave_kernels_stride_lanes_over_ctas(dev, rng):
    n, b = 300, 16  # the head and 6 chase lanes (7 deferred) on 2 CTAs
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
    for fn in (band_chase_wave.band_to_bidiagonal_wave,
               band_chase_wave.band_to_bidiagonal_wave_dl):
        d, e = fn(Ab, band=b, _ctas=2)
        assert band_chase_wave.last_ctas == 2
        assert torch.equal(d, d0) and torch.equal(e, e0)


def test_staged_kernel_khops(dev, rng):
    for b, khops, want in ((128, 4, 1), (64, 3, 3), (64, 99, 6)):
        Ab = _band(dev, rng, 4 * b, b)
        d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
        d, e = band_chase.band_to_bidiagonal(Ab, band=b, mega=True, khops=khops)
        assert band_chase.last_khops == want
        assert torch.equal(d, d0) and torch.equal(e, e0)


@pytest.mark.parametrize("n,b", [(256, 32), (384, 64), (512, 128), (200, 8), (1000, 64)])
def test_recording_wavefront_bit_equal_to_recording_chase(dev, rng, n, b):
    Ab = _band(dev, rng, n, b)
    want = band_chase.band_to_bidiagonal_accum(Ab, band=b)
    got = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_main_paths_launch_the_routed_chases(dev, rng):
    # n = 64 (band 32): one chase lane, the sequential kernels; n = 1000
    # (band 64): five lanes, the wavefront kernels
    counters = ((band_chase, "launches"), (band_chase, "launches_rec"),
                (band_chase_wave, "launches"), (band_chase_wave, "launches_rec"))
    for n, want in ((64, [1, 1, 0, 0]), (1000, [0, 0, 1, 1])):
        A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
        for mod, attr in counters:
            setattr(mod, attr, 0)
        svdvals(A)
        svd(A)
        assert [getattr(mod, attr) for mod, attr in counters] == want, n


def _counts():
    return {k: getattr(band_chase_wave, k) for k in
            ("launches", "launches_l2", "launches_rec", "launches_rec_l2", "launches_dl")}


def _reset():
    for k in _counts():
        setattr(band_chase_wave, k, 0)


@pytest.mark.parametrize("n,b", [(256, 32), (384, 64), (512, 128), (200, 8), (1000, 64),
                                 (1000, 128), (1024, 64)])
def test_smem_tick_bit_equal_to_sequential_kernels(dev, rng, n, b):
    # the shared-memory tick, plain and recording, against the sequential
    # kernels; n = 1000 at b = 128: the copies read and write past n
    Ab = _band(dev, rng, n, b)
    _reset()
    got = band_chase_wave.band_to_bidiagonal_wave(Ab, band=b)
    got_rec = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b)
    torch.cuda.synchronize()
    assert _counts() == {"launches": 1, "launches_l2": 0, "launches_rec": 1,
                         "launches_rec_l2": 0, "launches_dl": 0}
    for g, w in zip(got, band_chase.band_to_bidiagonal(Ab, band=b)):
        assert torch.equal(g, w)
    for g, w in zip(got_rec, band_chase.band_to_bidiagonal_accum(Ab, band=b)):
        assert torch.equal(g, w)


def test_smem_tick_striding_lanes_without_carry(dev):
    # 3840 / b128 on 4 CTAs: lanes stride, each pair copies its whole window
    n, b = 3840, 128
    A = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=b, _ctas=4)
    assert band_chase_wave.last_ctas == 4 and band_chase_wave.last_tick == "smem"
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_wide_band_and_deferred_left_take_the_l2_tick(dev, rng):
    Ab = _band(dev, rng, 640, 160)
    _reset()
    d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=160)
    band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=160)
    band_chase_wave.band_to_bidiagonal_wave_dl(_band(dev, rng, 256, 32), band=32)
    assert _counts() == {"launches": 0, "launches_l2": 1, "launches_rec": 0,
                         "launches_rec_l2": 1, "launches_dl": 1}
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=160)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_smem_tick_raises_on_impossible_shared_memory(dev, rng):
    # more dynamic shared memory than a CTA has: the launch fails and the
    # wrapper raises, with no fallback to the L2 tick
    Ab = _band(dev, rng, 256, 32)
    _reset()
    with pytest.raises(RuntimeError, match="band_chase_wave_smem"):
        band_chase_wave.band_to_bidiagonal_wave(Ab, band=32, _smem=240 * 1024)
    assert _counts()["launches"] == 0 and _counts()["launches_l2"] == 0


@pytest.mark.parametrize("probes", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 33, 1000])
def test_bisect_tree_bit_equal_to_one_thread(dev, rng, n, probes):
    d = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.uniform(0, 5, n - 1).astype(np.float32)).to(dev)
    want = bisect.bisect_svdvals(d, e, probes=probes, _group=1)
    bisect.launches = 0
    for group in (None, 4, 8, 16, 32):
        got = bisect.bisect_svdvals(d, e, probes=probes, _group=group)
        assert torch.equal(got, want), group
    assert bisect.launches == (5 if n > 1 else 0)


def test_bisect_tree_partial_round(dev, rng):
    # iters not a multiple of the tree's levels: the last round is partial
    d = torch.from_numpy(rng.normal(size=300).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=299).astype(np.float32)).to(dev)
    for probes, iters in ((1, 7), (1, 33), (3, 5), (2, 9)):
        want = bisect.bisect_svdvals(d, e, iters=iters, probes=probes, _group=1)
        got = bisect.bisect_svdvals(d, e, iters=iters, probes=probes)
        assert torch.equal(got, want), (probes, iters)


@pytest.mark.parametrize("n,k", [(160, None), (300, 75), (300, 97), (96, 3)])
def test_tgk_solve_staged_bit_equal_to_first_design(dev, rng, n, k):
    # k = 75, 97 and 3: lane counts that are not multiples of 4 or 32
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 5).to(dev)
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32) * 5).to(dev)
    z = torch.zeros(2 * n - 1, device=dev)
    z[0::2], z[1::2] = d, e
    sig = torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1))[: k or n].contiguous()
    rhs = torch.from_numpy(rng.normal(size=(2 * n, sig.shape[0])).astype(np.float32)).to(dev)
    pivmin = torch.tensor(float(sig[0]) * 2.0 ** -46, device=dev)
    big = torch.tensor(torch.finfo(torch.float32).max ** 0.5 / 16, device=dev)
    tridiag_solve.launches = tridiag_solve.launches_lane = 0
    x = tridiag_solve.tgk_solve(z, sig, rhs, pivmin, big)
    old = tridiag_solve.tgk_solve(z, sig, rhs, pivmin, big, _staged=False)
    assert (tridiag_solve.launches, tridiag_solve.launches_lane) == (1, 1)
    assert torch.equal(x, old)
    plain = tridiag_solve.tgk_solve_staged_plain(z, sig, rhs, pivmin, big)
    assert torch.equal(x, plain)


@pytest.mark.parametrize("m", [15360, 23040])
def test_panel_qr_past_the_old_cap(dev, rng, m):
    Pt = torch.from_numpy(rng.normal(size=(128, m)).astype(np.float32)).to(dev)
    plan = panel_qr.cluster_plan(128, m)
    assert plan.spill and plan.width - plan.smem_cols > plan.smem_cols
    got = panel_qr.panel_qr(Pt, 0)
    again = panel_qr.panel_qr(Pt, 0)
    want = panel_qr.panel_qr_plain(Pt, 0)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _sigma_err(A, s):
    ref = torch.linalg.svdvals(A.double())
    return float((s.double() - ref).abs().max() / ref[0])


def _known_spectrum(n, dev):
    """Q1 diag(sigma) Q2^T in float32 with float64 Gaussian QR factors and
    sigma = 100 * 10**(-4 i / (n - 1)): the singular values are known."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    q1, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=dev))
    sig = 100.0 * 10.0 ** (-4.0 * torch.arange(n, dtype=torch.float64, device=dev) / (n - 1))
    q1 *= sig
    q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=dev))
    return (q1 @ q2.T).float(), sig


@pytest.mark.slow
@pytest.mark.parametrize("n", [15360, 23040])
def test_svdvals_at_scale(dev, n):
    # past the first Stage I panel's old limit (m = 12,544): against float64
    # svdvals at 15,360 (~70 s), a spectrum known by construction at 23,040
    if n == 15360:
        A = torch.from_numpy(
            np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
        ref = torch.linalg.svdvals(A.double())
    else:
        A, ref = _known_spectrum(n, dev)
    s = svdvals(A)
    assert s.shape == (n,) and bool(torch.isfinite(s).all())
    assert float((s.double() - ref).abs().max() / ref[0]) <= 1e-5


@pytest.mark.slow
def test_svd_at_scale(dev):
    n = 7680
    A = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    U, s, Vh = svd(A)
    smax = float(s[0])
    assert _sigma_err(A, s) <= 1e-5
    Ud, Vd = U.double(), Vh.double()
    recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / smax
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    assert recon <= 1e-4
    assert float((Ud.T @ Ud - eye).abs().max()) <= 1e-4
    assert float((Vd @ Vd.T - eye).abs().max()) <= 1e-4
