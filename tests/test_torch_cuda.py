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
    # the staged TMA design (the route at this shape), bit-equal to the L2
    # kernel, against the plain version
    A = torch.from_numpy(rng.normal(size=(96, 96)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=16)
    d, e = band_chase.band_to_bidiagonal(Ab, band=16)
    d2, e2 = band_chase.band_to_bidiagonal_l2(Ab, band=16)
    assert torch.equal(d, d2) and torch.equal(e, e2)
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
    # n = 200: band 32, padded to 224, two chase lanes: the sequential chase
    # on its staged TMA design
    A = torch.from_numpy(rng.uniform(0, 5, (200, 200)).astype(np.float32)).to(dev)
    for mod in (panel_qr, band_chase, band_chase_wave, bisect):
        mod.launches = 0
    band_chase.launches_staged = 0
    s = svdvals(A)
    assert panel_qr.launches and band_chase.launches_staged == 1 and bisect.launches
    assert band_chase.launches == 0 and band_chase_wave.launches == 0
    want = torch.linalg.svdvals(A.double())
    torch.testing.assert_close(s.double(), want, rtol=2e-5,
                               atol=1e-5 * float(want[0]))


def test_kernels_reject_float64(dev):
    with pytest.raises(TypeError):
        panel_qr.panel_qr(torch.zeros(4, 8, dtype=torch.float64, device=dev), 0)


def test_chase_kernel_rejects_wide_band(dev):
    # past 256 the chase takes bands up to n (the wide pair); wider raise
    with pytest.raises(ValueError, match="band"):
        band_chase.band_to_bidiagonal(torch.zeros(280, 280, device=dev), band=300)
    with pytest.raises(ValueError, match="band"):
        band_chase_wave.band_to_bidiagonal_wave_dl(torch.zeros(600, 600, device=dev), band=300)


def test_recording_chase_matches_plain(dev, rng):
    # (d, e) bit-equal to the non-recording kernel; records rebuild the band
    # with orthogonal L, R, as the plain recording chase's do
    A = torch.from_numpy(rng.normal(size=(96, 96)).astype(np.float32)).to(dev)
    b = 16
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d0, e0 = band_chase.band_to_bidiagonal(Ab, band=b)
    eye = torch.eye(96, device=dev)
    for fn in (band_chase.band_to_bidiagonal_accum,
               band_chase.band_to_bidiagonal_accum_l2,
               band_chase.band_to_bidiagonal_accum_plain):
        d, e, VL, TL, VR, TR = fn(Ab, band=b)
        if fn is not band_chase.band_to_bidiagonal_accum_plain:
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
                      (band_chase, "launches_staged_rec"),
                      (band_chase_wave, "launches_rec"), (bisect, "launches"),
                      (tridiag_solve, "launches")):
        setattr(mod, attr, 0)
    U, s, Vh = svd(A)
    # two chase lanes at n = 200 (band 32): the sequential chase's
    # recording entry, on the staged TMA design
    assert panel_qr.launches and band_chase.launches_staged_rec == 1 and bisect.launches
    assert band_chase.launches_rec == 0 and band_chase_wave.launches_rec == 0
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
    # every variant runs the one chase pair: (d, e) bit-equal to the L2
    # kernel's
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
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
                (band_chase, "launches_staged"), (band_chase_vmem, "launches_tma"),
                (band_chase, "launches"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    for fn in VARIANTS.values():
        fn(Ab, 16)
    got = [getattr(mod, attr) for mod, attr in counters]
    # wave + wavefront flag, wave_dl, pipelined + mega, vmem (the TMA design
    # on the band store at b = 16); no sequential
    assert got == [2, 1, 2, 1, 0]
    assert band_chase_vmem.launches == 0


@pytest.mark.parametrize("n,b", [(1024, 64), (1002, 64), (256, 32), (37, 4), (1001, 64),
                                 (1003, 128), (5, 4), (130, 128)])
def test_packed_chase_tma_bit_equal_to_l2(dev, rng, n, b):
    # K12 on the band store against the L2 oracle: n % 4 == 2 at 1002 and
    # 130, odd n at 37, 1001, 1003 and 5, and n narrower than one box
    # (n < b + 4: every box clipped at n) at 5/b4 and 130/b128; A is read,
    # not modified
    Ab = _band(dev, rng, n, b)
    keep = Ab.clone()
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    band_chase_vmem.launches = band_chase_vmem.launches_tma = 0
    d, e = band_chase_vmem.band_to_bidiagonal_vmem(Ab, band=b)
    torch.cuda.synchronize()
    assert (band_chase_vmem.launches_tma, band_chase_vmem.launches) == (1, 0)
    assert torch.equal(d, d0) and torch.equal(e, e0)
    assert torch.equal(Ab, keep)


@pytest.mark.parametrize("n,b", [(96, 6), (150, 3)])
def test_packed_chase_l2_off_the_copy_engine(dev, rng, n, b):
    # bands the copy engine does not take run the L2 packed kernel
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    band_chase_vmem.launches = band_chase_vmem.launches_tma = 0
    d, e = band_chase_vmem.band_to_bidiagonal_vmem(Ab, band=b)
    torch.cuda.synchronize()
    assert (band_chase_vmem.launches_tma, band_chase_vmem.launches) == (0, 1)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_wave_kernels_stride_lanes_over_ctas(dev, rng):
    n, b = 300, 16  # the head and 6 chase lanes (7 deferred) on 2 CTAs
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    for fn in (band_chase_wave.band_to_bidiagonal_wave,
               band_chase_wave.band_to_bidiagonal_wave_dl):
        d, e = fn(Ab, band=b, _ctas=2)
        assert band_chase_wave.last_ctas == 2
        assert torch.equal(d, d0) and torch.equal(e, e0)


def test_staged_kernel_khops(dev, rng):
    for b, khops, want in ((128, 4, 1), (64, 3, 3), (64, 99, 5)):
        Ab = _band(dev, rng, 4 * b, b)
        d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        d, e = band_chase.band_to_bidiagonal(Ab, band=b, mega=True, khops=khops)
        assert band_chase.last_khops == want
        assert torch.equal(d, d0) and torch.equal(e, e0)


STAGED = {
    "plain": lambda A, b: band_chase.band_to_bidiagonal(A, band=b),
    "pipelined": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, pipelined=True),
    "mega": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, mega=True, khops=3),
    "mega_widest": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, mega=True,
                                                             khops=99),
}
STAGED_REC = {
    "accum": lambda A, b: band_chase.band_to_bidiagonal_accum(A, band=b),
    # the recording launch at the widest lookahead the route allows (the
    # entry itself runs one pair ahead)
    "accum_widest": lambda A, b: band_chase._launch(A, b, band_chase.staged_route(A, b, 99),
                                                    True),
}


def _seq_counts():
    return [band_chase.launches, band_chase.launches_rec, band_chase.launches_staged,
            band_chase.launches_staged_rec]


def _seq_reset():
    band_chase.launches = band_chase.launches_rec = 0
    band_chase.launches_staged = band_chase.launches_staged_rec = 0


@pytest.mark.parametrize("n,b", [(256, 32), (384, 64), (512, 128), (200, 8), (1000, 64)])
def test_staged_tma_bit_equal_three_times(dev, rng, n, b):
    # stores in flight that met would land in no fixed order: a race shows
    # as an output that differs only sometimes, so each entry runs three
    # times, plain against the L2 kernel's (d, e) and recording against its
    # (d, e) and records
    Ab = _band(dev, rng, n, b)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    want = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    for name, fn in {**STAGED, **STAGED_REC}.items():
        for _ in range(3):
            _seq_reset()
            got = fn(Ab, b)
            torch.cuda.synchronize()
            if name in STAGED:
                assert _seq_counts() == [0, 0, 1, 0], name
                assert torch.equal(got[0], d0) and torch.equal(got[1], e0), name
            else:
                assert _seq_counts() == [0, 0, 0, 1], name
                assert all(torch.equal(g, w) for g, w in zip(got, want)), name


@pytest.mark.parametrize("n,b,K", [(256, 64, 1), (1024, 64, 1), (3840, 128, 1), (1024, 64, 5)])
def test_sequential_routes_bit_equal_to_l2_kernel(dev, n, b, K):
    # K3's and K6's routes on the Stage I band of a uniform matrix: the
    # staged TMA design, (d, e) and all four records bit-equal to the L2
    # kernels', each launch counted by the kernel that ran
    A = torch.from_numpy(np.random.default_rng(7).uniform(0, 5, (n, n)).astype(np.float32))
    Ab = panel_qr.dense_to_band_fused(A.to(dev), band=b)
    _seq_reset()
    want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    want_rec = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    got = band_chase.band_to_bidiagonal(Ab, band=b, mega=K > 1, khops=K)
    got_rec = (band_chase.band_to_bidiagonal_accum(Ab, band=b) if K == 1
               else band_chase._launch(Ab, b, band_chase.staged_khops(b, K), True))
    torch.cuda.synchronize()
    assert _seq_counts() == [1, 1, 1, 1] and band_chase.last_khops == K
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got_rec, want_rec))


@pytest.mark.parametrize("n,b", [(201, 8), (150, 6), (130, 128), (640, 160)])
def test_staged_shapes_tma_does_not_take(dev, rng, n, b):
    # n or b not a multiple of 4, or b above 128: the L2 kernel, chosen
    # before launch, for every entry
    Ab = _band(dev, rng, n, b)
    assert not band_chase.staged_tma_takes(Ab, b)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    want = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    for name, fn in {**STAGED, **STAGED_REC}.items():
        _seq_reset()
        got = fn(Ab, b)
        torch.cuda.synchronize()
        assert _seq_counts() == ([1, 0, 0, 0] if name in STAGED else [0, 1, 0, 0]), name
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_staged_tma_misaligned_takes_the_l2_kernel(dev, rng):
    # A 4 bytes into its storage: the copy engine refuses it, the route
    # sends it to the L2 kernel before launch
    Ab = _band(dev, rng, 200, 8)
    mis = torch.empty(200 * 200 + 1, device=dev)[1:].view(200, 200)
    mis.copy_(Ab)
    _seq_reset()
    got = band_chase.band_to_bidiagonal(mis, band=8)
    got_rec = band_chase.band_to_bidiagonal_accum(mis, band=8)
    torch.cuda.synchronize()
    assert _seq_counts() == [1, 1, 0, 0]
    for g, w in zip(got_rec, band_chase.band_to_bidiagonal_accum(Ab, band=8)):
        assert torch.equal(g, w)
    assert torch.equal(got[0], got_rec[0]) and torch.equal(got[1], got_rec[1])


@pytest.mark.parametrize("n,b", [(256, 32), (384, 64), (512, 128), (200, 8), (1000, 64)])
def test_recording_wavefront_bit_equal_to_recording_chase(dev, rng, n, b):
    Ab = _band(dev, rng, n, b)
    want = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    got = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_main_paths_launch_the_routed_chases(dev, rng):
    # n = 64 (band 32): one chase lane, and n = 500 (band 64, padded to
    # 512): three lanes, the sequential chase's staged TMA design; n = 1000
    # (band 64): five lanes, the wavefront kernels; never the L2 kernels
    counters = ((band_chase, "launches_staged"), (band_chase, "launches_staged_rec"),
                (band_chase_wave, "launches"), (band_chase_wave, "launches_rec"),
                (band_chase, "launches"), (band_chase, "launches_rec"))
    for n, want in ((64, [1, 1, 0, 0, 0, 0]), (500, [1, 1, 0, 0, 0, 0]),
                    (1000, [0, 0, 1, 1, 0, 0])):
        A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
        for mod, attr in counters:
            setattr(mod, attr, 0)
        svdvals(A)
        svd(A)
        assert [getattr(mod, attr) for mod, attr in counters] == want, n


def _counts():
    return {k: getattr(band_chase_wave, k) for k in
            ("launches", "launches_l2", "launches_rec", "launches_rec_l2", "launches_dl",
             "launches_dl_l2")}


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
                         "launches_rec_l2": 0, "launches_dl": 0, "launches_dl_l2": 0}
    for g, w in zip(got, band_chase.band_to_bidiagonal_l2(Ab, band=b)):
        assert torch.equal(g, w)
    for g, w in zip(got_rec, band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)):
        assert torch.equal(g, w)


def test_smem_tick_striding_lanes_without_carry(dev):
    # 3840 / b128 on 4 CTAs: lanes stride, each pair copies its whole window
    n, b = 3840, 128
    A = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=b, _ctas=4)
    assert band_chase_wave.last_ctas == 4 and band_chase_wave.last_tick == "smem"
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_wide_band_and_deferred_left_take_the_l2_tick(dev, rng):
    # past b = 128 the entries take the L2 tick; the deferred-left entry
    # takes it where the copy engine does not take the shape (n = 250: rows
    # of n % 4 != 0 floats), and its shared-memory tick everywhere else
    Ab = _band(dev, rng, 640, 160)
    Ad = _band(dev, rng, 250, 32)
    _reset()
    d, e = band_chase_wave.band_to_bidiagonal_wave(Ab, band=160)
    band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=160)
    dd, ed = band_chase_wave.band_to_bidiagonal_wave_dl(Ad, band=32)
    assert _counts() == {"launches": 0, "launches_l2": 1, "launches_rec": 0,
                         "launches_rec_l2": 1, "launches_dl": 0, "launches_dl_l2": 1}
    assert band_chase_wave.last_tick == "l2"
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=160)
    assert torch.equal(d, d0) and torch.equal(e, e0)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ad, band=32)
    assert torch.equal(dd, d0) and torch.equal(ed, e0)


@pytest.mark.parametrize("n,b,ctas,tick", [
    (1024, 64, None, "smem"), (3840, 128, None, "smem"),
    (2048, 32, 4, "smem"),  # lanes striding over 4 CTAs: every hand-off through the ring
    (132, 128, None, "smem"), (64, 64, None, "smem"), (8, 4, None, "smem"),  # slots past n
    (1001, 64, None, "l2"), (1002, 64, None, "l2"),  # odd, and rows of n % 4 != 0 floats
])
def test_deferred_left_tick_bit_equal_to_l2_kernel(dev, rng, n, b, ctas, tick):
    # the deferred-left entry on the tick its shape takes, and forced onto
    # the L2 tick, against the sequential L2 kernel
    Ab = _band(dev, rng, n, b)
    want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    _reset()
    got = band_chase_wave.band_to_bidiagonal_wave_dl(Ab, band=b, _ctas=ctas)
    torch.cuda.synchronize()
    assert band_chase_wave.last_tick == tick
    assert (_counts()["launches_dl"], _counts()["launches_dl_l2"]) == \
        ((1, 0) if tick == "smem" else (0, 1))
    if ctas is not None:
        assert band_chase_wave.last_ctas == ctas
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = band_chase_wave.band_to_bidiagonal_wave_dl(Ab, band=b, _ctas=ctas, _tick="l2")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


# ---- the diagonalizers (bidiag_qr, dqds): bit-equal to their plain versions
# run on the card (a launch an operation: n <= 64), both memory instances

def _bidiag_card(rng, n, dtype, dev):
    d = torch.from_numpy(rng.normal(size=n)).to(dev, dtype)
    e = torch.from_numpy(rng.normal(size=n - 1)).to(dev, dtype)
    return d, e


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 5, 16, 64])
def test_bidiag_qr_kernel_bit_equal(dev, rng, dtype, n):
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr

    d, e = _bidiag_card(rng, n, dtype, dev)
    dp, ep, tp, sweeps, converged = dg.qr_converge_plain(d, e)
    for mem in ("smem", "global"):
        dk, ek, tk, info = bidiag_qr.converge(d, e, _memory=mem)
        assert torch.equal(dk, dp) and torch.equal(ek, ep) and torch.equal(tk, tp)
        assert int(info[0]) == sweeps and bool(info[1]) == converged
    dk, ek, _, info = bidiag_qr.converge(d, e, chunk_sweeps=7)
    assert torch.equal(dk, dp) and torch.equal(ek, ep) and int(info[0]) == sweeps
    s = bidiag_qr.bidiagonal_svdvals(d, e)
    assert torch.equal(s, dg.bidiagonal_svdvals_plain(d, e))
    want = torch.linalg.svdvals(torch.diag(d.double()) + torch.diag(e.double(), 1))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((s.double() - want).abs().max()) <= tol * float(want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bidiag_qr_sweep_entry_bit_equal(dev, rng, dtype):
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr

    d, e = _bidiag_card(rng, 16, dtype, dev)
    shift = torch.tensor(0.3, dtype=dtype, device=dev)
    for mem in ("smem", "global"):
        got = bidiag_qr.sweeps(d, e, 3, 7, _memory=mem)
        want = dg.zero_shift_sweep_plain(d, e, 3, 7)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(got[0][:3], d[:3]) and torch.equal(got[0][8:], d[8:])
        assert torch.equal(got[1][:3], e[:3]) and torch.equal(got[1][7:], e[7:])
        got = bidiag_qr.sweeps(d, e, 3, 7, shift=shift, _memory=mem)
        want = dg.shifted_sweep_plain(d, e, 3, 7, shift)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = bidiag_qr.sweeps(d, e, n_iter=4, _memory=mem)
        want = (d, e)
        for _ in range(4):
            want = dg.zero_shift_sweep_plain(*want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 5, 16, 64])
def test_dqds_kernel_bit_equal(dev, rng, dtype, n):
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    d, e = _bidiag_card(rng, n, dtype, dev)
    sp, swp, hp = dg.dqds_svdvals_plain(d, e, with_info="debug")
    for mem in ("smem", "global"):
        sk, swk, hk = dqds.dqds_svdvals(d, e, with_info="debug", _memory=mem)
        assert torch.equal(sk, sp) and swk == swp and torch.equal(hk, hp)


@pytest.mark.parametrize("kernel", ["bidiag_qr", "dqds"])
def test_diag_kernels_bit_equal_on_the_path_bidiagonal(dev, kernel):
    # the (d, e) that bidiagonalize gives the uniform 1000 matrix (a graded
    # spectrum; many strides a thread in the passes between sweeps): 6 QR or
    # 15 dqds sweeps on both sides, a window that holds a deflation, both
    # memory instances, everything bit-equal
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.models.svd import bidiagonalize
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    A = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (1000, 1000))
                         .astype(np.float32)).to(dev)
    B = bidiagonalize(A)
    d, e = B.d.contiguous(), B.e.contiguous()
    if kernel == "bidiag_qr":
        k = 6
        dp, ep, tp, sweeps, converged = dg.qr_converge_plain(d, e, max_sweeps=k)
        assert int((ep == 0).sum()) > 0
        for mem in ("smem", "global"):
            dk, ek, tk, info = bidiag_qr.converge(d, e, max_sweeps=k, _memory=mem)
            assert torch.equal(dk, dp) and torch.equal(ek, ep) and torch.equal(tk, tp)
            assert int(info[0]) == sweeps and bool(info[1]) == converged
    else:
        k = 15
        q, E, _ = dg.dqds_prepare(d, e)
        want = dg._dqds_loop_plain(q, E, k)
        assert want[1] < 999
        for mem in ("smem", "global"):
            out, hi, sweeps, hist = dqds.dqds_loop(q, E, k, mem)
            assert torch.equal(out, want[0])
            assert (hi, sweeps, list(hist)) == (want[1], want[2], list(want[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bidiag_qr_threshold_rejects_n1_on_card(dev, dtype):
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr

    d, e = torch.tensor([-2.0], dtype=dtype, device=dev), torch.zeros(0, dtype=dtype, device=dev)
    with pytest.raises(ValueError, match="n >= 2"):
        bidiag_qr.convergence_threshold(d, e)
    with pytest.raises(ValueError, match="n >= 2"):
        bidiag_qr.converge(d, e)
    assert bidiag_qr.bidiagonal_svdvals(d, e).tolist() == [2.0]


def test_dqds_stall_spectrum_on_card(dev):
    # float64, the stall spectrum (random n = 120, seed 0): at most 900
    # sweeps, every sigma to 1e-10 relative, no safety net
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    g = np.random.default_rng(0)
    d, e = g.standard_normal(120), g.standard_normal(119)
    nets, launches = dg.safety_nets, dqds.launches
    sig, sweeps = dqds.dqds_svdvals(torch.from_numpy(d).to(dev), torch.from_numpy(e).to(dev),
                                    with_info=True)
    want = np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)
    assert sweeps <= 900
    assert np.max(np.abs(sig.cpu().numpy() - want) / want) < 1e-10
    assert dg.safety_nets == nets and dqds.launches == launches + 1


def test_diag_kernels_refuse_float16(dev):
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    d, e = torch.ones(4, dtype=torch.float16, device=dev), torch.ones(3, dtype=torch.float16,
                                                                      device=dev)
    for fn in (bidiag_qr.bidiagonal_svdvals, dqds.dqds_svdvals):
        with pytest.raises(TypeError, match="float32 or float64"):
            fn(d, e)


@pytest.mark.parametrize("diag,kernel", [("qr", "bidiag_qr"), ("dqds", "dqds")])
def test_svdvals_diag_runs_its_kernel(dev, rng, diag, kernel):
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    mods = {"bidiag_qr": bidiag_qr, "dqds": dqds}
    A = torch.from_numpy(rng.uniform(0, 5, (256, 256)).astype(np.float32)).to(dev)
    before, loops = mods[kernel].launches, dg.plain_loops
    s = svdvals(A, diag=diag)
    assert mods[kernel].launches == before + 1 and dg.plain_loops == loops
    assert _sigma_err(A, s) <= 1e-5


# ---- the diagonalizers' second design: whole runs down the paths it changed ----

def _same_bits(got, want):
    """Bit-equal where not NaN, NaN where NaN (a NaN's payload aside)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])


def _dqds_whole_run(d, e):
    """dqds_svdvals on both memory instances bit-equal to the plain version
    run on the card (sigma, sweeps, histogram); returns the histogram."""
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    sp, swp, hp = dg.dqds_svdvals_plain(d, e, with_info="debug")
    for mem in ("smem", "global"):
        sk, swk, hk = dqds.dqds_svdvals(d, e, with_info="debug", _memory=mem)
        assert torch.equal(sk, sp) and swk == swp and torch.equal(hk, hp)
    return hp.tolist()


@pytest.mark.parametrize("dtype,seed", [(torch.float64, 27), (torch.float32, 0)])
def test_dqds_retries_and_fallback_bit_equal(dev, dtype, seed):
    # random n = 64 bidiagonals whose runs take corrected retries (bin 18)
    # and zero-shift fallbacks (bin 0): every failed sweep re-reads the
    # untouched source pair
    g = np.random.default_rng(seed)
    d = torch.from_numpy(g.standard_normal(64)).to(dev, dtype)
    e = torch.from_numpy(g.standard_normal(63)).to(dev, dtype)
    hist = _dqds_whole_run(d, e)
    assert hist[18] > 0 and hist[0] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dqds_flip_on_the_first_iteration(dev, dtype):
    # an ascending graded d: the window's large values at the bottom, so
    # the first iteration (which deflates nothing) flips the whole source
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    n = 60
    d = torch.from_numpy(10.0 ** np.linspace(-6, 0, n)).to(dev, dtype)
    e = torch.from_numpy(0.3 * 10.0 ** np.linspace(-6, 0, n - 1)).to(dev, dtype)
    q, E, _ = dg.dqds_prepare(d, e)
    assert float(1.5 * q[0]) < float(q[-1])
    for mem in ("smem", "global"):
        out, hi, sweeps, hist = dqds.dqds_loop(q, E, 1, mem)
        want = dg._dqds_loop_plain(q, E, 1)
        assert hi == n - 1 and sweeps == 1  # nothing deflated: the flip took [0, n - 1]
        assert torch.equal(out, want[0]) and list(hist) == list(want[3])
    _dqds_whole_run(d, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dqds_trailing_2x2_deflation(dev, rng, dtype):
    # e[9] = 0 splits off an unreduced trailing 2x2 block: the first
    # iteration deflates it whole (hi 11 -> 9, its E not negligible)
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    n = 12
    d = torch.from_numpy(rng.normal(size=n)).to(dev, dtype)
    e = torch.from_numpy(rng.normal(size=n - 1)).to(dev, dtype)
    e[9] = 0
    q, E, _ = dg.dqds_prepare(d, e)
    assert float(E[10]) > 1e-4 * float(torch.maximum(q[10], q[11]))
    for mem in ("smem", "global"):
        out, hi, sweeps, _ = dqds.dqds_loop(q, E, 1, mem)
        want = dg._dqds_loop_plain(q, E, 1)
        assert hi == 9 and want[1] == 9 and torch.equal(out, want[0])
    _dqds_whole_run(d, e)


@pytest.mark.parametrize("dtype,n", [(torch.float32, 11571), (torch.float32, 11572),
                                     (torch.float64, 5785), (torch.float64, 5786)])
def test_dqds_at_the_memory_limits(dev, rng, dtype, n):
    # both sides of memory_instance's limit: two sweeps bit-equal to the
    # plain loop on the instance the shape takes (and on the device one,
    # forced, below the limit); the whole run on each instance the shape
    # allows, bit-equal between them, sigma to the float64 reference
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import dqds

    d = torch.from_numpy(rng.normal(size=n)).to(dev, dtype)
    e = torch.from_numpy(rng.normal(size=n - 1)).to(dev, dtype)
    q, E, _ = dg.dqds_prepare(d, e)
    want = dg._dqds_loop_plain(q, E, 2)
    fits = dqds.memory_instance(n, dtype) == "smem"
    assert fits == (n in (11571, 5785))
    mems = ("smem", "global") if fits else ("global",)
    for mem in mems:
        out, hi, sweeps, hist = dqds.dqds_loop(q, E, 2, mem)
        assert torch.equal(out, want[0]) and (hi, sweeps) == (want[1], want[2])
        assert list(hist) == list(want[3])
    runs = [dqds.dqds_svdvals(d, e, with_info=True, _memory=mem) for mem in mems]
    assert all(torch.equal(s, runs[0][0]) and sw == runs[0][1] for s, sw in runs)
    ref = torch.linalg.svdvals(torch.diag(d.double()) + torch.diag(e.double(), 1))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((runs[0][0].double() - ref).abs().max()) <= tol * float(ref[0])


_GIVENS_CASES = {
    # (d, e, shift): the first rotation of the sweep meets the case
    "f == 0": ([0.0, 1.0, 2.0, 3.0], [1.0, 0.5, 2.0], None),
    "f == 0 shifted": ([0.5, 1.0, 2.0, 3.0], [1.0, 0.5, 2.0], 0.5),
    "|f| == |g|": ([1.5, -1.0, 2.0, 1.0], [1.5, -1.0, 1.0], None),
    "|f| == |g| shifted": ([2.0, -1.0, 2.0, 1.0], [1.5, -1.0, 1.0], 1.0),
    "g == 0": ([2.0, 0.0, 3.0, 1.0], [0.0, 0.0, 3.0], None),
    "g == 0 shifted": ([2.0, 1.0, 3.0, 1.0], [0.0, 1.0, 3.0], 0.5),
    "NaN": ([1.0, float("nan"), 2.0, 3.0], [0.5, 1.0, 2.0], None),
    "NaN shifted": ([1.0, 2.0, 3.0, 4.0], [float("nan"), 1.0, 1.0], 0.5),
    "all zero": ([0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0], None),
}


@pytest.mark.parametrize("case", list(_GIVENS_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bidiag_qr_givens_cases_bit_equal(dev, dtype, case):
    # the branch-free rotation at each of the plain version's sides,
    # through the sweep entry (one and two zero-shift sweeps, or a shifted
    # sweep), both memory instances
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr

    d, e, shift = _GIVENS_CASES[case]
    d = torch.tensor(d, dtype=dtype, device=dev)
    e = torch.tensor(e, dtype=dtype, device=dev)
    if shift is None:
        runs = {1: dg.zero_shift_sweep_plain(d, e)}
        runs[2] = dg.zero_shift_sweep_plain(*runs[1])
        got = {k: [bidiag_qr.sweeps(d, e, n_iter=k, _memory=m) for m in ("smem", "global")]
               for k in runs}
    else:
        shift = torch.tensor(shift, dtype=dtype, device=dev)
        runs = {1: dg.shifted_sweep_plain(d, e, 0, 3, shift)}
        got = {1: [bidiag_qr.sweeps(d, e, 0, 3, shift=shift, _memory=m)
                   for m in ("smem", "global")]}
    for k, want in runs.items():
        for dk, ek in got[k]:
            assert _same_bits(dk, want[0]) and _same_bits(ek, want[1])


# ---- the tiled Stage I's slab kernel (the multicore rung) and the batches

@pytest.mark.parametrize("t", [32, 64, 128])
@pytest.mark.parametrize("kind", ["1-slab", "2-slab", "2-slab lq"])
def test_tiled_slab_kernel_matches_plain(dev, rng, t, kind):
    # on rows of a 1024 matrix: a diagonal slab, a TS slab over the last
    # tile row, and a TS slab shaped as the LQ mirror's (its pivot columns a
    # tile left of its rows, so each pivot's row lies past the pivot block);
    # two launches bit-identical, the plain version within 1e-4 of max |A|
    # (float32 sums in another order over t steps), other rows untouched
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    n = 1024
    top, pc, bot = {"1-slab": (t, t, None), "2-slab": (t, t, n - t),
                    "2-slab lq": (2 * t, t, n - t)}[kind]
    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    got, again, want = A.clone(), A.clone(), A.clone()
    before = tiled_slab.launches
    tiled_slab.factor_slab(got, top, pc, t, bot)
    tiled_slab.factor_slab(again, top, pc, t, bot)
    assert tiled_slab.launches == before + 2
    tiled._factor_slab(want, top, pc, t, bot)
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-4 * float(A.abs().max())
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    for r in (top, bot):
        if r is not None:
            keep[r:r + t] = False
    assert torch.equal(got[keep], A[keep])


def test_tiled_slab_refuses_a_tile_past_shared_memory(dev):
    # the first design's kernel refuses a TS slab past its shared memory;
    # the Stage I takes such a band through the wide instance, with no
    # first-design launch
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    A = torch.zeros((1024, 1024), device=dev)
    before = (tiled_slab.launches, tiled_slab.launches_wide_chain)
    with pytest.raises(ValueError, match="shared-memory limit"):
        tiled_slab.factor_slab(A, 0, 0, 192, bot=512)
    tiled_slab.dense_to_band_tiled(A, band=256)
    assert tiled_slab.launches == before[0]
    assert tiled_slab.launches_wide_chain - before[1] == 2 * (1024 // 256) - 1


def test_svdvals_multicore_on_card(dev):
    # n = 1024, tiles of 128 (the band by size): a chain and an apply launch
    # for each of the 15 half-sweeps and no slab launch, then the routed
    # chase and K2
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    n = 1024
    A = torch.from_numpy(np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    before = (tiled_slab.launches, tiled_slab.launches_chain, tiled_slab.launches_apply)
    s = svdvals(A, method="multicore")
    half_sweeps = 2 * (n // 128) - 1
    assert (tiled_slab.launches - before[0], tiled_slab.launches_chain - before[1],
            tiled_slab.launches_apply - before[2]) == (0, half_sweeps, half_sweeps)
    assert _sigma_err(A, s) <= 1e-5


@pytest.mark.parametrize("n,t", [(1024, 64), (1024, 32), (200, 8)])
def test_tiled_sweeps_bit_equal_to_the_first_design(dev, rng, n, t):
    # dense_to_band_tiled (a chain and an apply a half-sweep) against every
    # slab through the first design's kernel on the same matrix
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    before = tiled_slab.launches_chain
    got = tiled_slab.dense_to_band_tiled(A, band=t)
    assert tiled_slab.launches_chain - before == 2 * (n // t) - 1
    want = tiled_slab.dense_to_band_slabs(A.clone(), t)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [32, 64, 128])
@pytest.mark.parametrize("half", ["qr", "lq"])
def test_tiled_chain_and_apply_kernels_match_plain(dev, rng, t, half):
    # one half-sweep on rows of a 1024 matrix (QR-shaped, and LQ-shaped:
    # pivots a tile left of the rows): the chain kernel against
    # models/tiled.chain_plain (the block, v and tau), then the apply kernel
    # against apply_plain on the kernel's history; each within 1e-4 of
    # max |A| (float32 sums in another order over the half-sweep's steps),
    # two launches bit-identical, the rows above the half-sweep untouched
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    n = 1024
    top, pc = (n - 4 * t, n - 4 * t) if half == "qr" else (n - 4 * t, n - 5 * t)
    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    amax = float(A.abs().max())
    got, again, want = A.clone(), A.clone(), A.clone()
    V, tau = tiled_slab.factor_sweep(got, top, pc, t)
    V2, tau2 = tiled_slab.factor_sweep(again, top, pc, t)
    Vp, taup = tiled.chain_plain(want, top, pc, t)
    assert torch.equal(got, again) and torch.equal(V, V2) and torch.equal(tau, tau2)
    assert float((got - want).abs().max()) <= 1e-4 * amax
    assert float((V[:, :, :2 * t] - Vp).abs().max()) <= 1e-4
    assert float((tau - taup).abs().max()) <= 1e-4
    assert torch.equal(V[:, :, 2 * t:], torch.zeros_like(V[:, :, 2 * t:]))
    plain = got.clone()
    tiled_slab.apply_sweep(got, top, pc, t, V, tau)
    tiled_slab.apply_sweep(again, top, pc, t, V, tau)
    tiled.apply_plain(plain, top, pc, t, V, tau)
    assert torch.equal(got, again)
    assert float((got - plain).abs().max()) <= 1e-4 * amax
    assert torch.equal(got[:top], A[:top])


def test_svdvals_batch_rows_bit_equal_on_card(dev, rng):
    from svdsolver_tpu_torch import svdvals_batch

    As = torch.from_numpy(rng.uniform(0, 5, (4, 200, 200)).astype(np.float32)).to(dev)
    S = svdvals_batch(As)
    for i in range(4):
        assert torch.equal(S[i], svdvals(As[i]))
    assert _sigma_err(As[0], S[0]) <= 1e-5


# ---- the wide instances (bands past the narrow kernels') ----

def _uniform_on(dev, n, seed=0):
    a = np.random.default_rng(seed).uniform(0, 5, (n, n)).astype(np.float32)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("method,n,block", [
    ("multicore", 1024, 192), ("multicore", 1024, 256), ("tpu2", 2048, 384),
    ("tpu2", 2048, 512), ("tpu2", 256, 256), ("multicore", 256, 256)])
def test_svdvals_at_wide_blocks(dev, method, n, block):
    # K1 past b = 256, the chases' wide pair, the tiled Stage I's wide
    # instance, block = n; sigma against float64 within 1e-5 sigma_max
    A = _uniform_on(dev, n)
    assert _sigma_err(A, svdvals(A, method=method, block=block)) <= 1e-5


def test_svd_at_band_512(dev):
    n = 2048
    A = _uniform_on(dev, n, seed=1)
    U, s, Vh = svd(A, band=512)
    Ad, Ud, Vd = A.double(), U.double(), Vh.double()
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    smax = float(torch.linalg.svdvals(Ad)[0])
    assert _sigma_err(A, s) <= 1e-5
    assert float((Ud * s.double() @ Vd - Ad).abs().max()) / smax <= 1e-4
    assert float((Ud.T @ Ud - eye).abs().max()) <= 1e-4
    assert float((Vd @ Vd.T - eye).abs().max()) <= 1e-4


@pytest.mark.parametrize("n,b", [(1152, 384), (2304, 384)])
def test_wide_chases_bit_equal_to_each_other(dev, n, b):
    # the L2 sequential kernel and the wavefront's L2 tick share the wide
    # pair: (d, e) and every record bit-equal; the spectrum against float64
    A = _uniform_on(dev, n, seed=2)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    seq = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    wave = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b)
    assert band_chase_wave.last_tick == "l2"
    for x, y in zip(seq, wave):
        assert torch.equal(x, y)
    d, e = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    assert torch.equal(d, seq[0]) and torch.equal(e, seq[1])
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    want = torch.linalg.svdvals(A.double())
    assert float((torch.linalg.svdvals(B) - want).abs().max()) <= 1e-5 * float(want[0])


@pytest.mark.parametrize("n,t", [(640, 160), (512, 64)])
def test_wide_tiled_instance_bit_equal_to_the_narrow_designs(dev, n, t):
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    A = _uniform_on(dev, n, seed=3)
    got = tiled_slab.dense_to_band_wide(A.clone(), t)
    want = (tiled_slab.dense_to_band_slabs(A.clone(), t) if t > 128
            else tiled_slab.dense_to_band_tiled(A, band=t))
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,m", [(384, 2048), (512, 1024), (1024, 1024)])
def test_panel_qr_at_wide_panels(dev, rng, b, m):
    # Q = I - V T V^T orthogonal and Q R = P (float64 from the kernel's
    # outputs); two launches bit-identical
    Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).to(dev)
    got = panel_qr.panel_qr(Pt, 0)
    again = panel_qr.panel_qr(Pt, 0)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    Rt, Vt, Tt = got
    V, T = Vt.double().T, Tt.double().T
    Q = torch.eye(m, dtype=torch.float64, device=dev) - V @ T @ V.T
    assert float((Q.T @ Q - torch.eye(m, dtype=torch.float64, device=dev)).abs().max()) < 1e-5
    P = Pt.double().T
    assert float(torch.linalg.norm(Q @ Rt.double().T - P) / torch.linalg.norm(P)) < 1e-5


# ---- one-sided block Jacobi on the card ----

def _jacobi_ok(A, U, s, Vh, tol):
    Ad, Ud, Vd = A.double(), U.double(), Vh.double()
    n = A.shape[-1]
    ref = torch.linalg.svdvals(Ad)
    assert float((s.double() - ref).abs().max() / ref[0]) <= tol
    assert float(torch.linalg.norm(Ud * s.double() @ Vd - Ad) / torch.linalg.norm(Ad)) <= tol
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    assert float((Ud.T @ Ud - eye).abs().max()) <= tol
    assert float((Vd @ Vd.T - eye).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.float64, 1e-10)])
def test_jacobi_entries_on_card(dev, dtype, tol):
    from svdsolver_tpu_torch import svd_jacobi, svd_jacobi_batch, svd_jacobi_pre

    A = _uniform_on(dev, 256, seed=4).to(dtype)
    for fn in (svd_jacobi, svd_jacobi_pre, lambda X: svd(X, method="jacobi")):
        U, s, Vh = fn(A)
        assert s.dtype == dtype and s.device == A.device
        _jacobi_ok(A, U, s, Vh, tol)
    As = torch.stack([_uniform_on(dev, 64, seed=k).to(dtype) for k in range(3)])
    U, s, Vh = svd_jacobi_batch(As)
    for i in range(3):
        _jacobi_ok(As[i], U[i], s[i], Vh[i], tol)



# ---- the robustness net on the card: degenerate input through the kernels ----

@pytest.fixture
def no_plain():
    """``run(fn)``: ``fn()`` with every plain version an entry point could
    run in place of a kernel replaced by a function that fails."""
    from svdsolver_tpu_torch.ops.cuda import plain_versions

    def failing(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"the plain version {name} ran on a CUDA tensor")
        return fail

    def run(fn):
        with pytest.MonkeyPatch.context() as mp:
            for mod, name in plain_versions():
                mp.setattr(mod, name, failing(name))
            return fn()

    return run


def _degenerate_panel(rng, b, m, kind):
    """P (m, b): all zero, every other column zero (zero-norm reflectors),
    or already upper triangular (every reflector the identity)."""
    P = rng.normal(size=(m, b)).astype(np.float32)
    if kind == "zero":
        P[:] = 0
    elif kind == "zero_columns":
        P[:, 1::2] = 0
    else:
        P = np.triu(P)
    return P


@pytest.mark.parametrize("kind", ["zero", "zero_columns", "factored"])
@pytest.mark.parametrize("b,m", [(16, 96), (128, 1024)])
def test_panel_qr_on_degenerate_panels(dev, rng, no_plain, b, m, kind):
    # a zero-norm reflector gives tau = 0 and no NaN; R, V, T as the plain
    # version's; Q = I - V T V^T orthogonal, Q R = P
    P = _degenerate_panel(rng, b, m, kind)
    Pt = torch.from_numpy(np.ascontiguousarray(P.T)).to(dev)
    panel_qr.launches = 0
    Rt, Vt, Tt = no_plain(lambda: panel_qr.panel_qr(Pt, 0))
    assert panel_qr.launches == 1
    assert all(bool(torch.isfinite(x).all()) for x in (Rt, Vt, Tt))
    tau = torch.diagonal(Tt)
    zero_tau = {"zero": range(b), "zero_columns": range(1, b, 2), "factored": range(b)}[kind]
    assert all(float(tau[j]) == 0.0 for j in zero_tau)
    scale = max(float(Pt.abs().max()), 1.0)
    for g, w in zip((Rt, Vt, Tt), panel_qr.panel_qr_plain(Pt, 0)):
        assert float((g - w).abs().max()) <= 1e-4 * scale
    if kind != "zero_columns":  # every reflector the identity: R = P exactly
        assert torch.equal(Rt, Pt) and torch.equal(Tt, torch.zeros_like(Tt))
    V, T = Vt.double().T, Tt.double().T
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    Q = eye - V @ T @ V.T
    assert float((Q.T @ Q - eye).abs().max()) < 1e-5
    assert float((Q @ Rt.double().T - Pt.double().T).abs().max()) <= 1e-5 * scale


def _chase_entries():
    return {
        "sequential": (band_chase.band_to_bidiagonal,
                       ((band_chase, "launches_staged"), (band_chase, "launches"))),
        "sequential_rec": (band_chase.band_to_bidiagonal_accum,
                           ((band_chase, "launches_staged_rec"), (band_chase, "launches_rec"))),
        "wavefront": (band_chase_wave.band_to_bidiagonal_wave,
                      ((band_chase_wave, "launches"), (band_chase_wave, "launches_l2"))),
        "wavefront_rec": (band_chase_wave.band_to_bidiagonal_wave_accum,
                          ((band_chase_wave, "launches_rec"), (band_chase_wave, "launches_rec_l2"))),
    }


@pytest.mark.parametrize("kind", ["bidiagonal", "zero"])
@pytest.mark.parametrize("entry", ["sequential", "sequential_rec", "wavefront", "wavefront_rec"])
def test_chases_on_degenerate_bands(dev, rng, no_plain, entry, kind):
    # a band that is already bidiagonal (every reflector the identity) or
    # zero: (d, e) exact, the records rebuild the band (L = R = I)
    n, b = 256, 32
    d0 = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    e0 = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32)).to(dev)
    if kind == "zero":
        d0, e0 = torch.zeros_like(d0), torch.zeros_like(e0)
    Ab = (torch.diag(d0) + torch.diag(e0, 1)).contiguous()
    fn, counters = _chase_entries()[entry]
    for mod, attr in counters:
        setattr(mod, attr, 0)
    out = no_plain(lambda: fn(Ab, band=b))
    assert sum(getattr(mod, attr) for mod, attr in counters) == 1
    assert torch.equal(out[0], d0) and torch.equal(out[1], e0)
    if entry.endswith("_rec"):
        _, _, VL, TL, VR, TR = out
        assert float(TL.abs().max()) == 0.0 and float(TR.abs().max()) == 0.0
        eye = torch.eye(n, device=dev)
        L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
        R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
        assert torch.equal(L @ Ab @ R.T, Ab)


@pytest.mark.parametrize("kind", ["zero", "split"])
@pytest.mark.parametrize("n", [24, 256])
def test_bisect_on_zero_and_split_bidiagonals(dev, rng, no_plain, n, kind):
    # d = e = 0: sigma exactly 0; exact zeros inside (d, e): the plain
    # bisection's values and float64's
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32)).to(dev)
    if kind == "zero":
        d.zero_(), e.zero_()
    else:
        d[[3, n // 2]] = 0
        e[[5, 6, n - 2]] = 0
    bisect.launches = 0
    s = no_plain(lambda: bisect.bisect_svdvals(d, e))
    assert bisect.launches == 1 and bool(torch.isfinite(s).all())
    if kind == "zero":
        assert torch.equal(s, torch.zeros_like(s))
        return
    sp = bisect.bisect_svdvals_plain(d, e)
    torch.testing.assert_close(s, sp, rtol=1e-6, atol=1e-7 * float(sp.abs().max()))
    want = torch.linalg.svdvals(torch.diag(d.double()) + torch.diag(e.double(), 1))
    assert float((s.double() - want).abs().max()) <= 1e-5 * float(want[0])


@pytest.mark.parametrize("kind", ["zero", "diagonal"])
def test_multicore_on_zero_and_diagonal(dev, rng, no_plain, kind):
    # the tiled Stage I's chain and apply kernels on zero tiles
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    n, t = 256, 32
    x = rng.normal(size=n).astype(np.float32) if kind == "diagonal" else np.zeros(n, np.float32)
    A = torch.diag(torch.from_numpy(x)).to(dev)
    tiled_slab.launches_chain = tiled_slab.launches_apply = 0
    s = no_plain(lambda: svdvals(A, method="multicore", block=t))
    assert tiled_slab.launches_chain == tiled_slab.launches_apply == 2 * (n // t) - 1
    want = np.sort(np.abs(x))[::-1].copy()
    if kind == "zero":
        assert torch.equal(s, torch.zeros_like(s))
    else:
        assert float((s.cpu() - torch.from_numpy(want)).abs().max()) <= 1e-6 * float(want[0])


@pytest.mark.parametrize("kind", ["identity", "three_q"])
@pytest.mark.parametrize("n", [24, 256])
def test_svd_on_duplicate_sigma(dev, rng, no_plain, n, kind):
    # one cluster of n equal values through the TGK solve kernel (K9/K10)
    A = (np.eye(n) if kind == "identity"
         else 3 * np.linalg.qr(rng.normal(size=(n, n)))[0]).astype(np.float32)
    A = torch.from_numpy(A).to(dev)
    tridiag_solve.launches = bisect.launches = 0
    U, s, Vh = no_plain(lambda: svd(A))
    assert tridiag_solve.launches == 2 and bisect.launches == 1
    Ad, Ud, Vd = A.double(), U.double(), Vh.double()
    smax = float(torch.linalg.svdvals(Ad)[0])
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    assert _sigma_err(A, s) <= 1e-5
    assert float((Ud * s.double() @ Vd - Ad).abs().max()) <= 1e-4 * smax
    assert float((Ud.T @ Ud - eye).abs().max()) <= 1e-4
    assert float((Vd @ Vd.T - eye).abs().max()) <= 1e-4


def test_svd_batch_mixed_spectra_on_card(dev, rng, no_plain):
    from svdsolver_tpu_torch import svd_batch

    n = 32
    Q1, _ = np.linalg.qr(rng.normal(size=(n, n)))
    Q2, _ = np.linalg.qr(rng.normal(size=(n, n)))
    specs = [np.linspace(2.0, 1.0, n), np.full(n, 1.5),
             np.concatenate([np.linspace(3, 1, n - 4), np.full(4, 1e-5)])]
    As = np.stack([(Q1 * sp[None, :]) @ Q2.T for sp in specs]).astype(np.float32)
    panel_qr.launches = tridiag_solve.launches = 0
    out = no_plain(lambda: svd_batch(torch.from_numpy(As).to(dev)))
    U, s, Vh = (x.cpu().numpy() for x in out)
    assert panel_qr.launches and tridiag_solve.launches == 2 * len(specs)
    for i, sp in enumerate(specs):
        want = np.sort(sp)[::-1]
        np.testing.assert_allclose(s[i], want, rtol=2e-4, atol=2e-5 * want[0])
        np.testing.assert_allclose(U[i] @ np.diag(s[i]) @ Vh[i], As[i], atol=5e-5 * want[0])


@pytest.mark.parametrize("kind", ["zero", "split", "zero_pivot"])
@pytest.mark.parametrize("kernel", ["bidiag_qr", "dqds"])
def test_diag_kernels_on_zero_and_split(dev, rng, no_plain, kernel, kind):
    # bit-equal to their plain versions (float32 and float64); zero (d, e)
    # gives exact zeros.  "zero_pivot" (a zero d with a zero e elsewhere)
    # costs the QR diagonalizer its accuracy in the JAX package too
    # (ROADMAP, faults shared with the reference): bits, not the spectrum
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    n = 24
    d = torch.from_numpy(rng.normal(size=n)).to(dev, torch.float32)
    e = torch.from_numpy(rng.normal(size=n - 1)).to(dev, torch.float32)
    if kind == "zero":
        d.zero_(), e.zero_()
    elif kind == "split":
        e[[10, 11]] = 0
    else:
        d[5], e[10] = 0, 0
    dg.plain_loops = 0
    if kernel == "bidiag_qr":
        bidiag_qr.launches = 0
        s = no_plain(lambda: bidiag_qr.bidiagonal_svdvals(d, e))
        assert bidiag_qr.launches == 1
        assert torch.equal(s, dg.bidiagonal_svdvals_plain(d, e))
    else:
        dqds.launches = dg.safety_nets = 0
        s = no_plain(lambda: dqds.dqds_svdvals(d, e))
        assert dqds.launches == 1 and dg.safety_nets == 0
        assert torch.equal(s, dg.dqds_svdvals_plain(d, e))
    assert bool(torch.isfinite(s).all())
    if kind == "zero":
        assert torch.equal(s, torch.zeros_like(s))
    elif kind == "split" or kernel == "dqds":
        want = torch.linalg.svdvals(torch.diag(d.double()) + torch.diag(e.double(), 1))
        assert float((s.double() - want).abs().max()) <= 1e-5 * float(want[0])


# ---- complex SVD, SBR and the CLI on the card ----

def test_complex64_gemm_is_fp32(dev, rng):
    # every complex contraction goes through pdot with TF32 off: one
    # complex64 GEMM within fp32 rounding of complex128 (TF32 gives ~1e-3)
    from svdsolver_tpu_torch.ops.precision import pdot

    A = torch.from_numpy(rng.normal(size=(512, 512)) + 1j * rng.normal(size=(512, 512))).to(dev)
    B = torch.from_numpy(rng.normal(size=(512, 512)) + 1j * rng.normal(size=(512, 512))).to(dev)
    got = pdot(A.to(torch.complex64), B.to(torch.complex64)).to(torch.complex128)
    want = A.to(torch.complex64).to(torch.complex128) @ B.to(torch.complex64).to(torch.complex128)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("shape", [(256, 256), (96, 160)])
def test_complex_svd_on_card(dev, rng, no_plain, shape):
    # complex64: the reduction on torch ops, then K2 and K9/K10 on the real
    # bidiagonal; sigma against complex128 LAPACK, the factors' gates
    from svdsolver_tpu_torch import svd_c, svdvals_c

    m, n = shape
    A = torch.from_numpy(rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
                         ).to(dev, torch.complex64)
    want = torch.linalg.svdvals(A.to(torch.complex128))
    bisect.launches = tridiag_solve.launches = 0
    s = no_plain(lambda: svdvals_c(A))
    assert s.dtype == torch.float32 and s.is_cuda and bisect.launches == 1
    assert float((s.double() - want).abs().max()) <= 1e-5 * float(want[0])
    U, s2, Vh = no_plain(lambda: svd(A))
    assert bisect.launches == 2 and tridiag_solve.launches == 2
    k = min(m, n)
    Ud, Vd, Ad = U.to(torch.complex128), Vh.to(torch.complex128), A.to(torch.complex128)
    eye = torch.eye(k, dtype=torch.complex128, device=dev)
    assert float((s2.double() - want).abs().max()) <= 1e-5 * float(want[0])
    assert float((Ud * s2.double() @ Vd - Ad).abs().max()) <= 1e-4 * float(want[0])
    assert float((Ud.mH @ Ud - eye).abs().max()) <= 1e-4
    assert float((Vd @ Vd.mH - eye).abs().max()) <= 1e-4
    s3 = svdvals_c(A.cpu().numpy())  # a numpy complex array goes to the card
    assert s3.is_cuda and torch.equal(s3, s)


def test_sbr_on_card(dev, rng, no_plain):
    # the block sweep on torch ops, then the routed chase kernel at mid
    from svdsolver_tpu_torch.models.sbr import band_to_bidiagonal_sbr

    n, b, mid = 256, 32, 8
    A = torch.from_numpy(rng.uniform(0, 5, (n, n)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    counters = ((band_chase, "launches_staged"), (band_chase, "launches"),
                (band_chase_wave, "launches"), (band_chase_wave, "launches_l2"))
    for mod, attr in counters:
        setattr(mod, attr, 0)
    d, e = no_plain(lambda: band_to_bidiagonal_sbr(Ab, band=b, mid=mid))
    assert sum(getattr(mod, attr) for mod, attr in counters) == 1
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    want = torch.linalg.svdvals(A.double())
    assert float((torch.linalg.svdvals(B) - want).abs().max()) <= 1e-5 * float(want[0])


def test_cli_on_card(dev, tmp_path, capsys):
    from svdsolver_tpu_torch.cli import main

    assert main(["check", "64"]) == 0
    assert main(["check", "64", "--model", "tpu2"]) == 0
    assert "CHECK PASSED" in capsys.readouterr().out
    out = tmp_path / "tpu2.csv"
    assert main(["bench", "tpu2", "128", "3", "1", "32", "--output", str(out)]) == 0
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 3 and lines[0].replace(" ", "") == "128,256"


# ---- the sharded entries (parallel/): ranks sharing the card over gloo ----

def test_superstep_kernel_bit_equal_to_the_sequential_chase_on_one_rank(dev, rng):
    """At tp = 1 one pass runs every sweep whole and in order: the
    pipelined chase through the superstep kernel gives the L2 kernel's
    (d, e) bit for bit (1024/b32, each group size)."""
    from svdsolver_tpu_torch.parallel import band_to_bidiagonal_pipelined
    from svdsolver_tpu_torch.parallel.mesh import single_rank

    A = torch.from_numpy(rng.uniform(0, 5, (1024, 1024)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=32)
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=32)
    for lg in (None, 1, 5):
        with single_rank() as mesh:
            before = band_chase.launches_superstep
            d, e = band_to_bidiagonal_pipelined(Ab, mesh, band=32, sweeps_per_group=lg)
            assert band_chase.launches_superstep > before
        assert torch.equal(d, d0) and torch.equal(e, e0), lg


def test_pipelined_chase_on_two_ranks_sharing_the_card(dev, rng):
    """tp = 2, each rank's passes through the superstep kernel and no plain
    version: the spectrum of (d, e) within 1e-5 sigma_max of the sequential
    chase's."""
    import torch_parallel_ranks as ranks
    from svdsolver_tpu_torch.parallel import spawn

    A = torch.from_numpy(rng.uniform(0, 5, (1024, 1024)).astype(np.float32)).to(dev)
    Ab = panel_qr.dense_to_band_fused(A, band=32)
    d, e, counts = spawn(ranks.card_pipelined, 2, dp=1, args=(Ab.cpu().numpy(), 32),
                         timeout=600)
    assert counts["band_chase_superstep"] > 0
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab, band=32)

    def sigma(d, e):
        return torch.linalg.svdvals(torch.diag(d.double()) + torch.diag(e.double(), 1))

    s0, s1 = sigma(d0.cpu(), e0.cpu()), sigma(d, e)
    assert float((s1 - s0).abs().max() / s0[0]) < 1e-5


def test_svdvals_sharded_on_two_ranks_runs_the_kernels(dev, rng):
    """``svdvals_sharded`` at 1024/b128 on 2 ranks: K1, the routed chase and
    K2 launched on rank 0, no plain version; sigma against float64."""
    import torch_parallel_ranks as ranks
    from svdsolver_tpu_torch.parallel import spawn

    A = rng.uniform(0, 5, (1024, 1024)).astype(np.float32)
    sig, counts = spawn(ranks.card_svdvals, 2, dp=1, args=(A, 128), timeout=600)
    assert counts["panel_qr"] == 2 * 1024 // 128 and counts["bisect"] == 1
    assert counts["band_chase_wave"] + counts["band_chase_wave_l2"] + \
        counts["band_chase_staged"] + counts["band_chase"] == 1
    ref = torch.linalg.svdvals(torch.from_numpy(A).double())
    assert float((sig.double() - ref).abs().max() / ref[0]) < 1e-5
