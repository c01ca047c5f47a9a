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

from svdsolver_tpu_torch import svdvals
from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr

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
    A = torch.from_numpy(rng.uniform(0, 5, (200, 200)).astype(np.float32)).to(dev)
    for mod in (panel_qr, band_chase, bisect):
        mod.launches = 0
    s = svdvals(A)
    assert panel_qr.launches and band_chase.launches and bisect.launches
    want = torch.linalg.svdvals(A.double())
    torch.testing.assert_close(s.double(), want, rtol=2e-5,
                               atol=1e-5 * float(want[0]))


def test_kernels_reject_float64(dev):
    with pytest.raises(TypeError):
        panel_qr.panel_qr(torch.zeros(4, 8, dtype=torch.float64, device=dev), 0)


def test_chase_kernel_rejects_wide_band(dev):
    with pytest.raises(ValueError, match="band"):
        band_chase.band_to_bidiagonal(torch.zeros(600, 600, device=dev), band=300)
