"""Hold the narrow instances of K1 and the chase kernels of one checkout bit
for bit to another's, on the card.

    python3 tools/narrow_bits.py save FILE   # under PYTHONPATH=<the other tree>
    python3 tools/narrow_bits.py cmp FILE    # under PYTHONPATH=<this tree>

A change that adds wide instances (panel widths past 256, bands past 256)
must leave the narrow ones' bits as they were.  ``save`` runs the checkout
on ``PYTHONPATH`` (e.g. an unpacked parent commit, ``git archive HEAD
svdsolver_tpu_torch | tar -x -C build/parent``) on seeded inputs and saves
every output: K1 (``panel_qr``) at six panels with b <= 256, the tiled
Stage I at four bands up to 160 (the two-kernel design and the first
design), and the L2
sequential chase, plain and recording, and the wavefront's L2 tick, plain,
recording and deferred-left, at five (n, band) with band <= 256 (bands
made once by the plain Stage I and saved beside the outputs, so both runs
chase the same band).  ``cmp`` runs this checkout on the same inputs and
exits non-zero unless every output is ``torch.equal`` to the saved one.
Run the two in one chip call, one process each.
"""

import sys

import numpy as np
import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave, panel_qr, tiled_slab

K1 = ((128, 3840, 0), (64, 1024, 0), (256, 1024, 0), (256, 2048, 1900), (200, 1000, 0),
      (128, 7680, 0))
CHASE = ((1024, 64), (640, 160), (768, 256), (512, 200), (1000, 256))
TILED = ((1024, 32), (1024, 64), (1024, 128), (640, 160))  # the tiled Stage I's narrow routes


def outputs(mode, path):
    out = {}
    rng = np.random.default_rng(3)
    for b, m, r in K1:
        Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).cuda()
        for k, x in zip("RVT", panel_qr.panel_qr(Pt, r)):
            out[f"k1 {b} {m} {r} {k}"] = x.cpu()
    for n, t in TILED:
        A = np.random.default_rng(n + t).uniform(0, 5, (n, n)).astype(np.float32)
        out[f"tiled {n} {t}"] = tiled_slab.dense_to_band_tiled(
            torch.from_numpy(A).cuda(), band=t).cpu()
    entries = (
        ("l2", band_chase.band_to_bidiagonal_l2),
        ("l2rec", band_chase.band_to_bidiagonal_accum_l2),
        ("wave_l2", lambda A, band: band_chase_wave.band_to_bidiagonal_wave(
            A, band=band, _tick="l2")),
        ("wave_rec_l2", lambda A, band: band_chase_wave.band_to_bidiagonal_wave_accum(
            A, band=band, _tick="l2")),
        ("wave_dl_l2", lambda A, band: band_chase_wave.band_to_bidiagonal_wave_dl(
            A, band=band, _tick="l2")))
    for n, b in CHASE:
        band_file = f"{path}.band_{n}_{b}.pt"
        if mode == "save":
            A = np.random.default_rng(n + b).uniform(0, 5, (n, n)).astype(np.float32)
            pad = (-n) % b
            Ap = torch.nn.functional.pad(torch.from_numpy(A).cuda(), (0, pad, 0, pad))
            Ab = two_stage.dense_to_band(Ap, band=b).contiguous()
            torch.save(Ab.cpu(), band_file)
        else:
            Ab = torch.load(band_file).cuda()
        for name, fn in entries:
            for i, x in enumerate(fn(Ab, band=b)):
                out[f"chase {n} {b} {name} {i}"] = x.cpu()
    torch.cuda.synchronize()
    return out


def main():
    mode, path = sys.argv[1], sys.argv[2]
    if mode not in ("save", "cmp"):
        raise SystemExit("usage: narrow_bits.py save|cmp FILE")
    out = outputs(mode, path)
    if mode == "save":
        torch.save(out, path)
        print(f"[bits] saved {len(out)} outputs")
        return 0
    old = torch.load(path)
    bad = [k for k in old if not torch.equal(old[k], out[k])]
    print(f"[bits] narrow instances against the saved build: {len(old) - len(bad)} of "
          f"{len(old)} outputs bit-equal; unequal: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
