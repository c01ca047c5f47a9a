"""Time the two diagonalizer kernels of one checkout of the port on the card.

    python3 tools/diag_times.py [--root DIR] [--label NAME] [--inputs FILE]

Imports ``svdsolver_tpu_torch`` from ``--root`` (default: this repository),
so an unpacked parent commit (``git archive HEAD | tar -x -C build/parent``)
and the working tree can be timed in turns in one call: parent, change,
change, parent, one process each.  The inputs are the main path's
bidiagonals, ``bidiagonalize`` of the uniform [0, 5) float32 matrix
(``default_rng(0)``) at n = 3840 and 1000; the first process makes them and
saves them to ``--inputs`` (default ``build/diag_inputs.pt``), later ones
load them, so every process times the same (d, e).  Each kernel runs to
convergence once after a warm-up on a small input, in float32 and in
float64 (the float32 (d, e) cast up), bracketed by CUDA events:
``bidiag_qr.converge`` (sweeps, zero-shift and shifted steps) and
``dqds.dqds_svdvals`` (sweeps, steps).  Where the checkout has the chain
entries (``chain_ns``), it also prints each chain's ns a step.  Every line
carries the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SIZES = (3840, 1000)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def inputs(path):
    if os.path.exists(path):
        return torch.load(path)
    from svdsolver_tpu_torch.models.svd import bidiagonalize

    made = {}
    for n in SIZES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        B = bidiagonalize(torch.from_numpy(a).cuda())
        made[n] = (B.d.contiguous().cpu(), B.e.contiguous().cpu())
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(made, path)
    return made


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default=None)
    ap.add_argument("--inputs", default=str(REPO / "build" / "diag_inputs.pt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diag_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    label = args.label or Path(args.root).name
    tag = f"| {card()}"
    t0 = time.perf_counter()
    data = inputs(args.inputs)
    g = np.random.default_rng(1)
    for dtype in (torch.float32, torch.float64):  # builds and warms both kernels
        d = torch.from_numpy(g.normal(size=64)).to("cuda", dtype)
        e = torch.from_numpy(g.normal(size=63)).to("cuda", dtype)
        bidiag_qr.converge(d, e)
        dqds.dqds_svdvals(d, e)
    torch.cuda.synchronize()
    print(f"[diag_times] {label}: set-up {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    if hasattr(bidiag_qr, "chain_ns"):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            ns = {k: bidiag_qr.chain_ns(dtype, k) for k in bidiag_qr.CHAINS}
            print(f"[diag_times] {label} chain {name}: QR zero-shift {ns['zero']:.2f} ns, "
                  f"shifted {ns['shifted']:.2f} ns, dqds {dqds.chain_ns(dtype):.2f} ns a step "
                  f"{tag}", flush=True)
    for n in SIZES:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            d, e = (x.to("cuda", dtype) for x in data[n])
            (_, _, _, info), qr_ms = event_ms(lambda: bidiag_qr.converge(d, e))
            info = info.tolist()
            (_, sweeps), dqds_ms = event_ms(lambda: dqds.dqds_svdvals(d, e, with_info=True))
            steps_qr, steps_dqds = info[2] + info[3], dqds.last_steps
            print(f"[diag_times] {label} n={n} {name}: bidiag_qr {qr_ms:.3f} ms ({info[0]} "
                  f"sweeps, {info[2]} zero-shift + {info[3]} shifted steps, "
                  f"{qr_ms * 1e6 / steps_qr:.2f} ns a step); dqds {dqds_ms:.3f} ms ({sweeps} "
                  f"sweeps, {steps_dqds} steps, {dqds_ms * 1e6 / steps_dqds:.2f} ns a step) "
                  f"{tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
