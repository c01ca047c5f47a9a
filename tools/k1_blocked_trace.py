"""Where the blocked K1's time goes on the card: one panel's device timeline.

    python3 tools/k1_blocked_trace.py [--first] [b m ...]

For each (b, m) panel (default 512 2048 and 1024 1024) of the uniform
[0, 5) float32 matrix (``default_rng(14)``, the first b rows of m), runs
``panel_qr.panel_qr`` past b = 256 (the blocked panel) once to warm up,
then twice under ``torch.profiler`` (the first launches under the
profiler wait on it) and prints the second call's device kernels in
start order: each one's name, start, duration and the gap since the last kernel
ended (negative where it ran beside another, as the T merges on the
second stream do under the next sub-panel).  Then the sums: the
sub-panels' kernel time, the products that ran alone (the update,
``svdt_panel_update``, and a merge, ``svdt_panel_merge``, that no
sub-panel covered; with ``--first`` the first design's Gram, its sum, Z
and the update) and those that started beside another kernel, the idle time between kernels, and the
wall time from the first kernel's start to the last one's end.  Each
total line carries the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from svdsolver_tpu_torch.ops.cuda import panel_qr  # noqa: E402


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


PRODUCTS = ("panel_update", "panel_merge", "panel_gemm", "panel_sum")


def trace(b, m, design):
    A = np.random.default_rng(14).uniform(0, 5, (m, m)).astype(np.float32)
    Pt = torch.from_numpy(A[:b]).cuda()
    panel_qr.panel_qr(Pt, 0, _design=design)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            panel_qr.panel_qr(Pt, 0, _design=design)
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    events = events[len(events) // 2:]  # the second call: both launch the same kernels
    t0, end = events[0].time_range.start, events[0].time_range.start
    sums = {"sub-panels": 0.0, "products alone": 0.0, "products beside": 0.0,
            "other": 0.0, "idle": 0.0}
    for e in events:
        start, dur = e.time_range.start, e.time_range.end - e.time_range.start
        gap = start - end
        print(f"[trace] b={b} m={m} {e.name[:48]:48s} start {start - t0:9.1f} us "
              f"dur {dur:7.1f} gap {gap:7.1f}")
        if "panel_qr_cluster" in e.name:
            sums["sub-panels"] += dur
        elif any(name in e.name for name in PRODUCTS):
            sums["products beside" if gap < 0 else "products alone"] += dur
        else:
            sums["other"] += dur
        sums["idle"] += max(gap, 0.0)
        end = max(end, e.time_range.end)
    parts = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in sums.items())
    print(f"[trace] b={b} m={m} products {design}: wall {(end - t0) / 1e3:.3f} ms from the "
          f"first kernel to the last; ms by part: {parts} | {card()}")


def main():
    design = "gemm" if "--first" in sys.argv else "cluster"
    args = [int(a) for a in sys.argv[1:] if a != "--first"] or [512, 2048, 1024, 1024]
    for b, m in zip(args[::2], args[1::2]):
        trace(b, m, design)


if __name__ == "__main__":
    main()
