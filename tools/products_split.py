"""Where the blocked K1's update kernel (``svdt_panel_update``) spends its
time on the card, phase by phase.

    python3 tools/products_split.py [b m r0 ...]

Builds ``csrc/panel_products.cu`` with ``SVDT_PRODUCT_STAMPS`` into
``build/products_split/`` (thread 0 of every CTA stamps ``clock64`` and
``%globaltimer`` at the end of each phase), factors the (b, m) panel of
the uniform [0, 5) float32 matrix (``default_rng(14)``, the first b rows
of m; default (512, 2048), as ``chip_smoke.time_k1_products``), then runs
sub-panel ``[r0, r0 + 64)``'s update (default the first and the last
sub-panel) on the stamped build, three times, and prints the third run's
phases: for the CTAs of W-row blocks and of V-row blocks apart, the median
and the largest µs (``%globaltimer``) of each phase, the spread of the
CTAs' first stamps, and the span from the first CTA's entry to the last
CTA's end.  The phases: entry (from the earliest CTA's entry), the copies
issued, the partial Gram, the first cluster barrier, the split sum, Z
pushed and the second barrier (V rows: the last barrier), the update.
Each line carries the card's name and power limit.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from svdsolver_tpu_torch.ops.cuda import _build, panel_qr, tiled_slab  # noqa: E402

PHASES = ("entry", "issued", "gram", "barrier 1", "sum", "Z + barrier 2", "update")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stamped_library():
    """The products' library built with SVDT_PRODUCT_STAMPS, its entries typed."""
    out_dir = REPO / "build" / "products_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libpanel_products_stamps-{_build._source_key('panel_products')}.so"
    if not out.exists():
        src = _build.CSRC / "panel_products.cu"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSVDT_PRODUCT_STAMPS", "-o", str(out),
               str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in panel_qr._PRODUCT_ENTRIES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.svdt_panel_update_stamps.argtypes = [ctypes.c_void_p]
    lib.svdt_panel_update_stamps.restype = ctypes.c_int
    return lib


def split(b, m, r0, lib):
    A = np.random.default_rng(14).uniform(0, 5, (m, m)).astype(np.float32)
    Pt = torch.from_numpy(A[:b]).cuda()
    _, Vt, Tt = panel_qr.panel_qr(Pt, 0)  # on the library without stamps
    normal, panel_qr._plib = panel_qr._products(), lib  # the wrapper launches the stamped build
    r1, p0 = min(b, r0 + panel_qr.BLOCK_NB), r0
    plan = panel_qr.update_plan(b, m, r0, r1, p0, tiled_slab._sms(Pt.device))
    above = torch.empty(r0 * (r1 - r0) + 1, device="cuda")
    stamps = torch.zeros((plan.clusters, plan.splits, 16), dtype=torch.int64, device="cuda")
    _build.raise_on_error(lib.svdt_panel_update_stamps(stamps.data_ptr()), "stamps")
    stream = torch.cuda.current_stream()
    for _ in range(3):
        W = Pt.clone()
        torch.cuda.synchronize()
        panel_qr._update(W, Vt, Tt, r0, r1, p0, plan, above.data_ptr(), stream)
        torch.cuda.synchronize()
    panel_qr._plib = normal
    gt = stamps[..., 8:].cpu().numpy().astype(np.float64) / 1e3  # us
    first = gt[..., 0].min()
    nv = r0 // panel_qr.BLOCK_NB
    head = (f"[split] b={b} m={m} sub-panel [{r0}, {r1}) ({plan.clusters} clusters x "
            f"{plan.splits} CTAs)")
    for label, rows in (("W rows", range(nv, plan.clusters)), ("V rows", range(nv))):
        if not len(rows):
            continue
        g = gt[list(rows)]
        last = 7 if label == "W rows" else 6
        parts = [g[..., 0] - first] + [g[..., i] - g[..., i - 1] for i in range(1, last)]
        cells = ", ".join(f"{name} {statistics.median(p.ravel()):.2f} / {p.max():.2f}"
                          for name, p in zip(PHASES, parts))
        print(f"{head} {label}: us median / largest over the CTAs: {cells} | {card()}")
    end = max(gt[:nv, :, 5].max() if nv else 0.0,
              gt[nv:, :, 6].max() if nv < plan.clusters else 0.0)
    print(f"{head}: first stamps spread over {gt[..., 0].max() - first:.2f} us; first entry to "
          f"last end {end - first:.2f} us | {card()}")


def main():
    if not torch.cuda.is_available():
        print("products_split: no CUDA device", file=sys.stderr)
        return 2
    lib = stamped_library()
    args = [int(a) for a in sys.argv[1:]] or [512, 2048, 0, 512, 2048, 448]
    for b, m, r0 in zip(args[::3], args[1::3], args[2::3]):
        split(b, m, r0, lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
