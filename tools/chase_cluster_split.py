"""Split and compare the time of the chases' cluster kernels (b > 256) on
the card.

    python3 tools/chase_cluster_split.py [--stamps] [--lanes]

With no flag it does both.  The band is a uniform [0, 5) float32
upper band of ``b`` superdiagonals made on the card from
``torch.Generator`` seed 0 (the time depends on the data only through
identity reflectors, which such a band does not have).

``--stamps`` builds ``csrc/band_chase_cluster.cu`` with
``SVDT_CLUSTER_STAMPS`` under ``build/chase_cluster_split/`` and runs the
sequential cluster kernel (kernel 1) once at 2048/b512: thread 0 of every
CTA stamps ``clock64`` at ten points of 64 pairs from pair 2000 on (the
right reflector, the first right chunk staged, the right apply, the
cluster barrier, the left reflector, the first left chunk staged, the
column sums, the left apply, the cluster barrier), and the tool prints
each phase's median cycles for CTA 0, CTA C/2 and CTA C - 1, the slowest
CTA's, and the pair period.

``--lanes`` times kernel 1 (``band_chase.band_to_bidiagonal``) and the
wavefront's cluster tick (kernel 2, ``band_chase_wave.
band_to_bidiagonal_wave(_tick="cluster")``) at C = 4, 8, 16 CTAs a
cluster (``band_chase.CLUSTER_MAX_CTAS`` set around each call) in turns
at the shapes of ``wave_lanes_needed``'s wide table, one to four lanes:
2048/b512, 1440/b288, 3840/b512, 6144/b512 (one run each, CUDA events,
kernel 1 first and last), then the recording entries of kernel 1 and of
kernel 2 at its fastest C.  Every timing line carries the card's
name and power limit.
"""

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
LANE_SHAPES = ((2048, 512), (1440, 288), (3840, 512), (6144, 512))
MARKS = ("right reflector", "right chunk staged", "right apply", "cluster barrier",
         "left reflector", "left chunk staged", "column sums", "left apply",
         "cluster barrier")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def band(n, b):
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.rand((n, n), generator=g, device="cuda") * 5
    i = torch.arange(n, device="cuda")
    return A * ((i[None, :] >= i[:, None]) & (i[None, :] - i[:, None] <= b))


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def build(defines, tag):
    """``csrc/band_chase_cluster.cu`` built with ``defines`` into
    ``build/chase_cluster_split/``, keyed by the package's build key of the
    source and its headers and by ``defines``; returns the loaded
    library."""
    from svdsolver_tpu_torch.ops.cuda import _build, band_chase

    src = _build.CSRC / "band_chase_cluster.cu"
    out_dir = REPO / "build" / "chase_cluster_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256((_build._source_key("band_chase_cluster") + " ".join(defines))
                         .encode()).hexdigest()[:16]
    out = out_dir / f"libband_chase_cluster_{tag}-{key}.so"
    if not out.exists():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[cluster-split] build {tag}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in band_chase._CLUSTER_ENTRIES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def run_seq(lib, Ab, b, plan):
    """Kernel 1 of ``lib`` on a copy of ``Ab``; returns (d, e)."""
    from svdsolver_tpu_torch.ops.cuda import _build, band_chase

    n = Ab.shape[0]
    work = Ab.clone()
    d = torch.empty(n, device="cuda")
    e = torch.empty(n - 1, device="cuda")
    err = lib.svdt_band_chase_cluster(work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                                      *band_chase.plan_args(plan), _build.stream_of(Ab))
    _build.raise_on_error(err, "band_chase_cluster (split build)")
    return d, e


def stamps(name):
    from svdsolver_tpu_torch.ops.cuda import band_chase

    n, b, first, count = 2048, 512, 2000, 64
    lib = build(["-DSVDT_CLUSTER_STAMPS"], "stamps")
    lib.svdt_chase_cluster_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.svdt_chase_cluster_stamps.restype = ctypes.c_int
    plan = band_chase.wide_chase_plan(n, b)
    C = plan.ctas
    buf = torch.zeros((count, C, len(MARKS) + 1), dtype=torch.int64, device="cuda")
    assert lib.svdt_chase_cluster_stamps(buf.data_ptr(), first, count) == 0
    Ab = band(n, b)
    (d, e), ms = event_ms(lambda: run_seq(lib, Ab, b, plan))
    want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    same = torch.equal(d, want[0]) and torch.equal(e, want[1])
    s = buf.cpu()
    print(f"[cluster-split] stamps n={n} b={b} C={C}: kernel 1 (stamped build) {ms:.3f} ms, "
          f"bit-equal to the L2 kernel {same}; pairs {first}..{first + count - 1} | {name}",
          flush=True)
    d_ = (s[:, :, 1:] - s[:, :, :-1]).float()  # (pair, CTA, phase)
    rows = [("CTA 0", d_[:, 0]), (f"CTA {C // 2}", d_[:, C // 2]), (f"CTA {C - 1}", d_[:, C - 1]),
            ("slowest CTA", d_.max(dim=1).values)]
    for label, m in rows:
        med = [statistics.median(m[:, k].tolist()) for k in range(len(MARKS))]
        print(f"[cluster-split]   {label}: " + ", ".join(
            f"{mk} {v:.0f}" for mk, v in zip(MARKS, med)) + f"; sum {sum(med):.0f} cycles",
            flush=True)
    period = (s[1:, 0, 0] - s[:-1, 0, 0]).float()
    print(f"[cluster-split]   pair period (CTA 0, start to start): median "
          f"{statistics.median(period.tolist()):.0f} cycles, min {float(period.min()):.0f}, "
          f"max {float(period.max()):.0f} | {name}", flush=True)


def tick(Ab, b, C, record=False):
    """Kernel 2 on ``Ab`` with the plan at C CTAs a cluster
    (``band_chase.CLUSTER_MAX_CTAS`` set around the call)."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    fn = (band_chase_wave.band_to_bidiagonal_wave_accum if record
          else band_chase_wave.band_to_bidiagonal_wave)
    saved = band_chase.CLUSTER_MAX_CTAS
    band_chase.CLUSTER_MAX_CTAS = C
    try:
        return fn(Ab, band=b, _tick="cluster")
    finally:
        band_chase.CLUSTER_MAX_CTAS = saved


def lanes(name):
    from svdsolver_tpu_torch.models import two_stage
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    for n, b in LANE_SHAPES:
        Ab = band(n, b)
        L = two_stage.wave_lanes(n, b)
        band_chase.band_to_bidiagonal(Ab, band=b)  # warm-up (builds, plans)
        _, k1a = event_ms(lambda: band_chase.band_to_bidiagonal(Ab, band=b))
        k2, ctas = {}, {}
        for C in (4, 8, 16):
            _, k2[C] = event_ms(lambda: tick(Ab, b, C))
            ctas[C] = band_chase_wave.last_ctas
        _, k1b = event_ms(lambda: band_chase.band_to_bidiagonal(Ab, band=b))
        best = min(k2, key=k2.get)
        _, r1 = event_ms(lambda: band_chase.band_to_bidiagonal_accum(Ab, band=b))
        _, r2 = event_ms(lambda: tick(Ab, b, best, record=True))
        print(f"[cluster-split] lanes n={n} b={b} ({L} lane(s)): kernel 1 {k1a:.3f} / "
              f"{k1b:.3f} ms; kernel 2 C=4 {k2[4]:.3f}, C=8 {k2[8]:.3f}, C=16 {k2[16]:.3f} ms "
              f"(CTAs {ctas}); recording: kernel 1 {r1:.3f}, "
              f"kernel 2 C={best} {r2:.3f} ms | {name}", flush=True)
        del Ab
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chase_cluster_split: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    every = not (args.stamps or args.lanes)
    if args.stamps or every:
        stamps(name)
    if args.lanes or every:
        lanes(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
