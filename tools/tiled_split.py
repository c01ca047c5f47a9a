"""Split the time of the tiled Stage I's two kernels on the card.

    python3 tools/tiled_split.py [--root DIR] [--stamps | --full | --oracle DIR]

Builds ``csrc/tiled_chain.cu`` and ``csrc/tiled_apply.cu`` of this
checkout (or of ``--root``, an unpacked other commit) under
``build/tiled_split/``, and
times one launch of each entry on the last two half-sweeps of the uniform
[0, 5) float32 matrix (``default_rng(0)``): a half-sweep of one slab (the
1-slab, t steps) and one of two (the 1-slab and a TS slab, 2t steps), at
n = 3840 (t = 128) and 1024 (t = 64): the chain (``svdt_tiled_chain``),
the chain alone (``svdt_tiled_chain_alone``: no apply to the other pivot
columns, its latency), the chain again, then the apply kernel on the
chain's history.  Each time is the median of 5 CUDA-event runs after a
warm-up, each run on fresh rows of the matrix (restored outside the
events); each line gives ms, us a step and the card's name and power
limit.  With ``--stamps`` it builds the chain with ``SVDT_SPLIT_STAMPS``
(every warp's clock stamps of one TS slab's steps) and prints where a
step's cycles go instead; with ``--full`` it times the whole tiled Stage I
at each shape through the build's entries; with ``--oracle DIR`` it holds
this tree's ``dense_to_band_tiled`` bit-equal to the first design of DIR
(an unpacked parent, ``git archive HEAD svdsolver_tpu_torch | tar -x -C
DIR``).
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
ENTRIES = ("svdt_tiled_chain", "svdt_tiled_chain_alone", "svdt_tiled_chain")
SHAPES = ((3840, 128), (1024, 64))
P, I = ctypes.c_void_p, ctypes.c_int


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def ms(fn, reps=5, restore=lambda: None):
    """Median ms of fn() over reps runs after a warm-up, each after
    restore() (outside the events: a factorization timed on its own output
    would time other numbers)."""
    restore()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def build(src, defines, tag, entry, argtypes):
    from svdsolver_tpu_torch.ops.cuda import _build

    out_dir = REPO / "build" / "tiled_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{src.stem}_{tag}.so"
    if out.exists():
        fn = getattr(ctypes.CDLL(str(out)), entry)
        fn.argtypes = argtypes
        fn.restype = I
        return fn
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[split] build {src.stem} {tag}: {line.strip()}", flush=True)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = argtypes
    fn.restype = I
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--oracle", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tiled_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    csrc = Path(args.root).resolve() / "svdsolver_tpu_torch" / "csrc"
    defines = []
    label = Path(args.root).resolve().name
    chains = {e: build(csrc / "tiled_chain.cu", defines, label, e, [P] + [I] * 5 + [P, P, I, I, P])
              for e in set(ENTRIES)}
    apply = build(csrc / "tiled_apply.cu", defines, label, "svdt_tiled_apply",
                  [P] + [I] * 11 + [P, P, P])
    tag = f"{args.root} | {card()}"
    if args.stamps:
        return stamps(csrc, defines, label, tag)
    if args.full:
        return full(chains["svdt_tiled_chain"], apply, tag)
    if args.oracle:
        return oracle(Path(args.oracle).resolve(), tag)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, t in SHAPES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        A0 = torch.from_numpy(a).cuda()
        plan = tiled_slab.chain_plan(t)
        ap_ = tiled_slab.apply_plan(n, t, sms)
        for slabs in (1, 2):
            top, pc, m = n - slabs * t, 0, slabs - 1
            V = torch.empty((slabs, t, 32 * plan.rpl), device="cuda")
            tau = torch.empty((slabs, t), device="cuda")
            M = A0.clone()
            for entry in ENTRIES:

                def run():
                    err = chains[entry](M.data_ptr(), n, top, pc, t, m, V.data_ptr(),
                                        tau.data_ptr(), plan.rpl, plan.smem, stream)
                    if err:
                        raise RuntimeError(f"{entry}: cudaError_t {err}")

                t_ms = ms(run, restore=lambda: M.copy_(A0))
                print(f"[split] n={n} t={t} {slabs} slab(s): {entry} {t_ms:.4f} ms "
                      f"({t_ms * 1e3 / (slabs * t):.3f} us a step) {tag}", flush=True)
            M.copy_(A0)
            chains["svdt_tiled_chain"](M.data_ptr(), n, top, pc, t, m, V.data_ptr(),
                                       tau.data_ptr(), plan.rpl, plan.smem, stream)
            chained = M.clone()

            def run_apply():
                err = apply(M.data_ptr(), n, n, top, pc, t, m, ap_.width, ap_.ctas, ap_.threads,
                            ap_.rpl, ap_.smem, V.data_ptr(), tau.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"tiled_apply: cudaError_t {err}")

            t_ms = ms(run_apply, restore=lambda: M.copy_(chained))
            print(f"[split] n={n} t={t} {slabs} slab(s): apply {t_ms:.4f} ms "
                  f"({t_ms * 1e3 / (slabs * t):.3f} us a step) {tag}", flush=True)
    return 0


def full(chain, apply, tag):
    """The whole tiled Stage I at SHAPES through this build's two entries
    (``models/tiled.tile_sweeps``, the LQ half on a transposed copy, as
    ``dense_to_band_tiled`` runs it): ms, the median of 3 after a warm-up."""
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, t in SHAPES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        A0 = torch.from_numpy(a).cuda()
        cp, ap_ = tiled_slab.chain_plan(t), tiled_slab.apply_plan(n, t, sms)
        V = torch.empty((n // t, t, 32 * cp.rpl), device="cuda")
        tau = torch.empty((n // t, t), device="cuda")

        def sweep(M, top, pc, t):
            m = (n - top) // t - 1
            if chain(M.data_ptr(), n, top, pc, t, m, V.data_ptr(), tau.data_ptr(), cp.rpl,
                     cp.smem, stream):
                raise RuntimeError("tiled_chain failed")
            if apply(M.data_ptr(), n, n, top, pc, t, m, ap_.width, ap_.ctas, ap_.threads,
                     ap_.rpl, ap_.smem, V.data_ptr(), tau.data_ptr(), stream):
                raise RuntimeError("tiled_apply failed")

        A = A0.clone()
        transpose = tiled_slab._transposer(A)
        t_ms = ms(lambda: tiled.tile_sweeps(A, t, sweep, transpose), reps=3,
                  restore=lambda: A.copy_(A0))
        print(f"[split] n={n} t={t}: the whole tiled Stage I {t_ms:.3f} ms {tag}", flush=True)
    return 0


def oracle(root, tag):
    """This tree's dense_to_band_tiled against every slab through the first
    design of ``root`` (``csrc/tiled_slab.cu`` of an unpacked other commit,
    launched as ``tiled_slab.factor_slab`` launches it) at SHAPES and at
    1024/t32: torch.equal, or the first differing entries."""
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    slab = build(root / "svdsolver_tpu_torch" / "csrc" / "tiled_slab.cu", [], "oracle",
                 "svdt_tiled_slab", [P] + [I] * 10 + [P, P])
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    same = True
    for n, t in SHAPES + ((1024, 32),):
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        A0 = torch.from_numpy(a).cuda()

        def factor(M, top, pc, t, bot):
            plan = tiled_slab.slab_plan(n, t, t if bot is None else 2 * t, sms)
            if slab(M.data_ptr(), M.stride(0), n, top, -1 if bot is None else bot, t, pc,
                    plan.width, plan.ctas, plan.rpl, plan.smem, counter.data_ptr(), stream):
                raise RuntimeError("the oracle's svdt_tiled_slab failed")

        A = A0.clone()
        want = tiled.tile_sweeps(A, t, tiled.slab_sweep(factor), tiled_slab._transposer(A))
        got = tiled_slab.dense_to_band_tiled(A0, band=t)
        torch.cuda.synchronize()
        eq = torch.equal(got, want)
        same = same and eq
        where = "" if eq else f"; first differing entries {(got != want).nonzero()[:4].tolist()}"
        print(f"[split] n={n} t={t}: dense_to_band_tiled torch.equal to {root}'s first "
              f"design: {eq}{where} {tag}", flush=True)
    return 0 if same else 1


def stamps(csrc, defines, label, tag):
    """One 2-slab half-sweep at n = 3840, t = 128 with every warp's clock
    stamps of the TS slab's steps (before the wait, after it, after the
    pivot's arrival, after the apply; the pivot's after its column's update
    and after the reflector); prints their percentiles over steps."""
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    src = csrc / "tiled_chain.cu"
    fn = build(src, defines + ["-DSVDT_SPLIT_STAMPS"], f"{label}_stamps", "svdt_tiled_chain",
               [P] + [I] * 5 + [P, P, I, I, P])
    lib = ctypes.CDLL(str(REPO / "build" / "tiled_split" / f"libtiled_chain_{label}_stamps.so"))
    lib.svdt_tiled_chain_stamps.argtypes = [P]
    n, t = SHAPES[0]
    plan = tiled_slab.chain_plan(t)
    warps = 16
    st = torch.zeros((warps, 128, 8), dtype=torch.int64, device="cuda")
    if lib.svdt_tiled_chain_stamps(st.data_ptr()):
        raise RuntimeError("cudaMemcpyToSymbol failed")
    a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
    M = torch.from_numpy(a).cuda()
    V = torch.empty((2, t, 32 * plan.rpl), device="cuda")
    tau = torch.empty((2, t), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(M.data_ptr(), n, n - 2 * t, 0, t, 1, V.data_ptr(), tau.data_ptr(), plan.rpl,
             plan.smem, stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"cudaError_t {err}")
    S = st.cpu().numpy().astype(np.float64)
    piv = [(j + 1) % warps for j in range(t - 1)]
    ready = np.array([S[piv[j], j, 2] for j in range(t - 1)])  # reflector j + 1 published
    period = np.diff(ready)
    pivot = np.array([S[piv[j], j, 2] - S[piv[j], j, 1] for j in range(t - 1)])
    handoff = np.array([S[piv[j + 1], j + 1, 1] - S[piv[j], j, 2] for j in range(t - 2)])
    late = np.array([S[piv[j + 1], j + 1, 0] - S[piv[j], j, 2] for j in range(t - 2)])
    upd = np.array([S[piv[j], j, 4] - S[piv[j], j, 1] for j in range(t - 1)])
    refl = np.array([S[piv[j], j, 5] - S[piv[j], j, 4] for j in range(t - 1)])
    publ = np.array([S[piv[j], j, 2] - S[piv[j], j, 5] for j in range(t - 1)])
    apply_ = (S[:, :, 3] - S[:, :, 1]).ravel()
    wait = (S[:, :, 1] - S[:, :, 0]).ravel()
    for name, arr in (("step period (cycles between reflectors)", period),
                      ("pivot: wait return to arrival", pivot),
                      ("pivot: its column's update (load, dot, butterfly, rank-1)", upd),
                      ("pivot: reflector", refl),
                      ("pivot: stores and arrival", publ),
                      ("next pivot's wait return after the arrival", handoff),
                      ("next pivot reaches its wait after the arrival (negative: early)", late),
                      ("a warp's step: wait return to apply end", apply_),
                      ("a warp's wait", wait)):
        q = np.percentile(arr, [10, 50, 90])
        print(f"[stamps] {name}: p10 {q[0]:.0f}, median {q[1]:.0f}, p90 {q[2]:.0f} cycles {tag}",
              flush=True)
    for j in (0, 1, 40, 100):
        print(f"[stamps] step {j}: " + "; ".join(
            f"w{w}:" + ",".join(f"{S[w, j, i] - S[piv[j], j, 1]:.0f}" for i in range(6))
            for w in range(warps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
