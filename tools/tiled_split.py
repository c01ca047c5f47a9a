"""Split the time of the tiled Stage I's two kernels on the card.

    python3 tools/tiled_split.py [--root DIR] [--stamps | --full | --oracle DIR]
    python3 tools/tiled_split.py --wide [--stamps | --plans]

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

With ``--wide`` it times the wide route's chains at WIDE_SHAPES ((960,
192), (1024, 256)) the same way, on 1- and 2-slab half-sweeps: the
device-memory chain (``csrc/tiled_wide.cu``), the cluster chain
(``csrc/tiled_wide_cluster.cu`` at ``tiled_slab.wide_chain_plan``), the
cluster chain alone (its latency bound) and the cluster chain again,
then the apply kernel's wide instance on the chain's history; with
``--wide --stamps`` it builds both wide chains with
``SVDT_SPLIT_STAMPS`` and prints where a TS slab's step goes in each (the
wait, the pivot column's update, the reflector, the broadcast or block
barrier, the apply) at 1024/t256; with ``--wide --plans`` it times the
cluster chain and the chain alone on the 2-slab half-sweeps at every
columns a warp of the instances (built with ``SVDT_WIDE_PLANS``) and 4, 8
and 16 ring slots (the choices ``tiled_slab.wide_chain_plan`` was fixed
from).
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
WIDE_SHAPES = ((960, 192), (1024, 256))
P, I = ctypes.c_void_p, ctypes.c_int
CLUSTER_ARGS = [P] + [I] * 5 + [P, P] + [I] * 6 + [P]


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
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tiled_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    csrc = Path(args.root).resolve() / "svdsolver_tpu_torch" / "csrc"
    defines = []
    label = Path(args.root).resolve().name
    if args.wide:
        return wide_stamps(csrc, label) if args.stamps else wide(csrc, label, args.plans)
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


def wide(csrc, label, plans=False):
    """The wide route's chains at WIDE_SHAPES on 1- and 2-slab
    half-sweeps (top = n - slabs t, pivots from 0): the device-memory
    chain, the cluster chain, the cluster chain alone, the cluster chain
    again, then the apply on the cluster chain's history.  With ``plans``:
    the cluster chain and the chain alone on the 2-slab half-sweeps under
    every plan of the instances' columns a warp and 4, 8, 16 slots."""
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    tag = f"{label} | {card()}"
    dev = build(csrc / "tiled_wide.cu", [], label, "svdt_tiled_wide_chain",
                [P] + [I] * 5 + [P, P, I, P, P])
    flags, tag_c = (["-DSVDT_WIDE_PLANS"], f"{label}_plans") if plans else ([], label)
    entries = {e: build(csrc / "tiled_wide_cluster.cu", flags, tag_c, e, CLUSTER_ARGS)
               for e in ("svdt_tiled_wide_chain_cluster", "svdt_tiled_wide_chain_cluster_alone")}
    apply = build(csrc / "tiled_apply.cu", [], label, "svdt_tiled_apply",
                  [P] + [I] * 11 + [P, P, P])
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, t in WIDE_SHAPES:
        a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
        A0 = torch.from_numpy(a).cuda()
        plan, ap_ = tiled_slab.wide_chain_plan(t), tiled_slab.apply_plan(n, t, sms)
        vld = tiled_slab.wide_vld(t)
        block = torch.empty((t, 2 * t), device="cuda")
        if plans:
            rpl = tiled_slab.wide_chain_plan(t).rpl
            top, m = n - 2 * t, 1
            V = torch.empty((2, t, vld), device="cuda")
            tau = torch.empty((2, t), device="cuda")
            M = A0.clone()
            for cols in tiled_slab.WIDE_CHAIN_INSTANCES[rpl]:
                for slots in (4, 8, 16):
                    p = tiled_slab.wide_chain_plan(t, cols, slots)
                    got = []
                    for e in ("svdt_tiled_wide_chain_cluster",
                              "svdt_tiled_wide_chain_cluster_alone"):
                        def run(e=e):
                            err = entries[e](M.data_ptr(), n, top, 0, t, m, V.data_ptr(),
                                             tau.data_ptr(), vld, p.ctas, p.cols, p.rpl,
                                             p.slots, p.smem, stream)
                            if err:
                                raise RuntimeError(f"{e}: cudaError_t {err}")
                        got.append(ms(run, restore=lambda: M.copy_(A0)))
                    print(f"[split] n={n} t={t} 2 slabs: cluster chain at {cols} columns a "
                          f"warp ({p.ctas} CTAs), {slots} slots: {got[0]:.4f} ms "
                          f"({got[0] * 1e3 / (2 * t):.3f} us a step), alone {got[1]:.4f} ms "
                          f"{tag}", flush=True)
            continue
        for slabs in (1, 2):
            top, pc, m = n - slabs * t, 0, slabs - 1
            V = torch.empty((slabs, t, vld), device="cuda")
            tau = torch.empty((slabs, t), device="cuda")
            M = A0.clone()

            def check(err, what):
                if err:
                    raise RuntimeError(f"{what}: cudaError_t {err}")

            runs = (("device-memory chain", lambda: check(dev(
                        M.data_ptr(), n, top, pc, t, m, V.data_ptr(), tau.data_ptr(), vld,
                        block.data_ptr(), stream), "tiled_wide_chain")),)
            for e in ("svdt_tiled_wide_chain_cluster", "svdt_tiled_wide_chain_cluster_alone",
                      "svdt_tiled_wide_chain_cluster"):
                runs += ((e, lambda e=e: check(entries[e](
                    M.data_ptr(), n, top, pc, t, m, V.data_ptr(), tau.data_ptr(), vld,
                    plan.ctas, plan.cols, plan.rpl, plan.slots, plan.smem, stream), e)),)
            for name, run in runs:
                t_ms = ms(run, restore=lambda: M.copy_(A0))
                print(f"[split] n={n} t={t} {slabs} slab(s): {name} {t_ms:.4f} ms "
                      f"({t_ms * 1e3 / (slabs * t):.3f} us a step; {plan.ctas} CTAs) {tag}",
                      flush=True)
            chained = M.clone()  # the last run: the cluster chain's block and history

            def run_apply():
                check(apply(M.data_ptr(), n, n, top, pc, t, m, ap_.width, ap_.ctas,
                            ap_.threads, ap_.rpl, ap_.smem, V.data_ptr(), tau.data_ptr(),
                            stream), "tiled_apply")

            t_ms = ms(run_apply, restore=lambda: M.copy_(chained))
            print(f"[split] n={n} t={t} {slabs} slab(s): apply {t_ms:.4f} ms "
                  f"({t_ms * 1e3 / (slabs * t):.3f} us a step) {tag}", flush=True)
    return 0


def wide_stamps(csrc, label):
    """A 2-slab half-sweep at n = 1024, t = 256 through each wide chain
    built with SVDT_SPLIT_STAMPS: the percentiles over the TS slab's
    steps of each part of a step (cycles of one SM's clock; a difference
    of two stamps of one warp)."""
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    tag = f"{label} | {card()}"
    n, t = WIDE_SHAPES[1]
    a = np.random.default_rng(0).uniform(0, 5, (n, n)).astype(np.float32)
    stream = torch.cuda.current_stream().cuda_stream
    vld = tiled_slab.wide_vld(t)
    V = torch.empty((2, t, vld), device="cuda")
    tau = torch.empty((2, t), device="cuda")

    def stamped(src, entry, argtypes, setter, shape):
        fn = build(csrc / src, ["-DSVDT_SPLIT_STAMPS"], f"{label}_stamps", entry, argtypes)
        lib = ctypes.CDLL(str(REPO / "build" / "tiled_split" /
                              f"lib{Path(src).stem}_{label}_stamps.so"))
        getattr(lib, setter).argtypes = [P]
        st = torch.zeros(shape + (128, 8), dtype=torch.int64, device="cuda")
        if getattr(lib, setter)(st.data_ptr()):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        return fn, st

    def show(name, arr):
        q = np.percentile(arr, [10, 50, 90])
        print(f"[stamps] {name}: p10 {q[0]:.0f}, median {q[1]:.0f}, p90 {q[2]:.0f} cycles "
              f"{tag}", flush=True)

    # the device-memory chain: warp (j + 1) % 16 owns the next pivot
    fn, st = stamped("tiled_wide.cu", "svdt_tiled_wide_chain", [P] + [I] * 5 + [P, P, I, P, P],
                     "svdt_tiled_wide_stamps", (16,))
    M = torch.from_numpy(a).cuda()
    block = torch.empty((t, 2 * t), device="cuda")
    err = fn(M.data_ptr(), n, n - 2 * t, 0, t, 1, V.data_ptr(), tau.data_ptr(), vld,
             block.data_ptr(), stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"cudaError_t {err}")
    S = st.cpu().numpy().astype(np.float64)
    steps = range(127)
    own = [(j + 1) % 16 for j in steps]
    print(f"[stamps] device-memory chain n={n} t={t}, TS slab steps 0-126:", flush=True)
    show("step period (warp 0's step starts)", np.diff(S[0, :128, 0]))
    show("pivot: its column's update", [S[own[j], j, 1] - S[own[j], j, 0] for j in steps])
    show("pivot: reflector", [S[own[j], j, 2] - S[own[j], j, 1] for j in steps])
    show("pivot: its other columns' applies", [S[own[j], j, 3] - S[own[j], j, 2] for j in steps])
    show("other warps: applies", [S[w, j, 3] - S[w, j, 0] for j in steps for w in range(16)
                                  if w != own[j]])
    show("block barrier (a warp's wait)", (S[:, :127, 4] - S[:, :127, 3]).ravel())

    # the cluster chain: CTA (j + 1) // W, its warp (j + 1) % 16 owns the next pivot
    plan = tiled_slab.wide_chain_plan(t)
    W = 16 * plan.cols
    fn, st = stamped("tiled_wide_cluster.cu", "svdt_tiled_wide_chain_cluster", CLUSTER_ARGS,
                     "svdt_tiled_wide_cluster_stamps", (plan.ctas, 16))
    M = torch.from_numpy(a).cuda()
    err = fn(M.data_ptr(), n, n - 2 * t, 0, t, 1, V.data_ptr(), tau.data_ptr(), vld, plan.ctas,
             plan.cols, plan.rpl, plan.slots, plan.smem, stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"cudaError_t {err}")
    S = st.cpu().numpy().astype(np.float64)
    own = [((j + 1) // W, (j + 1) % W % 16) for j in steps]
    print(f"[stamps] cluster chain n={n} t={t} ({plan.ctas} CTAs of {W} columns), TS slab "
          "steps 0-126:", flush=True)
    show("step period (publications of consecutive reflectors on one SM)",
         [S[c2, w2, j + 1, 4] - S[c, w, j, 4] for j, ((c, w), (c2, w2))
          in enumerate(zip(own[:-1], own[1:])) if c == c2])
    show("pivot: wait for its reflector", [S[c, w, j, 1] - S[c, w, j, 0]
                                           for j, (c, w) in enumerate(own)])
    show("pivot: its column's update", [S[c, w, j, 2] - S[c, w, j, 1]
                                        for j, (c, w) in enumerate(own)])
    show("pivot: claim of its slot before the wait (the empty barrier)",
         [S[c, w, j, 0] - S[c, w, j, 6] for j, (c, w) in enumerate(own)])
    show("pivot: reflector", [S[c, w, j, 3] - S[c, w, j, 2] for j, (c, w) in enumerate(own)])
    show("pivot: broadcast (arrival, remote copies)", [S[c, w, j, 4] - S[c, w, j, 3]
                                                      for j, (c, w) in enumerate(own)])
    show("pivot: history and its other columns' apply", [S[c, w, j, 5] - S[c, w, j, 4]
                                                         for j, (c, w) in enumerate(own)])
    show("other warps: wait", [S[c, w, j, 1] - S[c, w, j, 0] for j in steps
                               for c in range(plan.ctas) for w in range(16) if (c, w) != own[j]])
    show("other warps: apply", [S[c, w, j, 5] - S[c, w, j, 1] for j in steps
                                for c in range(plan.ctas) for w in range(16) if (c, w) != own[j]])
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
