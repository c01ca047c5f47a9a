"""The command line, with the reference's benchmark and check surface
(twin of ``svdsolver_tpu/cli.py``; same arguments, same CSV schema, plus
``--device``).

Benchmark mode:

    python -m svdsolver_tpu_torch bench MODEL step n_steps n_instances [block]

with MODEL in {base, singlecore, multicore, diagonal, tpu1, tpu2, jacobi}.
Sweeps N = k*step for k = 1..n_steps-1 over ``n_instances`` uniform [0, 5]
matrices a size, prints the mean seconds an instance, and writes
``data/<model>_benchmark.csv`` (sizes, stage-1 seconds, and stage-2 seconds
for a two-stage model).  The two-stage models time the functions
``bidiagonalize(method=MODEL)`` calls on that device: on the card for
``tpu2`` the panel kernel (Stage I) and the routed chase kernel.

Check mode:

    python -m svdsolver_tpu_torch check {64|512|1024} [--band 4] [--dtype float|double]
        [--model xla|tpu2] [--data-dir DIR]

``xla`` (the JAX package's name for its plain path): the plain two-stage
reduction at band 4 against the shipped ``band_*`` and ``bidiagonal_*``
fixtures, and sigma against LAPACK.  ``tpu2``: the panel kernel, the
routed chase kernel and the bisection kernel on the card, sigma against
LAPACK.  Size 1024 is generated once by the native C++ oracle into
``--data-dir`` (default the repository's ``data/``).

``--device {cuda,cpu}`` (default ``cuda``): where the tensors live.  The
entry points run on the CPU only when asked to; with no card ``cuda``
raises.
"""

import argparse
import sys
import time

import numpy as np
import torch


def _device(args):
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card, and none is available; "
                           "pass --device cpu to run on the CPU")
    return torch.device(args.device)


def _dtypes(args):
    if args.dtype == "double":
        return np.float64, torch.float64
    return np.float32, torch.float32


def _make_matrices(n, count, rng, dtype, device, min_val=0.0, max_val=5.0):
    return [
        torch.as_tensor(rng.uniform(min_val, max_val, size=(n, n)).astype(dtype), device=device)
        for _ in range(count)
    ]


def _make_bidiagonals(n, count, rng, dtype, device, min_val=0.0, max_val=5.0):
    return [
        (torch.as_tensor(rng.uniform(min_val, max_val, size=n).astype(dtype), device=device),
         torch.as_tensor(rng.uniform(min_val, max_val, size=n - 1).astype(dtype),
                         device=device))
        for _ in range(count)
    ]


def _device_name(device):
    if device.type == "cuda":
        return f"cuda: {torch.cuda.get_device_name(device)}"
    return "cpu"


def cmd_bench(args):
    from svdsolver_tpu_torch.models.blocked import bidiagonalize_blocked
    from svdsolver_tpu_torch.models.golub_kahan import bidiagonalize_gk
    from svdsolver_tpu_torch.models.svd import diagonalizer, two_stage_fns
    from svdsolver_tpu_torch.utils.csvout import write_benchmark_csv
    from svdsolver_tpu_torch.utils.timing import benchmark

    device = _device(args)
    model = args.model
    np_dtype, _ = _dtypes(args)
    rng = np.random.default_rng(args.seed)
    sizes, y, z = [], [], []
    print(f"Model: {model}  step={args.step} steps={args.n_steps} "
          f"instances={args.n_instances} block={args.block} dtype={args.dtype}")
    print(f"device: {_device_name(device)}")

    for k in range(1, args.n_steps):
        n = k * args.step
        t2 = None
        if model == "diagonal":
            data = _make_bidiagonals(n, args.n_instances, rng, np_dtype, device)
            solver = diagonalizer("tpu2", args.diag, data[0][0])
            t1 = benchmark(lambda de: solver(de[0], de[1]), data)
            print(f"\tN = {n} : {t1:g} sec (bidiagonal -> diagonal, {args.diag})")
        else:
            data = _make_matrices(n, args.n_instances, rng, np_dtype, device)
            if model == "base":
                t1 = benchmark(bidiagonalize_gk, data)
                print(f"\tN = {n} : {t1:g} sec (dense -> bidiagonal)")
            elif model == "singlecore":
                t1 = benchmark(lambda A: bidiagonalize_blocked(A, panel=args.block), data)
                print(f"\tN = {n} : {t1:g} sec (dense -> bidiagonal)")
            elif model == "jacobi":
                from svdsolver_tpu_torch.models.jacobi import svd_jacobi

                t1 = benchmark(lambda A: svd_jacobi(A, block=args.block)[1], data)
                print(f"\tN = {n} : {t1:g} sec (full SVD, block Jacobi)")
            else:  # multicore, tpu1, tpu2
                pad = (-n) % args.block
                if pad:  # the reference requires divisibility; pad instead
                    data = [torch.nn.functional.pad(A, (0, pad, 0, pad)) for A in data]
                stage1, stage2 = two_stage_fns(model, data[0])
                t1 = benchmark(lambda A: stage1(A, band=args.block), data)
                banded = [stage1(A, band=args.block) for A in data]
                t2 = benchmark(lambda A: stage2(A, band=args.block), banded)
                print(f"\tN = {n} : {t1:g} sec (dense -> band) | "
                      f"{t2:g} sec (band -> bidiagonal) | {t1 + t2:g} sec (total)")
        sizes.append(n)
        y.append(t1)
        if t2 is not None:
            z.append(t2)

    path = args.output or f"data/{model}_benchmark.csv"
    write_benchmark_csv(path, sizes, y, z if z else None)
    print(f"\nWrote results to {path}")


def _sigma_err(sig, sig_ref):
    return float(np.max(np.abs(sig - sig_ref[: len(sig)])) / sig_ref[0])


def cmd_check(args):
    from svdsolver_tpu_torch.models.svd import routed_chase, use_kernels
    from svdsolver_tpu_torch.models.two_stage import bidiagonalize_two_stage, dense_to_band
    from svdsolver_tpu_torch.utils import fixtures as fx

    device = _device(args)
    n = args.size
    np_dtype, dtype = _dtypes(args)
    if n == 1024:
        # not shipped by the reference; generated once by the native oracle
        fx.ensure_generated_fixtures(n, np_dtype, band=args.band, data_dir=args.data_dir)
    A0 = fx.load_fixture("test", n, np_dtype, data_dir=args.data_dir)
    sig_ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    tol = 1e-5 if np_dtype == np.float32 else 1e-10

    if args.model == "tpu2":
        # the hand-written kernels: panel Stage I, routed chase, bisection,
        # gated on sigma against LAPACK (the band-4 fixtures are keyed to
        # the reference's band-4 reduction)
        if not use_kernels(torch.empty(0, dtype=dtype, device=device)):
            print("CHECK SKIPPED: tpu2 model needs a CUDA card and fp32")
            return 0
        from svdsolver_tpu_torch.ops.cuda import bisect, panel_qr

        band = args.band if args.band != 4 else (128 if n >= 256 else 16)
        pad = (-n) % band
        A = torch.as_tensor(np.pad(A0, ((0, pad), (0, pad))), device=device)
        t0 = time.perf_counter()
        Ab = panel_qr.dense_to_band_fused(A, band=band)
        Abn = Ab[:n, :n].cpu().numpy()
        t_band = time.perf_counter() - t0
        rel_band = _sigma_err(np.linalg.svd(Abn.astype(np.float64), compute_uv=False), sig_ref)
        print(f"panel kernel band reduction N={n} band={band}: {t_band:.3f}s  "
              f"max |sigma - sigma_lapack| / ||A||_2 = {rel_band:.3e}")
        d, e = routed_chase(Ab, band)
        sig = bisect.bisect_svdvals(d.contiguous(), e.contiguous())[:n].cpu().numpy()
        rel = _sigma_err(sig, sig_ref)
        print(f"chase kernel + bisection kernel: "
              f"max |sigma - sigma_lapack| / ||A||_2 = {rel:.3e}")
        ok = rel_band < tol and rel < tol
        print("CHECK PASSED" if ok else "CHECK FAILED")
        return 0 if ok else 1

    band = args.band
    pad = (-n) % band
    A = torch.as_tensor(np.pad(A0, ((0, pad), (0, pad))), device=device)

    t0 = time.perf_counter()
    Ab = dense_to_band(A, band=band)[:n, :n].cpu().numpy()
    t_band = time.perf_counter() - t0
    mse_band = fx.band_mse(Ab, fx.load_fixture("band", n, np_dtype, data_dir=args.data_dir), band)
    print(f"band reduction    N={n} band={band}: {t_band:.3f}s  "
          f"MSE vs fixture = {mse_band:.3e}")

    d, e = bidiagonalize_two_stage(A, band=band)
    d, e = d[:n].cpu().numpy(), e[: n - 1].cpu().numpy()
    B = np.diag(d) + np.diag(e, 1)
    bidiag_ref = fx.load_fixture("bidiagonal", n, np_dtype, data_dir=args.data_dir)
    print(f"bidiagonalization N={n}: MSE vs fixture = {fx.band_mse(B, bidiag_ref, 1):.3e}")

    # the external oracle: singular values against LAPACK to ~eps ||A||
    rel = _sigma_err(np.linalg.svd(B.astype(np.float64), compute_uv=False), sig_ref)
    print(f"max |sigma - sigma_lapack| / ||A||_2 = {rel:.3e}")
    ok = rel < tol
    print("CHECK PASSED" if ok else "CHECK FAILED")
    return 0 if ok else 1


def _read(args):
    from svdsolver_tpu_torch.utils.fixtures import read_matrix

    device = _device(args)
    np_dtype, _ = _dtypes(args)
    A = read_matrix(args.path, args.n, args.n, np_dtype)
    return A, torch.as_tensor(A, device=device)


def cmd_svdvals(args):
    from svdsolver_tpu_torch.models.svd import svdvals

    _, A = _read(args)
    s = svdvals(A, method=args.model).cpu().numpy()
    if args.output:
        s.tofile(args.output)
        print(f"wrote {len(s)} singular values to {args.output}")
    else:
        np.set_printoptions(precision=6, suppress=False, threshold=50)
        print(s)
    return 0


def cmd_svd(args):
    from svdsolver_tpu_torch.models.vectors import svd, svds

    A, At = _read(args)
    U, s, Vh = svds(At, args.k) if args.k else svd(At)
    U, s, Vh = (x.cpu().numpy() for x in (U, s, Vh))
    # residual report: ||A V - U S|| holds for full and top-k outputs
    res = float(np.max(np.abs(A @ Vh.T - U * s[None, :])) / max(float(s[0]), 1e-30))
    print(f"computed {s.shape[0]} singular triplet(s); max residual "
          f"|A v - s u| / sigma_0 = {res:.3e}")
    if args.output_prefix:
        U.tofile(args.output_prefix + "_U.bin")
        s.tofile(args.output_prefix + "_s.bin")
        Vh.tofile(args.output_prefix + "_Vh.bin")
        print(f"wrote {args.output_prefix}_{{U,s,Vh}}.bin "
              f"(shapes {U.shape}, {s.shape}, {Vh.shape})")
    else:
        np.set_printoptions(precision=6, suppress=False, threshold=50)
        print(s)
    return 0


def _add_common(p):
    p.add_argument("--dtype", choices=["float", "double"], default="float")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the tensors live (default cuda; cpu runs the "
                        "plain PyTorch versions)")


def main(argv=None):
    from svdsolver_tpu_torch.utils.fixtures import REPO_DATA

    p = argparse.ArgumentParser(prog="svdsolver_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("bench", help="benchmark sweep (reference CLI parity)")
    pb.add_argument("model", choices=[
        "base", "singlecore", "multicore", "diagonal", "tpu1", "tpu2", "jacobi"])
    pb.add_argument("step", type=int)
    pb.add_argument("n_steps", type=int)
    pb.add_argument("n_instances", type=int)
    pb.add_argument("block", type=int, nargs="?", default=32)
    pb.add_argument("--diag", choices=["bisect", "qr", "dqds"], default="bisect",
                    help="diagonalization algorithm for the 'diagonal' model")
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--output", default=None)
    _add_common(pb)
    pb.set_defaults(fn=cmd_bench)

    pc = sub.add_parser("check", help="fixture correctness check")
    pc.add_argument("size", type=int, choices=[64, 512, 1024])
    pc.add_argument("--band", type=int, default=4)
    pc.add_argument(
        "--model", choices=["xla", "tpu2"], default="xla",
        help="xla: the plain band-4 path against the fixtures; tpu2: the "
             "panel, chase and bisection kernels, gated on sigma vs LAPACK")
    pc.add_argument("--data-dir", default=REPO_DATA,
                    help="fixture directory (size 1024 is generated there)")
    _add_common(pc)
    pc.set_defaults(fn=cmd_check)

    ps = sub.add_parser("svdvals", help="singular values of a raw binary matrix file")
    ps.add_argument("path", help="row-major binary matrix (reference format)")
    ps.add_argument("n", type=int, help="matrix dimension (n x n)")
    ps.add_argument("--model", default="tpu2", choices=[
        "base", "singlecore", "multicore", "tpu1", "tpu2"])
    ps.add_argument("--output", default=None,
                    help="write sigma as raw binary instead of printing")
    _add_common(ps)
    ps.set_defaults(fn=cmd_svdvals)

    pv = sub.add_parser("svd", help="full (or top-k) SVD of a raw binary matrix file")
    pv.add_argument("path", help="row-major binary matrix (reference format)")
    pv.add_argument("n", type=int, help="matrix dimension (n x n)")
    pv.add_argument("-k", type=int, default=None,
                    help="compute only the top-k singular triplets")
    pv.add_argument("--output-prefix", default=None,
                    help="write <prefix>_{U,s,Vh}.bin instead of printing s")
    _add_common(pv)
    pv.set_defaults(fn=cmd_svd)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
