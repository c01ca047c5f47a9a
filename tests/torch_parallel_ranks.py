"""Rank functions of the port's sharded entries, for ``spawn`` in
``tests/test_torch_parallel.py`` and ``tests/test_torch_cuda.py``.

A spawned rank imports the module of the function it runs, and the test
modules import JAX (``tests/conftest.py``), so the rank functions live here:
this module imports only torch, numpy and the port, and every function
checks that its rank never loaded JAX.  Each takes the rank's mesh (and
numpy inputs); ``spawn`` returns rank 0's result.
"""

import contextlib
import os
import sys

import torch

from svdsolver_tpu_torch.parallel import (
    band_to_bidiagonal_pipelined,
    dense_to_band_shardmap,
    svd_jacobi_sharded,
    svd_sharded,
    svdvals_batch_sharded,
    svdvals_batch_sharded_gspmd,
    svdvals_sharded,
)


def no_jax():
    if "jax" in sys.modules:
        raise AssertionError("a rank of the port imported jax")


def collectives(mesh):
    """Each collective on rank-dependent tensors over ``tp``, checked on
    every rank against what it must give; returns the checks made."""
    tp, me = mesh.shape["tp"], mesh.axis_index("tp")
    dev = mesh.device
    x = torch.arange(8, dtype=torch.float64, device=dev) + 10 * me
    want_sum = sum(torch.arange(8, dtype=torch.float64) + 10 * r for r in range(tp))
    checks = {
        "psum": torch.equal(mesh.psum(x, "tp").cpu(), want_sum),
        "pmax": torch.equal(mesh.pmax(x, "tp").cpu(), torch.arange(8.0).double() + 10 * (tp - 1)),
        "all_gather": torch.equal(
            mesh.all_gather(x[None], "tp", dim=0).cpu(),
            torch.stack([torch.arange(8.0).double() + 10 * r for r in range(tp)])),
        "all_gather stacked": tuple(mesh.all_gather(x, "tp", dim=1, tiled=False).shape) == (8, tp),
        "psum_scatter": torch.equal(mesh.psum_scatter(x, "tp").cpu(),
                                    want_sum[me * 8 // tp:(me + 1) * 8 // tp]),
    }
    ring = mesh.ppermute(x, "tp", [(i, (i + 1) % tp) for i in range(tp)])
    checks["ppermute ring"] = torch.equal(ring.cpu(), torch.arange(8.0).double()
                                          + 10 * ((me - 1) % tp))
    partial = mesh.ppermute(x, "tp", [(0, 1)])
    checks["ppermute zeros"] = bool((partial == 0).all()) if me != 1 else torch.equal(
        partial.cpu(), torch.arange(8.0).double())
    if not all(checks.values()):
        raise AssertionError(f"rank {mesh.rank}: {checks}")
    return sorted(checks)


def tp_cases(mesh, inp):
    """Every single-matrix case on a (1, tp) mesh (``inp``: numpy inputs by
    name, see ``tests/test_torch_parallel.py``)."""
    no_jax()
    out = {"collectives": collectives(mesh)}
    out["band f64"] = dense_to_band_shardmap(inp["A64"], mesh, band=16)
    out["band f32"] = dense_to_band_shardmap(inp["A32"], mesh, band=16)
    out["svdvals local"] = svdvals_sharded(inp["A256"], mesh, band=32)
    out["svdvals pipelined"] = svdvals_sharded(inp["A128"], mesh, band=16, stage2="pipelined")
    out["svd"] = svd_sharded(inp["Asvd"], mesh, band=8)
    for key, (Ab, b, lg) in inp["pipelined"].items():
        out[key] = band_to_bidiagonal_pipelined(Ab, mesh, band=b, sweeps_per_group=lg)
    for key in ("jacobi square", "jacobi graded", "jacobi padded"):
        out[key] = svd_jacobi_sharded(inp[key], mesh)
    no_jax()
    return out


def dp_cases(mesh, inp):
    """The batch entries on a (dp, tp) mesh, with the largest collective of
    the batch path and the ``ValueError`` of a batch ``dp`` does not
    divide."""
    no_jax()
    out = {}
    mesh.reset_stats()
    out["batch"] = svdvals_batch_sharded(inp["As"], mesh, band=8)
    out["largest"] = max(s["largest"] for s in mesh.stats().values())
    out["gspmd"] = svdvals_batch_sharded_gspmd(inp["As"], mesh, band=8)
    try:
        svdvals_batch_sharded(inp["As"][:3], mesh, band=8)
    except ValueError as exc:
        out["odd batch"] = str(exc)
    no_jax()
    return out


def both_meshes(mesh, inp):
    """:func:`tp_cases` on the (1, 4) ``mesh``, then :func:`dp_cases` on a
    (2, 2) mesh of the same ranks: ``(tp results, dp results)``."""
    from svdsolver_tpu_torch.parallel import make_mesh

    return tp_cases(mesh, inp), dp_cases(make_mesh(4, dp=2, device=mesh.device), inp)


def die_on_rank_1(mesh):
    """Rank 1 exits at once, as a crashed rank would; rank 0 returns."""
    if mesh.rank == 1:
        os._exit(3)
    return "rank 0 done"


@contextlib.contextmanager
def forbid_plain():
    """Every plain version an entry could run in place of a kernel
    (``ops.cuda.plain_versions``) replaced by a function that fails."""
    from svdsolver_tpu_torch.ops.cuda import plain_versions

    saved = [(mod, name, getattr(mod, name)) for mod, name in plain_versions()]

    def failing(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"the plain version {name} ran on the card")
        return fail

    for mod, name, _ in saved:
        setattr(mod, name, failing(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def launch_counts():
    """The launch counts of the kernels on the sharded paths."""
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_wave, bisect, panel_qr,
                                              tridiag_solve)

    return {"panel_qr": panel_qr.launches, "bisect": bisect.launches,
            "band_chase_staged": band_chase.launches_staged,
            "band_chase": band_chase.launches, "band_chase_wave": band_chase_wave.launches,
            "band_chase_wave_l2": band_chase_wave.launches_l2,
            "band_chase_superstep": band_chase.launches_superstep,
            "tridiag_solve": tridiag_solve.launches}


def reset_launches():
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_wave, bisect, panel_qr,
                                              tridiag_solve)

    panel_qr.launches = bisect.launches = tridiag_solve.launches = 0
    band_chase.launches = band_chase.launches_staged = band_chase.launches_superstep = 0
    band_chase_wave.launches = band_chase_wave.launches_l2 = 0


def card_pipelined(mesh, Ab, b):
    """The pipelined chase of the band ``Ab`` on the card, every plain
    version forbidden: ``(d, e, launches)``."""
    no_jax()
    A = torch.as_tensor(Ab, device=mesh.device)
    with forbid_plain():
        reset_launches()
        d, e = band_to_bidiagonal_pipelined(A, mesh, band=b)
        torch.cuda.synchronize()
        counts = launch_counts()
    return d, e, counts


def card_svdvals(mesh, A, b):
    """``svdvals_sharded`` of ``A`` on the card, every plain version
    forbidden: ``(sigma, launches)``."""
    no_jax()
    At = torch.as_tensor(A, device=mesh.device)
    with forbid_plain():
        reset_launches()
        sig = svdvals_sharded(At, mesh, band=b)
        torch.cuda.synchronize()
        counts = launch_counts()
    return sig, counts
