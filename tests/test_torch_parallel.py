"""The port's sharded entries (``svdsolver_tpu_torch/parallel``) held to the
JAX package's at the same mesh shape: JAX on ``make_mesh(4, dp=..., platform
="cpu")``, the port on 4 gloo ranks with ``device="cpu"`` (``spawn``).

One spawn of 4 ranks (a module fixture) runs every case of both mesh
shapes, (1, 4) and (2, 2), in a thread while the JAX side computes; the rank functions live in
``tests/torch_parallel_ranks.py``, which imports no JAX.  Inputs come from
numpy seeds.  The counterparts of ``tests/test_distributed.py`` that read
JAX's compiled HLO read the mesh's collective counts instead.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from svdsolver_tpu.parallel import distributed as jd
from svdsolver_tpu.parallel.jacobi import svd_jacobi_sharded as jax_jacobi
from svdsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.cuda import band_chase
from svdsolver_tpu_torch.parallel import (
    band_to_bidiagonal_pipelined,
    dense_to_band_shardmap,
    dryrun,
    spawn,
    svdvals_sharded,
)
from svdsolver_tpu_torch.parallel.distributed import pipeline_geometry
from svdsolver_tpu_torch.parallel.mesh import default_dp, single_rank

TIMEOUT = 240  # seconds a spawn may take before its ranks are killed
# the pipelined chase's cases: (n, band, sweeps_per_group, dtype); float64
# at each group size of the JAX test, float32 at its two shapes
PIPELINED = [(64, 8, None, np.float64), (64, 8, 1, np.float64), (64, 8, 2, np.float64),
             (96, 8, None, np.float32), (64, 4, None, np.float32)]
JACOBI = ("jacobi square", "jacobi graded", "jacobi padded")


def _pkey(n, b, lg, dtype):
    return f"pipelined {n}/{b} LG={lg} {np.dtype(dtype).name}"


def _inputs():
    rng = np.random.default_rng(586)
    inp = {
        "A64": rng.normal(size=(64, 64)),
        "A256": rng.normal(size=(256, 256)).astype(np.float32),
        "A128": rng.normal(size=(128, 128)).astype(np.float32),
        "Asvd": rng.normal(size=(64, 64)).astype(np.float32),
        "jacobi square": rng.normal(size=(64, 64)).astype(np.float32),
        "jacobi graded": (rng.normal(size=(64, 64)) @ np.diag(np.logspace(0, -6, 64))
                          ).astype(np.float32),
        "jacobi padded": rng.normal(size=(52, 52)).astype(np.float32),
        "As": rng.uniform(0, 5, (4, 32, 32)).astype(np.float32),
        "pipelined": {},
    }
    inp["A32"] = inp["A64"].astype(np.float32)
    for n, b, lg, dtype in PIPELINED:  # the band both packages chase
        A = torch.from_numpy(rng.normal(size=(n, n)).astype(dtype))
        inp["pipelined"][_pkey(n, b, lg, dtype)] = (
            two_stage.dense_to_band(A, band=b).numpy(), b, lg)
    return inp


def _jax_side(inp):
    m4 = jax_mesh(4, dp=1, platform="cpu")
    m22 = jax_mesh(4, dp=2, platform="cpu")
    out = {
        "band f64": jd.dense_to_band_shardmap(jnp.asarray(inp["A64"]), m4, band=16),
        "band f32": jd.dense_to_band_shardmap(jnp.asarray(inp["A32"]), m4, band=16),
        "svdvals local": jd.svdvals_sharded(jnp.asarray(inp["A256"]), m4, band=32),
        "svdvals pipelined": jd.svdvals_sharded(jnp.asarray(inp["A128"]), m4, band=16,
                                                stage2="pipelined"),
        "svd": jd.svd_sharded(jnp.asarray(inp["Asvd"]), m4, band=8),
        "batch": jd.svdvals_batch_sharded(jnp.asarray(inp["As"]), m22, band=8),
        "gspmd": jd.svdvals_batch_sharded_gspmd(jnp.asarray(inp["As"]), m22, band=8),
    }
    for key, (Ab, b, lg) in inp["pipelined"].items():
        out[key] = jd.band_to_bidiagonal_pipelined(jnp.asarray(Ab), m4, band=b,
                                                   sweeps_per_group=lg)
    for key in JACOBI:
        out[key] = jax_jacobi(jnp.asarray(inp[key]), m4)
    return {k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    """``(inputs, port on (1, 4), port on (2, 2), JAX)``: one spawn of 4
    ranks runs both meshes' cases in a thread while the JAX side runs
    here."""
    inp = _inputs()
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, ranks.both_meshes, 4, dp=1, device="cpu", args=(inp,),
                           timeout=TIMEOUT)
        jax_out = _jax_side(inp)
        return (inp, *port.result(), jax_out)


def _sigma(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.svd(np.diag(d) + np.diag(e, 1), compute_uv=False)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_default_dp(n):
    mesh = jax_mesh(n, platform="cpu")
    assert default_dp(n) == mesh.shape["dp"]


def test_collectives_on_four_ranks(runs):
    _, tp4, _, _ = runs
    assert tp4["collectives"] == ["all_gather", "all_gather stacked", "pmax", "ppermute ring",
                                  "ppermute zeros", "psum", "psum_scatter"]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_dense_to_band_shardmap_matches_jax(runs, dtype):
    inp, tp4, _, jx = runs
    A = inp["A64"] if dtype == "f64" else inp["A32"]
    got, want = tp4[f"band {dtype}"].numpy(), jx[f"band {dtype}"]
    assert got.dtype == A.dtype and got.shape == A.shape
    tol = 1e-10 * np.linalg.norm(A, 2) if dtype == "f64" else 5e-4
    np.testing.assert_allclose(got, want, atol=tol)
    s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, ref, rtol=2e-5, atol=1e-5 * ref[0])


@pytest.mark.parametrize("case", ["svdvals local", "svdvals pipelined", "batch", "gspmd"])
def test_svdvals_entries_match_jax(runs, case):
    inp, tp4, dp2, jx = runs
    got = (dp2 if case in ("batch", "gspmd") else tp4)[case].numpy()
    want = jx[case]
    A = {"svdvals local": inp["A256"], "svdvals pipelined": inp["A128"]}.get(case, inp["As"])
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert got.shape == want.shape == ref.shape
    smax = ref[..., :1]
    assert np.max(np.abs(got - want) / smax) < 1e-5, case
    assert np.max(np.abs(got - ref) / smax) < 1e-4, case


def test_batch_gspmd_equals_batch(runs):
    _, _, dp2, _ = runs
    assert torch.equal(dp2["batch"], dp2["gspmd"])
    assert "dp=2" in dp2["odd batch"]


def test_batch_sharded_never_replicates_A(runs):
    """No collective of the batch path moves more than the band of each
    of the rank's matrices (n (b + 1) floats a matrix): A itself, n^2 a
    matrix, never travels."""
    inp, _, dp2, _ = runs
    batch, n, _ = inp["As"].shape
    b = 8
    per_rank = batch // 2
    assert 0 < dp2["largest"] <= per_rank * n * (b + 1) * 4 < per_rank * n * n * 4


def test_svd_sharded_matches_jax(runs):
    inp, tp4, _, jx = runs
    A = inp["Asvd"]
    U, s, Vh = (x.numpy() for x in tp4["svd"])
    n = A.shape[0]
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert U.shape == Vh.shape == (n, n) and s.shape == (n,)
    assert np.max(np.abs(s - jx["svd"][1])) / ref[0] < 1e-4
    assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
    assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
    assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < 1e-4


@pytest.mark.parametrize("case", PIPELINED, ids=lambda c: _pkey(*c))
def test_pipelined_chase_matches_jax_and_the_sequential_chase(runs, case):
    """(d, e) against the JAX package's pipelined chase at the same tp and
    LG (entry by entry in float64), and the spectrum against the port's
    sequential chase on the same band."""
    inp, tp4, _, jx = runs
    n, b, lg, dtype = case
    key = _pkey(*case)
    Ab = inp["pipelined"][key][0]
    d, e = (x.numpy() for x in tp4[key])
    assert d.shape == (n,) and e.shape == (n - 1,) and d.dtype == dtype
    d0, e0 = two_stage.band_to_bidiagonal(torch.from_numpy(Ab), band=b)
    s0 = _sigma(d0.numpy(), e0.numpy())
    s1 = _sigma(d, e)
    if dtype == np.float64:
        tol = 1e-10 * np.linalg.norm(Ab, 2)
        np.testing.assert_allclose(d, jx[key][0], atol=tol)
        np.testing.assert_allclose(e, jx[key][1], atol=tol)
        assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-13
    else:
        assert np.max(np.abs(s1 - _sigma(*jx[key])) / s0[0]) < 1e-5
    assert np.max(np.abs(s1 - s0)) / s0[0] < 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,b,lg", [(64, 8, None), (64, 8, 3), (45, 4, None)])
def test_pipelined_chase_on_one_rank_is_the_sequential_chase(n, b, lg, dtype):
    """At tp = 1 a pass runs every sweep whole and in order: (d, e) are
    bit-equal to the sequential chase's."""
    rng = np.random.default_rng(n + b)
    if n % b:
        Ab = _band(rng, n, b, dtype)
    else:
        Ab = two_stage.dense_to_band(torch.from_numpy(rng.normal(size=(n, n))).to(dtype), band=b)
    with single_rank(device="cpu") as mesh:
        d, e = band_to_bidiagonal_pipelined(Ab, mesh, band=b, sweeps_per_group=lg)
    d0, e0 = two_stage.band_to_bidiagonal(Ab, band=b)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def _band(rng, n, b, dtype):
    """A random upper band of width ``b`` (n need not divide by b)."""
    A = torch.from_numpy(rng.normal(size=(n, n))).to(dtype)
    i = torch.arange(n)
    keep = (i[None, :] >= i[:, None]) & (i[None, :] <= i[:, None] + b)
    return torch.where(keep, A, torch.zeros((), dtype=dtype))


@pytest.mark.parametrize("case", JACOBI)
def test_svd_jacobi_sharded_matches_jax(runs, case):
    inp, tp4, _, jx = runs
    A = inp[case]
    n = A.shape[0]
    U, s, Vh = (x.numpy() for x in tp4[case])
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert s.shape == (n,) and U.shape == (n, n) and Vh.shape == (n, n)
    if case == "jacobi graded":  # relative, every decade
        assert np.max(np.abs(s - ref) / ref) < 1e-3
        assert np.max(np.abs(s - jx[case][1]) / ref) < 1e-3
    else:
        assert np.max(np.abs(s - ref)) / ref[0] < 1e-4
        assert np.max(np.abs(s - jx[case][1])) / ref[0] < 1e-4
    if case == "jacobi square":
        assert np.abs(U.T @ U - np.eye(n)).max() < 1e-4
        assert np.abs(Vh @ Vh.T - np.eye(n)).max() < 1e-4
    assert np.abs(U @ np.diag(s) @ Vh - A).max() / np.abs(A).max() < 1e-4


def test_entries_raise_the_jax_errors():
    with single_rank(device="cpu") as mesh:
        A = torch.zeros((20, 20))
        with pytest.raises(ValueError, match="must divide by band"):
            dense_to_band_shardmap(A, mesh, band=8)
        with pytest.raises(ValueError, match="stage2 must be"):
            svdvals_sharded(A, mesh, band=4, stage2="bogus")


def test_pipeline_geometry_is_the_jax_body_s():
    """m, LG, U, Np, NG, T and the chase slots as the JAX body computes
    them, at the card's 1024/b32 on 4 ranks and an inflating explicit LG."""
    g = pipeline_geometry(1024, 32, 4)
    assert (g.m, g.LG, g.U, g.Np, g.NG, g.T) == (273, 3, 192, 1092, 341, 685)
    g = pipeline_geometry(64, 8, 4, sweeps_per_group=2)
    assert (g.LG, g.U, g.m) == (2, 24, max(-(-(64 + 20) // 4), 24 + 16))
    assert g.s_chase == (g.m + g.U + 2 * 9 + 2) // 8 + 2


def test_superstep_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    """On a CPU tensor the superstep wrapper runs ``two_stage.
    chase_superstep`` in place; on a CUDA tensor it calls the C entry with
    the buffer's pointer and leading dimension (the library patched)."""
    n, b = 40, 4
    g = pipeline_geometry(n, b, 1)
    rng = np.random.default_rng(3)
    Ab = _band(rng, n, b, torch.float64)
    L = Ab.new_zeros((g.U + g.m + 4 * b, g.Np))
    L[g.U : g.U + n, :n] = Ab
    want = L.clone()
    two_stage.chase_superstep(want, n, b, 0, g.LG, 0, g.U, g.m, True, g.s_chase)
    before = band_chase.launches_superstep
    assert band_chase.superstep(L, n, b, 0, g.LG, 0, g.U, g.m, True, g.s_chase) is L
    assert torch.equal(L, want) and band_chase.launches_superstep == before

    calls = []

    class Lib:
        def svdt_band_chase_superstep(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(band_chase._build, "check_input", lambda *a, **k: True)
    monkeypatch.setattr(band_chase._build, "load", lambda *a, **k: Lib())
    monkeypatch.setattr(band_chase._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(band_chase.torch.cuda, "device", lambda d: __import__("contextlib")
                        .nullcontext())
    L32 = L.float()
    band_chase.superstep(L32, n, b, 6, g.LG, 0, g.U, g.m, True, g.s_chase)
    assert calls == [(L32.data_ptr(), g.Np, n, b, 6, g.LG, 0, g.U, g.m, 1, g.s_chase, 0)]
    assert band_chase.launches_superstep == before + 1
    assert len(band_chase._ENTRIES["svdt_band_chase_superstep"]) == len(calls[0])


def test_dryrun_on_four_cpu_ranks(capsys):
    dryrun(4, device="cpu")
    assert "dryrun_multichip OK: mesh={'dp': 2, 'tp': 2}" in capsys.readouterr().out


def test_spawn_fails_one_call_when_a_rank_raises_or_dies():
    with pytest.raises(RuntimeError, match=r"rank \d failed:(.|\n)*must divide by band"):
        spawn(ranks.dp_cases, 2, dp=1, device="cpu", args=({"As": np.zeros((3, 5, 5))},),
              timeout=60)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="spawn: rank"):  # rank 1 died or rank 0 lost it
        spawn(ranks.die_on_rank_1, 2, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 60  # well inside the deadline: no wait for it
