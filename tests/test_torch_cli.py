"""The port's command line and utilities (``svdsolver_tpu_torch/
cli.py``, ``utils/``) on the CPU: the counterparts of ``tests/test_cli.py``
(its 11 tests, run with ``--device cpu``), each CSV's shape held to the JAX
CLI's on the same argv, ``--device cuda`` refusing without a card, the
port's native loader (its own build, two processes building at once), and
``utils.profiling`` / ``utils.timing.benchmark_each``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svdsolver_tpu.cli import main as jax_main
from svdsolver_tpu_torch.cli import main
from svdsolver_tpu_torch.utils import fixtures as fx
from svdsolver_tpu_torch.utils import native, profiling, timing
from svdsolver_tpu_torch.utils.fixtures import REPO_DATA

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _csv_shape(path):
    return [len(line.split(",")) for line in Path(path).read_text().strip().split("\n")]


def _both_bench(tmp_path, argv):
    """The port's and the JAX CLI's CSV for one bench argv: their lines."""
    out, jout = tmp_path / "port.csv", tmp_path / "jax.csv"
    assert main(argv + ["--output", str(out)] + CPU) == 0
    assert jax_main(argv + ["--output", str(jout)]) == 0
    assert _csv_shape(out) == _csv_shape(jout)
    return out.read_text().strip().split("\n")


def test_bench_base_writes_csv(tmp_path):
    lines = _both_bench(tmp_path, ["bench", "base", "8", "3", "1"])
    assert lines[0].replace(" ", "") == "8,16"
    assert len(lines[1].split(",")) == 2


def test_bench_two_stage_writes_three_lines(tmp_path):
    lines = _both_bench(tmp_path, ["bench", "multicore", "16", "2", "1", "8"])
    assert len(lines) == 3  # sizes / stage1 / stage2 (reference schema)


def test_bench_diagonal_qr(tmp_path):
    out = tmp_path / "diag.csv"
    assert main(["bench", "diagonal", "16", "2", "1", "--diag", "qr",
                 "--output", str(out)] + CPU) == 0
    assert out.exists() and _csv_shape(out) == [1, 1]


def test_bench_rejects_unknown_model():
    with pytest.raises(SystemExit):
        main(["bench", "nosuch", "8", "2", "1"] + CPU)


def test_check_64():
    assert os.path.exists(os.path.join(REPO_DATA, "test_float_64_64.bin"))
    assert main(["check", "64"] + CPU) == 0


def test_fixture_roundtrip(tmp_path):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = tmp_path / "m.bin"
    fx.write_matrix(str(p), a)
    fx.write_matrix(str(p), a)  # truncating (unlike the reference's append)
    np.testing.assert_array_equal(a, fx.read_matrix(str(p), 3, 4, np.float32))
    with pytest.raises(ValueError, match="expected 20"):
        fx.read_matrix(str(p), 4, 5, np.float32)


def test_svdvals_subcommand(tmp_path):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(16, 16)).astype(np.float32)
    p = tmp_path / "a.bin"
    fx.write_matrix(str(p), A)
    out = tmp_path / "s.bin"
    assert main(["svdvals", str(p), "16", "--model", "base", "--output", str(out)] + CPU) == 0
    s = np.fromfile(out, dtype=np.float32)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-4, atol=1e-5 * want[0])


def test_check_double_dtype():
    assert os.path.exists(os.path.join(REPO_DATA, "test_double_64_64.bin"))
    assert main(["check", "64", "--dtype", "double"] + CPU) == 0


def test_check_64_flagship_tpu2(capsys):
    # the kernels' check runs on the card; on the CPU it says it skipped,
    # as the JAX package does off the TPU
    assert main(["check", "64", "--model", "tpu2"] + CPU) == 0
    assert "CHECK SKIPPED" in capsys.readouterr().out


def test_svd_subcommand(tmp_path):
    rng = np.random.default_rng(4)
    n = 32
    A = rng.normal(size=(n, n)).astype(np.float32)
    p = tmp_path / "a.bin"
    fx.write_matrix(str(p), A)
    pre = str(tmp_path / "out")
    assert main(["svd", str(p), str(n), "--output-prefix", pre] + CPU) == 0
    U = np.fromfile(pre + "_U.bin", dtype=np.float32).reshape(n, n)
    s = np.fromfile(pre + "_s.bin", dtype=np.float32)
    Vh = np.fromfile(pre + "_Vh.bin", dtype=np.float32).reshape(n, n)
    want = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=2e-4, atol=1e-5 * want[0])
    np.testing.assert_allclose(U @ np.diag(s) @ Vh, A, atol=5e-5 * want[0])
    # the top-k variant
    assert main(["svd", str(p), str(n), "-k", "4", "--output-prefix", pre] + CPU) == 0
    s4 = np.fromfile(pre + "_s.bin", dtype=np.float32)
    assert s4.shape == (4,)
    np.testing.assert_allclose(s4, want[:4], rtol=2e-4, atol=1e-5 * want[0])


def test_generated_fixtures_native(tmp_path):
    # fixtures of unshipped sizes come from the native C++ oracle: a
    # cross-implementation check of the port's plain Stage I
    from svdsolver_tpu_torch.models.two_stage import dense_to_band

    n, band = 96, 4
    fx.ensure_generated_fixtures(n, band=band, data_dir=str(tmp_path))
    A0 = fx.load_fixture("test", n, data_dir=str(tmp_path))
    band_ref = fx.load_fixture("band", n, data_dir=str(tmp_path))
    Ab = dense_to_band(torch.from_numpy(A0), band=band).numpy()
    assert fx.band_mse(Ab, band_ref, band) < 1e-3
    sig = np.linalg.svd(band_ref.astype(np.float64), compute_uv=False)
    ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    assert np.max(np.abs(sig - ref)) / ref[0] < 1e-5


def test_check_1024_generates_into_data_dir(tmp_path, capsys):
    # check 1024 writes the native oracle's fixtures where the caller says
    assert main(["check", "1024", "--model", "tpu2", "--data-dir", str(tmp_path)] + CPU) == 0
    assert "CHECK SKIPPED" in capsys.readouterr().out
    for kind in ("test", "band", "bidiagonal"):
        assert os.path.getsize(fx.fixture_path(kind, 1024, data_dir=str(tmp_path))) == 4 * 1024**2
    A0 = fx.load_fixture("test", 1024, data_dir=str(tmp_path))
    bidiag = fx.load_fixture("bidiagonal", 1024, data_dir=str(tmp_path)).astype(np.float64)
    ref = np.linalg.svd(A0.astype(np.float64), compute_uv=False)
    sig = np.linalg.svd(bidiag, compute_uv=False)
    assert np.max(np.abs(sig - ref)) / ref[0] < 1e-5


@pytest.mark.parametrize("argv", [
    ["check", "64"],
    ["bench", "base", "8", "2", "1"],
    ["svdvals", "nowhere.bin", "8"],
])
def test_device_cuda_needs_a_card(argv, monkeypatch):
    # the default device is the card; with none the CLI raises, never
    # running on the CPU unless asked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)


def test_native_builds_once_under_two_processes(tmp_path):
    """Two processes build the native library into one empty directory at
    once: both load it, from one file, and no temporary file is left."""
    code = ("import sys, pathlib, numpy as np; "
            "from svdsolver_tpu_torch.utils import native; "
            "native.BUILD_DIR = pathlib.Path(sys.argv[1]); "
            "A = np.random.default_rng(0).uniform(0, 5, (32, 32)).astype(np.float32); "
            "print(native.build(), float(native.svdvals(A, 8)[0]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].split() for o in outs]
    assert lines[0] == lines[1]
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        ["build.lock", Path(lines[0][0]).name])
    A = np.random.default_rng(0).uniform(0, 5, (32, 32))
    assert abs(float(lines[0][1]) - np.linalg.svd(A, compute_uv=False)[0]) < 1e-4 * 80


def test_native_oracle_matches_lapack(rng):
    A = rng.uniform(0, 5, (48, 48))
    ref = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(native.svdvals(A, band=8), ref, rtol=0, atol=1e-12 * ref[0])
    d, e = native.gk_brd(A)
    B = np.diag(d) + np.diag(e, 1)
    np.testing.assert_allclose(np.linalg.svd(B, compute_uv=False), ref, rtol=0,
                               atol=1e-12 * ref[0])
    np.testing.assert_allclose(native.qrd(d, e), ref, rtol=0, atol=1e-12 * ref[0])


@pytest.mark.parametrize("method,diag", [("tpu2", "bisect"), ("multicore", "qr"),
                                         ("tpu1", "dqds")])
def test_stage_timings(rng, method, diag):
    A = torch.from_numpy(rng.normal(size=(40, 40)))
    out = profiling.stage_timings(A, band=8, method=method, diag=diag, reps=2)
    stages = ("stage1_dense_to_band_s", "stage2_band_to_bidiagonal_s", "diagonalization_s")
    assert all(out[k] > 0 for k in stages)
    assert out["total_s"] == pytest.approx(sum(out[k] for k in stages))
    assert out["band"] == 8


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_benchmark_each():
    mean, times = timing.benchmark_each(lambda x: x * 2, [torch.ones(4)] * 3)
    assert len(times) == 3 and mean == pytest.approx(sum(times) / 3)
