"""The port's ops (svdsolver_tpu_torch.ops) held to the JAX package on CPU."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdsolver_tpu.ops import chase_schedule as jax_sched
from svdsolver_tpu.ops import householder as jax_hh
from svdsolver_tpu_torch.ops import chase_schedule, householder, precision
from svdsolver_tpu_torch.utils.convert import from_numpy, to_numpy
from svdsolver_tpu_torch.utils.timing import benchmark, sync


def _vector(rng, kind, L):
    x = rng.normal(size=L).astype(np.float32)
    if kind == "zero_tail":
        x[4:] = 0
    return x


@pytest.mark.parametrize(
    "kind,L,p",
    [
        ("normal", 16, 0),
        ("normal", 16, 5),
        ("normal", 16, 15),  # last index: empty tail -> identity
        ("normal", 16, 20),  # pivot out of range -> identity, v == 0
        ("zero_tail", 16, 3),  # zero tail -> identity
        ("normal", 33, 7),
    ],
)
def test_householder_vector_matches_jax(rng, kind, L, p):
    x = _vector(rng, kind, L)
    v, tau, beta = householder.householder_vector(from_numpy(x), p)
    vj, tauj, betaj = jax_hh.householder_vector(jnp.asarray(x), p)
    np.testing.assert_allclose(to_numpy(v), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(float(tau), float(tauj), atol=1e-6)
    np.testing.assert_allclose(float(beta), float(betaj), atol=1e-6)


def test_householder_vector_sign_convention():
    # pivot >= 0 -> beta = -norm; a zero pivot counts as non-negative
    for pivot, want in ((3.0, -5.0), (-3.0, 5.0), (0.0, -4.0)):
        x = torch.tensor([pivot, 4.0], dtype=torch.float32)
        _, _, beta = householder.householder_vector(x, 0)
        assert float(beta) == want


@pytest.mark.parametrize("side", ["left", "right"])
def test_apply_reflector_matches_jax(rng, side):
    A = rng.normal(size=(12, 12)).astype(np.float32)
    x = rng.normal(size=12).astype(np.float32)
    v, tau, _ = householder.householder_vector(from_numpy(x), 2)
    vj, tauj, _ = jax_hh.householder_vector(jnp.asarray(x), 2)
    port = getattr(householder, f"apply_{side}")(from_numpy(A), v, tau)
    ref = getattr(jax_hh, f"apply_{side}")(jnp.asarray(A), vj, tauj)
    np.testing.assert_allclose(to_numpy(port), np.asarray(ref), atol=1e-6)


def test_chase_schedule_matches_jax():
    for n in (2, 3, 17, 64, 96, 200, 1000, 3840):
        for b in (1, 2, 8, 16, 32, 64, 128):
            assert chase_schedule.s_max_of(n, b) == jax_sched.s_max_of(n, b)
            for i in range(0, n - 1, max(1, n // 23)):
                assert chase_schedule.nc_of_static(i, n, b) == (
                    jax_sched.nc_of_static(i, n, b)
                )
                assert chase_schedule.nc_of_static(i, n, b) == int(
                    jax_sched.nc_of(i, n, b)
                )


def test_pdot_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        a = torch.eye(3)
        assert torch.equal(precision.pdot(a, a), a)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def test_set_dot_precision_round_trip():
    try:
        precision.set_dot_precision("float32")
        assert precision.get_dot_precision() == "float32"
        assert torch.get_float32_matmul_precision() == "high"
        with pytest.raises(ValueError):
            precision.set_dot_precision("bf16")
    finally:
        precision.set_dot_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"


def test_convert_round_trip(rng):
    x = rng.normal(size=(5, 3))
    t = from_numpy(x.T)
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(to_numpy(t), x.T.astype(np.float32))


def test_timing_benchmark_counts_calls():
    calls = []
    mean = benchmark(lambda x: calls.append(x), [1, 2, 3])
    assert calls == [1, 1, 2, 3] and mean >= 0
    assert sync("out") == "out"


def test_import_needs_no_jax_nvcc_or_triton(tmp_path):
    """Importing the port, kernel modules included, loads no jax or triton
    and needs no nvcc (PATH holds nothing), and builds nothing."""
    code = (
        "import sys\n"
        "import svdsolver_tpu_torch\n"
        "import svdsolver_tpu_torch.ops.cuda.panel_qr\n"
        "import svdsolver_tpu_torch.ops.cuda.band_chase\n"
        "import svdsolver_tpu_torch.ops.cuda.bisect\n"
        "import svdsolver_tpu_torch.models.svd\n"
        "import svdsolver_tpu_torch.parallel\n"
        "import svdsolver_tpu_torch.parallel.mesh, svdsolver_tpu_torch.parallel.distributed\n"
        "import svdsolver_tpu_torch.parallel.jacobi\n"
        "import svdsolver_tpu_torch.utils.timing, svdsolver_tpu_torch.utils.convert\n"
        "from svdsolver_tpu_torch.ops.cuda import _build\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
        "assert not _build._LIBS\n"
        "print('ok')\n"
    )
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=root,
        env={"PATH": str(tmp_path), "PYTHONPATH": root, "HOME": str(tmp_path)},
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
