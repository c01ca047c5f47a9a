"""Binary matrix fixture I/O in the reference's on-disk format (twin of
``svdsolver_tpu/utils/fixtures.py``).

Matrices are raw row-major element dumps named
``{kind}_{float|double}_{n}_{n}.bin`` in the repository's ``data/``
(shared with the JAX package); dtype is honoured and writes truncate.
Arrays are numpy: a fixture is host data, whatever device runs the check.
"""

import os

import numpy as np

REPO_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def read_matrix(path, n_rows, n_cols, dtype=np.float32):
    """Read a raw row-major binary matrix (reference format)."""
    a = np.fromfile(path, dtype=dtype, count=n_rows * n_cols)
    if a.size != n_rows * n_cols:
        raise ValueError(
            f"{path}: expected {n_rows * n_cols} elements, got {a.size}"
        )
    return a.reshape(n_rows, n_cols)


def write_matrix(path, a):
    """Write a matrix as raw row-major elements (reference format, truncating)."""
    np.ascontiguousarray(a).tofile(path)


def fixture_path(kind, n, dtype=np.float32, data_dir=None):
    """Path to a fixture: kind in {test, band, bidiagonal}."""
    tname = "float" if np.dtype(dtype) == np.float32 else "double"
    return os.path.join(data_dir or REPO_DATA, f"{kind}_{tname}_{n}_{n}.bin")


def load_fixture(kind, n, dtype=np.float32, data_dir=None):
    """Load a fixture matrix as a numpy array."""
    return read_matrix(fixture_path(kind, n, dtype, data_dir), n, n, dtype)


def band_mse(A, B, band):
    """Band-limited mean squared difference of magnitudes over ``j - i in
    [0, band]`` (the reference's ``mse``: Householder reductions are
    sign-indeterminate, so magnitudes are compared)."""
    A = np.asarray(A)
    B = np.asarray(B)
    n, m = A.shape
    i, j = np.ogrid[:n, :m]
    mask = (j - i >= 0) & (j - i <= band)
    diff = np.abs(A[mask]) - np.abs(B[mask])
    return float(np.mean(diff * diff))


def ensure_generated_fixtures(n, dtype=np.float32, band=4, seed=586, data_dir=None):
    """Generate the missing {test, band, bidiagonal} fixtures of size ``n``
    with the native C++ reduction (``utils.native``, the oracle shared with
    the JAX package) into ``data_dir`` (default the repository's
    ``data/``).  Deterministic: a seeded uniform [0, 5] test matrix."""
    paths = {k: fixture_path(k, n, dtype, data_dir) for k in ("test", "band", "bidiagonal")}
    if all(os.path.exists(p) for p in paths.values()):
        return
    from svdsolver_tpu_torch.utils import native

    rng = np.random.default_rng(seed)
    A = rng.uniform(0.0, 5.0, size=(n, n)).astype(dtype)
    write_matrix(paths["test"], A)
    Ab = native.dense_to_band(A, band)
    write_matrix(paths["band"], Ab)
    d, e = native.band_to_bidiag(Ab, band)
    # fixtures store the full bidiagonal matrix (reference layout)
    write_matrix(paths["bidiagonal"], np.diag(d) + np.diag(e, 1))
