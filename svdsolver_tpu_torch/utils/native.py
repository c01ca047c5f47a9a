"""ctypes loader of the native C++ host reduction (``native/svd_native.cpp``),
the oracle shared with the JAX package.

The C++ source is shared; this loader is the port's own.  It never runs
``make -C native``: ``g++`` builds the library into
``build/svdsolver_tpu_torch/native/libsvd_native-<hash>.so`` (the hash
covers the source and the flags) under an exclusive ``fcntl`` lock, to a
temporary name renamed into place, so processes that build at once wait
for one another and none loads a partial file.  Arrays are numpy, in and
out: the oracle runs on the host.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "svd_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svdsolver_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-shared")

_lib = None


def build():
    """Compile the library unless an up-to-date one exists; returns its path."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"libsvd_native-{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():  # another process may have built it meanwhile
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, building it if needed; raises if ``g++`` fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c_long = ctypes.c_long
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    for suffix, fp in (("f32", f32p), ("f64", f64p)):
        for name, argtypes, restype in (
            ("gk_brd", [fp, c_long, c_long, fp, fp], ctypes.c_int),
            ("dense_to_band", [fp, c_long, c_long], ctypes.c_int),
            ("band_to_bidiag", [fp, c_long, c_long, fp, fp], ctypes.c_int),
            ("qrd", [fp, fp, c_long, c_long], c_long),
            ("svdvals", [fp, c_long, c_long, fp], c_long),
        ):
            fn = getattr(lib, f"svdn_{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def _suffix(dtype):
    return "f32" if np.dtype(dtype) == np.float32 else "f64"


def gk_brd(A):
    """Golub-Kahan bidiagonalization on the host; returns (d, e)."""
    A = np.ascontiguousarray(A).copy()
    m, n = A.shape
    d = np.zeros(n, A.dtype)
    e = np.zeros(max(n - 1, 1), A.dtype)
    getattr(get_lib(), f"svdn_gk_brd_{_suffix(A.dtype)}")(A, m, n, d, e)
    return d, e[: n - 1]


def dense_to_band(A, band):
    """Stage I on the host; returns the banded matrix."""
    A = np.ascontiguousarray(A).copy()
    getattr(get_lib(), f"svdn_dense_to_band_{_suffix(A.dtype)}")(A, A.shape[0], band)
    return A


def band_to_bidiag(A, band):
    """Stage II on the host; returns (d, e)."""
    A = np.ascontiguousarray(A).copy()
    n = A.shape[0]
    d = np.zeros(n, A.dtype)
    e = np.zeros(max(n - 1, 1), A.dtype)
    getattr(get_lib(), f"svdn_band_to_bidiag_{_suffix(A.dtype)}")(A, n, band, d, e)
    return d, e[: n - 1]


def qrd(d, e, max_sweeps=0):
    """Convergent QR diagonalization on the host; returns sorted sigma."""
    d = np.ascontiguousarray(d).copy()
    e = np.ascontiguousarray(e).copy()
    if e.size == 0:
        e = np.zeros(1, d.dtype)
    getattr(get_lib(), f"svdn_qrd_{_suffix(d.dtype)}")(d, e, d.shape[0], max_sweeps)
    return d


def svdvals(A, band=32):
    """Full host pipeline: dense -> band -> bidiagonal -> sigma (descending)."""
    A = np.ascontiguousarray(A).copy()
    n = A.shape[0]
    sigma = np.zeros(n, A.dtype)
    getattr(get_lib(), f"svdn_svdvals_{_suffix(A.dtype)}")(A, n, band, sigma)
    return sigma
