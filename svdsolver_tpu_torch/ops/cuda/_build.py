"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
at first use into ``build/svdsolver_tpu_torch/lib<name>-<hash>.so`` (the
hash covers the source, every shared header ``csrc/*.cuh`` and the flags,
so an edited source or header rebuilds), then loaded with ``ctypes``.
Nothing here runs at import: a CPU-only machine with no ``nvcc`` imports
every kernel module and never builds.

No ``--use_fast_math``: bisection relies on IEEE division and on ``inf``
for zero pivots, which flush-to-zero or approximate division would change.
The diagonalizers (``SOURCE_FLAGS``) also build with ``-fmad=false``: their
results are bit-equal to the plain versions only if no ``a*b + c`` is
contracted into one rounding.
"""

import ast
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "svdsolver_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# flags of one source beside NVCC_FLAGS
SOURCE_FLAGS = {"bidiag_qr": ("-fmad=false",), "dqds": ("-fmad=false",)}

_LIBS = {}  # name -> ctypes.CDLL, loaded once per process
MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on the H100
STATIC_SMEM = 1024  # room kept for a kernel's static shared variables


def nvcc_path():
    """The ``nvcc`` to build with; raises if the toolkit is missing."""
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_key(name):
    """The build key of ``csrc/<name>.cu``: a hash of the source, of every
    header in ``csrc/`` (by name and content, so an edited header rebuilds
    each source) and of the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(_flags(name)).encode())
    return key.hexdigest()[:16]


def _flags(name):
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def build(name):
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns ``(path, seconds, log)``: the library, the compile time (0.0
    when it was already built) and the compiler's output (``-Xptxas -v``
    register and shared-memory report; empty when already built).
    """
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{_source_key(name)}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, seconds, log


def load(name, entries):
    """The loaded library of kernel ``name``, building it if needed.

    ``entries`` maps each C entry point to its ``argtypes``; every entry
    returns the ``cudaError_t`` of its launch as an int.  They are set on
    every call: two modules may load one library for different entries.
    """
    lib = _LIBS.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    for fn, argtypes in entries.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def constants(name):
    """The ``constexpr int`` constants of ``csrc/<name>.cu`` whose values
    are integer expressions of literals and earlier such constants, by name,
    read from the source (no build): so a host plan that must agree with a
    kernel's layout takes that layout from the kernel's own definition."""
    ops = {ast.Add: int.__add__, ast.Sub: int.__sub__, ast.Mult: int.__mul__,
           ast.Div: int.__floordiv__}
    found = {}

    def value(node):
        if isinstance(node, ast.Constant) and type(node.value) is int:
            return node.value
        if isinstance(node, ast.Name):
            return found[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in ops:
            left, right = value(node.left), value(node.right)
            if isinstance(node.op, ast.Div) and (left < 0 or right <= 0):
                raise KeyError(node)  # C++ truncates: keep to what both agree on
            return ops[type(node.op)](left, right)
        raise KeyError(node)

    text = (CSRC / f"{name}.cu").read_text()
    for key, expr in re.findall(r"^\s*constexpr int (\w+) = ([^;]+);", text, re.M):
        try:
            found[key] = value(ast.parse(expr.strip(), mode="eval").body)
        except (KeyError, SyntaxError):
            continue
    return found


def check_input(t, name, ndim, dtypes=(torch.float32,)):
    """Validate a kernel input; returns True when it lies on a CUDA device
    (launch the kernel) and False on the CPU (run the plain version).  On
    the card it must have one of ``dtypes``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CPU or CUDA device, not {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"the CUDA kernel takes {names} {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    return True


def check_bidiagonal(d, e, dtypes):
    """Validate a bidiagonal {d (n,), e (n-1,)} of one device and dtype;
    returns :func:`check_input`'s answer for it (True: launch)."""
    on_card = check_input(d, "d", 1, dtypes)
    check_input(e, "e", 1, dtypes)
    if e.shape[0] != max(d.shape[0] - 1, 0):
        raise ValueError(
            f"need d (n,) and e (n-1,), got {tuple(d.shape)} and {tuple(e.shape)}")
    if d.device != e.device or d.dtype != e.dtype:
        raise ValueError("d and e must share device and dtype")
    return on_card


def stream_of(t):
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(err, kernel):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


def chain_ns(fn, dtype, steps, *args):
    """ns a step of a chain-bound entry ``fn(out, steps, *args, stream)``
    (one thread running a sweep's dependent recurrence from registers, its
    final state to ``out``, ``steps`` a multiple of 8): a short warm-up
    launch, then one launch between CUDA events.  Returns ns a step;
    raises if a launch fails or the state left the finite range (the
    chain would then time another path of the division)."""
    out = torch.zeros(4, dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    raise_on_error(fn(out.data_ptr(), 64, *args, stream), "chain")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    err = fn(out.data_ptr(), steps, *args, stream)
    stop.record()
    raise_on_error(err, "chain")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"chain state not finite: {out.tolist()}")
    return start.elapsed_time(stop) * 1e6 / steps


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
DOUBLE = ctypes.c_double
