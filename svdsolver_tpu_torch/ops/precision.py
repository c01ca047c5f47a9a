"""Matmul precision control.

On the H100 a float32 matmul may run on the tensor cores in TF32, which
keeps about three decimal digits (~1e-3 relative error) — unacceptable for
orthogonal reductions, whose error must stay near machine epsilon.  All
contractions in the solver go through :func:`pdot` (or :func:`peinsum`),
which default to full
float32 ('highest': TF32 off for both cuBLAS and cuDNN).  Callers chasing
raw throughput can lower it globally with :func:`set_dot_precision`
('default' | 'float32' | 'highest'), the twin of the JAX package's switch.
"""

import torch

_PRECISION = "highest"

# JAX package name -> torch.set_float32_matmul_precision name
_MAP = {
    "default": "medium",
    "float32": "high",
    "highest": "highest",
}


def set_dot_precision(name):
    """Set the global contraction precision: 'default' | 'float32' | 'highest'."""
    global _PRECISION
    if name not in _MAP:
        raise ValueError(f"unknown precision {name!r}; one of {sorted(_MAP)}")
    _PRECISION = name
    torch.set_float32_matmul_precision(_MAP[name])


def get_dot_precision():
    return _PRECISION


def _require_full_fp32():
    """Turn TF32 off for matmuls and convolutions, and check that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError("TF32 is still enabled; fp32 contractions would round")


def pdot(a, b):
    """Precision-controlled matmul/vecdot used for every contraction."""
    if _PRECISION == "highest":
        _require_full_fp32()
    return torch.matmul(a, b)


def peinsum(equation, *operands):
    """Precision-controlled einsum (the twin of ``jnp.einsum`` at the
    package's precision), for contractions that are no plain matmul."""
    if _PRECISION == "highest":
        _require_full_fp32()
    return torch.einsum(equation, *operands)
