"""Multi-rank execution: the device mesh, the sharded single-matrix and
batch entries, the pipelined chase and multi-rank block Jacobi (twin of
``svdsolver_tpu/parallel``).

The JAX package is single-controller over a ``jax.sharding.Mesh``; the port
is SPMD on ``torch.distributed`` (gloo): :func:`spawn` starts the ranks,
each builds its :class:`Mesh` with :func:`make_mesh`, calls an entry with
the same global input and gets the global result back.  Names and
signatures follow the JAX package's, with ``make_mesh``'s ``platform``
replaced by ``device``.
"""

from svdsolver_tpu_torch.parallel.mesh import Mesh, make_mesh, spawn
from svdsolver_tpu_torch.parallel.distributed import (
    band_to_bidiagonal_pipelined,
    svdvals_batch_sharded,
    svdvals_batch_sharded_gspmd,
    svdvals_sharded,
    svd_sharded,
    dense_to_band_sharded,
    dense_to_band_shardmap,
    dryrun,
)
from svdsolver_tpu_torch.parallel.jacobi import svd_jacobi_sharded

__all__ = [
    "svd_jacobi_sharded",
    "make_mesh",
    "svdvals_batch_sharded",
    "svdvals_batch_sharded_gspmd",
    "svdvals_sharded",
    "svd_sharded",
    "dense_to_band_sharded",
    "dense_to_band_shardmap",
    "dryrun",
    "band_to_bidiagonal_pipelined",
    "Mesh",
    "spawn",
]
