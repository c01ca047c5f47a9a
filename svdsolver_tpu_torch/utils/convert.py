"""State carried across packages: the input matrix, the band after Stage I
and the bidiagonal (d, e) travel as numpy arrays, so one input can be fed
to the JAX package and to this port alike."""

import numpy as np
import torch


def from_numpy(x, device="cpu", dtype=torch.float32):
    """A contiguous tensor of ``dtype`` on ``device`` holding a copy of ``x``."""
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def to_numpy(t):
    """``t`` as a numpy array on the host (waits for the device)."""
    return t.detach().cpu().numpy()
