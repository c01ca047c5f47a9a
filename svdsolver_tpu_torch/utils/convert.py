"""State carried across packages: the input matrix, the band after Stage I,
the bidiagonal (d, e) and the reflector records travel as numpy arrays, so
one input can be fed to the JAX package and to this port alike."""

import numpy as np
import torch


def from_numpy(x, device="cpu", dtype=torch.float32):
    """A contiguous tensor of ``dtype`` on ``device`` holding a copy of ``x``."""
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def to_numpy(t):
    """``t`` as a numpy array on the host (waits for the device)."""
    return t.detach().cpu().numpy()


def records_from_numpy(records, device="cpu"):
    """The JAX package's record tuple as the port's tensors on ``device``,
    each keeping its dtype: Stage I's ``(Ab, Vq, Tq, Vl, Tl)`` (from
    ``dense_to_band_rec``) or the chase's ``(d, e, VL, TL, VR, TR)`` (from
    ``band_to_bidiagonal_accum``).  The layouts are the same in both
    packages, so the port's back-transforms take them as they are."""
    records = tuple(records)
    if len(records) not in (5, 6):
        raise ValueError(
            "expected (Ab, Vq, Tq, Vl, Tl) or (d, e, VL, TL, VR, TR), "
            f"got {len(records)} arrays"
        )
    return tuple(
        torch.from_numpy(np.array(r, copy=True)).to(device) for r in records
    )
