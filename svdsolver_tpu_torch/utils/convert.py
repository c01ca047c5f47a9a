"""State carried across packages: the input matrix, the band after Stage I,
the bidiagonal (d, e) and the reflector records travel as numpy arrays, so
one input can be fed to the JAX package and to this port alike.  A complex
matrix travels as a numpy complex array or as the JAX package's ``(re,
im)`` pair of real arrays."""

import numpy as np
import torch


def from_numpy(x, device="cpu", dtype=torch.float32):
    """A contiguous tensor of ``dtype`` on ``device`` holding a copy of ``x``.
    A complex ``x`` with a real ``dtype`` takes the complex dtype of that
    precision (complex64 for float32, complex128 for float64)."""
    x = np.ascontiguousarray(x)
    if np.iscomplexobj(x) and not dtype.is_complex:
        dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return torch.tensor(x, dtype=dtype, device=device)


def pair_from_numpy(x, device="cpu", dtype=torch.float32):
    """The ``(re, im)`` pair of real ``dtype`` tensors of a complex array."""
    x = np.asarray(x)
    return from_numpy(x.real, device, dtype), from_numpy(x.imag, device, dtype)


def to_numpy(t):
    """``t`` as a numpy array on the host (waits for the device).  A
    conjugate view is resolved first; a ``(re, im)`` pair of real tensors
    comes back as one complex array."""
    if isinstance(t, tuple):
        return to_numpy(t[0]) + 1j * to_numpy(t[1])
    return t.detach().resolve_conj().cpu().numpy()


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
