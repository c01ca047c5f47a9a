"""Successive band reduction (SBR): a block bulge chase that narrows an
upper-band matrix from bandwidth ``b1`` to ``b2`` with rank-``nb`` block
reflectors (twin of ``svdsolver_tpu/models/sbr.py``).

One block sweep takes band(b1) to band(b2), each window updated once a
rank-``nb`` block reflector (compact WY, GEMMs) instead of once a rank-1
reflector; the scalar chase then runs on the narrower band.  The block
pair generalizes the scalar window pair (``nb = 1``, ``b2 = 1``):

* right (LQ) block elimination: rows ``[R, R + nb)`` brought to the
  staircase where row ``t`` ends at window column ``t``, by a compact-WY
  LQ panel over the ``d + nb`` wide support (``d = b1 - b2``), applied to
  every window row; it fills a lower-triangular bulge in the next
  ``d + nb`` rows;
* left (QR) block elimination: the first ``nb`` bulge columns back to
  upper form by the mirrored QR panel, spreading fill ``b1`` columns
  ahead, which the next hop's right elimination removes.

``nb <= b2`` (the staircase).  The windows are views of a zero-padded
copy, ``2 (b1 + W) + 2`` past ``n`` as in the JAX package (``W = b1 - b2 +
nb``); where a window would still run past the padded end, its start is
clamped back as ``lax.dynamic_slice`` clamps it (torch slicing would
truncate the window instead).  The block sweep is a host loop of PyTorch
ops on any device (the reference's is XLA ops, with no Pallas kernel);
:func:`band_to_bidiagonal_sbr`'s narrow chase runs the routed chase
kernel on a float32 CUDA tensor and the plain chase elsewhere.
"""

from svdsolver_tpu_torch.models.svd import routed_chase, use_kernels
from svdsolver_tpu_torch.models.two_stage import _panel_qr_step, band_to_bidiagonal


def make_sbr_window_pairs(b, c, nb):
    """The block window pairs of one SBR sweep: ``(top_pair, chase_pair)``,
    each updating its window in place.

    ``top_pair`` acts on the (b + nb, b + W) window at rows ``[i0, ...)``,
    cols ``[i0 + c, ...)``; ``chase_pair`` on the (b + W, b + W) window at
    rows ``[R, ...)``, cols ``[R + b, ...)``, ``W = b - c + nb`` the
    reflector support.  At ``nb = c = 1`` these are the scalar chase's
    windows.
    """
    W = b - c + nb

    def _right_block(Wn):
        # LQ panel over the first nb rows of the W-wide left strip; row t
        # pivots at column t (the staircase)
        Wn[:, :W] = _panel_qr_step(Wn[:, :W].T, 0, 0, nb)[0].T

    def _left_block(Wn, r0):
        # QR panel over the first nb columns of the rows from r0 on
        Wn[r0:, :] = _panel_qr_step(Wn[r0:, :], 0, 0, nb)[0]

    def top_pair(Wn):
        _right_block(Wn)
        _left_block(Wn, c)
        return Wn

    def chase_pair(Wn):
        _right_block(Wn)
        _left_block(Wn, b)
        return Wn

    return top_pair, chase_pair


def window_start(r, c, h, w, size):
    """The corner of an (h, w) window at (r, c) of a (size, size) matrix,
    clamped into it as ``lax.dynamic_slice`` clamps."""
    return min(max(r, 0), size - h), min(max(c, 0), size - w)


def band_reduce_width(A, b1, b2, nb=None):
    """Reduce square upper-band ``A`` (bandwidth ``b1``) to upper-band form
    of bandwidth ``b2`` by one SBR block sweep; returns the (n, n) narrowed
    band matrix (orthogonally equivalent: the same singular values).

    ``nb``: the block reflectors' rank (default ``b2``; ``1 <= nb <=
    b2``).  Eliminations past n see zero columns and are exact no-ops
    (tau = 0), as in the scalar chase.  ``A`` is not modified.
    """
    b, c = int(b1), int(b2)
    nb = c if nb is None else int(nb)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError("band_reduce_width expects a square matrix")
    if not 1 <= c < b:
        raise ValueError(f"need 1 <= b2 < b1, got b1={b}, b2={c}")
    if not 1 <= nb <= c:
        raise ValueError(f"need 1 <= nb <= b2 (staircase), got nb={nb}")
    n = A.shape[0]
    if n < 2:
        return A.clone()
    W = b - c + nb
    size = n + 2 * (b + W) + 2
    Ap = A.new_zeros((size, size))
    Ap[:n, :n] = A
    top_pair, chase_pair = make_sbr_window_pairs(b, c, nb)

    def run(pair, r, col, h, w):
        r, col = window_start(r, col, h, w, size)
        pair(Ap[r : r + h, col : col + w])

    for k in range(max(1, -(-(n - 1) // nb))):
        i0 = k * nb
        run(top_pair, i0, i0 + c, b + nb, b + W)
        # hop h: the right elimination of rows [R, R + nb), R = i0 + c + h b,
        # while R + b < n, and one overshoot hop as in the scalar chase
        for h in range(max(0, -(-(n - (i0 + c + b)) // b)) + 1):
            R = i0 + c + h * b
            run(chase_pair, R, R + b, b + W, b + W)
    return Ap[:n, :n].clone()


def band_to_bidiagonal_sbr(A, band=128, mid=32, nb=None):
    """Two-step Stage II: band(``band``) to band(``mid``) by the SBR block
    sweep, then the scalar chase at ``mid``; returns ``(d, e)``.

    The narrow chase is the routed chase kernel on a float32 CUDA tensor
    (``models.svd.routed_chase``) and the plain chase elsewhere.  The same
    output class as ``band_to_bidiagonal``: the reflectors differ, so
    ``(d, e)`` are spectrum-equivalent to its, not equal.
    """
    Am = band_reduce_width(A, b1=int(band), b2=int(mid), nb=nb)
    if use_kernels(Am) and Am.shape[0] >= 2:
        return routed_chase(Am, int(mid))
    return band_to_bidiagonal(Am, band=int(mid))
