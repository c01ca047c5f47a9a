"""The chase slot schedule (twin of ``svdsolver_tpu/ops/chase_schedule.py``).

Sweep ``i`` of an (n, n) band-``b`` chase runs a head pair (slot 0) plus
``nc_of_static(i, n, b)`` chase pairs (slots 1..nc), with window corners
advancing ``b`` rows per slot.  The plain chase and the CUDA chase kernel
(``csrc/band_chase.cu``, which repeats the formula in C) walk exactly this
schedule; the tests hold both formulas to the JAX package as integers.
"""


def nc_of_static(i, n, b):
    """Chase-hop count of sweep ``i`` on Python ints:
    ``max(0, ceil((n - (i + 2b + 1)) / b)) + 1``."""
    w2 = 2 * (b + 1) - 1  # i + w2 = first row past the head pair's window
    return max(0, -(-(n - (i + w2)) // b)) + 1


def s_max_of(n, b):
    """Record slots per sweep: head slot + the longest sweep's chase slots."""
    return nc_of_static(0, n, b) + 1
