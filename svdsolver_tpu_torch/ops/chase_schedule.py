"""The chase slot schedule (twin of ``svdsolver_tpu/ops/chase_schedule.py``).

Sweep ``i`` of an (n, n) band-``b`` chase runs a head pair (slot 0) plus
``nc_of_static(i, n, b)`` chase pairs (slots 1..nc), with window corners
advancing ``b`` rows per slot.  The plain chase and the CUDA chase kernel
(``csrc/band_chase.cu``, which repeats the formula in C) walk exactly this
schedule; the tests hold both formulas to the JAX package as integers.
"""

from typing import NamedTuple


def nc_of_static(i, n, b):
    """Chase-hop count of sweep ``i`` on Python ints:
    ``max(0, ceil((n - (i + 2b + 1)) / b)) + 1``."""
    w2 = 2 * (b + 1) - 1  # i + w2 = first row past the head pair's window
    return max(0, -(-(n - (i + w2)) // b)) + 1


def s_max_of(n, b):
    """Record slots per sweep: head slot + the longest sweep's chase slots."""
    return nc_of_static(0, n, b) + 1


def wave_ticks(n, b):
    """Ticks of the wavefront schedule: sweep ``i`` runs slot ``s`` at tick
    ``3 i + s``, the last sweep (``n - 2``) its last slot at the end."""
    return 3 * (n - 2) + nc_of_static(0, n, b) + 1


def wave_units(n, b):
    """Work units of a wavefront tick: the head pair (unit 0) and
    ``ceil(S / 3)`` chase lanes, ``S = nc_of_static(0, n, b)``."""
    return -(-nc_of_static(0, n, b) // 3) + 1


class WavePair(NamedTuple):
    """One pair of the wavefront schedule as the shared-memory tick of
    ``csrc/band_chase_wave.cu`` runs it.

    ``t``, ``unit``: its tick and work unit (0: the head pair, ``u >= 1``:
    chase lane ``u``, slots ``3u - 2 .. 3u`` of one sweep); ``i``, ``s``:
    sweep and slot.  The window's corner is ``(r, c)``: the head pair's
    window, ``(b + 1) x 2b`` at ``(i, i + 1)``, is two ``b x b`` tiles,
    ``(i, i + 1)`` and ``(i, i + 1 + b)``, and row ``i + b``, which the
    threads copy; a chase pair's is three ``b x b`` tiles, ``(r, c)``,
    ``(r + b, c)`` and ``(r + b, c + b)``.  ``loads`` and ``stores`` are the
    corners of the tiles copied in and written back; a tile carried to the
    lane's next pair (``carry_out``)
    stays in shared memory, and that pair (``carry_in``) does not load its
    ``(r, c)`` tile.
    """

    t: int
    unit: int
    i: int
    s: int
    r: int
    c: int
    loads: tuple
    stores: tuple
    carry_in: bool
    carry_out: bool


def _carries(i, s, n, b):
    """Whether chase pair ``(i, s)`` keeps its ``(r + b, c + b)`` tile for
    the same lane's next pair: not the lane's last slot (``s % 3 == 0``),
    and that pair exists and has work (its corner column below ``n``)."""
    c = i + 1 + s * b
    return s % 3 != 0 and s + 1 <= nc_of_static(i, n, b) and c + b < n


def wave_pairs(n, b, carry=True):
    """The pairs of the wavefront schedule that do work (corner column below
    ``n``), in tick order and unit order within a tick, as
    :class:`WavePair`.  ``carry=False``: every pair copies its whole window
    in and out (lanes striding over fewer CTAs than units)."""
    S = nc_of_static(0, n, b)
    for t in range(wave_ticks(n, b)):
        q = (t - 1) // 3 if t >= 1 else -1  # newest sweep past its head
        if t % 3 == 0 and t // 3 <= n - 2:
            i = t // 3
            head = ((i, i + 1), (i, i + 1 + b))
            yield WavePair(t, 0, i, 0, i, i + 1, head, head, False, False)
        for u in range(1, -(-S // 3) + 1):
            i = q - (u - 1)
            s = t - 3 * i
            if i < 0 or i > n - 2 or s > nc_of_static(i, n, b):
                continue
            r = i + 1 + (s - 1) * b
            c = r + b
            if c >= n:
                continue
            cin = carry and s >= 2 and _carries(i, s - 1, n, b)
            cout = carry and _carries(i, s, n, b)
            tiles = ((r, c), (r + b, c), (r + b, c + b))
            yield WavePair(t, u, i, s, r, c, tiles[1:] if cin else tiles,
                           tiles[:2] if cout else tiles, cin, cout)
