"""The chase slot schedule (twin of ``svdsolver_tpu/ops/chase_schedule.py``).

Sweep ``i`` of an (n, n) band-``b`` chase runs a head pair (slot 0) plus
``nc_of_static(i, n, b)`` chase pairs (slots 1..nc), with window corners
advancing ``b`` rows per slot.  The plain chase and the CUDA chase kernel
(``csrc/band_chase.cu``, which repeats the formula in C) walk exactly this
schedule; the tests hold both formulas to the JAX package as integers.
"""

from typing import NamedTuple

import torch


def nc_of_static(i, n, b):
    """Chase-hop count of sweep ``i`` on Python ints:
    ``max(0, ceil((n - (i + 2b + 1)) / b)) + 1``."""
    w2 = 2 * (b + 1) - 1  # i + w2 = first row past the head pair's window
    return max(0, -(-(n - (i + w2)) // b)) + 1


def nc_of(i, n, b):
    """:func:`nc_of_static` on an int tensor ``i`` (a scalar or a vector of
    sweeps; ``n``, ``b`` Python ints): the twin of the JAX package's traced
    ``nc_of``, elementwise, in ``i``'s dtype."""
    i = torch.as_tensor(i)
    w2 = 2 * (b + 1) - 1
    ceil = -torch.div(-(n - (i + w2)), b, rounding_mode="floor")
    return torch.clamp_min(ceil, 0) + 1


def s_max_of(n, b):
    """Record slots per sweep: head slot + the longest sweep's chase slots."""
    return nc_of_static(0, n, b) + 1


def wave_slots(n, b, defer_left=False):
    """Slots past the head of the longest sweep: ``S = nc_of_static(0, n,
    b)``, one more with ``defer_left`` (the flush of the last pending
    left)."""
    return nc_of_static(0, n, b) + (1 if defer_left else 0)


def wave_ticks(n, b, defer_left=False):
    """Ticks of the wavefront schedule: sweep ``i`` runs slot ``s`` at tick
    ``3 i + s``, the last sweep (``n - 2``) its last slot at the end."""
    return 3 * (n - 2) + wave_slots(n, b, defer_left) + 1


def wave_units(n, b, defer_left=False):
    """Work units of a wavefront tick: the head pair (unit 0) and
    ``ceil(S / 3)`` chase lanes, ``S`` of :func:`wave_slots`."""
    return -(-wave_slots(n, b, defer_left) // 3) + 1


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

    With deferred left applies (``wave_pairs(defer_left=True)``) a slot's
    tiles are ``(r, c - b)``, ``(r, c)`` and ``(r + b, c)``: the pending
    left reflector of slot ``s - 1`` acts on the first two, the right
    elimination of pair ``(i, s)`` on the last two, and the new left
    reflector is column ``c`` of the last.  The head slot is one
    ``(b + 1) x b`` box at ``(i, i + 1)`` (its last row copied by the
    threads); a carried tile is ``(r + b, c)``, the next slot's ``(r,
    c - b)``, and with it the pending reflector stays in shared memory.
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


def _dl_carries(i, s, n, b):
    """Whether deferred-left slot ``(i, s)`` keeps its ``(r + b, c)`` tile
    and its new left reflector for the same lane's next slot: not the
    lane's last slot, that slot exists (``s + 1 <= nc + 1``), and its
    pending columns ``[c, c + 2b)`` start below ``n`` (this slot made a
    reflector)."""
    c = i + 1 + s * b
    return s % 3 != 0 and s + 1 <= nc_of_static(i, n, b) + 1 and c < n


def wave_pairs(n, b, carry=True, defer_left=False):
    """The pairs of the wavefront schedule that do work (corner column below
    ``n``), in tick order and unit order within a tick, as
    :class:`WavePair`.  ``carry=False``: every pair copies its whole window
    in and out (lanes striding over fewer CTAs than units).

    ``defer_left=True``: the slots of the deferred-left tick, one more a
    sweep (the flush ``s = nc + 1``).  A slot runs while its pending columns
    ``[c - b, c + b)`` start below ``n``; one whose corner column ``c`` is
    past ``n`` applies its pending reflector alone ("pending only": it
    copies only its ``(r, c - b)`` tile, and makes no reflector).  A slot
    that does not carry its tile in takes its pending reflector from the
    device ring (``s % 3 == 1`` with ``carry``: from the head or from the
    previous lane); one that does not carry out puts its new one there."""
    if defer_left:
        yield from _wave_dl_pairs(n, b, carry)
        return
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


def _wave_dl_pairs(n, b, carry):
    S = wave_slots(n, b, defer_left=True)
    for t in range(wave_ticks(n, b, defer_left=True)):
        q = (t - 1) // 3 if t >= 1 else -1  # newest sweep past its head
        if t % 3 == 0 and t // 3 <= n - 2:
            i = t // 3
            head = ((i, i + 1),)
            yield WavePair(t, 0, i, 0, i, i + 1, head, head, False, False)
        for u in range(1, -(-S // 3) + 1):
            i = q - (u - 1)
            s = t - 3 * i
            if i < 0 or i > n - 2 or s > nc_of_static(i, n, b) + 1:
                continue
            r = i + 1 + (s - 1) * b
            c = r + b
            if c - b >= n:
                continue  # nothing pending, no pair
            cin = carry and s >= 2 and _dl_carries(i, s - 1, n, b)
            cout = carry and _dl_carries(i, s, n, b)
            tiles = ((r, c - b), (r, c), (r + b, c)) if c < n else ((r, c - b),)
            yield WavePair(t, u, i, s, r, c, tiles[1:] if cin else tiles,
                           tiles[:2] if cout else tiles, cin, cout)


def wave_copy_bytes(n, b, defer_left=False):
    """Bytes the shared-memory tick's copies move on its critical path (the
    schedule bound's, over one CTA's copy rate): at each tick the most any
    one pair of :func:`wave_pairs` (one CTA a unit) moves, its boxes of
    ``b`` rows of ``b + 4`` float32 in and out, and the head pair's window
    row (``2b`` columns; ``b`` deferring the left applies) both ways."""
    box = 4 * b * (b + 4)
    row = 8 * b * (1 if defer_left else 2)
    most = {}
    for p in wave_pairs(n, b, defer_left=defer_left):
        nbytes = (len(p.loads) + len(p.stores)) * box + (row if p.s == 0 else 0)
        most[p.t] = max(most.get(p.t, 0), nbytes)
    return sum(most.values())


class SuperstepPair(NamedTuple):
    """One pair of a rank's pass of the pipelined chase, as the pass's
    wavefront kernel (``csrc/band_chase_superstep.cu``) runs it: at global
    tick ``t`` (``3 i`` for the head pair, ``3 i + k + 1`` for chase pair
    ``k``) on lane ``lane`` (sweep ``i = i0 + lane``); ``k = -1`` is the
    head pair, whose window's corner is ``(i, i + 1)``; chase pair ``k``'s
    is ``(r, r + b)``, ``r = i + 1 + k b``."""

    t: int
    lane: int
    i: int
    k: int


def superstep_pairs(n, b, i0, LG, R0, m, last, s_chase, Np):
    """The pairs of one rank's pass of one superstep of the pipelined chase
    (``models.two_stage.chase_superstep``'s pairs, the same arguments, ``Np``
    the buffer's columns) as :class:`SuperstepPair`, in tick order and lane
    order within a tick.  Sweep ``i = i0 + l`` runs its head pair if ``lo
    <= i < hi`` and its chase pairs from the first whose start row reaches
    ``lo``, at most ``s_chase`` of them and while the start row is below
    ``hi``; ``lo = R0 - 3 b l``, ``hi = R0 + m - 3 b l`` (``Np`` on the
    ``last`` rank).  Every pair is listed, those whose corner column lies
    past ``n`` (no-ops) too."""
    pairs = []
    for l in range(LG):
        i = i0 + l
        if i > n - 2:
            break
        lo = R0 - 3 * b * l
        hi = Np if last else R0 + m - 3 * b * l
        if lo <= i < hi:
            pairs.append(SuperstepPair(3 * i, l, i, -1))
        k0 = max(0, (lo - i - 1 + b - 1) // b)
        for k in range(k0, min(k0 + s_chase, nc_of_static(i, n, b))):
            if i + 1 + k * b >= hi:
                break
            pairs.append(SuperstepPair(3 * i + k + 1, l, i, k))
    return sorted(pairs)


def superstep_copy_bytes(n, b, i0, LG, R0, m, last, s_chase, Np):
    """Bytes the pass's copies move on its critical path (the schedule
    bound's, over one CTA's copy rate): at each tick the most any one pair
    of :func:`superstep_pairs` with work (corner column below ``n``) moves,
    as :func:`wave_copy_bytes` counts a pair: boxes of ``b`` rows of ``b +
    4`` float32 in and out, two each way and the window's last row (``2b``
    floats) both ways for a head pair, three each way for a chase pair less
    the tile its lane keeps from its last pair and the one it keeps for its
    next (a lane keeps its ``(r + b, c + b)`` tile whenever its next chase
    pair runs)."""
    box = 4 * b * (b + 4)
    most = {}
    pairs = superstep_pairs(n, b, i0, LG, R0, m, last, s_chase, Np)
    work = {(p.lane, p.k) for p in pairs if p.k >= 0 and p.i + 1 + (p.k + 1) * b < n}
    for p in pairs:
        if p.k < 0:
            nbytes = 4 * box + 16 * b
        elif (p.lane, p.k) in work:
            nbytes = (6 - ((p.lane, p.k - 1) in work) - ((p.lane, p.k + 1) in work)) * box
        else:
            continue
        most[p.t] = max(most.get(p.t, 0), nbytes)
    return sum(most.values())


def staged_pairs(i, n, b):
    """Chase pairs of sweep ``i`` that do work (corner column ``i + 1 +
    (k + 1) b`` below ``n``): a prefix of its ``nc_of_static`` pairs."""
    return min(nc_of_static(i, n, b), max(0, (n - i - 2) // b))


class StagedOp(NamedTuple):
    """One step of the staged chase kernel (``csrc/band_chase_staged.cu``,
    TMA route), in the order its threads take them.

    ``kind``:

    * ``"load"`` / ``"store"``: a box of ``rows`` rows (``b``, or ``b + 1``
      for the head pair's boxes) of ``b + 4`` columns with corner ``(r, c)``
      copied into / out of tile slot ``slot`` by the copy engine (``c`` a
      multiple of 4; entries past ``n`` read zero, writes past ``n`` are
      dropped); a load lands on the slot's ``mbarrier``, a store joins the
      bulk stores in flight;
    * ``"wait_read"`` / ``"wait_all"``: the copying thread waits until every
      store in flight has read its slot / has written device memory;
    * ``"head"``: the head pair of sweep ``i`` on ``slots`` = (h0, h1), its
      window's columns ``[i + 1, i + 1 + b)`` and the next ``b``;
    * ``"right"`` / ``"left"``: the right / left elimination of chase pair
      ``k`` of sweep ``i`` on ``slots`` = (A, B, C), the tiles ``(r, c)``,
      ``(r + b, c)`` and ``(r + b, c + b)`` of its corner ``(r, c)``; the
      right one reads A and B, the left one B and C.

    ``pair``: the (sweep, chase pair) whose tiles a copy moves (``k = -1``:
    the head).
    """

    kind: str
    slot: int
    r: int
    c: int
    pair: tuple
    slots: tuple = ()
    rows: int = 0


def staged_copies(n, b, K):
    """The staged chase kernel's steps for an (n, n) band ``b`` with a ring
    of ``NS = 2K + 1`` tile slots, as :class:`StagedOp`: sweep by sweep, the
    head pair, then the sweep's chase pairs, the loads running ``K`` pairs
    ahead.

    Pair k's A tile sits in slot ``2k mod NS``, B in the next, C in the one
    after, which is pair k + 1's A (carried).  The head pair is pair -1 of
    that ring: its two boxes of ``b + 1`` rows, h0 in slot ``NS - 1`` and
    h1 in slot 0, and h1 from its second row is pair 0's A.  Once pair k's
    right elimination is done, the copying thread waits for every store to
    be written (pair k - 1's B, or h0, shares 4 columns with this A), loads
    pair k - 1 + K's C into pair k - 1's B slot (h0's for k = 0), and stores
    A (h1 whole for k = 0); after the left elimination it waits for A's
    store to read its slot, loads pair k + K's B into it, and stores B (and
    C at the sweep's last pair).  Each wait comes a whole apply after the
    store it waits for.  A sweep starts once the previous one's stores have
    read their slots, and have been written where they may meet its loads
    (the previous sweep had at most ``K + 2`` pairs).
    """
    if b % 4:
        raise ValueError(f"the TMA design takes bands that are multiples of 4, not {b}")
    NS = 2 * K + 1
    prev = None  # the previous sweep's pairs with work
    for i in range(n - 1):
        a = (i + 1) & ~3
        head = (i, -1)
        nk = staged_pairs(i, n, b)
        if prev is not None:
            yield StagedOp("wait_all" if prev <= K + 2 else "wait_read", -1, 0, 0, head)

        def corner(k):
            r = i + 1 + k * b
            return r, (r + b) & ~3

        yield StagedOp("load", NS - 1, i, a, head, rows=b + 1)
        yield StagedOp("load", 0, i, a + b, head, rows=b + 1)
        for j in range(min(K, nk)):
            r, c = corner(j)
            yield StagedOp("load", 2 * j + 1, r + b, c, (i, j), rows=b)
        for j in range(min(K - 1, nk)):
            r, c = corner(j)
            yield StagedOp("load", 2 * j + 2, r + b, c + b, (i, j), rows=b)
        yield StagedOp("head", -1, i, i + 1, head, (NS - 1, 0))
        yield StagedOp("store", NS - 1, i, a, head, rows=b + 1)
        if nk == 0:
            yield StagedOp("store", 0, i, a + b, head, rows=b + 1)
        for k in range(nk):
            r, c = corner(k)
            sA, sB, sC = (2 * k) % NS, (2 * k + 1) % NS, (2 * k + 2) % NS
            slots = (sA, sB, sC)
            yield StagedOp("right", -1, r, r + b, (i, k), slots)
            yield StagedOp("wait_all", -1, 0, 0, (i, k))
            if k - 1 + K < nk:
                rc, cc = corner(k - 1 + K)
                yield StagedOp("load", (2 * k - 1) % NS, rc + b, cc + b, (i, k - 1 + K), rows=b)
            if k == 0:
                yield StagedOp("store", sA, i, c, (i, k), rows=b + 1)
            else:
                yield StagedOp("store", sA, r, c, (i, k), rows=b)
            yield StagedOp("left", -1, r, r + b, (i, k), slots)
            if k + K < nk:
                ra, ca = corner(k + K)
                yield StagedOp("wait_read", -1, 0, 0, (i, k))
                yield StagedOp("load", sA, ra + b, ca, (i, k + K), rows=b)
            yield StagedOp("store", sB, r + b, c, (i, k), rows=b)
            if k == nk - 1:
                yield StagedOp("store", sC, r + b, c + b, (i, k), rows=b)
        prev = nk
    yield StagedOp("wait_all", -1, 0, 0, (n - 2, -1))


def staged_copy_bytes(n, b, K=1):
    """Bytes the staged chase kernel's copies move for an (n, n) band ``b``
    (float32): every load and store of :func:`staged_copies`, a box of its
    ``rows`` rows of ``b + 4`` floats each.  Each tile is loaded and stored
    once, whatever ``K``."""
    return sum(4 * op.rows * (b + 4) for op in staged_copies(n, b, K)
               if op.kind in ("load", "store"))


def store_pitch(b):
    """Row pitch (floats) of the packed chase's band store: dense entry
    ``(g, j)`` lives at ``store_pitch(b) * g + j``; a multiple of 4 (16
    bytes, as the copy engine needs) wherever ``b`` is."""
    return 3 * int(b) + 8


def store_range(b):
    """The offsets ``j - g`` the band store keeps, ``(-b - 2, 2b + 4)``
    inclusive: every entry a box of :func:`staged_copies` touches inside
    the matrix (the tests walk every box)."""
    return -int(b) - 2, 2 * int(b) + 4


def store_floats(n, b):
    """Floats of the band store of an (n, n) band ``b``: the last entry
    ``(n - 1, n - 1)`` sits at ``(n - 1) * pitch + n - 1``."""
    return (n - 1) * store_pitch(b) + n
