"""The band -> bidiagonal chase on the wavefront schedule, one CTA a lane
(``csrc/band_chase_wave.cu``): plain, recording, and with deferred left
applies.

``band_to_bidiagonal_wave`` stands for the TPU's ``band_chase_wave.
_wave_chase_kernel`` and ``band_chase._wavefront_kernel`` (the
``wavefront=True`` route of ``band_to_bidiagonal_pallas``, which
:func:`band_chase.band_to_bidiagonal` sends here too) and is the
counterpart of the JAX package's ``band_to_bidiagonal_pallas_wave``.
``band_to_bidiagonal_wave_accum`` stands for ``band_chase_wave.
_wave_chase_rec_kernel`` (``band_to_bidiagonal_pallas_wave_accum``): it also
records every reflector, bit-equal to the sequential recording chase's.
``band_to_bidiagonal_wave_dl`` stands for ``band_chase_wave.
_wave_chase_dl_kernel``: each pair's left apply is deferred one tick and
fused into the same sweep's next right apply (a slot's tiles are ``(r, c -
b)``, ``(r, c)`` and ``(r + b, c)``).  All give ``(d, e)``
bit-equal to the sequential chase kernel's.  Their plain versions are
``models.two_stage.band_to_bidiagonal_wavefront`` (``record``,
``defer_left``); a CPU tensor runs those.

The wavefront runs sweeps three slots apart at once, each lane on its own
CTA of a cooperative launch with a grid barrier between ticks.  A tick runs
in one of two ways, chosen by shape before the launch for every entry: the
shared-memory tick copies each pair's window into shared memory by TMA and
keeps a lane's shared tile (and, deferring the left applies, its pending
reflector) for its next slot (:func:`smem_tick_takes`: every band of the
main paths, b <= 128), the L2 tick runs the pair on the matrix through L2
(wider bands, other shapes).  Past b = 256, wherever ``band_chase.
wide_route`` takes the band, a third tick runs the schedule with one
thread-block cluster a work unit (``csrc/band_chase_cluster.cu``,
``svdt_band_chase_wave_cluster`` and ``_cluster_rec``: each pair the wide
pair split over the cluster's CTAs, bit-equal to the L2 tick, which stays
as its oracle and as the route past the plan).  Each tick counts its own launches; the plain
version of the shared-memory tick is ``two_stage.
band_to_bidiagonal_wavefront_tiles`` (tiles copied in and out as the
kernel copies them; ``defer_left`` for the deferred-left entry's).  The
main paths route by
:func:`wave_chase_preferred` (``svdvals``) and
:func:`wave_chase_accum_preferred` (``svd``, ``svds``), measured on the
card; elsewhere they take the sequential chase (``band_chase``: its staged
TMA design on every band of the main paths).
"""

import ctypes

import torch

from svdsolver_tpu_torch.models import two_stage
from svdsolver_tpu_torch.ops.chase_schedule import s_max_of
from svdsolver_tpu_torch.ops.cuda import _build

# Launches since the last reset, by entry and tick: the shared-memory tick
# (b <= 128), the cluster tick (b > 256) and the L2 tick (other shapes).
launches = 0  # band_to_bidiagonal_wave, shared-memory tick
launches_l2 = 0  # band_to_bidiagonal_wave, L2 tick
launches_rec = 0  # band_to_bidiagonal_wave_accum, shared-memory tick
launches_rec_l2 = 0  # band_to_bidiagonal_wave_accum, L2 tick
launches_dl = 0  # band_to_bidiagonal_wave_dl, shared-memory tick
launches_dl_l2 = 0  # band_to_bidiagonal_wave_dl, L2 tick
launches_cluster = 0  # band_to_bidiagonal_wave, cluster tick
launches_cluster_rec = 0  # band_to_bidiagonal_wave_accum, cluster tick
last_ctas = 0  # CTAs of the last launch (lanes stride over them, or over clusters)
last_tick = ""  # "smem", "cluster" or "l2": the tick of the last launch

NARROW_BAND = 256  # the narrow chase pair's 2b window columns on 512 threads
# the wide pair (bands past NARROW_BAND): v in dynamic shared memory, beside
# the kernels' static arrays (8 KB at most)
WIDE_MAX_BAND = (_build.MAX_SMEM - 8 * 1024) // 4
SMEM_BAND = 128  # the widest band of the shared-memory tick (3 b x b tiles)

_ENTRIES = {
    "svdt_band_chase_wave": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP, _build.INT]
        + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP, _build.INT] + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_dl": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 3
        + [_build.INT] * 2 + [_build.VOIDP] * 2
    ),
    "svdt_band_chase_wave_smem": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP, _build.INT]
        + [_build.VOIDP, _build.INT, _build.VOIDP]
    ),
    "svdt_band_chase_wave_smem_rec": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 4
        + [_build.INT, _build.VOIDP, _build.INT, _build.VOIDP, _build.INT,
           _build.VOIDP]
    ),
    "svdt_band_chase_wave_smem_dl": (
        [_build.VOIDP] * 3 + [_build.INT] * 2 + [_build.VOIDP] * 3
        + [_build.INT] * 2 + [_build.VOIDP, _build.INT, _build.VOIDP]
    ),
    "svdt_wave_copy": [_build.VOIDP] + [_build.INT] * 5 + [_build.VOIDP],
}


def tma_shape_takes(n, band):
    """Whether the copy engine takes an (n, n) band of ``band`` by its shape
    (``tma_takes`` of ``csrc/chase_tma.cuh``, the address aside): it moves
    boxes of whole 16-byte rows, so ``band`` and ``n`` are multiples of 4;
    three ``band x band`` tiles fit a CTA's shared memory up to
    ``band = 128``.  The shared-memory tick and the sequential chase's
    staged TMA design share this rule."""
    b, n = int(band), int(n)
    return 4 <= b <= SMEM_BAND and b % 4 == 0 and n % 4 == 0


def smem_tick_takes(A, band):
    """Whether the shared-memory tick takes ``A`` with ``band``:
    :func:`tma_shape_takes` and ``A`` 16-byte aligned."""
    return tma_shape_takes(A.shape[0], band) and A.data_ptr() % 16 == 0


def _tick_of(A, b, tick, defer_left=False):
    """The tick a launch takes: the shared-memory one where it can, the
    cluster one past b = 256 where its plan takes the band, else the L2
    tick; or the one ``tick`` names ("smem" and "cluster" raise where they
    cannot)."""
    if tick not in (None, "smem", "l2", "cluster"):
        raise ValueError(f"_tick must be None, 'smem', 'l2' or 'cluster', got {tick!r}")
    takes = smem_tick_takes(A, b)
    if tick == "smem" and not takes:
        raise ValueError(f"the shared-memory tick does not take n={A.shape[0]}, band={b}")
    from svdsolver_tpu_torch.ops.cuda import band_chase

    cluster = not defer_left and band_chase.wide_route(A.shape[0], b) is not None
    if tick == "cluster" and not cluster:
        raise ValueError(f"the cluster tick does not take n={A.shape[0]}, band={b}")
    return tick or ("smem" if takes else "cluster" if cluster else "l2")


def band_to_bidiagonal_wave_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band)


def band_to_bidiagonal_wave_accum_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band, record=True)


def band_to_bidiagonal_wave_dl_plain(A, band=128):
    return two_stage.band_to_bidiagonal_wavefront(A, band=band, defer_left=True)


def band_to_bidiagonal_wave_tiles_plain(A, band=128, record=False, carry=True,
                                        defer_left=False):
    """Plain version of the shared-memory tick: boxes copied in and out, a
    lane's tile carried (``carry``: one CTA a unit)."""
    return two_stage.band_to_bidiagonal_wavefront_tiles(A, band=band, record=record,
                                                        carry=carry, defer_left=defer_left)


def band_range(n, defer_left=False):
    """The widest band the chase kernels take for an (n, n) band: any band
    up to ``NARROW_BAND`` (the narrow pair), and up to ``n`` past it (the
    wide pair, at most ``WIDE_MAX_BAND``); the deferred-left entry has no
    wide instance and stops at ``NARROW_BAND``."""
    if defer_left:
        return NARROW_BAND
    return max(NARROW_BAND, min(int(n), WIDE_MAX_BAND))


def check_band(A, b, defer_left=False):
    """``n`` of a square ``A`` whose band ``b`` the chase kernels take
    (:func:`band_range`); raises ``ValueError`` otherwise."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    top = band_range(A.shape[0], defer_left)
    if not 1 <= b <= top:
        raise ValueError(f"band={b} outside the kernel's range [1, {top}]")
    return A.shape[0]


def _plain(A, b, record, ctas, tick, defer_left=False):
    """A CPU tensor: the plain version of the tick the card would take."""
    if _tick_of(A, b, tick, defer_left) != "smem":
        return (band_to_bidiagonal_wave_accum_plain if record
                else band_to_bidiagonal_wave_dl_plain if defer_left
                else band_to_bidiagonal_wave_plain)(A, band=b)
    lanes = two_stage.wave_lanes(A.shape[0], b, defer_left=defer_left)
    carry = ctas is None or int(ctas) >= lanes + 1
    return band_to_bidiagonal_wave_tiles_plain(A, band=b, record=record, carry=carry,
                                               defer_left=defer_left)


def _launch_cluster(A, b, ctas, record):
    """One launch of the cluster tick on a copy of the CUDA ``A``: at most
    ``ctas`` // C clusters (all that are co-resident, at most one a unit,
    where None) of the plan's C CTAs."""
    global last_ctas, last_tick
    from svdsolver_tpu_torch.ops.cuda import band_chase

    n = A.shape[0]
    plan = band_chase.wide_route(n, b)
    if plan is None:
        raise ValueError(f"the cluster tick does not take n={n}, band={b}")
    cap = 0 if ctas is None else max(1, int(ctas) // plan.ctas)
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    ctr = torch.zeros((1,), dtype=torch.int32, device=A.device)  # grid barrier
    got = ctypes.c_int(0)
    args = [work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b]
    recs = []
    if record:
        recs, s_max = band_chase._records(n, b, A)
        args += [t.data_ptr() for t in recs] + [s_max]
    kernel = "band_chase_wave_cluster" + ("_rec" if record else "")
    with torch.cuda.device(A.device):
        lib = _build.load("band_chase_cluster", band_chase._CLUSTER_ENTRIES)
        band_chase.check_resident(lib, plan, True, record)
        err = getattr(lib, f"svdt_{kernel}")(
            *args, ctr.data_ptr(), *band_chase.plan_args(plan), cap, ctypes.addressof(got),
            _build.stream_of(A))
    _build.raise_on_error(err, kernel)
    last_ctas = got.value * plan.ctas
    last_tick = "cluster"
    return (d, e, *recs)


def _launch(A, b, defer_left, ctas, record=False, tick="l2", smem=None):
    global last_ctas, last_tick
    if tick == "cluster":
        return _launch_cluster(A, b, ctas, record)
    n = A.shape[0]
    work = A.clone()
    d = torch.empty((n,), dtype=A.dtype, device=A.device)
    e = torch.empty((n - 1,), dtype=A.dtype, device=A.device)
    ctr = torch.zeros((1,), dtype=torch.int32, device=A.device)  # grid barrier
    got = ctypes.c_int(0)
    max_ctas = 0 if ctas is None else int(ctas)
    if ctas is not None and max_ctas < 1:
        raise ValueError(f"_ctas must be >= 1, got {ctas}")
    smem = 0 if smem is None else int(smem)
    lib = _build.load("band_chase_wave", _ENTRIES)
    stream = _build.stream_of(A)
    with torch.cuda.device(A.device):
        if record:
            s_max = s_max_of(n, b)
            # zeros: the kernel writes only the slots the schedule reaches
            VL, VR = torch.zeros((2, n - 1, s_max, b), dtype=A.dtype, device=A.device)
            TL, TR = torch.zeros((2, n - 1, s_max), dtype=A.dtype, device=A.device)
            recs = (VL.data_ptr(), TL.data_ptr(), VR.data_ptr(), TR.data_ptr(), s_max)
            if tick == "smem":
                err = lib.svdt_band_chase_wave_smem_rec(
                    work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, *recs,
                    ctr.data_ptr(), max_ctas, ctypes.addressof(got), smem, stream)
            else:
                err = lib.svdt_band_chase_wave_rec(
                    work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, *recs,
                    ctr.data_ptr(), max_ctas, ctypes.addressof(got), stream)
        elif defer_left:
            slots = two_stage.wave_lanes(n, b, defer_left=True) + 2
            ring_v = torch.zeros((slots, b), dtype=A.dtype, device=A.device)
            ring_t = torch.zeros((slots,), dtype=A.dtype, device=A.device)
            args = (work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b, ctr.data_ptr(),
                    ring_v.data_ptr(), ring_t.data_ptr(), slots, max_ctas,
                    ctypes.addressof(got))
            if tick == "smem":
                err = lib.svdt_band_chase_wave_smem_dl(*args, smem, stream)
            else:
                err = lib.svdt_band_chase_wave_dl(*args, stream)
        elif tick == "smem":
            err = lib.svdt_band_chase_wave_smem(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                ctr.data_ptr(), max_ctas, ctypes.addressof(got), smem, stream)
        else:
            err = lib.svdt_band_chase_wave(
                work.data_ptr(), d.data_ptr(), e.data_ptr(), n, b,
                ctr.data_ptr(), max_ctas, ctypes.addressof(got), stream,
            )
    name = ("_rec" if record else "_dl" if defer_left else "") + ("_smem" if tick == "smem" else "")
    _build.raise_on_error(err, "band_chase_wave" + name)
    last_ctas = got.value
    last_tick = tick
    return (d, e, VL, TL, VR, TR) if record else (d, e)


def band_to_bidiagonal_wave(A, band=128, _ctas=None, _tick=None, _smem=None):
    """Bulge-chase the upper-band ``A`` (n, n; ``band`` superdiagonals) to
    bidiagonal on the wavefront schedule; returns ``(d, e)``, bit-equal to
    the sequential chase's.

    A CUDA tensor must be contiguous float32 with a band
    :func:`band_range` takes (any band up to 256, and up to n past it,
    where the cluster tick or the L2 tick runs the wide pair); it launches
    the kernel on a copy of ``A`` over as many CTAs (clusters, on the
    cluster tick) as work units, or as fit on the card at once (``_ctas``
    caps the CTAs; units stride over them).  Where :func:`smem_tick_takes`
    holds (every band of the main paths) the kernel runs the shared-memory
    tick; past b = 256 the cluster tick where ``band_chase.wide_route``
    takes the band; else the L2 tick.  ``_tick`` ("smem", "cluster" or
    "l2") forces one, ``_smem`` sets the shared-memory tick's dynamic
    shared memory a CTA (bytes).  A failed launch raises.  A CPU tensor
    runs the plain version of the tick the card would take.
    """
    global launches, launches_l2, launches_cluster
    b = int(band)
    n = check_band(A, b)
    if not _build.check_input(A, "A", 2):
        return _plain(A, b, False, _ctas, _tick)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    tick = _tick_of(A, b, _tick)
    out = _launch(A, b, False, _ctas, tick=tick, smem=_smem)
    if tick == "smem":
        launches += 1
    elif tick == "cluster":
        launches_cluster += 1
    else:
        launches_l2 += 1
    return out


def band_to_bidiagonal_wave_dl(A, band=128, _ctas=None, _tick=None):
    """As :func:`band_to_bidiagonal_wave`, each pair's left apply deferred
    one tick and fused into the same sweep's next right apply (two passes
    over a pair's rows instead of three); ``(d, e)`` bit-equal to
    :func:`band_to_bidiagonal_wave`'s, for bands up to 256 (it has no
    wide instance).  The tick is chosen as there, by shape before the
    launch (``_tick`` forces one); a failed launch raises.
    A CPU tensor runs the plain version of the tick the card would take
    (``band_to_bidiagonal_wavefront_tiles(defer_left=True)``, or
    ``band_to_bidiagonal_wavefront(defer_left=True)`` for the L2 tick).
    """
    global launches_dl, launches_dl_l2
    b = int(band)
    n = check_band(A, b, defer_left=True)
    if not _build.check_input(A, "A", 2):
        return _plain(A, b, False, _ctas, _tick, defer_left=True)
    if n < 2:
        return torch.abs(torch.diagonal(A)), A.new_zeros((0,))
    tick = _tick_of(A, b, _tick, defer_left=True)
    out = _launch(A, b, True, _ctas, tick=tick)
    if tick == "smem":
        launches_dl += 1
    else:
        launches_dl_l2 += 1
    return out


def band_to_bidiagonal_wave_accum(A, band=128, _ctas=None, _tick=None, _smem=None):
    """As :func:`band_to_bidiagonal_wave`, recording every reflector;
    returns ``(d, e, VL, TL, VR, TR)`` as ``band_chase.
    band_to_bidiagonal_accum``, whose kernel fills the same slots with the
    same values, bit for bit (zero rows with tau 0 for identity reflectors
    and the slots the schedule never reaches).  Counterpart of the JAX
    ``band_to_bidiagonal_pallas_wave_accum``.  The tick is chosen as there.
    A CPU tensor runs the plain version (``band_to_bidiagonal_wavefront
    (record=True)`` or its tile twin, whose records keep ``v = e_0`` for
    identity reflectors, as the plain sequential chase's do).
    """
    global launches_rec, launches_rec_l2, launches_cluster_rec
    b = int(band)
    n = check_band(A, b)
    if not _build.check_input(A, "A", 2):
        if n < 2:
            raise ValueError("band_to_bidiagonal_accum needs n >= 2")
        return _plain(A, b, True, _ctas, _tick)
    if n < 2:
        raise ValueError("band_to_bidiagonal_accum needs n >= 2")
    tick = _tick_of(A, b, _tick)
    out = _launch(A, b, False, _ctas, record=True, tick=tick, smem=_smem)
    if tick == "smem":
        launches_rec += 1
    elif tick == "cluster":
        launches_cluster_rec += 1
    else:
        launches_rec_l2 += 1
    return out


def window_copy(A, band, r, c, reps):
    """Time base of the shared-memory tick's schedule bound: one CTA copies
    the three ``band x band`` tiles of a chase window at corner ``(r, c)``
    of the CUDA float32 ``A`` into shared memory and back, ``reps`` times,
    as the tick does (entries past ``n`` read zero, writes dropped).  ``A``
    is left as it was.  Not a chase: it counts no launch."""
    b = int(band)
    if not (A.is_cuda and A.dtype == torch.float32 and A.is_contiguous()
            and smem_tick_takes(A, b)):
        raise ValueError("window_copy takes a CUDA float32 matrix the shared-memory tick takes")
    lib = _build.load("band_chase_wave", _ENTRIES)
    with torch.cuda.device(A.device):
        err = lib.svdt_wave_copy(A.data_ptr(), A.shape[0], b, int(r), int(c), int(reps),
                                 _build.stream_of(A))
    _build.raise_on_error(err, "wave_copy")


def wave_lanes_needed(n, band):
    """The fewest wavefront lanes (``two_stage.wave_lanes``) at which the
    wavefront chase beats the sequential chase for an (n, n) band of
    ``band``, by shape.  Where both run their copy-engine designs
    (:func:`tma_shape_takes`): four lanes up to ``band = 64``, three at
    ``band = 128``, and two between, where the sequential design runs its
    run-time-band instance of four columns a thread; elsewhere two lanes:
    where both run through L2, as measured against the L2 sequential
    kernel (one lane at 256 / 64: 3.060 against 4.621 ms), and past
    ``band = 256``, where ``band_chase.wide_route`` takes the band and
    both run on thread-block clusters (the sequential cluster kernel
    against the cluster tick: the wide table below).

    Measured on one NVIDIA H100 80GB HBM3 at 700.00 W, all rows in one run
    (``chip_smoke.py``, ``phase_route_times``: Stage I bands of a uniform
    matrix, the two chases in turns, the faster of two medians, ms; the
    sequential chase on its staged TMA design, the wavefront on its
    shared-memory tick):

    ===========  =====  ==========  =========  ==========  =========  ==========
    n / band     lanes  sequential  wavefront  seq. rec.   wave rec.  routed
    ===========  =====  ==========  =========  ==========  =========  ==========
    32 / 4       3      0.542       0.646      0.728       0.829      sequential
    44 / 4       4      0.914       0.854      1.028       0.967      wavefront
    80 / 8       3      1.373       1.434      1.640       1.658      sequential
    88 / 8       4      1.713       1.576      1.893       1.814      wavefront
    96 / 12      3      1.408       1.663      1.585       1.787      sequential
    132 / 12     4      2.457       2.219      2.574       2.385      wavefront
    160 / 16     3      2.673       2.728      2.869       2.836      sequential
    176 / 16     4      3.185       2.955      3.397       3.119      wavefront
    192 / 24     3      2.827       3.205      2.894       3.389      sequential
    264 / 24     4      4.911       4.512      5.160       4.731      wavefront
    224 / 32     2      2.131       3.034      2.076       2.982      sequential
    256 / 32     3      2.605       3.506      2.719       3.621      sequential
    320 / 32     3      3.948       4.444      4.042       4.501      sequential
    352 / 32     4      4.678       4.824      4.816       4.910      wavefront
    416 / 32     4      6.440       5.940      6.517       5.829      wavefront
    384 / 48     3      7.223       7.415      7.764       7.942      sequential
    528 / 48     4      12.925      10.391     13.793      10.931     wavefront
    256 / 64     1      2.071       3.925      2.150       3.874      sequential
    384 / 64     2      4.086       6.214      4.328       6.392      sequential
    512 / 64     3      6.905       8.513      7.167       8.515      sequential
    640 / 64     3      10.383      10.889     10.720      10.868     sequential
    704 / 64     4      12.516      12.143     12.786      12.153     wavefront
    1024 / 64    5      25.318      17.579     26.102      18.379     wavefront
    560 / 80     2      21.463      18.133     22.298      18.430     wavefront
    480 / 96     2      13.942      15.095     14.804      15.437     wavefront
    768 / 96     3      33.036      25.822     34.626      26.788     wavefront
    784 / 112    2      34.317      28.870     36.285      30.631     wavefront
    896 / 128    2      25.901      26.771     25.952      27.500     sequential
    1024 / 128   3      33.072      30.959     33.122      32.133     wavefront
    2048 / 128   5      124.589     66.678     122.831     68.066     wavefront
    3840 / 128   10     424.280     129.612    417.687     131.033    wavefront
    7680 / 128   20     1667.585    266.095    1645.510    269.329    wavefront
    ===========  =====  ==========  =========  ==========  =========  ==========

    Two shapes lose a little to the rule in this run: 352 / 32 (four
    lanes; the sequential chase 3 % faster, a near tie that other runs
    read the other way) and 480 / 96 (two lanes; 8 %).  At 640 / 64 the
    two tie within the spread between runs (the recording entries 1.4 %
    apart here), as do 80 / 8 and 160 / 16 at three lanes.

    The wide table: the sequential cluster kernel and the cluster tick
    (``csrc/band_chase_cluster.cu``, 16 CTAs a cluster) in turns on a
    uniform band, one run each, ms (``tools/chase_cluster_split.py
    --lanes``; NVIDIA H100 80GB HBM3 at 700.00 W).  The tick ran slower
    on 4 and 8 CTAs a cluster at every row (at 6144 / 512: 1159.127 and
    693.609 ms):

    ===========  =====  ==============  ============  ===========  =========  ==========
    n / band     lanes  cluster kernel  cluster tick  kernel rec.  tick rec.  routed
    ===========  =====  ==============  ============  ===========  =========  ==========
    2048 / 512   1      96.831          95.713        106.615      98.793     sequential
    1440 / 288   2      54.389          50.644        57.439       51.447     wavefront
    3840 / 512   3      340.319         233.046       349.940      235.793    wavefront
    6144 / 512   4      872.045         417.648       894.048      419.512    wavefront
    ===========  =====  ==============  ============  ===========  =========  ==========

    One lane is a near tie at 2048 / 512 (the tick 1 % ahead) and the
    sequential kernel's elsewhere: 24.376 against 26.286 ms at 900 / 257,
    9.374 against 11.751 at 640 / 640 (``chip_smoke.py``,
    ``check_wide_chases``, the same call's build); so the wide bands keep
    the rule of two lanes.
    """
    b = int(band)
    if not tma_shape_takes(n, b):
        return 2
    if b <= 64:
        return 4
    return 3 if b == SMEM_BAND else 2


def wave_chase_preferred(n, band):
    """Whether ``svdvals`` takes the wavefront chase for an (n, n) band of
    ``band``: where its sweeps run in at least :func:`wave_lanes_needed`
    lanes (whose docstring holds the measurements).  With fewer lanes the
    head pair and the few chase lanes cannot hide the grid barrier a tick,
    and the sequential chase's staged TMA design (one CTA, ~3.6 us a pair
    at b = 64, ~7.7 at b = 128) wins: on the main paths every input up to
    n = 640 (b = 32 or 64) takes the sequential chase, and from 641 on
    (b = 64 at four lanes or more, b = 128 at three or more) the
    wavefront."""
    return two_stage.wave_lanes(int(n), int(band)) >= wave_lanes_needed(n, band)


def wave_chase_accum_preferred(n, band):
    """Whether ``svd`` and ``svds`` take the recording wavefront chase: the
    rule of :func:`wave_chase_preferred`, :func:`wave_lanes_needed` lanes
    or more (the recording entries were measured beside the plain ones)."""
    return two_stage.wave_lanes(int(n), int(band)) >= wave_lanes_needed(n, band)
