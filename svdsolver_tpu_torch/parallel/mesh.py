"""The device mesh of the sharded entries, its collectives, and a launcher
(twin of ``svdsolver_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process sees every device and
``shard_map`` runs a body on each.  The port is SPMD on
``torch.distributed``: one process a rank, every rank calls an entry with
the same global input, works on its own block, and gets the global result
back.  :func:`make_mesh` lays the ranks out as the JAX mesh lays out its
devices, ``(dp, tp)`` row-major (rank ``i_dp * tp + i_tp``), and returns a
:class:`Mesh` with the rank's coordinates, a process group for each axis,
the rank's compute device and the collectives, named after JAX's
(``psum``, ``pmax``, ``all_gather``, ``psum_scatter``, ``ppermute``).  Each
collective counts its calls, the bytes it moved, the bytes it staged
through host memory and the host seconds it took (waiting for the other
ranks included): :meth:`Mesh.stats`.  :func:`spawn` starts the ranks and
stands for JAX's single controller.

The backend is gloo: NCCL refuses two ranks on one GPU, and the sharded
entries are checked on one card whose ranks share it.  NCCL, for ranks that
each have a card, is not written yet.  Gloo takes CUDA tensors in some of
its operations only.  With torch 2.11 (CUDA 12.8) on the H100, two ranks
sharing the card (``tools/gloo_cuda_probe.py``): ``all_reduce`` (sum and max),
``all_gather`` and ``reduce_scatter`` take CUDA tensors (gloo copies them
through host memory itself); ``isend``/``irecv`` do not check the device
and hand the CUDA pointer to the socket, and the rank aborts (``writev:
Bad address``).  So :data:`DIRECT_CUDA` lists ``psum``, ``pmax``,
``all_gather`` and ``psum_scatter``, and ``ppermute`` on a CUDA tensor
copies it through a pinned host buffer and back.  That copy is the
transport, not a fallback: the arithmetic stays on the card.
"""

import contextlib
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

# The collectives gloo runs on CUDA tensors as they are; the others stage
# CUDA tensors through pinned host memory (module docstring)
DIRECT_CUDA = frozenset({"psum", "pmax", "all_gather", "psum_scatter"})

# the kernel sources the sharded entries launch, built once in the parent
# before the ranks start (each rank would otherwise run nvcc itself)
KERNEL_SOURCES = ("panel_qr", "band_chase", "band_chase_staged", "band_chase_wave",
                  "band_chase_superstep", "bisect", "tridiag_solve")


def default_dp(n_devices):
    """The JAX package's default ``dp``: the largest power of two whose
    square is at most ``n_devices`` and that divides it."""
    dp = 1
    while dp * 2 * dp * 2 <= n_devices and n_devices % (dp * 2) == 0:
        dp *= 2
    return dp


class Mesh:
    """A ``(dp, tp)`` mesh of ranks as seen from one rank: ``shape`` (axis
    name -> size), ``coords`` (axis name -> this rank's index), ``device``
    (where this rank computes) and the collectives over an axis.  Built by
    :func:`make_mesh` inside every rank."""

    def __init__(self, dp, tp, axis_names, device):
        a_dp, a_tp = axis_names
        rank = dist.get_rank()
        self.rank = rank
        self.axis_names = tuple(axis_names)
        self.shape = {a_dp: dp, a_tp: tp}
        self.coords = {a_dp: rank // tp, a_tp: rank % tp}
        self.device = torch.device(device)
        # dist.new_group is collective: every rank makes every group, in one order
        self._groups = {}
        for i in range(dp):
            ranks = [i * tp + j for j in range(tp)]
            group = dist.new_group(ranks)
            if i == rank // tp:
                self._groups[a_tp] = (group, ranks)
        for j in range(tp):
            ranks = [i * tp + j for i in range(dp)]
            group = dist.new_group(ranks)
            if j == rank % tp:
                self._groups[a_dp] = (group, ranks)
        self._pinned = {}
        self.reset_stats()

    def axis_index(self, axis):
        return self.coords[axis]

    def reset_stats(self):
        self._stats = {}

    def stats(self):
        """``{collective: {"calls", "bytes", "staged_bytes", "largest",
        "seconds"}}`` since the last :meth:`reset_stats`: ``bytes`` the
        larger of each call's input and output, ``largest`` the most bytes
        of one call, ``seconds`` host time in the collective."""
        return {k: dict(v) for k, v in self._stats.items()}

    def _count(self, name, nbytes, staged, t0):
        s = self._stats.setdefault(name, {"calls": 0, "bytes": 0, "staged_bytes": 0,
                                          "largest": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += nbytes
        s["staged_bytes"] += nbytes if staged else 0
        s["largest"] = max(s["largest"], nbytes)
        s["seconds"] += time.perf_counter() - t0

    def _staged(self, x, name):
        return x.is_cuda and name not in DIRECT_CUDA

    def _host(self, x, slot):
        """A pinned host buffer holding ``x`` (one buffer a slot, shape and
        dtype, reused across calls)."""
        key = (slot, tuple(x.shape), x.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(x)
        return buf

    def _reduce(self, x, axis, op, name):
        group, ranks = self._groups[axis]
        if len(ranks) == 1:
            return x.clone()
        t0 = time.perf_counter()
        staged = self._staged(x, name)
        y = self._host(x, "in") if staged else x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=op, group=group)
        out = y.to(x.device, copy=True) if staged else y
        self._count(name, y.numel() * y.element_size(), staged, t0)
        return out

    def psum(self, x, axis):
        """Sum of ``x`` over the ranks of ``axis``, on every one of them."""
        return self._reduce(x, axis, dist.ReduceOp.SUM, "psum")

    def pmax(self, x, axis):
        """Elementwise maximum of ``x`` over the ranks of ``axis``."""
        return self._reduce(x, axis, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, x, axis, dim=0, tiled=True):
        """Every rank's ``x`` in axis order: concatenated along ``dim``
        (``tiled``) or stacked on a new ``dim``."""
        group, ranks = self._groups[axis]
        if len(ranks) == 1:
            return x.clone() if tiled else x.unsqueeze(dim).clone()
        t0 = time.perf_counter()
        staged = self._staged(x, "all_gather")
        y = self._host(x, "in") if staged else x.contiguous()
        parts = [torch.empty_like(y) for _ in ranks]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        nbytes = out.numel() * out.element_size()
        if staged:
            out = out.to(x.device)
        self._count("all_gather", nbytes, staged, t0)
        return out

    def psum_scatter(self, x, axis, scatter_dimension=0, tiled=True):
        """The sum of ``x`` over the ranks of ``axis``, cut into equal
        blocks along ``scatter_dimension``; rank ``k`` of the axis keeps
        block ``k`` (``tiled``; otherwise the dimension, of the axis's
        size, is dropped)."""
        group, ranks = self._groups[axis]
        size = len(ranks)
        if x.shape[scatter_dimension] % size:
            raise ValueError(f"psum_scatter: dim {scatter_dimension} of {tuple(x.shape)} "
                             f"does not split over {size} ranks")
        if size == 1:
            out = x.clone()
        else:
            t0 = time.perf_counter()
            staged = self._staged(x, "psum_scatter")
            y = self._host(x, "in") if staged else x
            chunks = [c.contiguous() for c in torch.chunk(y, size, scatter_dimension)]
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=group)
            if staged:
                out = out.to(x.device)
            self._count("psum_scatter", x.numel() * x.element_size(), staged, t0)
        return out if tiled else out.squeeze(scatter_dimension)

    def ppermute(self, x, axis, pairs):
        """JAX's ``ppermute``: for each ``(src, dst)`` in ``pairs`` (axis
        indices, each at most once a side) rank ``dst`` gets ``src``'s
        ``x``; a rank no pair sends to gets zeros."""
        group, ranks = self._groups[axis]
        me = self.coords[axis]
        to = [dst for src, dst in pairs if src == me]
        frm = [src for src, dst in pairs if dst == me]
        out = torch.zeros_like(x)
        if not to and not frm:
            return out
        t0 = time.perf_counter()
        staged = self._staged(x, "ppermute")
        works = []
        if to:
            y = self._host(x, "send") if staged else x.contiguous()
            works += [dist.isend(y, ranks[dst], group=group) for dst in to]
        if frm:
            r = self._host(out, "recv") if staged else out
            works += [dist.irecv(r, ranks[src], group=group) for src in frm]
        for w in works:
            w.wait()
        if frm and staged:
            out.copy_(r)
        self._count("ppermute", (len(to) + len(frm)) * x.numel() * x.element_size(),
                    staged, t0)
        return out


def make_mesh(n_devices=None, dp=None, axis_names=("dp", "tp"), device=None):
    """The ``(dp, tp)`` :class:`Mesh` of this rank; call it in every rank
    after the process group is up (:func:`spawn` does).

    ``n_devices`` (default: the world size) must equal the world size:
    every rank takes part in a mesh.  ``dp`` defaults to the JAX package's
    rule (:func:`default_dp`); pass ``dp=1`` for pure tensor parallelism.
    ``device``: ``"cpu"`` computes on the CPU; otherwise the rank computes
    on card ``rank % torch.cuda.device_count()``, and with no card this
    raises (it never carries on on the CPU).  When ranks outnumber the
    cards they share them and a warning says so: the counterpart of the
    JAX package's warning for a virtual mesh, functional and not
    representative of speed.
    """
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, the world has {world}")
    dp = default_dp(n) if dp is None else int(dp)
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} must divide n_devices={n}")
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
        cards = torch.cuda.device_count()
        if world > cards and dist.get_rank() == 0:
            warnings.warn(f"make_mesh: {world} ranks share {cards} CUDA device(s); results "
                          "are functional, not performance-representative", stacklevel=2)
        dev = torch.device("cuda", dist.get_rank() % cards)
        torch.cuda.set_device(dev)
    return Mesh(dp, n // dp, axis_names, dev)


@contextlib.contextmanager
def single_rank(device=None, timeout=600):
    """A one-rank process group in this process and its ``(1, 1)`` mesh,
    for the sharded entries on one device without spawning ranks (their
    ``tp = 1`` form); the group is destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("single_rank: a process group is already up in this process")
    tmp = tempfile.mkdtemp(prefix="svdt_mesh_")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            yield make_mesh(1, dp=1, device=device)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _to_host(x):
    """``x`` with every tensor turned into a numpy array (to leave a rank)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, store_path, fn, dp, device, args, timeout, results):
    """One rank: the process group on a file store, the mesh, ``fn(mesh,
    *args)``; reports ``(rank, ok, rank 0's result or a traceback)``."""
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(make_mesh(world, dp=dp, device=device), *args)
        dist.barrier()  # no rank tears the group down while another still uses it
        results.put((rank, True, _to_host(out) if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def prebuild():
    """Build :data:`KERNEL_SOURCES` (one ``nvcc`` each, all together)."""
    from svdsolver_tpu_torch.ops.cuda import _build

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for job in [pool.submit(_build.build, name) for name in KERNEL_SOURCES]:
            job.result()


def spawn(fn, n_devices, dp=None, device=None, args=(), timeout=600):
    """Run ``fn(mesh, *args)`` on ``n_devices`` ranks and return rank 0's
    result, its tensors on the CPU.

    ``fn`` must be importable by name (a module-level function of a module
    that imports what the rank needs); the ranks are new processes
    (``torch.multiprocessing``, spawn start method) on a gloo process group
    over a ``FileStore`` in a temporary directory: no TCP, no network.
    ``dp`` and ``device`` go to :func:`make_mesh`; on the card the kernel
    sources are built here first (:func:`prebuild`).  CPU ranks run one
    thread each.  ``timeout`` (seconds) bounds every collective and the
    whole call: past it the ranks are killed and this raises, so a hang
    fails one call.  A rank that raises or dies fails the call too.
    """
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("spawn: no CUDA device; pass device='cpu' to run on the CPU")
        prebuild()
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="svdt_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_devices, os.path.join(tmp, "store"), fn, dp, device,
                               args, timeout, results))
             for r in range(n_devices)]
    deadline = time.monotonic() + timeout + 60  # the ranks' start-up beside the work
    reported = {}
    try:
        for p in procs:
            p.start()
        while len(reported) < n_devices:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in reported and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} died "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: ranks {sorted(set(range(n_devices)) - set(reported))}"
                                       f" did not finish within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            reported[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return _to_torch(reported[0])

