#!/usr/bin/env python3
"""Which gloo operations take CUDA tensors, on this machine's card.

Run from the repository root on a machine with a CUDA card:
``python3 tools/gloo_cuda_probe.py``.  Two ranks share card 0 over gloo
(``svdsolver_tpu_torch.parallel.spawn``): first every collective the mesh
gives CUDA tensors as they are (:func:`probe_gloo_cuda`: all_reduce
sum and max, all_gather, reduce_scatter), then, in a spawn of its own, one
``isend``/``irecv`` pair of CUDA tensors.  A send that gloo does not take can
abort the rank (no exception reaches Python), so that spawn's failure is the
answer.  Prints one line an operation, the card's name and power limit, and
torch's version.
"""

import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, ".")

from svdsolver_tpu_torch.parallel import spawn  # noqa: E402


def probe_gloo_cuda(mesh):
    """Which gloo collectives take CUDA tensors as they are, on this
    rank's card: ``{name: "ok" or the error}``, each tried on a tensor of
    the card over the ``tp`` axis (run it inside every rank of a mesh on
    the card: ``spawn(probe_gloo_cuda, 2)``).  Point-to-point sends are not
    tried: with torch 2.11 gloo passes a CUDA tensor's pointer to the
    socket and the rank aborts, which no ``except`` can report."""
    group, ranks = mesh._groups["tp"]
    x = torch.full((8,), float(mesh.axis_index("tp") + 1), device=mesh.device)
    size = len(ranks)
    tries = {
        "psum": lambda: dist.all_reduce(x.clone(), group=group),
        "pmax": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in ranks], x,
                                              group=group),
        "psum_scatter": lambda: dist.reduce_scatter(
            torch.empty(8 // size, device=x.device), list(torch.chunk(x, size)), group=group),
    }
    found = {}
    for name, call in tries.items():
        try:
            call()
            torch.cuda.synchronize()
            found[name] = "ok"
        except RuntimeError as exc:  # gloo refuses the device type
            found[name] = str(exc).splitlines()[0][:160]
    return found


def send_recv_cuda(mesh):
    """One ring exchange of CUDA tensors by isend/irecv over the tp axis."""
    group, ranks = mesh._groups["tp"]
    me = mesh.axis_index("tp")
    x = torch.full((8,), float(me + 1), device=mesh.device)
    y = torch.empty_like(x)
    works = [dist.isend(x, ranks[(me + 1) % 2], group=group),
             dist.irecv(y, ranks[(me - 1) % 2], group=group)]
    for w in works:
        w.wait()
    torch.cuda.synchronize()
    return float(y[0])


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[gloo] {smi.splitlines()[0]}; torch {torch.__version__}", flush=True)
    for name, result in spawn(probe_gloo_cuda, 2, dp=1, timeout=120).items():
        print(f"[gloo] {name} on CUDA tensors: {result}", flush=True)
    try:
        got = spawn(send_recv_cuda, 2, dp=1, timeout=120)
        print(f"[gloo] isend/irecv on CUDA tensors: ok (received {got})", flush=True)
    except (RuntimeError, TimeoutError) as exc:
        print(f"[gloo] isend/irecv on CUDA tensors: refused ({str(exc).splitlines()[0]})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
