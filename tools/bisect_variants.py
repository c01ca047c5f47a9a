#!/usr/bin/env python3
"""Two variants of the bisection tree kernel (K2) against the package's, on
one CUDA card.

Run from the repository root: ``python3 tools/bisect_variants.py``.  It
copies ``csrc/bisect.cu`` into ``build/bisect_variants/`` twice, with the
count loop unrolled by 4 (``unroll``) and with the z^2 streams read from
device memory through L1 instead of staged in shared memory (``l1``, also
unrolled; no shared memory, so any block size fits an SM many times),
builds the copies with the package's nvcc flags, and times each in turns
with the package's kernel (CUDA events, medians of 5) on the bidiagonal the
main path's chase gives for a uniform [0, 5) matrix at n = 1024, 3840 and
7680: ``unroll`` at the package's block size for G = 8 and 16, ``l1`` with
blocks of 32, 64 and 128 threads.  Every variant's sigma is held bit-equal
to the one-thread design's.  The shipped kernel is not changed.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from svdsolver_tpu_torch.ops.cuda import _build, bisect, panel_qr  # noqa: E402

OUT = ROOT / "build" / "bisect_variants"
SIZES = (1024, 3840, 7680)


def patch(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"source changed: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def sources():
    base = (_build.CSRC / "bisect.cu").read_text()
    unroll = patch(base, "  int cnt = p < 0.f;\n  for (int s = 0; s < n; ++s) {",
                   "  int cnt = p < 0.f;\n#pragma unroll 4\n  for (int s = 0; s < n; ++s) {")
    l1 = patch(unroll, """  extern __shared__ float zs[];  // z2f then z2r, n floats each
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    zs[i] = z2f[i];
    zs[n + i] = z2r[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;""", "  const int lane = threadIdx.x & 31;")
    l1 = patch(l1, "      below = twisted_count(zs, zs + n, n, lam) - n <= ks;",
               "      below = twisted_count_l1(z2f, z2r, n, lam) - n <= ks;")
    l1 = patch(l1, "// One sweep's bracket update", """__device__ __forceinline__ int twisted_count_l1(const float* __restrict__ zf,
                                                const float* __restrict__ zr,
                                                int n, float lam) {
  float p = -lam;
  float q = -lam;
  int cnt = p < 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    p = -lam - __ldg(zf + s) / p;
    q = -lam - __ldg(zr + s) / q;
    cnt += (p < 0.f) + (q < 0.f);
  }
  const float gamma = p + q + lam;
  return cnt - (p < 0.f) - (q < 0.f) + (gamma < 0.f);
}

// One sweep's bracket update""")
    l1 = patch(l1, """  const size_t smem = 2 * sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      bisect_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total""", "  const size_t smem = 0;\n  const long long total")
    return {"unroll": unroll, "l1": l1}


def build_all():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        src = OUT / f"bisect_{name}.cu"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.svdt_bisect_tree.argtypes = bisect._ENTRIES["svdt_bisect_tree"]
        lib.svdt_bisect_tree.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, d, e, group, threads):
    z2f, z2r, bound, iters, probes = bisect._prepare(d, e, None, 1)
    bound = bound.reshape(1)
    out = torch.empty_like(d)
    err = lib.svdt_bisect_tree(z2f.data_ptr(), z2r.data_ptr(), bound.data_ptr(),
                               out.data_ptr(), d.shape[0], iters, probes, group,
                               bisect.tree_levels(probes, group), threads,
                               torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(err, "bisect variant")
    return out


def main():
    if not torch.cuda.is_available():
        print("bisect_variants: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_device()
    cs.phase_build()
    libs = build_all()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in SIZES:
        b = cs.path_band(n)[1]
        Ab = panel_qr.dense_to_band_fused(cs.uniform_matrix(n), band=b)
        d, e = cs.chase_entry(n, b, record=False)[1](Ab, band=b)
        del Ab
        want = bisect.bisect_svdvals(d, e, _group=1)
        routed = bisect.tree_group(n, 1, sms)
        calls = {f"package G={routed} threads={bisect.tree_block(n, routed, sms)}":
                 lambda: bisect.bisect_svdvals(d, e)}
        for g in (8, 16):
            th = bisect.tree_block(n, g, sms)
            calls[f"unroll G={g} threads={th}"] = (
                lambda g=g, th=th: launch(libs["unroll"], d, e, g, th))
            for th in (32, 64, 128):
                calls[f"l1 G={g} threads={th}"] = (
                    lambda g=g, th=th: launch(libs["l1"], d, e, g, th))
        for label, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            cs.require(torch.equal(got, want), f"{label} at n={n}: bit-equal to one thread")
        times = {}
        for label in list(calls) + list(calls)[::-1]:
            times.setdefault(label, []).append(cs.cuda_ms(calls[label]))
        for label, (t1, t2) in times.items():
            cs.say(f"[times] bisect variant n={n} {label}: {t1:.3f} / {t2:.3f} ms "
                   f"(medians of {cs.REPS}, in turns; sigma bit-equal to one thread)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
