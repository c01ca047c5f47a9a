#!/usr/bin/env python3
"""svd's inverse iteration at scale on one CUDA card: the shift
perturbation counted over whole 64-eps clusters (the JAX package's) against
runs of near-duplicates (the port's, ``vectors._PERTURB_TOL`` = 4).

Run from the repository root: ``python3 tools/tgk_shift_study.py``.  For a
uniform [0, 5) matrix at n = 3840, 5120, 7680 and 10240 it runs the main
path's Stage I, recording chase and bisection on the card, prints the
cluster structure of the spectrum, then ``tgk_vectors`` with the
perturbation runs linked at 64 eps (as the JAX package links them) and at
4 eps sig_max: the orthogonality of U_b and V_b, the residual |B V_b - U_b
S| / sigma_max, and how many cluster CholeskyQR passes failed and kept
their input; and ``svd`` at 7680 and 10240 with its reconstruction,
orthogonality and peak device memory beyond A.
"""

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from svdsolver_tpu_torch import svd  # noqa: E402
from svdsolver_tpu_torch.models import vectors  # noqa: E402
from svdsolver_tpu_torch.ops.cuda import band_chase_wave, bisect, panel_qr  # noqa: E402

SIZES = (3840, 5120, 7680, 10240)
SVD_SIZES = (7680, 10240)


def orth(X):
    X = X.double()
    return float((X.T @ X - torch.eye(X.shape[1], dtype=torch.float64, device=X.device)).abs().max())


def main():
    if not torch.cuda.is_available():
        print("tgk_shift_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    kept = []
    cholesky_qr = vectors._cholesky_qr

    def counted(y, mask, shift):
        out = cholesky_qr(y, mask, shift)
        kept.append(bool(torch.equal(out, y)))
        return out

    vectors._cholesky_qr = counted
    eps = torch.finfo(torch.float32).eps
    for n in SIZES:
        A = cs.uniform_matrix(n)
        Ab = panel_qr.dense_to_band_rec_fused(A, band=128)[0]
        d, e = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=128)[:2]
        del Ab
        sig = bisect.bisect_svdvals(d, e)
        smax = float(sig[0])
        rid, start, end = vectors._cluster_bounds(sig, 64 * eps)
        width = end - start + 1
        cs.say(f"[shift] n={n}: sigma_max {smax:.3f}, 64 eps sigma_max {64 * eps * smax:.4f}, "
               f"{int(torch.unique(rid[width > 1]).numel())} clusters over "
               f"{int((width > 1).sum())} values, widest {int(width.max())}")
        B = torch.diag(d.double()) + torch.diag(e.double(), 1)
        for tol in (64, 4):
            vectors._PERTURB_TOL = tol
            kept.clear()
            Ub, Vb = vectors.tgk_vectors(d, e, sig)
            res = float((B @ Vb.double() - Ub.double() * sig.double()).abs().max()) / smax
            cs.say(f"[shift] n={n} runs linked at {tol} eps sigma_max: |Ub^T Ub - I| "
                   f"{orth(Ub):.3e}, |Vb^T Vb - I| {orth(Vb):.3e}, |B Vb - Ub S| / sigma_max "
                   f"{res:.3e}; CholeskyQR passes that failed: {sum(kept)} of {len(kept)}")
            del Ub, Vb
        vectors._PERTURB_TOL = 4
        del B
        torch.cuda.empty_cache()
        if n in SVD_SIZES:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            U, s, Vh = svd(A)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            Ud, Vd = U.double(), Vh.double()
            recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / float(s[0])
            cs.say(f"[shift] svd n={n}: {seconds:.3f} s (host clock, first call), "
                   f"|U S Vh - A| / sigma_max {recon:.3e}, |U^T U - I| {orth(Ud):.3e}, "
                   f"|Vh Vh^T - I| {orth(Vd.T):.3e}, peak device memory beyond A "
                   f"{peak / 2**30:.3f} GiB ({peak / (4 * n * n):.2f} floats per n^2) | {cs.CARD}")
            del U, s, Vh, Ud, Vd
        del A
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
