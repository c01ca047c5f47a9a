#!/usr/bin/env python3
"""Bring-up check of svdsolver_tpu_torch on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  It

1. reports the card (name, power limit), torch, CUDA and nvcc;
2. builds the thirteen kernel sources of ``svdsolver_tpu_torch/csrc`` (one
   ``nvcc`` each, all started together): the panel QR (one thread-block
   cluster), the sequential chase's L2 kernel (plain and recording
   entries), the bisection, the TGK solve, the wavefront chase (plain,
   recording, and with deferred left applies), the staged chase (the
   sequential chase's TMA design, plain and recording, and the packed
   chase's: the same kernel on a band store), the packed chase's L2
   kernel, the QR and dqds diagonalizers (each loop in one launch), and
   the tiled Stage I's kernels (a half-sweep's pivot-block chain, its apply
   to the other columns, the first design: a slab's t steps in one launch,
   and the wide instance for bands past it);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the panel QR at (b, m, r_off) = (128,
   3840, 0), (128, 3840, 3776) (identity reflectors past m), (64, 1024, 0)
   and (128, 7680, 0) (the large-panel route), two launches bit-identical,
   Q = I - V T V^T orthogonal and Q R = P in float64; the L2 kernel's
   recording (d, e) bit-equal to its plain entry's and its records
   rebuilding the band; the sequential chase's staged TMA design, plain
   and recording, bit-equal to the L2 kernel ((d, e) and all four records)
   at n = 256 and 1024 (b = 64), 3840 (b = 128) and 1024 with five pairs of
   lookahead, its records rebuilding the band; the TGK solve's normalized
   columns within 64 eps; and drives
   the chase variants, every launch count set to 0 before each call and
   read after it: each variant's (d, e), and the recording wavefront's
   (d, e) and records, bit-equal to the sequential kernels' at n = 1024
   (b = 64), 3840 (b = 128) and, on capped CTAs, 2048 (b = 32) (the
   deferred-left entry on its shared-memory tick at all three); each
   variant against its plain version at 1024; each variant's sigma through
   the bisection kernel at 3840 against float64; the wavefront kernel's
   L2 tick (forced at b = 64, taken at b = 160 by all three entries)
   bit-equal to the L2 kernels too; the packed chase (K12) on its route, the TMA
   design on the band store at 1024 (b = 64), 3840 (b = 128) and the
   VMEM_ODD shapes (n not a multiple of 4, odd, and below one box), the
   L2 packed kernel at 96 (b = 6) and launched directly at 1024 and 3840,
   each bit-equal to the L2 kernel, and its peak
   device memory beyond A at most the store, d, e and 1 MB;
4. drives the two main paths, with every launch count set to 0 just before
   each call and read just after: ``svdvals`` on a uniform [0, 5) float32
   matrix at n = 3840, 1000, 7680, 500 and 256 (sigma against float64
   ``torch.linalg.svdvals`` to 1e-5 sigma_max), and ``svd`` at n = 3840
   (uniform), 2048 (Gaussian), 1000 and 256 (uniform): sigma to 1e-5
   sigma_max, reconstruction to 1e-4 sigma_max, orthogonality of U and Vh
   to 1e-4; the counts show the chase each routing predicate picked (the
   sequential chase by the staged TMA design), and at 3840 the routed chase
   is bit-equal to the L2 kernel on the same band;
5. times ``svdvals`` and ``svd`` at 3840 with their stages, each kernel
   beside its plain version and, where one exists, the PyTorch library
   call computing the same function (CUDA events), the panel QR at each
   Stage I panel length of n = 3840 with a split, the sequential and
   wavefront chases in turns at the eleven routing shapes (outputs
   bit-equal, 7680 included), each chase variant in turns with the L2
   kernel at 1024 and 3840 (the deferred-left entry on both its ticks
   beside the plain shared-memory tick, with its own schedule bound), the
   wavefront kernel's shared-memory tick in turns with
   its L2 tick at n = 1024, 3840 and 7680 (plain and recording), one CTA's
   copy rate for a chase window and the shared-memory tick's schedule
   bound, the sequential chase's staged TMA design in turns with the L2
   kernel, plain and recording, at 1024 (b = 64; also K = 3 and the
   largest that fits, 5) and 3840 (b = 128, K = 1) with its schedule
   bound (its copy bytes over that copy rate), the packed chase's TMA
   design in turns with its L2 packed kernel at 1024 and 3840 with the
   same schedule bound, and computes each kernel's bound from its shapes;
6. profiles one ``svdvals`` and one ``svd`` call and one wavefront chase at
   n = 3840: device time by kernel and the card's busy share;
7. holds the redesigned kernels to their first designs: the bisection tree
   (K2, every group G of 4, 8, 16, 32 threads a sigma) bit-equal to the
   one-thread kernel at n = 1, 2, 33, 1024, 3840 and 7680 for probes 1 and
   3, the staged TGK solve (K9/K10) bit-equal to the first design at n =
   512, 1280, 3840 and at 997 and 250 lanes; drives ``svds`` at n = 1000,
   k = 250; times K2 at every G and both solve designs in turns at n =
   1024, 3840, 7680; and runs the scale net: the panel QR at m = 15,360
   and 23,040, ``svdvals`` at 15,360 and 23,040 (against a spectrum known
   by construction), ``svd`` at 7680 with
   its gates and its peak device memory.  Every main-path run shows the
   tree and the staged solve in the launch counts, never a first design;
8. holds the two diagonalizer kernels bit-equal to their plain versions
   run on the card (``check_diag``: n = 2, 5, 16, 64, float32 and float64,
   both memory instances, the QR driver in chunks, the sweep entry on a
   sub-block; dqds's sweep count and shift-type histogram; dqds in float64
   on the stall spectrum within 900 sweeps), drives ``svdvals(A,
   diag="qr")`` and ``svdvals(A, diag="dqds")`` at n = 3840 and 1000 with
   the counts set to 0 before each call (``phase_diag``: Stage I, the
   routed chase and the diagonalizer's kernel launched, no plain
   diagonalizer loop, sigma against float64), times each diagonalizer
   alone, ``diag_reduce_fixed_iter`` at 3840 and ``torch.linalg.svdvals``
   of the dense bidiagonal, and calls each ``linalg`` function once on the
   card against float64 ``torch.linalg`` (``phase_linalg``);
9. drives the ladder rungs and the batch entries (``phase_ladder``,
   ``phase_batch``), every launch count set to 0 just before each call
   and read just after: the first design's slab kernel against its plain
   version at t = 32, 64, 128 on rows of the 3840 and 1024 matrices (a
   diagonal slab, a TS slab, a TS slab shaped as the LQ mirror's; two
   launches bit-identical, within 1e-4 of max |A|) and timed beside its
   plain version, its bound and ``torch.geqrf`` + ``torch.ormqr``;
   ``dense_to_band_tiled`` (a chain and an apply launch a half-sweep)
   ``torch.equal`` to every slab through the first design at 3840/t128,
   1024/t64 and 1024/t32; the chain and the apply kernels against their
   plain versions on a 4-slab half-sweep (QR- and LQ-shaped) at 3840/t128
   and 1024/t64 (within 1e-4 of max |A|, two launches bit-identical), a
   1-slab and a 2-slab half-sweep timed through them beside the chain
   alone (its latency bound), the plain versions, geqrf / ormqr of the
   same slabs and the bounds; ``svdvals(A, method=m)`` for m = base,
   singlecore, multicore at 3840 and 1000 (sigma to 1e-5 sigma_max;
   multicore: 2 n / t - 1 chain and apply launches each, no slab launch,
   the routed chase, K2); ``dense_to_band_tiled`` at 3840/t128 and
   1024/t64 in turns with the first design, beside ``dense_to_band_fused``
   at 3840 and its plain version at 1024;
   ``svd(A, method="singlecore")`` at 3840 and 1000 with svd's gates;
   ``svdvals_batch`` at (B, n) = (64, 256), (16, 1024) (rows bit-equal to
   ``svdvals(As[i])``); ``svd_batch`` at (64, 256) Gaussian and (8, 1024)
   with svd's gates for every matrix; each batch beside B calls and the
   library on the batch; ``dense_to_band_uv_fused`` at 3840 (Ab bit-equal
   to ``dense_to_band_fused(segments=1)``, the factors' reconstruction and
   orthogonality in float64);
10. runs the widths past the narrow instances, which the reference takes
   too (``phase_wide``): K1 past b = 256 against its plain version (Q R = P
   and Q orthogonal at b up to 1536, block = n; entries within 1e-4 where
   m >= 2b) and timed beside ``torch.geqrf``, Stage I on it (fused,
   recording, with factors) against the plain Stage I; the chases' wide
   pair (b >
   256) on the L2 sequential kernel and the wavefront's L2 tick, plain and
   recording, bit-equal to each other, against the plain chase, records
   rebuilding the band, both timed; the tiled Stage I's wide instance
   (``csrc/tiled_wide.cu``) ``torch.equal`` to the first design at t = 160
   and to the two-kernel design at t = 64 and 128, within 1e-4 of the plain
   Stage I at 960/t192 and 1024/t256, its two kernels against their plain
   versions and timed beside ``geqrf`` / ``ormqr``; and ``svdvals`` with
   tpu2 at blocks 384 and 512 (n = 2048), multicore at 192 and 256, block
   = n at 256 and 640, ``svd`` at bands 384 and 512 (n = 2048), the counts
   set to 0 before each call and read after (the path's kernels, the wide
   pair on the routed chase);
11. runs one-sided block Jacobi (``phase_jacobi``, PyTorch ops, no kernel
   of its own): ``svd(A, method="jacobi")`` at n = 1024 and 3840,
   ``svd_jacobi_pre`` at 1024, ``svd_jacobi_batch`` at (8, 256) (each
   matrix's sweeps those of its single solve) and float64 ``svd_jacobi``
   at 512, gated at 30 n eps, with sweeps, launches a round (profiler),
   ms a round and ``torch.linalg.svd`` at the same shape;
12. runs the robustness net (``phase_robust``): each degenerate input of
   the CPU net through the kernel its entry routes it to, every plain
   version forbidden (``ops.cuda.plain_versions``) and the counts read
   around each call: K1 on zero, zero-column and upper-triangular panels
   at (16, 96) and the main path's (128, 1024) (tau = 0, no NaN, the plain
   version's R, V, T, Q orthogonal); the four routed chases on a
   bidiagonal and a zero band ((d, e) exact, the records rebuilding it);
   K2 on zero and split (d, e); the tiled Stage I on zero and diagonal
   matrices; ``svd`` (K9/K10) on the identity and 3 Q; ``svd_batch`` with
   three spectra; ``bidiag_qr`` and ``dqds`` on zero and split (d, e),
   bit-equal to their plain versions; then complex SVD (``phase_complex``:
   complex64 ``svdvals`` and ``svd`` at 1024 and 2048, K2 and K9/K10
   launched, sigma, reconstruction and unitarity against complex128,
   launches a column, ``torch.linalg`` on complex64), the CLI
   (``phase_cli``: ``check 64``, ``check 512 --model tpu2``, ``bench tpu2
   1024 2 1`` through ``cli.main``) and SBR (``phase_sbr``:
   ``band_to_bidiagonal_sbr`` at 1024, band 128 to 32, the routed chase at
   32 launched);
13. runs the sharded entries of ``svdsolver_tpu_torch.parallel`` on 4
   ranks that share the card over gloo (``phase_parallel``): every
   collective on CUDA tensors checked on every rank, ``svdvals_sharded``
   and ``svd_sharded`` at 3840/b128 on tp = 4, the pipelined
   ``svdvals_sharded`` at 1024/b32 on tp = 4 (one superstep kernel launch a
   rank an active superstep), ``svd_jacobi_sharded`` at 1024 on tp = 4,
   ``svdvals_batch_sharded`` at (4, 1024)/b128 on dp = tp = 2, each with
   every plain version forbidden and every rank's counts read; the
   superstep kernel against its plain version on passes the pipelined
   entry gives it on every rank at tp = 4, and bit-equal to the L2 kernel
   at tp = 1; ``dryrun(4)``; each entry's time beside the one-rank
   entry's, with the collectives' share.

Any failure raises and exits non-zero.  The second-to-last line is the
kernel table as JSON, the last ``{"ok": true, "device": {...}}``.  With no
CUDA device, or without the package beside it, it exits non-zero and
prints no result.  Every timing line stands under the card's name and power
limit, printed first.
"""

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL_SIGMA = 1e-5  # max |sigma - sigma_ref| / sigma_max against float64
TOL_RECON = 1e-4  # max |U diag(s) Vh - A| / sigma_max (JAX package's scale tests)
TOL_ORTH = 1e-4  # max |U^T U - I| and max |Vh Vh^T - I|
TOL_REBUILD = 1e-5  # chase records: max |L B R^T - Ab| / max |Ab|, |L^T L - I|
# n = 256 (band 64) has one chase lane, n = 500 (band 64, padded to 512)
# three: the predicates route both to the sequential chase
SLICE_SIZES = (3840, 1000, 7680, 500, 256)
SVD_CASES = ((3840, "uniform"), (2048, "gauss"), (1000, "uniform"), (256, "uniform"))
REPS = 5
SVD_REPS = 3
SOURCES = ("panel_qr", "band_chase", "bisect", "tridiag_solve",
           "band_chase_wave", "band_chase_staged", "band_chase_vmem", "bidiag_qr", "dqds",
           "tiled_slab", "tiled_chain", "tiled_apply", "tiled_wide")
# the variants' entries, counted by the kernel that ran: the packed chase
# runs "band_chase_vmem_tma" (the TMA design on the band store) at every
# band of these checks; "band_chase_vmem", its L2 packed kernel, takes the
# bands the copy engine does not (VMEM_OFF)
VARIANTS = ("band_chase_wave", "band_chase_wave_dl", "band_chase_staged",
            "band_chase_vmem_tma")
SVD_PATH = ("panel_qr", "bisect", "tridiag_solve")  # and the routed chase
# the chase entries count by the kernel that ran: the sequential chase's
# "band_chase_staged(_rec)" the staged TMA design, "band_chase(_rec)" the L2
# kernel; the wavefront's "band_chase_wave(_rec)" the shared-memory tick,
# "_l2" the L2 tick
CHASES = ("band_chase", "band_chase_rec", "band_chase_staged", "band_chase_staged_rec",
          "band_chase_wave", "band_chase_wave_rec", "band_chase_wave_l2",
          "band_chase_wave_rec_l2")
# the two wavefront ticks in turns (n, band): the check band and the widest
# chases of the main paths
TICK_SHAPES = ((1024, 64), (3840, 128), (7680, 128))
# the redesigned K2 and K9/K10 against their first designs: bit-equality at
# these n (1 and 2: the smallest trees), times in turns at DESIGN_TIMES
K2_CHECK = (1, 2, 33, 1024, 3840, 7680)
TGK_CHECK = (512, 1280, 3840)
DESIGN_TIMES = (1024, 3840, 7680)
GROUPS = (1, 4, 8, 16, 32)  # K2's threads a sigma (1: the first design)
SVDS_CASE = (1000, 250)  # (n, k): k lanes not a multiple of 4
# the scale net: svdvals at SCALE_VALS (sigma against a spectrum known by
# construction) and svd at SCALE_SVD with its gates and peak device memory
SCALE_VALS = (15360, 23040)
SCALE_SVD = 7680
WIDE_BAND = (640, 160)  # past the shared-memory tick's 128: the L2 tick
# K1 (b, m, r_off): the first Stage I panel at 3840, an LQ panel whose last
# 64 pivots lie past m, the first panel at 1000 (padded to 1024, b = 64) and
# the first at 7680, 15,360 and 23,040 (the large-panel route; past 12,544
# most of a CTA's columns stay in device memory)
K1_SHAPES = ((128, 3840, 0), (128, 3840, 3776), (64, 1024, 0), (128, 7680, 0),
             (128, 15360, 0), (128, 23040, 0))
TOL_K1 = 1e-4  # |kernel - plain| <= TOL_K1 max|plain|: sums over m in other orders
TOL_Q = 1e-5  # |Q^T Q - I| and |Q R - P|_F / |P|_F, float64 from the kernel's V, T, R
# the chase's routing shapes (n, band): svdvals/svd at 1000, svd at 2048,
# both paths at 3840 (not 7680: ~7 s of the script's time, its route, the
# wavefront at 264 against 1671 ms, stands in PERF.md), the Stage I bands of
# n = 257 ... 512
# (padded to 384: two lanes, and 512: three lanes), a one-lane shape
# (n = 256), two- and three-lane bands of 32 (n = 193 ... 256), and the
# predicates' boundary on the main paths: 640 / 64 (three lanes,
# sequential), 704 / 64 (four lanes) and 1024 / 128 (three lanes, the
# narrowest band-128 input), both wavefront; then, for the bands callers
# of Stage II may pass, the lane counts on either side of the boundary:
# three and four lanes from b = 4 to 48 (b = 32 at both ends of four
# lanes), two lanes at b = 80, 96, 112 and 128, three at 96
ROUTE_SHAPES = ((1024, 64), (2048, 128), (3840, 128), (256, 64),
                (384, 64), (512, 64), (224, 32), (256, 32), (640, 64), (704, 64),
                (1024, 128), (32, 4), (44, 4), (80, 8), (88, 8), (96, 12), (132, 12),
                (160, 16), (176, 16), (192, 24), (264, 24), (320, 32), (352, 32),
                (416, 32), (384, 48), (528, 48), (560, 80), (480, 96), (768, 96),
                (784, 112), (896, 128))
# the sequential chase's two kernels held bit-equal (the staged TMA design
# against the L2 kernel, plain and recording) at (n, band, khops): a
# one-lane band, the check band, the path's band and the deepest lookahead
SEQ_CHECK = ((256, 64, 1), (1024, 64, 1), (3840, 128, 1), (1024, 64, 5))
# the chase variants' shapes: (n, band, khops) of the check against the plain
# versions (phase_kernels' band), of the slice at full width, and (n, band,
# CTAs) of the wavefront kernels with lanes striding over capped CTAs
VAR_CHECK = (1024, 64, 3)
VAR_PATH = (3840, 128, 4)
VAR_CTAS = (2048, 32, 4)
# the packed chase's TMA design at n that are not multiples of 4 (2 mod 4,
# odd) and at n narrower than one box (n < band + 4, every box clipped),
# and a band off the copy engine (the L2 packed kernel): (n, band)
VMEM_ODD = ((1002, 64), (1001, 64), (1003, 128), (130, 128), (37, 4), (5, 4))
VMEM_OFF = (96, 6)
VMEM_SLACK = 2**20  # peak device memory beyond A, store, d and e: at most 1 MB
# the diagonalizers (bidiag_qr, dqds): svdvals(diag=...) at DIAG_SIZES; each
# kernel bit-equal to its plain version run on the card at DIAG_CHECK (the
# plain side costs a launch an operation), float32 and float64, both memory
# instances, the QR driver in chunks of DIAG_CHUNK sweeps, the sweep entry
# on the sub-block DIAG_SUB (n, lo, hi); dqds in float64 on the stall
# spectrum (random n = 120, seed 0) within STALL_SWEEPS sweeps
DIAG_SIZES = (3840, 1000)
DIAG_CHECK = (2, 5, 16, 64)
DIAG_CHUNK = 7
DIAG_SUB = (16, 3, 7)
# sweeps held bit-equal on the main path's (d, e) at each of DIAG_SIZES: enough
# that each window holds a deflation (the QR driver hard-zeroes an e, dqds's
# hi drops), so later sweeps run on a moved block
DIAG_PATH_SWEEPS = {"bidiag_qr": {3840: 8, 1000: 6}, "dqds": {3840: 15, 1000: 15}}
STALL_SWEEPS = 900
TOL_STALL = 1e-10  # max relative error of every sigma of the stall spectrum
# the linalg applications: one call each on the card, gated against
# float64 torch.linalg (phase_linalg has the sizes and the gates)
TOL_LINALG = 1e-3  # pinv's Penrose conditions, eigh's residual, rsvd's sigma (relative)
LINALG = {"pinv": 2048, "lstsq": (4096, 2048, 4), "eigh": 3840, "polar": 2048,
          "rsvd": (3840, 64), "values": 3840, "rank": 3000, "orth": (1024, 700),
          "lowrank": (1000, 250)}
# the ladder rungs and the batch entries (phase_ladder, phase_batch)
LADDER = ("base", "singlecore", "multicore")
LADDER_SIZES = (3840, 1000)
ONE_STAGE_SIZES = (1000,)  # base, singlecore, svd(singlecore): host-paced loops, 3840 cut
SLAB_SIZES = (3840, 1024)  # the slab kernel's checks: rows of these matrices
SLAB_TILES = (32, 64, 128)
TOL_SLAB = 1e-4  # max |kernel - plain| / max |A| after a slab's t steps (float32 sums
# in another order); the tiled band at 1024: |kernel - plain|_F / |A|_F
BATCH_VALS = ((64, 256), (16, 1024))  # (B, n) of svdvals_batch
BATCH_SVD = ((64, 256, "gauss"), (8, 1024, "uniform"))  # (B, n, matrix) of svd_batch
UV_FUSED = 3840  # dense_to_band_uv_fused against dense_to_band_fused(segments=1)
# dense_to_band_tiled alone (n, t): in turns with the first design and beside
# dense_to_band_fused at the first; beside its plain version at the second
TILED_TIMES = ((3840, 128), (1024, 64))
# dense_to_band_tiled (two kernels a half-sweep) torch.equal to every slab
# through the first design's kernel at these (n, t)
SWEEP_CHECK = ((3840, 128), (1024, 64), (1024, 32))
SWEEP_SLABS = 4  # the half-sweep (top = n - 4t) each new kernel is held to its plain version on
# the wide instances (phase_wide): K1 (b, m, r_off) past b = 256 (2 lanes a
# row to 512, 1 past it; T in device memory), an LQ panel whose last pivots
# lie past m, and one past 1024 rows (rows looped over the threads)
WIDE_K1 = ((257, 1024, 0), (384, 2048, 0), (512, 2048, 0), (512, 2048, 1792),
           (1024, 1024, 0), (1536, 1536, 0))
WIDE_K1_TIME = (512, 2048, 0)  # timed beside torch.geqrf of the same panel
WIDE_STAGE1 = (1152, 384)  # the fused Stage I entries against the plain Stage I
# the chases' wide pair (n, band): the L2 sequential kernel and the
# wavefront's L2 tick, plain and recording, bit-equal to each other, each
# against the plain chase; the first has one wavefront lane, the second two
WIDE_CHASE = ((1152, 384), (2048, 512), (1440, 288))
WIDE_CHASE_TIME = (2048, 512)  # the rows' shape: both kernels, medians of 3
# the tiled Stage I's wide instance forced where the first design (t = 160)
# and the two-kernel design (t = 64, 128) run: torch.equal to them
WIDE_TILED_BITS = ((640, 160), (512, 64), (1024, 128))
# the wide instance on its route against the plain Stage I, and its kernels
# on a 2-slab half-sweep against their plain versions and timed
WIDE_TILED = ((960, 192), (1024, 256))
# the entry points at the new widths: (entry, method, n, block)
WIDE_PATHS = (("svdvals", "tpu2", 2048, 512),
              ("svdvals", "multicore", 1024, 192), ("svdvals", "multicore", 1024, 256),
              ("svdvals", "tpu2", 256, 256), ("svdvals", "multicore", 256, 256),
              ("svdvals", "tpu2", 640, 640), ("svdvals", "multicore", 640, 640),
              ("svd", "tpu2", 2048, 512))
# one-sided block Jacobi (phase_jacobi): svd(method="jacobi") at these n,
# svd_jacobi_pre, svd_jacobi_batch (B, n) and svd_jacobi in float64
JACOBI_SVD = (1024,)  # 3840 (a 19 s solve) cut to keep the script near 600 s
JACOBI_PRE = 1024
JACOBI_BATCH = (8, 256)
JACOBI_F64 = 512
TOL_JACOBI = 30  # sigma, reconstruction and orthogonality: at most 30 n eps
# the robustness net: degenerate input through the kernels, no plain version
ROBUST_PANELS = ((16, 96), (128, 1024))  # K1 (b, m): a small panel and a main-path one
ROBUST_BAND = (256, 32)  # (n, b) of the chases on a bidiagonal and a zero band
ROBUST_N = (24, 256)  # K2, svd, the diagonalizers (24 only), the tiled Stage I (256)
ROBUST_TILE = 32
ROBUST_BATCH = 32  # n of svd_batch with three spectra
# complex SVD: Golub-Kahan below complex_svd.GK_MAX columns, the blocked
# reduction from it on
COMPLEX_SIZES = (1024, 2048)
CLI_RUNS = (("check 64", ["check", "64"]),
            ("check 512 tpu2", ["check", "512", "--model", "tpu2"]),
            ("bench tpu2 1024", ["bench", "tpu2", "1024", "2", "1",
                                 "--output", "build/chip_smoke/tpu2_benchmark.csv"]))
SBR_CASE = (1024, 128, 32)  # (n, band, mid) of band_to_bidiagonal_sbr
# the sharded entries (phase_parallel): ranks sharing the card over gloo
PAR_VALS = (3840, 128)  # (n, band) of svdvals_sharded and svd_sharded on tp = 4
PAR_BATCH = (4, 1024, 128)  # (B, n, band) of svdvals_batch_sharded on dp = 2, tp = 2
# (n, band) of the pipelined svdvals_sharded on tp = 4 and of the superstep
# kernel against its plain version on that entry's passes: its exchange
# moves two (U + 2 band) x Np blocks a superstep (~22 GB a rank at 3840)
PAR_PIPE = (1024, 32)
PAR_JACOBI = 1024  # svd_jacobi_sharded on tp = 4
PAR_SEEDS = (21, 22, 16, 23)  # the uniform [0, 5) matrices of PAR_VALS, PAR_PIPE, PAR_JACOBI,
# PAR_BATCH
# the superstep kernel at tp = 1 bit-equal to svdt_band_chase at these
# sweeps a group: the default, 1, 3 (the group of PAR_PIPE on tp = 4), 5
PAR_BITS_LG = (None, 1, 3, 5)
TOL_PAR = 1e-4  # sigma against float64 LAPACK over sigma_max, reconstruction, orthogonality
TOL_SUPERSTEP = 1e-4  # max |kernel - plain| / max |L| after one pass (float32 sums in
# other orders)
# published H100 SXM peaks (NVIDIA's data sheet, 700 W): float32 and
# float64 outside the tensor cores, and HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
DEV = "cuda"


CARD = ""  # the card's name and power limit, as nvidia-smi gives them
TIMED = ("[times]", "[route]", "[profile]", "[slice]", "[svd]", "[ticks]", "[scale]",
         "[diag]", "[linalg]", "[ladder]", "[batch]", "[wide]", "[jacobi]", "[complex]",
         "[cli]", "[sbr]", "[parallel]", "[clock]")


T_START = time.perf_counter()


def clock(label):
    """A line with the seconds since the start, after a phase."""
    say(f"[clock] {label}: {time.perf_counter() - T_START:.1f} s since the start")


def say(*parts):
    """Print a line; a line with a time carries the card and its limit."""
    line = " ".join(str(p) for p in parts)
    if CARD and line.startswith(TIMED):
        line += f" | {CARD}"
    print(line, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps=REPS, warm=True):
    """Median milliseconds of ``fn()`` over ``reps`` runs (after one warm-up
    unless ``warm`` is false), each bracketed by CUDA events."""
    if warm:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def fresh_ms(fn, restore, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each on the state ``restore()`` sets up before its CUDA events (a
    factorization timed on its own output would time other numbers)."""
    times = []
    for rep in range(reps + 1):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:
            times.append(start.elapsed_time(stop))
    return statistics.median(times)


def in_turns(kern, plain):
    """Kernel and plain version timed in turns (plain, kernel, kernel); the
    plain version, a slow launch-bound loop, once."""
    p1 = cuda_ms(plain, 1, warm=False)
    k1 = cuda_ms(kern)
    k2 = cuda_ms(kern)
    return (k1, k2), p1


def uniform_matrix(n, seed=0):
    """The bench's matrix: uniform [0, 5) float32 from ``default_rng(seed)``."""
    a = np.random.default_rng(seed).uniform(0, 5, (n, n)).astype(np.float32)
    return torch.from_numpy(a).to(DEV)


def gauss_matrix(n, seed=0):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return torch.from_numpy(a).to(DEV)


def bidiag_sigma(d, e):
    """Singular values of bidiag(d, e) in float64 on the card (oracle only)."""
    B = torch.diag(d.double()) + torch.diag(e.double(), 1)
    return torch.linalg.svdvals(B)


def _counters():
    from svdsolver_tpu_torch.models import diagonalize
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_vmem,
                                              band_chase_wave, bidiag_qr, bisect, dqds,
                                              panel_qr, tiled_slab, tridiag_solve)

    return {"panel_qr": (panel_qr, "launches"),
            "band_chase": (band_chase, "launches"),
            "band_chase_rec": (band_chase, "launches_rec"),
            "bisect": (bisect, "launches"),
            "bisect_thread": (bisect, "launches_thread"),
            "tridiag_solve": (tridiag_solve, "launches"),
            "tridiag_solve_lane": (tridiag_solve, "launches_lane"),
            "band_chase_wave": (band_chase_wave, "launches"),
            "band_chase_wave_dl": (band_chase_wave, "launches_dl"),
            "band_chase_wave_dl_l2": (band_chase_wave, "launches_dl_l2"),
            "band_chase_wave_rec": (band_chase_wave, "launches_rec"),
            "band_chase_wave_l2": (band_chase_wave, "launches_l2"),
            "band_chase_wave_rec_l2": (band_chase_wave, "launches_rec_l2"),
            "band_chase_staged": (band_chase, "launches_staged"),
            "band_chase_staged_rec": (band_chase, "launches_staged_rec"),
            "band_chase_vmem": (band_chase_vmem, "launches"),
            "band_chase_vmem_tma": (band_chase_vmem, "launches_tma"),
            "bidiag_qr": (bidiag_qr, "launches"),
            "bidiag_qr_sweeps": (bidiag_qr, "launches_sweeps"),
            "dqds": (dqds, "launches"),
            "tiled_slab": (tiled_slab, "launches"),
            "tiled_chain": (tiled_slab, "launches_chain"),
            "tiled_apply": (tiled_slab, "launches_apply"),
            "tiled_wide_chain": (tiled_slab, "launches_wide_chain"),
            "tiled_wide_apply": (tiled_slab, "launches_wide_apply"),
            "band_chase_superstep": (band_chase, "launches_superstep"),
            # not launches: runs of a plain diagonalizer loop, and dqds runs
            # that ended unconverged and took the bisection
            "plain_diag_loops": (diagonalize, "plain_loops"),
            "dqds_safety_nets": (diagonalize, "safety_nets")}


def reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}


# ---- work of each kernel, from its shapes (for its bound) ----

def bound(flops, nbytes, peak=PEAK_FP32):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    (float32's unless ``peak`` is given) and bytes over the HBM rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def work_panel_qr(b, m, r_off):
    """Householder QR of the (b, m) transposed panel with the larft T:
    per column j with L = m - p active entries, its norm and scaling (3L),
    the update of the b-j-1 later rows (4L each), V^T v (2Lj) and T w (j^2).
    Bytes: Pt in; Rt, Vt, Tt out."""
    flops = 0
    for j in range(b):
        L = max(m - (r_off + j), 0)
        flops += 3 * L + 4 * L * (b - j - 1) + 2 * L * j + j * j
    return flops, 4 * (3 * b * m + b * b)


def work_chase(n, b, record):
    """Every pair of the schedule: a reflector from b entries (3b) applied
    to the window rows it reaches (4 per entry), on each side, clipped at n.
    Bytes: the band's n (b + 1) entries in, d and e out, and with
    ``record`` the v and tau of every reflector (the slots the schedule
    fills)."""
    from svdsolver_tpu_torch.ops.chase_schedule import nc_of_static

    def pair(r0, c0, wr, lr0):
        if c0 >= n:
            return 0
        cols = min(b, n - c0)
        rl = r0 + lr0
        return (3 * b + 4 * min(wr, n - r0) * cols
                + 3 * b + 4 * max(min(b, n - rl), 0) * min(2 * b, n - c0))

    flops = pairs = 0
    for i in range(n - 1):
        flops += pair(i, i + 1, b + 1, 1)
        for k in range(nc_of_static(i, n, b)):
            r = i + 1 + k * b
            flops += pair(r, r + b, 2 * b, b)
        pairs += 1 + nc_of_static(i, n, b)
    nbytes = 4 * (n * (b + 1) + 2 * n)
    if record:  # each pair's two reflectors: b entries and tau each
        nbytes += 4 * 2 * pairs * (b + 1)
    return flops, nbytes


def work_bisect(n, iters, probes):
    """Each Sturm count: n steps of two divisions and two subtractions."""
    return 4 * n * n * iters * probes, 4 * 3 * n


def work_tgk(N, k):
    """Per row and lane: forward one division, three products, three
    differences; backward one division, two products, two differences.
    Bytes: rhs in, x out, z and lam."""
    return 12 * N * k, 4 * (2 * N * k + N + k)


# ---- phases ----

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    global CARD
    say("[device]", name)
    say(smi.splitlines()[0])
    CARD = smi.splitlines()[0].strip()
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    from svdsolver_tpu_torch.ops.cuda import _build
    say("[device] nvcc:", run([_build.nvcc_path(), "--version"]).splitlines()[-1])
    return name, smi.splitlines()[0]


def phase_build():
    from svdsolver_tpu_torch.ops.cuda import _build

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = [pool.submit(_build.build, name) for name in SOURCES]
    failed = []
    for name, job in zip(SOURCES, built):
        try:
            path, seconds, log = job.result()
        except RuntimeError as exc:  # report every source that fails
            say(f"[build] {name}: FAILED\n{exc}")
            failed.append(name)
            continue
        say(f"[build] {name}: {seconds:.2f} s -> {path}")
        for line in log.splitlines():  # each kernel instance, then its counts
            if "entry function" in line:
                say(f"[build]   {line.split('entry function')[1].strip()}")
            elif "registers" in line or "spill" in line:
                say(f"[build]   {line.strip()}")
    require(not failed, f"kernel sources failed to build: {failed}")


def check_records(label, Ab, b, rec):
    """The chase records rebuild the band: L B R^T = Ab with L, R built by
    the rank-1 reference back-transform on the identity, both orthogonal."""
    from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors

    d, e, VL, TL, VR, TR = rec
    n = Ab.shape[0]
    eye = torch.eye(n, device=Ab.device)
    L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
    R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
    B = torch.diag(d) + torch.diag(e, 1)
    rebuild = float((L @ B @ R.T - Ab).abs().max() / Ab.abs().max())
    orth_l = float((L.T @ L - eye).abs().max())
    orth_r = float((R.T @ R - eye).abs().max())
    say(f"[kernels] records n={n} b={b} {label}: |L B R^T - Ab| / |Ab| "
        f"{rebuild:.3e}, |L^T L - I| {orth_l:.3e}, |R^T R - I| {orth_r:.3e}")
    require(rebuild <= TOL_REBUILD, f"{label} records rebuild the band at n={n}")
    require(max(orth_l, orth_r) <= TOL_REBUILD, f"{label} L, R orthogonal at n={n}")


def tgk_problem(rng, n):
    """The recipe of the JAX package's tgk-solve parity test, on the card."""
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 5).to(DEV)
    e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32) * 5).to(DEV)
    z = torch.zeros(2 * n - 1, device=DEV)
    z[0::2] = d
    z[1::2] = e
    sig = torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)).contiguous()
    eps = torch.finfo(torch.float32).eps
    pivmin = torch.clamp_min(sig.abs().max() * eps * eps, torch.finfo(torch.float32).tiny)
    big = torch.tensor(torch.finfo(torch.float32).max ** 0.5 / 16.0, device=DEV)
    rhs = torch.from_numpy(rng.normal(size=(2 * n, n)).astype(np.float32)).to(DEV)
    return z, sig, rhs, pivmin, big


def chase_entry(n, b, record):
    """The chase the main path takes for an (n, n) band ``b``: (launch
    counter of the kernel that runs, entry point), by the routing
    predicates and, for the sequential chase, ``band_chase.staged_route``."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    if record:
        if band_chase_wave.wave_chase_accum_preferred(n, b):
            return "band_chase_wave_rec", band_chase_wave.band_to_bidiagonal_wave_accum
        fn = band_chase.band_to_bidiagonal_accum
    else:
        if band_chase_wave.wave_chase_preferred(n, b):
            return "band_chase_wave", band_chase_wave.band_to_bidiagonal_wave
        fn = band_chase.band_to_bidiagonal
    # the band's shape on the meta device: its address 0 is aligned, as the
    # main paths' fresh bands are
    staged = band_chase.staged_route(torch.empty((n, n), device="meta"), b)
    return ("band_chase_staged" if staged else "band_chase") + ("_rec" if record else ""), fn


def path_band(n):
    """(padded n, band) of the main paths' Stage I for an (n, n) input."""
    from svdsolver_tpu_torch.models.svd import _auto_block

    b = _auto_block(n)
    while b >= n and b > 2:
        b //= 2
    return -(-n // b) * b, b


def check_panel_qr(rng, shapes=None):
    """K1 against its plain version at ``shapes`` (K1_SHAPES): outputs within TOL_K1
    (panels with m >= 2b),
    exact zeros and ones of the contract, identity reflectors past m, two
    launches bit-identical, Q = I - V T V^T orthogonal and Q R = P within
    TOL_Q (float64).  Returns the largest |kernel - plain|."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    k1 = 0.0
    for b, m, r_off in shapes or K1_SHAPES:
        plan = panel_qr.cluster_plan(b, m)
        Pt = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).to(DEV)
        panel_qr.launches = 0
        got = panel_qr.panel_qr(Pt, r_off)
        again = panel_qr.panel_qr(Pt, r_off)
        torch.cuda.synchronize()
        require(panel_qr.launches == 2, "panel_qr counts its launches")
        shape = f"b={b} m={m} r_off={r_off}"
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"panel_qr {shape}: two launches bit-identical")
        say(f"[kernels] panel_qr {shape}: one cluster of {plan.ctas} CTAs x "
            f"{plan.width} columns ({plan.smem_cols} in shared memory"
            f"{', the rest in device memory' if plan.spill else ''}), {plan.groups} "
            f"lane(s) a row, T in {'device' if plan.tdev else 'shared'} memory, "
            f"{plan.smem} B shared memory a CTA; two launches bit-identical")
        want = panel_qr.panel_qr_plain(Pt, r_off)
        torch.cuda.synchronize()
        # entry by entry where the panel is at least twice as long as wide
        # (every Stage I panel of b <= 256 at n >= 2b): the reflectors of a
        # panel nearly as long as wide (block = n) end on tails of a few
        # rounding-level entries, whose directions differ between two
        # summation orders; both are held by Q R = P and Q^T Q = I below
        for label, g, w in zip("RVT", got, want) if m >= 2 * b else ():
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            require(err <= TOL_K1 * scale, f"panel_qr {label} {shape}: "
                    f"{err:.3e} > {TOL_K1} * {scale:.3e}")
            k1 = max(k1, err)
            say(f"[kernels] panel_qr {shape} {label}: max_abs_err {err:.3e} "
                f"(scale {scale:.3e})")
        Rt, Vt, Tt = got
        cols = torch.arange(m, device=DEV)[None, :]
        piv = r_off + torch.arange(b, device=DEV)[:, None]
        require(bool((Rt[cols > piv] == 0).all()), f"panel_qr {shape}: R zero past the pivot")
        require(bool((Vt[cols < piv] == 0).all()), f"panel_qr {shape}: V zero before the pivot")
        live = max(0, min(b, m - r_off))
        require(bool((Vt[:live].gather(1, piv[:live]) == 1).all()),
                f"panel_qr {shape}: V one at the pivot")
        if live < b:
            require(bool((Tt[live:] == 0).all()) and bool((Vt[live:] == 0).all()),
                    f"panel_qr {shape}: identity reflectors past m")
            say(f"[kernels] panel_qr {shape}: {b - live} identity reflectors: "
                "tau 0, zero T rows, zero V rows")
        V, T = Vt.double().T, Tt.double().T
        R, P = Rt.double().T, Pt.double().T
        Q = torch.eye(m, dtype=torch.float64, device=DEV) - V @ T @ V.T
        orth = float((Q.T @ Q - torch.eye(m, dtype=torch.float64, device=DEV)).abs().max())
        rebuild = float(torch.linalg.norm(Q @ R - P) / torch.linalg.norm(P))
        say(f"[kernels] panel_qr {shape}: |Q^T Q - I| {orth:.3e}, "
            f"|Q R - P|_F / |P|_F {rebuild:.3e} (tolerance {TOL_Q})")
        require(orth <= TOL_Q and rebuild <= TOL_Q, f"panel_qr {shape}: Q R = P, Q orthogonal")
        del Q, V, T, R, P
    torch.cuda.empty_cache()
    return k1


def check_bisect_tree(rng, d1024, e1024):
    """K2's tree against the one-thread design: sigma bit-equal at every n of
    K2_CHECK (the chase's bidiagonal at 1024, uniform [0, 5) entries
    elsewhere), probes 1 and 3, for the routed group and every other."""
    from svdsolver_tpu_torch.ops.cuda import bisect

    for n in K2_CHECK:
        if n == 1024:
            d, e = d1024, e1024
        else:
            d = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32)).to(DEV)
            e = torch.from_numpy(rng.uniform(0, 5, n - 1).astype(np.float32)).to(DEV)
        for probes in (1, 3):
            want = bisect.bisect_svdvals(d, e, probes=probes, _group=1)
            routed = None
            for group in (None,) + GROUPS[1:]:
                bisect.last_group = None  # n = 1 launches nothing
                got = bisect.bisect_svdvals(d, e, probes=probes, _group=group)
                routed = routed or bisect.last_group
                torch.cuda.synchronize()
                require(torch.equal(got, want), f"bisect tree n={n} probes={probes} "
                        f"G={bisect.last_group}: {int((got != want).sum())} bit-unequal")
            say(f"[kernels] bisect tree n={n} probes={probes}: routed G={routed} and "
                f"G={', '.join(map(str, GROUPS[1:]))} bit-equal to the one-thread design")


def check_sequential():
    """The sequential chase's two kernels at SEQ_CHECK, on Stage I bands of
    uniform matrices: the staged TMA design (the routes of K3, with its
    flags, and of K6) bit-equal to the L2 kernel in (d, e) and all four
    records, each launch counted by the kernel that ran; the TMA design's
    records rebuild the band."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr

    for n, b, K in SEQ_CHECK:
        Ab = panel_qr.dense_to_band_fused(uniform_matrix(n, seed=7), band=b)
        torch.cuda.synchronize()
        reset_counts()
        want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        want_rec = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
        got = band_chase.band_to_bidiagonal(Ab, band=b, mega=K > 1, khops=K)
        # the recording entry runs one pair ahead; K > 1 through its launch
        got_rec = (band_chase.band_to_bidiagonal_accum(Ab, band=b) if K == 1
                   else band_chase._launch(Ab, b, band_chase.staged_khops(b, K), True))
        torch.cuda.synchronize()
        counts = read_counts()
        require(band_chase.last_khops == K, f"the staged TMA design ran K={K} at n={n} b={b}")
        require([counts[k] for k in ("band_chase", "band_chase_rec", "band_chase_staged",
                                     "band_chase_staged_rec")] == [1, 1, 1, 1],
                f"each sequential kernel launched once at n={n} b={b}: {counts}")
        require_bit_equal(f"staged TMA n={n} b={b} K={K}", got, want)
        require_bit_equal(f"L2 recording n={n} b={b}", want_rec[:2], want)
        for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got_rec, want_rec):
            require(torch.equal(g, w), f"staged TMA recording n={n} b={b} K={K}: {name} "
                    "bit-equal to the L2 recording kernel's")
        say(f"[kernels] sequential chase n={n} b={b} K={K}: the staged TMA design's (d, e), "
            "and its recording entry's (d, e) and VL, TL, VR, TR, bit-equal to the L2 "
            "kernel's (whose recording (d, e) are its plain entry's)")
        check_records(f"staged TMA K={K}", Ab, b, got_rec)
        del Ab, want, want_rec, got, got_rec
        torch.cuda.empty_cache()


def phase_kernels(rng):
    """Each kernel against its plain version, same inputs, on the card."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr, tridiag_solve

    errs = {}
    errs["panel_qr"] = check_panel_qr(rng)

    # K3: chase of a Stage I band at n = 1024, b = 64, on the L2 kernel (the
    # staged TMA design is held bit-equal to it below)
    n, b = 1024, 64
    A = uniform_matrix(n, seed=1)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = band_chase.band_to_bidiagonal_l2(Ab, band=b)
    dp, ep = band_chase.band_to_bidiagonal_plain(Ab, band=b)
    torch.cuda.synchronize()
    s_a = torch.linalg.svdvals(A.double())
    s_k, s_p = bidiag_sigma(d, e), bidiag_sigma(dp, ep)
    smax = float(s_a[0])
    for label, s in (("kernel", s_k), ("plain", s_p)):
        err = float((s - s_a).abs().max())
        say(f"[kernels] band_chase n={n} b={b} {label} spectrum vs float64 "
            f"sigma(A): {err / smax:.3e} * sigma_max")
        require(torch.allclose(s, s_a, rtol=2e-5, atol=1e-5 * smax),
                f"band_chase {label} spectrum")
    lead = float(((d.abs() - dp.abs())[:8].abs() / dp.abs()[:8]).max())
    say(f"[kernels] band_chase |d|[:8] rel diff kernel vs plain: {lead:.3e}")
    require(lead <= 1e-4, "band_chase leading |d| vs plain")
    errs["band_chase"] = float((s_k - s_p).abs().max())

    # K6-K8: the recording chase (L2 kernel) on the same band
    rec = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    rec_p = band_chase.band_to_bidiagonal_accum_plain(Ab, band=b)
    require(torch.equal(rec[0], d) and torch.equal(rec[1], e),
            "recording chase (d, e) bit-equal to the chase kernel at n=1024")
    require(torch.equal(rec_p[0], dp) and torch.equal(rec_p[1], ep),
            "plain recording chase (d, e) bit-equal to the plain chase")
    say(f"[kernels] band_chase_rec n={n} b={b}: (d, e) bit-equal to band_chase")
    check_records("kernel", Ab, b, rec)
    check_records("plain", Ab, b, rec_p)
    errs["band_chase_rec"] = float((bidiag_sigma(rec[0], rec[1])
                                    - bidiag_sigma(rec_p[0], rec_p[1])).abs().max())
    # the staged TMA design's recording entry against the same plain version
    rec_t = band_chase.band_to_bidiagonal_accum(Ab, band=b)
    errs["band_chase_staged_rec"] = float((bidiag_sigma(rec_t[0], rec_t[1])
                                           - bidiag_sigma(rec_p[0], rec_p[1])).abs().max())
    del rec, rec_p, rec_t
    check_sequential()

    # K2: bisection at n = 1024 on the chase's bidiagonal, probes 1 and 3:
    # the tree kernel against the plain version, and against the
    # one-thread design at K2_CHECK for every group
    k2 = 0.0
    for probes in (1, 3):
        s = bisect.bisect_svdvals(d, e, probes=probes)
        sp = bisect.bisect_svdvals_plain(d, e, probes=probes)
        torch.cuda.synchronize()
        err = float((s - sp).abs().max())
        top = float(sp.abs().max())
        say(f"[kernels] bisect n={n} probes={probes} (G={bisect.last_group}): "
            f"max_abs_err {err:.3e} (sigma_max {top:.3e}), {int((s != sp).sum())} "
            f"of {n} bit-unequal to the plain version")
        require(torch.allclose(s, sp, rtol=1e-6, atol=1e-7 * top),
                f"bisect probes={probes} vs plain")
        require(torch.allclose(s.double(), s_k, rtol=2e-5, atol=1e-5 * top),
                f"bisect probes={probes} vs float64")
        k2 = max(k2, err)
    errs["bisect"] = k2
    check_bisect_tree(rng, d, e)

    # K9 + K10: the TGK solve, normalized columns within 64 eps of the
    # plain version, bit-equal to the first design (also at svds' lane
    # counts, not multiples of 4)
    eps = torch.finfo(torch.float32).eps
    k9 = 0.0
    for nt, kt in [(nt, None) for nt in TGK_CHECK] + [(SVDS_CASE[0], 997), (SVDS_CASE[0], 250)]:
        z, sig, rhs, pivmin, big = tgk_problem(rng, nt)
        if kt is not None:
            sig, rhs = sig[:kt].contiguous(), rhs[:, :kt].contiguous()
        args = (z, sig, rhs, pivmin, big)
        tridiag_solve.launches = tridiag_solve.launches_lane = 0
        x = tridiag_solve.tgk_solve(*args)
        old = tridiag_solve.tgk_solve(*args, _staged=False)
        torch.cuda.synchronize()
        require((tridiag_solve.launches, tridiag_solve.launches_lane) == (1, 1),
                "tridiag_solve counts each design's launches")
        shape = f"n={nt} ({2 * nt} rows, {sig.shape[0]} lanes)"
        require(torch.equal(x, old), f"tridiag_solve {shape}: staged bit-equal to the first design")
        if kt is not None:
            say(f"[kernels] tridiag_solve {shape}: staged kernel bit-equal to the first design")
            continue
        xp = tridiag_solve.tgk_solve_plain(*args)
        torch.cuda.synchronize()
        unequal = int((x != xp).sum())
        err = float((x / x.norm(dim=0) - xp / xp.norm(dim=0)).abs().max())
        say(f"[kernels] tridiag_solve {shape}: staged kernel bit-equal to the first "
            f"design; normalized max_abs_err {err:.3e} against the plain version "
            f"(64 eps = {64 * eps:.3e}), {unequal} of {x.numel()} entries bit-unequal")
        require(err < 64 * eps, f"tridiag_solve n={nt} vs plain")
        k9 = max(k9, err)
    errs["tridiag_solve"] = k9
    return errs, (Ab, d, e, dp, ep)


def variant_calls(b, khops):
    """The chase variants' entry points at band ``b``: call name -> (launch
    counter it moves, call on a band)."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_vmem, band_chase_wave

    return {
        "wave": ("band_chase_wave",
                 lambda A: band_chase_wave.band_to_bidiagonal_wave(A, band=b)),
        "wavefront=True": ("band_chase_wave",
                           lambda A: band_chase.band_to_bidiagonal(A, band=b, wavefront=True)),
        "wave_dl": ("band_chase_wave_dl",
                    lambda A: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=b)),
        "pipelined=True": ("band_chase_staged",
                           lambda A: band_chase.band_to_bidiagonal(A, band=b, pipelined=True)),
        f"mega=True khops={khops}": (
            "band_chase_staged",
            lambda A: band_chase.band_to_bidiagonal(A, band=b, mega=True, khops=khops)),
        "vmem": ("band_chase_vmem_tma",
                 lambda A: band_chase_vmem.band_to_bidiagonal_vmem(A, band=b)),
    }


def require_bit_equal(label, got, want):
    d, e = got
    require(torch.equal(d, want[0]) and torch.equal(e, want[1]),
            f"{label}: (d, e) bit-equal to the chase kernel's")


def check_wave_rec(label, Ab, b, ctas=None):
    """The recording wavefront chase against the sequential recording chase
    on one band: (d, e) and all four records bit-equal."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    want = band_chase.band_to_bidiagonal_accum_l2(Ab, band=b)
    got = band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b, _ctas=ctas)
    torch.cuda.synchronize()
    if ctas is not None:
        require(band_chase_wave.last_ctas == ctas, "the _ctas cap holds")
    for name, g, w in zip(("d", "e", "VL", "TL", "VR", "TR"), got, want):
        require(torch.equal(g, w), f"wave_accum {label}: {name} bit-equal to band_chase_rec's")
    say(f"[variants] wave_accum {label} on {band_chase_wave.last_ctas} CTAs: (d, e) "
        "and VL, TL, VR, TR bit-equal to band_chase_rec")


def phase_variants(band_state):
    """The chase variants, the third path (K11-K15): every entry point on
    the band of ``phase_kernels`` (VAR_CHECK), on the Stage I kernel's band
    at the slice's full width (VAR_PATH) and, for the wavefront kernels on
    capped CTAs, at VAR_CTAS; each one's (d, e) bit-equal to the chase
    kernel's on the same band.  Returns the launch counts of the full-width
    run, each kernel's max spectrum difference from its plain version and
    the plain versions' times (VAR_CHECK), and the kernels' times."""
    from svdsolver_tpu_torch.models import two_stage
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_vmem,
                                              band_chase_wave, bisect, panel_qr)

    def drive(label, calls, A, want):
        """Each call once, every count set to 0 just before and read just
        after; returns the outputs and the counts."""
        torch.cuda.synchronize()
        reset_counts()
        outs = {name: fn(A) for name, (_, fn) in calls.items()}
        torch.cuda.synchronize()
        counts = read_counts()
        say(f"[variants] {label}: launches {counts}, staged khops "
            f"{band_chase.last_khops}, wave CTAs {band_chase_wave.last_ctas}")
        for name in calls:
            require_bit_equal(f"{name} {label}", outs[name], want)
        for k in VARIANTS:
            require(counts[k] >= 1, f"{k} not launched at {label}")
        require(counts["band_chase"] == 0 and counts["band_chase_rec"] == 0
                and counts["band_chase_vmem"] == 0 and counts["band_chase_wave_dl_l2"] == 0,
                f"a variant took an L2 kernel at {label}")
        say(f"[variants] {label}: {', '.join(calls)}: (d, e) bit-equal to band_chase")
        return outs, counts

    # each kernel against the chase kernel and against its plain version
    # (spectrum, leading |d|), each plain version once
    n1, b1, khops1 = VAR_CHECK
    Ab1, d1, e1, dp1, ep1 = band_state
    outs, _ = drive(f"n={n1} b={b1}", variant_calls(b1, khops1), Ab1, (d1, e1))
    check_wave_rec(f"n={n1} b={b1}", Ab1, b1)
    require(band_chase.last_khops == band_chase.staged_khops(b1, khops1) == khops1,
            f"mega khops={khops1} at b={b1} runs {khops1} pairs a window")
    plains = {
        "band_chase_wave": ("wave", band_chase_wave.band_to_bidiagonal_wave_plain),
        "band_chase_wave_dl": ("wave_dl", band_chase_wave.band_to_bidiagonal_wave_dl_plain),
        "band_chase_vmem_tma": ("vmem", band_chase_vmem.band_to_bidiagonal_vmem_plain),
    }
    errs, plain_ms = {}, {}
    for k, (name, plain) in plains.items():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        dp, ep = plain(Ab1, band=b1)
        stop.record()
        torch.cuda.synchronize()
        plain_ms[k] = start.elapsed_time(stop)
        same = torch.equal(dp, dp1) and torch.equal(ep, ep1)
        say(f"[variants] {k} plain version n={n1} b={b1}: {plain_ms[k]:.3f} ms "
            f"(one run), (d, e) {'bit-equal' if same else 'not bit-equal'} to "
            "the plain chase's")
        plains[k] = (name, (dp, ep))
    plain_ms["band_chase_vmem"] = plain_ms["band_chase_vmem_tma"]  # one plain version
    plain_ms["band_chase_wave_dl_l2"] = plain_ms["band_chase_wave_dl"]
    plains["band_chase_staged"] = ("pipelined=True", (dp1, ep1))  # its plain version
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    rec_p = band_chase_wave.band_to_bidiagonal_wave_accum_plain(Ab1, band=b1)
    stop.record()
    torch.cuda.synchronize()
    plain_ms["band_chase_wave_rec"] = start.elapsed_time(stop)
    rec_k = band_chase_wave.band_to_bidiagonal_wave_accum(Ab1, band=b1)
    seq_p = band_chase.band_to_bidiagonal_accum_plain(Ab1, band=b1)
    same = all(torch.equal(x, y) for x, y in zip(rec_p, seq_p))
    say(f"[variants] band_chase_wave_rec plain version n={n1} b={b1}: "
        f"{plain_ms['band_chase_wave_rec']:.3f} ms (one run), (d, e) and records "
        f"{'bit-equal' if same else 'not bit-equal'} to the plain recording chase's")
    check_records("wave_accum kernel", Ab1, b1, rec_k)
    errs["band_chase_wave_rec"] = float((bidiag_sigma(rec_k[0], rec_k[1])
                                         - bidiag_sigma(rec_p[0], rec_p[1])).abs().max())
    del rec_p, rec_k, seq_p
    # the L2 tick of the three entries (off the path at b <= 128) on the same band
    for k, fn in (("band_chase_wave_l2", band_chase_wave.band_to_bidiagonal_wave),
                  ("band_chase_wave_rec_l2", band_chase_wave.band_to_bidiagonal_wave_accum),
                  ("band_chase_wave_dl_l2", band_chase_wave.band_to_bidiagonal_wave_dl)):
        got = fn(Ab1, band=b1, _tick="l2")
        torch.cuda.synchronize()
        require_bit_equal(f"{k} n={n1} b={b1}", got[:2], (d1, e1))
        errs[k] = float((bidiag_sigma(got[0], got[1]) - bidiag_sigma(dp1, ep1)).abs().max())
        say(f"[variants] {k} n={n1} b={b1}: (d, e) bit-equal to band_chase; spectrum vs "
            f"the plain chase {errs[k]:.3e}")
    s_a = torch.linalg.svdvals(Ab1.double())
    smax = float(s_a[0])
    for k, (name, (dp, ep)) in plains.items():
        d, e = outs[name]
        s_k, s_p = bidiag_sigma(d, e), bidiag_sigma(dp, ep)
        errs[k] = float((s_k - s_p).abs().max())
        lead = float(((d.abs() - dp.abs())[:8].abs() / dp.abs()[:8]).max())
        say(f"[variants] {k} n={n1} b={b1}: spectrum kernel vs plain "
            f"{errs[k]:.3e} (vs float64 sigma(Ab): kernel "
            f"{float((s_k - s_a).abs().max()) / smax:.3e}, plain "
            f"{float((s_p - s_a).abs().max()) / smax:.3e} * sigma_max), "
            f"|d|[:8] rel diff {lead:.3e}")
        require(torch.allclose(s_k, s_p, rtol=2e-5, atol=1e-5 * smax),
                f"{k} spectrum vs plain")
        require(lead <= 1e-4, f"{k} leading |d| vs plain")

    # the wavefront kernels with more lanes than CTAs: lanes stride over them
    n2, b2, ctas = VAR_CTAS
    A2 = panel_qr.dense_to_band_fused(uniform_matrix(n2, seed=2), band=b2)
    want2 = band_chase.band_to_bidiagonal_l2(A2, band=b2)
    for name, fn in (("wave", band_chase_wave.band_to_bidiagonal_wave),
                     ("wave_dl", band_chase_wave.band_to_bidiagonal_wave_dl)):
        got = fn(A2, band=b2, _ctas=ctas)
        torch.cuda.synchronize()
        require(band_chase_wave.last_ctas == ctas, "the _ctas cap holds")
        require(band_chase_wave.last_tick == "smem", f"{name} n={n2} b={b2} takes the "
                "shared-memory tick")
        require_bit_equal(f"{name} n={n2} b={b2} on {ctas} CTAs", got, want2)
        lanes = two_stage.wave_lanes(n2, b2, defer_left=name == "wave_dl") + 1
        say(f"[variants] {name} n={n2} b={b2}: {lanes} lanes (the head's "
            f"included) on {ctas} CTAs, shared-memory tick, (d, e) bit-equal to band_chase")
    check_wave_rec(f"n={n2} b={b2}", A2, b2, ctas=ctas)
    del A2

    # past b = 128 the three wavefront entries take the L2 tick
    nw, bwide = WIDE_BAND
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(nw, nw)).astype(np.float32)).to(DEV)
    Aw = torch.triu(torch.tril(g, bwide)).contiguous()
    torch.cuda.synchronize()
    reset_counts()
    got = band_chase_wave.band_to_bidiagonal_wave(Aw, band=bwide)
    got_rec = band_chase_wave.band_to_bidiagonal_wave_accum(Aw, band=bwide)
    got_dl = band_chase_wave.band_to_bidiagonal_wave_dl(Aw, band=bwide)
    torch.cuda.synchronize()
    wide = read_counts()
    require(wide["band_chase_wave_l2"] == 1 and wide["band_chase_wave_rec_l2"] == 1
            and wide["band_chase_wave_dl_l2"] == 1 and wide["band_chase_wave"] == 0
            and wide["band_chase_wave_rec"] == 0 and wide["band_chase_wave_dl"] == 0,
            f"b={bwide} takes the L2 tick: {wide}")
    want_w = band_chase.band_to_bidiagonal_l2(Aw, band=bwide)
    require_bit_equal(f"wave n={nw} b={bwide} (L2 tick)", got, want_w)
    require_bit_equal(f"wave_dl n={nw} b={bwide} (L2 tick)", got_dl, want_w)
    require(all(torch.equal(x, y) for x, y in
                zip(got_rec, band_chase.band_to_bidiagonal_accum_l2(Aw, band=bwide))),
            f"wave_accum n={nw} b={bwide} (L2 tick) bit-equal to band_chase_rec")
    say(f"[variants] n={nw} b={bwide}: the three wavefront entries took the L2 tick "
        f"(launches {wide}); (d, e) and records bit-equal to the sequential kernels")
    del Aw, g, got, got_rec, got_dl

    # the slice at full width: every entry point once, on the Stage I band
    n, b, khops = VAR_PATH
    A = uniform_matrix(n)
    Ab3 = panel_qr.dense_to_band_fused(A, band=b)
    want3 = band_chase.band_to_bidiagonal_l2(Ab3, band=b)
    outs3, counts = drive(f"n={n} b={b}", variant_calls(b, khops), Ab3, want3)
    check_wave_rec(f"n={n} b={b}", Ab3, b)
    require(band_chase.last_khops == band_chase.staged_khops(b, khops),
            f"mega khops={khops} at b={b} runs the largest window that fits")
    errs["band_chase_vmem"], off_counts = check_vmem(Ab1, b1, plains["band_chase_vmem_tma"][1],
                                                     Ab3, b, want3)
    s_ref = torch.linalg.svdvals(A.double())
    for name, (d, e) in outs3.items():
        s = bisect.bisect_svdvals(d, e)
        err = float((s.double() - s_ref).abs().max() / s_ref[0])
        say(f"[variants] {name} n={n}: bisection sigma vs float64 sigma(A) "
            f"{err:.3e} * sigma_max")
        require(err <= TOL_SIGMA, f"{name} sigma at n={n}")
    del outs3, s_ref

    # times: every variant in turns with the chase kernel (A B C .. C B A),
    # at full width and on the check band (the kernel table's shape)
    timed = {
        "band_chase": lambda A, b: band_chase.band_to_bidiagonal_l2(A, band=b),
        "band_chase_wave": lambda A, b: band_chase_wave.band_to_bidiagonal_wave(A, band=b),
        "band_chase_wave_l2": lambda A, b: band_chase_wave.band_to_bidiagonal_wave(
            A, band=b, _tick="l2"),
        "band_chase_wave_dl": lambda A, b: band_chase_wave.band_to_bidiagonal_wave_dl(A, band=b),
        "band_chase_wave_dl_l2": lambda A, b: band_chase_wave.band_to_bidiagonal_wave_dl(
            A, band=b, _tick="l2"),
        "band_chase_staged": lambda A, b: band_chase.band_to_bidiagonal(A, band=b, pipelined=True),
        "band_chase_vmem_tma": lambda A, b: band_chase_vmem.band_to_bidiagonal_vmem(A, band=b),
        "band_chase_vmem": lambda A, b: band_chase_vmem._launch(A, b, "packed"),
    }
    times = {}
    # one run a turn at full width: the kernels vary by under 0.1 % between
    # runs there, and three a turn took ~26 s of the script's time
    for label, Ab_, n_, b_, reps in (("path", Ab3, n, b, 1), ("check", Ab1, n1, b1, SVD_REPS)):
        got = {}
        for k in list(timed) + list(timed)[::-1]:
            got.setdefault(k, []).append(cuda_ms(lambda: timed[k](Ab_, b_), reps))
        for k, (t1, t2) in got.items():
            times[k, label] = min(t1, t2)
            say(f"[times] {k} n={n_} b={b_}: {t1:.3f} / {t2:.3f} ms (medians "
                f"of {reps}, in turns)")
    phase_profile(f"wave chase n={n}",
                  lambda: band_chase_wave.band_to_bidiagonal_wave(Ab3, band=b))
    del Ab3, A
    torch.cuda.empty_cache()
    return counts, errs, plain_ms, times, off_counts, wide


def check_vmem(Ab1, b1, plain1, Ab3, b3, want3):
    """The packed chase (K12) beyond the variants' drives: the TMA design
    on the band store at each VMEM_ODD shape and the L2 packed kernel on
    its route (VMEM_OFF), counts set to 0 just before and read just after
    each, and the L2 packed kernel launched directly at the check band and
    the path's (``want3``: the L2 kernel's (d, e) there), each bit-equal to
    the L2 kernel; the peak device
    memory of a call beyond its input at the check band and the path's
    (the store, d, e and at most VMEM_SLACK).  Returns the L2 packed
    kernel's spectrum difference from the plain version at the check band
    and the launch counts of its route's run."""
    from svdsolver_tpu_torch.ops.chase_schedule import store_floats
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_vmem

    def band(n, b, seed):
        g = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
        return torch.triu(torch.tril(torch.from_numpy(g).to(DEV), b)).contiguous()

    for (n, b), kernel in ([(nb, "band_chase_vmem_tma") for nb in VMEM_ODD]
                           + [(VMEM_OFF, "band_chase_vmem")]):
        Ab = band(n, b, seed=4)
        want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        torch.cuda.synchronize()
        reset_counts()
        got = band_chase_vmem.band_to_bidiagonal_vmem(Ab, band=b)
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts[kernel] == 1 and sum(counts.values()) == 1,
                f"the packed chase at n={n} b={b} runs {kernel} alone: {counts}")
        require_bit_equal(f"vmem n={n} b={b} ({kernel})", got, want)
        say(f"[variants] vmem n={n} b={b}: route {band_chase_vmem.vmem_route(Ab, b)}, "
            f"launches {counts}; (d, e) bit-equal to band_chase")
        if kernel == "band_chase_vmem":
            off = counts
    for Ab, b, want in ((Ab3, b3, want3),
                        (Ab1, b1, band_chase.band_to_bidiagonal_l2(Ab1, band=b1))):
        got = band_chase_vmem._launch(Ab, b, "packed")
        require_bit_equal(f"vmem n={Ab.shape[0]} b={b} (L2 packed kernel, launched directly)",
                          got, want)
        say(f"[variants] vmem n={Ab.shape[0]} b={b}: the L2 packed kernel, launched directly, "
            "bit-equal to band_chase")
    err = float((bidiag_sigma(*got) - bidiag_sigma(*plain1)).abs().max())
    say(f"[variants] vmem n={Ab1.shape[0]} b={b1}: the L2 packed kernel's spectrum vs the "
        f"plain version {err:.3e}")
    for Ab, b in ((Ab1, b1), (Ab3, b3)):
        n = Ab.shape[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        band_chase_vmem.band_to_bidiagonal_vmem(Ab, band=b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        store = 4 * store_floats(n, b)
        say(f"[variants] vmem n={n} b={b}: peak device memory beyond A {peak} bytes "
            f"(store {store}, d and e {4 * (2 * n - 1)}, slack {VMEM_SLACK})")
        require(peak <= store + 4 * (2 * n - 1) + VMEM_SLACK,
                f"the packed chase at n={n} b={b} holds no more than its store, d and e")
    return err, off


def require_route(label, counts, record):
    """The run launched the path's kernels and, of the chase entries, only
    the one the routing predicates pick (``record``: the recording ones)."""
    n, b = label
    chase, _ = chase_entry(n, b, record)
    for k in CHASES:
        if k == chase:
            require(counts[k] == 1, f"{k} launched once at n={n} b={b}")
        else:
            require(counts[k] == 0, f"{k} launched at n={n} b={b}, the route is {chase}")
    for k in VARIANTS + ("band_chase_vmem", "band_chase_wave_dl_l2"):
        if k != chase:
            require(counts[k] == 0, f"{k} launched at n={n} b={b}")
    return chase


def require_routed_bit_equal(label, A, record):
    """At ``A``'s size: the routed chase and the sequential one on the same
    Stage I band give the same (d, e) (and records) bit for bit."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr

    n, b = path_band(A.shape[0])
    chase, fn = chase_entry(n, b, record)
    seq = band_chase.band_to_bidiagonal_accum_l2 if record else band_chase.band_to_bidiagonal_l2
    Ab = (panel_qr.dense_to_band_rec_fused(A, band=b)[0] if record
          else panel_qr.dense_to_band_fused(A, band=b))
    got, want = fn(Ab, band=b), seq(Ab, band=b)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{label}: the routed {chase} bit-equal to the sequential kernel")
    say(f"{label}: the routed {chase} gives {'(d, e) and records' if record else '(d, e)'} "
        f"bit-equal to the L2 kernel's {'band_chase_rec' if record else 'band_chase'} on the "
        "same band")


def phase_slice():
    """svdvals, the first main path, at each size; returns the launch counts
    at each n."""
    from svdsolver_tpu_torch import svdvals
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by_n = {}
    for n in SLICE_SIZES:
        A = uniform_matrix(n)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = svdvals(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        say(f"[slice] n={n}: svdvals {seconds:.3f} s (host clock, first call "
            f"at this size) launches {counts}")
        for k in ("panel_qr", "bisect"):
            require(counts[k] > 0, f"kernel {k} not launched by svdvals at n={n}")
        require(counts["bisect_thread"] == 0, f"svdvals at n={n} took the one-thread K2")
        say(f"[slice] n={n}: K2 took the tree, G={bisect.last_group}")
        chase = require_route(path_band(n), counts, record=False)
        say(f"[slice] n={n}: the chase took {chase} (wave_chase_preferred"
            f"{path_band(n)} = {chase == 'band_chase_wave'})")
        require(s.shape == (n,) and bool(torch.isfinite(s).all()),
                f"svdvals output at n={n}")
        ref = torch.linalg.svdvals(A.double())
        err = float((s.double() - ref).abs().max() / ref[0])
        say(f"[slice] n={n}: max|sigma - sigma_ref| / sigma_max = {err:.3e}")
        require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n}")
        if n == 3840:
            require_routed_bit_equal(f"[slice] n={n}", A, record=False)
        counts_by_n[n] = counts
        del A, s, ref
        torch.cuda.empty_cache()
    return counts_by_n


def phase_svd():
    """svd, the second main path, at each case; returns the launch counts
    at each n."""
    from svdsolver_tpu_torch import svd
    from svdsolver_tpu_torch.models import vectors
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by_n = {}
    eps = torch.finfo(torch.float32).eps
    for n, kind in SVD_CASES:
        A = uniform_matrix(n) if kind == "uniform" else gauss_matrix(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        U, s, Vh = svd(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        say(f"[svd] n={n} {kind}: svd {seconds:.3f} s (host clock, first call "
            f"at this size) launches {counts}")
        for k in SVD_PATH:
            require(counts[k] > 0, f"kernel {k} not launched by svd at n={n}")
        require(counts["tridiag_solve"] == 2, "two TGK solves (iters = 2)")
        require(counts["bisect_thread"] == 0 and counts["tridiag_solve_lane"] == 0,
                f"svd at n={n} took a first design of K2 or K9/K10")
        say(f"[svd] n={n}: K2 took the tree (G={bisect.last_group}), K9/K10 the "
            f"staged solve; peak device memory {peak / 2**30:.3f} GiB "
            f"({peak / (4 * n * n):.2f} floats per n^2)")
        chase = require_route(path_band(n), counts, record=True)
        say(f"[svd] n={n}: the chase took {chase} (wave_chase_accum_preferred"
            f"{path_band(n)} = {chase == 'band_chase_wave_rec'})")
        require(U.shape == (n, n) and s.shape == (n,) and Vh.shape == (n, n),
                f"svd shapes at n={n}")
        require(all(bool(torch.isfinite(t).all()) for t in (U, s, Vh)),
                f"svd output finite at n={n}")
        ref = torch.linalg.svdvals(A.double())
        smax = float(ref[0])
        sig_err = float((s.double() - ref).abs().max()) / smax
        Ud, Vd = U.double(), Vh.double()
        recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / smax
        eye = torch.eye(n, dtype=torch.float64, device=DEV)
        orth_u = float((Ud.T @ Ud - eye).abs().max())
        orth_v = float((Vd @ Vd.T - eye).abs().max())
        rid, start, end = vectors._cluster_bounds(s, 64 * eps)
        width = end - start + 1
        clustered = width > 1
        n_clusters = int(torch.unique(rid[clustered]).numel())
        widest = int(width.max())
        dense = bool(vectors._has_wide_cluster(s, 64 * eps))
        say(f"[svd] n={n} {kind}: sigma err {sig_err:.3e}, |U S Vh - A| "
            f"{recon:.3e} (both / sigma_max), |U^T U - I| {orth_u:.3e}, "
            f"|Vh Vh^T - I| {orth_v:.3e}")
        say(f"[svd] n={n} {kind}: {n_clusters} clusters over "
            f"{int(clustered.sum())} values, widest {widest}; dense cluster "
            f"orthogonalization {'taken' if dense else 'not taken'}")
        require(sig_err <= TOL_SIGMA, f"svd sigma error at n={n}")
        require(recon <= TOL_RECON, f"svd reconstruction at n={n}")
        require(max(orth_u, orth_v) <= TOL_ORTH, f"svd orthogonality at n={n}")
        del U, s, Vh, Ud, Vd, ref, eye
        if n == 3840:
            require_routed_bit_equal(f"[svd] n={n}", A, record=True)
        counts_by_n[n] = counts
        del A
        torch.cuda.empty_cache()
    return counts_by_n


def phase_svds():
    """svds, the partial path, at SVDS_CASE (k lanes not a multiple of 4):
    the top-k sigma against float64, |A Vh^T - U diag(s)| / sigma_max and
    the orthogonality of U and Vh; returns the launch counts."""
    from svdsolver_tpu_torch import svds

    n, k = SVDS_CASE
    A = uniform_matrix(n, seed=4)
    torch.cuda.synchronize()
    reset_counts()
    U, s, Vh = svds(A, k)
    torch.cuda.synchronize()
    counts = read_counts()
    say(f"[svd] svds n={n} k={k}: launches {counts}")
    for k_ in SVD_PATH:
        require(counts[k_] > 0, f"kernel {k_} not launched by svds")
    require(counts["tridiag_solve"] == 2 and counts["tridiag_solve_lane"] == 0
            and counts["bisect_thread"] == 0, "svds took the staged solve and the tree")
    require(U.shape == (n, k) and s.shape == (k,) and Vh.shape == (k, n), "svds shapes")
    ref = torch.linalg.svdvals(A.double())
    smax = float(ref[0])
    sig_err = float((s.double() - ref[:k]).abs().max()) / smax
    Ud, Vd = U.double(), Vh.double()
    resid = float((A.double() @ Vd.T - Ud * s.double()).abs().max()) / smax
    eye = torch.eye(k, dtype=torch.float64, device=DEV)
    orth = max(float((Ud.T @ Ud - eye).abs().max()), float((Vd @ Vd.T - eye).abs().max()))
    say(f"[svd] svds n={n} k={k}: sigma err {sig_err:.3e}, |A Vh^T - U S| {resid:.3e} "
        f"(both / sigma_max), orthogonality {orth:.3e}")
    require(sig_err <= TOL_SIGMA and resid <= TOL_RECON and orth <= TOL_ORTH,
            f"svds gates at n={n} k={k}")
    return counts


def known_spectrum_matrix(n, seed=5, decades=4.0):
    """A float32 (n, n) matrix Q1 diag(sigma) Q2^T with Q1, Q2 the float64
    QR factors of Gaussian matrices drawn on the card from ``seed`` and
    sigma = 100 * 10**(-decades i / (n - 1)) (100 down to 0.01 by default):
    its singular values are known by construction, to the float32 rounding
    of A (an oracle where float64 svdvals would take minutes)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    q1, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=DEV))
    sig = 100.0 * 10.0 ** (-decades * torch.arange(n, dtype=torch.float64, device=DEV) / (n - 1))
    q1 *= sig
    q2, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64, device=DEV))
    A = (q1 @ q2.T).float()
    del q1, q2
    torch.cuda.empty_cache()
    return A, sig


def phase_scale():
    """The scale net: svdvals at SCALE_VALS (past the first Stage I panel's
    old limit of 12,544) and svd at SCALE_SVD, each with the counts set to 0
    just before and read just after; returns the counts, the host-clock
    seconds of each call and the svd's peak device memory."""
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.ops.cuda import bisect

    counts_by, seconds_by = {}, {}
    for n in SCALE_VALS:
        # the spectrum known by construction at both sizes: float64 svdvals
        # took 66 s at 15,360, a tenth of the script; the card test
        # test_svdvals_at_scale keeps that oracle there (marked slow)
        t0 = time.perf_counter()
        A, ref = known_spectrum_matrix(n)
        torch.cuda.synchronize()
        oracle = (f"sigma known by construction, Q1 diag(sigma) Q2^T "
                  f"({time.perf_counter() - t0:.1f} s to build)")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        s = svdvals(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        say(f"[scale] svdvals n={n}: {seconds:.3f} s (host clock, first call at this "
            f"size) launches {counts}")
        for k in ("panel_qr", "bisect"):
            require(counts[k] > 0, f"kernel {k} not launched by svdvals at n={n}")
        require(counts["bisect_thread"] == 0, f"svdvals at n={n} took the one-thread K2")
        require_route(path_band(n), counts, record=False)
        require(s.shape == (n,) and bool(torch.isfinite(s).all()), f"svdvals output at n={n}")
        err = float((s.double() - ref).abs().max() / ref[0])
        say(f"[scale] svdvals n={n}: max|sigma - sigma_ref| / sigma_max = {err:.3e} "
            f"(oracle: {oracle}; K2 G={bisect.last_group})")
        require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n}")
        seconds_by[n] = seconds  # one call: a second one ran within 1 % of it
        counts_by[n] = counts
        del A, s, ref
        torch.cuda.empty_cache()

    n = SCALE_SVD
    A = uniform_matrix(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    U, s, Vh = svd(A)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    say(f"[scale] svd n={n}: {seconds:.3f} s (host clock, first call at this size) "
        f"launches {counts}; peak device memory {peak / 2**30:.3f} GiB beyond A "
        f"({peak / (4 * n * n):.2f} floats per n^2)")
    for k in SVD_PATH:
        require(counts[k] > 0, f"kernel {k} not launched by svd at n={n}")
    require(counts["tridiag_solve"] == 2 and counts["tridiag_solve_lane"] == 0
            and counts["bisect_thread"] == 0, f"svd at n={n} took the new designs")
    require_route(path_band(n), counts, record=True)
    require(all(bool(torch.isfinite(t).all()) for t in (U, s, Vh)), f"svd finite at n={n}")
    ref = torch.linalg.svdvals(A.double())
    smax = float(ref[0])
    sig_err = float((s.double() - ref).abs().max()) / smax
    Ud, Vd = U.double(), Vh.double()
    recon = float(((Ud * s.double()) @ Vd - A.double()).abs().max()) / smax
    eye = torch.eye(n, dtype=torch.float64, device=DEV)
    orth_u = float((Ud.T @ Ud - eye).abs().max())
    orth_v = float((Vd @ Vd.T - eye).abs().max())
    say(f"[scale] svd n={n}: sigma err {sig_err:.3e}, |U S Vh - A| {recon:.3e} (both / "
        f"sigma_max), |U^T U - I| {orth_u:.3e}, |Vh Vh^T - I| {orth_v:.3e}")
    require(sig_err <= TOL_SIGMA, f"svd sigma error at n={n}")
    require(recon <= TOL_RECON, f"svd reconstruction at n={n}")
    require(max(orth_u, orth_v) <= TOL_ORTH, f"svd orthogonality at n={n}")
    counts_by["svd", n] = counts
    seconds_by["svd", n] = seconds
    del U, s, Vh, Ud, Vd, ref, eye, A
    torch.cuda.empty_cache()
    return counts_by, seconds_by, peak


def phase_design_times():
    """K2 for each group of GROUPS (1: the one-thread design) and K9/K10's
    staged and first designs, in turns (A B .. B A), at DESIGN_TIMES on the
    main path's inputs: K2 on the routed chase's bidiagonal of the uniform
    matrix, the solve on the tgk-solve parity recipe (2n rows, n lanes)."""
    from svdsolver_tpu_torch.ops.cuda import bisect, panel_qr, tridiag_solve

    rng = np.random.default_rng(6)
    k2, tgk = {}, {}
    for n in DESIGN_TIMES:
        b = path_band(n)[1]
        Ab = panel_qr.dense_to_band_fused(uniform_matrix(n), band=b)
        d, e = chase_entry(n, b, record=False)[1](Ab, band=b)
        del Ab
        got = {}
        for g in GROUPS + GROUPS[::-1]:
            got.setdefault(g, []).append(
                cuda_ms(lambda: bisect.bisect_svdvals(d, e, _group=g)))
        bisect.bisect_svdvals(d, e)
        routed = bisect.last_group
        for g, (t1, t2) in got.items():
            k2[n, g] = min(t1, t2)
            say(f"[times] bisect n={n} G={g}{' (one thread: first design)' if g == 1 else ''}"
                f"{' (routed)' if g == routed else ''}: {t1:.3f} / {t2:.3f} ms "
                f"(medians of {REPS}, in turns)")
        args = tgk_problem(rng, n)
        require(torch.equal(tridiag_solve.tgk_solve(*args), tridiag_solve.tgk_solve(
            *args, _staged=False)), f"tridiag_solve n={n}: staged bit-equal to the first design")
        l1 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args, _staged=False))
        s1 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args))
        s2 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args))
        l2 = cuda_ms(lambda: tridiag_solve.tgk_solve(*args, _staged=False))
        tgk[n] = (min(s1, s2), min(l1, l2))
        say(f"[times] tridiag_solve n={n} ({2 * n} rows, {n} lanes): staged {s1:.3f} / "
            f"{s2:.3f} ms, first design {l1:.3f} / {l2:.3f} ms (medians of {REPS}, in turns; "
            "x bit-equal)")
        del args, d, e
        torch.cuda.empty_cache()
    return k2, tgk


def stage1_widths(n, b):
    """The panel lengths m of Stage I's segments at n (one per segment)."""
    from svdsolver_tpu_torch.models.two_stage import segment_bounds
    from svdsolver_tpu_torch.ops.cuda.panel_qr import _auto_segments

    bounds = segment_bounds(n // b, _auto_segments(n, b))
    return [n - k * b for k in bounds[:-1]]


def phase_k1_times():
    """K1 at (128, 3840) and each Stage I panel length at 3840, in turns with
    its plain version, beside torch.geqrf; the cluster sizes 8 and 16 at
    3840; and a split: the load and store alone (r_off = m: no column), a
    zero panel (every column an identity reflector: one cluster barrier and
    the reflector each) and the full panel."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    rng = np.random.default_rng(2)
    out = {}
    for m in stage1_widths(3840, 128):
        Pt = torch.from_numpy(rng.normal(size=(128, m)).astype(np.float32)).to(DEV)
        (k1, k2), p1 = in_turns(lambda: panel_qr.panel_qr(Pt, 0),
                                lambda: panel_qr.panel_qr_plain(Pt, 0))
        panel = Pt.T.contiguous()
        lib = cuda_ms(lambda: torch.geqrf(panel))
        plan = panel_qr.cluster_plan(128, m)
        out[m] = (min(k1, k2), p1, lib)
        say(f"[times] panel_qr b=128 m={m} ({plan.ctas} CTAs): kernel {k1:.3f} / "
            f"{k2:.3f} ms (medians of {REPS}), plain {p1:.3f} ms (one run), "
            f"torch.geqrf ({m}, 128) {lib:.3f} ms")
        if m == 3840:
            for C in (8, 16, 8):
                t = cuda_ms(lambda: panel_qr.panel_qr(Pt, 0, _cluster=C))
                say(f"[times] panel_qr b=128 m=3840 on a cluster of {C}: {t:.3f} ms")
            zero = torch.zeros_like(Pt)
            split = {"load and store only (r_off = m)": lambda: panel_qr.panel_qr(Pt, m),
                     "zero panel (identity reflectors)": lambda: panel_qr.panel_qr(zero, 0),
                     "full panel": lambda: panel_qr.panel_qr(Pt, 0)}
            for label, fn in split.items():
                say(f"[times] panel_qr split b=128 m=3840 {label}: {cuda_ms(fn):.3f} ms")
    for m in SCALE_VALS:  # the first Stage I panel past the old limit
        Pt = torch.from_numpy(rng.normal(size=(128, m)).astype(np.float32)).to(DEV)
        (k1, k2), p1 = in_turns(lambda: panel_qr.panel_qr(Pt, 0),
                                lambda: panel_qr.panel_qr_plain(Pt, 0))
        panel = Pt.T.contiguous()
        lib = cuda_ms(lambda: torch.geqrf(panel))
        plan = panel_qr.cluster_plan(128, m)
        out[m] = (min(k1, k2), p1, lib)
        say(f"[times] panel_qr b=128 m={m} ({plan.ctas} CTAs, {plan.smem_cols} of "
            f"{plan.width} columns a CTA in shared memory): kernel {k1:.3f} / {k2:.3f} "
            f"ms (medians of {REPS}), plain {p1:.3f} ms (one run), torch.geqrf "
            f"({m}, 128) {lib:.3f} ms")
        del Pt, panel
    return out


def phase_route_times():
    """The predicates' evidence: at each ROUTE_SHAPES band (Stage I's), the
    sequential chase (the kernel its route picks: the staged TMA design at
    every such band) and the wavefront chase in turns (seq, wave, wave,
    seq), plain and recording entries."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave, panel_qr

    entries = {
        False: (band_chase.band_to_bidiagonal, band_chase_wave.band_to_bidiagonal_wave),
        True: (band_chase.band_to_bidiagonal_accum, band_chase_wave.band_to_bidiagonal_wave_accum),
    }
    out = {}
    for n, b in ROUTE_SHAPES:
        Ab = panel_qr.dense_to_band_fused(uniform_matrix(n), band=b)
        reps = SVD_REPS if n > 1000 else REPS
        for record, (seq, wave) in entries.items():
            res = {}

            def run_seq():
                res["seq"] = seq(Ab, band=b)

            def run_wave():
                res["wave"] = wave(Ab, band=b)

            reset_counts()
            s1 = cuda_ms(run_seq, reps)
            staged = read_counts()["band_chase_staged_rec" if record else "band_chase_staged"]
            w1 = cuda_ms(run_wave, reps)
            w2 = cuda_ms(run_wave, reps)
            s2 = cuda_ms(run_seq, reps, warm=False)
            out[n, b, record] = (min(w1, w2), min(s1, s2))
            same = all(torch.equal(x, y) for x, y in zip(res["wave"], res["seq"]))
            require(same, f"n={n} b={b}: the wavefront chase bit-equal to the sequential one")
            del res
            say(f"[route] n={n} b={b} {'recording' if record else 'plain'}: "
                f"sequential ({'staged TMA design' if staged else 'L2 kernel'}) "
                f"{s1:.3f} / {s2:.3f} ms, wavefront {w1:.3f} / "
                f"{w2:.3f} ms (medians of {reps}, in turns, "
                f"{band_chase_wave.last_ctas} CTAs, {band_chase_wave.last_tick} tick; "
                f"outputs bit-equal); the predicate takes the "
                f"{'wavefront' if chase_entry(n, b, record)[0].startswith('band_chase_wave') else 'sequential'}")
        del Ab
        torch.cuda.empty_cache()
    return out


def phase_sequential_times(band_state):
    """The sequential chase's two kernels in turns (L2, staged TMA, staged
    TMA, L2), plain and recording entries, at the check band (VAR_CHECK)
    and the path's band (VAR_PATH), the TMA design at K = 1 (the route of
    both entries, and ``pipelined``); at the check band also the deeper
    lookaheads of ``mega`` (its khops and the largest that fits), plain.
    Every output bit-equal to the L2 kernel's.  Returns {(n, b, K, record):
    (tma_ms, l2_ms)} (l2_ms None where only the TMA design was timed)."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr

    (n1, b1, khops1), (n3, b3, _) = VAR_CHECK, VAR_PATH
    out = {}
    for n, b, Ab in ((n1, b1, band_state[0]),
                     (n3, b3, panel_qr.dense_to_band_fused(uniform_matrix(n3), band=b3))):
        reps = 1 if n > 2000 else SVD_REPS
        for record in (False, True):
            tma = band_chase.band_to_bidiagonal_accum if record else band_chase.band_to_bidiagonal
            l2 = (band_chase.band_to_bidiagonal_accum_l2 if record
                  else band_chase.band_to_bidiagonal_l2)
            res = {}
            l1 = cuda_ms(lambda: res.setdefault("l2", l2(Ab, band=b)), reps, warm=n < 2000)
            t1 = cuda_ms(lambda: res.setdefault("tma", tma(Ab, band=b)), reps)
            t2 = cuda_ms(lambda: tma(Ab, band=b), reps)
            l2_ms = cuda_ms(lambda: l2(Ab, band=b), reps, warm=n < 2000)
            require(all(torch.equal(x, y) for x, y in zip(res["tma"], res["l2"])),
                    f"sequential n={n} b={b}: the staged TMA design bit-equal to the L2 kernel")
            out[n, b, 1, record] = (min(t1, t2), min(l1, l2_ms))
            say(f"[times] sequential {'recording' if record else 'plain'} n={n} b={b}: "
                f"staged TMA design (K=1) {t1:.3f} / {t2:.3f} ms, L2 kernel {l1:.3f} / "
                f"{l2_ms:.3f} ms (medians of {reps}, in turns; "
                f"{'(d, e) and records' if record else '(d, e)'} bit-equal)")
        want = band_chase.band_to_bidiagonal_l2(Ab, band=b)
        for K in sorted({band_chase.staged_khops(b, khops1), band_chase.staged_khops(b, 99)} - {1}):
            require_bit_equal(f"staged n={n} b={b} K={K}", band_chase.band_to_bidiagonal(
                Ab, band=b, mega=True, khops=K), want)
            require(band_chase.last_khops == K, f"staged n={n} b={b} runs K={K}")
            t = cuda_ms(lambda: band_chase.band_to_bidiagonal(Ab, band=b, mega=True, khops=K),
                        reps)
            out[n, b, K, False] = (t, None)
            say(f"[times] sequential plain n={n} b={b}: staged TMA design K={K} (mega) "
                f"{t:.3f} ms (median of {reps}; (d, e) bit-equal to the L2 kernel's)")
        del Ab, want
        torch.cuda.empty_cache()
    return out


def phase_tick_times(band_state):
    """The wavefront kernel's two ticks in turns (L2, shared memory, shared
    memory, L2) at TICK_SHAPES, plain and recording entries; one CTA's copy
    rate for a chase window at b = 128 (three b x (b + 4) boxes into shared
    memory and back, 1000 times); and the shared-memory tick's schedule
    bound, its critical path's copy bytes over that rate."""
    from svdsolver_tpu_torch.ops.chase_schedule import wave_copy_bytes, wave_ticks
    from svdsolver_tpu_torch.ops.cuda import band_chase_wave as bw, panel_qr

    out, sched = {}, {}
    rate = None
    for n, b in TICK_SHAPES:
        Ab = (band_state[0] if (n, b) == VAR_CHECK[:2]
              else panel_qr.dense_to_band_fused(uniform_matrix(n), band=b))
        reps = 1 if n > 4000 else SVD_REPS
        for record in (False, True):
            fn = bw.band_to_bidiagonal_wave_accum if record else bw.band_to_bidiagonal_wave
            l1 = cuda_ms(lambda: fn(Ab, band=b, _tick="l2"), reps)
            s1 = cuda_ms(lambda: fn(Ab, band=b, _tick="smem"), reps)
            s2 = cuda_ms(lambda: fn(Ab, band=b, _tick="smem"), reps)
            l2 = cuda_ms(lambda: fn(Ab, band=b, _tick="l2"), reps)
            out[n, b, record] = (min(s1, s2), min(l1, l2))
            say(f"[ticks] n={n} b={b} {'recording' if record else 'plain'}: shared-memory "
                f"tick {s1:.3f} / {s2:.3f} ms, L2 tick {l1:.3f} / {l2:.3f} ms (medians of "
                f"{reps}, in turns, {bw.last_ctas} CTAs, {wave_ticks(n, b)} ticks: "
                f"{min(s1, s2) / wave_ticks(n, b) * 1e3:.2f} against "
                f"{min(l1, l2) / wave_ticks(n, b) * 1e3:.2f} us a tick)")
        if b == 128 and rate is None:
            reps_copy = 1000
            r = n // 2
            t = cuda_ms(lambda: bw.window_copy(Ab, b, r, r + b, reps_copy))
            moved = 6 * 4 * b * (b + 4)
            rate = moved * reps_copy / t  # bytes a millisecond
            say(f"[ticks] one CTA's window copy b={b}: {t / reps_copy * 1e3:.3f} us for "
                f"{moved} bytes in and out, {rate / 1e6:.2f} GB/s (median of {REPS} runs of "
                f"{reps_copy})")
        del Ab
        torch.cuda.empty_cache()
    for n, b in TICK_SHAPES:
        nbytes = wave_copy_bytes(n, b)
        sched[n, b] = nbytes / rate
        say(f"[ticks] schedule bound n={n} b={b}: {nbytes:.4g} bytes on the critical "
            f"path over {rate / 1e6:.2f} GB/s = {sched[n, b]:.3f} ms (shared-memory tick "
            f"{out[n, b, False][0]:.3f} ms)")
    return out, sched, rate


def phase_times(band_state):
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.models import vectors
    from svdsolver_tpu_torch.ops.cuda import band_chase, bisect, panel_qr, tridiag_solve

    n, b = 3840, 128
    A = uniform_matrix(n)
    _, chase = chase_entry(n, b, record=False)
    _, chase_rec = chase_entry(n, b, record=True)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    d, e = chase(Ab, band=b)
    t = {
        "svdvals_3840": cuda_ms(lambda: svdvals(A)),
        "stage1_3840": cuda_ms(lambda: panel_qr.dense_to_band_fused(A, band=b)),
        "chase_3840": cuda_ms(lambda: chase(Ab, band=b)),
        "bisect_3840": cuda_ms(lambda: bisect.bisect_svdvals(d, e)),
    }
    for k, v in t.items():
        say(f"[times] {k}: {v:.3f} ms (median of {REPS})")

    # svd at 3840 and its split, each stage on the previous one's outputs
    Abr, Vq, Tq, Vl, Tl = panel_qr.dense_to_band_rec_fused(A, band=b)
    dr, er, VL, TL, VR, TR = chase_rec(Abr, band=b)
    sig = bisect.bisect_svdvals(dr, er)
    Ub, Vb = vectors.tgk_vectors(dr, er, sig)
    LU, RV = vectors._apply_chase_reflectors_wy_pair(VL, TL, VR, TR, Ub, Vb, b)
    split = {
        "svd_3840": lambda: svd(A),
        "stage1_rec_3840": lambda: panel_qr.dense_to_band_rec_fused(A, band=b),
        "chase_rec_3840": lambda: chase_rec(Abr, band=b),
        "bisect_svd_3840": lambda: bisect.bisect_svdvals(dr, er),
        "tgk_vectors_3840": lambda: vectors.tgk_vectors(dr, er, sig),
        "chase_backtransform_3840": lambda: vectors._apply_chase_reflectors_wy_pair(
            VL, TL, VR, TR, Ub, Vb, b),
        "stage1_backtransform_3840": lambda: vectors._apply_stage1_reflectors_pair(
            Vq, Tq, Vl, Tl, LU, RV),
    }
    for k, fn in split.items():
        t[k] = cuda_ms(fn, SVD_REPS)
        say(f"[times] {k}: {t[k]:.3f} ms (median of {SVD_REPS})")
    parts = sum(v for k, v in t.items() if k in split and k != "svd_3840")
    say(f"[times] svd split sums to {parts:.3f} ms of {t['svd_3840']:.3f} ms")
    del Vq, Tq, Vl, Tl, VL, TL, VR, TR, Ub, Vb, LU, RV

    # the cost of recording: the routed plain and recording entries on one
    # band, in turns
    c1 = cuda_ms(lambda: chase(Ab, band=b), SVD_REPS)
    r1 = cuda_ms(lambda: chase_rec(Ab, band=b), SVD_REPS)
    r2 = cuda_ms(lambda: chase_rec(Ab, band=b), SVD_REPS)
    c2 = cuda_ms(lambda: chase(Ab, band=b), SVD_REPS)
    say(f"[times] routed chase n=3840 b=128: plain entry {c1:.3f} / {c2:.3f} ms, "
        f"recording entry {r1:.3f} / {r2:.3f} ms (medians of {SVD_REPS})")

    rng = np.random.default_rng(2)
    Ab1, d1, e1 = band_state[:3]
    tgk = {nt: tgk_problem(rng, nt) for nt in (1024, 3840)}
    pairs = {
        "band_chase": (lambda: band_chase.band_to_bidiagonal_l2(Ab1, band=64),
                       lambda: band_chase.band_to_bidiagonal_plain(Ab1, band=64),
                       "n=1024 b=64"),
        "band_chase_rec": (
            lambda: band_chase.band_to_bidiagonal_accum_l2(Ab1, band=64),
            lambda: band_chase.band_to_bidiagonal_accum_plain(Ab1, band=64),
            "n=1024 b=64"),
        "bisect": (lambda: bisect.bisect_svdvals(d1, e1),
                   lambda: bisect.bisect_svdvals_plain(d1, e1), "n=1024 probes=1"),
        "bisect_p3": (lambda: bisect.bisect_svdvals(d1, e1, probes=3),
                      lambda: bisect.bisect_svdvals_plain(d1, e1, probes=3),
                      "n=1024 probes=3"),
        "tridiag_solve": (lambda: tridiag_solve.tgk_solve(*tgk[3840]),
                          lambda: tridiag_solve.tgk_solve_plain(*tgk[3840]),
                          "n=3840 (7680 rows, 3840 lanes)"),
        "tridiag_solve_1024": (lambda: tridiag_solve.tgk_solve(*tgk[1024]),
                               lambda: tridiag_solve.tgk_solve_plain(*tgk[1024]),
                               "n=1024 (2048 rows, 1024 lanes)"),
    }
    kt = {}
    for name, (kern, plain, shape) in pairs.items():
        (k1, k2), p1 = in_turns(kern, plain)
        kt[name] = (min(k1, k2), p1, shape)
        say(f"[times] {name} {shape}: kernel {k1:.3f} / {k2:.3f} ms (medians of "
            f"{REPS}), plain {p1:.3f} ms (one run)")

    # library calls computing the same function, timed beside the kernels
    # (never called by the port)
    lib = {
        "bisect": cuda_ms(lambda: torch.linalg.svdvals(
            torch.diag(d1) + torch.diag(e1, 1))),
    }
    lib_3840 = cuda_ms(lambda: torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)))
    say(f"[times] library: torch.linalg.svdvals of the dense bidiagonal n=1024 "
        f"{lib['bisect']:.3f} ms, n=3840 {lib_3840:.3f} ms (medians of {REPS})")
    k1 = phase_k1_times()
    kt["panel_qr"] = (k1[3840][0], k1[3840][1], "b=128 m=3840")
    lib["panel_qr"] = k1[3840][2]
    return t, kt, lib, k1


def phase_profile(label, fn):
    """Device time by kernel over one call of ``fn`` (``torch.profiler``),
    and the share of the call's wall time in which the card ran a kernel.
    Busy is not utilization: the panel kernel holds one cluster of up to 16
    SMs, the wavefront chase one SM a lane, the sequential chase one SM."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm: allocator and libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's device time repeats its kernels'
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )
    for ms, count, key in rows[:10]:
        say(f"[profile] {label}: {ms:10.3f} ms {count:5d} x {key[:72]}")
    busy = sum(r[0] for r in rows)
    say(f"[profile] {label}: wall {wall_ms:.3f} ms (host clock, profiler on), "
        f"kernels {busy:.3f} ms = {100 * busy / wall_ms:.1f}% of wall")


# ---- the diagonalizers (bidiag_qr, dqds) and the linalg applications ----

def work_qr(n, steps_zero, steps_shift, size=4):
    """The QR driver's work from the steps it reports: a Givens rotation is
    7 operations (three divisions, a square root, a product, a sum, a
    product), a zero-shift step two rotations and 4 products, a shifted
    step two rotations and 16 products and sums.  Bytes: d and e in and
    out."""
    return 18 * steps_zero + 30 * steps_shift, 4 * size * n


def work_dqds(n, steps, size=4):
    """The dqds loop's work from the steps it reports (every sweep run,
    retries included): a step is 5 operations (a sum, a division, two
    products, a difference).  Bytes: q and E in, the estimates out."""
    return 5 * steps, 3 * size * n


def _bidiag_on_card(rng, n, dtype):
    d = torch.from_numpy(rng.normal(size=n)).to(DEV, dtype)
    e = torch.from_numpy(rng.normal(size=n - 1)).to(DEV, dtype)
    return d, e


def require_same(label, pairs):
    """Each (name, got, want) bit-equal (tensors) or equal (numbers);
    returns the largest |got - want| of the tensors."""
    worst = 0.0
    for name, got, want in pairs:
        if isinstance(got, torch.Tensor):
            same = got.shape == want.shape and torch.equal(got, want)
            diff = (float((got.double() - want.double()).abs().max())
                    if got.shape == want.shape and got.numel() else 0.0)
            require(same, f"{label}: {name} bit-equal to the plain version "
                          f"(max |diff| {diff:.3e})")
            worst = max(worst, diff)
        else:
            require(got == want, f"{label}: {name} {got} == plain {want}")
    return worst


def _event_ms(fn):
    """One run of ``fn`` bracketed by CUDA events: (result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def check_diag():
    """The two diagonalizer kernels held bit-equal to their plain versions
    run on the card: at n in DIAG_CHECK, float32 and float64, the QR
    driver's (d, e), threshold, sweep count and convergence on both memory
    instances and in chunks of DIAG_CHUNK sweeps, dqds's sigma, sweep
    count and shift-type histogram on both instances; the sweep entry on the
    sub-block DIAG_SUB (one and three zero-shift sweeps, a shifted sweep;
    the entries outside it untouched) and four full sweeps
    (diag_reduce_fixed_iter); dqds in float64 on the stall spectrum within
    STALL_SWEEPS sweeps to TOL_STALL with no safety net; other dtypes
    refused.  Returns each kernel's row at n = 64 float32: kernel ms
    (median of REPS), plain ms (one run), library ms, work."""
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    rng = np.random.default_rng(12)
    rows = {}
    errs = {"bidiag_qr": 0.0, "dqds": 0.0}  # largest |kernel - plain| over the checks
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).removeprefix("torch.")
        for n in DIAG_CHECK:
            d, e = _bidiag_on_card(rng, n, dtype)
            (dp, ep, tp, sw, conv), qr_plain = _event_ms(lambda: dg.qr_converge_plain(d, e))
            for mem in ("smem", "global"):
                dk, ek, tk, info = bidiag_qr.converge(d, e, _memory=mem)
                info = info.tolist()
                errs["bidiag_qr"] = max(errs["bidiag_qr"], require_same(
                    f"[diag] bidiag_qr {tag} n={n} {mem}", [
                    ("d", dk, dp), ("e", ek, ep), ("threshold", tk, tp),
                    ("sweeps", info[0], sw), ("converged", bool(info[1]), conv)]))
            dk, ek, _, info_c = bidiag_qr.converge(d, e, chunk_sweeps=DIAG_CHUNK)
            require_same(f"[diag] bidiag_qr {tag} n={n} chunks of {DIAG_CHUNK}", [
                ("d", dk, dp), ("e", ek, ep), ("sweeps", int(info_c[0]), sw)])
            require_same(f"[diag] bidiag_qr {tag} n={n} sigma", [
                ("sigma", bidiag_qr.bidiagonal_svdvals(d, e),
                 dg.bidiagonal_svdvals_plain(d, e))])
            (sp, swp, hp), dqds_plain = _event_ms(
                lambda: dg.dqds_svdvals_plain(d, e, with_info="debug"))
            for mem in ("smem", "global"):
                sk, swk, hk = dqds.dqds_svdvals(d, e, with_info="debug", _memory=mem)
                errs["dqds"] = max(errs["dqds"], require_same(
                    f"[diag] dqds {tag} n={n} {mem}",
                    [("sigma", sk, sp), ("sweeps", swk, swp), ("histogram", hk, hp)]))
            say(f"[diag] check {tag} n={n}: bidiag_qr (d, e, threshold, {sw} sweeps) and "
                f"dqds (sigma, {swp} sweeps, histogram) bit-equal to the plain versions on "
                f"both memory instances; plain runs {qr_plain:.1f} / "
                f"{dqds_plain:.1f} ms")
            if n == DIAG_CHECK[-1] and dtype == torch.float32:
                lib = cuda_ms(lambda: torch.linalg.svdvals(torch.diag(d) + torch.diag(e, 1)))
                rows["bidiag_qr"] = {
                    "ms": cuda_ms(lambda: bidiag_qr.bidiagonal_svdvals(d, e)),
                    "plain_ms": qr_plain, "library_ms": lib,
                    "work": work_qr(n, int(info[2]), int(info[3])), "sweeps": sw,
                    "steps": (int(info[2]), int(info[3]))}
                rows["dqds"] = {
                    "ms": cuda_ms(lambda: dqds.dqds_svdvals(d, e)),
                    "plain_ms": dqds_plain, "library_ms": lib,
                    "work": work_dqds(n, dqds.last_steps), "sweeps": swp,
                    "steps": dqds.last_steps}
        # the sweep entry on a sub-block, and full sweeps
        n, lo, hi = DIAG_SUB
        d, e = _bidiag_on_card(rng, n, dtype)
        shift = torch.tensor(0.3, dtype=dtype, device=DEV)

        def zero_shift_plain(k, lo_, hi_):
            dd, ee = d, e
            for _ in range(k):
                dd, ee = dg.zero_shift_sweep_plain(dd, ee, lo_, hi_)
            return dd, ee

        cases = {
            "zero-shift sweep": ((lo, hi, 1, None), lambda: zero_shift_plain(1, lo, hi)),
            "3 zero-shift sweeps": ((lo, hi, 3, None), lambda: zero_shift_plain(3, lo, hi)),
            "shifted sweep": ((lo, hi, 1, shift),
                              lambda: dg.shifted_sweep_plain(d, e, lo, hi, shift)),
            "diag_reduce_fixed_iter(4)": ((0, n - 1, 4, None),
                                          lambda: zero_shift_plain(4, 0, n - 1)),
        }
        for name, ((lo_, hi_, k, sh), plain) in cases.items():
            want = plain()
            for mem in ("smem", "global"):
                got = bidiag_qr.sweeps(d, e, lo_, hi_, n_iter=k, shift=sh, _memory=mem)
                require_same(f"[diag] {name} {tag} [{lo_}, {hi_}] {mem}",
                             [("d", got[0], want[0]), ("e", got[1], want[1])])
                if lo_ > 0:
                    require(torch.equal(got[0][:lo_], d[:lo_]) and torch.equal(
                        got[0][hi_ + 1:], d[hi_ + 1:]) and torch.equal(got[1][:lo_], e[:lo_])
                        and torch.equal(got[1][hi_:], e[hi_:]),
                        f"{name}: the entries outside [{lo_}, {hi_}] untouched")
        say(f"[diag] check {tag}: the sweep entry bit-equal on [{lo}, {hi}] of n={n} (one "
            "and three zero-shift sweeps, a shifted sweep) and on four full sweeps, both "
            "memory instances")
    # dqds in float64 on the stall spectrum
    g = np.random.default_rng(0)
    d64, e64 = g.standard_normal(120), g.standard_normal(119)
    nets = dg.safety_nets
    sig, sweeps = dqds.dqds_svdvals(torch.from_numpy(d64).to(DEV), torch.from_numpy(e64).to(DEV),
                                    with_info=True)
    want = np.linalg.svd(np.diag(d64) + np.diag(e64, 1), compute_uv=False)
    rel = float(np.max(np.abs(sig.cpu().numpy() - want) / want))
    say(f"[diag] dqds float64 stall spectrum n=120: {sweeps} sweeps (JAX package 865, "
        f"LAPACK dlasq2 877), max relative error {rel:.3e}, safety net "
        f"{'fired' if dg.safety_nets != nets else 'not fired'}")
    require(sweeps <= STALL_SWEEPS and rel < TOL_STALL and dg.safety_nets == nets,
            "dqds on the stall spectrum")
    for fn in (bidiag_qr.bidiagonal_svdvals, dqds.dqds_svdvals):
        try:
            fn(torch.ones(4, dtype=torch.float16, device=DEV),
               torch.ones(3, dtype=torch.float16, device=DEV))
        except TypeError:
            continue
        raise RuntimeError(f"check failed: {fn.__module__} took float16")
    for k, err in errs.items():
        rows[k]["max_abs_err"] = err
    return rows


def diag_chains(rows):
    """ns a step of each diagonalizer's dependent chain alone, float32 and
    float64 (the chain entries: one thread, operands in registers, no
    memory; the faster of two launches): QR's zero-shift and shifted
    steps, dqds's step.  Adds them to ``rows``; returns {(kind, dtype):
    ns}, kind "zero", "shifted" or "dqds"."""
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    chain = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).removeprefix("torch.")
        for kind in bidiag_qr.CHAINS:
            chain[(kind, tag)] = min(bidiag_qr.chain_ns(dtype, kind) for _ in range(2))
        chain[("dqds", tag)] = min(dqds.chain_ns(dtype) for _ in range(2))
        say(f"[diag] chain {tag}: QR zero-shift step {chain[('zero', tag)]:.2f} ns, shifted "
            f"step {chain[('shifted', tag)]:.2f} ns, dqds step {chain[('dqds', tag)]:.2f} ns "
            "(one thread, operands in registers, CUDA events)")
    rows["bidiag_qr"]["chain_ns"] = {f"{k} {t}": v for (k, t), v in chain.items() if k != "dqds"}
    rows["dqds"]["chain_ns"] = {t: v for (k, t), v in chain.items() if k == "dqds"}
    return chain


def phase_diag(rows):
    """The diagonalizers on the main path: svdvals(A, diag="qr") and
    svdvals(A, diag="dqds") on the uniform matrix at DIAG_SIZES, every
    launch count set to 0 just before each call and read just after (Stage
    I, the routed chase and the diagonalizer's kernel launched, no plain
    diagonalizer loop, K2 only where dqds's safety net fired), sigma within
    TOL_SIGMA of float64 svdvals; then on the (d, e) of the reduction, both
    kernels held bit-equal to their plain versions over DIAG_PATH_SWEEPS
    sweeps, each window holding a deflation, on both memory instances (the
    QR driver's d, e, threshold, sweep
    count and convergence; dqds's loop on the scaled qd arrays: the
    estimates, hi, sweep count and histogram), each diagonalizer alone
    (one run each: seconds at 3840), diag_reduce_fixed_iter(d, e, 200)
    at 3840 (the reference's ``diagonal`` benchmark) and
    torch.linalg.svdvals of the dense bidiagonal (the library yardstick),
    the alone runs and the yardstick in float32 and float64, each beside
    its chain bound (steps times the chain's ns a step, ``diag_chains``)
    and its sweep overhead ((ms - chain bound) / sweeps).  Adds the path's
    numbers to ``rows``; returns the launch counts."""
    from svdsolver_tpu_torch import diag_reduce_fixed_iter, svdvals
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.models.svd import bidiagonalize
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    counts_by_run = {}
    for k in ("bidiag_qr", "dqds"):
        rows[k].update({"path_ms": {}, "path_bound_ms": {}, "path_library_ms": {},
                        "path_sweeps": {}, "path_ns_step": {}, "path_chain_bound_ms": {},
                        "path_sweep_overhead_us": {}})
    chain = diag_chains(rows)
    for n in DIAG_SIZES:
        A = uniform_matrix(n)
        ref = torch.linalg.svdvals(A.double())
        for diag, kernel, other in (("qr", "bidiag_qr", "dqds"), ("dqds", "dqds", "bidiag_qr")):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            s = svdvals(A, diag=diag)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            say(f"[diag] n={n}: svdvals(diag={diag!r}) {seconds:.3f} s (host clock) launches "
                f"{counts}")
            require(counts["panel_qr"] > 0 and counts[kernel] == 1 and counts[other] == 0
                    and counts["bidiag_qr_sweeps"] == 0,
                    f"svdvals(diag={diag!r}) at n={n} launched Stage I and {kernel} once")
            require(counts["plain_diag_loops"] == 0,
                    f"svdvals(diag={diag!r}) at n={n} ran a plain diagonalizer loop")
            chase = require_route(path_band(n), counts, record=False)
            nets = counts["dqds_safety_nets"]
            require(counts["bisect"] == nets and counts["bisect_thread"] == 0,
                    f"svdvals(diag={diag!r}) at n={n}: K2 only for the safety net")
            if diag == "dqds":
                fired = "FIRED (K2 gave sigma)" if nets else "not fired"
                say(f"[diag] n={n}: dqds's safety net {fired}")
            require(s.shape == (n,) and bool(torch.isfinite(s).all()), f"svdvals output n={n}")
            err = float((s.double() - ref).abs().max() / ref[0])
            say(f"[diag] n={n} diag={diag!r}: the chase took {chase}; max|sigma - sigma_ref| / "
                f"sigma_max = {err:.3e}")
            require(err <= TOL_SIGMA, f"sigma error {err:.3e} at n={n} diag={diag!r}")
            counts_by_run[f"svdvals {n} {diag}"] = counts
        # each diagonalizer alone on the reduction's (d, e)
        B = bidiagonalize(A)
        d, e = B.d.contiguous(), B.e.contiguous()
        kq, kd = DIAG_PATH_SWEEPS["bidiag_qr"][n], DIAG_PATH_SWEEPS["dqds"][n]
        (dp, ep, tp, swp, convp), qr_plain = _event_ms(
            lambda: dg.qr_converge_plain(d, e, max_sweeps=kq))
        q0, E0, _ = dg.dqds_prepare(d, e)
        (outp, hip, itp, thp), dqds_plain = _event_ms(lambda: dg._dqds_loop_plain(q0, E0, kd))
        zeroed = int((ep == 0).sum())
        require(zeroed > 0 and hip < n - 1,
                f"the windows of {kq} QR and {kd} dqds sweeps at n={n} each hold a deflation "
                f"(e hard-zeroed: {zeroed}; dqds hi = {hip})")
        for mem in ("smem", "global"):
            dk, ek, tk, info_k = bidiag_qr.converge(d, e, max_sweeps=kq, _memory=mem)
            info_k = info_k.tolist()
            rows["bidiag_qr"]["max_abs_err"] = max(rows["bidiag_qr"]["max_abs_err"], require_same(
                f"[diag] bidiag_qr on the path's (d, e) n={n} {kq} sweeps {mem}", [
                    ("d", dk, dp), ("e", ek, ep), ("threshold", tk, tp),
                    ("sweeps", info_k[0], swp), ("converged", bool(info_k[1]), convp)]))
            outk, hik, itk, thk = dqds.dqds_loop(q0, E0, kd, mem)
            rows["dqds"]["max_abs_err"] = max(rows["dqds"]["max_abs_err"], require_same(
                f"[diag] dqds on the path's (d, e) n={n} {kd} sweeps {mem}", [
                    ("estimates", outk, outp), ("hi", hik, hip), ("sweeps", itk, itp),
                    ("histogram", thk, thp)]))
        say(f"[diag] check n={n}: on the path's (d, e), {kq} sweeps of bidiag_qr (d, e, "
            f"threshold, {swp} sweeps, {zeroed} e hard-zeroed) and {kd} of the dqds loop "
            f"(estimates, hi = {hip}, {itp} sweeps, histogram {thp}) bit-equal to the plain "
            f"versions on both memory instances; plain runs {qr_plain:.1f} / "
            f"{dqds_plain:.1f} ms")
        lib_ms = {}
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).removeprefix("torch.")
            key = f"n={n}" if dtype == torch.float32 else f"n={n} {tag}"
            dd, ee = d.to(dtype), e.to(dtype)
            (_, _, _, info), qr_ms = _event_ms(lambda: bidiag_qr.converge(dd, ee))
            info = info.tolist()
            (_, sweeps, hist), dqds_ms = _event_ms(
                lambda: dqds.dqds_svdvals(dd, ee, with_info="debug"))
            steps = dqds.last_steps
            _, lib_ms[tag] = _event_ms(
                lambda: torch.linalg.svdvals(torch.diag(dd) + torch.diag(ee, 1)))
            say(f"[diag] n={n} {tag} alone (one run each, CUDA events): bidiag_qr "
                f"{qr_ms:.3f} ms ({info[0]} sweeps, {info[2]} zero-shift and {info[3]} shifted "
                f"steps), dqds {dqds_ms:.3f} ms ({sweeps} sweeps, {steps} steps, histogram "
                f"{hist.tolist()}), torch.linalg.svdvals of the dense bidiagonal "
                f"{lib_ms[tag]:.3f} ms")
            ns = {k: chain[(k, tag)] for k in ("zero", "shifted", "dqds")}
            for k, ms, w, sw, nsteps, chain_ms in (
                    ("bidiag_qr", qr_ms, work_qr(n, info[2], info[3], dtype.itemsize), info[0],
                     info[2] + info[3], bidiag_qr.chain_bound_ms(
                         info[2], info[3], ns["zero"], ns["shifted"])),
                    ("dqds", dqds_ms, work_dqds(n, steps, dtype.itemsize), sweeps, steps,
                     dqds.chain_bound_ms(steps, ns["dqds"]))):
                peak = PEAK_FP32 if dtype == torch.float32 else PEAK_FP64
                b_ms, b_by = bound(*w, peak=peak)
                ns_step = ms * 1e6 / nsteps
                over_us = (ms - chain_ms) * 1e3 / sw
                r = rows[k]
                r["path_ms"][key] = ms
                r["path_bound_ms"][key] = b_ms
                r["path_library_ms"][key] = lib_ms[tag]
                r["path_sweeps"][key] = sw
                r["path_ns_step"][key] = ns_step
                r["path_chain_bound_ms"][key] = chain_ms
                r["path_sweep_overhead_us"][key] = over_us
                say(f"[diag] {k} n={n} {tag}: {ms:.3f} ms, {nsteps} steps at "
                    f"{ns_step:.2f} ns a step; chain bound {chain_ms:.3f} ms "
                    f"({ms / chain_ms:.3f}x); sweep overhead {over_us:.3f} us a sweep "
                    f"({sw} sweeps); library {lib_ms[tag]:.3f} ms ({ms / lib_ms[tag]:.3f}x)")
                say(f"[bound] {k} n={n} {tag}: {w[0]:.4g} flops, {w[1]:.4g} bytes -> "
                    f"{b_ms:.6f} ms, bound by {b_by} ({ms / b_ms:.0f}x)")
        if n == 3840:
            _, fixed_ms = _event_ms(lambda: diag_reduce_fixed_iter(d, e, 200))
            rows["bidiag_qr"]["fixed_iter_200_ms"] = fixed_ms
            fixed_steps = 200 * (n - 1)
            say(f"[diag] n={n}: diag_reduce_fixed_iter(d, e, 200) {fixed_ms:.3f} ms (one run, "
                f"{fixed_steps} zero-shift steps: {fixed_ms * 1e6 / fixed_steps:.2f} ns a step; "
                f"chain bound {fixed_steps * chain[('zero', 'float32')] / 1e6:.3f} ms)")
        del A, ref, B, d, e, dp, ep, q0, E0, outp
        torch.cuda.empty_cache()
    return counts_by_run


def phase_linalg():
    """One call of each linalg application on the card, gated against
    float64 torch.linalg on the same float32 input, host seconds printed:
    pinv (Gaussian 2048: Penrose conditions 1 and 2 to TOL_LINALG of
    sigma_max, of 1 / sigma_min), lstsq (Gaussian 4096 x 2048, 4
    right-hand sides: x and the residual norms to 1e-4 relative, full
    rank), eigh (symmetric Gaussian 3840: eigenvalues to 1e-4 of max|w|,
    |A V - V W| and |V^T V - I| to TOL_LINALG), polar (Gaussian 2048: W P = A
    to TOL_RECON sigma_max, W orthogonal to TOL_ORTH), rsvd (3840, k = 64,
    sigma_i = 100 * 10**(-i/20) known by construction: sigma_1..k to
    TOL_LINALG relative), norm2 (uniform 3840: to TOL_SIGMA), cond
    (Gaussian 3840: to 2 eps32 cond relative, what float32 reaches: a
    float32 sigma_min is off by a small multiple of eps32 sigma_max, so
    cond by that multiple of eps32 cond), matrix_rank (3840 x 3000 times 3000 x 3840:
    3000 and the float64 count), orth and null_space (rank-700 1024^2: the
    ranks, and the projectors against float64 to 1e-4), lowrank (uniform
    1000, k = 250: the Eckart-Young error)."""
    from svdsolver_tpu_torch import linalg as la

    f64 = torch.float64
    eye = lambda k: torch.eye(k, dtype=f64, device=DEV)  # noqa: E731
    rng = np.random.default_rng(21)

    def gauss(m, n):
        return torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(DEV)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def gate(name, seconds, checks):
        say(f"[linalg] {name}: {seconds:.3f} s (host clock, first call); " + ", ".join(
            f"{label} {value:.3e} (limit {limit:.1e})" for label, value, limit in checks))
        for label, value, limit in checks:
            require(value <= limit, f"linalg {name}: {label} {value:.3e} > {limit:.1e}")

    n = LINALG["pinv"]
    A = gauss(n, n)
    P, sec = timed("pinv", lambda: la.pinv(A))
    Ad, Pd = A.double(), P.double()
    s64 = torch.linalg.svdvals(Ad)
    gate(f"pinv n={n}", sec, [
        ("|A P A - A| / sigma_max", float((Ad @ Pd @ Ad - Ad).abs().max() / s64[0]), TOL_LINALG),
        ("|P A P - P| sigma_min", float((Pd @ Ad @ Pd - Pd).abs().max() * s64[-1]), TOL_LINALG)])

    m, n, nrhs = LINALG["lstsq"]
    A, Bm = gauss(m, n), gauss(m, nrhs)
    (x, resid, rank), sec = timed("lstsq", lambda: la.lstsq(A, Bm))
    x64 = torch.linalg.lstsq(A.double(), Bm.double()).solution
    r64 = torch.linalg.norm(A.double() @ x64 - Bm.double(), dim=0)
    gate(f"lstsq {m}x{n}, {nrhs} rhs", sec, [
        ("|x - x64|_F / |x64|_F",
         float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64)), 1e-4),
        ("max |resid - resid64| / resid64",
         float(((resid.double() - r64) / r64).abs().max()), 1e-4),
        ("rank deficit", float(n - int(rank)), 0.0)])

    n = LINALG["eigh"]
    M = gauss(n, n)
    A = 0.5 * (M + M.T)
    (w, V), sec = timed("eigh", lambda: la.eigh(A))
    w64 = torch.linalg.eigvalsh(A.double())
    wmax = float(w64.abs().max())
    Vd = V.double()
    gate(f"eigh n={n}", sec, [
        ("|w - w64| / max|w64|", float((w.double() - w64).abs().max()) / wmax, 1e-4),
        ("|A V - V W| / max|w64|", float((A.double() @ Vd - Vd * w.double()).abs().max()) / wmax,
         TOL_LINALG),
        ("|V^T V - I|", float((Vd.T @ Vd - eye(n)).abs().max()), TOL_LINALG)])
    del M, A, V, Vd

    n = LINALG["polar"]
    A = gauss(n, n)
    (W, Pp), sec = timed("polar", lambda: la.polar(A))
    smax = float(torch.linalg.svdvals(A.double())[0])
    Wd = W.double()
    gate(f"polar n={n}", sec, [
        ("|W P - A| / sigma_max", float((Wd @ Pp.double() - A.double()).abs().max()) / smax,
         TOL_RECON),
        ("|W^T W - I|", float((Wd.T @ Wd - eye(n)).abs().max()), TOL_ORTH)])

    n, k = LINALG["rsvd"]
    A, sig = known_spectrum_matrix(n, seed=7, decades=(n - 1) / 20)
    (U, s, Vh), sec = timed("rsvd", lambda: la.rsvd(A, k))
    Ud = U.double()
    gate(f"rsvd n={n} k={k}", sec, [
        ("max |sigma - sigma_known| / sigma_known",
         float(((s.double() - sig[:k]) / sig[:k]).abs().max()), TOL_LINALG),
        ("|U^T U - I|", float((Ud.T @ Ud - eye(k)).abs().max()), TOL_LINALG)])

    n = LINALG["values"]
    A = uniform_matrix(n)
    val, sec = timed("norm2", lambda: la.norm2(A))
    s1 = float(torch.linalg.svdvals(A.double())[0])
    gate(f"norm2 uniform {n}", sec, [("|norm2 - sigma_1| / sigma_1", abs(float(val) - s1) / s1,
                                      TOL_SIGMA)])
    A = gauss(n, n)
    val, sec = timed("cond", lambda: la.cond(A))
    s64 = torch.linalg.svdvals(A.double())
    c64 = float(s64[0] / s64[-1])
    eps32 = torch.finfo(torch.float32).eps
    gate(f"cond Gaussian {n}", sec, [("|cond - cond64| / cond64", abs(float(val) - c64) / c64,
                                      2 * eps32 * c64)])
    say(f"[linalg] cond Gaussian {n}: {float(val):.6g} (float64 {c64:.6g})")
    r = LINALG["rank"]
    A = gauss(n, r) @ gauss(r, n)
    val, sec = timed("matrix_rank", lambda: la.matrix_rank(A))
    s64 = torch.linalg.svdvals(A.double())
    r64 = int((s64 > n * torch.finfo(torch.float32).eps * s64[0]).sum())
    gate(f"matrix_rank {n} (rank {r})", sec, [("|rank - r|", abs(int(val) - r), 0.0),
                                              ("|rank - rank64|", abs(int(val) - r64), 0.0)])
    del A, s64

    n, r = LINALG["orth"]
    A = gauss(n, r) @ gauss(r, n)
    U64, _, Vh64 = torch.linalg.svd(A.double())
    Q, sec = timed("orth", lambda: la.orth(A))
    Qd = Q.double()
    gate(f"orth rank-{r} {n}", sec, [
        ("|rank - r|", abs(Q.shape[1] - r), 0.0),
        ("|Q Q^T - U U^T|", float((Qd @ Qd.T - U64[:, :r] @ U64[:, :r].T).abs().max()), 1e-4)])
    N, sec = timed("null_space", lambda: la.null_space(A))
    Nd, V0 = N.double(), Vh64[r:].T
    gate(f"null_space rank-{r} {n}", sec, [
        ("|nullity - (n - r)|", abs(N.shape[1] - (n - r)), 0.0),
        ("|N N^T - V0 V0^T|", float((Nd @ Nd.T - V0 @ V0.T).abs().max()), 1e-4),
        ("|N^T N - I|", float((Nd.T @ Nd - eye(N.shape[1])).abs().max()), TOL_ORTH)])

    n, k = LINALG["lowrank"]
    A = uniform_matrix(n, seed=3)
    (L, R), sec = timed("lowrank", lambda: la.lowrank(A, k))
    s64 = torch.linalg.svdvals(A.double())
    best = float(torch.sqrt((s64[k:] ** 2).sum()))
    err = float(torch.linalg.norm(L.double() @ R.double() - A.double()))
    gate(f"lowrank {n} k={k}", sec, [
        ("|A - L R|_F / best - 1", err / best - 1, 1e-3 + 1e-4 * float(s64[0]) / best)])


def slab_cases(n, t):
    """(label, top, pc, bot) of the slab checks at (n, t): a diagonal slab
    (tile row 1), a TS slab (tile row 1 over the last tile row) and a TS
    slab shaped as the LQ mirror's (its pivot columns a tile left of its
    rows: the pivots' rows lie past the pivot block)."""
    return (("1-slab", t, t, None), ("2-slab", t, t, n - t),
            ("2-slab lq", 2 * t, t, n - t))


def work_slab(n, t, rows):
    """A slab's t steps: step j's reflector is zero above its pivot, so it
    needs a dot and an update of every column over rows j..rows-1 only, 4
    operations an entry (4 n sum_j (rows - j): 2 t^2 n for a 1-slab, 6 t^2 n
    for a 2-slab); bytes: the slab read once and written once."""
    return 4 * n * (t * rows - t * (t - 1) // 2), 4 * 2 * rows * n


def slab_library_ms(A, top, pc, t, bot):
    """The yardstick: torch.geqrf of the pivot block and torch.ormqr of its
    reflectors on the slab (the same QR and the same update, with LAPACK's
    reflectors), on copies made beforehand."""
    S = torch.cat([A[top:top + t]] + ([] if bot is None else [A[bot:bot + t]]))
    blk = S[:, pc:pc + t].contiguous()

    def fn():
        a, tau = torch.geqrf(blk)
        return torch.ormqr(a, tau, S, left=True, transpose=True)

    return cuda_ms(fn)


def check_slabs():
    """The slab kernel against its plain version on the card, at SLAB_TILES
    on rows of the SLAB_SIZES matrices (``slab_cases``): two launches
    bit-identical, the plain version within TOL_SLAB of max |A|, the rows
    outside the slab untouched; then ms a slab (1-slab and 2-slab) beside
    its plain version (one run), its bound and geqrf + ormqr.  Returns
    (max error, {(n, t, rows): (ms, plain_ms, library_ms, bound)})."""
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    worst, times = 0.0, {}
    for n in SLAB_SIZES:
        A = uniform_matrix(n, seed=4)
        amax = float(A.abs().max())
        for t in SLAB_TILES:
            for label, top, pc, bot in slab_cases(n, t):
                got, again, want = A.clone(), A.clone(), A.clone()
                tiled_slab.factor_slab(got, top, pc, t, bot)
                tiled_slab.factor_slab(again, top, pc, t, bot)
                tiled._factor_slab(want, top, pc, t, bot)
                torch.cuda.synchronize()
                require(torch.equal(got, again), f"tiled_slab {label} n={n} t={t}: two "
                        "launches bit-identical")
                err = float((got - want).abs().max()) / amax
                keep = torch.ones(n, dtype=torch.bool, device=DEV)
                for r in (top, bot):
                    if r is not None:
                        keep[r:r + t] = False
                require(torch.equal(got[keep], A[keep]), f"tiled_slab {label} n={n} t={t}: "
                        "rows outside the slab untouched")
                say(f"[ladder] tiled_slab {label} n={n} t={t} (rows {top}, pivots {pc}, TS "
                    f"rows {bot}): two launches bit-identical; max|kernel - plain| / max|A| "
                    f"= {err:.3e}")
                require(err <= TOL_SLAB, f"tiled_slab {label} n={n} t={t}: {err:.3e}")
                worst = max(worst, err * amax)
            for label, top, pc, bot in slab_cases(n, t)[:2]:
                rows = t if bot is None else 2 * t
                S = A.clone()
                k1, k2 = (fresh_ms(lambda: tiled_slab.factor_slab(S, top, pc, t, bot),
                                   lambda: S.copy_(A)) for _ in range(2))
                S.copy_(A)
                _, p1 = _event_ms(lambda: tiled._factor_slab(S, top, pc, t, bot))
                lib = slab_library_ms(A, top, pc, t, bot)
                b_ms, b_by = bound(*work_slab(n, t, rows))
                times[n, t, rows] = (min(k1, k2), p1, lib, (b_ms, b_by))
                say(f"[ladder] tiled_slab {label} n={n} t={t}: kernel {k1:.4f} / {k2:.4f} ms "
                    f"(medians of {REPS}; {min(k1, k2) * 1e3 / t:.3f} us a step), plain "
                    f"{p1:.3f} ms (one run), torch.geqrf + torch.ormqr {lib:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}; kernel {min(k1, k2) / b_ms:.1f}x)")
        del A
        torch.cuda.empty_cache()
    return worst, times


def work_sweep(n, t, slabs):
    """A half-sweep of ``slabs`` slabs (the 1-slab, then TS slabs): every
    column takes 4 sum_j (R - j) operations a slab (step j's reflector is
    zero above its pivot), the chain's t pivot columns and the apply's
    n - t others.  Bytes: the chain reads and writes the pivot columns of
    the half-sweep's rows and writes the history (v and tau); the apply
    reads and writes the other columns and reads the history.  Returns
    ((flops, bytes) of the chain, (flops, bytes) of the apply)."""
    per_col = sum(4 * (t * R - t * (t - 1) // 2) for R in [t] + [2 * t] * (slabs - 1))
    rows = slabs * t
    hist = 4 * slabs * t * (2 * t + 1)
    return ((t * per_col, 4 * 2 * rows * t + hist),
            ((n - t) * per_col, 4 * 2 * rows * (n - t) + hist))


def sweep_library_ms(A, top, pc, t, slabs):
    """The yardstick of a half-sweep's kernels: for each of its slabs,
    torch.geqrf of the stacked pivot block (the chain's QR) and torch.ormqr
    of its reflectors on the stack's other columns (the apply), on copies
    made beforehand.  Returns (geqrf ms, ormqr ms), summed over the slabs."""
    n = A.shape[1]
    others = torch.cat([torch.arange(pc), torch.arange(pc + t, n)]).to(A.device)
    geqrf_ms = ormqr_ms = 0.0
    for s_ in range(slabs):
        rows = [A[top:top + t]] + ([] if s_ == 0 else [A[top + s_ * t:top + s_ * t + t]])
        S = torch.cat(rows)
        blk = S[:, pc:pc + t].contiguous()
        rest = S[:, others].contiguous()
        geqrf_ms += cuda_ms(lambda: torch.geqrf(blk))
        a, tau = torch.geqrf(blk)
        ormqr_ms += cuda_ms(lambda: torch.ormqr(a, tau, rest, left=True, transpose=True))
    return geqrf_ms, ormqr_ms


def check_sweeps():
    """The two-kernel tiled Stage I (``tiled_chain``, ``tiled_apply``)
    against the first design and the plain versions.  dense_to_band_tiled
    ``torch.equal`` to dense_to_band_slabs (every slab through the first
    design's kernel) at SWEEP_CHECK, with its 2 (2 n / t - 1) launches
    counted; each kernel against its plain version (``models/tiled.
    chain_plain``, ``apply_plain`` on the kernel's history) on a half-sweep
    of SWEEP_SLABS slabs, QR-shaped and LQ-shaped (pivots a tile left of the
    rows), at TILED_TIMES, within TOL_SLAB of max |A|, two launches
    bit-identical.  Then, at TILED_TIMES: a 1-slab half-sweep (top = n - t)
    and a 2-slab one (top = n - 2t) through the kernels, each kernel and
    the chain alone (its latency bound: ``tiled_slab.chain_alone_ms``)
    timed, beside its plain version, geqrf / ormqr of the same slabs and
    the bound.  Returns ({kernel: max abs error}, {(n, t, slabs): times})."""
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import tiled_slab

    for n, t in SWEEP_CHECK:
        A = uniform_matrix(n, seed=6)
        reset_counts()
        got = tiled_slab.dense_to_band_tiled(A, band=t)
        torch.cuda.synchronize()
        counts = read_counts()
        want = tiled_slab.dense_to_band_slabs(A.clone(), t)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        half = 2 * (n // t) - 1
        say(f"[ladder] dense_to_band_tiled n={n} t={t}: torch.equal to the first design's "
            f"{(n // t) ** 2} slab launches: {same}; launches: chain {counts['tiled_chain']}, "
            f"apply {counts['tiled_apply']}, slab {counts['tiled_slab']}")
        require(same, f"dense_to_band_tiled n={n} t={t} bit-equal to the first design")
        require(counts["tiled_chain"] == counts["tiled_apply"] == half
                and counts["tiled_slab"] == 0, f"dense_to_band_tiled n={n} t={t}: launches")
        del A, got, want
    errs, times = {"tiled_chain": 0.0, "tiled_apply": 0.0}, {}
    for n, t in TILED_TIMES:
        A = uniform_matrix(n, seed=7)
        amax = float(A.abs().max())
        for label, pc_off in (("QR", 0), ("LQ", t)):
            top = n - SWEEP_SLABS * t
            pc = top - pc_off
            got, again, want = A.clone(), A.clone(), A.clone()
            V, tau = tiled_slab.factor_sweep(got, top, pc, t)
            V2, tau2 = tiled_slab.factor_sweep(again, top, pc, t)
            Vp, taup = tiled.chain_plain(want, top, pc, t)
            torch.cuda.synchronize()
            require(torch.equal(got, again) and torch.equal(V, V2) and torch.equal(tau, tau2),
                    f"tiled_chain {label} n={n} t={t}: two launches bit-identical")
            e_chain = float((got - want).abs().max())
            e_v = max(float((V[:, :, :2 * t] - Vp).abs().max()), float((tau - taup).abs().max()))
            plain = got.clone()
            tiled_slab.apply_sweep(got, top, pc, t, V, tau)
            tiled_slab.apply_sweep(again, top, pc, t, V, tau)
            tiled.apply_plain(plain, top, pc, t, V, tau)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"tiled_apply {label} n={n} t={t}: two launches "
                    "bit-identical")
            e_apply = float((got - plain).abs().max())
            require(torch.equal(got[:top], A[:top]), f"tiled sweep {label} n={n} t={t}: rows "
                    "above the half-sweep untouched")
            say(f"[ladder] tiled_chain / tiled_apply {label} half-sweep n={n} t={t} (rows {top}, "
                f"pivots {pc}, {SWEEP_SLABS} slabs): two launches bit-identical; chain "
                f"max|kernel - plain| / max|A| = {e_chain / amax:.3e} (v, tau {e_v:.3e}); "
                f"apply {e_apply / amax:.3e}")
            require(max(e_chain, e_apply) <= TOL_SLAB * amax and e_v <= TOL_SLAB,
                    f"tiled sweep kernels {label} n={n} t={t} against their plain versions")
            errs["tiled_chain"] = max(errs["tiled_chain"], e_chain)
            errs["tiled_apply"] = max(errs["tiled_apply"], e_apply)
        for slabs in (1, 2):  # every run on fresh rows of A
            top = n - slabs * t
            M = A.clone()
            V, tau = tiled_slab.factor_sweep(M, top, 0, t)
            chained = M.clone()  # the chain's output: the apply's input

            def both():
                tiled_slab.apply_sweep(M, top, 0, t, *tiled_slab.factor_sweep(M, top, 0, t))

            c_ms = fresh_ms(lambda: tiled_slab.factor_sweep(M, top, 0, t), lambda: M.copy_(A))
            a_ms = fresh_ms(lambda: tiled_slab.apply_sweep(M, top, 0, t, V, tau),
                            lambda: M.copy_(chained))
            b_ms = fresh_ms(both, lambda: M.copy_(A))
            alone = []
            for _ in range(REPS + 1):  # the first a warm-up
                M.copy_(A)
                alone.append(tiled_slab.chain_alone_ms(M, top, 0, t))
            alone = statistics.median(alone[1:])
            M.copy_(A)
            _, cp_ms = _event_ms(lambda: tiled.chain_plain(M, top, 0, t))
            M.copy_(chained)
            _, ap_ms = _event_ms(lambda: tiled.apply_plain(M, top, 0, t, V, tau))
            g_ms, o_ms = sweep_library_ms(A, top, 0, t, slabs)
            (cw, cb), (aw, ab) = work_sweep(n, t, slabs)
            cbound, abound = bound(cw, cb), bound(aw, ab)
            times[n, t, slabs] = {
                "chain_ms": c_ms, "apply_ms": a_ms, "both_ms": b_ms, "chain_alone_ms": alone,
                "chain_plain_ms": cp_ms, "apply_plain_ms": ap_ms, "geqrf_ms": g_ms,
                "ormqr_ms": o_ms, "chain_bound": cbound, "apply_bound": abound,
                "steps": slabs * t}
            say(f"[ladder] tiled sweep n={n} t={t} {slabs} slab(s) (top {top}): chain + apply "
                f"{b_ms:.4f} ms (chain {c_ms:.4f}, {c_ms * 1e3 / (slabs * t):.3f} us a step; "
                f"apply {a_ms:.4f}); chain alone {alone:.4f} ms ({alone * 1e3 / (slabs * t):.3f} "
                f"us a step); plain chain {cp_ms:.3f}, apply {ap_ms:.3f} ms (one run); "
                f"torch.geqrf {g_ms:.4f} + torch.ormqr {o_ms:.4f} ms; bound chain "
                f"{cbound[0]:.5f} ({cbound[1]}), apply {abound[0]:.5f} ms ({abound[1]}) "
                f"(medians of {REPS})")
        one, two = times[n, t, 1], times[n, t, 2]
        ts_ms = two["both_ms"] - one["both_ms"]
        lib1 = slab_library_ms(A, n - t, 0, t, None)
        lib2 = slab_library_ms(A, n - 2 * t, 0, t, n - t)
        say(f"[ladder] one slab through the two kernels n={n} t={t}: 1-slab {one['both_ms']:.4f} "
            f"ms (torch.geqrf + torch.ormqr {lib1:.4f}, bound "
            f"{bound(*work_slab(n, t, t))[0]:.5f}); TS slab {ts_ms:.4f} ms (the 2-slab "
            f"half-sweep less the 1-slab; torch.geqrf + torch.ormqr {lib2:.4f}, bound "
            f"{bound(*work_slab(n, t, 2 * t))[0]:.5f})")
        times[n, t, "slab"] = {"1-slab": one["both_ms"], "TS slab": ts_ms,
                               "1-slab library": lib1, "TS slab library": lib2}
        del A
        torch.cuda.empty_cache()
    return errs, times


def svd_gates(label, A, U, s, Vh, ref):
    """svd's gates in float64: sigma to TOL_SIGMA sigma_max, U diag(s) Vh
    to TOL_RECON sigma_max, U and Vh orthogonal to TOL_ORTH."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=DEV)
    Ud, Vd = U.double(), Vh.double()
    smax = float(ref[0])
    errs = {"sigma": float((s.double() - ref).abs().max()) / smax,
            "recon": float((Ud * s.double() @ Vd - A.double()).abs().max()) / smax,
            "orth U": float((Ud.T @ Ud - eye).abs().max()),
            "orth Vh": float((Vd @ Vd.T - eye).abs().max())}
    limits = {"sigma": TOL_SIGMA, "recon": TOL_RECON, "orth U": TOL_ORTH, "orth Vh": TOL_ORTH}
    for k, v in errs.items():
        require(v <= limits[k], f"{label}: {k} {v:.3e} > {limits[k]:.1e}")
    return errs


def phase_ladder():
    """The ladder rungs on the card.  The tiled Stage I's kernels first
    (check_slabs: the first design; check_sweeps: the chain and the apply).
    Then svdvals(A, method=m) for m in LADDER at LADDER_SIZES on the
    uniform matrix (the one-stage rungs at ONE_STAGE_SIZES only), every
    launch count set to 0 just before each call and
    read just after: sigma within TOL_SIGMA of float64 svdvals; K2 launched
    once by every rung; ``multicore``: a chain and an apply launch for each
    of its 2 n / t - 1 half-sweeps, no slab launch, the routed chase, no
    panel QR; ``base`` and ``singlecore``: no Stage I or chase kernel.
    dense_to_band_tiled at TILED_TIMES in turns with the first design
    (dense_to_band_slabs), dense_to_band_fused at 3840, and at 1024 beside
    its plain version (one run; the bands within TOL_SLAB in Frobenius
    norm).  svd(A, method="singlecore") at ONE_STAGE_SIZES with svd's gates.
    Returns (counts by run for the svdvals side, counts by run for the svd
    side, the rows of tiled_slab, tiled_chain and tiled_apply)."""
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import panel_qr, tiled_slab

    worst, times = check_slabs()
    sweep_errs, sweep_times = check_sweeps()
    counts_vals, counts_svd = {}, {}
    for n in LADDER_SIZES:
        A = uniform_matrix(n)
        ref = torch.linalg.svdvals(A.double())
        np_, b = path_band(n)
        for m in LADDER:
            if m != "multicore" and n not in ONE_STAGE_SIZES:
                continue
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            s = svdvals(A, method=m)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            require(s.shape == (n,) and bool(torch.isfinite(s).all()), f"{m} output n={n}")
            err = float((s.double() - ref).abs().max() / ref[0])
            require(counts["bisect"] == 1 and counts["bisect_thread"] == 0,
                    f"svdvals({m}) at n={n} launched the K2 tree once")
            if m == "multicore":
                want = 2 * (np_ // b) - 1  # half-sweeps: a chain and an apply launch each
                require(counts["tiled_chain"] == counts["tiled_apply"] == want
                        and counts["tiled_slab"] == 0 and counts["panel_qr"] == 0,
                        f"svdvals(multicore) at n={n}: chain {counts['tiled_chain']}, apply "
                        f"{counts['tiled_apply']} launches, want {want} each; slab "
                        f"{counts['tiled_slab']}, panel QR {counts['panel_qr']}, want 0")
                chase = require_route((np_, b), counts, record=False)
            else:
                require(all(counts[k] == 0 for k in ("tiled_slab", "tiled_chain", "tiled_apply",
                                                     "panel_qr") + CHASES),
                        f"svdvals({m}) at n={n} launched no Stage I or chase kernel")
                chase = "none (one-stage)"
            say(f"[ladder] n={n}: svdvals(method={m!r}) {seconds:.3f} s (host clock, one "
                f"call); max|sigma - sigma_ref| / sigma_max = {err:.3e}; chase {chase}; "
                f"launches {counts}")
            require(err <= TOL_SIGMA, f"svdvals({m}) sigma error {err:.3e} at n={n}")
            counts_vals[f"{m} {n}"] = counts
        if n not in ONE_STAGE_SIZES:
            continue
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        U, s, Vh = svd(A, method="singlecore")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        require(counts["bisect"] == 1 and counts["tridiag_solve"] > 0 and all(
            counts[k] == 0 for k in ("panel_qr", "tiled_slab", "tiled_chain", "tiled_apply")
            + CHASES),
            f"svd(singlecore) at n={n}: K2 and the TGK solve, no two-stage kernel")
        errs = svd_gates(f"svd(singlecore) n={n}", A, U, s, Vh, ref)
        say(f"[ladder] n={n}: svd(method='singlecore') {seconds:.3f} s (host clock, one "
            f"call); " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        counts_svd[f"svd singlecore {n}"] = counts
        del A, ref, U, s, Vh
        torch.cuda.empty_cache()

    # the tiled Stage I alone: in turns with its first design (first, new,
    # new, first), beside the panel Stage I and its plain version
    (n1, t1), (n2, t2) = TILED_TIMES
    tiled_ms, first_ms = {}, {}
    for n_, t_ in TILED_TIMES:
        A = uniform_matrix(n_)
        f1 = cuda_ms(lambda: tiled_slab.dense_to_band_slabs(A.clone(), t_), reps=3)
        k1 = cuda_ms(lambda: tiled_slab.dense_to_band_tiled(A, band=t_), reps=3)
        k2 = cuda_ms(lambda: tiled_slab.dense_to_band_tiled(A, band=t_), reps=3)
        f2 = cuda_ms(lambda: tiled_slab.dense_to_band_slabs(A.clone(), t_), reps=3)
        tiled_ms[n_, t_], first_ms[n_, t_] = min(k1, k2), min(f1, f2)
        say(f"[ladder] dense_to_band_tiled n={n_} t={t_} ({2 * (2 * n_ // t_ - 1)} launches): "
            f"{k1:.3f} / {k2:.3f} ms in turns with the first design ({(n_ // t_) ** 2} slab "
            f"launches) {f1:.3f} / {f2:.3f} ms (medians of 3; the first design's include a "
            f"copy of A, {cuda_ms(lambda: A.clone(), reps=3):.3f} ms)")
    A = uniform_matrix(n1)
    fused_ms = cuda_ms(lambda: panel_qr.dense_to_band_fused(A, band=t1), reps=3)
    say(f"[ladder] dense_to_band_fused n={n1} b={t1}: {fused_ms:.3f} ms (median of 3)")
    A = uniform_matrix(n2)
    Ab_k, k_ms = _event_ms(lambda: tiled_slab.dense_to_band_tiled(A, band=t2))
    Ab_p, p_ms = _event_ms(lambda: tiled.dense_to_band_tiled_plain(A, band=t2))
    rel = float(torch.linalg.norm(Ab_k - Ab_p) / torch.linalg.norm(A))
    say(f"[ladder] dense_to_band_tiled n={n2} t={t2}: kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms (one run each); |kernel - plain|_F / |A|_F = {rel:.3e}")
    require(rel <= TOL_SLAB, f"dense_to_band_tiled at {n2}: {rel:.3e}")
    del A, Ab_k, Ab_p

    n, t = SLAB_SIZES[0], SLAB_TILES[-1]
    ms, plain_ms, lib_ms, (b_ms, b_by) = times[n, t, 2 * t]
    replaces = ("svdsolver_tpu/models/tiled.py:59 + :72 (the lax.fori_loop of "
                "_factor_1slab / _factor_2slab over _slab_factor_step :33)")
    first = {
        "name": "tiled_slab", "route": "cuda", "source": "svdsolver_tpu_torch/csrc/tiled_slab.cu",
        "replaces": replaces, "tpu": [],
        "role": "first design: the bitwise oracle of tiled_chain + tiled_apply, and the route "
                "for bands past 128; the main path launches it no time",
        "launches": sum(c["tiled_slab"] for c in counts_vals.values()),
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "shape": f"2-slab n={n} t={t}",
        "slabs_ms": {f"n={n_} t={t_} rows={r}": {"ms": v[0], "plain_ms": v[1],
                                                 "library_ms": v[2], "bound_ms": v[3][0]}
                     for (n_, t_, r), v in times.items()},
        "dense_to_band_tiled_ms": {f"n={n_} t={t_}": v for (n_, t_), v in first_ms.items()},
    }
    rows = [first]
    for name, src in (("tiled_chain", "chain"), ("tiled_apply", "apply")):
        tm = sweep_times[n1, t1, 2]
        bnd = tm[f"{src}_bound"]
        row = {
            "name": name, "route": "cuda",
            "source": f"svdsolver_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": [],
            "launches": sum(c[name] for c in counts_vals.values()),
            "max_abs_err": sweep_errs[name], "ms": tm[f"{src}_ms"],
            "plain_ms": tm[f"{src}_plain_ms"], "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": tm["geqrf_ms" if src == "chain" else "ormqr_ms"],
            "shape": f"2-slab half-sweep n={n1} t={t1} (top = n - 2t)",
            "half_sweeps_ms": {f"n={n_} t={t_} slabs={k}": {
                key: (val if not isinstance(val, tuple) else val[0]) for key, val in v.items()
                if key.startswith(src) or key in ("both_ms", "steps", "geqrf_ms", "ormqr_ms")}
                for (n_, t_, k), v in sweep_times.items() if k != "slab"},
        }
        if name == "tiled_chain":
            row["chain_bound_ms"] = tm["chain_alone_ms"]
            row["us_a_step"] = tm["chain_ms"] * 1e3 / tm["steps"]
            row["one_slab_ms"] = {f"n={n_} t={t_}": v for (n_, t_, k), v in sweep_times.items()
                                  if k == "slab"}
            row["dense_to_band_tiled_ms"] = {f"n={n1} t={t1}": tiled_ms[n1, t1],
                                             f"n={n2} t={t2}": tiled_ms[n2, t2],
                                             f"plain n={n2} t={t2}": p_ms}
            row["dense_to_band_fused_ms"] = {f"n={n1} b={t1}": fused_ms}
        rows.append(row)
    return counts_vals, counts_svd, rows


def batch_of(B, n, kind, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(B, n, n)) if kind == "gauss"
         else rng.uniform(0, 5, (B, n, n))).astype(np.float32)
    return torch.from_numpy(a).to(DEV)


def phase_batch():
    """The batch entries on the card, every launch count set to 0 just
    before each batch call and read just after.  svdvals_batch at
    BATCH_VALS (uniform): each row bit-equal to svdvals(As[i]), K1, the
    routed chase and K2 launched for every matrix; svd_batch at BATCH_SVD
    (one Gaussian batch): svd's gates for every matrix, the recording
    chase and K2 for every matrix; each batch's ms (one run, CUDA events)
    beside B times one call (svdvals / svd of one matrix, a median of 3)
    and torch.linalg.svdvals / torch.linalg.svd of the batch.
    dense_to_band_uv_fused at UV_FUSED: Ab bit-equal to
    dense_to_band_fused(segments=1), |A - U1 Ab V1^T|_F / |A|_F and the
    orthogonality of U1, V1 in float64 within TOL_Q.  Returns (counts by
    run for svdvals_batch, counts by run for svd_batch)."""
    from svdsolver_tpu_torch import svd, svd_batch, svdvals, svdvals_batch
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    counts_vals, counts_svd = {}, {}
    for B, n in BATCH_VALS:
        As = batch_of(B, n, "uniform", seed=8)
        torch.cuda.synchronize()
        reset_counts()
        S, ms = _event_ms(lambda: svdvals_batch(As))
        counts = read_counts()
        np_, b = path_band(n)
        chase, _ = chase_entry(np_, b, record=False)
        require(counts["panel_qr"] > 0 and counts["bisect"] == B and counts[chase] == B,
                f"svdvals_batch ({B}, {n}): K1, {chase} and K2 for every matrix: {counts}")
        require(all(torch.equal(S[i], svdvals(As[i])) for i in range(B)),
                f"svdvals_batch ({B}, {n}): every row bit-equal to svdvals(As[i])")
        one = cuda_ms(lambda: svdvals(As[0]), reps=3)
        lib = cuda_ms(lambda: torch.linalg.svdvals(As), reps=3)
        ref = torch.linalg.svdvals(As.double())
        err = float(((S.double() - ref).abs().amax(1) / ref[:, 0]).max())
        require(err <= TOL_SIGMA, f"svdvals_batch ({B}, {n}): sigma error {err:.3e}")
        say(f"[batch] svdvals_batch B={B} n={n}: {ms:.3f} ms (one run), B x svdvals "
            f"{B * one:.3f} ms ({one:.3f} a call, median of 3), torch.linalg.svdvals of the "
            f"batch {lib:.3f} ms; rows bit-equal to svdvals(As[i]); max sigma error "
            f"{err:.3e}; chase {chase}")
        counts_vals[f"svdvals_batch {B}x{n}"] = counts
        del As, S, ref
    for B, n, kind in BATCH_SVD:
        As = batch_of(B, n, kind, seed=9)
        torch.cuda.synchronize()
        reset_counts()
        (U, S, Vh), ms = _event_ms(lambda: svd_batch(As))
        counts = read_counts()
        b = path_band(n)[1]
        chase, _ = chase_entry(path_band(n)[0], b, record=True)
        require(counts["panel_qr"] > 0 and counts["bisect"] == B and counts[chase] == B
                and counts["tridiag_solve"] >= B,
                f"svd_batch ({B}, {n}): K1, {chase}, K2 and the TGK solve: {counts}")
        ref = torch.linalg.svdvals(As.double())
        worst = {}
        for i in range(B):
            for k, v in svd_gates(f"svd_batch ({B}, {n}) matrix {i}", As[i], U[i], S[i],
                                  Vh[i], ref[i]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        one = cuda_ms(lambda: svd(As[0]), reps=3)
        lib = cuda_ms(lambda: torch.linalg.svd(As, full_matrices=False), reps=3)
        say(f"[batch] svd_batch B={B} n={n} ({kind}): {ms:.3f} ms (one run), B x svd "
            f"{B * one:.3f} ms ({one:.3f} a call, median of 3), torch.linalg.svd of the batch "
            f"{lib:.3f} ms; worst over the batch " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items()) + f"; chase {chase}")
        counts_svd[f"svd_batch {B}x{n}"] = counts
        del As, U, S, Vh, ref
        torch.cuda.empty_cache()
    n = UV_FUSED
    b = path_band(n)[1]
    A = uniform_matrix(n)
    (Ab, U1, V1), ms = _event_ms(lambda: panel_qr.dense_to_band_uv_fused(A, band=b))
    Ab1 = panel_qr.dense_to_band_fused(A, band=b, segments=1)
    require(torch.equal(Ab, Ab1), f"dense_to_band_uv_fused n={n}: Ab bit-equal to "
            "dense_to_band_fused(segments=1)")
    eye = torch.eye(n, dtype=torch.float64, device=DEV)
    Ud, Vd = U1.double(), V1.double()
    rec = float(torch.linalg.norm(Ud @ Ab.double() @ Vd.T - A.double()) /
                torch.linalg.norm(A.double()))
    orth = max(float((Ud.T @ Ud - eye).abs().max()), float((Vd.T @ Vd - eye).abs().max()))
    say(f"[batch] dense_to_band_uv_fused n={n} b={b}: {ms:.3f} ms (one run); Ab bit-equal to "
        f"dense_to_band_fused(segments=1); |A - U1 Ab V1^T|_F / |A|_F = {rec:.3e}, "
        f"orthogonality {orth:.3e}")
    require(rec <= TOL_Q and orth <= TOL_Q, f"dense_to_band_uv_fused n={n}: {rec:.3e}, "
            f"{orth:.3e}")
    return counts_vals, counts_svd


def check_wide_chases(rng):
    """The chases' wide pair at WIDE_CHASE, on the wide K1's Stage I band:
    the L2 sequential kernel and the wavefront's L2 tick bit-equal to each
    other, plain ((d, e)) and recording ((d, e) and the four records); the
    recording (d, e) bit-equal to the plain; each against the plain chase
    run on the card (spectra against float64 sigma(A), leading |d|); the
    records rebuilding the band (but at the largest shape, whose rank-1
    rebuild is slow); each run timed once (CUDA events), and both kernels
    at WIDE_CHASE_TIME as medians of 3.  Returns ({row: max |sigma_kernel -
    sigma_plain|}, {(n, b): times})."""
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave, panel_qr
    from svdsolver_tpu_torch.models import two_stage

    errs = {"band_chase_wide": 0.0, "band_chase_rec_wide": 0.0,
            "band_chase_wave_wide": 0.0, "band_chase_wave_rec_wide": 0.0}
    times = {}
    for n, b in WIDE_CHASE:
        A = uniform_matrix(n, seed=11)
        Ab = panel_qr.dense_to_band_fused(A, band=b)
        reset_counts()
        (d, e), l2 = _event_ms(lambda: band_chase.band_to_bidiagonal_l2(Ab, band=b))
        (dw, ew), wv = _event_ms(lambda: band_chase_wave.band_to_bidiagonal_wave(Ab, band=b))
        rec, l2r = _event_ms(lambda: band_chase.band_to_bidiagonal_accum_l2(Ab, band=b))
        recw, wvr = _event_ms(lambda: band_chase_wave.band_to_bidiagonal_wave_accum(Ab, band=b))
        c = read_counts()
        lanes = two_stage.wave_lanes(n, b)
        shape = f"n={n} b={b}"
        require((c["band_chase"], c["band_chase_rec"], c["band_chase_wave_l2"],
                 c["band_chase_wave_rec_l2"]) == (1, 1, 1, 1),
                f"wide chases {shape}: one launch of each L2 entry, got {c}")
        require(torch.equal(d, dw) and torch.equal(e, ew),
                f"wide chase {shape}: wavefront L2 tick bit-equal to the L2 kernel")
        require(all(torch.equal(x, y) for x, y in zip(rec, recw)),
                f"wide recording chase {shape}: wavefront bit-equal to the L2 kernel")
        require(torch.equal(rec[0], d) and torch.equal(rec[1], e),
                f"wide recording chase {shape}: (d, e) bit-equal to the plain entry's")
        say(f"[wide] chase {shape} ({lanes} wavefront lane(s)): L2 kernel and wavefront L2 "
            "tick bit-equal, plain and recording ((d, e) and the four records)")
        (dp, ep), pl = _event_ms(lambda: band_chase.band_to_bidiagonal_plain(Ab, band=b))
        _, plr = _event_ms(lambda: band_chase.band_to_bidiagonal_accum_plain(Ab, band=b))
        s_a = torch.linalg.svdvals(A.double())
        smax = float(s_a[0])
        s_k, s_p = bidiag_sigma(d, e), bidiag_sigma(dp, ep)
        for label, sg in (("kernel", s_k), ("plain", s_p)):
            err = float((sg - s_a).abs().max())
            say(f"[wide] chase {shape} {label} spectrum vs float64 sigma(A): "
                f"{err / smax:.3e} * sigma_max")
            require(err <= TOL_SIGMA * smax, f"wide chase {shape} {label} spectrum")
        lead = float(((d.abs() - dp.abs())[:8].abs() / dp.abs()[:8]).max())
        say(f"[wide] chase {shape} |d|[:8] rel diff kernel vs plain: {lead:.3e}")
        require(lead <= 1e-4, f"wide chase {shape}: leading |d| vs plain")
        err = float((s_k - s_p).abs().max())
        for k in errs:
            errs[k] = max(errs[k], err)
        if (n, b) != WIDE_CHASE_TIME:
            check_records(f"wide kernel {shape}", Ab, b, rec)
        del rec, recw
        times[n, b] = {"l2": l2, "wave": wv, "l2_rec": l2r, "wave_rec": wvr, "plain": pl,
                       "plain_rec": plr}
        if (n, b) == WIDE_CHASE_TIME:
            times[n, b].update({
                "l2": cuda_ms(lambda: band_chase.band_to_bidiagonal_l2(Ab, band=b), reps=3),
                "wave": cuda_ms(lambda: band_chase_wave.band_to_bidiagonal_wave(Ab, band=b),
                                reps=3)})
        tm = times[n, b]
        bnd, bnd_r = bound(*work_chase(n, b, False)), bound(*work_chase(n, b, True))
        say(f"[wide] chase {shape}: L2 kernel {tm['l2']:.3f} ms, wavefront L2 tick "
            f"{tm['wave']:.3f} ms, recording {l2r:.3f} / {wvr:.3f} ms; plain {pl:.1f} / "
            f"{plr:.1f} ms (one run each{'' if (n, b) != WIDE_CHASE_TIME else '; the L2 kernel '
            'and the wavefront medians of 3'}); bound {bnd[0]:.4f} ({bnd[1]}) / {bnd_r[0]:.4f} ms")
        del A, Ab
        torch.cuda.empty_cache()
    return errs, times


def check_wide_tiled():
    """The tiled Stage I's wide instance: forced at WIDE_TILED_BITS,
    torch.equal to the first design (t = 160) and to the two-kernel design
    (t <= 128); on its route at WIDE_TILED, its 2 (2 n / t - 1) launches
    counted and the band within TOL_SLAB of the plain Stage I run on the
    card (|kernel - plain|_F / |A|_F); its two kernels against their plain
    versions on a 2-slab half-sweep (top = n - 2t, QR- and LQ-shaped, two
    launches bit-identical), timed beside the plain versions, torch.geqrf /
    torch.ormqr of the same slabs and the bounds; the Stage I timed beside
    dense_to_band_fused at the same band.  Returns ({row: max abs error},
    {(n, t): times})."""
    from svdsolver_tpu_torch.models import tiled
    from svdsolver_tpu_torch.ops.cuda import panel_qr, tiled_slab

    for n, t in WIDE_TILED_BITS:
        A = uniform_matrix(n, seed=12)
        reset_counts()
        got = tiled_slab.dense_to_band_wide(A.clone(), t)
        torch.cuda.synchronize()
        c = read_counts()
        half = 2 * (n // t) - 1
        require(c["tiled_wide_chain"] == c["tiled_wide_apply"] == half,
                f"dense_to_band_wide n={n} t={t}: {half} launches of each kernel, got {c}")
        if tiled_slab.tiled_route(n, t, tiled_slab._sms(A.device)) == "slabs":
            want, other = tiled_slab.dense_to_band_slabs(A.clone(), t), "first design"
        else:
            want, other = tiled_slab.dense_to_band_tiled(A, band=t), "two-kernel design"
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        say(f"[wide] tiled n={n} t={t}: the wide instance ({half} chain and apply launches) "
            f"torch.equal to the {other}: {same}")
        require(same, f"tiled wide instance n={n} t={t} bit-equal to the {other}")
        del A, got, want
    errs, times = {"tiled_wide_chain": 0.0, "tiled_wide_apply": 0.0}, {}
    for n, t in WIDE_TILED:
        A = uniform_matrix(n, seed=13)
        amax = float(A.abs().max())
        require(tiled_slab.tiled_route(n, t, tiled_slab._sms(A.device)) == "wide",
                f"tiled_route n={n} t={t} is the wide instance")
        reset_counts()
        got, ms = _event_ms(lambda: tiled_slab.dense_to_band_tiled(A, band=t))
        c = read_counts()
        half = 2 * (n // t) - 1
        require(c["tiled_wide_chain"] == c["tiled_wide_apply"] == half
                and c["tiled_chain"] == c["tiled_apply"] == c["tiled_slab"] == 0,
                f"dense_to_band_tiled n={n} t={t}: the wide instance's launches, got {c}")
        want, p_ms = _event_ms(lambda: tiled.dense_to_band_tiled_plain(A, t))
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(A))
        fused = cuda_ms(lambda: panel_qr.dense_to_band_fused(A, band=t), reps=3)
        wide_ms = cuda_ms(lambda: tiled_slab.dense_to_band_tiled(A, band=t), reps=3)
        say(f"[wide] dense_to_band_tiled n={n} t={t} (the wide instance): |kernel - plain|_F "
            f"/ |A|_F = {rel:.3e}; {wide_ms:.3f} ms (first run {ms:.3f}), plain {p_ms:.1f} ms "
            f"(one run), dense_to_band_fused at b={t} {fused:.3f} ms")
        require(rel <= TOL_SLAB, f"dense_to_band_tiled n={n} t={t} against the plain Stage I")
        top = n - 2 * t
        for label, pc_off in (("QR", 0), ("LQ", t)):
            pc = top - pc_off
            g1, g2, w = A.clone(), A.clone(), A.clone()
            V, tau = tiled_slab.wide_chain(g1, top, pc, t)
            V2, tau2 = tiled_slab.wide_chain(g2, top, pc, t)
            Vp, taup = tiled.chain_plain(w, top, pc, t)
            torch.cuda.synchronize()
            require(torch.equal(g1, g2) and torch.equal(V, V2) and torch.equal(tau, tau2),
                    f"tiled_wide_chain {label} n={n} t={t}: two launches bit-identical")
            e_chain = float((g1 - w).abs().max())
            e_v = max(float((V - Vp).abs().max()), float((tau - taup).abs().max()))
            plain = g1.clone()
            tiled_slab.wide_apply(g1, top, pc, t, V, tau)
            tiled_slab.wide_apply(g2, top, pc, t, V, tau)
            tiled.apply_plain(plain, top, pc, t, V, tau)
            torch.cuda.synchronize()
            require(torch.equal(g1, g2), f"tiled_wide_apply {label} n={n} t={t}: two launches "
                    "bit-identical")
            e_apply = float((g1 - plain).abs().max())
            say(f"[wide] tiled_wide_chain / tiled_wide_apply {label} half-sweep n={n} t={t} "
                f"(rows {top}, pivots {pc}, 2 slabs): two launches bit-identical; chain "
                f"max|kernel - plain| / max|A| = {e_chain / amax:.3e} (v, tau {e_v:.3e}); "
                f"apply {e_apply / amax:.3e}")
            require(max(e_chain, e_apply) <= TOL_SLAB * amax and e_v <= TOL_SLAB,
                    f"tiled wide kernels {label} n={n} t={t} against their plain versions")
            errs["tiled_wide_chain"] = max(errs["tiled_wide_chain"], e_chain)
            errs["tiled_wide_apply"] = max(errs["tiled_wide_apply"], e_apply)
        M = A.clone()
        V, tau = tiled_slab.wide_chain(M, top, 0, t)
        chained = M.clone()
        c_ms = fresh_ms(lambda: tiled_slab.wide_chain(M, top, 0, t), lambda: M.copy_(A))
        a_ms = fresh_ms(lambda: tiled_slab.wide_apply(M, top, 0, t, V, tau),
                        lambda: M.copy_(chained))
        M.copy_(A)
        _, cp_ms = _event_ms(lambda: tiled.chain_plain(M, top, 0, t))
        M.copy_(chained)
        _, ap_ms = _event_ms(lambda: tiled.apply_plain(M, top, 0, t, V, tau))
        g_ms, o_ms = sweep_library_ms(A, top, 0, t, 2)
        (cw, cb), (aw, ab) = work_sweep(n, t, 2)
        cbound, abound = bound(cw, cb), bound(aw, ab)
        times[n, t] = {"chain_ms": c_ms, "apply_ms": a_ms, "chain_plain_ms": cp_ms,
                       "apply_plain_ms": ap_ms, "geqrf_ms": g_ms, "ormqr_ms": o_ms,
                       "chain_bound": cbound, "apply_bound": abound, "stage1_ms": wide_ms,
                       "stage1_plain_ms": p_ms, "fused_ms": fused, "steps": 2 * t}
        say(f"[wide] tiled wide half-sweep n={n} t={t} 2 slabs (top {top}): chain {c_ms:.4f} "
            f"ms ({c_ms * 1e3 / (2 * t):.3f} us a step), apply {a_ms:.4f} ms; plain chain "
            f"{cp_ms:.3f}, apply {ap_ms:.3f} ms (one run); torch.geqrf {g_ms:.4f} + "
            f"torch.ormqr {o_ms:.4f} ms; bound chain {cbound[0]:.5f} ({cbound[1]}), apply "
            f"{abound[0]:.5f} ms ({abound[1]}) (medians of {REPS})")
        del A, M, chained
        torch.cuda.empty_cache()
    return errs, times


def check_wide_stage1():
    """Stage I at WIDE_STAGE1 through K1's wide instance against the plain
    Stage I run on the card, output by output: ``dense_to_band_fused``
    against ``two_stage.dense_to_band``, ``dense_to_band_rec_fused`` (band
    and records) against ``dense_to_band_rec``, ``dense_to_band_uv_fused``
    (band, U1, V1) against ``dense_to_band_uv``; each |kernel - plain|_F /
    |plain|_F within TOL_SLAB (the same reflectors, float32 sums in other
    orders).  Returns the largest."""
    from svdsolver_tpu_torch.models import two_stage
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    n, b = WIDE_STAGE1
    A = uniform_matrix(n, seed=18)
    worst = 0.0
    for name, kern, plain in (
            ("dense_to_band_fused", lambda: (panel_qr.dense_to_band_fused(A, band=b),),
             lambda: (two_stage.dense_to_band(A, band=b),)),
            ("dense_to_band_rec_fused", lambda: panel_qr.dense_to_band_rec_fused(A, band=b),
             lambda: two_stage.dense_to_band_rec(A, band=b)),
            ("dense_to_band_uv_fused", lambda: panel_qr.dense_to_band_uv_fused(A, band=b),
             lambda: two_stage.dense_to_band_uv(A, band=b))):
        reset_counts()
        got = kern()
        c = read_counts()["panel_qr"]
        want = plain()
        errs = [float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) for g, w in zip(got, want)]
        say(f"[wide] {name} n={n} b={b} ({c} K1 launches, 2 lanes a row, T in device memory) "
            f"against the plain Stage I: |kernel - plain|_F / |plain|_F = "
            f"{', '.join(f'{e:.3e}' for e in errs)} (outputs in order)")
        require(c == 2 * (n // b) and max(errs) <= TOL_SLAB, f"{name} n={n} b={b} vs plain")
        worst = max(worst, max(errs))
    return worst


def time_wide_k1():
    """K1 at WIDE_K1_TIME beside its plain version (one run) and
    torch.geqrf of the same (m, b) panel: (ms, plain ms, library ms)."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    b, m, r_off = WIDE_K1_TIME
    Pt = uniform_matrix(m, seed=14)[:b].contiguous()
    P = Pt.T.contiguous()
    (k_ms, k2_ms), p_ms = in_turns(lambda: panel_qr.panel_qr(Pt, r_off),
                                   lambda: panel_qr.panel_qr_plain(Pt, r_off))
    lib_ms = cuda_ms(lambda: torch.geqrf(P))
    bnd = bound(*work_panel_qr(b, m, r_off))
    say(f"[wide] panel_qr b={b} m={m}: {min(k_ms, k2_ms):.3f} ms, plain {p_ms:.1f} ms (one "
        f"run), torch.geqrf of the (m, b) panel {lib_ms:.3f} ms, bound {bnd[0]:.5f} ms "
        f"({bnd[1]})")
    return min(k_ms, k2_ms), p_ms, lib_ms


def phase_wide(rng):
    """F3's repair, on the card: K1 past b = 256 against its plain version
    (check_panel_qr at WIDE_K1), the three fused Stage I entries on it
    against the plain Stage I (check_wide_stage1), K1 timed; the chases'
    wide pair
    (check_wide_chases); the tiled Stage I's wide instance
    (check_wide_tiled); then every entry of WIDE_PATHS with the launch
    counts set to 0 just before each call and read just after: sigma
    against float64 torch.linalg.svdvals to TOL_SIGMA sigma_max, svd's
    gates, and the counts showing the kernels of the path (K1 or the tiled
    Stage I's wide instance, the routed chase, K2; no first-design slab
    launch).  The narrow instances' bits are the other phases' checks.
    Returns (errors, times, {label: counts})."""
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.ops.cuda import band_chase_wave, tiled_slab

    t0 = time.perf_counter()
    errs = {"panel_qr_wide": check_panel_qr(rng, WIDE_K1)}
    check_wide_stage1()
    k1_times = time_wide_k1()
    e_chase, chase_times = check_wide_chases(rng)
    e_tiled, tiled_times = check_wide_tiled()
    errs.update(e_chase)
    errs.update(e_tiled)
    counts, refs = {}, {}
    for entry, method, n, b in WIDE_PATHS:
        A = uniform_matrix(n, seed=15)
        if n not in refs:
            refs[n] = torch.linalg.svdvals(A.double())
        ref = refs[n]
        label = f"{entry} {method} n={n} block={b}"
        reset_counts()
        if entry == "svdvals":
            s, ms = _event_ms(lambda: svdvals(A, method=method, block=b))
            c = read_counts()
            err = float((s.double() - ref).abs().max() / ref[0])
            require(err <= TOL_SIGMA, f"{label}: sigma {err:.3e}")
            gates = f"sigma err {err:.3e} * sigma_max"
        else:
            (U, s, Vh), ms = _event_ms(lambda: svd(A, method=method, band=b))
            c = read_counts()
            g = svd_gates(label, A, U, s, Vh, ref)
            gates = ", ".join(f"{k} {v:.3e}" for k, v in g.items())
            del U, Vh
        fired = {k: v for k, v in c.items() if v}
        say(f"[wide] {label}: {ms:.1f} ms (one run, builds done); {gates}; launches {fired}")
        stage1 = c["tiled_wide_chain"] if method == "multicore" else c["panel_qr"]
        require(stage1 > 0 and c["tiled_slab"] == 0 and c["bisect"] > 0,
                f"{label}: the path's kernels, got {fired}")
        chase = sum(c[k] for k in ("band_chase", "band_chase_rec", "band_chase_wave_l2",
                                   "band_chase_wave_rec_l2", "band_chase_staged",
                                   "band_chase_staged_rec", "band_chase_wave",
                                   "band_chase_wave_rec"))
        require(chase == 1, f"{label}: one chase launch, got {fired}")
        if b > band_chase_wave.NARROW_BAND and n > b:
            lanes = band_chase_wave.wave_chase_preferred(n, b)
            key = ("band_chase_wave" if lanes else "band_chase") + (
                "_rec" if entry == "svd" else "") + ("_l2" if lanes else "")
            require(c[key] == 1, f"{label}: the wide pair on the routed chase {key}")
        if method == "multicore" and b > 168:
            require(tiled_slab.tiled_route(n, b, tiled_slab._sms(A.device)) == "wide",
                    f"{label}: the wide tiled route")
        counts[label] = c
        del A
        torch.cuda.empty_cache()
    say(f"[done] phase_wide {time.perf_counter() - t0:.1f} s")
    return errs, {"k1": k1_times, "chase": chase_times, "tiled": tiled_times}, counts


def jacobi_gates(label, A, U, s, Vh):
    """The Jacobi checks of tests/test_jacobi.py in float64: sigma against
    float64 torch.linalg.svdvals over sigma_max, |U diag(s) Vh - A|_F /
    |A|_F, and U, Vh orthogonal on the numerical range (max entry of
    U^T U - I), each gated at TOL_JACOBI n eps (LAPACK's SVD test ratio:
    Jacobi's rounding grows with the rotations a column takes, so the
    JAX package's float32 gates at n = 192 do not carry to n = 3840; on the
    CPU at n = 512 float32 the JAX package itself gives a reconstruction of
    7.1e-05 and the port 9.9e-05, both over its n = 192 gate)."""
    from svdsolver_tpu_torch.models import jacobi

    lim = TOL_JACOBI * A.shape[-1] * jacobi._eps_eff(A.dtype)
    Ad, Ud, Vd, sd = A.double(), U.double(), Vh.double(), s.double()
    ref = torch.linalg.svdvals(Ad)
    k = s.shape[-1]
    errs = {"sigma": float((sd - ref).abs().max() / ref[0]),
            "recon": float(torch.linalg.norm(Ud * sd @ Vd - Ad) / torch.linalg.norm(Ad))}
    alive = sd > np.sqrt(k) * jacobi._eps_eff(A.dtype) * float(sd[0])
    Ua, Va = Ud[:, alive], Vd[alive]
    eye = torch.eye(int(alive.sum()), dtype=torch.float64, device=A.device)
    errs["orth"] = max(float((Ua.T @ Ua - eye).abs().max()), float((Va @ Va.T - eye).abs().max()))
    for key in ("sigma", "recon", "orth"):
        require(errs[key] <= lim, f"{label}: {key} {errs[key]:.3e} > {lim:.3e}")
    errs["gate"] = lim
    return errs


def jacobi_rounds(A, b):
    """One tournament round of ``A``'s Jacobi solve at block ``b``, measured
    eagerly: launches a round (torch.profiler's device events), ms a round
    (CUDA events, median of REPS), host ms a round, rounds a sweep, the
    device's busy share of a round; and a sweep of rounds replayed from
    the solve's CUDA graph (``jacobi._Rounds``): ms a round, and the one-off
    ms of the capture."""
    from torch.profiler import ProfilerActivity, profile
    from svdsolver_tpu_torch.models import jacobi

    n = A.shape[0]
    n_pad = -(-n // (2 * b)) * (2 * b)
    W = torch.nn.functional.pad(A, (0, n_pad - n))[None].contiguous()
    V = torch.eye(n_pad, dtype=A.dtype, device=A.device)[None].contiguous()
    perms, iperms = jacobi._schedule_cols(n_pad, b, A.device)
    ip, ii = jacobi._schedule_cols(2 * b, 1, A.device)
    eps = jacobi._eps_eff(A.dtype)

    def one():
        return jacobi._jacobi_round(W, V, perms[1], iperms[1], ip, ii, b, eps)

    ms = cuda_ms(one)
    t0 = time.perf_counter()
    for _ in range(REPS):
        one()
    host = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    sched = (perms, iperms, ip, ii)
    rounds, capture_ms = _event_ms(lambda: jacobi._Rounds(W, V, sched, b, eps))
    graph_ms = cuda_ms(lambda: rounds.sweep(W, V), reps=3) / perms.shape[0]
    return (launches, ms, host, perms.shape[0], busy / ms if ms else 0.0, graph_ms,
            capture_ms)


def phase_jacobi():
    """One-sided block Jacobi on the card (PyTorch ops; no kernel of its
    own): ``svd(A, method="jacobi")`` at JACOBI_SVD (float32 uniform),
    ``svd_jacobi_pre`` at JACOBI_PRE, ``svd_jacobi_batch`` at JACOBI_BATCH
    (each matrix held to its own single solve), ``svd_jacobi`` in float64
    at JACOBI_F64, each with the JAX package's gates, its sweeps, one
    round's launches, device ms and host ms, and ``torch.linalg.svd`` at the
    same shape.  Returns {label: numbers}."""
    from svdsolver_tpu_torch import svd, svd_jacobi, svd_jacobi_batch, svd_jacobi_pre
    from svdsolver_tpu_torch.models import jacobi

    t0 = time.perf_counter()
    out = {}

    cases = [("svd jacobi", n, torch.float32, 64) for n in JACOBI_SVD]
    cases += [("svd_jacobi_pre", JACOBI_PRE, torch.float32, 16),
              ("svd_jacobi float64", JACOBI_F64, torch.float64, 64)]
    calls = {"svd jacobi": lambda A: svd(A, method="jacobi"), "svd_jacobi_pre": svd_jacobi_pre,
             "svd_jacobi float64": svd_jacobi}
    for entry, n, dtype, b in cases:
        A = uniform_matrix(n, seed=16).to(dtype)
        label = f"{entry} n={n} {str(dtype).split('.')[1]}"
        (U, s, Vh), ms = _event_ms(lambda: calls[entry](A))
        sweeps = int(jacobi.last_sweeps[0])
        g = jacobi_gates(label, A, U, s, Vh)
        lib_ms = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), reps=3)
        launches, r_ms, r_host, rounds, busy, g_ms, cap_ms = jacobi_rounds(A, b)
        out[label] = {"ms": ms, "sweeps": sweeps, "rounds_a_sweep": rounds,
                      "launches_a_round": launches, "round_eager_ms": r_ms,
                      "round_host_ms": r_host, "round_busy": busy, "round_graph_ms": g_ms,
                      "capture_ms": cap_ms, "library_ms": lib_ms, **g}
        say(f"[jacobi] {label} (block {b}): {ms:.1f} ms (one run), {sweeps} sweeps of "
            f"{rounds} rounds; a round replayed from the graph {g_ms:.3f} ms (capture "
            f"{cap_ms:.1f} ms once a solve); eagerly {r_ms:.3f} ms on CUDA events ({r_host:.3f} "
            f"ms of host time), {launches} launches ({r_ms * 1e3 / max(launches, 1):.1f} us "
            f"each), kernels {100 * busy:.1f}% of it; torch.linalg.svd {lib_ms:.2f} ms; sigma "
            f"{g['sigma']:.3e}, recon {g['recon']:.3e}, orth {g['orth']:.3e} (gate "
            f"{g['gate']:.3e})")
        del A, U, Vh
        torch.cuda.empty_cache()
    B, n = JACOBI_BATCH
    rng = np.random.default_rng(17)
    As = torch.from_numpy(rng.uniform(0, 5, (B, n, n)).astype(np.float32)).to(DEV)
    (U, s, Vh), ms = _event_ms(lambda: svd_jacobi_batch(As))
    sweeps = jacobi.last_sweeps.tolist()
    worst = 0.0
    for i in range(B):
        jacobi_gates(f"svd_jacobi_batch ({B}, {n}) [{i}]", As[i], U[i], s[i], Vh[i])
        Ui, si, Vhi = svd_jacobi(As[i], block=16)
        one = int(jacobi.last_sweeps[0])
        require(one == sweeps[i], f"svd_jacobi_batch [{i}]: {sweeps[i]} sweeps, alone {one}")
        worst = max(worst, float((s[i] - si).abs().max() / si[0]))
    lib_ms = cuda_ms(lambda: torch.linalg.svd(As, full_matrices=False), reps=3)
    launches, r_ms, r_host, rounds, busy, g_ms, _ = jacobi_rounds(As[0], 16)
    out[f"svd_jacobi_batch ({B}, {n})"] = {"ms": ms, "sweeps": sweeps, "library_ms": lib_ms,
                                           "vs_single": worst}
    say(f"[jacobi] svd_jacobi_batch ({B}, {n}) float32 (block 16): {ms:.1f} ms (one run), "
        f"sweeps {sweeps} (each as its single solve's; sigma within {worst:.3e} sigma_max of "
        f"it); torch.linalg.svd on the batch {lib_ms:.2f} ms; one matrix's round {g_ms:.3f} "
        f"ms replayed, {r_ms:.3f} ms eagerly, {launches} launches")
    say(f"[done] phase_jacobi {time.perf_counter() - t0:.1f} s")
    return out


# ---- the robustness net, complex SVD, the CLI and SBR ----

@contextlib.contextmanager
def forbid_plain():
    """Every plain version an entry point could run in place of a kernel
    (``ops.cuda.plain_versions``) replaced by a function that fails."""
    from svdsolver_tpu_torch.ops.cuda import plain_versions

    saved = [(mod, name, getattr(mod, name)) for mod, name in plain_versions()]

    def failing(name):
        def fail(*args, **kwargs):
            raise RuntimeError(f"check failed: the plain version {name} ran on the card")
        return fail

    for mod, name, _ in saved:
        setattr(mod, name, failing(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def forbidden_run(fn):
    """``fn()`` with every plain version forbidden and the launch counts
    set to 0 just before: (result, counts)."""
    torch.cuda.synchronize()
    with forbid_plain():
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
    return out, counts


def _chase_routes():
    from svdsolver_tpu_torch.ops.cuda import band_chase, band_chase_wave

    return {"sequential": (band_chase.band_to_bidiagonal, ("band_chase_staged", "band_chase")),
            "sequential rec": (band_chase.band_to_bidiagonal_accum,
                               ("band_chase_staged_rec", "band_chase_rec")),
            "wavefront": (band_chase_wave.band_to_bidiagonal_wave,
                          ("band_chase_wave", "band_chase_wave_l2")),
            "wavefront rec": (band_chase_wave.band_to_bidiagonal_wave_accum,
                              ("band_chase_wave_rec", "band_chase_wave_rec_l2"))}


def robust_panels(rng):
    """K1 on a zero panel, a panel with every other column zero (zero-norm
    reflectors) and an upper-triangular one (every reflector the identity)."""
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    for b, m in ROBUST_PANELS:
        for kind in ("zero", "zero_columns", "factored"):
            P = rng.normal(size=(m, b)).astype(np.float32)
            P = (np.zeros_like(P) if kind == "zero" else np.triu(P) if kind == "factored"
                 else P * (np.arange(b) % 2 == 0))
            Pt = torch.from_numpy(np.ascontiguousarray(P.T)).to(DEV)
            want = panel_qr.panel_qr_plain(Pt, 0)
            (Rt, Vt, Tt), c = forbidden_run(lambda: panel_qr.panel_qr(Pt, 0))
            label = f"[robust] K1 b={b} m={m} {kind}"
            require(c["panel_qr"] == 1, f"{label}: one launch")
            require(all(bool(torch.isfinite(x).all()) for x in (Rt, Vt, Tt)), f"{label}: finite")
            tau = torch.diagonal(Tt)
            zero_j = range(1, b, 2) if kind == "zero_columns" else range(b)
            require(all(float(tau[j]) == 0.0 for j in zero_j), f"{label}: tau = 0 "
                    "at every zero-norm reflector")
            scale = max(float(Pt.abs().max()), 1.0)
            err = max(float((g - w).abs().max()) for g, w in zip((Rt, Vt, Tt), want)) / scale
            require(err <= 1e-4, f"{label}: against the plain version ({err:.3e})")
            if kind != "zero_columns":
                require(torch.equal(Rt, Pt), f"{label}: R = P exactly")
            V, T = Vt.double().T, Tt.double().T
            eye = torch.eye(m, dtype=torch.float64, device=DEV)
            Q = eye - V @ T @ V.T
            orth = float((Q.T @ Q - eye).abs().max())
            qr = float((Q @ Rt.double().T - Pt.double().T).abs().max()) / scale
            require(orth <= TOL_Q and qr <= TOL_Q, f"{label}: Q orthogonal, Q R = P")
            say(f"{label}: tau = 0 at {len(zero_j)} of {b} reflectors, no NaN; max |kernel "
                f"- plain| {err:.3e} (/ max |P|); |Q^T Q - I| {orth:.3e}, |Q R - P| {qr:.3e}")


def robust_chases(rng):
    """The routed chases, plain and recording, on a band that is already
    bidiagonal and on the zero band: (d, e) exact, the records rebuild the
    band (every reflector the identity)."""
    from svdsolver_tpu_torch.models.vectors import _apply_chase_reflectors

    n, b = ROBUST_BAND
    for kind in ("bidiagonal", "zero"):
        d0 = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(DEV)
        e0 = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32)).to(DEV)
        if kind == "zero":
            d0.zero_(), e0.zero_()
        Ab = (torch.diag(d0) + torch.diag(e0, 1)).contiguous()
        for entry, (fn, keys) in _chase_routes().items():
            label = f"[robust] {entry} chase n={n} b={b} on a {kind} band"
            out, c = forbidden_run(lambda: fn(Ab, band=b))
            ran = [k for k in keys if c[k]]
            require(sum(c[k] for k in keys) == 1, f"{label}: one launch")
            require(torch.equal(out[0], d0) and torch.equal(out[1], e0), f"{label}: (d, e) exact")
            if entry.endswith("rec"):
                _, _, VL, TL, VR, TR = out
                eye = torch.eye(n, device=DEV)
                L = _apply_chase_reflectors(VL, TL, eye, b, reverse=True)
                R = _apply_chase_reflectors(VR, TR, eye, b, reverse=True)
                require(torch.equal(L @ Ab @ R.T, Ab), f"{label}: the records rebuild the band")
            say(f"{label}: {', '.join(ran)} launched, (d, e) exact"
                + (", the records rebuild the band exactly" if entry.endswith("rec") else ""))


def robust_bisect(rng):
    """K2 on d = e = 0 and on (d, e) with exact zeros inside."""
    from svdsolver_tpu_torch.ops.cuda import bisect

    for n in ROBUST_N:
        for kind in ("zero", "split"):
            d = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(DEV)
            e = torch.from_numpy(rng.normal(size=n - 1).astype(np.float32)).to(DEV)
            if kind == "zero":
                d.zero_(), e.zero_()
            else:
                d[[3, n // 2]] = 0
                e[[5, 6, n - 2]] = 0
            label = f"[robust] K2 n={n} {kind} (d, e)"
            want = bisect.bisect_svdvals_plain(d, e)
            s, c = forbidden_run(lambda: bisect.bisect_svdvals(d, e))
            require(c["bisect"] == 1 and bool(torch.isfinite(s).all()), f"{label}: one launch")
            diff = float((s - want).abs().max())
            ref = bidiag_sigma(d, e)
            err = float((s.double() - ref).abs().max()) / max(float(ref[0]), 1e-30)
            if kind == "zero":
                require(torch.equal(s, torch.zeros_like(s)), f"{label}: sigma exactly 0")
            else:
                require(diff <= 1e-6 * float(want.abs().max()) and err <= TOL_SIGMA,
                        f"{label}: the plain bisection's values ({diff:.3e}), float64 ({err:.3e})")
            say(f"{label}: max |kernel - plain| {diff:.3e}, sigma err {err:.3e}"
                + (" (all exactly 0)" if kind == "zero" else ""))


def robust_paths(rng):
    """The tiled Stage I on zero and diagonal matrices; svd (K9/K10) on the
    identity and 3 Q; svd_batch with three spectra."""
    from svdsolver_tpu_torch import svd, svd_batch, svdvals

    n, t = ROBUST_N[-1], ROBUST_TILE
    for kind in ("zero", "diagonal"):
        x = rng.normal(size=n).astype(np.float32) if kind == "diagonal" else np.zeros(n, np.float32)
        A = torch.diag(torch.from_numpy(x)).to(DEV)
        s, c = forbidden_run(lambda: svdvals(A, method="multicore", block=t))
        label = f"[robust] multicore n={n} t={t} {kind}"
        half = 2 * (n // t) - 1
        require(c["tiled_chain"] == half and c["tiled_apply"] == half and c["bisect"] == 1,
                f"{label}: the chain and the apply kernels, K2")
        want = torch.from_numpy(np.sort(np.abs(x))[::-1].copy()).to(DEV)
        err = float((s - want).abs().max()) / max(float(want[0]), 1e-30)
        require(torch.equal(s, want) if kind == "zero" else err <= 1e-6, f"{label}: sigma")
        say(f"{label}: {half} chain and {half} apply launches, sigma err {err:.3e}")
    for n in ROBUST_N:
        for kind in ("identity", "three_q"):
            A = (np.eye(n) if kind == "identity"
                 else 3 * np.linalg.qr(rng.normal(size=(n, n)))[0]).astype(np.float32)
            A = torch.from_numpy(A).to(DEV)
            (U, s, Vh), c = forbidden_run(lambda: svd(A))
            label = f"[robust] svd n={n} {kind}"
            require(c["tridiag_solve"] == 2 and c["bisect"] == 1, f"{label}: K2, K9/K10 launched")
            g = svd_gates(label, A, U, s, Vh, torch.linalg.svdvals(A.double()))
            say(f"{label}: K2 and K9/K10 launched; sigma {g['sigma']:.3e}, recon "
                f"{g['recon']:.3e}, orth {max(g['orth U'], g['orth Vh']):.3e}")
    B = ROBUST_BATCH
    Q1, Q2 = (np.linalg.qr(rng.normal(size=(B, B)))[0] for _ in range(2))
    specs = [np.linspace(2.0, 1.0, B), np.full(B, 1.5),
             np.concatenate([np.linspace(3, 1, B - 4), np.full(4, 1e-5)])]
    As = torch.from_numpy(np.stack([(Q1 * sp[None, :]) @ Q2.T for sp in specs])
                          .astype(np.float32)).to(DEV)
    (U, s, Vh), c = forbidden_run(lambda: svd_batch(As))
    require(c["panel_qr"] > 0 and c["tridiag_solve"] == 2 * len(specs),
            "[robust] svd_batch: K1 and K9/K10 launched")
    for i, sp in enumerate(specs):
        want = torch.from_numpy(np.sort(sp)[::-1].copy()).to(DEV)
        err = float((s[i].double() - want).abs().max()) / float(want[0])
        recon = float(((U[i] * s[i]) @ Vh[i] - As[i]).abs().max()) / float(want[0])
        require(err <= 2e-4 and recon <= 5e-5, f"[robust] svd_batch [{i}]: sigma, recon")
        say(f"[robust] svd_batch ({len(specs)}, {B}) [{i}]: sigma err {err:.3e}, "
            f"recon {recon:.3e}")


def robust_diag(rng):
    """bidiag_qr and dqds on zero, split and zero-pivot (d, e): bit-equal
    to the plain versions, zero (d, e) exactly 0.  A zero d with a zero e
    elsewhere costs the QR diagonalizer its accuracy in the JAX package
    too (ROADMAP, shared with the reference): held to bits there."""
    from svdsolver_tpu_torch.models import diagonalize as dg
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    n = ROBUST_N[0]
    for kind in ("zero", "split", "zero_pivot"):
        d, e = _bidiag_on_card(rng, n, torch.float32)
        if kind == "zero":
            d.zero_(), e.zero_()
        elif kind == "split":
            e[[10, 11]] = 0
        else:
            d[5], e[10] = 0, 0
        ref = bidiag_sigma(d, e)
        for name, fn, plain in (("bidiag_qr", bidiag_qr.bidiagonal_svdvals,
                                 dg.bidiagonal_svdvals_plain),
                                ("dqds", dqds.dqds_svdvals, dg.dqds_svdvals_plain)):
            label = f"[robust] {name} n={n} {kind} (d, e)"
            want = plain(d, e)
            s, c = forbidden_run(lambda: fn(d, e))
            require(c[name] == 1 and c["plain_diag_loops"] == 0 and c["dqds_safety_nets"] == 0,
                    f"{label}: one launch, no plain loop")
            require(torch.equal(s, want) and bool(torch.isfinite(s).all()),
                    f"{label}: bit-equal to the plain version")
            err = float((s.double() - ref).abs().max()) / max(float(ref[0]), 1e-30)
            if kind == "zero":
                require(torch.equal(s, torch.zeros_like(s)), f"{label}: sigma exactly 0")
            elif kind == "split" or name == "dqds":
                require(err <= TOL_SIGMA, f"{label}: sigma err {err:.3e}")
            say(f"{label}: bit-equal to the plain version, sigma err {err:.3e}"
                + (" (shared with the JAX package's QR)" if err > TOL_SIGMA else ""))


def phase_robust():
    """The robustness net on the card: each degenerate input of the CPU net
    (``tests/test_torch_robustness.py``) through the kernel its entry routes
    it to, float32, every plain version forbidden and the launch counts
    read around each call (``forbidden_run``)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    robust_panels(rng)
    robust_chases(rng)
    robust_bisect(rng)
    robust_paths(rng)
    robust_diag(rng)
    say(f"[done] phase_robust {time.perf_counter() - t0:.1f} s")


def kernel_launches(fn):
    """Device kernels ``fn()`` launches (torch.profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_complex():
    """Complex SVD (``models/complex_svd.py``, torch complex64; no kernel of
    its own): ``svdvals`` and ``svd`` at COMPLEX_SIZES (Golub-Kahan, then
    the blocked reduction), the counts set to 0 before each call and read
    after (K2; K9/K10 for svd); sigma against complex128
    ``torch.linalg.svdvals`` to 1e-5 sigma_max, reconstruction and
    unitarity to 1e-4; one run's ms (CUDA events), ``torch.linalg.svdvals``
    / ``svd`` on complex64; each reduction's launches a column from the
    profiler on a 256 x 256 matrix (its column step is the same ops at any
    n).  Returns ({label: counts} of svdvals, of svd)."""
    from svdsolver_tpu_torch import svd, svdvals
    from svdsolver_tpu_torch.models import complex_svd

    t0 = time.perf_counter()
    rng = np.random.default_rng(19)

    def cmatrix(n):
        return torch.from_numpy(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).to(
            DEV, torch.complex64)

    S = cmatrix(256)
    per_col = {}
    for name, red in (("golub-kahan", complex_svd._gk_c), ("blocked", complex_svd._blocked_c)):
        for uv in (False, True):
            red(S, uv=uv)  # warm
            per_col[name, uv] = kernel_launches(lambda: red(S, uv=uv)) / 256
        say(f"[complex] {name} reduction: {per_col[name, False]:.1f} launches a column, "
            f"{per_col[name, True]:.1f} with the factors (profiler, n = 256)")
    counts_vals, counts_svd = {}, {}
    for n in COMPLEX_SIZES:
        A = cmatrix(n)
        red = "golub-kahan" if n < complex_svd.GK_MAX else "blocked"
        ref = torch.linalg.svdvals(A.to(torch.complex128))
        smax = float(ref[0])
        torch.cuda.synchronize()
        reset_counts()
        s, ms = _event_ms(lambda: svdvals(A))
        c = read_counts()
        counts_vals[f"complex svdvals {n}"] = c
        require(c["bisect"] == 1 and c["panel_qr"] == 0, f"complex svdvals n={n}: K2 alone")
        err = float((s.double() - ref).abs().max()) / smax
        require(s.dtype == torch.float32 and err <= TOL_SIGMA, f"complex svdvals n={n}: sigma")
        lib_ms = cuda_ms(lambda: torch.linalg.svdvals(A), reps=3)
        say(f"[complex] svdvals n={n} complex64 ({red}): {ms:.1f} ms (one run, CUDA events; "
            f"{ms * 1e3 / (n * per_col[red, False]):.1f} us a launch), sigma err {err:.3e}; "
            f"torch.linalg.svdvals {lib_ms:.2f} ms")
        torch.cuda.synchronize()
        reset_counts()
        (U, s2, Vh), ms = _event_ms(lambda: svd(A))
        c = read_counts()
        counts_svd[f"complex svd {n}"] = c
        require(c["bisect"] == 1 and c["tridiag_solve"] == 2, f"complex svd n={n}: K2, K9/K10")
        Ud, Vd = U.to(torch.complex128), Vh.to(torch.complex128)
        eye = torch.eye(n, dtype=torch.complex128, device=DEV)
        sig = float((s2.double() - ref).abs().max()) / smax
        recon = float(((Ud * s2.double()) @ Vd - A.to(torch.complex128)).abs().max()) / smax
        orth = max(float((Ud.mH @ Ud - eye).abs().max()), float((Vd @ Vd.mH - eye).abs().max()))
        require(sig <= TOL_SIGMA and recon <= TOL_RECON and orth <= TOL_ORTH,
                f"complex svd n={n}: sigma {sig:.3e}, recon {recon:.3e}, unitarity {orth:.3e}")
        lib_ms = cuda_ms(lambda: torch.linalg.svd(A, full_matrices=False), reps=1)
        say(f"[complex] svd n={n} complex64 ({red}): {ms:.1f} ms (one run, CUDA events), "
            f"sigma err {sig:.3e}, |U S Vh - A| / sigma_max {recon:.3e}, unitarity {orth:.3e}; "
            f"torch.linalg.svd {lib_ms:.2f} ms")
        del A, U, Vh, Ud, Vd, eye
        torch.cuda.empty_cache()
    say(f"[done] phase_complex {time.perf_counter() - t0:.1f} s")
    return counts_vals, counts_svd


def phase_cli():
    """``python -m svdsolver_tpu_torch`` on the card, through ``cli.main``:
    each of CLI_RUNS with the counts set to 0 before and read after (the
    tpu2 runs: K1, the routed chase, K2 for check).  Returns {label:
    counts} of the tpu2 runs."""
    from svdsolver_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    counts = {}
    for label, argv in CLI_RUNS:
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        c = read_counts()
        text = buf.getvalue()
        for line in text.splitlines():
            if line.strip():
                say(f"[cli] {label}: {line.strip()}")
        require(rc == 0, f"cli {label}: exit code {rc}")
        if argv[0] == "check":
            require("CHECK PASSED" in text, f"cli {label}: CHECK PASSED")
        if "tpu2" in argv:
            chase = sum(c[k] for k in ("band_chase", "band_chase_staged", "band_chase_wave",
                                       "band_chase_wave_l2"))
            require(c["panel_qr"] > 0 and chase > 0, f"cli {label}: K1 and the chase launched")
            if argv[0] == "check":
                require(c["bisect"] == 1, f"cli {label}: K2 launched")
            counts[f"cli {label}"] = c
            say(f"[cli] {label}: launches {c}")
    say(f"[done] phase_cli {time.perf_counter() - t0:.1f} s")
    return counts


def phase_sbr():
    """``band_to_bidiagonal_sbr`` at SBR_CASE on the band of the panel
    kernel's Stage I: the block sweep (torch ops) and the routed chase
    kernel at mid, the counts set to 0 before and read after; sigma against
    float64; the routed chase timed alone at mid and at the full band on
    the panel kernel's bands of those widths (the chase's time is its
    schedule's, not its data's), the block sweep the rest of the run.
    Returns {label: counts}."""
    from svdsolver_tpu_torch.models.sbr import band_to_bidiagonal_sbr
    from svdsolver_tpu_torch.models.svd import routed_chase
    from svdsolver_tpu_torch.ops.cuda import panel_qr

    t0 = time.perf_counter()
    n, b, mid = SBR_CASE
    A = uniform_matrix(n, seed=20)
    Ab = panel_qr.dense_to_band_fused(A, band=b)
    torch.cuda.synchronize()
    reset_counts()
    (d, e), ms = _event_ms(lambda: band_to_bidiagonal_sbr(Ab, band=b, mid=mid))
    c = read_counts()
    chase = {k: c[k] for k in ("band_chase", "band_chase_staged", "band_chase_wave",
                               "band_chase_wave_l2") if c[k]}
    require(sum(chase.values()) == 1 and c["panel_qr"] == 0 and c["bisect"] == 0,
            f"sbr: one routed chase launch at mid ({chase})")
    ref = torch.linalg.svdvals(A.double())
    err = float((bidiag_sigma(d, e) - ref).abs().max() / ref[0])
    require(err <= TOL_SIGMA, f"sbr sigma error {err:.3e}")
    Am = panel_qr.dense_to_band_fused(A, band=mid)
    mid_ms = cuda_ms(lambda: routed_chase(Am, mid), reps=3)
    full_ms = cuda_ms(lambda: routed_chase(Ab, b), reps=3)
    say(f"[sbr] n={n} band {b} -> {mid}: {ms:.1f} ms (one run, CUDA events) = the block sweep "
        f"(torch ops) ~{ms - mid_ms:.1f} ms + the routed chase at {mid} {mid_ms:.3f} ms "
        f"({', '.join(chase)}); the routed chase at {b} alone {full_ms:.3f} ms; sigma err "
        f"{err:.3e}")
    say(f"[done] phase_sbr {time.perf_counter() - t0:.1f} s")
    return {f"sbr {n}": c}


# ---- the sharded entries (parallel/): ranks sharing the card over gloo ----

def _world_values(mesh, values):
    """``values`` (a list of floats) of every rank, gathered over both
    axes: a list a rank, in rank order."""
    v = torch.tensor([values], dtype=torch.float64)
    v = mesh.all_gather(v, "tp", dim=0)
    return mesh.all_gather(v[None], "dp", dim=0).reshape(-1, len(values)).tolist()


def _par_run(mesh, fn):
    """``fn()`` on every rank of ``mesh`` at once, from a barrier, every
    plain version forbidden and the launch counts set to 0 just before:
    ``(result, seconds on this rank, every rank's counts, this rank's
    collective stats)``."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()
    mesh.reset_stats()
    with forbid_plain():
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
    keys = sorted(counts)
    rows = _world_values(mesh, [float(counts[k]) for k in keys])
    return out, sec, [dict(zip(keys, map(int, r))) for r in rows], mesh.stats()


def _par_collectives(mesh):
    """Every collective of the mesh on CUDA tensors over ``tp``, each
    result checked on every rank (gloo's own CUDA path for psum, pmax,
    all_gather and psum_scatter; ppermute staged)."""
    tp, me = mesh.shape["tp"], mesh.axis_index("tp")
    x = torch.arange(8, dtype=torch.float32, device=mesh.device) + 10 * me
    base = torch.arange(8, dtype=torch.float32)
    total = sum(base + 10 * r for r in range(tp))
    got = {"psum": (mesh.psum(x, "tp"), total),
           "pmax": (mesh.pmax(x, "tp"), base + 10 * (tp - 1)),
           "all_gather": (mesh.all_gather(x, "tp"), torch.cat([base + 10 * r for r in range(tp)])),
           "psum_scatter": (mesh.psum_scatter(x, "tp"), total[me * 8 // tp:(me + 1) * 8 // tp]),
           "ppermute": (mesh.ppermute(x, "tp", [(i, (i + 1) % tp) for i in range(tp)]),
                        base + 10 * ((me - 1) % tp))}
    for k, (g, w) in got.items():
        require(g.device == x.device and torch.equal(g.cpu(), w),
                f"rank {mesh.rank}: {k} on {x.device}")
    return sorted(got)


def parallel_rank(mesh, inp):
    """The sharded entries on one rank of a (1, 4) mesh whose ranks share
    the card, then on a (2, 2) mesh of the same ranks (``phase_parallel``
    has the list) on the matrices of PAR_SEEDS, made on each rank (``inp``:
    the float64 references); the gates on rank 0.  Returns rank 0's
    {label: numbers}."""
    from svdsolver_tpu_torch.parallel import (make_mesh, svd_jacobi_sharded, svd_sharded,
                                              svdvals_batch_sharded, svdvals_sharded)

    require("jax" not in sys.modules, "a rank imported jax")
    dev = mesh.device
    out = {"collectives": _par_collectives(mesh)}
    n, b = PAR_VALS
    A, A1, Aj, As = par_inputs()
    ref = torch.from_numpy(inp["ref"]).to(dev)

    def record(label, res, extra):
        _, sec, counts, stats = res
        out[label] = {"s": sec, "counts": counts, "stats": stats, **extra}

    res = _par_run(mesh, lambda: svdvals_sharded(A, mesh, band=b))
    err = float((res[0].double() - ref).abs().max() / ref[0])
    record(f"svdvals_sharded n={n} b={b} tp=4", res, {"sigma": err})
    res = _par_run(mesh, lambda: svd_sharded(A, mesh, band=b))
    U, sv, Vh = res[0]
    gates = {}
    if mesh.rank == 0:
        Ud, Vd, sd = U.double(), Vh.double(), sv.double()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        gates = {"sigma": float((sd - ref).abs().max() / ref[0]),
                 "recon": float((Ud * sd @ Vd - A.double()).abs().max() / ref[0]),
                 "orth U": float((Ud.T @ Ud - eye).abs().max()),
                 "orth Vh": float((Vd @ Vd.T - eye).abs().max())}
        del Ud, Vd, eye
    del U, Vh
    record(f"svd_sharded n={n} b={b} tp=4", res, gates)
    n1, b1 = PAR_PIPE
    ref1 = torch.from_numpy(inp["ref1"]).to(dev)
    res = _par_run(mesh, lambda: svdvals_sharded(A1, mesh, band=b1, stage2="pipelined"))
    record(f"svdvals_sharded pipelined n={n1} b={b1} tp=4", res,
           {"sigma": float((res[0].double() - ref1).abs().max() / ref1[0])})
    out["superstep"] = _superstep_checked(mesh, A1)
    res = _par_run(mesh, lambda: svd_jacobi_sharded(Aj, mesh))
    record(f"svd_jacobi_sharded n={PAR_JACOBI} tp=4", res,
           jacobi_gates("svd_jacobi_sharded", Aj, *res[0]) if mesh.rank == 0 else {})

    mesh2 = make_mesh(4, dp=2, device=dev)
    B, nb, bb = PAR_BATCH
    refb = torch.from_numpy(inp["refb"]).to(dev)
    res = _par_run(mesh2, lambda: svdvals_batch_sharded(As, mesh2, band=bb))
    record(f"svdvals_batch_sharded ({B}, {nb}) b={bb} dp=2 tp=2", res,
           {"sigma": float(((res[0].double() - refb).abs() / refb[:, :1]).max())})

    require("jax" not in sys.modules, "a rank imported jax")
    return out


def _superstep_checked(mesh, A1):
    """The pipelined entry at PAR_PIPE once more on ``mesh`` (tp = 4, as
    in the run that counts), outside the counted run, with each rank's
    kernel pass at three of its groups held against the plain version on
    the buffer the path hands it: group 0, the group after the sweeps' top
    windows enter the rank's rows, and the last group whose top windows
    lie in them.  Rank 0 times both on its group 0 pass (while the other
    ranks wait in the exchange).  Returns every rank's [abs err, err / max
    |L|] at the three groups, the geometry, and rank 0's times and work."""
    import torch.distributed as dist

    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr
    from svdsolver_tpu_torch.parallel import band_to_bidiagonal_pipelined
    from svdsolver_tpu_torch.parallel.distributed import pipeline_geometry

    n1, b1 = PAR_PIPE
    geo = pipeline_geometry(n1, b1, mesh.shape["tp"])
    R0 = mesh.axis_index("tp") * geo.m
    groups = (0, R0 // geo.LG + 1, min(geo.NG - 1, (R0 + geo.m - 1) // geo.LG))
    kernel, plain = band_chase.superstep, band_chase.superstep_plain
    errs, out = {}, {"geometry": geo._asdict()}

    def checked(L, *args):
        g = args[2] // geo.LG
        if g in groups and g not in errs:
            L0 = L.clone()
            Lp = plain(L0.clone(), *args)
            if g == 0 and mesh.rank == 0:
                Lw = L0.clone()
                out["ms"] = fresh_ms(lambda: kernel(Lw, *args), lambda: Lw.copy_(L0))
                out["plain_ms"] = fresh_ms(lambda: plain(Lw, *args), lambda: Lw.copy_(L0),
                                           reps=3)
                out["work"] = work_superstep(*args, geo.Np)
                out["args"] = args
            kernel(L, *args)
            err = float((L - Lp).abs().max())
            errs[g] = [err, err / float(L0.abs().max())]
            return L
        return kernel(L, *args)

    Ab1 = panel_qr.dense_to_band_fused(A1, band=b1)
    torch.cuda.synchronize()
    dist.barrier()
    band_chase.superstep = checked
    try:
        band_to_bidiagonal_pipelined(Ab1, mesh, band=b1)
    finally:
        band_chase.superstep = kernel
    torch.cuda.synchronize()
    require(all(g in errs for g in groups), f"rank {mesh.rank}: passes {groups} not all run")
    rows = _world_values(mesh, [x for g in groups for x in errs[g]])
    out["errs"] = [[r[2 * k: 2 * k + 2] for k in range(len(groups))] for r in rows]
    out["groups"] = _world_values(mesh, [float(g) for g in groups])
    return out


def par_inputs():
    """The matrices of ``phase_parallel`` on the card, from PAR_SEEDS: A
    (PAR_VALS), A1 (PAR_PIPE), Aj (PAR_JACOBI) and the batch As
    (PAR_BATCH), each rank making its own."""
    s, s1, sj, sb = PAR_SEEDS
    B, nb, _ = PAR_BATCH
    As = np.random.default_rng(sb).uniform(0, 5, (B, nb, nb)).astype(np.float32)
    return (uniform_matrix(PAR_VALS[0], seed=s), uniform_matrix(PAR_PIPE[0], seed=s1),
            uniform_matrix(PAR_JACOBI, seed=sj), torch.from_numpy(As).to(DEV))


def work_superstep(n, b, i0, LG, R0, U, m, last, s_chase, Np):
    """One rank's pass of the pipelined chase: each pair's flops as
    ``work_chase`` counts them; bytes: the band entries (b + 1 a row) of
    the rows its windows touch, read once and written once."""
    from svdsolver_tpu_torch.ops.chase_schedule import nc_of_static

    def pair(r0, c0, wr, lr0):
        cols = min(b, n - c0)
        rl = r0 + lr0
        return (3 * b + 4 * min(wr, n - r0) * cols
                + 3 * b + 4 * max(min(b, n - rl), 0) * min(2 * b, n - c0))

    flops, rows = 0, set()
    for l in range(LG):
        i = i0 + l
        if i > n - 2:
            break
        lo = R0 - 3 * b * l
        hi = Np if last else R0 + m - 3 * b * l
        if lo <= i < hi:
            flops += pair(i, i + 1, b + 1, 1)
            rows.update(range(i, min(i + b + 1, n)))
        k0 = max(0, (lo - i - 1 + b - 1) // b)
        for k in range(k0, min(k0 + s_chase, nc_of_static(i, n, b))):
            r = i + 1 + k * b
            if r >= hi:
                break
            flops += pair(r, r + b, 2 * b, b)
            rows.update(range(r, min(r + 2 * b, n)))
    return flops, 2 * 4 * len(rows) * (b + 1)


def phase_parallel():
    """The sharded entries (``svdsolver_tpu_torch/parallel``) on ranks that
    share the one card over gloo, in one spawn of 4 ranks: every
    collective on CUDA tensors checked on every rank; ``svdvals_sharded``
    and ``svd_sharded`` at PAR_VALS on tp = 4 (sigma against float64
    LAPACK, reconstruction and orthogonality, TOL_PAR); the pipelined
    ``svdvals_sharded`` at PAR_PIPE on tp = 4 (the superstep kernel);
    ``svd_jacobi_sharded`` at PAR_JACOBI on tp = 4 (``jacobi_gates``); then
    on a (2, 2) mesh ``svdvals_batch_sharded`` at PAR_BATCH.  Between the
    pipelined and the Jacobi entries, the pipelined entry runs once more,
    uncounted, with the superstep kernel held against its plain version on
    the buffers it is handed at three passes of every rank
    (``_superstep_checked``).  Each entry runs from a barrier with every
    plain version forbidden and the counts set to 0 on every rank
    (``_par_run``); the
    counts of every rank show its kernels.  Then the superstep kernel at
    tp = 1 (a one-rank group here) bit-equal to the L2 kernel
    (``svdt_band_chase``) at PAR_PIPE for each group size of PAR_BITS_LG,
    and ``dryrun(4)``.  Each entry's wall time stands beside the one-rank
    port entry at the same shape, with the collectives' share (rank 0's
    host seconds in them).  Returns (counts_vals, counts_svd, the
    superstep row's numbers)."""
    from svdsolver_tpu_torch import svd, svdvals, svdvals_batch
    from svdsolver_tpu_torch.ops.cuda import band_chase, panel_qr
    from svdsolver_tpu_torch.parallel import band_to_bidiagonal_pipelined, dryrun, spawn
    from svdsolver_tpu_torch.parallel.mesh import single_rank

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n, b = PAR_VALS
    n1, b1 = PAR_PIPE
    B, nb, bb = PAR_BATCH
    A, A1, Aj, As = par_inputs()
    Ab1 = panel_qr.dense_to_band_fused(A1, band=b1)
    inp = {"ref": torch.linalg.svdvals(A.double()), "ref1": torch.linalg.svdvals(A1.double()),
           "refb": torch.linalg.svdvals(As.double())}
    inp = {k: v.cpu().numpy() for k, v in inp.items()}
    one = {  # the one-rank port entry at each shape (CUDA events, median)
        f"svdvals_sharded n={n} b={b} tp=4": cuda_ms(lambda: svdvals(A, block=b), reps=3),
        f"svd_sharded n={n} b={b} tp=4": cuda_ms(lambda: svd(A, band=b), reps=1, warm=False),
        f"svdvals_sharded pipelined n={n1} b={b1} tp=4":
            cuda_ms(lambda: svdvals(A1, block=b1), reps=3),
        f"svd_jacobi_sharded n={PAR_JACOBI} tp=4":
            cuda_ms(lambda: svd(Aj, method="jacobi"), reps=1, warm=False),
        f"svdvals_batch_sharded ({B}, {nb}) b={bb} dp=2 tp=2":
            cuda_ms(lambda: svdvals_batch(As, block=bb), reps=3),
    }
    panels = {  # label -> (matrices on rank 0, panel steps a matrix)
        f"svdvals_sharded n={n} b={b} tp=4": (1, n // b),
        f"svd_sharded n={n} b={b} tp=4": (1, n // b),
        f"svdvals_batch_sharded ({B}, {nb}) b={bb} dp=2 tp=2": (B // 2, nb // bb)}
    ts = time.perf_counter()
    par = spawn(parallel_rank, 4, dp=1, args=(inp,), timeout=900)
    spawn_s = time.perf_counter() - ts
    say(f"[parallel] collectives on CUDA tensors, every rank: {par['collectives']} correct")
    counts_vals, counts_svd = {}, {}
    for label, r in par.items():
        if not isinstance(r, dict) or "counts" not in r:
            continue
        if "sigma" in r and not label.startswith("svd_jacobi"):
            require(r["sigma"] <= TOL_PAR, f"{label}: sigma {r['sigma']:.3e}")
        if label.startswith("svd_sharded"):
            for k in ("recon", "orth U", "orth Vh"):
                require(r[k] <= TOL_PAR, f"{label}: {k} {r[k]:.3e}")
        total = {k: sum(c[k] for c in r["counts"]) for k in r["counts"][0]}
        plain = [k for k in ("plain_diag_loops",) if total[k]]
        require(not plain, f"{label}: a plain loop ran: {plain}")
        c0 = r["counts"][0]
        chase = {k: c0[k] for k in CHASES if c0[k]}
        if label in panels:  # K1 twice a panel step, the routed chase and K2 once a matrix
            mats, steps = panels[label]
            require(c0["panel_qr"] == 2 * mats * steps and c0["bisect"] == mats
                    and sum(chase.values()) == mats, f"{label}: rank 0's kernels: {c0}")
        if label.startswith("svd_sharded"):
            require(c0["tridiag_solve"] >= 1, f"{label}: the TGK solve ran: {c0}")
        if "pipelined" in label:
            require(all(c["band_chase_superstep"] > 0 for c in r["counts"])
                    and c0["panel_qr"] == 2 * n1 // b1 and c0["bisect"] == 1 and not chase,
                    f"{label}: every rank's passes on the superstep kernel: {r['counts']}")
        coll = sum(v["seconds"] for v in r["stats"].values())
        moved = sum(v["bytes"] for v in r["stats"].values())
        staged = sum(v["staged_bytes"] for v in r["stats"].values())
        calls = sum(v["calls"] for v in r["stats"].values())
        gates = ", ".join(f"{k} {r[k]:.3e}" for k in ("sigma", "recon", "orth U", "orth Vh",
                                                      "orth") if k in r)
        say(f"[parallel] {label}: {1e3 * r['s']:.1f} ms on rank 0 (host clock, from a barrier) "
            f"vs {one[label]:.1f} ms for the one-rank entry; collectives {calls} calls, "
            f"{moved / 1e6:.2f} MB ({staged / 1e6:.2f} MB staged through host), "
            f"{100 * coll / r['s']:.1f}% of the time; {gates}; rank 0 launches "
            f"{ {k: v for k, v in c0.items() if v} }")
        r["one_rank_ms"] = one[label]
        side = counts_svd if label.startswith("svd") and "svdvals" not in label else counts_vals
        side[label] = total
    sup = par["superstep"]
    geo = sup["geometry"]
    rel = [e[1] for r in sup["errs"] for e in r]
    require(max(rel) <= TOL_SUPERSTEP, f"superstep kernel vs plain on the path's passes: "
            f"{sup['errs']}")
    b_ms, b_by = bound(*sup["work"])
    say(f"[parallel] superstep kernel vs plain on the pipelined entry's passes at n={n1} b={b1} "
        f"tp={geo['tp']} (m={geo['m']}, LG={geo['LG']}, U={geo['U']}), groups "
        f"{[[int(g) for g in r] for r in sup['groups']]} a rank: [abs, / max |L|] "
        f"{sup['errs']}; rank 0's group 0 pass {sup['ms']:.4f} ms, plain "
        f"{sup['plain_ms']:.3f} ms, bound {b_ms:.6f} ms ({b_by})")
    bits = {}
    d0, e0 = band_chase.band_to_bidiagonal_l2(Ab1, band=b1)
    for lg in PAR_BITS_LG:
        with single_rank() as mesh:
            reset_counts()
            d, e = band_to_bidiagonal_pipelined(Ab1, mesh, band=b1, sweeps_per_group=lg)
            torch.cuda.synchronize()
            launches = read_counts()["band_chase_superstep"]
        require(torch.equal(d, d0) and torch.equal(e, e0) and launches > 0,
                f"superstep kernel at tp=1, LG={lg}: (d, e) bit-equal to svdt_band_chase")
        bits[str(lg)] = launches
    say(f"[parallel] superstep kernel at tp=1, n={n1} b={b1}: (d, e) bit-equal to "
        f"svdt_band_chase at LG {list(bits)} ({list(bits.values())} launches)")
    td = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        dryrun(4)
    require("dryrun_multichip OK" in buf.getvalue(), "dryrun(4)")
    say(f"[parallel] dryrun(4): {buf.getvalue().strip()} ({time.perf_counter() - td:.1f} s)")
    pipe = par[f"svdvals_sharded pipelined n={n1} b={b1} tp=4"]
    row = {"ms": sup["ms"], "plain_ms": sup["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": max(e[0] for r in sup["errs"] for e in r),
           "launches": sum(c["band_chase_superstep"] for c in pipe["counts"]),
           "shape": f"rank 0's group 0 pass of the pipelined entry, n={n1} b={b1} "
                    f"tp={geo['tp']} (LG={geo['LG']})",
           "path_launches": [c["band_chase_superstep"] for c in pipe["counts"]],
           "bits_tp1_launches": bits}
    say(f"[done] phase_parallel {time.perf_counter() - t0:.1f} s (the spawn of 4 ranks "
        f"{spawn_s:.1f} s)")
    return counts_vals, counts_svd, row


def parallel_rows(row):
    """The kernel line's row of the superstep kernel: no TPU kernel (the JAX
    package runs the pass as XLA windows); ms and its plain version on rank
    0's group 0 pass of the pipelined entry (tp = 4), launches from that
    entry's counted run."""
    return [{"name": "band_chase_superstep", "route": "cuda",
             "source": "svdsolver_tpu_torch/csrc/band_chase.cu",
             "replaces": "none: XLA windows of svdsolver_tpu/parallel/distributed.py:352-392",
             "tpu": [], "library_ms": None, **row}]


def wide_rows(errs, times, counts):
    """The kernel line's rows of the wide instances: launches from
    phase_wide's entry runs."""
    src = "svdsolver_tpu_torch/csrc/{}.cu"
    total = {k: sum(c[k] for c in counts.values()) for k in next(iter(counts.values()))}
    rows = []
    b, m, r_off = WIDE_K1_TIME
    k_ms, p_ms, lib_ms = times["k1"]
    bnd = bound(*work_panel_qr(b, m, r_off))
    rows.append({
        "name": "panel_qr_wide", "route": "cuda", "source": src.format("panel_qr"),
        "replaces": "svdsolver_tpu/ops/pallas/panel_qr.py:30", "tpu": ["K1"],
        "launches": total["panel_qr"], "max_abs_err": errs["panel_qr_wide"], "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
        "shape": f"b={b} m={m}", "instance": "b > 256: 2 lanes a row (1 past 512), T in "
                                            "device memory"})
    for name, key, record, kernel, tpu, repl in (
            ("band_chase_wide", "l2", False, "band_chase", ["K3", "K5"],
             "svdsolver_tpu/ops/pallas/band_chase.py:331 + band_chase_stream.py:118"),
            ("band_chase_rec_wide", "l2_rec", True, "band_chase", ["K6", "K8"],
             "svdsolver_tpu/ops/pallas/band_chase.py:191 + band_chase_stream.py:118 (rec=True)"),
            ("band_chase_wave_wide", "wave", False, "band_chase_wave", ["K4", "K13"],
             "svdsolver_tpu/ops/pallas/band_chase.py:676 + band_chase_wave.py:687"),
            ("band_chase_wave_rec_wide", "wave_rec", True, "band_chase_wave", ["K7"],
             "svdsolver_tpu/ops/pallas/band_chase_wave.py:959")):
        n, bw = WIDE_CHASE_TIME
        tm = times["chase"][n, bw]
        bnd = bound(*work_chase(n, bw, record))
        count = {"band_chase_wide": "band_chase", "band_chase_rec_wide": "band_chase_rec",
                 "band_chase_wave_wide": "band_chase_wave_l2",
                 "band_chase_wave_rec_wide": "band_chase_wave_rec_l2"}[name]
        rows.append({
            "name": name, "route": "cuda", "source": src.format(kernel), "replaces": repl,
            "tpu": tpu, "launches": sum(c[count] for lbl, c in counts.items()
                                        if int(lbl.split("block=")[1]) > 256),
            "max_abs_err": errs[name], "ms": tm[key],
            "plain_ms": tm["plain_rec" if record else "plain"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None, "shape": f"n={n} b={bw}",
            "instance": "the wide pair of chase_pair.cuh (b > 256)",
            "designs_ms": {f"n={n_} b={b_}": v for (n_, b_), v in times["chase"].items()}})
    n, t = WIDE_TILED[1]
    tm = times["tiled"][n, t]
    for name, part, lib in (("tiled_wide_chain", "chain", "geqrf_ms"),
                            ("tiled_wide_apply", "apply", "ormqr_ms")):
        bnd = tm[f"{part}_bound"]
        rows.append({
            "name": name, "route": "cuda", "source": src.format("tiled_wide"),
            "replaces": ("svdsolver_tpu/models/tiled.py:59 + :72 (the lax.fori_loop of "
                         "_slab_factor_step :33, no Pallas kernel)"),
            "tpu": [], "launches": total[name], "max_abs_err": errs[name],
            "ms": tm[f"{part}_ms"], "plain_ms": tm[f"{part}_plain_ms"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": tm[lib],
            "shape": f"2-slab half-sweep n={n} t={t} (top = n - 2t)",
            "dense_to_band_tiled_ms": {f"n={n_} t={t_}": v["stage1_ms"]
                                       for (n_, t_), v in times["tiled"].items()}})
    return rows


def diag_rows(rows, counts_diag):
    """The kernel line's rows of the two diagonalizers: no TPU kernel, each
    the counterpart of an XLA-compiled loop; ms, plain ms, library ms,
    bound and chain bound at n = 64 float32 (where the plain version runs),
    the path's at DIAG_SIZES in float32 and float64 (``path_*``), the
    chains' ns a step (``chain_ns``)."""
    src = "svdsolver_tpu_torch/csrc/{}.cu"
    replaces = {
        "bidiag_qr": "svdsolver_tpu/models/diagonalize.py:186 (the lax.while_loop of "
                     "_qr_diag_chunk; the sweeps :27, :145, :68 and the threshold :80)",
        "dqds": "svdsolver_tpu/models/diagonalize.py:280 (the lax.while_loop of "
                "dqds_svdvals at :958)",
    }
    from svdsolver_tpu_torch.ops.cuda import bidiag_qr, dqds

    out = []
    for k in ("bidiag_qr", "dqds"):
        r = dict(rows[k])
        b_ms, b_by = bound(*r.pop("work"))
        steps, ns = r.pop("steps"), r["chain_ns"]
        r["chain_bound_ms"] = (
            bidiag_qr.chain_bound_ms(*steps, ns["zero float32"], ns["shifted float32"])
            if k == "bidiag_qr" else dqds.chain_bound_ms(steps, ns["float32"]))
        out.append({
            "name": k, "route": "cuda", "source": src.format(k), "replaces": replaces[k],
            "tpu": [], "launches": sum(c[k] for c in counts_diag.values()),
            "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
            "plain_ms": r.pop("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r.pop("library_ms"),
            "shape": f"n={DIAG_CHECK[-1]} float32", **r,
        })
    return out


# the TPU kernels (K1-K15 of PERF.md) each row's kernel stands for; the
# sequential chase (K3, K5, K6, K8) runs the staged TMA design on the shapes
# the copy engine takes and the L2 kernel on the others
TPU_KERNELS = {
    "panel_qr": ["K1"], "band_chase": ["K3", "K5"], "band_chase_rec": ["K6", "K8"],
    "bisect": ["K2"], "tridiag_solve": ["K9", "K10"],
    "band_chase_wave": ["K4", "K5", "K13"], "band_chase_wave_dl": ["K11"],
    "band_chase_wave_dl_l2": ["K11"],
    "band_chase_staged": ["K3", "K5", "K14", "K15"], "band_chase_vmem": ["K12"],
    "band_chase_vmem_tma": ["K12"],
    "band_chase_staged_rec": ["K6", "K8"],
    "band_chase_wave_rec": ["K7", "K8"], "band_chase_wave_l2": ["K4", "K13"],
    "band_chase_wave_rec_l2": ["K7"],
    # no TPU kernel: the counterparts of XLA-compiled loops
    "bidiag_qr": [], "dqds": [],
}


# which kernel each sequential-chase row runs, and on which shapes
SEQ_KERNEL = {
    "band_chase": "L2 kernel: shapes the staged TMA design does not take; the bitwise oracle",
    "band_chase_rec": "L2 kernel, recording: shapes the staged TMA design does not take",
    "band_chase_staged": "staged TMA design: every shape it takes (all main-path bands)",
    "band_chase_staged_rec": "staged TMA design, recording: every shape it takes",
}


def kernel_table(errs, counts_vals, counts_svd, kt, lib, variants, route, k1, ticks,
                 designs, staged):
    from svdsolver_tpu_torch.models.diagonalize import default_bisect_iters

    counts_var, errs_var, plain_var, times_var, vmem_off, wide = variants
    k2_ms, tgk_ms = designs
    tick_ms, sched, rate = ticks
    src = "svdsolver_tpu_torch/csrc/{}.cu"
    replaces = {
        "panel_qr": "svdsolver_tpu/ops/pallas/panel_qr.py:30",
        "band_chase": "svdsolver_tpu/ops/pallas/band_chase.py:331 "
                      "+ band_chase_stream.py:118",
        "band_chase_rec": "svdsolver_tpu/ops/pallas/band_chase.py:191 "
                          "+ band_chase_stream.py:118 (rec=True)",
        "bisect": "svdsolver_tpu/ops/pallas/bisect.py:44",
        "tridiag_solve": "svdsolver_tpu/ops/pallas/tridiag_solve.py:41 "
                         "+ tridiag_solve.py:124",
    }
    work = {  # the shapes of each kernel's "ms" in kt
        "panel_qr": work_panel_qr(128, 3840, 0),
        "band_chase": work_chase(1024, 64, record=False),
        "band_chase_rec": work_chase(1024, 64, record=True),
        "bisect": work_bisect(1024, default_bisect_iters(torch.float32), 1),
        "tridiag_solve": work_tgk(2 * 3840, 3840),
    }
    rows = []
    svd_side = ("band_chase_rec", "tridiag_solve", "band_chase_wave_rec",
                "band_chase_staged_rec")
    for k in work:
        b_ms, b_by = bound(*work[k])
        # every main-path run of svdvals, or of svd and svds; K2 runs on both
        sides = ((counts_svd,) if k in svd_side else
                 (counts_vals, counts_svd) if k == "bisect" else (counts_vals,))
        launches = sum(c[k] for side in sides for c in side.values())
        say(f"[bound] {k} ({kt[k][2]}): {work[k][0]:.4g} flops, {work[k][1]:.4g} "
            f"bytes -> {b_ms:.4f} ms, bound by {b_by}")
        rows.append({
            "name": k, "route": "cuda",
            "source": src.format("band_chase" if k == "band_chase_rec" else k),
            "replaces": replaces[k], "launches": launches,
            "max_abs_err": errs[k], "ms": kt[k][0], "plain_ms": kt[k][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib.get(k),
            "shape": kt[k][2],
        })
        if k in ("band_chase", "band_chase_rec"):
            side = counts_svd if k in svd_side else counts_vals
            rows[-1]["path_launches"] = {n: c[k] for n, c in side.items()}
    # K2 and K9/K10: each group's and each design's times in turns
    iters = default_bisect_iters(torch.float32)
    row = rows[3]
    row["groups_ms"] = {f"n={n}": {f"G={g}": k2_ms[n, g] for g in GROUPS}
                        for n in DESIGN_TIMES}
    row["earlier_design_ms"] = {f"n={n}": k2_ms[n, 1] for n in DESIGN_TIMES}
    row["path_ms"] = min(v for (n, g), v in k2_ms.items() if n == 3840 and g > 1)
    row["path_bound_ms"] = bound(*work_bisect(3840, iters, 1))[0]
    row["path_launches"] = {f"svdvals {n}": c["bisect"] for n, c in counts_vals.items()}
    row["path_launches"].update({n if isinstance(n, str) else f"svd {n}": c["bisect"]
                                 for n, c in counts_svd.items()})
    row = rows[4]
    row["staged_ms"] = {f"n={n}": tgk_ms[n][0] for n in DESIGN_TIMES}
    row["earlier_design_ms"] = {f"n={n}": tgk_ms[n][1] for n in DESIGN_TIMES}
    rows[0]["widths"] = {  # K1 at each Stage I panel length of n = 3840,
        # and the first panels at SCALE_VALS
        m: {"ms": km, "plain_ms": pm, "library_ms": lm,
            "bound_ms": bound(*work_panel_qr(128, m, 0))[0]}
        for m, (km, pm, lm) in k1.items()}
    at_path = {  # where the ms above were taken at a smaller n
        "band_chase": work_chase(3840, 128, record=False),
        "band_chase_rec": work_chase(3840, 128, record=True),
        "bisect": work_bisect(3840, iters, 1),
    }
    for k, w in at_path.items():
        b_ms, b_by = bound(*w)
        say(f"[bound] {k} at the path's n=3840: {w[0]:.4g} flops, {w[1]:.4g} "
            f"bytes -> {b_ms:.4f} ms, bound by {b_by}")

    # the chase variants: the chase's work
    replaces.update({
        "band_chase_wave": "svdsolver_tpu/ops/pallas/band_chase.py:676 "
                           "+ band_chase_wave.py:687",
        "band_chase_wave_dl": "svdsolver_tpu/ops/pallas/band_chase_wave.py:581",
        "band_chase_staged": "svdsolver_tpu/ops/pallas/band_chase.py:331 "
                             "+ band_chase.py:405 + band_chase.py:541 "
                             "+ band_chase_stream.py:118",
        "band_chase_vmem_tma": "svdsolver_tpu/ops/pallas/band_chase_vmem.py:180",
    })
    (n1, b1, _), (n3, b3, _) = VAR_CHECK, VAR_PATH
    for k in VARIANTS:
        bounds = {}
        for label, n, b in (("check", n1, b1), ("path", n3, b3)):
            flops, nbytes = work_chase(n, b, record=False)
            bounds[label] = bound(flops, nbytes)
            say(f"[bound] {k} (n={n} b={b}): {flops:.4g} flops, {nbytes:.4g} "
                f"bytes -> {bounds[label][0]:.4f} ms, bound by {bounds[label][1]}")
        on_path = k in ("band_chase_wave", "band_chase_staged")
        rows.append({
            "name": k, "route": "cuda",
            "source": src.format({"band_chase_wave_dl": "band_chase_wave",
                                  "band_chase_vmem_tma": "band_chase_staged"}.get(k, k)),
            "replaces": replaces[k],
            "launches": (sum(c[k] for c in counts_vals.values()) if on_path
                         else counts_var[k]),
            "max_abs_err": errs_var[k], "ms": times_var[k, "check"],
            # the staged kernel's plain version is the plain chase
            "plain_ms": (kt["band_chase"][1] if k == "band_chase_staged"
                         else plain_var[k]),
            "bound_ms": bounds["check"][0], "bound_by": bounds["check"][1],
            "library_ms": None, "shape": f"n={n1} b={b1}",
            "path_shape": f"n={n3} b={b3}", "path_ms": times_var[k, "path"],
            "path_bound_ms": bounds["path"][0],
            "band_chase_path_ms": times_var["band_chase", "path"],
        })
        if k == "band_chase_staged":
            rows[-1].update(staged_keys(staged, rate, record=False))
        if k == "band_chase_vmem_tma":
            rows[-1].update(vmem_keys(times_var, rate))
        if k == "band_chase_wave_dl":
            rows[-1].update(dl_keys(times_var, rate))
        if on_path:
            rows[-1]["variant_launches"] = counts_var[k]
            rows[-1]["path_launches"] = {n: c[k] for n, c in counts_vals.items()}
        if k == "band_chase_wave":
            rows[-1].update(tick_keys(tick_ms, sched, rate, record=False))

    # the packed chase's L2 kernel: the bands the copy engine does not take
    # (its launches: the run at VMEM_OFF); ms launched directly at the
    # check band, in turns with the TMA design
    k = "band_chase_vmem"
    b_var = bound(*work_chase(n1, b1, record=False))
    rows.append({
        "name": k, "route": "cuda", "source": src.format(k),
        "replaces": replaces["band_chase_vmem_tma"], "launches": vmem_off[k],
        "launches_shape": f"n={VMEM_OFF[0]} b={VMEM_OFF[1]}",
        "max_abs_err": errs_var[k], "ms": times_var[k, "check"], "plain_ms": plain_var[k],
        "bound_ms": b_var[0], "bound_by": b_var[1], "library_ms": None,
        "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
        "path_ms": times_var[k, "path"],
        "path_bound_ms": bound(*work_chase(n3, b3, record=False))[0],
    })

    # the staged TMA design's recording entry (svd's sequential chase):
    # ms in turns with the L2 recording kernel (phase_sequential_times)
    k = "band_chase_staged_rec"
    b_chk, b_path = (bound(*work_chase(n, b, record=True)) for n, b in ((n1, b1), (n3, b3)))
    rows.append({
        "name": k, "route": "cuda", "source": src.format("band_chase_staged"),
        "replaces": replaces["band_chase_rec"],
        "launches": sum(c[k] for c in counts_svd.values()), "max_abs_err": errs[k],
        "ms": staged[n1, b1, 1, True][0], "plain_ms": kt["band_chase_rec"][1],
        "bound_ms": b_chk[0], "bound_by": b_chk[1], "library_ms": None,
        "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
        "path_ms": staged[n3, b3, 1, True][0], "path_bound_ms": b_path[0],
        "path_launches": {n: c[k] for n, c in counts_svd.items()},
        **staged_keys(staged, rate, record=True),
    })

    # the recording wavefront entry (svd's chase): ms at the check band from
    # the routing evidence, in turns with the sequential recording entry
    k = "band_chase_wave_rec"
    rows.append({
        "name": k, "route": "cuda", "source": src.format("band_chase_wave"),
        "replaces": "svdsolver_tpu/ops/pallas/band_chase_wave.py:959",
        "launches": sum(c[k] for c in counts_svd.values()), "max_abs_err": errs_var[k],
        "ms": route[n1, b1, True][0], "plain_ms": plain_var[k],
        "bound_ms": b_chk[0], "bound_by": b_chk[1], "library_ms": None,
        "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
        "path_ms": route[n3, b3, True][0], "path_bound_ms": b_path[0],
        "band_chase_rec_path_ms": route[n3, b3, True][1],
        "path_launches": {n: c[k] for n, c in counts_svd.items()},
        **tick_keys(tick_ms, sched, rate, record=True),
    })

    # the L2 tick of both entries: off the main paths for b <= 128, kept for
    # wider bands; ms from the ticks in turns at the check band
    b_path_plain = bound(*work_chase(n3, b3, record=False))
    for k, record in (("band_chase_wave_l2", False), ("band_chase_wave_rec_l2", True)):
        b_k = b_chk if record else bound(*work_chase(n1, b1, record=False))
        side = counts_svd if record else counts_vals
        rows.append({
            "name": k, "route": "cuda", "source": src.format("band_chase_wave"),
            "replaces": ("svdsolver_tpu/ops/pallas/band_chase_wave.py:959" if record else
                         replaces["band_chase_wave"]),
            "launches": sum(c[k] for c in side.values()),
            "max_abs_err": errs_var[k], "ms": tick_ms[n1, b1, record][1],
            "plain_ms": plain_var["band_chase_wave_rec" if record else "band_chase_wave"],
            "bound_ms": b_k[0], "bound_by": b_k[1], "library_ms": None,
            "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
            "path_ms": tick_ms[n3, b3, record][1],
            "path_bound_ms": (b_path if record else b_path_plain)[0],
            "variant_launches": counts_var[k],
        })
    # the deferred-left entry's L2 tick: shapes the copy engine does not
    # take (its launches: the run at WIDE_BAND); ms forced at the check band
    # and the path's, in turns with its shared-memory tick
    k = "band_chase_wave_dl_l2"
    b_var = bound(*work_chase(n1, b1, record=False))
    rows.append({
        "name": k, "route": "cuda", "source": src.format("band_chase_wave"),
        "replaces": replaces["band_chase_wave_dl"], "launches": wide[k],
        "launches_shape": f"n={WIDE_BAND[0]} b={WIDE_BAND[1]}",
        "max_abs_err": errs_var[k], "ms": times_var[k, "check"], "plain_ms": plain_var[k],
        "bound_ms": b_var[0], "bound_by": b_var[1], "library_ms": None,
        "shape": f"n={n1} b={b1}", "path_shape": f"n={n3} b={b3}",
        "path_ms": times_var[k, "path"],
        "path_bound_ms": bound(*work_chase(n3, b3, record=False))[0],
    })
    for row in rows:
        row["tpu"] = TPU_KERNELS[row["name"]]
        if row["name"] in SEQ_KERNEL:
            row["kernel"] = SEQ_KERNEL[row["name"]]
    covered = {t for row in rows for t in row["tpu"]}
    require(covered == {f"K{i}" for i in range(1, 16)}, f"the rows cover K1-K15: {covered}")
    return rows


def staged_keys(staged, rate, record):
    """The sequential chase's two kernels in turns, and the staged TMA
    design's schedule bound (the bytes of every copy of ``chase_schedule.
    staged_copies``, the kernel's own order, over one CTA's copy rate), by
    shape; the records' stores are not copies and add nothing to it."""
    from svdsolver_tpu_torch.ops.chase_schedule import staged_copy_bytes

    out = {"designs_ms": {}, "schedule_bound_ms": {}, "window_copy_gb_s": rate / 1e6}
    for (n, b, K, rec), (tma, l2) in staged.items():
        if rec == record:
            out["designs_ms"][f"n={n} b={b} K={K}"] = {"staged_tma": tma, "l2": l2}
    for n, b in sorted({(n, b) for n, b, _, _ in staged}):
        nbytes = staged_copy_bytes(n, b)
        out["schedule_bound_ms"][f"n={n} b={b}"] = nbytes / rate
        say(f"[bound] {'band_chase_staged_rec' if record else 'band_chase_staged'} schedule "
            f"n={n} b={b}: {nbytes:.4g} bytes over {rate / 1e6:.2f} GB/s = "
            f"{nbytes / rate:.3f} ms (staged TMA design K=1 {staged[n, b, 1, record][0]:.3f} "
            "ms)")
    return out


def vmem_keys(times_var, rate):
    """The packed chase's two kernels in turns at the check band and the
    path's, and the TMA design's schedule bound (its copies are the staged
    design's: ``chase_schedule.staged_copy_bytes`` over one CTA's copy
    rate)."""
    from svdsolver_tpu_torch.ops.chase_schedule import staged_copy_bytes

    out = {"designs_ms": {}, "schedule_bound_ms": {}, "window_copy_gb_s": rate / 1e6}
    for label, (n, b, _) in (("check", VAR_CHECK), ("path", VAR_PATH)):
        key = f"n={n} b={b}"
        out["designs_ms"][key] = {"staged_tma_store": times_var["band_chase_vmem_tma", label],
                                  "l2_packed": times_var["band_chase_vmem", label]}
        out["schedule_bound_ms"][key] = staged_copy_bytes(n, b) / rate
        say(f"[bound] band_chase_vmem_tma schedule {key}: {staged_copy_bytes(n, b):.4g} bytes "
            f"over {rate / 1e6:.2f} GB/s = {out['schedule_bound_ms'][key]:.3f} ms (TMA design "
            f"{times_var['band_chase_vmem_tma', label]:.3f} ms, L2 packed kernel "
            f"{times_var['band_chase_vmem', label]:.3f} ms)")
    return out


def dl_keys(times_var, rate):
    """The deferred-left entry's two ticks and the plain entry's
    shared-memory tick in turns at the check band and the path's, and the
    deferred-left tick's schedule bound (its own copies, ``chase_schedule.
    wave_copy_bytes(defer_left=True)``, over one CTA's copy rate)."""
    from svdsolver_tpu_torch.ops.chase_schedule import wave_copy_bytes

    out = {"ticks_ms": {}, "schedule_bound_ms": {}, "window_copy_gb_s": rate / 1e6}
    for label, (n, b, _) in (("check", VAR_CHECK), ("path", VAR_PATH)):
        key = f"n={n} b={b}"
        nbytes = wave_copy_bytes(n, b, defer_left=True)
        out["ticks_ms"][key] = {"smem": times_var["band_chase_wave_dl", label],
                                "l2": times_var["band_chase_wave_dl_l2", label],
                                "plain_smem_tick": times_var["band_chase_wave", label]}
        out["schedule_bound_ms"][key] = nbytes / rate
        say(f"[bound] band_chase_wave_dl schedule {key}: {nbytes:.4g} bytes over "
            f"{rate / 1e6:.2f} GB/s = {nbytes / rate:.3f} ms (shared-memory tick "
            f"{times_var['band_chase_wave_dl', label]:.3f} ms, L2 tick "
            f"{times_var['band_chase_wave_dl_l2', label]:.3f} ms, the plain entry's "
            f"shared-memory tick {times_var['band_chase_wave', label]:.3f} ms)")
    return out


def tick_keys(tick_ms, sched, rate, record):
    """The two ticks of a wavefront entry in turns at TICK_SHAPES, and the
    shared-memory tick's schedule bound."""
    return {
        "ticks_ms": {f"n={n} b={b}": {"smem": tick_ms[n, b, record][0],
                                      "l2": tick_ms[n, b, record][1],
                                      "schedule_bound_ms": sched[n, b]}
                     for n, b in TICK_SHAPES},
        "window_copy_gb_s": rate / 1e6,
    }


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import svdsolver_tpu_torch  # noqa: F401  (fails outside the repository)
    from svdsolver_tpu_torch import svd, svdvals

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the oracles' GEMMs too
    global T_START
    t_start = T_START = time.perf_counter()
    name, _ = phase_device()
    t0 = time.perf_counter()
    phase_build()
    say(f"[build] total {time.perf_counter() - t0:.2f} s")
    errs, band_state = phase_kernels(np.random.default_rng(0))
    clock('phase_kernels')
    diag = check_diag()
    clock('check_diag')
    variants = phase_variants(band_state)
    clock('phase_variants')
    counts_vals = phase_slice()
    counts_svd = phase_svd()
    counts_svd[f"svds {SVDS_CASE[0]}"] = phase_svds()
    clock('phase_slice, phase_svd, phase_svds')
    scale_counts, _, _ = phase_scale()
    for key, c in scale_counts.items():
        if isinstance(key, tuple):
            counts_svd[key[1]] = c
        else:
            counts_vals[key] = c
    clock('phase_scale')
    counts_diag = phase_diag(diag)
    clock('phase_diag')
    phase_linalg()
    clock('phase_linalg')
    t0 = time.perf_counter()
    ladder_vals, ladder_svd, slab_rows = phase_ladder()
    batch_vals, batch_svd = phase_batch()
    say(f"[done] the ladder and the batches {time.perf_counter() - t0:.1f} s")
    wide_errs, wide_times, wide_counts = phase_wide(np.random.default_rng(1))
    clock('phase_wide')
    phase_jacobi()
    clock('phase_jacobi')
    t0 = time.perf_counter()
    phase_robust()
    complex_vals, complex_svd = phase_complex()
    counts_vals.update(complex_vals)
    counts_svd.update(complex_svd)
    counts_vals.update(phase_cli())
    counts_vals.update(phase_sbr())
    say(f"[done] the robustness net, complex, the CLI and SBR {time.perf_counter() - t0:.1f} s")
    par_vals, par_svd, par_row = phase_parallel()
    counts_vals.update(par_vals)
    counts_svd.update(par_svd)
    clock('phase_parallel')
    counts_vals.update(ladder_vals)
    counts_vals.update(batch_vals)
    counts_svd.update(ladder_svd)
    counts_svd.update(batch_svd)
    _, kt, lib, k1 = phase_times(band_state)
    clock('phase_times')
    designs = phase_design_times()
    clock('phase_design_times')
    route = phase_route_times()
    clock('phase_route_times')
    ticks = phase_tick_times(band_state)
    clock('phase_tick_times')
    staged = phase_sequential_times(band_state)
    clock('phase_sequential_times')
    A = uniform_matrix(3840)
    phase_profile("svdvals n=3840", lambda: svdvals(A))
    phase_profile("svd n=3840", lambda: svd(A))
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    rows = kernel_table(errs, counts_vals, counts_svd, kt, lib, variants, route, k1, ticks,
                        designs, staged) + diag_rows(diag, counts_diag) + slab_rows
    rows += wide_rows(wide_errs, wide_times, wide_counts) + parallel_rows(par_row)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
