#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``rcppml_tpu_torch``) on one H100.

    python3 chip_smoke.py [--profile]

It builds the CUDA kernels from ``rcppml_tpu_torch/csrc`` (seven sources, one
``nvcc`` each, started together), holds each against its plain PyTorch twin,
drives the port's main paths through ``rcppml_tpu_torch.nmf`` on a matrix on
the card, and times kernels, twins and fits with CUDA events:

  * the MSE fit with both solvers at the pbmc3k (13,714 x 2,638, k=20) and
    movielens (3,867 x 610, k=50) shapes: the shared-Gram CD NNLS kernel,
    bit for bit against its twin at the main path's shapes and at the edges
    of its lane-group design, and a rank-1 fit that ends finite on the card
    and on the CPU;
  * the IRLS fit at the pbmc3k shape: KL at k=16 for 20 iterations, the same
    with the fused weighted-Gram kernel switched on (``RCPPML_FUSED_WGRAM``),
    and NB with zero inflation per row at k=20 for 5 iterations: the
    per-column-Gram CD NNLS kernel, bit for bit against its twin (the same
    edges), and the fused weight + Gram + RHS kernel (kernel 5's tile, the
    weight formed in a prologue), within 1e-4 of its twin's largest entry
    at every loss and at the edges of its tile;
  * the whole-fit Newton-Schulz ALS (``fused_vmem=True``) at both shapes,
    with float32 and bfloat16 data: the tall-skinny products B = F A and
    B = H A^T within 1e-5 of ``torch.matmul``, the whole-fit kernel within
    1e-4 of its twin after one iteration and within 1e-3 in loss after
    twenty, every half step within 1e-4 also at k=150 (its k x k section in
    a cluster of blocks) and k=257 (in device memory), all three bitwise
    repeatable; and the default loop with
    ``bf16_data=True``, multi-restart, callbacks and ``profile=True``;
  * cross-validated and masked fits at the pbmc3k shape (speckled holdout
    at k=16 with both solvers and with the KL loss, a 10% mask at k=20,
    ``mask="zeros"``, a masked fit at k=128), a rank sweep and ``k="auto"`` on
    a planted-rank matrix: the per-column weighted Gram + RHS kernel within
    2e-5 of its twin's largest entry, the Cholesky solve + clip kernel bit
    for bit its twin on both routes and at the edges of its lane groups,
    and within 1e-4 of ``torch.linalg``, both bitwise repeatable, and the
    holdout mask computed on the card bit for bit the host's;
  * the truncated SVD at the atlas shape (5,000 x 40,000, k=10) on a planted
    matrix: ``rtt.svd`` with ``method="lanczos"``, ``"irlba"`` and
    ``"randomized"`` within 1e-3 of the exact singular values (float64, on
    the card) with orthonormal U and V, timed beside the reference's
    published figures; ``pca``, Krylov with ``nonneg=True`` and deflation
    at the full shape, and the same and a cross-validated SVD on a corner
    card against CPU;
  * the SVD-seeded NMF (``seed="lanczos"`` / ``"irlba"``) at the pbmc3k
    shape, its init within 1e-4 of the CPU port's, the fit through the
    Cholesky kernel; the projections ``nnls`` / ``predict`` through kernels
    6, 1, 2 and 4, each within 1e-4 of the CPU port's and bitwise
    repeatable; the profiled KL fit bit for bit the unprofiled one;
  * rank-2 divisive clustering: one ``bipartition`` at the atlas shape on two
    planted groups, ``dclust`` at the pbmc3k shape on 16 planted groups
    (every split between groups, the leaves recovering them), both bitwise
    repeatable, with the host reads of the rank-2 loop counted, and dclust
    card against CPU on a small planted matrix; ``consensus_nmf`` at the
    pbmc3k shape (k=10, 10 runs, ``"hard"`` and ``"knn_jaccard"``), its
    fits through the Cholesky kernel, labels card against CPU;
    checkpointed MSE (Cholesky and CD), KL and NB + ZI fits bit for bit the
    uninterrupted ones with their launches; ``auto_nmf_distribution`` on the
    counts;
  * out-of-core streaming on two synthetic count matrices written with the
    port's ``st_write`` (the hcabm40k shape, 5,000 x 40,000 at 16.5%, and
    the flagship's rows and density on 20,000 columns, 38,606 x 20,000 at
    5.15%): the codec bit for bit, ``nmf`` of the ``.spz`` path with both
    solvers against the in-memory card fit (the kernel's launches once a
    panel a sweep), the uncached, sparse-panel and checkpointed streams bit
    for bit the cached one, the wire cache within 1e-5 of the uncached
    stream, KL and CV streams through kernel 2, streaming SVD (randomized,
    lanczos, irlba) within 1e-3 of the in-memory SVD and
    ``nnls_streaming`` within 1e-5 of ``nnls``;
  * the FactorNet graph engine at the pbmc3k shape (phase 30): (a) the
    2-layer MSE net k=20 -> k=8, 20 outer sweeps on the card with the
    default solver (kernel 6) and CD (kernel 1), timed, bit for bit across
    two runs, no host read at tol=0, against the same net through the host
    loop and on the CPU; (b) ``nmf([A[:10000], A[10000:]], 20)`` bit for
    bit the stacked fit; (c) a conditioned concat of two branches on the
    fused path; (d) a GP layer under an MSE layer through the host loop
    (kernel 2); (e) ``cross_validate_graph`` (kernel 2); (f) ``predict`` of
    1,000 held-back columns against the CPU port's;
  * the device mesh at the pbmc3k shape (phase 31): (a) the (1, 1) mesh at
    world size 1 over NCCL, bit for bit the plain MSE fits with both
    solvers and their launches; (b) 8 ranks sharing the card over gloo
    (``torch.multiprocessing``, spawn) in a (2, 4) mesh, where 2,638
    columns do not divide by 4: MSE default, CD and ``bf16_data`` at k=20,
    KL and CV at k=16 and a masked fit at k=20, each rank's kernel launches
    checked, every rank's result the same, rank 0's held to the single-card
    fit of the same call (the bfloat16 and KL fits to the single-card fit
    with its sums made in the mesh's order, ``tests/torch_mesh_order.py``:
    over 20 iterations a last-bit change of a sum's order grows past the
    bars, on one card too), the wall clock and each rank's device time
    printed; the twin phases hold kernels 6, 1, 2, 7 and 8 at the ranks'
    block shapes;
  * the mesh's three consumers on phase 31's ranks and mesh (phase 32):
    (a) checkpointed mesh fits at the pbmc3k shape (MSE default, CD and
    ``bf16_data`` k=20, KL k=16, NB + ZI by row k=20), each stopped at
    half its iterations and resumed from its file, bit for bit the
    uninterrupted mesh fit with the same launches on every rank; (b)
    sharded streams of phase 26's (i) (MSE k=20 over 20 sweeps, CV k=16
    over 5), every rank reading the file with its own loader, held to
    phase 27's single-card streams; (c) phase 30's nets (a) and (c) on the
    mesh, held to phase 30's single-card nets; each path's slowest-rank
    wall, device time a rank, host decode a rank and sweep and the bytes
    through the collectives printed.

Each phase prints its own lines and any failure raises, so the exit code is
non-zero.  There is no CPU fallback: without a CUDA card of compute
capability 9.0 it fails.

The second line from the end is one JSON object about the kernels; the last
line is ``{"ok": true, "device": {...}}``.  The matrices are synthetic and
seeded (``simulate_nmf``, ``pbmc_counts``), with the shapes and the share
of zeros of the real data sets.  Imports no JAX.

With ``--profile`` it builds the kernels and then, instead of the phases
above, runs the same fits once each under ``torch.profiler`` and prints
where each fit's time goes: wall time, summed device time and its share of
the wall time (the rest is the device idling while the host works), the host
syncs the fit counted, and the largest device kernels by name; also dclust,
consensus_nmf and the graph engine's fused net (a) and host loop (d).
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PBMC = dict(m=13714, n=2638, k=20, dropout=0.9)      # BASELINE.md:20
MOVIELENS = dict(m=3867, n=610, k=50, dropout=0.95)  # bench.py:123-126
# pbmc3k as counts: 17.9 MB of raw CSC (BENCH_NOTES.md:76) is about 2.2M
# nonzeros of 36.2M entries
PBMC_ZERO_SHARE = 0.938
KL_K, KL_MAXIT = 16, 20                              # BASELINE.md:15
NBZI_K, NBZI_MAXIT = 20, 5                           # BENCH_NOTES.md:23
# the NB + ZI fit's counts: overdispersed, dropout per row, rows of very
# different depth, so that the dispersion and dropout estimates have
# something to find
NBZI_DATA = dict(nb_size=1.0, row_dropout=0.3, row_spread=2.0)
# at least this share of the rows must end with a size strictly inside
# (nb_size_min, nb_size_max); a row of nearly all zeros ends at the cap
NBZI_THETA_INSIDE = 0.05
# a corner of the count matrices small enough for a CPU fit; the fit on the
# card must agree with it in loss history and in factors (share of the
# largest entry)
SMALL = (1200, 400)
SMALL_RTOL, SMALL_FACTOR_TOL = 1e-4, 1e-2
MAXIT = 20
REPS = 5
WGRAM_RTOL = 1e-4
# the card's published peaks (H100 SXM data sheet): device memory rate,
# float32 rate outside the tensor cores, dense bfloat16 and TF32 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# tall-skinny products: every k (below, at and past a multiple of 8, and
# past the 128 rows of one pass) at both data shapes, one odd shape and one
# shape for each alignment of A's rows that the data shapes miss (n = 3 mod
# 4, n = 0 mod 8; 610 and 2638 are 2 mod 4, 77 is 1), below and one past
# the 128 columns of a tile, within this share of the twin's largest entry
# (float32 sums in another order, 3xTF32 products)
RHS_KS = (1, 7, 20, 50, 128, 150)
RHS_ODD_SHAPE = (1001, 77)
RHS_ALIGN_SHAPES = {"n = 3 mod 4": (129, 259), "n = 0 mod 8": (127, 512)}
RHS_RTOL = 1e-5
# whole-fit kernel against its twin.  After one iteration: this share of the
# largest entry of W_T, H, d.  With bfloat16 data W_T and d come from H
# rounded to bfloat16, where a last-bit difference between the kernel's H and
# the twin's rounds the other way, so there the twin's W update is fed the
# kernel's own H and held to the same bar.  The same is done along the
# kernel's own trajectory, one iteration per call: every half step of MAXIT
# iterations, float32 and bfloat16, within this bar of the twin fed the
# kernel's state.  After MAXIT iterations in one call: the loss history, and
# with float32 data the factors; the bfloat16 factors against the twin's own
# trajectory are printed (ALS amplifies the flipped roundings: 0.24 of the
# largest entry at the movielens shape, where every half step agrees to 1e-5)
FUSED_RTOL_ONE = 1e-4
FUSED_LOSS_RTOL = 1e-3
FUSED_FACTOR_TOL = 1e-2
FUSED_PENALTIES = dict(l1_w=0.01, l1_h=0.02, l2_w=0.05, l2_h=0.03)
# the fused fit's converged loss against the default (Cholesky) fit's
CONVERGED_MAXIT, CONVERGED_RTOL = 100, 1e-2
# (k, n, L1, upper_bound, dead coordinate): every k at every n of the main
# path's solves, with and without L1, then the special cases; k=128 puts G
# above 48 KB of shared memory and k=256 beyond it (read from device memory)
CD_CASES = [(k, n, l1, 0.0, False) for k in (8, 20, 50, 100, 128)
            for n in (610, 2638, 13714) for l1 in (0.0, 0.25)]
CD_CASES += [(20, 2638, 0.0, 0.0, True), (50, 610, 0.25, 0.0, True),
             (20, 2638, 0.0, 2.0, False), (100, 610, 0.25, 2.0, False),
             (256, 610, 0.0, 0.0, False)]
# the lane-group design's edges (csrc/cd_nnls.cuh): one lane; a group of 16
# (two columns a warp) and one past it; a warp, one and two registers of rows
# a lane; at a single column, one warp and one lane past it, and a column
# past a block; plain, and with L1, upper_bound and a dead coordinate
CD_EDGE_KS = (1, 2, 15, 16, 17, 31, 32, 33, 64, 65)
CD_EDGE_NS = (1, 33, 2639)
CD_EDGES = [(k, n, l1, ub, dead) for k in CD_EDGE_KS for n in CD_EDGE_NS
            for l1, ub, dead in ((0.0, 0.0, False), (0.25, 2.0, True))]
# past kernel 1's shared-memory route (k <= 241) and past 8 rows a lane
# (k > 256: the loop variant)
CD_CASES += CD_EDGES + [(242, 2639, 0.25, 2.0, True), (300, 610, 0.0, 0.0,
                                                        False)]
# the same for the per-column-Gram kernel; at k=100 the Gram batch of
# n=13,714 columns is 549 MB; past its shared-memory route (k <= 83) and
# past 8 rows a lane
CDB_CASES = [(k, n, l1, 0.0, False) for k in (8, 16, 20, 50, 100)
             for n in (610, 2638, 13714) for l1 in (0.0, 0.25)]
CDB_CASES += [(16, 2638, 0.0, 0.0, True), (50, 610, 0.25, 0.0, True),
              (16, 2638, 0.0, 2.0, False), (20, 13714, 0.25, 2.0, False)]
CDB_CASES += CD_EDGES + [(83, 2639, 0.25, 2.0, True),
                         (84, 2639, 0.25, 2.0, True),
                         (300, 610, 0.0, 0.0, False)]
# fused weighted-Gram kernel: (loss_kind, power, theta per "row"/"col"/None)
WG_KINDS = [("kl", 0.0, None), ("power", 2.0, None), ("power", 3.0, None),
            ("power", 1.5, None), ("nb", 0.0, "row"), ("nb", 0.0, "col")]
WG_SHAPES = [(13714, 2638), (2638, 13714), (3867, 610)]   # (m, bc), all ragged


# per-column weighted Gram + RHS from given weights (kernel 5): (k, m, bc,
# real-valued weights or 0/1, operands as column blocks of wider matrices).
# k=128 at (13,714, 68) and (13,714, 54) are the blocks of the masked k=128
# fit's H side.  Within this share of the twin's largest entry: both sum m
# products, the kernel in 3xTF32 on the tensor cores in a fixed order, cuBLAS
# in float32 tiles
WG5_RTOL = 2e-5
WG5_CASES = [(128, 13714, 68, False, True), (128, 13714, 54, False, True),
             (105, 13714, 83, True, False), (138, 2638, 33, True, True),
             (5, 1001, 1, True, False), (16, 13714, 77, False, False),
             (20, 2638, 1, False, True), (50, 3867, 610, True, False),
             (200, 1001, 7, False, False), (13, 257, 40, True, True),
             (1, 33, 3, True, False)]
MASK_K128 = 128
# the rank-deficient fit held card against CPU: (m, n) and k
RANK1, RANK1_K = (200, 150), 10
# the whole-fit kernel past one block's k x k section (k > 128: a cluster of
# blocks sharing it through distributed shared memory; k > 256: a
# device-memory scratch), on the movielens matrix
FUSED_WIDE_K = 150
FUSED_SCRATCH_K = 257
# Cholesky solve + clip (kernel 6) against its twin (bitwise: the kernel
# keeps the twin's order of operations with _rn intrinsics) and against
# torch.linalg.cholesky + cholesky_solve + clamp on well-conditioned systems
# (share of the largest entry): the main path's k and n, k past the
# one-launch route (k = 138 and 200: two kernels), and the edges of the
# lane-group design: one lane, one warp of factor rows (32) and one past
# it, the route's last k (64) and one past it; one column, one warp of
# columns and one past it, a column past a block
CHOL_KS = (2, 16, 20, 50, 64, 138, 200)
CHOL_NS = (1, 610, 2638, 13714)
CHOL_EDGE_KS = (1, 2, 15, 16, 17, 31, 32, 33, 64, 65)
CHOL_EDGE_NS = (1, 33, 2639)
CHOL_LINALG_RTOL = 1e-4
CHOL_UB = 0.05
# the holdout mask on the card against the host's: (seed, 1 / probability)
HOLDOUT_CASES = [(s, p) for s in (0, 1, 2**31, 2**63 + 5) for p in (2, 10, 7)]
HOLDOUT_SMALL = (1000, 700)
# the cross-validated and masked fits
CV_K, CV_FRACTION, MASK_K, MASK_SHARE = 16, 0.1, 20, 0.1   # BASELINE.md:14,16
KL_CV_MAXIT, ZEROS_MAXIT, K128_MAXIT = 3, 5, 2
# a planted-rank matrix for the sweep and the rank search
PLANTED = dict(m=3000, n=400, k=8)
SWEEP_KS, SWEEP_SEEDS = [4, 8, 16], [1, 2]
# the gathered downdate against the weighted path: loss histories within
# this (two roundings of the same per-column Grams)
DOWNDATE_RTOL = 1e-3


# truncated SVD at the atlas shape of the published SVD rows (BASELINE.md:
# 17-19: 40K cells, k=10): a planted nonnegative matrix with k factors on
# interleaved rows and columns (orthogonal), singular values top * decay^f,
# plus uniform noise in [0, 0.01).  Every d within SVD_D_RTOL of the exact
# leading singular values (float64 eigenvalues of A A^T on the card), U and V
# orthonormal within SVD_ORTHO_TOL; the pca, krylov and deflation runs on a
# corner agree card against CPU within SVD_CORNER_RTOL of the largest d
ATLAS = dict(m=5000, n=40000, k=10, top=2000.0, decay=0.8)
ATLAS_PUBLISHED_S = {"lanczos": 0.44, "randomized": 0.41, "irlba": 0.38}
SVD_D_RTOL, SVD_ORTHO_TOL = 1e-3, 1e-3
ATLAS_CORNER, SVD_CORNER_RTOL = (1000, 4000), 2e-2
# SVD-seeded NMF and the projections at the pbmc3k shape, on a planted matrix
# whose 20 leading singular values are well separated: on the simulate_nmf
# matrix the spectrum past the first value is flat to 1%, its singular
# vectors are not defined (the two packages' inits on the CPU already differ
# by 5e-3 there).  Inits and projections within these shares of the largest
# entry of the CPU port's; HELD_BACK more columns of the same factor model
# for predict
SEEDED = dict(m=13714, n=2638, k=20, top=2000.0, decay=0.85)
SEEDED_RTOL, PROJ_RTOL, PROJ_WIDE_K, HELD_BACK = 1e-4, 1e-4, 50, 1000
# rank-2 divisive clustering: one split at the atlas shape on two planted
# groups; dclust at the pbmc3k shape on 16 planted groups of 164 or 165
# columns, each below 2 * min_samples (min_samples=100, the verify recipe's
# digits run), so that every split falls between groups (a column near
# v = 0 could land on either side when two devices round differently), the
# leaves within CLUSTER_ARI of the planted groups; card against CPU on a
# small planted matrix: ((m, n), levels, min_samples), 8 groups of 50
CLUSTER = dict(levels=4, min_samples=100)
CLUSTER_ARI = 0.99
CLUSTER_CORNER = ((1200, 400), 3, 30)
# consensus NMF at the pbmc3k shape on the MSE stand-in, default solver
CONSENSUS = dict(k=10, n_runs=10)
# checkpointed fits: every this many iterations (NB + ZI, 5 iterations,
# every 2: three files of the imputed matrix)
CKPT_EVERY, NBZI_CKPT_EVERY = 5, 2
AUTO_DISTS, AUTO_MAXIT = ("mse", "gp", "nb"), 20
# out-of-core streaming (phases 26-29): two synthetic count matrices, made
# on the card from a seed and written with the port's st_write (forward and
# transpose streams).  (i) the hcabm40k shape of BASELINE.md:11 (NMF k=20 at
# 5,000 x 40,000, nnz about 33M): Poisson counts around a background plus
# 20 planted blocks of decaying level (stream_counts_i), 16.5% of the
# entries nonzero: the auto rule takes dense panels (density above 0.15) and
# the dense panel cache; 512 columns a panel, so that the largest panel (40,000 x
# 512 floats of A^T, 82 MB) stays well under a quarter of the dense matrix.
# (ii) the flagship's rows and density (BASELINE.md:29: 38,606 rows, 554M
# nonzeros over 278,676 columns) on 20,000 columns: entry (i, j) nonzero
# with probability proportional to a lognormal(0, 1.6) gene popularity
# times a lognormal(0, 0.35) cell depth (tools/flagship_streaming.py::
# synthesize's model), values 1 + geometric(0.42): sparse panels with uint16
# rows and uint8 values, and the wire cache
STREAM_I = dict(m=5000, n=40000, density=0.165, chunk_cols=512)
STREAM_II = dict(m=38606, n=20000, density=554e6 / (38606 * 278676),
                 chunk_cols=2048)


def stream_panels(spec):
    """(rows, columns) of each panel solve of a stream, forward panels then
    transposed ones: chunk_cols columns of A at a time, then chunk_cols rows
    (phase 26 holds the written files' panels to this)."""
    m, n, c = spec["m"], spec["n"], spec["chunk_cols"]
    return [(rows, min(c, cols - j0)) for rows, cols in ((m, n), (n, m))
            for j0 in range(0, cols, c)]


STREAM_K, STREAM_MAXIT, STREAM_CKPT_EVERY = 20, MAXIT, 5
STREAM_I_TOP, STREAM_I_DECAY = 2.0, 0.85
STREAM_II_MAXIT, STREAM_KL_K, STREAM_KL_MAXIT = 5, 16, 5
STREAM_CV_K, STREAM_CV_MAXIT, STREAM_CV_FRACTION = 16, 5, 0.1
STREAM_SVD_K, STREAM_SVD_RTOL, STREAM_NNLS_RTOL = 10, 1e-3, 1e-5
# the twin cases at the shapes the streams launch (each panel width and its
# remainder): kernel 6 on every MSE panel of (i) and (ii) and in
# nnls_streaming, kernel 1 on (i) with solver="cd", kernel 2 on the column
# blocks (stream_blocks) of the KL stream of (ii) and the CV stream of (i)
STREAM_CHOL_CASES = sorted({(STREAM_K, w) for spec in (STREAM_I, STREAM_II)
                            for _, w in stream_panels(spec)})
STREAM_CD_CASES = [(STREAM_K, w, 0.0, 0.0, False) for w in
                   sorted({w for _, w in stream_panels(STREAM_I)})]


def stream_blocks(spec, k, nmf_irls):
    """The column blocks of kernel 2 in a stream's CV and IRLS panel
    solves: each panel cut as nmf_cv and nmf_irls cut it."""
    out = []
    for rows, nc in stream_panels(spec):
        bc = nmf_irls._block_count(nc, k, rows,
                                   kr=nmf_irls._use_kr(k, rows))
        out += [min(bc, nc - j0) for j0 in range(0, nc, bc)]
    return out


def stream_cdb_cases(nmf_irls):
    return sorted({(k, w, 0.0, 0.0, False)
                   for spec, k in ((STREAM_II, STREAM_KL_K),
                                   (STREAM_I, STREAM_CV_K))
                   for w in stream_blocks(spec, k, nmf_irls)})
# the streaming fit against the in-memory one on the card: train loss
# within STREAM_LOSS_RTOL, W within STREAM_W_TOL of its largest entry (the
# port's card-against-CPU factor bar, tests/test_torch_kernels_gpu.py; the
# JAX streaming test's atol of 2e-3 is about ten times a typical entry of
# an L1-normalised W with 5,000 rows); the wire cache's fit within
# STREAM_WIRE_TOL of the uncached one (tests/test_streaming.py:399-420)
STREAM_LOSS_RTOL, STREAM_W_TOL = 1e-3, 2e-3
STREAM_WIRE_TOL = 1e-5
IRLS_PROFILE_KEYS = ["fused_per_iter_us", "fused_total_ms", "irls_iteration",
                     "iterations", "mode", "section_basis"]


# the edges of kernel 4's tile (kernel 5's, csrc/tri_gram.cuh): k no
# multiple of its 16 x 8 tiles, m no multiple of its 32-row stages, odd bc,
# the reduction over m in one range and in three, F's rows for mu staged
# with the stage (mode 1) and read from device memory (mode 2)
WG_EDGE_KS = (1, 8, 16, 17, 50, 128, 129)
WG_EDGE_SHAPE = (1500, 77)
WG_EDGE_PLANS = [(splits, mode) for splits in (1, 3) for mode in (1, 2)]
# the graph engine (phase 30) at the pbmc3k shape: the JAX package's graph
# record (BENCH_NOTES.md:61-65), a 2-layer MSE net k=20 -> k=8 with 20 outer
# sweeps, on the seeded simulate_nmf matrix (graph_matrix) and, for
# predict, GRAPH_HELD_BACK more columns of the same factor model.  (b) and
# (c) split its rows at GRAPH_SPLIT; (c) concatenates a k=20 and a k=10
# branch, conditions on GRAPH_Z seeded covariates and tops them with k=8;
# (d) the host loop on the counts (GP k=16 with CD, then MSE k=8) for
# GRAPH_HOST_SWEEPS sweeps; (e) cross_validate_graph over GRAPH_CV_KS
GRAPH = dict(k1=20, k2=8, maxit=20, seed=42)
GRAPH_SPLIT, GRAPH_HELD_BACK, GRAPH_Z = 10000, 1000, 2
GRAPH_BRANCH_KS = (20, 10, 8)
GRAPH_HOST_K, GRAPH_HOST_SWEEPS = 16, 3
GRAPH_CV_KS, GRAPH_CV_REPS, GRAPH_CV_MAXIT = (8, 16), 2, 10
# the fused net against the same net through the host loop: the JAX test's
# bars (tests/test_graph.py:185-211): total loss rtol, factors rtol and atol
GRAPH_HOST_LOSS_RTOL, GRAPH_HOST_RTOL, GRAPH_HOST_ATOL = 1e-3, 2e-3, 2e-4
# kernel 6 and kernel 1 at the shapes the graph paths give them that the
# cases above miss: the deep layer's (8, 20) and (8, 2638), the row blocks'
# (20, 10000), (10, 2638), (10, 3714), the conditioned top's (8, 32), the
# host loop's deep layer (8, 16), predict's (20, 1000) and (8, 1000)
GRAPH_CHOL_CASES = [(8, 20), (8, 2638), (20, 10000), (10, 2638),
                    (10, 3714), (8, 32), (8, 16), (20, 1000), (8, 1000)]
GRAPH_CD_CASES = [(8, 20, l1, 0.0, False) for l1 in (0.0, 0.25)]


def graph_cdb_cases(nmf_irls):
    """Kernel 2's column blocks in the graph paths: the GP layer of the
    host loop (k=16) and the CV fits of cross_validate_graph (k=8, 16), on
    both sides of the pbmc3k shape, cut as nmf_irls and nmf_cv cut them."""
    m, n = PBMC["m"], PBMC["n"]
    out = set()
    for k in (GRAPH_HOST_K, *GRAPH_CV_KS):
        for rows, cols in ((m, n), (n, m)):
            bc = nmf_irls._block_count(cols, k, rows,
                                       kr=nmf_irls._use_kr(k, rows))
            out |= {(k, min(bc, cols - j0), 0.0, 0.0, False)
                    for j0 in range(0, cols, bc)}
    return sorted(out)


# the device mesh (phase 31) at the pbmc3k shape: (a) the (1, 1) mesh at
# world size 1 over NCCL, bit for bit the plain fits of phases 4 and 5 with
# their launches; (b) MESH_RANKS ranks sharing the card over gloo (NCCL
# refuses two ranks on one card) in a MESH_SHAPE mesh, where 2,638 columns
# do not divide by 4: each rank runs MESH_FITS on its block (MSE default, CD
# and bf16_data at k=20, KL and CV at k=16, a masked fit at k=20) and is
# held to the single-card fit of the same call (MESH_REORDERED: with its
# sums in the mesh's order): the MSE loss within
# MESH_LOSS_TR tr(A'A) (tests/test_parallel.py:38), W and H within
# STREAM_W_TOL of their largest entry, the IRLS loss within MESH_IRLS_RTOL
# (tests/test_parallel.py:162), the CV test loss within MESH_CV_RTOL (:154).
# The ranks join within MESH_TIMEOUT_S or are killed and fail the run
MESH_SHAPE, MESH_RANKS, MESH_TIMEOUT_S = (2, 4), 8, 600.0
MESH_LOSS_TR, MESH_IRLS_RTOL, MESH_CV_RTOL = 1e-6, 1e-5, 1e-4
MESH_FITS = {
    "MSE default k=20": ("A", PBMC["k"], dict(maxit=MAXIT, tol=0, seed=1)),
    "MSE CD k=20": ("A", PBMC["k"], dict(solver="cd", maxit=MAXIT, tol=0,
                                         seed=1)),
    "MSE bf16_data k=20": ("A", PBMC["k"], dict(bf16_data=True, maxit=MAXIT,
                                                tol=0, seed=1)),
    f"KL k={KL_K}": ("counts", KL_K, dict(loss="kl", maxit=KL_MAXIT, tol=0,
                                          seed=1)),
    f"CV k={CV_K} CD": ("A", CV_K, dict(
        test_fraction=CV_FRACTION, cv_seed=1, solver="cd", maxit=MAXIT,
        tol=0, cv_patience=MAXIT + 1, seed=1)),
    f"masked k={MASK_K} CD": ("A", MASK_K, dict(masked=True, solver="cd",
                                                maxit=MAXIT, tol=0, seed=1)),
}
# the fits whose twenty iterations grow a last-bit difference in a sum past
# the bars (it flips a bfloat16 rounding, or an IRLS column's freeze and CD
# exit): the single-card fit splits its sums alike and lands as far from
# itself.  They are held to the single-card fit with its sums made in the
# mesh's order (mesh_order_fit); the gap to the plain single-card fit is
# printed
MESH_REORDERED = ("MSE bf16_data k=20", f"KL k={KL_K}")
# phase 32, on the same ranks and mesh.  (a) checkpointed mesh fits: label
# -> (matrix, k, keywords, checkpoint_every), phase 24's fits and phase
# 31's bf16_data fit (kernels 7 and 8); each runs to half its maxit, then
# resumes, and is held bit for bit to the uninterrupted mesh fit (phase
# 31's where it ran the same call) with the same launches a rank.  (b) sharded streams of phase 26's (i), phase 27's
# calls, held to phase 27's single-card streams within STREAM_LOSS_RTOL
# (the loss) and STREAM_W_TOL (W's largest entry).  (c) phase 30's nets (a)
# and (c), held to phase 30's single-card nets with phase 30's bars for
# the same net with its sums in another order (the card against the CPU):
# the loss within SMALL_RTOL, each factor within SMALL_FACTOR_TOL of its
# largest entry.  Net (c)'s top layer turns a last-bit change into 1e-3 of
# its W on one device already (one ulp of one entry of A moves it 1.5e-3 on
# the CPU), past the host loop's rtol 2e-3 / atol 2e-4
MESH_CKPT = {
    "MSE default k=20": ("A", PBMC["k"], dict(maxit=MAXIT, tol=0, seed=1),
                         CKPT_EVERY),
    "MSE CD k=20": ("A", PBMC["k"], dict(solver="cd", maxit=MAXIT, tol=0,
                                         seed=1), CKPT_EVERY),
    "MSE bf16_data k=20": ("A", PBMC["k"], dict(bf16_data=True, maxit=MAXIT,
                                                tol=0, seed=1), CKPT_EVERY),
    f"KL k={KL_K}": ("counts", KL_K, dict(loss="kl", maxit=KL_MAXIT, tol=0,
                                          seed=1), CKPT_EVERY),
    f"NB zi=row k={NBZI_K}": ("nb", NBZI_K, dict(
        loss="nb", zi="row", maxit=NBZI_MAXIT, tol=0, seed=1),
        NBZI_CKPT_EVERY),
}
MESH_STREAMS = {
    f"MSE k={STREAM_K}": (STREAM_K, dict(maxit=STREAM_MAXIT, tol=0,
                                         seed=1)),
    f"CV k={STREAM_CV_K}": (STREAM_CV_K, dict(
        solver="cd", test_fraction=STREAM_CV_FRACTION, cv_seed=1,
        cv_patience=STREAM_CV_MAXIT + 1, maxit=STREAM_CV_MAXIT, tol=0,
        seed=1)),
}
MESH_GRAPHS = ("(a)", "(c)")


def mesh_stream_blocks():
    """(rows, columns) of one rank's block of each panel of (i) on
    MESH_SHAPE: a forward panel split (rows, cols), a transposed one
    (cols, rows)."""
    r, c = MESH_SHAPE
    out = []
    for rows, width in stream_panels(STREAM_I):
        split = (r, c) if rows == STREAM_I["m"] else (c, r)
        out.append((-(-rows // split[0]), -(-width // split[1])))
    return out


def mesh_consumer_chol_cases():
    """Kernel 6 at the shapes phase 32 gives it beyond phase 31's: the
    mesh stream's panel blocks, and the blocks of net (c)'s two data
    layers (rows GRAPH_SPLIT and the rest, k of their branch)."""
    _, nb = mesh_blocks()
    r = MESH_SHAPE[0]
    k1, k2, _ = GRAPH_BRANCH_KS
    rows2 = PBMC["m"] - GRAPH_SPLIT
    return sorted({(STREAM_K, w) for _, w in mesh_stream_blocks()}
                  | {(k1, -(-GRAPH_SPLIT // r)), (k1, nb),
                     (k2, -(-rows2 // r)), (k2, nb)})


def mesh_consumer_cdb_cases(nmf_irls):
    """Kernel 2's column blocks in the mesh CV stream's panel solves."""
    out = set()
    for rows, nc in mesh_stream_blocks():
        bc = nmf_irls._block_count(nc, STREAM_CV_K, rows,
                                   kr=nmf_irls._use_kr(STREAM_CV_K, rows))
        out |= {(STREAM_CV_K, min(bc, nc - j0), 0.0, 0.0, False)
                for j0 in range(0, nc, bc)}
    return sorted(out)


def mesh_blocks():
    """(rows, columns) of one rank's block of the pbmc3k matrix on
    MESH_SHAPE, from the port's own mesh padding."""
    import types
    from rcppml_tpu_torch.parallel.mesh import mesh_padding
    r, c = MESH_SHAPE
    pm, pn = mesh_padding(types.SimpleNamespace(
        shape={"rows": r, "cols": c}), PBMC["m"], PBMC["n"])
    return (PBMC["m"] + pm) // r, (PBMC["n"] + pn) // c


def mesh_order_fit(data, label, plain):
    """The single-card fit of MESH_FITS ``label`` with its sums made in the
    MESH_SHAPE mesh's order (``tests/torch_mesh_order.py``: the single-card
    loop, its Grams, right-hand sides and row norms added from the ranks'
    blocks in rank order, its solves on the ranks' columns).  ``plain``: the
    plain single-card fit of the same call, whose config it takes."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_mesh_order import mesh_order_fit as fit
    return fit(data[MESH_FITS[label][0]], plain.misc["config"], MESH_SHAPE)


def mesh_chol_cases():
    """Kernel 6 (and kernel 1) at the mesh fits' per-rank solves: k=20
    against the block's columns (H side) and rows (W side)."""
    mb, nb = mesh_blocks()
    return [(PBMC["k"], nb), (PBMC["k"], mb)]


def mesh_cdb_cases(nmf_irls):
    """Kernel 2's column blocks in the mesh fits' KL, CV and masked solves,
    on both sides of a rank's block, cut as nmf_irls and nmf_cv cut them."""
    mb, nb = mesh_blocks()
    out = set()
    for k in (KL_K, CV_K, MASK_K):
        for rows, cols in ((mb, nb), (nb, mb)):
            bc = nmf_irls._block_count(cols, k, rows,
                                       kr=nmf_irls._use_kr(k, rows))
            out |= {(k, min(bc, cols - j0), 0.0, 0.0, False)
                    for j0 in range(0, cols, bc)}
    return sorted(out)


def wgram_cases():
    """(kind, power, theta, sparse_zeros, k, m, bc, forced plan): every kind
    with sparse_zeros on and off at k=16 on the KL fit's H side, the KL
    fit's W side as the fit launches it, each of the twelve (k, shape)
    pairs with one of the twelve (kind, sparse) pairs, all at the plan of
    ``wgram.plan_wgram``; then every edge k with every forced (splits,
    mode), each with one of the (kind, sparse) pairs."""
    combos = [(kind, s) for kind in WG_KINDS for s in (False, True)]
    cases = [(*kind, s, 16, *WG_SHAPES[0], None) for kind, s in combos]
    cases.append(("kl", 0.0, None, False, 16, *WG_SHAPES[1], None))
    pairs = [(k, shape) for k in (8, 16, 20, 50) for shape in WG_SHAPES]
    for i, (k, shape) in enumerate(pairs):
        kind, s = combos[(5 * i + 3) % len(combos)]
        cases.append((*kind, s, k, *shape, None))
    edges = [(k, plan) for k in WG_EDGE_KS for plan in WG_EDGE_PLANS]
    for i, (k, plan) in enumerate(edges):
        kind, s = combos[(7 * i + 1) % len(combos)]
        cases.append((*kind, s, k, *WG_EDGE_SHAPE, plan))
    return cases


@contextlib.contextmanager
def forced_wgram_plan(plan):
    """Kernel 4 at ``plan`` = (splits, mode), its block width as planned
    (``None``: the plan as it is)."""
    from rcppml_tpu_torch.ops import wgram
    if plan is None:
        yield
        return
    real = wgram.plan_wgram
    splits, mode = plan

    def forced(k, m, bc, sms=132):
        _, wc, _, _ = real(k, m, bc, sms)
        chunk = -(-(-(-m // splits)) // 32) * 32
        return mode, wc, -(-m // chunk), chunk

    wgram.plan_wgram = forced
    try:
        yield
    finally:
        wgram.plan_wgram = real


def check(ok, what):
    """Fail the run (a plain ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def simulated(shape, seed=0):
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(shape["m"], shape["n"], shape["k"], noise=0.5,
                     dropout=shape["dropout"], seed=seed)["A"]
    return torch.from_numpy(A).cuda()


def pbmc_counts(k, seed=0, nb_size=None, row_dropout=0.0,
                row_spread=0.0):
    """The stand-in for the pbmc3k count matrix (the real one is not at
    hand): counts around ``scale * W H`` with W and H from ``simulate_nmf``
    and ``scale`` found by bisection so that the expected share of zeros is
    the real matrix's (estimated on every 37th entry).  Poisson counts, or
    with ``nb_size`` a gamma-Poisson mixture (negative binomial of that
    size).  ``row_spread`` > 0 scales row i of the mean by a lognormal
    factor of that sigma (genes differ in expression by orders of
    magnitude; only a row with counts well above 1 shows its dispersion);
    ``row_dropout`` > 0 zeroes each entry of row i with a probability pi_i
    drawn uniformly from [0, row_dropout].  Returns the matrix (float32, on
    the card) and a dict with scale, nb_size, pi_row."""
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    m, n = PBMC["m"], PBMC["n"]
    mean = simulate_nmf(m, n, k, noise=0.0, dropout=0.0,
                        seed=seed)["A"].astype(np.float64)
    rs = np.random.RandomState(seed + 1)
    if row_spread > 0:
        mean *= rs.lognormal(0.0, row_spread, size=(m, 1))
    pi_row = rs.uniform(0.0, row_dropout, size=m)
    pick = np.arange(0, m * n, 37)
    sample, pi = mean.ravel()[pick], pi_row[pick // n]

    def zero_share(scale):
        mu = scale * sample
        p0 = np.exp(-mu) if nb_size is None else \
            (nb_size / (nb_size + mu)) ** nb_size
        return (pi + (1.0 - pi) * p0).mean()

    lo, hi = 0.0, 1.0
    while zero_share(hi) > PBMC_ZERO_SHARE:
        hi *= 2.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if zero_share(mid) > PBMC_ZERO_SHARE else (lo, mid)
    scale = 0.5 * (lo + hi)
    mean *= scale
    if nb_size is not None:
        mean *= rs.gamma(nb_size, 1.0 / nb_size, size=mean.shape)
    A = rs.poisson(mean).astype(np.float32)
    if row_dropout > 0:
        A *= rs.uniform(size=A.shape) >= pi_row[:, None]
    return torch.from_numpy(A).cuda(), dict(scale=scale, nb_size=nb_size,
                                            pi_row=pi_row)


def cuda_ms(fn, reps=REPS, warmup=True):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def peak_mib(fn):
    """``torch.cuda.max_memory_allocated`` over one ``fn()``, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def max_ulp(a, b):
    """Largest distance in units in the last place between two fp32 tensors."""
    def ordered(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def bound_ms(n_bytes, n_flops, n_flops_bf16=0):
    """The least time the card could take: the larger of bytes over the
    memory rate and the operations over the peak rate of their type
    (float32, and products of bfloat16 values).  Returns (milliseconds,
    "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_flops / PEAK_FP32_FLOPS
             + n_flops_bf16 / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_cd_twin():
    """Route the fit's CD solves to the plain twins: a test hook, used only
    to compare a fit through the kernels with the same fit without them."""
    from rcppml_tpu_torch.ops import cd_nnls, cd_nnls_batched, solvers
    kernels = solvers.cd_nnls_shared, solvers.cd_nnls_batched
    solvers.cd_nnls_shared = cd_nnls.cd_nnls_shared_plain
    solvers.cd_nnls_batched = cd_nnls_batched.cd_nnls_batched_plain
    try:
        yield
    finally:
        solvers.cd_nnls_shared, solvers.cd_nnls_batched = kernels


@contextlib.contextmanager
def linalg_cholesky_solve():
    """Route the fit's shared-Gram Cholesky solve on the card to
    ``torch.linalg.cholesky`` + ``cholesky_solve`` + clamps, the calls the
    kernel replaced: a timing hook, used only to time the same fit through
    the library's solve."""
    from rcppml_tpu_torch.ops import solvers
    kernel = solvers.cholesky_clip
    solvers.cholesky_clip = linalg_cholesky_clip
    try:
        yield
    finally:
        solvers.cholesky_clip = kernel


def linalg_cholesky_clip(G, B, *, nonneg=True, upper_bound=0.0):
    X = torch.cholesky_solve(B, torch.linalg.cholesky(G))
    if nonneg:
        X = torch.clamp_min(X, 0.0)
    if upper_bound > 0:
        X = torch.clamp_max(X, upper_bound)
    return X


@contextlib.contextmanager
def plain_wgram_twin():
    """Route the fused weighted-Gram call of the IRLS solve to its twin."""
    from rcppml_tpu_torch.models import nmf_irls
    from rcppml_tpu_torch.ops import wgram
    kernel = nmf_irls.weighted_gram_rhs
    nmf_irls.weighted_gram_rhs = wgram.weighted_gram_rhs_plain
    try:
        yield
    finally:
        nmf_irls.weighted_gram_rhs = kernel


@contextlib.contextmanager
def fused_wgram():
    """Set ``RCPPML_FUSED_WGRAM`` for the fits inside."""
    saved = os.environ.pop("RCPPML_FUSED_WGRAM", None)
    os.environ["RCPPML_FUSED_WGRAM"] = "1"
    try:
        yield
    finally:
        os.environ.pop("RCPPML_FUSED_WGRAM", None)
        if saved is not None:
            os.environ["RCPPML_FUSED_WGRAM"] = saved


def cd_system(k, n, seed, dead=False):
    """A warm-started shared-Gram NNLS system in residual form."""
    rs = np.random.RandomState(seed)
    p = max(2 * k, 64)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    Y = (np.abs(rs.normal(size=(p, n)))
         * (rs.uniform(size=(p, n)) < 0.3)).astype(np.float32)
    G = F @ F.T
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    B_res = (F @ Y - G @ X0).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (G, B_res, X0)]


def cd_batched_system(k, n, seed, dead=False):
    """A warm-started NNLS system with one Gram per column, in residual
    form: G_j = F diag(w_j) F^T and b_j = F (w_j * y_j) from seeded numpy
    data, assembled on the card."""
    from rcppml_tpu_torch.ops import linalg, solvers
    rs = np.random.RandomState(seed)
    p = max(2 * k, 64)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    w = rs.uniform(0.2, 2.0, size=(p, n)).astype(np.float32)
    Y = (np.abs(rs.normal(size=(p, n)))
         * (rs.uniform(size=(p, n)) < 0.3)).astype(np.float32)
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    F, w, Y, X0 = (torch.from_numpy(a).cuda() for a in (F, w, Y, X0))
    Gb, b = linalg.weighted_gram_and_rhs(F, w, Y)
    return Gb, b - solvers.batched_gram_matvec(Gb, X0), X0


def check_cd_kernel(kernel, plain_fn, plan_cd, system, cases):
    """A CD kernel against its twin in every case: bitwise equal, and a
    second launch bitwise equal to the first.  Returns the largest absolute
    difference (0.0 when every case is equal)."""
    worst = 0.0
    for k, n, l1, ub, dead in cases:
        G, B_res, X0 = system(k, n, seed=k * 100003 + n, dead=dead)
        kw = dict(nonneg=True, maxit=100, upper_bound=ub)
        out, again = kernel(G, B_res, X0, l1, 5e-6, **kw), \
            kernel(G, B_res, X0, l1, 5e-6, **kw)
        torch.cuda.synchronize()
        plain, sweeps = plain_fn(G, B_res, X0, l1, 5e-6, return_sweeps=True,
                                 **kw)
        check(bool(torch.isfinite(out).all()), "finite CD solution")
        equal = torch.equal(out, plain)
        worst = max(worst, float((out - plain).abs().max()))
        plan = plan_cd(k, n)
        print(f"k={k:3d} n={n:5d} L1={l1} ub={ub} dead={dead}: "
              f"{'bitwise equal' if equal else f'max {max_ulp(out, plain)} ulp'}"
              f", {float((out > 0).float().mean()):.3f} of x > 0, sweeps "
              f"{float(sweeps.float().mean()):.1f} mean {int(sweeps.max())} "
              f"max; {plan.lanes} lanes x {plan.rows or 'loop'} rows, Gram in "
              f"{'shared' if plan.gram_shared else 'device'} memory",
              flush=True)
        check(equal, f"kernel bitwise equal to the twin at k={k} n={n} "
              f"L1={l1} ub={ub} dead={dead}")
        check(torch.equal(out, again),
              "a second launch on the same inputs is bitwise equal")
        if dead:
            # its step is 0: it keeps its warm start, moved onto the bound
            # where it lies above it (x + (ub - x) may round a last bit off)
            x0 = X0[k // 2]
            check(torch.equal(out[k // 2], x0) if ub == 0 else
                  torch.allclose(out[k // 2], x0.clamp(max=ub), rtol=1e-6,
                                 atol=0),
                  "a dead coordinate keeps its warm start")
        del G, B_res, X0, out, again, plain
    return worst


def wgram_inputs(k, m, bc, seed, theta):
    """Operands of one weight + Gram + RHS call: a nonnegative factor and
    warm start (numpy, seeded), counts with about two thirds zeros (torch
    generator on the card, seeded), and a dispersion per row or column."""
    rs = np.random.RandomState(seed)
    F = (np.abs(rs.normal(size=(k, m))) * (rs.uniform(size=(k, m)) < 0.7)
         ).astype(np.float32)
    X = (np.abs(rs.normal(size=(k, bc))) * (rs.uniform(size=(k, bc)) < 0.7)
         / k).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.poisson(torch.full((m, bc), 0.4, device="cuda"), generator=gen)
    th = None
    if theta is not None:
        th = torch.from_numpy(rs.uniform(0.05, 50.0, size=(
            m if theta == "row" else bc,)).astype(np.float32)).cuda()
    return (torch.from_numpy(F).cuda(), torch.from_numpy(X).cuda(), A,
            th if theta == "row" else None, th if theta == "col" else None)


def check_losses(res, A, *, monotone):
    hist = np.asarray(res.loss_history, np.float64)
    check(hist.shape == (MAXIT,) and np.isfinite(hist).all(),
          f"finite loss history of {MAXIT}: {hist}")
    if monotone:
        rise = (hist[1:] - hist[:-1]) / np.abs(hist[:-1])
        check(rise.max() <= 1e-5, f"loss rose by {rise.max():.3g} relative")
    check(hist[-1] < hist[0], f"last loss below the first: {hist}")
    W = torch.from_numpy(np.ascontiguousarray(res.W)).cuda()
    H = torch.from_numpy(np.ascontiguousarray(res.H)).cuda()
    d = torch.from_numpy(res.d).cuda()
    mse = float(((A - (W * d) @ H) ** 2).mean())
    var = float(A.var())
    check(mse < var, f"reconstruction MSE {mse} below var(A) {var}")
    return hist, mse, var


def check_irls(res, maxit, k, shape, *, falling=True):
    """``falling``: the last loss is below the first.  Not asked of a
    zero-inflated fit: its solves see the imputed matrix while the loss is
    the likelihood of the observed one without the dropout term, and it
    rises in the JAX package too on such counts."""
    hist = np.asarray(res.loss_history, np.float64)
    check(hist.shape == (maxit,) and np.isfinite(hist).all(),
          f"finite loss history of {maxit}: {hist}")
    if falling:
        check(hist[-1] < hist[0], f"last loss below the first: {hist}")
    check(res.W.shape == (shape[0], k) and res.H.shape == (k, shape[1])
          and np.isfinite(res.W).all() and np.isfinite(res.H).all()
          and np.isfinite(res.d).all() and (res.W >= 0).all()
          and (res.H >= 0).all(), "finite nonnegative factors of the shape")
    return hist


def mse_cd_fit(rtt, A):
    return rtt.nmf(A, PBMC["k"], solver="cd", maxit=MAXIT, tol=0, seed=1)


def kl_fit(rtt, A, maxit=KL_MAXIT):
    return rtt.nmf(A, KL_K, loss="kl", maxit=maxit, tol=0, seed=1)


def nbzi_fit(rtt, A):
    return rtt.nmf(A, NBZI_K, loss="nb", zi="row", maxit=NBZI_MAXIT, tol=0,
                   seed=1)


def fused_fit(rtt, A, shape, maxit=MAXIT, **kw):
    return rtt.nmf(A, shape["k"], fused_vmem=True, tol=0, maxit=maxit, seed=1,
                   **kw)


@contextlib.contextmanager
def plain_fused_twin():
    """Route the ``fused_vmem`` fit to the plain twin of the whole-fit
    kernel: a test hook, used only to time the twin-driven fit."""
    from rcppml_tpu_torch.ops import fused_als
    kernel = fused_als.fused_als
    fused_als.fused_als = fused_als.fused_als_plain
    try:
        yield
    finally:
        fused_als.fused_als = kernel


def rel_err(out, plain):
    """Largest error as a share of the plain version's largest entry."""
    return float((out - plain).abs().max()) / float(plain.abs().max())


def check_rhs_kernels(A_by_shape):
    """Kernels 7 and 8 against their twins.  Returns, for each kernel by
    name, the largest absolute and relative error seen at float32."""
    from rcppml_tpu_torch.ops import rhs_tall as rt_
    worst = {"rhs_tall": [0.0, 0.0], "rhs_tall_t": [0.0, 0.0]}
    for label, A32 in A_by_shape.items():
        m, n = A32.shape
        for dtype in (torch.float32, torch.bfloat16):
            A = A32.to(dtype)
            for k in RHS_KS:
                rs = np.random.RandomState(k * 7919 + m)
                F = torch.from_numpy(rs.rand(k, m).astype(np.float32)).cuda()
                H = torch.from_numpy(rs.rand(k, n).astype(np.float32)).cuda()
                errs = []
                for fn, plain_fn, X in (
                        (rt_.rhs_tall, rt_.rhs_tall_plain, F),
                        (rt_.rhs_tall_t, rt_.rhs_tall_t_plain, H)):
                    out, again = fn(X, A), fn(X, A)
                    torch.cuda.synchronize()
                    check(torch.equal(out, again), f"{fn.__name__}: a second "
                          "launch on the same inputs is bitwise equal")
                    plain = plain_fn(X, A)
                    check(bool(torch.isfinite(out).all()), "finite product")
                    errs.append(rel_err(out, plain))
                    if dtype == torch.float32:
                        own = worst[fn.__name__]
                        own[0] = max(own[0], float((out - plain).abs().max()))
                        own[1] = max(own[1], errs[-1])
                name = "bf16" if dtype == torch.bfloat16 else "fp32"
                print(f"{label} {m}x{n} {name} A, k={k:3d}: F A off by "
                      f"{errs[0]:.2e}, H A^T by {errs[1]:.2e} of the largest "
                      f"entry; bitwise repeatable", flush=True)
                check(max(errs) <= RHS_RTOL, f"within {RHS_RTOL} of the twin "
                      f"at {label} {name} k={k}: {errs}")
            del A
    return worst


def fused_start(shape):
    """The starting factors ``rtt.nmf(..., seed=1)`` uses, on the card."""
    from rcppml_tpu_torch import rng
    k, m, n = shape["k"], shape["m"], shape["n"]
    return (torch.from_numpy(rng.fill_uniform(1, k, m)).cuda(),
            torch.from_numpy(rng.fill_uniform(1, k, n, offset=k * m)).cuda())


def fused_half_steps(A, W0, H0, iters, **kw):
    """The whole-fit kernel's own trajectory, one iteration per call, with
    each half step held against the twin fed the kernel's state: H against
    the twin's H update from the same W, then W_T, d and the loss against
    the twin's W update from the kernel's H.  Returns the largest error of
    each over the iterations, as shares of the twin's largest entry."""
    from rcppml_tpu_torch.ops import fused_als as fa
    bf16 = kw.get("a_bf16", False)
    A_mm, trata = fa.widened(A, bf16), (A * A).sum()
    l1_w, l1_h, l2_w, l2_h = (kw.get(key, 0.0) for key in
                              ("l1_w", "l1_h", "l2_w", "l2_h"))
    W, H = W0, H0
    worst = dict(W_T=0.0, H=0.0, d=0.0, loss=0.0)
    for _ in range(iters):
        Wk, Hk, dk, lk = fa.fused_als(A, W, H, maxit=1, **kw)
        Hp, _ = fa.h_update_plain(A_mm, W, fa.seed_inverse_plain(W, l2_h),
                                  a_bf16=bf16, l1_h=l1_h, l2_h=l2_h)
        Wp, dp, _, lp = fa.w_update_plain(
            A_mm, Hk, fa.seed_inverse_plain(H, l2_w), trata, a_bf16=bf16,
            l1_w=l1_w, l2_w=l2_w)
        for f, out, plain in (("W_T", Wk, Wp), ("H", Hk, Hp), ("d", dk, dp),
                              ("loss", lk[0], lp)):
            worst[f] = max(worst[f], rel_err(out, plain))
        W, H = Wk, Hk
    return worst


def check_fused_kernel(cells):
    """Kernel 3 against its twin at both shapes: one iteration, then MAXIT
    with and without L1/L2, float32 and bfloat16 data, in one call and half
    step by half step.  Returns the largest absolute and relative error of
    the float32 one-iteration cases."""
    from rcppml_tpu_torch.ops import fused_als as fa
    worst_abs = worst_rel = 0.0
    for label, (A, shape) in cells.items():
        W0, H0 = fused_start(shape)
        for bf16 in (False, True):
            name = "bf16" if bf16 else "fp32"
            one = fa.fused_als(A, W0, H0, maxit=1, a_bf16=bf16)
            one_plain = fa.fused_als_plain(A, W0, H0, maxit=1, a_bf16=bf16)
            errs = {f: rel_err(o, p)
                    for f, o, p in zip(("W_T", "H", "d"), one, one_plain)}
            note = ""
            if bf16:
                # the twin's W update from the kernel's H
                W_p, d_p = fa.w_update_plain(
                    fa.widened(A, True), one[1], fa.seed_inverse_plain(H0),
                    (A * A).sum(), a_bf16=True)[:2]
                note = (f" (from the twin's own H: {errs['W_T']:.2e}, "
                        f"{errs['d']:.2e})")
                errs.update(W_T=rel_err(one[0], W_p), d=rel_err(one[2], d_p))
            else:
                worst_rel = max(worst_rel, *errs.values())
                worst_abs = max(worst_abs, *(
                    float((o - p).abs().max())
                    for o, p in zip(one[:3], one_plain[:3])))
            print(f"{label} k={shape['k']} {name} A, 1 iteration: H off by "
                  f"{errs['H']:.2e}, W_T and d"
                  f"{' from the kernel H' if bf16 else ''} by "
                  f"{errs['W_T']:.2e}, {errs['d']:.2e} of the largest entry"
                  f"{note}", flush=True)
            for f, err in errs.items():
                check(err <= FUSED_RTOL_ONE, f"{f} within {FUSED_RTOL_ONE} of "
                      f"the twin after one iteration at {label} {name}: {err}")
            for pen in (False, True):
                kw = dict(a_bf16=bf16, **(FUSED_PENALTIES if pen else {}))
                steps = fused_half_steps(A, W0, H0, MAXIT, **kw)
                kw["maxit"] = MAXIT
                out, again = fa.fused_als(A, W0, H0, **kw), \
                    fa.fused_als(A, W0, H0, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(out, again)),
                      "two runs of the whole-fit kernel are bitwise equal")
                plain = fa.fused_als_plain(A, W0, H0, **kw)
                check(bool(torch.isfinite(out[3]).all()),
                      f"finite loss history: {out[3]}")
                loss_off = float(((out[3] - plain[3]).abs()
                                  / plain[3].abs()).max())
                far = max(rel_err(o, p) for o, p in zip(out[:3], plain[:3]))
                print(f"{label} k={shape['k']} {name} A, {MAXIT} iterations"
                      f"{', L1/L2' if pen else ''}: every half step within "
                      f"{max(steps.values()):.2e} of the twin fed the "
                      f"kernel's state; in one call: loss history within "
                      f"{loss_off:.2e}, W_T, H, d within {far:.2e} of the "
                      f"largest entry; loss {float(out[3][0]):.6g} -> "
                      f"{float(out[3][-1]):.6g}; bitwise repeatable",
                      flush=True)
                check(max(steps.values()) <= FUSED_RTOL_ONE,
                      f"every half step within {FUSED_RTOL_ONE} of the twin "
                      f"at {label} {name} pen={pen}: {steps}")
                check(loss_off <= FUSED_LOSS_RTOL,
                      f"loss history within {FUSED_LOSS_RTOL} of the twin's "
                      f"at {label} {name} pen={pen}: {loss_off}")
                check(bf16 or far <= FUSED_FACTOR_TOL,
                      f"factors within {FUSED_FACTOR_TOL} of the twin's at "
                      f"{label} {name} pen={pen}: {far}")
    return worst_abs, worst_rel



def check_fused_wide(A, k):
    """Kernel 3 at a k past one block's k x k section (a cluster of blocks,
    or device memory): every half step of MAXIT iterations within
    FUSED_RTOL_ONE of the twin fed the kernel's state, float32 and bfloat16,
    with and without L1/L2; MAXIT iterations in one call bitwise repeatable
    with a finite loss history."""
    from rcppml_tpu_torch.ops import fused_als as fa
    shape = dict(m=A.shape[0], n=A.shape[1], k=k)
    ranks, rows, _, scratch = fa.refine_plan(k)
    check(rows > 0 and (ranks > 1 or scratch > 0),
          f"k={k} takes a cluster or the device-memory route")
    W0, H0 = fused_start(shape)
    for bf16 in (False, True):
        for pen in (False, True):
            kw = dict(a_bf16=bf16, **(FUSED_PENALTIES if pen else {}))
            steps = fused_half_steps(A, W0, H0, MAXIT, **kw)
            out, again = fa.fused_als(A, W0, H0, maxit=MAXIT, **kw), \
                fa.fused_als(A, W0, H0, maxit=MAXIT, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  "two runs of the whole-fit kernel are bitwise equal")
            check(bool(torch.isfinite(out[3]).all()),
                  f"finite loss history: {out[3]}")
            print(f"{A.shape[0]}x{A.shape[1]} k={k} "
                  f"{'bf16' if bf16 else 'fp32'} A{', L1/L2' if pen else ''}: "
                  f"every half step of {MAXIT} within "
                  f"{max(steps.values()):.2e} of the twin fed the kernel's "
                  f"state; loss {float(out[3][0]):.6g} -> "
                  f"{float(out[3][-1]):.6g}; bitwise repeatable", flush=True)
            check(max(steps.values()) <= FUSED_RTOL_ONE,
                  f"every half step within {FUSED_RTOL_ONE} of the twin at "
                  f"k={k} bf16={bf16} pen={pen}: {steps}")


@contextlib.contextmanager
def counted_calls(owner, name):
    """Count the calls of ``owner.name`` inside the block (``.calls`` of what
    is yielded)."""
    real = getattr(owner, name)

    def counting(*args, **kwargs):
        counting.calls += 1
        return real(*args, **kwargs)

    counting.calls = 0
    setattr(owner, name, counting)
    try:
        yield counting
    finally:
        setattr(owner, name, real)


def wg5_inputs(k, m, bc, real, strided, seed):
    """Operands of one weighted Gram + RHS call: a sparse nonnegative factor,
    0/1 train weights (a tenth held out) or real-valued ones, counts.  With
    ``strided`` w and A are column blocks of matrices 40 columns wider, as a
    fit passes them."""
    rs = np.random.RandomState(seed)
    F = (np.abs(rs.normal(size=(k, m))) * (rs.uniform(size=(k, m)) < 0.7)
         ).astype(np.float32)
    wide = bc + (40 if strided else 0)
    w = (rs.uniform(0.0, 2.0, size=(m, wide)) if real
         else rs.uniform(size=(m, wide)) >= 0.1).astype(np.float32)
    A = rs.poisson(0.4, size=(m, wide)).astype(np.float32)
    F, w, A = (torch.from_numpy(a).cuda() for a in (F, w, A))
    lo = 17 if strided else 0
    return F, w[:, lo:lo + bc], A[:, lo:lo + bc]


def check_weighted_gram():
    """Kernel 5 against its twin.  Returns the largest absolute and relative
    error seen."""
    from rcppml_tpu_torch.ops import weighted_gram as wg5
    worst_abs = worst_rel = 0.0
    for k, m, bc, real, strided in WG5_CASES:
        F, w, A = wg5_inputs(k, m, bc, real, strided, seed=k * 1013 + bc)
        Gb, b = wg5.weighted_gram(F, w, A)
        Gb2, b2 = wg5.weighted_gram(F, w, A)
        torch.cuda.synchronize()
        check(torch.equal(Gb, Gb2) and torch.equal(b, b2),
              "a second launch on the same inputs is bitwise equal")
        Gp, bp = wg5.weighted_gram_plain(F, w, A)
        check(bool(torch.isfinite(Gb).all() and torch.isfinite(b).all()),
              "finite Gram and RHS")
        # (F_a w) F_b and (F_b w) F_a round alike only for 0/1 weights
        check(real or torch.equal(Gb, Gb.transpose(1, 2)),
              "with 0/1 weights the two triangles of every Gram are equal")
        eg, eb = float((Gb - Gp).abs().max()), float((b - bp).abs().max())
        rg, rb = eg / float(Gp.abs().max()), eb / max(float(bp.abs().max()),
                                                     1e-30)
        worst_abs, worst_rel = max(worst_abs, eg, eb), max(worst_rel, rg, rb)
        print(f"k={k:3d} m={m:5d} bc={bc:3d} "
              f"{'real' if real else '0/1 '} weights"
              f"{', column blocks of wider matrices' if strided else ''}: "
              f"Gb off by {rg:.2e}, b by {rb:.2e} of the largest entry; "
              f"bitwise repeatable", flush=True)
        check(rg <= WG5_RTOL and rb <= WG5_RTOL,
              f"kernel within {WG5_RTOL} of the twin at k={k} m={m} bc={bc}: "
              f"{rg:.3g}, {rb:.3g}")
        del F, w, A, Gb, b, Gb2, b2, Gp, bp
    return worst_abs, worst_rel


def chol_system(k, n, seed, rank=None):
    """G = F F^T / p of a (k, p) Gaussian F with p = 4k (condition number
    about 9), or of rank ``rank`` < k, and a Gaussian B (k, n)."""
    rs = np.random.RandomState(seed)
    p = 4 * k if rank is None else rank
    F = rs.normal(size=(k, p)).astype(np.float32)
    G = (F @ F.T / p).astype(np.float32)
    B = rs.normal(size=(k, n)).astype(np.float32)
    return torch.from_numpy(G).cuda(), torch.from_numpy(B).cuda()


def check_cholesky_clip():
    """Kernel 6 against its twin (bitwise) and against ``torch.linalg``, at
    the main cases, at the edges of the lane-group route and at the streams'
    panel widths.  Returns the
    largest absolute and relative error against the twin and whether every
    case was bitwise equal to it."""
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    from rcppml_tpu_torch.ops import solvers
    worst_abs = worst_rel = worst_lib = 0.0
    all_equal = True
    cases = [(k, n) for k in CHOL_KS for n in CHOL_NS] + [
        (k, n) for k in CHOL_EDGE_KS for n in CHOL_EDGE_NS] + \
        STREAM_CHOL_CASES + GRAPH_CHOL_CASES + mesh_chol_cases() + \
        mesh_consumer_chol_cases()
    for k, n in cases:
        G, B = chol_system(k, n, seed=k * 7919 + n)
        L = torch.linalg.cholesky(G)
        for nonneg in (True, False):
            for ub in (0.0, CHOL_UB):
                kw = dict(nonneg=nonneg, upper_bound=ub)
                out, again = cc.cholesky_clip(G, B, **kw), \
                    cc.cholesky_clip(G, B, **kw)
                torch.cuda.synchronize()
                check(torch.equal(out, again), "a second launch on the "
                      "same inputs is bitwise equal")
                check(bool(torch.isfinite(out).all()), "finite solution")
                plain = cc.cholesky_clip_plain(G, B, **kw)
                lib = torch.cholesky_solve(B, L)
                lib = lib.clamp_min(0.0) if nonneg else lib
                lib = lib.clamp_max(ub) if ub > 0 else lib
                scale = max(float(plain.abs().max()), 1e-30)
                err = float((out - plain).abs().max())
                err_lib = float((out - lib).abs().max()) / max(
                    float(lib.abs().max()), 1e-30)
                all_equal &= torch.equal(out, plain)
                worst_abs = max(worst_abs, err)
                worst_rel = max(worst_rel, err / scale)
                worst_lib = max(worst_lib, err_lib)
                ulp = 0 if err == 0 else max_ulp(out, plain)
                check(torch.equal(out, plain),
                      f"kernel bitwise equal to the twin at k={k} n={n} "
                      f"{kw}: {ulp} ulp off")
                check(err_lib <= CHOL_LINALG_RTOL,
                      f"kernel within {CHOL_LINALG_RTOL} of torch.linalg "
                      f"at k={k} n={n} {kw}: {err_lib:.3g}")
        plan = cc.plan_cholesky_clip(k, n)
        route = (f"one launch, {plan.lanes} lanes x {plan.rows} rows, "
                 f"{plan.threads} threads, {plan.blocks} blocks"
                 if plan.lanes else "two kernels")
        print(f"k={k:3d} n={n:5d} ({route}), nonneg and upper_bound on "
              f"and off: bitwise equal to the twin, within "
              f"{worst_lib:.2e} of torch.linalg so far; bitwise "
              f"repeatable", flush=True)
    # a rank-deficient Gram through the fit's entry, which adds the ridge,
    # on both routes
    for k, n in ((20, 2638), (64, 610), (65, 610)):
        G, B = chol_system(k, n, seed=k + n, rank=k // 2)
        out = solvers.cholesky_clip_batch(G, B)
        plain = cc.cholesky_clip_plain(solvers._ridged(G), B)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "finite solution of a "
              "rank-deficient system with the ridge")
        ulp = 0 if torch.equal(out, plain) else max_ulp(out, plain)
        print(f"k={k} n={n}, G of rank {k // 2} with the trace-relative "
              f"ridge: finite, {ulp} ulp from the twin", flush=True)
        check(ulp == 0, f"rank-deficient system bitwise equal to the twin: "
              f"{ulp} ulp off")
    # a Gram that is not positive definite: floored pivots, nothing raised
    out = cc.cholesky_clip(torch.zeros((8, 8), device="cuda"),
                           torch.ones((8, 5), device="cuda"))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()) and torch.equal(
        out, cc.cholesky_clip_plain(torch.zeros((8, 8), device="cuda"),
                                    torch.ones((8, 5), device="cuda"))),
          "a zero Gram gives the twin's finite solution (pivots floored)")
    print(f"largest error against the twin: {worst_rel:.3e} relative, "
          f"{worst_abs:.3e} absolute; every case bitwise equal: {all_equal}",
          flush=True)
    return worst_abs, worst_rel, all_equal


def check_holdout():
    """The holdout mask computed on the card against the host's."""
    from rcppml_tpu_torch import rng
    for seed, inv_prob in HOLDOUT_CASES:
        on_card = rng.is_holdout(seed, *HOLDOUT_SMALL, inv_prob, "cuda")
        host = rng.holdout_mask(seed, *HOLDOUT_SMALL, inv_prob)
        check(np.array_equal(on_card.cpu().numpy(), host),
              f"holdout mask of seed {seed}, 1/{inv_prob}, on the card "
              f"equals the host's")
    m, n = PBMC["m"], PBMC["n"]
    on_card = rng.is_holdout(1, m, n, 10, "cuda")
    host = rng.holdout_mask(1, m, n, 10)
    check(np.array_equal(on_card.cpu().numpy(), host),
          f"the {m} x {n} holdout mask on the card equals the host's")
    ms = cuda_ms(lambda: rng.is_holdout(1, m, n, 10, "cuda"))
    print(f"{len(HOLDOUT_CASES)} (seed, probability) pairs at "
          f"{HOLDOUT_SMALL} and seed 1, 1/10 at {m} x {n} "
          f"({float(on_card.float().mean()):.4f} held out): bit for bit the "
          f"host's; {ms:.3f} ms on the card", flush=True)


def check_cv_histories(res, maxit, *, falling=True):
    train = np.asarray(res.loss_history, np.float64)
    test = np.asarray(res.test_loss_history, np.float64)
    check(res.iterations == maxit and train.shape == test.shape == (maxit,)
          and np.isfinite(train).all() and np.isfinite(test).all(),
          f"finite train and test histories of {maxit}: {train}, {test}")
    if falling:
        check(train[-1] < train[0], f"train loss falls: {train}")
    check(np.isfinite(res.W).all() and np.isfinite(res.H).all()
          and np.isfinite(res.d).all() and (res.W >= 0).all()
          and (res.H >= 0).all(), "finite nonnegative factors")
    return train, test


def profile_fits(rtt, card):
    """One run of each fit under ``torch.profiler``, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    A_pb, (A_ct, _) = simulated(PBMC), pbmc_counts(KL_K)
    A_ml = simulated(MOVIELENS)
    A_nb, _ = pbmc_counts(NBZI_K, **NBZI_DATA)
    gen = torch.Generator(device="cuda").manual_seed(3)
    M_pb = torch.rand(A_pb.shape, device="cuda", generator=gen) < MASK_SHARE

    def cv(**kw):
        return rtt.nmf(A_pb, CV_K, test_fraction=CV_FRACTION, cv_seed=1,
                       maxit=MAXIT, tol=0, cv_patience=MAXIT + 1, seed=1, **kw)

    A_at, _ = planted_matrix(ATLAS, seed=1)
    A_s, _ = planted_matrix(SEEDED, seed=2)
    A_gr, _ = planted_groups(PBMC["m"], PBMC["n"], CLUSTER["levels"], seed=5)
    k_at = ATLAS["k"]
    # matrix (i) of phase 27 as a .spz file, for its default streaming fit
    import tempfile
    stream_dir = tempfile.TemporaryDirectory()
    path_i = os.path.join(stream_dir.name, "i.spz")
    A_i = stream_counts_i()
    rtt.st_write(csc_of_columns(STREAM_I["n"], 4096,
                                lambda j0, j1: A_i[:, j0:j1].T.contiguous()),
                 path_i, chunk_cols=STREAM_I["chunk_cols"])
    del A_i
    A_g, _ = graph_matrix()
    net_a, net_d = graph_deep_net(rtt, A_g), graph_host_net(rtt, A_ct)

    fits = (("MSE CD k=20", lambda: mse_cd_fit(rtt, A_pb), False),
            (f"KL k={KL_K}", lambda: kl_fit(rtt, A_ct), False),
            (f"KL k={KL_K}, RCPPML_FUSED_WGRAM=1", lambda: kl_fit(rtt, A_ct),
             True),
            (f"NB zi=row k={NBZI_K}", lambda: nbzi_fit(rtt, A_nb), False),
            ("MSE fused_vmem k=20", lambda: fused_fit(rtt, A_pb, PBMC), False),
            ("MSE fused_vmem k=20 bf16_data",
             lambda: fused_fit(rtt, A_pb, PBMC, bf16_data=True), False),
            ("MSE Cholesky k=20 bf16_data", lambda: rtt.nmf(
                A_pb, PBMC["k"], bf16_data=True, maxit=MAXIT, tol=0, seed=1),
             False),
            ("movielens MSE fused_vmem k=50",
             lambda: fused_fit(rtt, A_ml, MOVIELENS), False),
            (f"movielens MSE fused_vmem k={FUSED_WIDE_K}",
             lambda: fused_fit(rtt, A_ml, dict(MOVIELENS, k=FUSED_WIDE_K)),
             False),
            ("MSE Cholesky k=20", lambda: rtt.nmf(
                A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1), False),
            (f"CV k={CV_K} CD", lambda: cv(solver="cd"), False),
            (f"CV k={CV_K} Cholesky per column", cv, False),
            (f"masked k={MASK_K}", lambda: rtt.nmf(
                A_pb, MASK_K, mask=M_pb, maxit=MAXIT, tol=0, seed=1), False),
            *((f"atlas svd {method} k={k_at}", lambda method=method: rtt.svd(
                A_at, k_at, method=method), False)
              for method in ("lanczos", "irlba", "randomized", "deflation")),
            (f"atlas svd krylov nonneg=True k={k_at}", lambda: rtt.svd(
                A_at, k_at, method="krylov", nonneg=True), False),
            (f"atlas pca k={k_at}", lambda: rtt.pca(A_at, k_at), False),
            (f"pbmc3k-shape nmf seed='lanczos' k={SEEDED['k']}",
             lambda: rtt.nmf(A_s, SEEDED["k"], seed="lanczos", maxit=MAXIT,
                             tol=0), False),
            (f"dclust min_samples={CLUSTER['min_samples']} on "
             f"{2 ** CLUSTER['levels']} planted groups",
             lambda: rtt.dclust(A_gr, min_samples=CLUSTER["min_samples"]),
             False),
            (f"consensus_nmf hard k={CONSENSUS['k']}, {CONSENSUS['n_runs']} "
             f"runs", lambda: rtt.consensus_nmf(
                 A_pb, CONSENSUS["k"], n_runs=CONSENSUS["n_runs"]), False),
            (f"streaming MSE k={STREAM_K} from the .spz of (i) "
             f"{STREAM_I['m']} x {STREAM_I['n']}, {STREAM_MAXIT} sweeps",
             lambda: rtt.nmf(path_i, STREAM_K, maxit=STREAM_MAXIT, tol=0,
                             seed=1), False),
            (f"graph (a) 2-layer MSE net k={GRAPH['k1']} -> {GRAPH['k2']}, "
             f"{GRAPH['maxit']} sweeps", lambda: rtt.fit(net_a), False),
            (f"graph (d) host loop GP k={GRAPH_HOST_K} -> MSE k={GRAPH['k2']}"
             f", {GRAPH_HOST_SWEEPS} sweeps", lambda: rtt.fit(net_d), False))
    for label, fit, fused in fits:
        with fused_wgram() if fused else contextlib.nullcontext():
            fit()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = fit()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in rows) / 1e3
        # dclust returns its leaves, consensus_nmf a dict with its runs, a
        # graph fit its layers
        if hasattr(res, "layers"):
            counted_by = (f"{res.total_iterations} outer sweeps, "
                          f"{len(res.layers)} layers")
        elif isinstance(res, list):
            counted_by = f"{len(res)} leaves"
        elif isinstance(res, dict):
            counted_by = (f"{sum(r.iterations for r in res['runs'])} "
                          f"iterations in {len(res['runs'])} fits")
        else:
            counted_by = (f"{res.iterations} iterations, "
                          f"{res.misc.get('host_syncs', 'no')} counted host "
                          f"syncs, {res.misc.get('irls_inner_iterations', 0)}"
                          f" inner iterations")
        print(f"{label}: wall {wall_ms:.1f} ms "
              f"under the profiler, device busy {device_ms:.1f} ms "
              f"({100 * device_ms / wall_ms:.1f}%), "
              f"{sum(e.count for e in rows)} device kernels and copies; "
              f"{counted_by}  [{card}]", flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"{e.count:5d} x  {e.key[:90]}", flush=True)
        if "fused_vmem" in label:
            print(f"    kernel 3 by part: {kernel3_parts(prof)}", flush=True)
    stream_dir.cleanup()


# kernel 3's kernels by part, from their names
KERNEL3_PARTS = (("Grams", ("cluster_gram", "small_kernel<2, true>",
                            "small_kernel<4, true>", "small_kernel<8, true>")),
                 ("refine", ("refine_kernel",)),
                 ("row normalisation", ("row_normalize",)),
                 ("products with A", ("tall_kernel", "reduce_pieces")),
                 ("Ginv B", ("small_kernel",)),
                 ("loss", ("loss_kernel",)))


def kernel3_parts(prof):
    """Device time of kernel 3's parts in one profiled fit, and the time
    between its kernels (the span from the first to the last less their
    sum)."""
    from torch.autograd import DeviceType
    spans, times = [], {part: [0.0, 0] for part, _ in KERNEL3_PARTS}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for part, keys in KERNEL3_PARTS:
            if any(key in e.name for key in keys):
                times[part][0] += (e.time_range.end - e.time_range.start) / 1e3
                times[part][1] += 1
                spans.append((e.time_range.start, e.time_range.end))
                break
    if not spans:
        return "no kernel of the sequence"
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    busy = sum(t for t, _ in times.values())
    parts = ", ".join(f"{part} {t:.3f} ms ({n})" for part, (t, n)
                      in times.items())
    return (f"{parts}; between kernels {span - busy:.3f} ms of a "
            f"{span:.3f} ms span")


def planted_matrix(shape, seed, extra_cols=0):
    """A nonnegative (m, n + extra_cols) float32 matrix on the card with
    ``shape["k"]`` factors on interleaved rows and columns (row i belongs to
    factor i mod k, so the factors are orthogonal) and singular values
    ``top * decay^f``, plus uniform noise in [0, 0.01).  Returns the matrix
    and the planted singular values."""
    m, n, k = shape["m"], shape["n"] + extra_cols, shape["k"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def factor(size):
        F = torch.zeros((size, k), device="cuda")
        idx = torch.arange(size, device="cuda")
        F[idx, idx % k] = torch.rand(size, generator=gen, device="cuda") + 0.5
        return F / F.norm(dim=0)

    U, V = factor(m), factor(n)
    s = shape["top"] * shape["decay"] ** torch.arange(
        k, device="cuda", dtype=torch.float32)
    A = torch.rand((m, n), generator=gen, device="cuda") * 0.01
    A.addmm_(U * s, V.T)
    return A, s.cpu().numpy()


def exact_singular_values(A, k):
    """The k leading singular values of A from the float64 eigenvalues of
    A A^T, on the card."""
    A64 = A.double()
    ev = torch.linalg.eigvalsh(A64 @ A64.T)
    del A64
    return ev.flip(0)[:k].clamp_min(0).sqrt().cpu().numpy()


def check_svd(res, exact, label):
    """d within SVD_D_RTOL of the exact values, U and V orthonormal within
    SVD_ORTHO_TOL.  Returns (relative d error, orthonormality error)."""
    k = exact.shape[0]
    d = np.asarray(res.d, np.float64)
    check(d.shape == (k,) and np.isfinite(d).all(), f"{label}: finite d of "
          f"{k}: {d}")
    d_err = float((np.abs(d - exact) / exact).max())
    check(d_err <= SVD_D_RTOL, f"{label}: d within {SVD_D_RTOL} of the "
          f"exact singular values: {d_err:.3e}")
    ortho = max(float(np.abs(X.T @ X - np.eye(k)).max()) for X in (
        np.asarray(res.U, np.float64), np.asarray(res.V, np.float64)))
    check(ortho <= SVD_ORTHO_TOL, f"{label}: U, V orthonormal within "
          f"{SVD_ORTHO_TOL}: {ortho:.3e}")
    return d_err, ortho


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call of ``fn``."""
    out = {}
    ms = cuda_ms(lambda: out.__setitem__("res", fn()), reps=1, warmup=False)
    return out["res"], ms


def svd_phases(rtt, card, counted, reset_counts):
    """The truncated SVD at the atlas shape: lanczos, irlba and randomized
    against the exact spectrum and timed beside the published figures, pca,
    krylov (nonneg) and deflation at the full shape, the same three and a
    cross-validated fit on a corner card against CPU.  No hand-written
    kernel runs.  Returns {label: ms}."""
    A, planted = planted_matrix(ATLAS, seed=1)
    m, n, k = ATLAS["m"], ATLAS["n"], ATLAS["k"]
    t0 = time.perf_counter()
    exact = exact_singular_values(A, k)
    print(f"atlas {m} x {n}, planted {np.round(planted, 2).tolist()}; exact "
          f"leading singular values (float64 eigenvalues of A A^T, "
          f"{time.perf_counter() - t0:.2f} s) {np.round(exact, 4).tolist()}",
          flush=True)
    times = {}
    reset_counts()
    for method in ("lanczos", "irlba", "randomized"):
        res = rtt.svd(A, k, method=method)
        d_err, ortho = check_svd(res, exact, method)
        ms = cuda_ms(lambda: rtt.svd(A, k, method=method), reps=3)
        times[method] = ms
        print(f"svd {method} k={k}: {ms / 1e3:.4f} s (median of 3 after a "
              f"warm-up) on {card}; the reference's published time on its "
              f"own card, an H100 NVL (BASELINE.md:17-19): "
              f"{ATLAS_PUBLISHED_S[method]} s; d within {d_err:.2e} of the "
              f"exact values, U, V orthonormal within {ortho:.2e}; "
              f"{res.iterations} iterations, converged {res.converged}, "
              f"{res.misc['host_syncs']} host syncs", flush=True)
    full = (("pca center=True", lambda X: rtt.pca(X, k)),
            ("krylov nonneg=True", lambda X: rtt.svd(X, k, method="krylov",
                                                     nonneg=True)),
            ("deflation", lambda X: rtt.svd(X, k, method="deflation")))
    for label, fn in full:
        res, ms = timed_once(lambda: fn(A))
        d = np.asarray(res.d)
        check(d.shape == (k,) and np.isfinite(d).all()
              and np.all(np.diff(d) <= 0), f"{label}: finite sorted d {d}")
        times[label] = ms
        print(f"svd {label} k={k}: {ms / 1e3:.4f} s (one run) on {card}; d "
              f"{np.round(d, 3).tolist()}; {res.iterations} iterations, "
              f"{res.misc['host_syncs']} host syncs", flush=True)
    check(sum(fn.launches for fn in counted) == 0,
          "the SVD methods launch no hand-written kernel")
    corner = A[:ATLAS_CORNER[0], :ATLAS_CORNER[1]].contiguous()
    corner_cpu = corner.cpu()
    for label, fn in full:
        on_card, on_cpu = fn(corner), fn(corner_cpu)
        off = float(np.abs(on_card.d - on_cpu.d).max() / on_cpu.d.max())
        check(off <= SVD_CORNER_RTOL, f"{label} on the {ATLAS_CORNER} "
              f"corner: card against CPU within {SVD_CORNER_RTOL}: {off}")
        print(f"  {label} on the {ATLAS_CORNER} corner: d card against the "
              f"port on the CPU within {off:.2e} of the largest", flush=True)
    cv_card = rtt.svd(corner, k, test_fraction=0.1)
    cv_cpu = rtt.svd(corner_cpu, k, test_fraction=0.1)
    check(cv_card.k_selected == cv_cpu.k_selected
          and cv_card.misc["method"] == cv_cpu.misc["method"],
          f"SVD CV on the corner: k_selected {cv_card.k_selected} on the "
          f"card, {cv_cpu.k_selected} on the CPU")
    print(f"  SVD CV (test_fraction=0.1, method {cv_card.misc['method']}) on "
          f"the corner: k_selected {cv_card.k_selected} on the card and on "
          f"the CPU; test loss {cv_card.test_loss:.6g} / "
          f"{cv_cpu.test_loss:.6g}", flush=True)
    return times


def seeded_phases(rtt, card, counted, reset_counts, chol):
    """SVD-seeded NMF at the pbmc3k shape: the init on the card against the
    CPU port's, then the fit through kernel 6.  Returns (the lanczos-seeded
    fit, the matrix, HELD_BACK more columns of its factor model, the fits'
    kernel 6 launches, {label: ms})."""
    from rcppml_tpu_torch.models import nmf as nmf_mod
    m, n, k = SEEDED["m"], SEEDED["n"], SEEDED["k"]
    A_all, _ = planted_matrix(SEEDED, seed=2, extra_cols=HELD_BACK)
    A = A_all[:, :n].contiguous()
    held = A_all[:, n:].contiguous()
    del A_all
    fits, launches, times = {}, {}, {}
    for seed in ("lanczos", "irlba"):
        cfg = rtt.build_config(k, seed=seed)
        on_card = nmf_mod.init_factors(cfg, m, n, A=A)
        on_cpu = nmf_mod.init_factors(cfg, m, n, A=A.cpu())
        err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(on_card[:2], on_cpu[:2]))
        check(err <= SEEDED_RTOL, f"seed={seed!r}: the init on the card "
              f"within {SEEDED_RTOL} of the CPU port's: {err:.3e}")
        reset_counts()
        res = rtt.nmf(A, k, seed=seed, maxit=MAXIT, tol=0)
        launches[seed] = chol.launches
        check(chol.launches == 2 * MAXIT
              and sum(fn.launches for fn in counted) == chol.launches,
              f"seed={seed!r}: {2 * MAXIT} launches of cholesky_clip and "
              f"no other kernel: {chol.launches}")
        hist, mse, var = check_losses(res, A, monotone=False)
        times[seed] = cuda_ms(lambda: rtt.nmf(A, k, seed=seed, maxit=MAXIT,
                                              tol=0), reps=3)
        fits[seed] = res
        print(f"nmf seed={seed!r} {m} x {n} k={k}: init within {err:.2e} of "
              f"the CPU port's; {launches[seed]} launches of cholesky_clip; "
              f"loss {hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < var(A) "
              f"{var:.6g}; {times[seed]:.3f} ms (median of 3)  [{card}]",
              flush=True)
    return fits["lanczos"], A, held, launches, times


def projection_phases(rtt, card, counted, reset_counts, kernels, model, A,
                      held):
    """``nnls`` / ``predict`` at the pbmc3k shape through kernels 6, 1, 2
    and 4, each against the CPU port's result and bitwise repeatable.
    ``kernels``: the wrappers by name.  Returns {label: (launches by kernel
    name, ms)}."""
    W = model.W * model.d[None, :]
    W_wide = np.abs(np.random.RandomState(PROJ_WIDE_K).normal(
        size=(A.shape[0], PROJ_WIDE_K))).astype(np.float32)
    routes = (
        (f"nnls k={model.k} default (Cholesky + clip)", A, W, dict(),
         {"cholesky_clip": 1}),
        (f"nnls k={model.k} L1=0.01 (CD)", A, W, dict(L1=0.01),
         {"cd_nnls_shared": 1}),
        (f"nnls k={PROJ_WIDE_K} seeded nonnegative W (CD)", A, W_wide,
         dict(), {"cd_nnls_shared": 1}),
        (f"nnls k={model.k} loss='kl'", A, W, dict(loss="kl"),
         {"cd_nnls_batched": None}),
        (f"nnls k={model.k} loss='kl', RCPPML_FUSED_WGRAM=1", A, W,
         dict(loss="kl", fused=True),
         {"cd_nnls_batched": None, "weighted_gram_rhs": None}),
        (f"predict on {HELD_BACK} held-back columns", held, None, dict(),
         {"cholesky_clip": 1}))
    out = {}
    for label, data, F, kw, expect in routes:
        kw = dict(kw)
        fused = kw.pop("fused", False)

        def run(X):
            if F is None:
                return rtt.predict(model, X, **kw)
            return rtt.nnls(X, w=F, **kw)
        with fused_wgram() if fused else contextlib.nullcontext():
            reset_counts()
            first = run(data)
            got = {name: fn.launches for name, fn in kernels.items()
                   if fn.launches}
            again = run(data)
            ms = cuda_ms(lambda: run(data), reps=3)
            on_cpu = run(data.cpu())
        check(sorted(got) == sorted(expect) and all(
            n is None or got[name] == n for name, n in expect.items()),
            f"{label}: launches {got}, expected {expect}")
        if "weighted_gram_rhs" in expect:
            check(got["weighted_gram_rhs"] == got["cd_nnls_batched"],
                  f"{label}: one launch of kernel 4 per launch of kernel 2")
        check(np.array_equal(first, again), f"{label}: bitwise repeatable")
        err = float(np.abs(first - on_cpu).max() / np.abs(on_cpu).max())
        check(np.isfinite(first).all() and err <= PROJ_RTOL,
              f"{label}: within {PROJ_RTOL} of the CPU port's: {err:.3e}")
        out[label] = (got, ms)
        print(f"{label}: {first.shape}, launches {got}, within {err:.2e} of "
              f"the CPU port's largest entry, bitwise repeatable; "
              f"{ms:.3f} ms (median of 3)  [{card}]", flush=True)
    return out


def profiled_irls_phase(rtt, card, A_ct, res_kl):
    """The KL fit with profile=True: the JAX package's profile keys and the
    unprofiled fit's history and factors bit for bit."""
    prof = rtt.nmf(A_ct, KL_K, loss="kl", maxit=KL_MAXIT, tol=0, seed=1,
                   profile=True)
    check(sorted(prof.profile) == IRLS_PROFILE_KEYS,
          f"the profile's keys: {sorted(prof.profile)}")
    check(np.array_equal(prof.loss_history, res_kl.loss_history)
          and same_factors(prof, res_kl),
          "the profiled KL fit's history and factors are the unprofiled "
          "fit's, bit for bit")
    print(f"KL k={KL_K} profile=True: "
          + ", ".join(f"{key} {prof.profile[key]:.6g}"
                      if isinstance(prof.profile[key], float)
                      else f"{key} {prof.profile[key]}"
                      for key in IRLS_PROFILE_KEYS[:4])
          + f"; history bitwise the unprofiled fit's  [{card}]", flush=True)


def same_factors(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("W", "d", "H"))


def planted_groups(m, n, levels, seed, noise=0.5, device="cuda"):
    """A nonnegative (m, n) float32 matrix on the card whose columns fall in
    2**levels planted groups on a binary tree of gene programs: at level l
    each group expresses the gene block of its path's prefix with weight
    2**(levels - l) (a random profile per block, a depth per column), plus
    uniform noise in [0, noise).  Every rank-2 split falls between groups.
    Returns the matrix and the host labels."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    labels = torch.arange(n, device=device) * 2 ** levels // n
    depth = 0.8 + 0.4 * rand(n)
    A = noise * rand(m, n)
    for lev in range(1, levels + 1):
        perm = torch.randperm(m, generator=gen, device=device)
        for b, rows in enumerate(torch.tensor_split(perm, 2 ** lev)):
            prog = 2.0 ** (levels - lev) * (0.5 + rand(len(rows)))
            cols = torch.nonzero(labels >> (levels - lev) == b).squeeze(1)
            A[rows[:, None], cols[None, :]] += prog[:, None] * depth[cols]
    return A, labels.cpu().numpy()


def leaf_labels(clusters, n):
    """The leaf index of every column of a dclust partition; fails unless
    the leaves cover every column exactly once."""
    out = np.full(n, -1)
    for i, cl in enumerate(clusters):
        check(np.all(out[cl.samples] == -1), f"leaf {cl.id} overlaps")
        out[cl.samples] = i
    check(np.all(out >= 0), "the leaves cover every column")
    return out


def same_tree(a, b):
    return [c.id for c in a] == [c.id for c in b] and all(
        np.array_equal(x.samples, y.samples) for x, y in zip(a, b))


def clustering_phases(rtt, card, counted, reset_counts):
    """Phases 21 and 22: one bipartition at the atlas shape on a planted
    two-group matrix, dclust at the pbmc3k shape on 16 planted groups, both
    bitwise repeatable, recovering the groups, and dclust card against CPU
    on a small planted matrix.  Returns ({label: ms}, host reads by label)."""
    from rcppml_tpu_torch.models import clustering
    from rcppml_tpu_torch.utils.metrics import adjusted_rand_index
    times, reads = {}, {}

    def host_reads():
        return clustering._rank2_als.host_reads

    m, n = ATLAS["m"], ATLAS["n"]
    A, labels = planted_groups(m, n, 1, seed=4)
    reset_counts()
    r0 = host_reads()
    bp = rtt.bipartition(A, seed=1)
    reads["bipartition"] = host_reads() - r0
    check(sum(fn.launches for fn in counted) == 0,
          "bipartition launches no hand-written kernel")
    check(reads["bipartition"] <= 10, f"at most maxit // 10 = 10 host reads "
          f"a split: {reads['bipartition']}")
    ari = adjusted_rand_index(np.isin(np.arange(n), bp.samples1), labels)
    check(ari == 1.0 and -1.0 <= bp.dist <= 1.0,
          f"the split is the planted one: ARI {ari}, dist {bp.dist}")
    again = rtt.bipartition(A, seed=1)
    check(np.array_equal(again.v, bp.v) and again.dist == bp.dist
          and np.array_equal(again.center1, bp.center1),
          "bipartition is bitwise repeatable on the card")
    times["bipartition atlas"] = cuda_ms(lambda: rtt.bipartition(A, seed=1),
                                         reps=3)
    print(f"bipartition {m} x {n} (two planted groups): sizes {bp.size1} / "
          f"{bp.size2}, ARI {ari}, dist {bp.dist:.6g}, "
          f"{reads['bipartition']} host reads, bitwise repeatable; "
          f"{times['bipartition atlas']:.3f} ms (median of 3)  [{card}]",
          flush=True)
    del A, again

    m, n = PBMC["m"], PBMC["n"]
    A, labels = planted_groups(m, n, CLUSTER["levels"], seed=5)
    kw = dict(min_samples=CLUSTER["min_samples"])
    r0 = host_reads()
    tree, times["dclust pbmc3k"] = timed_once(lambda: rtt.dclust(A, **kw))
    reads["dclust"] = host_reads() - r0
    splits = len(tree) - 1
    check(sum(fn.launches for fn in counted) == 0,
          "dclust launches no hand-written kernel")
    check(reads["dclust"] <= 10 * splits, f"at most 10 host reads a split: "
          f"{reads['dclust']} for {splits} splits")
    ari = adjusted_rand_index(leaf_labels(tree, n), labels)
    groups = 2 ** CLUSTER["levels"]
    check(ari >= CLUSTER_ARI,
          f"the leaves recover the {groups} planted groups: ARI {ari}")
    check(same_tree(rtt.dclust(A, **kw), tree),
          "dclust is bitwise repeatable on the card")
    print(f"dclust {m} x {n}, min_samples={kw['min_samples']}: "
          f"{len(tree)} leaves ({splits} splits), ARI {ari} against the "
          f"{2 ** CLUSTER['levels']} planted groups, {reads['dclust']} host "
          f"reads, bitwise repeatable; {times['dclust pbmc3k']:.3f} ms (one "
          f"run)  [{card}]", flush=True)
    del A

    (cm, cn), levels, min_samples = CLUSTER_CORNER
    A, labels = planted_groups(cm, cn, levels, seed=6)
    on_card = rtt.dclust(A, min_samples=min_samples)
    on_cpu = rtt.dclust(A.cpu(), min_samples=min_samples)
    check(same_tree(on_card, on_cpu), "dclust on the card and on the CPU: "
          "the same ids and samples")
    off = max(abs(a.dist - b.dist) for a, b in zip(on_card, on_cpu))
    print(f"  dclust {cm} x {cn} ({2 ** levels} planted groups, min_samples="
          f"{min_samples}): {len(on_card)} leaves, ids and samples identical "
          f"on the card and on the CPU, dist within {off:.2e}", flush=True)
    return times, reads


def consensus_phase(rtt, card, counted, reset_counts, chol, A):
    """Phase 23: consensus_nmf at the pbmc3k shape with both methods, its
    fits through kernel 6 (twice an iteration), bitwise repeatable; labels
    card against CPU on a small planted matrix.  Returns ({label: ms},
    {label: kernel 6 launches})."""
    k, runs = CONSENSUS["k"], CONSENSUS["n_runs"]
    n = A.shape[1]
    times, launches = {}, {}
    for method in ("hard", "knn_jaccard"):
        reset_counts()
        out, ms = timed_once(lambda: rtt.consensus_nmf(A, k, n_runs=runs,
                                                       method=method))
        iters = sum(r.iterations for r in out["runs"])
        launches[method] = chol.launches
        check(chol.launches == 2 * iters and sum(
            fn.launches for fn in counted) == chol.launches,
            f"consensus {method}: kernel 6 twice an iteration of its runs "
            f"and no other kernel: {chol.launches} for {iters} iterations")
        C = out["consensus"]
        check(C.shape == (n, n) and C.dtype == np.float64
              and np.isfinite(C).all() and np.array_equal(C, C.T)
              and (np.diag(C) == 1.0).all() and C.min() >= 0
              and C.max() <= 1.0, f"consensus {method}: a symmetric matrix "
              "in [0, 1] with a unit diagonal")
        check(-1.0 <= out["cophenetic"] <= 1.0,
              f"cophenetic {out['cophenetic']}")
        again = rtt.consensus_nmf(A, k, n_runs=runs, method=method)
        check(np.array_equal(again["consensus"], C)
              and np.array_equal(again["labels"], out["labels"]),
              f"consensus {method} is bitwise repeatable on the card")
        times[f"consensus {method}"] = ms
        print(f"consensus_nmf {A.shape[0]} x {n} k={k}, {runs} runs, "
              f"{method}: {iters} iterations in all, {launches[method]} "
              f"launches of cholesky_clip; cophenetic "
              f"{out['cophenetic']:.6f}, {len(np.unique(out['labels']))} "
              f"labels in use, bitwise repeatable; {ms:.1f} ms (one run)  "
              f"[{card}]", flush=True)
    (cm, cn), levels, _ = CLUSTER_CORNER
    A_c, _ = planted_groups(cm, cn, levels - 1, seed=7)
    kw = dict(n_runs=3, maxit=50)
    for method in ("hard", "knn_jaccard"):
        on_card = rtt.consensus_nmf(A_c, 2 ** (levels - 1), method=method,
                                    **kw)
        on_cpu = rtt.consensus_nmf(A_c.cpu(), 2 ** (levels - 1),
                                   method=method, **kw)
        check(np.array_equal(on_card["labels"], on_cpu["labels"]),
              f"consensus {method}: the labels on the card and on the CPU")
        off = float(np.abs(on_card["consensus"] - on_cpu["consensus"]).max())
        print(f"  consensus {method} {cm} x {cn} ({2 ** (levels - 1)} planted "
              f"groups): labels equal on the card and on the CPU, consensus "
              f"within {off:.2e}", flush=True)
    return times, launches


def checkpoint_phase(rtt, card, counted, reset_counts, kernels, fits):
    """Phase 24: each fit of ``fits`` ((label, A, k, keywords, every, kernel
    name)) uninterrupted and checkpointed every ``every`` iterations: W, d,
    H, the history, theta and pi bit for bit, the kernel's launches equal;
    the MSE fit stopped at half its iterations and resumed too.  Returns
    ({label: (ms, checkpointed ms)}, {label: launches})."""
    import tempfile
    times, launches = {}, {}
    fields = ("W", "d", "H", "loss_history", "theta", "pi_row")

    def same(a, b):
        return all((getattr(a, f) is None and getattr(b, f) is None)
                   or np.array_equal(getattr(a, f), getattr(b, f))
                   for f in fields)

    with tempfile.TemporaryDirectory() as tmp:
        for label, A, k, kw, every, name in fits:
            path = os.path.join(tmp, f"{len(times)}.npz")
            reset_counts()
            plain, ms = timed_once(lambda: rtt.nmf(A, k, **kw))
            plain_launches = kernels[name].launches
            reset_counts()
            res, ck_ms = timed_once(lambda: rtt.nmf(
                A, k, checkpoint_path=path, checkpoint_every=every, **kw))
            launches[label] = kernels[name].launches
            check(same(res, plain), f"checkpointed {label} every {every}: "
                  "bit for bit the uninterrupted fit")
            check(launches[label] == plain_launches > 0 and sum(
                fn.launches for fn in counted) == launches[label],
                f"checkpointed {label}: {launches[label]} launches of {name}"
                f" and no other kernel, as the uninterrupted fit's "
                f"{plain_launches}")
            size = os.path.getsize(path)
            with np.load(path) as z:
                check(int(z["scalars"][0]) == kw["maxit"]
                      and ("A_imp" in z.files) == ("zi" in kw),
                      f"{label}: the file holds iteration {kw['maxit']}")
            times[label] = (ms, ck_ms)
            print(f"checkpointed {label}, every {every}: bit for bit the "
                  f"uninterrupted fit, {launches[label]} launches of {name} "
                  f"as it; {ck_ms:.1f} ms against {ms:.1f} ms uninterrupted "
                  f"(one run each), file {size / 2**20:.1f} MiB  [{card}]",
                  flush=True)
        label, A, k, kw, every, name = fits[0]
        path = os.path.join(tmp, "resume.npz")
        half = dict(kw, maxit=kw["maxit"] // 2)
        rtt.nmf(A, k, checkpoint_path=path, checkpoint_every=every, **half)
        resumed = rtt.nmf(A, k, checkpoint_path=path, checkpoint_every=every,
                          **kw)
        check(same(resumed, rtt.nmf(A, k, **kw)),
              f"{label} stopped at {half['maxit']} and resumed to "
              f"{kw['maxit']}: bit for bit the uninterrupted fit")
        print(f"  {label} stopped at {half['maxit']} iterations and resumed "
              f"to {kw['maxit']}: bit for bit the uninterrupted fit",
              flush=True)
    return times, launches


def auto_distribution_phase(rtt, card, counted, reset_counts, kernels, A):
    """Phase 25: auto_nmf_distribution on the counts, ("mse", "gp", "nb"):
    finite rows, one selected, the MSE fit through kernel 6 and the GP and
    NB fits through kernel 2.  Returns (ms, {kernel name: launches})."""
    reset_counts()
    out, ms = timed_once(lambda: rtt.auto_nmf_distribution(
        A, KL_K, distributions=AUTO_DISTS, maxit=AUTO_MAXIT))
    rows, models = out["comparison"], out["models"]
    check([r["distribution"] for r in rows] == list(AUTO_DISTS)
          and all(np.isfinite([r["nll"], r["aic"], r["bic"]]).all()
                  for r in rows)
          and sum(r["selected"] for r in rows) == 1,
          f"auto_nmf_distribution rows: {rows}")
    inner = sum(models[d].misc["irls_inner_iterations"] for d in ("gp", "nb"))
    got = {name: fn.launches for name, fn in kernels.items() if fn.launches}
    check(got == {"cholesky_clip": 2 * models["mse"].iterations,
                  "cd_nnls_batched": inner},
          f"auto_nmf_distribution: kernel 6 twice an MSE iteration, kernel 2 "
          f"once an inner GP / NB iteration: {got}")
    again = rtt.auto_nmf_distribution(A, KL_K, distributions=AUTO_DISTS,
                                      maxit=AUTO_MAXIT)
    check(again["comparison"] == rows and all(
        same_factors(again["models"][d], models[d]) for d in AUTO_DISTS),
        "auto_nmf_distribution is bitwise repeatable on the card")
    print(f"auto_nmf_distribution k={KL_K} {tuple(A.shape)} counts, maxit="
          f"{AUTO_MAXIT}: selected {out['loss']!r}; "
          + "; ".join(f"{r['distribution']} "
                      f"{models[r['distribution']].iterations} iterations "
                      f"bic {r['bic']:.6g}" for r in rows)
          + f"; launches {got}; bitwise repeatable; {ms:.1f} ms (one run)  "
          f"[{card}]", flush=True)
    return ms, got


# ---------------------------------------------------------------------------
# Out-of-core streaming (phases 26-29)
# ---------------------------------------------------------------------------

def bisect_scale(share_of, target, iters=40):
    """The scale s with share_of(s) == target, for share_of rising in s."""
    lo, hi = 0.0, 1.0
    while share_of(hi) < target:
        hi *= 2.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if share_of(mid) < target else (lo, mid)
    return 0.5 * (lo + hi)


def stream_counts_i(seed=11):
    """Matrix (i) as a dense float32 tensor on the card: Poisson counts
    around b + a planted block mean (factor f on the rows and columns
    congruent to f mod k, level STREAM_I_TOP * STREAM_I_DECAY^f times
    uniform [0.5, 1.5) row and column weights), with the background b set
    so that 16.5% of the entries are nonzero.  The blocks put the ten
    leading singular values well above the noise's (on uniform rank-20
    factors they fall inside the noise bulk, where a Lanczos run's Ritz
    values are rounding noise)."""
    m, n, k = STREAM_I["m"], STREAM_I["n"], STREAM_K
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(m, device="cuda", generator=gen) + 0.5
    c = torch.rand(n, device="cuda", generator=gen) + 0.5
    level = STREAM_I_TOP * STREAM_I_DECAY ** torch.arange(
        k, device="cuda", dtype=torch.float32)
    rf = torch.arange(m, device="cuda") % k
    cf = torch.arange(n, device="cuda") % k
    block = torch.where(rf[:, None] == cf[None, :],
                        (level[rf] * a)[:, None] * c[None, :],
                        torch.zeros((), device="cuda"))
    sample = block.flatten()[::37]
    b = bisect_scale(lambda s: float((1.0 - torch.exp(-(s + sample)))
                                     .mean()), STREAM_I["density"])
    return torch.poisson(block + b, generator=gen)


def csc_of_columns(n, block, columns):
    """A host scipy CSC matrix from ``columns(j0, j1)``, which gives columns
    j0..j1 of the matrix as the rows of a tensor on the card: nonzero() of
    a row-major block of A^T lists the entries in CSC order."""
    import scipy.sparse as sp
    counts, rows, vals = [], [], []
    m = None
    for j0 in range(0, n, block):
        At = columns(j0, min(j0 + block, n))
        m = At.shape[1]
        nz = At.nonzero()
        counts.append(torch.bincount(nz[:, 0], minlength=At.shape[0]))
        rows.append(nz[:, 1].to(torch.int32).cpu())
        vals.append(At[nz[:, 0], nz[:, 1]].cpu())
        del At, nz
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).cpu().numpy(), out=indptr[1:])
    return sp.csc_matrix((torch.cat(vals).numpy(), torch.cat(rows).numpy(),
                          indptr), shape=(m, n))


def stream_counts_ii(seed=12):
    """Matrix (ii) as a host scipy CSC matrix, made on the card."""
    m, n = STREAM_II["m"], STREAM_II["n"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pop = torch.exp(1.6 * torch.randn(m, device="cuda", generator=gen))
    depth = torch.exp(0.35 * torch.randn(n, device="cuda", generator=gen))
    sample = depth[::37, None] * pop[None, :]
    c = bisect_scale(lambda s: float(torch.clamp_max(s * sample, 1.0).mean()),
                     STREAM_II["density"])
    log_q = float(np.log(1.0 - 0.42))

    def columns(j0, j1):
        p = torch.clamp_max(c * depth[j0:j1, None] * pop[None, :], 1.0)
        keep = torch.rand(p.shape, device="cuda", generator=gen) < p
        u = torch.rand(p.shape, device="cuda", generator=gen)
        # 1 + geometric(0.42), whose support starts at 1
        value = 2.0 + torch.floor(torch.log1p(-u) / log_q)
        return torch.where(keep, value, torch.zeros((), device="cuda"))
    return csc_of_columns(n, 2048, columns)


def same_csc(a, b):
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def stream_fit(path, k, **kw):
    """The streaming engine on a .spz file, with the engine's own keywords
    (panel_cache, sparse_panels) besides the config's; its counters are in
    ``res.misc["stream"]``."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.io.loaders import SpzLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    engine = {key: kw.pop(key) for key in ("panel_cache", "sparse_panels",
                                           "checkpoint_path",
                                           "checkpoint_every", "mesh")
              if key in kw}
    return nmf_chunked(SpzLoader(path), rtt.build_config(k, **kw),
                       **engine)


def streaming_phases(rtt, card, counted, reset_counts, kernels, keep):
    """Phases 26-29: the .spz codec on matrices (i) and (ii), streaming MSE
    on (i) with both solvers against the in-memory card fit, its cache,
    sparse-panel and checkpoint modes bit for bit, the wire cache, KL and
    CV streams, streaming SVD and nnls_streaming.  Returns ({label: ms},
    {kernel name: {path label: launches}}).  ``keep``: a dict given a copy
    of (i)'s file in the directory ``keep["dir"]`` ("spz") and phase 27's
    MSE and CV streams of it (MESH_STREAMS labels), for phase 32."""
    import tempfile

    from rcppml_tpu_torch.io.loaders import SpzLoader
    from rcppml_tpu_torch.models import nmf_irls
    times, paths = {}, {}
    launches = {name: {} for name in kernels}
    chol, cd_shared, cd_batched = (kernels["cholesky_clip"],
                                   kernels["cd_nnls_shared"],
                                   kernels["cd_nnls_batched"])

    def only(fn, what):
        got = fn.launches
        check(got > 0 and sum(f.launches for f in counted) == got,
              f"{what}: {got} launches and no other kernel")
        return got

    with tempfile.TemporaryDirectory() as tmp:
        t_phase = time.perf_counter()
        phase("26 the .spz codec: st_write of (i) 5,000 x 40,000 and (ii) "
              "38,606 x 20,000 with the transpose stream, st_read back")
        t0 = time.perf_counter()
        A_i = stream_counts_i()
        S_i = csc_of_columns(STREAM_I["n"], 4096,
                             lambda j0, j1: A_i[:, j0:j1].T.contiguous())
        S_ii = stream_counts_ii()
        torch.cuda.synchronize()
        print(f"matrices made on the card and copied to the host as CSC in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for label, S, spec in (("(i)", S_i, STREAM_I),
                               ("(ii)", S_ii, STREAM_II)):
            path = os.path.join(tmp, f"{label.strip('()')}.spz")
            t0 = time.perf_counter()
            info = rtt.st_write(S, path, chunk_cols=spec["chunk_cols"],
                                with_transpose=True)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = rtt.st_read(path)
            read_s = time.perf_counter() - t0
            check(same_csc(back, S), f"st_read of {label} equals the source "
                  "bit for bit")
            size = os.path.getsize(path)
            raw = S.nnz * 8 + (S.shape[1] + 1) * 8
            ld = SpzLoader(path)
            check([(n_rows, ld.reader.chunk_info(c, t)[1])
                   for t, n_rows in ((False, S.shape[0]), (True, S.shape[1]))
                   for c in range(ld.num_chunks(t))] == stream_panels(spec),
                  f"the panels of {label} have the shapes at which the "
                  f"twin phases checked the kernels")
            print(f"{label} {S.shape[0]} x {S.shape[1]}, nnz {S.nnz} "
                  f"({100 * S.nnz / (S.shape[0] * S.shape[1]):.2f}%), "
                  f"values {info['value_type']}, {spec['chunk_cols']} "
                  f"columns a panel ({ld.num_chunks(False)} forward + "
                  f"{ld.num_chunks(True)} transpose panels): file "
                  f"{size / 2**20:.1f} MiB, {raw / size:.2f}x smaller than "
                  f"raw CSC; st_write {write_s:.2f} s, st_read {read_s:.2f} s "
                  f"(bit for bit the source)  [{card}]", flush=True)
            paths[label] = path
            times[f"st_write {label}"] = write_s * 1e3
            times[f"st_read {label}"] = read_s * 1e3
            del back
        del S_ii
        times["phase 26"] = (time.perf_counter() - t_phase) * 1e3
        keep["spz"] = os.path.join(keep["dir"], "i.spz")
        shutil.copy(paths["(i)"], keep["spz"])

        t_phase = time.perf_counter()
        phase(f"27 streaming MSE from the .spz of (i), k={STREAM_K}, "
              f"maxit={STREAM_MAXIT}, tol=0, seed=1")
        path = paths["(i)"]
        ld = SpzLoader(path)
        panels = ld.num_chunks(False) + ld.num_chunks(True)
        kw = dict(maxit=STREAM_MAXIT, tol=0, seed=1)
        for solver, fn, name in (("cholesky", chol, "cholesky_clip"),
                                 ("cd", cd_shared, "cd_nnls_shared")):
            reset_counts()
            mem, mem_ms = timed_once(lambda: rtt.nmf(
                A_i, STREAM_K, solver=solver, **kw))
            check(only(fn, f"in-memory {solver}") == 2 * STREAM_MAXIT,
                  "the in-memory fit launches twice an iteration")
            reset_counts()
            res, ms = timed_once(lambda: rtt.nmf(path, STREAM_K,
                                                 solver=solver, **kw))
            got = only(fn, f"streaming {solver}")
            check(got == STREAM_MAXIT * panels,
                  f"streaming {solver}: {got} launches of {name}, once a "
                  f"panel a sweep ({STREAM_MAXIT} x {panels})")
            hist, _, _ = check_losses(res, A_i, monotone=solver == "cd")
            check(abs(res.train_loss - mem.train_loss)
                  <= STREAM_LOSS_RTOL * abs(mem.train_loss),
                  f"streaming {solver} loss {res.train_loss} against the "
                  f"in-memory {mem.train_loss}")
            w_err = np.abs(res.W - mem.W).max() / np.abs(mem.W).max()
            check(w_err <= STREAM_W_TOL,
                  f"streaming {solver} W within {STREAM_W_TOL} of the "
                  f"in-memory W's largest entry: {w_err:.3g}")
            launches[name][f"streaming MSE (i) {solver}"] = got
            times[f"stream (i) {solver}"] = ms
            times[f"in-memory (i) {solver}"] = mem_ms
            print(f"streaming MSE {solver}: {got} launches of {name} "
                  f"({STREAM_MAXIT} sweeps x {panels} panels), loss "
                  f"{hist[0]:.6g} -> {hist[-1]:.6g}, in-memory "
                  f"{mem.train_loss:.6g} (relative "
                  f"{abs(res.train_loss / mem.train_loss - 1):.2e}), W "
                  f"within {w_err:.2e} of the in-memory W's largest entry; "
                  f"{ms:.1f} ms against {mem_ms:.1f} ms in memory (one run "
                  f"each)  [{card}]", flush=True)
            if solver == "cholesky":
                cached = res
                keep[f"MSE k={STREAM_K}"] = res
        fields = ("W", "d", "H", "loss_history")

        def same(a, b):
            return all(np.array_equal(getattr(a, f), getattr(b, f))
                       for f in fields)
        res, ms = timed_once(lambda: stream_fit(path, STREAM_K,
                                                sparse_panels=True, **kw))
        check(same(res, cached), "sparse_panels=True: bit for bit the dense "
              "panels' fit")
        dense_bytes = 4 * STREAM_I["m"] * STREAM_I["n"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, ms_off = timed_once(lambda: stream_fit(
            path, STREAM_K, sparse_panels=True, panel_cache=False, **kw))
        stats = res.misc["stream"]
        peak = torch.cuda.max_memory_allocated() - before
        check(same(res, cached), "panel_cache=False: bit for bit the cached "
              "fit")
        check(peak < dense_bytes / 4, f"panel_cache=False peak {peak} bytes "
              f"below a quarter of the dense matrix ({dense_bytes})")
        print(f"sparse_panels=True: bit for bit the dense panels' fit, "
              f"{ms:.1f} ms; with panel_cache=False too: bit for bit, peak "
              f"device memory {peak / 2**20:.1f} MiB over what was "
              f"allocated (the dense matrix: {dense_bytes / 2**20:.1f} MiB), "
              f"{stats['upload_bytes'] / 2**20:.1f} MiB uploaded in "
              f"{stats['upload_s']:.2f} s of host time, {ms_off:.1f} ms  "
              f"[{card}]", flush=True)
        times["stream (i) sparse panels"] = ms
        times["stream (i) uncached sparse panels"] = ms_off
        ckpt = os.path.join(tmp, "stream.npz")
        stream_fit(path, STREAM_K, checkpoint_path=ckpt,
                   checkpoint_every=STREAM_CKPT_EVERY,
                   **dict(kw, maxit=STREAM_MAXIT // 2))
        res = stream_fit(path, STREAM_K, checkpoint_path=ckpt,
                         checkpoint_every=STREAM_CKPT_EVERY, **kw)
        check(same(res, cached), "a stream stopped at half its sweeps and "
              "resumed: bit for bit the uninterrupted one")
        print(f"stopped at {STREAM_MAXIT // 2} sweeps, checkpointed every "
              f"{STREAM_CKPT_EVERY}, resumed to {STREAM_MAXIT}: bit for bit "
              f"the uninterrupted stream", flush=True)
        times["phase 27"] = (time.perf_counter() - t_phase) * 1e3

        t_phase = time.perf_counter()
        phase(f"28 sparse and IRLS streams: MSE with the wire cache and KL "
              f"k={STREAM_KL_K} on (ii), CV k={STREAM_CV_K} on (i)")
        path = paths["(ii)"]
        ld = SpzLoader(path)
        panels_ii = ld.num_chunks(False) + ld.num_chunks(True)
        kw_ii = dict(maxit=STREAM_II_MAXIT, tol=0, seed=1)
        runs = {}
        for cache in ("wire", False):
            reset_counts()
            res, ms = timed_once(lambda: stream_fit(
                path, STREAM_K, panel_cache=cache, **kw_ii))
            stats = res.misc["stream"]
            got = only(chol, f"(ii) panel_cache={cache!r}")
            check(got == STREAM_II_MAXIT * panels_ii,
                  f"(ii): {got} launches, once a panel a sweep")
            hist = np.asarray(res.loss_history)
            check(np.isfinite(hist).all() and hist[-1] < hist[0],
                  f"(ii) panel_cache={cache!r}: finite falling losses {hist}")
            runs[cache] = (res, ms, stats, got)
        (wire, ms_w, st_w, got), (off, ms_o, st_o, _) = runs["wire"], \
            runs[False]
        w_diff = np.abs(wire.W - off.W).max()
        check(w_diff < STREAM_WIRE_TOL and abs(wire.train_loss
                                               - off.train_loss)
              <= STREAM_WIRE_TOL * abs(off.train_loss),
              f"wire cache within {STREAM_WIRE_TOL} of panel_cache=False: W "
              f"{w_diff}, loss {wire.train_loss} against {off.train_loss}")
        check(2 * st_w["upload_bytes"] < st_o["upload_bytes"],
              "the wire cache uploads the panels in the first sweep only")
        launches["cholesky_clip"]["streaming MSE (ii) wire cache"] = got
        times["stream (ii) wire"], times["stream (ii) uncached"] = ms_w, ms_o
        print(f"(ii) MSE k={STREAM_K}, {STREAM_II_MAXIT} sweeps x "
              f"{panels_ii} panels: wire cache {ms_w:.1f} ms "
              f"({st_w['upload_bytes'] / 2**20:.1f} MiB uploaded), "
              f"panel_cache=False {ms_o:.1f} ms "
              f"({st_o['upload_bytes'] / 2**20:.1f} MiB); W within "
              f"{w_diff:.2e}, loss {wire.train_loss:.8g} against "
              f"{off.train_loss:.8g}; sweeps "
              f"{[round(s, 2) for s in st_w['sweep_s']]} s against "
              f"{[round(s, 2) for s in st_o['sweep_s']]} s  [{card}]",
              flush=True)

        reset_counts()
        res, ms = timed_once(lambda: stream_fit(
            path, STREAM_KL_K, loss="kl", maxit=STREAM_KL_MAXIT, tol=0,
            seed=1))
        stats = res.misc["stream"]
        got = only(cd_batched, "streaming KL")
        check(got == stats["inner_iters"],
              f"streaming KL: kernel 2 once an inner iteration "
              f"({got} against {stats['inner_iters']})")
        hist = check_irls(res, STREAM_KL_MAXIT, STREAM_KL_K,
                          (STREAM_II["m"], STREAM_II["n"]))
        launches["cd_nnls_batched"]["streaming KL (ii)"] = got
        times["stream (ii) KL"] = ms
        print(f"(ii) KL k={STREAM_KL_K}, {STREAM_KL_MAXIT} sweeps: {got} "
              f"launches of cd_nnls_batched (one an inner iteration), loss "
              f"{hist[0]:.6g} -> {hist[-1]:.6g}; {ms:.1f} ms  [{card}]",
              flush=True)

        path = paths["(i)"]
        ld = SpzLoader(path)
        blocks = len(stream_blocks(STREAM_I, STREAM_CV_K, nmf_irls))
        reset_counts()
        res, ms = timed_once(lambda: rtt.nmf(
            path, STREAM_CV_K, solver="cd", test_fraction=STREAM_CV_FRACTION,
            cv_seed=1, cv_patience=STREAM_CV_MAXIT + 1,
            maxit=STREAM_CV_MAXIT, tol=0, seed=1))
        keep[f"CV k={STREAM_CV_K}"] = res
        got = only(cd_batched, "streaming CV")
        check(got == STREAM_CV_MAXIT * blocks,
              f"streaming CV: kernel 2 once a column block a sweep ({got} "
              f"against {STREAM_CV_MAXIT} x {blocks})")
        train, test = check_cv_histories(res, STREAM_CV_MAXIT)
        launches["cd_nnls_batched"]["streaming CV (i)"] = got
        times["stream (i) CV"] = ms
        print(f"(i) CV k={STREAM_CV_K}, test_fraction="
              f"{STREAM_CV_FRACTION}, CD, {STREAM_CV_MAXIT} sweeps: {got} "
              f"launches of cd_nnls_batched; train {train[0]:.6g} -> "
              f"{train[-1]:.6g}, test {test[0]:.6g} -> {test[-1]:.6g}; "
              f"{ms:.1f} ms  [{card}]", flush=True)
        times["phase 28"] = (time.perf_counter() - t_phase) * 1e3

        t_phase = time.perf_counter()
        phase(f"29 streaming SVD (k={STREAM_SVD_K}) and nnls_streaming on "
              f"(i)")
        for method in ("randomized", "lanczos", "irlba"):
            reset_counts()
            res, ms = timed_once(lambda: rtt.svd(path, STREAM_SVD_K,
                                                 method=method))
            mem, mem_ms = timed_once(lambda: rtt.svd(A_i, STREAM_SVD_K,
                                                     method=method))
            err = float(np.max(np.abs(res.d - mem.d) / mem.d))
            check(err <= STREAM_SVD_RTOL and sum(
                f.launches for f in counted) == 0,
                f"streaming svd {method}: d within {STREAM_SVD_RTOL} of the "
                f"in-memory card svd ({err:.3g}), no hand-written kernel")
            times[f"stream svd {method}"] = ms
            times[f"in-memory svd {method}"] = mem_ms
            print(f"svd {method} of the .spz path: d within {err:.2e} of the "
                  f"in-memory svd's (d[0] {res.d[0]:.6g}); {ms:.1f} ms "
                  f"against {mem_ms:.1f} ms in memory  [{card}]", flush=True)
        W = np.ascontiguousarray(cached.W * cached.d[None, :])
        reset_counts()
        H_s, ms = timed_once(lambda: rtt.nnls_streaming(path, W))
        got = only(chol, "nnls_streaming")
        H_m, mem_ms = timed_once(lambda: rtt.nnls(A_i, w=W))
        err = float(np.abs(H_s - H_m).max() / np.abs(H_m).max())
        check(err <= STREAM_NNLS_RTOL and got == ld.num_chunks(False),
              f"nnls_streaming within {STREAM_NNLS_RTOL} of nnls ({err:.3g}), "
              f"kernel 6 once a panel ({got})")
        launches["cholesky_clip"]["nnls_streaming (i)"] = got
        times["nnls_streaming (i)"], times["nnls (i)"] = ms, mem_ms
        print(f"nnls_streaming k={STREAM_K}: within {err:.2e} of nnls on the "
              f"matrix in memory, {got} launches of cholesky_clip (one a "
              f"panel); {ms:.1f} ms against {mem_ms:.1f} ms  [{card}]",
              flush=True)
        times["phase 29"] = (time.perf_counter() - t_phase) * 1e3
    return times, {name: got for name, got in launches.items() if got}


# ---------------------------------------------------------------------------
# The graph engine (phase 30)
# ---------------------------------------------------------------------------

def graph_matrix(seed=30):
    """The phase's MSE matrix, simulate_nmf at the pbmc3k shape as
    ``simulated(PBMC)`` makes it, with GRAPH_HELD_BACK more columns of the
    same factor model: (A, the held-back columns), both on the card."""
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    m, n = PBMC["m"], PBMC["n"]
    A = torch.from_numpy(simulate_nmf(
        m, n + GRAPH_HELD_BACK, PBMC["k"], noise=0.5, dropout=PBMC["dropout"],
        seed=seed)["A"]).cuda()
    return A[:, :n].contiguous(), A[:, n:].contiguous()


def graph_deep_net(rtt, A, solver="auto", tol=0.0):
    """(a): nmf_layer(input, 20) -> nmf_layer(L1, 8), 20 sweeps."""
    inp = rtt.factor_input(A, "x")
    l2 = rtt.nmf_layer(rtt.nmf_layer(inp, GRAPH["k1"], name="L1",
                                     solver=solver),
                       GRAPH["k2"], name="L2", solver=solver)
    return rtt.factor_net(inp, l2, maxit=GRAPH["maxit"], tol=tol,
                          seed=GRAPH["seed"])


def graph_branched_net(rtt, A):
    """(c): Condition(Concat(b1, b2), Z) over the two row blocks, topped by
    k=8."""
    k1, k2, k_top = GRAPH_BRANCH_KS
    i1 = rtt.factor_input(A[:GRAPH_SPLIT], "rows1")
    i2 = rtt.factor_input(A[GRAPH_SPLIT:], "rows2")
    Z = np.random.RandomState(31).rand(A.shape[1], GRAPH_Z).astype(
        np.float32)
    top = rtt.nmf_layer(rtt.factor_condition(rtt.factor_concat(
        rtt.nmf_layer(i1, k1, name="b1"), rtt.nmf_layer(i2, k2, name="b2")),
        Z), k_top, name="top")
    return rtt.factor_net([i1, i2], top, maxit=GRAPH["maxit"], tol=0.0,
                          seed=GRAPH["seed"])


def graph_host_net(rtt, A_ct):
    """(d): a GP layer (k=16, CD) under an MSE layer (k=8): the host loop."""
    inp = rtt.factor_input(A_ct, "counts")
    l2 = rtt.nmf_layer(rtt.nmf_layer(inp, GRAPH_HOST_K, name="gp",
                                     loss="gp", solver="cd"),
                       GRAPH["k2"], name="mse")
    return rtt.factor_net(inp, l2, maxit=GRAPH_HOST_SWEEPS, tol=0.0,
                          seed=GRAPH["seed"])


def graph_layers_equal(a, b):
    return a.total_loss == b.total_loss and all(
        same_factors(a[name], b[name]) for name in a.layers)


def graph_phase(rtt, card, counted, reset_counts, kernels, A_ct, keep):
    """Phase 30: the graph engine at the pbmc3k shape, (a) to (f) of the
    module docstring.  Returns ({label: ms}, {kernel name: {path label:
    launches}}).  ``keep``: a dict given the nets' (a) and (c) results
    (MESH_GRAPHS labels), for phase 32."""
    from rcppml_tpu_torch.models import graph as tg
    chol, cd_shared, cd_batched = (kernels["cholesky_clip"],
                                   kernels["cd_nnls_shared"],
                                   kernels["cd_nnls_batched"])
    times = {}
    launches = {name: {} for name in kernels}
    A, A_new = graph_matrix()
    keep["graph"] = A
    m, n = A.shape

    def got():
        return {name: fn.launches for name, fn in kernels.items()
                if fn.launches}

    # (a) the fused 2-layer net, default solver (kernel 6) and CD (kernel 1)
    for solver, fn, name in (("auto", chol, "cholesky_clip"),
                             ("cd", cd_shared, "cd_nnls_shared")):
        net = graph_deep_net(rtt, A, solver)
        reset_counts()
        reads = tg._outer_als.host_reads
        res = rtt.fit(net)
        reads = tg._outer_als.host_reads - reads
        warm = sum(net._warm_iterations)
        want = 2 * warm + 4 * GRAPH["maxit"]
        check(net._fused_fn is not None and got() == {name: want},
              f"(a) solver={solver}: the fused outer ALS, {name} twice a "
              f"warmup iteration ({warm}) and twice a layer a sweep, no other "
              f"kernel: {got()}")
        check(reads == 0, f"(a) solver={solver}: no host read at tol=0, "
              f"{reads}")
        launches[name][f"graph (a) fused 2-layer net, solver={solver}"] = \
            want
        check(res.total_iterations == GRAPH["maxit"]
              and np.isfinite(res.total_loss)
              and res["L1"].W.shape == (m, GRAPH["k1"])
              and res["L2"].W.shape == (n, GRAPH["k2"])
              and res["L2"].H.shape == (GRAPH["k2"], GRAPH["k1"])
              and all(np.isfinite(getattr(res[lay], f)).all()
                      for lay in ("L1", "L2") for f in ("W", "d", "H")),
              f"(a) solver={solver}: finite factors of the net's shapes")
        check(graph_layers_equal(rtt.fit(net), res),
              f"(a) solver={solver}: bit for bit across two runs")
        ms = cuda_ms(lambda: rtt.fit(net))
        times[f"graph (a) solver={solver}"] = ms
        print(f"(a) 2-layer net k={GRAPH['k1']} -> {GRAPH['k2']}, "
              f"{GRAPH['maxit']} sweeps, solver={solver}: {want} launches of "
              f"{name} (warmups {net._warm_iterations} iterations), "
              f"{reads} host reads; loss {res.total_loss:.6g} (L1 "
              f"{res['L1'].loss:.6g}, L2 {res['L2'].loss:.6g}); bit for bit "
              f"across two runs; {ms:.3f} ms (median of {REPS})  [{card}]",
              flush=True)
        if solver != "auto":
            continue
        res_a = keep["(a)"] = res
        # the same net through the host loop, and on the CPU
        net_h = graph_deep_net(rtt, A)
        net_h._fit_deep_fused = lambda *args, **kw: None
        reset_counts()
        res_h, ms_h = timed_once(lambda: rtt.fit(net_h))
        launches[name]["graph (a) the same net through the host loop"] = \
            chol.launches
        check(net_h._fused_fn is None and res_h.total_iterations ==
              GRAPH["maxit"], "(a) host loop: the forced path ran")
        rel = abs(res_h.total_loss - res.total_loss) / res.total_loss
        check(rel <= GRAPH_HOST_LOSS_RTOL,
              f"(a) host loop: total loss within {GRAPH_HOST_LOSS_RTOL}: "
              f"{rel:.3g}")
        for lay in ("L1", "L2"):
            for f in ("W", "H"):
                check(np.allclose(getattr(res[lay], f),
                                  getattr(res_h[lay], f),
                                  rtol=GRAPH_HOST_RTOL,
                                  atol=GRAPH_HOST_ATOL),
                      f"(a) host loop: {lay}.{f} within rtol "
                      f"{GRAPH_HOST_RTOL}, atol {GRAPH_HOST_ATOL}")
        times["graph (a) host loop"] = ms_h
        res_c, ms_c = timed_once(lambda: rtt.fit(graph_deep_net(
            rtt, A.cpu()), device="cpu"))
        rel_c = abs(res_c.total_loss - res.total_loss) / res_c.total_loss
        off_c = max(float(np.abs(getattr(res[lay], f)
                                 - getattr(res_c[lay], f)).max()
                          / np.abs(getattr(res_c[lay], f)).max())
                    for lay in ("L1", "L2") for f in ("W", "d", "H"))
        check(rel_c <= SMALL_RTOL and off_c <= SMALL_FACTOR_TOL,
              f"(a) card against CPU: loss within {SMALL_RTOL} ({rel_c:.3g}),"
              f" factors within {SMALL_FACTOR_TOL} ({off_c:.3g})")
        print(f"  host loop: {chol.launches} launches of cholesky_clip, loss "
              f"{res_h.total_loss:.6g} ({rel:.2e} from the fused), factors "
              f"within rtol {GRAPH_HOST_RTOL} atol {GRAPH_HOST_ATOL}; "
              f"{ms_h:.1f} ms (one run)  [{card}]", flush=True)
        print(f"  on the CPU: loss {res_c.total_loss:.6g} ({rel_c:.2e}), "
              f"factors within {off_c:.2e} of their largest entry; "
              f"{ms_c:.1f} ms (one run)", flush=True)
    # with tol > 0: one host read a sweep
    net = graph_deep_net(rtt, A, tol=1e-12)
    reads = tg._outer_als.host_reads
    res_t = rtt.fit(net)
    reads = tg._outer_als.host_reads - reads
    check(reads == res_t.total_iterations,
          f"(a) tol=1e-12: one host read a sweep, {reads} for "
          f"{res_t.total_iterations}")
    print(f"  tol=1e-12: {reads} host reads in {res_t.total_iterations} "
          f"sweeps", flush=True)

    # (b) multi-modal: the stacked fit, split
    reset_counts()
    multi, ms_b = timed_once(lambda: rtt.nmf(
        [A[:GRAPH_SPLIT], A[GRAPH_SPLIT:]], GRAPH["k1"],
        maxit=GRAPH["maxit"], tol=0, seed=GRAPH["seed"]))
    launches["cholesky_clip"]["graph (b) multi-modal nmf"] = chol.launches
    check(got() == {"cholesky_clip": 2 * GRAPH["maxit"]},
          f"(b) kernel 6 twice an iteration and no other kernel: {got()}")
    single = rtt.nmf(A, GRAPH["k1"], maxit=GRAPH["maxit"], tol=0,
                     seed=GRAPH["seed"])
    lr = multi["L1"]
    check(np.array_equal(lr.W_blocks["modal1"], single.W[:GRAPH_SPLIT])
          and np.array_equal(lr.W_blocks["modal2"], single.W[GRAPH_SPLIT:])
          and np.array_equal(lr.H, single.H)
          and np.array_equal(lr.d, single.d),
          "(b) W_blocks bit for bit the row split of the single fit")
    times["graph (b) multi-modal"] = ms_b
    print(f"(b) nmf([A[:{GRAPH_SPLIT}], A[{GRAPH_SPLIT}:]], "
          f"{GRAPH['k1']}): W_blocks, d and H bit for bit the stacked fit's; "
          f"{ms_b:.1f} ms (one run)  [{card}]", flush=True)

    # (c) the branched net
    net_c = graph_branched_net(rtt, A)
    reset_counts()
    res_b, ms_c = timed_once(lambda: rtt.fit(net_c))
    keep["(c)"] = res_b
    want = 2 * sum(net_c._warm_iterations) + 2 * 3 * GRAPH["maxit"]
    check(net_c._fused_fn is not None and got() == {"cholesky_clip": want},
          f"(c) the fused path, kernel 6 only, {want} launches: {got()}")
    launches["cholesky_clip"]["graph (c) branched net"] = want
    k_top = GRAPH_BRANCH_KS[2]
    check(res_b["top"].W.shape == (n, k_top)
          and res_b["top"].H.shape == (k_top, sum(GRAPH_BRANCH_KS[:2])
                                       + GRAPH_Z)
          and np.isfinite(res_b.total_loss) and not res_b.chain_topology,
          "(c) the conditioned concat's shapes, a finite loss")
    times["graph (c) branched"] = ms_c
    print(f"(c) Condition(Concat(b1 k={GRAPH_BRANCH_KS[0]}, b2 "
          f"k={GRAPH_BRANCH_KS[1]}), Z) -> k={k_top}: fused, {want} launches "
          f"of cholesky_clip, loss {res_b.total_loss:.6g}; {ms_c:.1f} ms "
          f"(one run)  [{card}]", flush=True)

    # (d) the host loop on the counts
    net_d = graph_host_net(rtt, A_ct)
    reset_counts()
    res_d, ms_d = timed_once(lambda: rtt.fit(net_d))
    g = got()
    check(net_d._fused_fn is None and set(g) == {"cd_nnls_batched",
                                                 "cholesky_clip"},
          f"(d) the host loop: kernel 2 for the GP layer, kernel 6 for the "
          f"MSE layer, no other kernel: {g}")
    check(res_d.total_iterations == GRAPH_HOST_SWEEPS
          and np.isfinite(res_d.total_loss)
          and all(np.isfinite(res_d[lay].loss) for lay in res_d.layers),
          f"(d) finite losses after {GRAPH_HOST_SWEEPS} sweeps")
    launches["cd_nnls_batched"]["graph (d) host loop, GP layer"] = \
        g.get("cd_nnls_batched", 0)
    launches["cholesky_clip"]["graph (d) host loop, MSE layer"] = \
        g.get("cholesky_clip", 0)
    times["graph (d) host loop"] = ms_d
    print(f"(d) GP k={GRAPH_HOST_K} (CD) -> MSE k={GRAPH['k2']} on the "
          f"counts, {GRAPH_HOST_SWEEPS} sweeps: the host loop, launches {g}, "
          f"loss {res_d.total_loss:.6g}; {ms_d:.1f} ms (one run)  [{card}]",
          flush=True)

    # (e) cross_validate_graph
    inp = rtt.factor_input(A, "x")
    reset_counts()
    cv, ms_e = timed_once(lambda: rtt.cross_validate_graph(
        inp, lambda p: rtt.nmf_layer(inp, p["k"], name="L"),
        params={"k": list(GRAPH_CV_KS)},
        config=rtt.factor_config(maxit=GRAPH_CV_MAXIT, seed=GRAPH["seed"],
                                 solver="cd"), reps=GRAPH_CV_REPS))
    g = got()
    check(set(g) == {"cd_nnls_batched"}, f"(e) kernel 2 only: {g}")
    check(len(cv.results) == len(GRAPH_CV_KS) * GRAPH_CV_REPS
          and all(np.isfinite(r["test_loss"]) for r in cv.results),
          f"(e) a finite test loss in every row: {cv.results}")
    launches["cd_nnls_batched"]["graph (e) cross_validate_graph"] = \
        g.get("cd_nnls_batched", 0)
    times["graph (e) cross_validate_graph"] = ms_e
    print(f"(e) cross_validate_graph k={list(GRAPH_CV_KS)} x "
          f"{GRAPH_CV_REPS} reps, maxit={GRAPH_CV_MAXIT}, CD: best "
          f"{cv.best_params}, "
          + ", ".join(f"k={s['k']} test {s['mean_test_loss']:.6g}"
                      for s in cv.summary)
          + f"; {g.get('cd_nnls_batched', 0)} launches of cd_nnls_batched; "
          f"{ms_e:.1f} ms (one run)  [{card}]", flush=True)

    # (f) predict on the held-back columns
    reset_counts()
    pred, ms_f = timed_once(lambda: res_a.predict(A_new))
    check(got() == {"cholesky_clip": 2},
          f"(f) one launch of kernel 6 a layer: {got()}")
    launches["cholesky_clip"]["graph (f) predict"] = 2
    on_cpu = res_a.predict(A_new.cpu(), device="cpu")
    off = max(float(np.abs(pred[lay] - on_cpu[lay]).max()
                    / np.abs(on_cpu[lay]).max()) for lay in on_cpu)
    check(set(pred) == {"L1", "L2"}
          and pred["L1"].shape == (GRAPH["k1"], GRAPH_HELD_BACK)
          and pred["L2"].shape == (GRAPH["k2"], GRAPH_HELD_BACK)
          and all(np.isfinite(v).all() for v in pred.values())
          and off <= PROJ_RTOL,
          f"(f) predict: shapes, finite, within {PROJ_RTOL} of the CPU "
          f"port's ({off:.3g})")
    times["graph (f) predict"] = ms_f
    print(f"(f) predict of {GRAPH_HELD_BACK} held-back columns through both "
          f"layers: within {off:.2e} of the CPU port's; {ms_f:.2f} ms (one "
          f"run)  [{card}]", flush=True)
    return times, launches


# ---------------------------------------------------------------------------
# The device mesh (phase 31)
# ---------------------------------------------------------------------------

def kernel_wrappers():
    """The eight kernel wrappers by name, each with its ``launches``."""
    from rcppml_tpu_torch.ops import (cd_nnls, cd_nnls_batched,
                                      cholesky_clip, fused_als, rhs_tall,
                                      weighted_gram, wgram)
    return {"cd_nnls_shared": cd_nnls.cd_nnls_shared,
            "cd_nnls_batched": cd_nnls_batched.cd_nnls_batched,
            "weighted_gram_rhs": wgram.weighted_gram_rhs,
            "fused_als": fused_als.fused_als,
            "rhs_tall": rhs_tall.rhs_tall, "rhs_tall_t": rhs_tall.rhs_tall_t,
            "weighted_gram": weighted_gram.weighted_gram,
            "cholesky_clip": cholesky_clip.cholesky_clip}


def mesh_fit(rtt, data, label, mesh=None):
    """The MESH_FITS call ``label`` on the host arrays of ``data`` (``A``,
    ``counts``, ``mask``), on ``mesh`` or on the card alone."""
    matrix, k, kw = MESH_FITS[label]
    kw = dict(kw)
    mask = data["mask"] if kw.pop("masked", False) else None
    return rtt.nmf(data[matrix], k, mask=mask, mesh=mesh, **kw)


def result_digest(res) -> str:
    """A SHA-256 of a result's factors and histories (bit for bit)."""
    import hashlib
    h = hashlib.sha256()
    for name in ("W", "d", "H", "loss_history", "test_loss_history"):
        val = getattr(res, name, None)
        if val is not None:
            h.update(np.ascontiguousarray(val).tobytes())
    return h.hexdigest()


def mesh_rank(rank, init_file, data_dir, out_dir):
    """One rank of phase 31 (b), started by ``torch.multiprocessing`` with
    the spawn method: joins the gloo group of MESH_RANKS ranks, all on card
    0, and runs every MESH_FITS call on MESH_SHAPE from the host matrices
    in ``data_dir`` (memory-mapped: a rank copies only its block to the
    card).  Each fit runs twice: timed on the host clock, then under
    ``torch.profiler`` for the device time of this rank's kernels.  Rank 0
    gathers every rank's launches, times and result digest and writes them,
    with its own results, to ``out_dir``."""
    import warnings
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    # one profile a fit: the warning about cycles of a schedule is not ours
    warnings.filterwarnings("ignore", message=".*Profiler clears events")

    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.parallel import multihost
    torch.cuda.set_device(0)
    rtt.set_fp32_precision()
    os.environ.pop("RCPPML_FUSED_WGRAM", None)
    multihost.initialize(init_method=f"file://{init_file}",
                         num_processes=MESH_RANKS, process_id=rank,
                         backend="gloo", device="cuda:0")
    mesh = rtt.default_mesh(shape=MESH_SHAPE)
    ready = time.time()
    wrappers = kernel_wrappers()
    data = {name: np.load(os.path.join(data_dir, f"{name}.npy"),
                          mmap_mode="r") for name in ("A", "counts", "mask")}
    report = {}
    for label in MESH_FITS:
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = mesh_fit(rtt, data, label, mesh)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mesh_fit(rtt, data, label, mesh)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3
        mine = {"launches": launches, "wall_s": wall_s,
                "device_ms": device_ms, "digest": result_digest(res),
                "inner": res.misc.get("irls_inner_iterations"),
                "host_syncs": res.misc.get("host_syncs")}
        every = [None] * MESH_RANKS
        dist.all_gather_object(every, mine)
        report[label] = every
        if rank == 0:
            np.savez(os.path.join(out_dir, f"fit{list(MESH_FITS).index(label)}"
                                  ".npz"),
                     **{name: np.asarray(getattr(res, name))
                        for name in ("W", "d", "H", "loss_history",
                                     "test_loss_history")
                        if getattr(res, name, None) is not None},
                     train_loss=res.train_loss, test_loss=res.test_loss,
                     iterations=res.iterations)
    consumers = mesh_consumers(rtt, mesh, rank, data_dir, out_dir, data,
                               wrappers, report)
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump({"ready": ready, "fits": report,
                       "consumers": consumers}, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_consumers(rtt, mesh, rank, data_dir, out_dir, data, wrappers,
                   fits):
    """Phase 32 on one rank of phase 31's mesh: every path of MESH_CKPT,
    MESH_STREAMS and MESH_GRAPHS once, each under ``torch.profiler`` (the
    device time of this rank's kernels), its launches counted from zero.
    ``fits``: phase 31's report (the uninterrupted mesh fits' digests and
    launches).  Returns, on rank 0, {path: every rank's report}; rank 0
    writes its own results to ``out_dir``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from rcppml_tpu_torch.models import graph as tg
    from rcppml_tpu_torch.parallel import mesh as mesh_mod
    data = dict(data, nb=np.load(os.path.join(data_dir, "nb.npy"),
                                 mmap_mode="r"))
    spz = os.path.join(data_dir, "i.spz")
    A_graph = np.load(os.path.join(data_dir, "graph.npy"))
    report = {}

    def run(path, fn):
        for w in wrappers.values():
            w.launches = 0
        before = dict(mesh_mod.traffic)
        t_path = time.perf_counter()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res, extra = fn()
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # the CUDA activities' durations summed from the raw trace: what
        # key_averages() sums as their self device time, without building
        # its event tree (tens of seconds for a stream's events); the paths
        # other than the streams print key_averages()'s sum beside it
        device_ms = sum(e.duration_ns()
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA) / 1e6
        mine = {"launches": {name: w.launches
                             for name, w in wrappers.items()},
                "wall_s": wall_s, "device_ms": device_ms,
                "traffic": {key: mesh_mod.traffic[key] - before[key]
                            for key in before}, **extra}
        if not path.startswith("stream"):
            mine["key_averages_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3
        # the whole path on this rank: the wait for the others, the fit,
        # the profiler's own work on its events
        mine["path_s"] = time.perf_counter() - t_path
        every = [None] * MESH_RANKS
        dist.all_gather_object(every, mine)
        report[path] = every
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{path}.npz"), **res)
        return mine

    def arrays(res):
        return {name: np.asarray(getattr(res, name))
                for name in ("W", "d", "H", "loss_history",
                             "test_loss_history", "theta", "pi_row")
                if getattr(res, name, None) is not None} | {
            "train_loss": res.train_loss, "test_loss": res.test_loss,
            "iterations": res.iterations}

    # (a) checkpointed mesh fits
    for i, (label, (matrix, k, kw, every)) in enumerate(MESH_CKPT.items()):
        path = os.path.join(out_dir, f"ckpt{i}.npz")
        half = kw["maxit"] // 2

        def uninterrupted():
            res = rtt.nmf(data[matrix], k, mesh=mesh, **kw)
            return arrays(res), {"digest": result_digest(res)}
        whole = (fits[label][rank] if label in fits
                 else run(f"uninterrupted {label}", uninterrupted))

        def ckpt():
            rtt.nmf(data[matrix], k, mesh=mesh, checkpoint_path=path,
                    checkpoint_every=every, **dict(kw, maxit=half))
            res = rtt.nmf(data[matrix], k, mesh=mesh, checkpoint_path=path,
                          checkpoint_every=every, **kw)
            return arrays(res), {"digest": result_digest(res),
                                 "uninterrupted": whole["digest"],
                                 "uninterrupted_launches":
                                     whole["launches"],
                                 "segments": -(-half // every) + -(-(
                                     kw["maxit"] - half) // every)}
        run(f"checkpointed {label}", ckpt)

    # (b) sharded streams of (i), every rank reading the file itself
    for label, (k, kw) in MESH_STREAMS.items():
        def stream():
            res = stream_fit(spz, k, mesh=mesh, **kw)
            stats = res.misc["stream"]
            return arrays(res), {"decode_s": stats["decode_s"],
                                 "sweep_s": stats["sweep_s"],
                                 "upload_bytes": stats["upload_bytes"],
                                 "digest": result_digest(res)}
        run(f"stream {label}", stream)

    # (c) phase 30's nets on the mesh
    for label in MESH_GRAPHS:
        net = (graph_deep_net(rtt, A_graph) if label == "(a)"
               else graph_branched_net(rtt, A_graph))

        def graph():
            reads = tg._outer_als.host_reads
            res = rtt.fit(net, mesh=mesh)
            out = {"total_loss": res.total_loss,
                   "iterations": res.total_iterations}
            for name, lr in res.layers.items():
                for f in ("W", "d", "H"):
                    out[f"{name}.{f}"] = getattr(lr, f)
            h = __import__("hashlib").sha256()
            for key in sorted(out):
                h.update(np.ascontiguousarray(out[key]).tobytes())
            return out, {"digest": h.hexdigest(),
                         "warm": sum(net._warm_iterations),
                         "host_reads": tg._outer_als.host_reads - reads}
        run(f"graph {label}", graph)
    return report


def mesh_phase_one_rank(rtt, counted, reset_counts, chol, cd_shared, A_pb,
                        res_ch, res_cd):
    """Phase 31 (a): the (1, 1) mesh at world size 1 over NCCL.  The fits
    are bit for bit the plain ones of phases 4 and 5, with the same
    launches (no collective runs on an axis of one rank).  Returns the
    launches by label."""
    import socket
    import torch.distributed as dist
    from rcppml_tpu_torch.parallel import multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        check(info["backend"] == "nccl" and info["process_count"] == 1,
              f"a one-rank NCCL group on the card: {info}")
        probe = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        check(probe.tolist() == [0.0, 1.0, 2.0, 3.0],
              "an all-reduce over the one-rank NCCL group")
        mesh = rtt.default_mesh(health_check=True)
        check(mesh.shape == {"rows": 1, "cols": 1},
              f"the default mesh of one rank: {mesh.shape}")
        launches = {}
        for label, plain, kernel, kw in (
                ("MSE default k=20", res_ch, chol, {}),
                ("MSE CD k=20", res_cd, cd_shared, {"solver": "cd"})):
            reset_counts()
            res = rtt.nmf(A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1,
                          mesh=mesh, **kw)
            launches[label] = kernel.launches
            check(kernel.launches == 2 * MAXIT and sum(
                fn.launches for fn in counted) == kernel.launches,
                f"{label} on the (1, 1) mesh: {2 * MAXIT} launches of "
                f"{kernel.__name__} and no other: {kernel.launches}")
            check(same_factors(res, plain) and np.array_equal(
                res.loss_history, plain.loss_history),
                f"{label} on the (1, 1) mesh is the plain fit bit for bit")
            print(f"(a) {label}, (1, 1) mesh over NCCL: {kernel.launches} "
                  f"launches of {kernel.__name__}; W, d, H and the loss "
                  f"history bit for bit the plain fit's", flush=True)
    finally:
        dist.destroy_process_group()
    return launches


def mesh_gaps(res, ref, tr, label):
    """(gap, bar, what, W error, H error) of a mesh fit's result ``res``
    (a dict of arrays) against the single-card fit ``ref``, with the bars of
    ``label``'s kind."""
    W_err = float(np.abs(res["W"] - ref.W).max() / np.abs(ref.W).max())
    H_err = float(np.abs(res["H"] - ref.H).max() / np.abs(ref.H).max())
    if label.startswith(("CV", "masked")):
        gap = abs(float(res["test_loss"]) / ref.test_loss - 1)
        return gap, MESH_CV_RTOL, "test loss, relative", W_err, H_err
    if label.startswith("KL"):
        gap = abs(float(res["train_loss"]) / ref.train_loss - 1)
        return gap, MESH_IRLS_RTOL, "loss, relative", W_err, H_err
    gap = abs(float(res["train_loss"]) - ref.train_loss) / tr
    return gap, MESH_LOSS_TR, "loss over tr(A'A)", W_err, H_err


def mesh_phase_ranks(rtt, card, refs, order_refs, A_pb, A_ct, M_pb, extra):
    """Phase 31 (b): MESH_RANKS ranks sharing the card over gloo, a
    MESH_SHAPE mesh at the pbmc3k shape.  ``refs``: the single-card fit of
    each MESH_FITS label; ``order_refs``: for MESH_REORDERED, the
    single-card fit with its sums in the mesh's order (mesh_order_fit).
    Checks each rank's launches, that every rank returned the same result,
    and rank 0's result against the single-card fit (in the mesh's order
    where there is one); prints the times.  ``extra``: phase 32's inputs
    (``nb``, ``graph``: host matrices; ``spz``: the path of (i); ``dir``:
    an empty directory the caller removes, where the ranks read their
    inputs and rank 0 writes its results).  Returns ({kernel: {label:
    launches per rank}}, phase 32's report)."""
    import torch.multiprocessing as mp
    mb, nb = mesh_blocks()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    tmp = extra["dir"]
    for name, t in (("A", A_pb), ("counts", A_ct), ("mask", M_pb),
                    ("nb", extra["nb"]), ("graph", extra["graph"])):
        np.save(os.path.join(tmp, f"{name}.npy"),
                t.cpu().numpy() if isinstance(t, torch.Tensor) else t)
    os.symlink(extra["spz"], os.path.join(tmp, "i.spz"))
    t0, spawned = time.perf_counter(), time.time()
    ctx = mp.start_processes(
        mesh_rank, args=(os.path.join(tmp, "store"), tmp, tmp),
        nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                raise RuntimeError(f"chip_smoke: the {MESH_RANKS} mesh "
                                   f"ranks did not finish within "
                                   f"{MESH_TIMEOUT_S:.0f} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "report.json")) as f:
        report = json.load(f)
    ready_s, consumers = report["ready"] - spawned, report["consumers"]
    report = report["fits"]
    got = {label: dict(np.load(os.path.join(tmp, f"fit{i}.npz")))
           for i, label in enumerate(MESH_FITS)}
    print(f"(b) {MESH_RANKS} ranks, gloo on one card ({card}), mesh "
          f"{MESH_SHAPE}, blocks of {mb} x {nb}: {ranks_s:.1f} s from spawn "
          f"to join, the mesh ready after {ready_s:.1f} s", flush=True)
    launches_by, failed = {}, []
    A64 = A_pb.double()
    tr = float((A64 * A64).sum())
    for label, every in report.items():
        plain = refs[label]
        k = MESH_FITS[label][1]
        digests = {r["digest"] for r in every}
        check(len(digests) == 1, f"{label}: every rank returns the same "
              f"result ({len(digests)} digests)")
        maxit = MESH_FITS[label][2]["maxit"]
        expect = {}
        if label.startswith("MSE"):
            expect["cd_nnls_shared" if "CD" in label else "cholesky_clip"] \
                = 2 * maxit
            if "bf16" in label:
                expect["rhs_tall"] = expect["rhs_tall_t"] = maxit
        for rank, r in enumerate(every):
            want = dict(expect)
            if label.startswith("KL"):
                want["cd_nnls_batched"] = r["inner"]
            elif not label.startswith("MSE"):
                blocks = sum(-(-cols // _block_cols(k, rows, cols))
                             for rows, cols in ((mb, nb), (nb, mb)))
                want["cd_nnls_batched"] = blocks * maxit
            nonzero = {name: n for name, n in r["launches"].items() if n}
            check(nonzero == want, f"{label}, rank {rank}: launches "
                  f"{nonzero}, expected {want}")
        for name, n in every[0]["launches"].items():
            if n:
                launches_by.setdefault(name, {})[
                    f"mesh {MESH_SHAPE} {label}, per rank"] = [
                        r["launches"][name] for r in every]
        res = got[label]
        held = order_refs.get(label, plain)
        gap, bar, what, W_err, H_err = mesh_gaps(res, held, tr, label)
        against = ("the single card in the mesh's order"
                   if label in order_refs else "the single card")
        same = all(np.array_equal(res[f], getattr(held, f)) for f in "WdH")
        bits = "; W, d, H bit for bit" if same else ""
        print(f"  {label}, against {against}: {what} {gap:.2e} (bar "
              f"{bar:g}), W {W_err:.2e}, H {H_err:.2e} of the largest entry "
              f"(bar {STREAM_W_TOL:g}){bits}"
              f"; W after matching columns "
              f"{matched_err(res['W'], held.W):.2e}; "
              f"launches per rank "
              f"{ {n: v for n, v in every[0]['launches'].items() if v} }; "
              f"wall {max(r['wall_s'] for r in every):.2f} s (slowest "
              f"rank), device ms per rank "
              f"{[round(r['device_ms'], 1) for r in every]} (gloo on one "
              f"card, {card})", flush=True)
        hist = np.abs(np.asarray(res["loss_history"], np.float64)
                      / np.asarray(held.loss_history, np.float64) - 1)
        print(f"    loss history against {against}, relative: "
              f"{' '.join(f'{v:.1e}' for v in hist)}", flush=True)
        if label in order_refs:
            spread = mesh_gaps(res, plain, tr, label)
            print(f"    against the plain single-card fit (its own order of "
                  f"sums, not held): {what} {spread[0]:.2e}, W "
                  f"{spread[3]:.2e}, H {spread[4]:.2e}; the single card in "
                  f"the mesh's order against it: "
                  f"{mesh_gaps(vars(held), plain, tr, label)[0]:.2e}",
                  flush=True)
        if int(res["iterations"]) != held.iterations:
            failed.append(f"{label}: {int(res['iterations'])} iterations, "
                          f"the single card {held.iterations}")
        if gap > bar:
            failed.append(f"{label}: {what} {gap:.3g} past {bar:g}")
        if W_err > STREAM_W_TOL or H_err > STREAM_W_TOL:
            failed.append(f"{label}: W, H {W_err:.3g}, {H_err:.3g} of the "
                          f"largest entry past {STREAM_W_TOL}")
    check(not failed, "every mesh fit within its bars of the single-card "
          "fit: " + "; ".join(failed))
    return launches_by, consumers


def consumers_phase(report, out_dir, refs, card, nmf_irls):
    """Phase 32's checks and lines, from the ranks' ``report`` (one entry a
    path, every rank's) and rank 0's results in ``out_dir``.  ``refs``:
    phase 27's streams and phase 30's nets by MESH_STREAMS and MESH_GRAPHS
    label.  Returns ({kernel: {path label: launches per rank}}, the sum of
    the paths' slowest-rank walls in seconds)."""
    launches_by, failed = {}, []
    panels = len(stream_panels(STREAM_I))
    cv_blocks = sum(-(-nc // nmf_irls._block_count(
        nc, STREAM_CV_K, rows, kr=nmf_irls._use_kr(STREAM_CV_K, rows)))
        for rows, nc in mesh_stream_blocks())
    walls = 0.0
    for path, every in report.items():
        res = dict(np.load(os.path.join(out_dir, f"{path}.npz")))
        check(len({r["digest"] for r in every}) == 1,
              f"{path}: every rank returns the same result")
        nonzero = [{n: v for n, v in r["launches"].items() if v}
                   for r in every]
        for name in nonzero[0]:
            launches_by.setdefault(name, {})[
                f"mesh {MESH_SHAPE} {path}, per rank"] = [
                    r["launches"][name] for r in every]
        wall = max(r["wall_s"] for r in every)
        walls += wall
        line = (f"{path}: launches per rank {nonzero[0]}; wall {wall:.2f} s "
                f"(slowest rank, under the profiler; "
                f"{max(r['path_s'] for r in every):.2f} s with the wait and "
                f"the profiler's work), device ms per rank "
                f"{[round(r['device_ms'], 1) for r in every]}")
        if "key_averages_ms" in every[0]:
            line += (" (key_averages: "
                     f"{[round(r['key_averages_ms'], 1) for r in every]})")
        label = path.split(" ", 1)[1]
        if path.startswith("checkpointed"):
            for rank, r in enumerate(every):
                check(r["digest"] == r["uninterrupted"],
                      f"{path}, rank {rank}: bit for bit the uninterrupted "
                      "mesh fit")
                want = {n: v for n, v in r["uninterrupted_launches"].items()
                        if v}
                check(nonzero[rank] == want, f"{path}, rank {rank}: the "
                      f"uninterrupted fit's launches {want}: "
                      f"{nonzero[rank]}")
            line += (f"; bit for bit the uninterrupted mesh fit on every "
                     f"rank, with its launches; {every[0]['segments']} "
                     f"segments, "
                     f"{every[0]['traffic']['to_root'] / every[0]['segments'] / 2**20:.2f}"
                     f" MiB gathered to rank 0 a segment")
        elif path.startswith("stream"):
            ref = refs[label]
            sweeps = len(every[0]["sweep_s"])
            want = ({"cholesky_clip": STREAM_MAXIT * panels}
                    if label.startswith("MSE")
                    else {"cd_nnls_batched": STREAM_CV_MAXIT * cv_blocks})
            for rank in range(MESH_RANKS):
                check(nonzero[rank] == want, f"{path}, rank {rank}: "
                      f"launches {want}: {nonzero[rank]}")
            gap = abs(float(res["train_loss"]) / ref.train_loss - 1)
            W_err = float(np.abs(res["W"] - ref.W).max()
                          / np.abs(ref.W).max())
            if gap > STREAM_LOSS_RTOL or W_err > STREAM_W_TOL:
                failed.append(f"{path}: loss {gap:.3g}, W {W_err:.3g}")
            if label.startswith("CV"):
                line += (f"; test loss {float(res['test_loss']):.6g}, the "
                         f"single card {ref.test_loss:.6g}")
            line += (f"; loss {float(res['train_loss']):.6g} against phase "
                     f"27's {ref.train_loss:.6g} (relative {gap:.2e}, bar "
                     f"{STREAM_LOSS_RTOL:g}), W within {W_err:.2e} of its "
                     f"largest entry (bar {STREAM_W_TOL:g}); host decode a "
                     f"rank {[round(r['decode_s'], 2) for r in every]} s in "
                     f"{sweeps} sweeps ("
                     f"{[round(r['decode_s'] / sweeps, 3) for r in every]} "
                     f"s a sweep), sweeps of rank 0 "
                     f"{[round(t, 2) for t in every[0]['sweep_s']]} s, "
                     f"{every[0]['upload_bytes'] / 2**20:.1f} MiB uploaded "
                     f"a rank, "
                     f"{every[0]['traffic']['gathered'] / sweeps / 2**20:.2f}"
                     f" MiB through the collectives a rank and sweep")
        elif path.startswith("graph"):
            ref = refs[label]
            layers = 2 if label == "(a)" else 3
            for rank, r in enumerate(every):
                want = {"cholesky_clip": 2 * r["warm"]
                        + 2 * layers * GRAPH["maxit"]}
                check(nonzero[rank] == want and r["host_reads"] == 0,
                      f"{path}, rank {rank}: launches {want} and no host "
                      f"read: {nonzero[rank]}, {r['host_reads']}")
            gap = abs(float(res["total_loss"]) / ref.total_loss - 1)
            offs = {f"{name}.{f}": float(
                np.abs(res[f"{name}.{f}"] - getattr(ref[name], f)).max()
                / np.abs(getattr(ref[name], f)).max())
                for name in ref.layers for f in ("W", "d", "H")}
            worst = max(offs, key=offs.get)
            if gap > SMALL_RTOL or offs[worst] > SMALL_FACTOR_TOL:
                failed.append(f"{path}: loss {gap:.3g}, {worst} "
                              f"{offs[worst]:.3g}")
            line += (f"; loss {float(res['total_loss']):.6g} against phase "
                     f"30's {ref.total_loss:.6g} (relative {gap:.2e}, bar "
                     f"{SMALL_RTOL:g}), factors within {offs[worst]:.2e} of "
                     f"their largest entry ({worst}; bar "
                     f"{SMALL_FACTOR_TOL:g}), "
                     + ", ".join(f"{key} {v:.1e}" for key, v in offs.items())
                     + "; "
                     f"{every[0]['traffic']['gathered'] / GRAPH['maxit'] / 2**20:.2f}"
                     f" MiB through the collectives a rank and sweep")
        print(f"{line}  [{card}]", flush=True)
    check(not failed, "every phase 32 path within its bars: "
          + "; ".join(failed))
    return launches_by, walls


def matched_err(W, V):
    """The largest entry of W - V over V's largest, after each column of W
    is matched with its closest column of V (the factors' order is free)."""
    W, V = np.asarray(W, np.float64), np.asarray(V, np.float64)
    cos = (W / np.linalg.norm(W, axis=0)).T @ (V / np.linalg.norm(V, axis=0))
    return float(np.abs(W - V[:, np.argmax(cos, axis=1)]).max()
                 / np.abs(V).max())


def _block_cols(k, rows, cols):
    """The column block width of a per-column-Gram solve (nmf_irls)."""
    from rcppml_tpu_torch.models import nmf_irls
    return nmf_irls._block_count(cols, k, rows, kr=nmf_irls._use_kr(k, rows))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on the card")
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.models import nmf_cv, nmf_irls
    from rcppml_tpu_torch.ops import (_build, cd_nnls, cd_nnls_batched,
                                      cholesky_clip, fused_als, linalg,
                                      rhs_tall, solvers, weighted_gram, wgram)
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    cd_shared, cd_batched = cd_nnls.cd_nnls_shared, \
        cd_nnls_batched.cd_nnls_batched
    wg = wgram.weighted_gram_rhs
    fused, rhs_f, rhs_t = fused_als.fused_als, rhs_tall.rhs_tall, \
        rhs_tall.rhs_tall_t
    wg5, chol = weighted_gram.weighted_gram, cholesky_clip.cholesky_clip
    counted = (cd_shared, cd_batched, wg, fused, rhs_f, rhs_t, wg5, chol)

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        fused.calls = 0

    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    print(card, flush=True)
    if not rtt.kernels_available():
        raise SystemExit("chip_smoke: the kernels need compute capability "
                         "9.0 (sm_90a)")
    rtt.set_fp32_precision()
    os.environ.pop("RCPPML_FUSED_WGRAM", None)

    phase("2 build")
    t0 = time.perf_counter()
    built = _build.build_all()
    check(sorted(built) == sorted([cd_nnls.KERNEL, cd_nnls_batched.KERNEL,
                                   wgram.KERNEL, fused_als.KERNEL,
                                   rhs_tall.KERNEL, weighted_gram.KERNEL,
                                   cholesky_clip.KERNEL]),
          f"the seven sources were built: {sorted(built)}")
    for name, (path, seconds) in built.items():
        print(f"built {path.name} in {seconds:.2f} s", flush=True)
        # one line per distinct report: the product tiles are instantiated
        # sixteen times
        for line in sorted({line.split(":", 1)[1].strip() for line in
                            path.with_suffix(".so.log").read_text().splitlines()
                            if "registers" in line}):
            print("  ptxas:", line, flush=True)
    print(f"all seven, side by side: {time.perf_counter() - t0:.2f} s",
          flush=True)
    if "--profile" in sys.argv[1:]:
        phase(f"profiles on {card}")
        profile_fits(rtt, card)
        return

    phase("3 shared-Gram CD kernel against its plain twin (bitwise)")
    err_shared = check_cd_kernel(cd_shared, cd_nnls.cd_nnls_shared_plain,
                                 cd_nnls.plan_cd, cd_system,
                                 CD_CASES + STREAM_CD_CASES
                                 + [(k, n, 0.0, 0.0, False)
                                    for k, n in mesh_chol_cases()]
                                 + GRAPH_CD_CASES)

    phase("4 MSE path, CD solver")
    A_pb = simulated(PBMC)
    reset_counts()
    res_cd = mse_cd_fit(rtt, A_pb)
    launches_shared = cd_shared.launches
    print(f"pbmc3k shape, k=20, CD: {launches_shared} kernel launches",
          flush=True)
    check(launches_shared == 2 * MAXIT,
          f"{2 * MAXIT} kernel launches, got {launches_shared}")
    check(sum(fn.launches for fn in counted) == launches_shared,
          "the MSE CD fit launches no other kernel")
    hist, mse, var = check_losses(res_cd, A_pb, monotone=True)
    print(f"  loss {hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < "
          f"var(A) {var:.6g}", flush=True)
    with plain_cd_twin():
        plain_fit_ms = cuda_ms(lambda: check(np.array_equal(
            mse_cd_fit(rtt, A_pb).loss_history, res_cd.loss_history),
            "the fit through the plain twin has the same loss history"),
            reps=1, warmup=False)
    print("  the same fit through the plain twin: identical loss history",
          flush=True)

    A_ml = simulated(MOVIELENS)
    cd_shared.launches = 0
    res_ml = rtt.nmf(A_ml, MOVIELENS["k"], L1=(0, 0.01), maxit=MAXIT, tol=0,
                     seed=1)
    ml_launches = cd_shared.launches
    print(f"movielens shape, k=50, L1=(0, 0.01), solver "
          f"{res_ml.misc['config'].solver.name}: {ml_launches} kernel "
          f"launches", flush=True)
    check(ml_launches == 2 * MAXIT,
          f"{2 * MAXIT} kernel launches, got {ml_launches}")
    hist, mse, var = check_losses(res_ml, A_ml, monotone=False)
    print(f"  loss {hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < "
          f"var(A) {var:.6g}", flush=True)

    phase("5 MSE path, default solver (Cholesky)")
    reset_counts()
    with counted_calls(torch.linalg, "cholesky") as linalg_cholesky:
        res_ch = rtt.nmf(A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1)
    launches_chol = chol.launches
    check(res_ch.misc["config"].solver.name == "CHOLESKY",
          "auto selects Cholesky at k=20 without L1")
    check(launches_chol == 2 * MAXIT
          and sum(fn.launches for fn in counted) == launches_chol,
          f"{2 * MAXIT} launches of cholesky_clip and no other kernel: "
          f"{launches_chol}")
    check(linalg_cholesky.calls == 0,
          "the Cholesky fit on the card calls no torch.linalg.cholesky")
    hist, mse, var = check_losses(res_ch, A_pb, monotone=True)
    print(f"pbmc3k shape, k=20, Cholesky: {launches_chol} launches of "
          f"cholesky_clip, no torch.linalg.cholesky; loss "
          f"{hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < var(A) "
          f"{var:.6g}", flush=True)
    # a rank-1 matrix, whose ridged fp32 Grams are close to singular: the
    # card (kernel 6) and the CPU (cholesky_ex, or kernel 6's twin where
    # LAPACK refuses) both run to the end with finite losses
    rs = np.random.default_rng(0)
    A_r1 = np.outer(rs.random(RANK1[0]), rs.random(RANK1[1])).astype(
        np.float32)
    r1 = {dev: rtt.nmf(A_r1, RANK1_K, maxit=10, tol=0, seed=1, device=dev)
          for dev in ("cuda", "cpu")}
    for dev, res in r1.items():
        print(f"rank-1 {RANK1[0]}x{RANK1[1]}, k={RANK1_K}, on the {dev}: "
              f"loss {res.loss_history[0]:.6g} -> {res.loss_history[-1]:.6g}",
              flush=True)
    check(all(np.isfinite(res.loss_history).all() and np.isfinite(res.W).all()
              and np.isfinite(res.H).all() for res in r1.values()),
          "the rank-1 fit ends finite on the card and on the CPU")

    phase("6 per-column-Gram CD kernel against its plain twin (bitwise)")
    err_batched = check_cd_kernel(cd_batched,
                                  cd_nnls_batched.cd_nnls_batched_plain,
                                  cd_nnls_batched.plan_cd, cd_batched_system,
                                  CDB_CASES + stream_cdb_cases(nmf_irls)
                                  + graph_cdb_cases(nmf_irls)
                                  + mesh_cdb_cases(nmf_irls)
                                  + mesh_consumer_cdb_cases(nmf_irls))

    phase("7 fused weight + Gram + RHS kernel against its plain twin "
          f"(within {WGRAM_RTOL} of the twin's largest entry)")
    err_wgram = rel_wgram = 0.0
    for kind, power, theta, sparse, k, m, bc, forced in wgram_cases():
        F, X, A, th_r, th_c = wgram_inputs(k, m, bc, seed=k * 1009 + m,
                                           theta=theta)
        kw = dict(loss_kind=kind, power=power, sparse_zeros=sparse)
        with forced_wgram_plan(forced):
            Gb, b = wg(F, X, A, th_r, th_c, **kw)
            Gb2, b2 = wg(F, X, A, th_r, th_c, **kw)
        torch.cuda.synchronize()
        check(torch.equal(Gb, Gb2) and torch.equal(b, b2),
              "a second launch on the same inputs is bitwise equal")
        Gp, bp = wgram.weighted_gram_rhs_plain(F, X, A, th_r, th_c, **kw)
        check(bool(torch.isfinite(Gb).all() and torch.isfinite(b).all()),
              "finite Gram and RHS")
        eg, eb = float((Gb - Gp).abs().max()), float((b - bp).abs().max())
        rg, rb = eg / float(Gp.abs().max()), eb / float(bp.abs().max())
        err_wgram, rel_wgram = max(err_wgram, eg, eb), max(rel_wgram, rg, rb)
        plan = (f"(splits, mode) forced to {forced}" if forced else
                f"plan {wgram.plan_wgram(k, m, bc)}")
        print(f"{kind:5s} p={power} theta={theta} sparse_zeros={sparse} "
              f"k={k:3d} m={m:5d} bc={bc:5d}, {plan}: Gb off by {rg:.2e}, b "
              f"by {rb:.2e} of the largest entry; bitwise repeatable",
              flush=True)
        check(rg <= WGRAM_RTOL and rb <= WGRAM_RTOL,
              f"kernel within {WGRAM_RTOL} of the twin at {kind} p={power} "
              f"theta={theta} sparse={sparse} k={k} m={m} bc={bc}: "
              f"{rg:.3g}, {rb:.3g}")
        del F, X, A, Gb, b, Gb2, b2, Gp, bp
    print(f"largest error: {rel_wgram:.3e} relative, {err_wgram:.3e} "
          f"absolute", flush=True)

    phase("8 IRLS path at the pbmc3k shape")
    A_ct, info = pbmc_counts(KL_K)
    A_nb, info_nb = pbmc_counts(NBZI_K, **NBZI_DATA)
    shape = tuple(A_ct.shape)
    for label, A, made in (("Poisson counts", A_ct, info),
                           (f"counts {NBZI_DATA}", A_nb, info_nb)):
        print(f"{label} {shape}: {float((A == 0).float().mean()):.4f} zeros, "
              f"largest {int(A.max())}, scale {made['scale']:.4g}",
              flush=True)

    def fit_kl(maxit=KL_MAXIT):
        return kl_fit(rtt, A_ct, maxit)

    def fit_nbzi():
        return nbzi_fit(rtt, A_nb)

    # (i) KL through the default path: kernel 2 once per inner iteration
    reset_counts()
    res_kl = fit_kl()
    launches_batched = cd_batched.launches
    inner = res_kl.misc["irls_inner_iterations"]
    hist_kl = check_irls(res_kl, KL_MAXIT, KL_K, shape)
    print(f"(i) KL k={KL_K}, {KL_MAXIT} iterations: {launches_batched} "
          f"launches of cd_nnls_batched for {inner} inner iterations, "
          f"{res_kl.misc['host_syncs']} host syncs; loss {hist_kl[0]:.6g} -> "
          f"{hist_kl[-1]:.6g}", flush=True)
    check(launches_batched == inner and 2 * KL_MAXIT <= inner <= 200,
          f"one launch per inner iteration, 40 to 200: {launches_batched}, "
          f"{inner}")
    check(sum(fn.launches for fn in counted) == launches_batched,
          "the default IRLS path launches only cd_nnls_batched")
    check(same_factors(fit_kl(), res_kl),
          "the same seed gives bitwise equal W, d, H")

    # (ii) the same fit with the fused weighted-Gram kernel switched on
    with fused_wgram():
        reset_counts()
        res_fused = fit_kl()
        launches_wgram, fused_batched = wg.launches, cd_batched.launches
        hist_fused = check_irls(res_fused, KL_MAXIT, KL_K, shape)
        off = float(np.abs(hist_fused / hist_kl - 1).max())
        print(f"(ii) with RCPPML_FUSED_WGRAM: {launches_wgram} launches of "
              f"weighted_gram_rhs, {fused_batched} of cd_nnls_batched; loss "
              f"history within {off:.2e} of (i)", flush=True)
        check(launches_wgram == fused_batched
              == res_fused.misc["irls_inner_iterations"] > 0,
              "one weighted_gram_rhs launch per cd_nnls_batched launch")
        check(off <= 1e-3, f"loss history within 1e-3 of (i): {off}")
        check(same_factors(fit_kl(), res_fused),
              "the same seed gives bitwise equal W, d, H with the fused "
              "kernel")

    # (iii) NB with zero inflation per row
    cd_batched.launches = 0
    res_nb = fit_nbzi()
    nb_launches = cd_batched.launches
    hist_nb = check_irls(res_nb, NBZI_MAXIT, NBZI_K, shape, falling=False)
    cfg_nb = res_nb.misc["config"]
    check(res_nb.theta is not None and res_nb.theta.shape == (shape[0],)
          and (res_nb.theta >= cfg_nb.nb_size_min).all()
          and (res_nb.theta <= cfg_nb.nb_size_max).all(),
          "theta inside [nb_size_min, nb_size_max]")
    inside = float(((res_nb.theta > cfg_nb.nb_size_min)
                    & (res_nb.theta < cfg_nb.nb_size_max)).mean())
    check(inside >= NBZI_THETA_INSIDE,
          f"theta strictly inside its bounds in {inside:.3f} of the rows")
    pi_corr = float(np.corrcoef(res_nb.pi_row, info_nb["pi_row"])[0, 1])
    check(res_nb.pi_row is not None and res_nb.pi_row.shape == (shape[0],)
          and (res_nb.pi_row >= 0.001).all() and (res_nb.pi_row <= 0.999).all(),
          "pi_row inside [0.001, 0.999]")
    check(nb_launches == res_nb.misc["irls_inner_iterations"],
          "one launch per inner iteration")
    print(f"(iii) NB + zi=row k={NBZI_K}, {NBZI_MAXIT} iterations: "
          f"{nb_launches} launches of cd_nnls_batched; loss {hist_nb[0]:.6g} "
          f"-> {hist_nb[-1]:.6g}; theta {res_nb.theta.min():.3g}.."
          f"{res_nb.theta.max():.3g}, strictly inside its bounds in "
          f"{inside:.3f} of the rows, median of those "
          f"{float(np.median(res_nb.theta[res_nb.theta < cfg_nb.nb_size_max])):.3g}"
          f" (data: {NBZI_DATA['nb_size']}); pi_row {res_nb.pi_row.min():.3g}.."
          f"{res_nb.pi_row.max():.3g}, correlation with the data's dropout "
          f"{pi_corr:.3f}", flush=True)

    # the same counts without zero inflation: there the NB loss falls
    res_nb0 = rtt.nmf(A_nb, NBZI_K, loss="nb", maxit=NBZI_MAXIT, tol=0, seed=1)
    hist_nb0 = check_irls(res_nb0, NBZI_MAXIT, NBZI_K, shape)
    inside0 = float(((res_nb0.theta > cfg_nb.nb_size_min)
                     & (res_nb0.theta < cfg_nb.nb_size_max)).mean())
    check(inside0 >= NBZI_THETA_INSIDE,
          f"theta strictly inside its bounds in {inside0:.3f} of the rows")
    print(f"      NB without zi on the same counts: loss {hist_nb0[0]:.6g} -> "
          f"{hist_nb0[-1]:.6g}; theta strictly inside its bounds in "
          f"{inside0:.3f} of the rows", flush=True)

    # (iv) two KL iterations through the kernels and through their twins
    with fused_wgram():
        two = fit_kl(2)
        with plain_cd_twin():
            two_cd_plain = fit_kl(2)
            with plain_wgram_twin():
                cd_batched.launches = wg.launches = 0
                two_plain = fit_kl(2)
                check(cd_batched.launches == 0 and wg.launches == 0,
                      "the fit through both twins launches no kernel")
    check(np.array_equal(two.loss_history, two_cd_plain.loss_history),
          "with cd_nnls_batched alone swapped for its twin the loss "
          "histories are bitwise equal")
    off = float(np.abs(two_plain.loss_history / two.loss_history - 1).max())
    check(off <= 1e-3, f"both twins: loss history within 1e-3: {off}")
    print(f"(iv) KL, 2 iterations, fused: cd_nnls_batched swapped for its "
          f"twin: identical loss history; both kernels swapped: within "
          f"{off:.2e}", flush=True)

    # (v) a small corner of the same counts, on the card and on the CPU,
    # where the wrappers run their twins
    for label, fit, A in (
            ("KL", lambda r, a: kl_fit(r, a, NBZI_MAXIT), A_ct),
            ("NB + zi=row", nbzi_fit, A_nb)):
        small = A[:SMALL[0], :SMALL[1]].contiguous()
        on_card, on_cpu = fit(rtt, small), fit(rtt, small.cpu())
        off = float(np.abs(np.asarray(on_card.loss_history)
                           / np.asarray(on_cpu.loss_history) - 1).max())
        far = max(float(np.abs(getattr(on_card, f) - getattr(on_cpu, f)).max()
                        / np.abs(getattr(on_cpu, f)).max()) for f in "WdH")
        print(f"(v) {label} at {SMALL}, {NBZI_MAXIT} iterations, card "
              f"against CPU: loss history within "
              f"{off:.2e}, W, d, H within {far:.2e} of their largest entry",
              flush=True)
        check(off <= SMALL_RTOL and far <= SMALL_FACTOR_TOL,
              f"{label} on the card agrees with the CPU fit: {off}, {far}")

    phase(f"9 tall-skinny product kernels against their twins (within "
          f"{RHS_RTOL} of the twin's largest entry)")
    rs = np.random.RandomState(11)
    rhs_shapes = {"odd": RHS_ODD_SHAPE, **RHS_ALIGN_SHAPES}
    A_rhs = {label: torch.from_numpy((rs.rand(*shape) * (rs.rand(*shape) < 0.3))
                                     .astype(np.float32)).cuda()
             for label, shape in rhs_shapes.items()}
    # a rank's block of phase 31's bf16_data fit, where kernels 7 and 8 run
    mb, nb = mesh_blocks()
    A_rhs[f"pbmc3k mesh {MESH_SHAPE} block"] = A_pb[:mb, :nb].contiguous()
    errs_rhs = check_rhs_kernels({"movielens": A_ml, "pbmc3k": A_pb, **A_rhs})
    for name, (err, rel) in errs_rhs.items():
        print(f"{name}, largest float32 error: {rel:.3e} relative, "
              f"{err:.3e} absolute", flush=True)

    phase("10 whole-fit Newton-Schulz ALS kernel against its twin (one "
          f"iteration, and every half step of {MAXIT}, within "
          f"{FUSED_RTOL_ONE}; {MAXIT} iterations in one call: loss within "
          f"{FUSED_LOSS_RTOL}, float32 factors within {FUSED_FACTOR_TOL}; "
          f"half steps also at k={FUSED_WIDE_K} and {FUSED_SCRATCH_K})")
    cells = {"movielens": (A_ml, MOVIELENS), "pbmc3k": (A_pb, PBMC)}
    err_fused, rel_fused = check_fused_kernel(cells)
    check_fused_wide(A_ml, FUSED_WIDE_K)
    check_fused_wide(A_ml, FUSED_SCRATCH_K)

    phase("11 fused_vmem path, bf16_data, multi-restart, callbacks, profile")
    phases = fused_als.phase_count(MAXIT)
    launches_fused = 0
    for label, (A, shape) in cells.items():
        k = shape["k"]
        base = rtt.nmf(A, k, maxit=CONVERGED_MAXIT, tol=0, seed=1)
        check(base.misc["config"].solver.name == "CHOLESKY",
              "the default fit takes the Cholesky solver")
        for bf16 in (False, True):
            name = "bf16_data" if bf16 else "float32"
            reset_counts()
            res = fused_fit(rtt, A, shape, bf16_data=bf16)
            check(fused.calls == 1 and fused.launches == phases,
                  f"one call enqueuing {phases} kernels: {fused.calls}, "
                  f"{fused.launches}")
            check(sum(fn.launches for fn in counted) == phases,
                  "the fused_vmem fit launches no other kernel")
            if label == "pbmc3k" and not bf16:
                launches_fused = fused.launches
            check(res.iterations == MAXIT and res.converged is False
                  and np.isfinite(res.final_tol),
                  "fixed-iteration result contract")
            hist, mse, var = check_losses(res, A, monotone=False)
            check(same_factors(fused_fit(rtt, A, shape, bf16_data=bf16), res),
                  "the same seed gives bitwise equal W, d, H")
            long_fit = fused_fit(rtt, A, shape, maxit=CONVERGED_MAXIT,
                                 bf16_data=bf16)
            b, f = base.loss_history[-1], long_fit.loss_history[-1]
            print(f"{label} k={k} fused_vmem {name}: 1 call, {phases} "
                  f"kernels, no other launch; loss {hist[0]:.6g} -> "
                  f"{hist[-1]:.6g}; mse {mse:.6g} < var(A) {var:.6g}; after "
                  f"{CONVERGED_MAXIT} iterations {f:.6g} against the "
                  f"Cholesky fit's {b:.6g} ({abs(b - f) / abs(b):.2e} "
                  f"relative)", flush=True)
            check(abs(b - f) / abs(b) <= CONVERGED_RTOL,
                  f"converged loss within {CONVERGED_RTOL} of the default "
                  f"fit's: {f}, {b}")

    # the default loop with bf16_data: kernels 7 and 8 once per iteration
    reset_counts()
    res_bf = rtt.nmf(A_pb, PBMC["k"], bf16_data=True, maxit=MAXIT, tol=0,
                     seed=1)
    launches_rhs, launches_rhs_t = rhs_f.launches, rhs_t.launches
    check(launches_rhs == MAXIT and launches_rhs_t == MAXIT
          and chol.launches == 2 * MAXIT
          and sum(fn.launches for fn in counted) == 4 * MAXIT,
          f"{MAXIT} launches each of rhs_tall and rhs_tall_t, {2 * MAXIT} of "
          f"cholesky_clip and no other: {launches_rhs}, {launches_rhs_t}, "
          f"{chol.launches}")
    hist, mse, var = check_losses(res_bf, A_pb, monotone=False)
    off = float(np.abs(hist / np.asarray(res_ch.loss_history, np.float64)
                       - 1).max())
    print(f"pbmc3k k=20 Cholesky bf16_data: {launches_rhs} launches of "
          f"rhs_tall, {launches_rhs_t} of rhs_tall_t; loss {hist[0]:.6g} -> "
          f"{hist[-1]:.6g}, within {off:.2e} of the float32 fit's; mse "
          f"{mse:.6g} < var(A) {var:.6g}", flush=True)
    check(off <= 2e-2, f"bf16_data loss history within 2e-2 of float32: {off}")
    check(same_factors(rtt.nmf(A_pb, PBMC["k"], bf16_data=True, maxit=MAXIT,
                               tol=0, seed=1), res_bf),
          "the same seed gives bitwise equal W, d, H with bf16_data")

    seeds = [1, 2, 3]
    multi = rtt.nmf(A_ml, MOVIELENS["k"], fused_vmem=True, tol=0, maxit=MAXIT,
                    seed=seeds)
    inits = multi.misc["all_inits"]
    best = [r["selected"] for r in inits].index(True)
    check(len(inits) == 3 and inits[best]["loss"] == min(
        r["loss"] for r in inits) and np.isfinite(multi.loss_history).all(),
          f"the best of three restarts is selected: {inits}")
    check(same_factors(rtt.nmf(A_ml, MOVIELENS["k"], fused_vmem=True, tol=0,
                               maxit=MAXIT, seed=seeds[best]), multi),
          "the selected restart equals its standalone fit")
    print(f"movielens k=50 fused_vmem seed={seeds}: losses "
          f"{[round(r['loss'], 1) for r in inits]}, restart {best} selected",
          flush=True)

    calls = []
    stepped = rtt.nmf(A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1,
                      on_iteration=lambda it, train, test: calls.append(
                          (it, train)))
    check([c[0] for c in calls] == list(range(1, MAXIT + 1))
          and np.array_equal(np.float32([c[1] for c in calls]),
                             stepped.loss_history),
          f"the callback is called {MAXIT} times with the losses")
    check(np.array_equal(stepped.loss_history, res_ch.loss_history),
          "step mode has the loop's loss history")
    sections = {key: round(v, 2) for key, v in stepped.profile.items()}
    print(f"pbmc3k k=20 on_iteration: {len(calls)} calls; sections "
          f"{sections} ms", flush=True)
    profiled = rtt.nmf(A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1,
                       profile=True)
    check(profiled.profile.get("mode") == "fused-segmented"
          and profiled.profile["iterations"] == MAXIT
          and np.array_equal(profiled.loss_history, res_ch.loss_history),
          f"the profiled fit is the loop in segments: {profiled.profile}")
    timed = {key: round(v, 2) for key, v in profiled.profile.items()
             if isinstance(v, float)}
    print(f"pbmc3k k=20 profile=True: {timed}", flush=True)

    phase("12 per-column weighted Gram + RHS kernel against its plain twin "
          f"(within {WG5_RTOL} of the twin's largest entry)")
    err_wg5, rel_wg5 = check_weighted_gram()
    print(f"largest error: {rel_wg5:.3e} relative, {err_wg5:.3e} absolute",
          flush=True)

    phase("13 Cholesky solve + clip kernel against its plain twin "
          f"(bitwise) and torch.linalg (within {CHOL_LINALG_RTOL} of the "
          f"largest entry)")
    err_chol, rel_chol, _ = check_cholesky_clip()

    phase("14 the holdout mask on the card against the host's")
    check_holdout()

    phase("15 cross-validated and masked fits at the pbmc3k shape, rank "
          "sweep and rank search")
    m_pb, n_pb = PBMC["m"], PBMC["n"]

    def column_blocks(k, rows, cols):
        """Column blocks of one side's masked solve: ``cols`` columns
        against a (k, rows) factor."""
        bc = nmf_irls._block_count(cols, k, rows,
                                   kr=nmf_irls._use_kr(k, rows))
        return -(-cols // bc)

    def cv_fit(A, maxit=MAXIT, k=CV_K, **kw):
        return rtt.nmf(A, k, test_fraction=CV_FRACTION, cv_seed=1,
                       maxit=maxit, tol=0, cv_patience=maxit + 1, seed=1,
                       **kw)

    def same_fit(a, b):
        return same_factors(a, b) and np.array_equal(
            a.loss_history, b.loss_history) and np.array_equal(
            a.test_loss_history, b.test_loss_history)

    # (i) speckled CV, k=16, CD solver: kernel 2 once per column block
    reset_counts()
    res_cv_cd = cv_fit(A_pb, solver="cd")
    launches_cv_batched = cd_batched.launches
    blocks = column_blocks(CV_K, m_pb, n_pb) + column_blocks(CV_K, n_pb, m_pb)
    train, test = check_cv_histories(res_cv_cd, MAXIT)
    check(launches_cv_batched == blocks * MAXIT
          and sum(fn.launches for fn in counted) == launches_cv_batched,
          f"{blocks * MAXIT} launches of cd_nnls_batched and no other "
          f"kernel: {launches_cv_batched}")
    check(res_cv_cd.misc["host_syncs"] == MAXIT,
          f"one host read per iteration: {res_cv_cd.misc['host_syncs']}")
    check(same_fit(cv_fit(A_pb, solver="cd"), res_cv_cd),
          "the same seeds give bitwise equal factors and histories")
    print(f"(i) CV k={CV_K}, test_fraction={CV_FRACTION}, CD, {MAXIT} "
          f"iterations: {launches_cv_batched} launches of cd_nnls_batched, "
          f"{res_cv_cd.misc['host_syncs']} host syncs; train "
          f"{train[0]:.6g} -> {train[-1]:.6g}, test {test[0]:.6g} -> "
          f"{test[-1]:.6g}, best test {res_cv_cd.misc['best_test_loss']:.6g} "
          f"at iteration {res_cv_cd.best_iter}; bitwise repeatable",
          flush=True)

    # (ii) the same with the default solver: per-column Cholesky, no kernel
    reset_counts()
    res_cv = cv_fit(A_pb)
    train, test = check_cv_histories(res_cv, MAXIT)
    check(res_cv.misc["config"].solver.name == "CHOLESKY"
          and sum(fn.launches for fn in counted) == 0,
          "the Cholesky-mode CV fit launches no kernel (batched_spd_solve)")
    check(same_fit(cv_fit(A_pb), res_cv),
          "the same seeds give bitwise equal factors and histories")
    print(f"(ii) CV k={CV_K}, default solver (Cholesky per column, plain "
          f"PyTorch): train {train[0]:.6g} -> {train[-1]:.6g}, test "
          f"{test[0]:.6g} -> {test[-1]:.6g}, best test "
          f"{res_cv.misc['best_test_loss']:.6g} at iteration "
          f"{res_cv.best_iter}; bitwise repeatable", flush=True)

    # (iii) a seeded 10% mask, k=20; the masked entries are the test set
    gen = torch.Generator(device="cuda").manual_seed(3)
    M_pb = torch.rand(A_pb.shape, device="cuda", generator=gen) < MASK_SHARE

    def mask_fit(k=MASK_K, maxit=MAXIT):
        return rtt.nmf(A_pb, k, mask=M_pb, maxit=maxit, tol=0, seed=1)

    res_mask = mask_fit()
    train, test = check_cv_histories(res_mask, MAXIT)
    check(res_mask.misc["host_syncs"] == 0,
          "a masked fit with tol=0 reads nothing on the host")
    print(f"(iii) masked k={MASK_K}, {float(M_pb.float().mean()):.4f} of "
          f"the entries masked: train {train[0]:.6g} -> {train[-1]:.6g}, "
          f"loss on the masked entries {test[0]:.6g} -> {test[-1]:.6g}",
          flush=True)

    # (iv) mask="zeros": only the nonzeros are fitted
    def zeros_fit():
        return rtt.nmf(A_pb, MASK_K, mask="zeros", maxit=ZEROS_MAXIT, tol=0,
                       seed=1)

    res_zeros = zeros_fit()
    train, test = check_cv_histories(res_zeros, ZEROS_MAXIT, falling=False)
    print(f"(iv) mask=\"zeros\" k={MASK_K}, {ZEROS_MAXIT} iterations, "
          f"{float((A_pb == 0).float().mean()):.4f} of the entries masked: "
          f"train {train[0]:.6g} -> {train[-1]:.6g}, loss on the zeros "
          f"{test[0]:.6g} -> {test[-1]:.6g}", flush=True)

    # (v) KL under CV: the IRLS solves with the holdout weights
    def kl_cv_fit():
        return rtt.nmf(A_ct, CV_K, loss="kl", test_fraction=CV_FRACTION,
                       cv_seed=1, maxit=KL_CV_MAXIT, tol=0,
                       cv_patience=KL_CV_MAXIT + 1, seed=1)

    reset_counts()
    res_kl_cv = kl_cv_fit()
    train, test = check_cv_histories(res_kl_cv, KL_CV_MAXIT, falling=False)
    check(cd_batched.launches == res_kl_cv.misc["irls_inner_iterations"] > 0
          and sum(fn.launches for fn in counted) == cd_batched.launches,
          "one cd_nnls_batched launch per inner iteration and no other")
    print(f"(v) KL CV k={CV_K}, {KL_CV_MAXIT} iterations: "
          f"{cd_batched.launches} launches of cd_nnls_batched; train "
          f"{train[0]:.6g} -> {train[-1]:.6g}, test {test[0]:.6g} -> "
          f"{test[-1]:.6g}", flush=True)

    # (vi) masked, k=128: the H side's Khatri-Rao operand does not fit, so
    # its weighted Grams come from kernel 5; the W side's fits
    check(not nmf_irls._use_kr(MASK_K128, m_pb)
          and nmf_irls._use_kr(MASK_K128, n_pb),
          f"at k={MASK_K128} the Khatri-Rao operand fits on the W side only")
    reset_counts()
    with counted_calls(linalg, "kr_product") as kr_calls:
        res_128 = mask_fit(MASK_K128, K128_MAXIT)
    launches_wg5 = wg5.launches
    blocks_h = column_blocks(MASK_K128, m_pb, n_pb)
    train, test = check_cv_histories(res_128, K128_MAXIT)
    check(launches_wg5 == blocks_h * K128_MAXIT
          and sum(fn.launches for fn in counted) == launches_wg5,
          f"{blocks_h} column blocks x {K128_MAXIT} iterations of "
          f"weighted_gram and no other kernel: {launches_wg5}")
    check(kr_calls.calls == K128_MAXIT,
          f"the Khatri-Rao product served the W side, once per iteration: "
          f"{kr_calls.calls}")
    print(f"(vi) masked k={MASK_K128}, {K128_MAXIT} iterations: "
          f"{launches_wg5} launches of weighted_gram ({blocks_h} column "
          f"blocks an iteration on the H side), {kr_calls.calls} Khatri-Rao "
          f"products (W side); train {train[0]:.6g} -> {train[-1]:.6g}",
          flush=True)

    # (vii) a sweep and the rank search on a planted-rank matrix
    A_pl = torch.from_numpy(simulate_nmf(
        PLANTED["m"], PLANTED["n"], PLANTED["k"], noise=0.5,
        seed=5)["A"]).cuda()

    def sweep():
        return rtt.nmf(A_pl, SWEEP_KS, test_fraction=CV_FRACTION,
                       cv_seed=SWEEP_SEEDS, maxit=30)

    rows = sweep()
    check([(r["k"], r["rep"]) for r in rows] == [
        (k, rep + 1) for rep in range(len(SWEEP_SEEDS)) for k in SWEEP_KS]
        and all(np.isfinite(r["test_mse"]) and np.isfinite(r["train_mse"])
                for r in rows), f"one finite row per rank and seed: {rows}")
    mean_test = {k: float(np.mean([r["test_mse"] for r in rows
                                   if r["k"] == k])) for k in SWEEP_KS}
    check(min(mean_test, key=mean_test.get) == PLANTED["k"],
          f"the test loss is lowest at the planted rank: {mean_test}")
    print(f"(vii) sweep k={SWEEP_KS} x cv_seed={SWEEP_SEEDS} on a planted "
          f"rank-{PLANTED['k']} {tuple(A_pl.shape)} matrix: mean test loss "
          f"{ {k: round(v, 6) for k, v in mean_test.items()} }", flush=True)

    def auto_fit():
        return rtt.nmf(A_pl, "auto", cv_k_range=(2, 24), criterion="test",
                       maxit=30, seed=1)

    reset_counts()
    with counted_calls(torch.linalg, "cholesky") as linalg_cholesky:
        res_auto = auto_fit()
    search = res_auto.misc["rank_search"]
    check(res_auto.k == search["k_optimal"]
          and abs(res_auto.k - PLANTED["k"]) <= 1,
          f"the rank search finds the planted rank: {search}")
    check(chol.launches == 2 * res_auto.iterations > 0
          and linalg_cholesky.calls == 0 and cd_batched.launches > 0,
          f"the rank-search fits ran through cd_nnls_batched and the refit "
          f"through cholesky_clip on the card: {chol.launches}, "
          f"{res_auto.iterations}")
    print(f"       k=\"auto\": ranks tried "
          f"{[e['rank'] for e in search['evaluations']]}, k_optimal "
          f"{search['k_optimal']}; {cd_batched.launches} launches of "
          f"cd_nnls_batched in the search, {chol.launches} of cholesky_clip "
          f"in the refit of {res_auto.iterations} iterations", flush=True)

    # (viii) held-out entries do not move the factors; card against CPU
    from rcppml_tpu_torch import rng as port_rng
    small = A_pb[:SMALL[0], :SMALL[1]].contiguous()
    held = torch.from_numpy(port_rng.holdout_mask(
        1, *SMALL, int(1.0 / CV_FRACTION))).cuda()
    moved = torch.where(held, small + 5.0, small)
    for label, kw in (("CD", dict(solver="cd")), ("Cholesky", dict())):
        on_card, other = cv_fit(small, **kw), cv_fit(moved, **kw)
        check(same_factors(on_card, other) and np.array_equal(
            on_card.loss_history, other.loss_history)
            and not np.array_equal(on_card.test_loss_history,
                                   other.test_loss_history),
            f"{label}: changing A at the held-out entries changes the test "
            f"loss and nothing else, bit for bit")
        on_cpu = cv_fit(small.cpu(), **kw)
        off = max(float(np.abs(np.asarray(getattr(on_card, h))
                               / np.asarray(getattr(on_cpu, h)) - 1).max())
                  for h in ("loss_history", "test_loss_history"))
        far = max(float(np.abs(getattr(on_card, f) - getattr(on_cpu, f)).max()
                        / np.abs(getattr(on_cpu, f)).max()) for f in "WdH")
        print(f"(viii) CV k={CV_K} {label} at {SMALL}: held-out entries do "
              f"not move W, d, H; card against CPU: train and test "
              f"histories within {off:.2e}, W, d, H within {far:.2e} of "
              f"their largest entry", flush=True)
        check(off <= SMALL_RTOL and far <= SMALL_FACTOR_TOL,
              f"CV {label} on the card agrees with the CPU fit: {off}, {far}")

    # (ix) the gathered downdate against the weighted path
    cfg_cv = rtt.build_config(CV_K, test_fraction=CV_FRACTION, cv_seed=1,
                              maxit=MAXIT, tol=0, cv_patience=MAXIT + 1,
                              seed=1)

    def downdate_fit(use):
        return nmf_cv.fit_cv_or_masked(A_pb, cfg_cv, use_downdate=use)

    res_dd = downdate_fit(True)
    check_cv_histories(res_dd, MAXIT)
    check(same_factors(downdate_fit(False), res_cv),
          "fit_cv_or_masked without the downdate is the fit of (ii)")
    off = float(np.abs(np.asarray(res_dd.loss_history, np.float64)
                       / np.asarray(res_cv.loss_history, np.float64)
                       - 1).max())
    off_test = float(np.abs(np.asarray(res_dd.test_loss_history, np.float64)
                            / np.asarray(res_cv.test_loss_history,
                                         np.float64) - 1).max())
    print(f"(ix) use_downdate=True against the weighted path of (ii): "
          f"train history within {off:.2e}, test history within "
          f"{off_test:.2e}", flush=True)
    check(off <= DOWNDATE_RTOL, f"the downdate's train history within "
          f"{DOWNDATE_RTOL} of the weighted path's: {off}")

    phase(f"16 times (CUDA events, median of {REPS} after a warm-up) on "
          f"{card}")

    def factors(res):
        W_T = torch.from_numpy(np.ascontiguousarray(res.W.T)).cuda()
        H = torch.from_numpy(np.ascontiguousarray(res.H)).cuda()
        return W_T, H

    def solve_inputs(res, A, side):
        """The next iteration's solve of a finished fit, as the loop
        builds it: Gram, RHS and warm start in residual form."""
        W_T, H = factors(res)
        F, X0, data = (W_T, H, A) if side == "H" else (H, W_T, A.T)
        G, B = linalg.gram(F), linalg.rhs(F, data)
        return G, B - G @ X0, X0

    def cd_report(label, k, n, gram_floats, ms, plain_ms, sweeps):
        """Print one solve's times beside its bound and the time of one
        coordinate step of the slowest column (time / (max sweeps x k));
        returns the bound and that step."""
        col_sweeps = int(sweeps.sum())
        bound, by = bound_ms(4 * (gram_floats + 3 * k * n),
                             2 * k * k * col_sweeps)
        step_us = ms * 1e3 / (int(sweeps.max()) * k)
        print(f"solve {label}: kernel {ms:.4f} ms, plain twin "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by}; sweeps "
              f"{col_sweeps / n:.2f} mean {int(sweeps.max())} max; "
              f"{step_us:.4f} us a step of the slowest column  [{card}]",
              flush=True)
        return bound, by, step_us

    times, added = {}, {}
    for label, res, A, side in (("(20, 2638) H side", res_cd, A_pb, "H"),
                                ("(20, 13714) W side", res_cd, A_pb, "W"),
                                ("(50, 610) H side", res_ml, A_ml, "H"),
                                ("(50, 3867) W side", res_ml, A_ml, "W")):
        G, B_res, X0 = solve_inputs(res, A, side)
        ms = cuda_ms(lambda: cd_shared(G, B_res, X0, 0.0, 5e-6, nonneg=True,
                                       maxit=100))
        plain_ms = cuda_ms(lambda: cd_nnls.cd_nnls_shared_plain(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100))
        _, sweeps = cd_nnls.cd_nnls_shared_plain(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100,
            return_sweeps=True)
        k, n = B_res.shape
        times["shared " + label] = (ms, plain_ms, *cd_report(
            "cd_nnls_shared " + label, k, n, k * k, ms, plain_ms, sweeps))

    def irls_inputs(res, A, side):
        """The first inner iteration of the next ALS iteration's solve of a
        finished KL fit: F, warm start X, data panel."""
        W_T, H = factors(res)
        if side == "H":
            return W_T, H, A
        return H, W_T, A.T.contiguous()

    rs = np.random.RandomState(5)
    F_ml = torch.from_numpy(np.abs(rs.normal(size=(50, 610))).astype(
        np.float32)).cuda()
    X_ml = torch.from_numpy((np.abs(rs.normal(size=(50, 3867))) / 50).astype(
        np.float32)).cuda()
    A_ml_T = A_ml.T.contiguous()
    for label, (F, X, A_blk) in (
            ("(16, 2638) H side of fit (i)", irls_inputs(res_kl, A_ct, "H")),
            ("(16, 13714) W side of fit (i)", irls_inputs(res_kl, A_ct, "W")),
            ("(50, 3867) movielens W side", (F_ml, X_ml, A_ml_T))):
        kw = dict(loss_kind="kl", sparse_zeros=False)
        k, m = F.shape
        bc = X.shape[1]
        KR = linalg.kr_product(F)
        Gb, b = wgram.weighted_gram_rhs_plain(F, X, A_blk, KR=KR, **kw)
        B_res = b - solvers.batched_gram_matvec(Gb, X)
        ms = cuda_ms(lambda: cd_batched(Gb, B_res, X, 0.0, 5e-6, nonneg=True,
                                        maxit=100))
        held_mib = torch.cuda.memory_allocated() / 2**20
        solve_mib = peak_mib(lambda: cd_batched(Gb, B_res, X, 0.0, 5e-6,
                                                nonneg=True, maxit=100)) \
            - held_mib
        plain_ms = cuda_ms(lambda: cd_nnls_batched.cd_nnls_batched_plain(
            Gb, B_res, X, 0.0, 5e-6, nonneg=True, maxit=100))
        _, sweeps = cd_nnls_batched.cd_nnls_batched_plain(
            Gb, B_res, X, 0.0, 5e-6, nonneg=True, maxit=100,
            return_sweeps=True)
        times["batched " + label] = (ms, plain_ms, *cd_report(
            "cd_nnls_batched " + label, k, bc, bc * k * k, ms, plain_ms,
            sweeps))
        print(f"  peak device memory of the solve above what was held "
              f"before it: {solve_mib:.1f} MiB (the Gram batch "
              f"{bc * k * k * 4 / 2**20:.1f} MiB)", flush=True)
        if "movielens" in label:
            continue
        ms = cuda_ms(lambda: wg(F, X, A_blk, **kw))
        plain_ms = cuda_ms(lambda: wgram.weighted_gram_rhs_plain(
            F, X, A_blk, KR=KR, **kw))
        # per entry of A: mu (k multiply-adds), the k (k + 1) / 2 distinct
        # entries of a symmetric Gram, and b (k); the Gram's and b's
        # products run on the tensor cores as three TF32 products each
        bound, by = bound_ms(4 * (k * m + k * bc + m * bc + bc * k * k
                                  + k * bc),
                             2 * m * bc * (k * (k + 1) // 2 + 2 * k))
        floor = 3 * 2 * m * bc * (k * (k + 1) // 2 + k) / PEAK_TF32_FLOPS \
            * 1e3
        mode, wc, splits, chunk = wgram.plan_wgram(
            k, m, bc, rhs_tall.device_sms(F.device))
        # no single PyTorch call computes the function: the yardstick is
        # the default IRLS path, several calls, which is also the twin
        print(f"weight + Gram + RHS {label}: kernel {ms:.4f} ms ({splits} "
              f"splits of {chunk} rows, {wc} column pairs a block, F for mu "
              f"{'staged' if mode == 1 else 'from device memory'}), plain "
              f"twin = library yardstick (several PyTorch calls, the default "
              f"IRLS path: F.T @ X, the weight pass, KR @ w, F @ (w * A)) "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by}, 3xTF32 "
              f"floor of its products {floor:.5f} ms  [{card}]", flush=True)
        times["wgram " + label] = (ms, plain_ms, bound, by, plain_ms)
        added["wgram " + label] = {
            "floor_3xtf32_ms": floor,
            "library_is": "several PyTorch calls (the default IRLS path: "
                          "F.T @ X, the weight pass, KR @ w, F @ (w * A))"}
        del KR, Gb, b, B_res

    # kernels 7 and 8 beside torch.matmul: device time, from a CUDA graph of
    # BATCH calls replayed (a product of tens of microseconds is otherwise
    # timed by the host's launch path), and beside it the time per call of
    # BATCH eager calls back to back.  A matrix that fits in L2 stays there,
    # as it does between the iterations of a fit.  With a bfloat16 A the
    # yardstick is torch.matmul of the rounded small operand and the
    # bfloat16 A, whose output is bfloat16 (no single PyTorch call gives
    # the float32 sum the kernel writes)
    BATCH = 20

    def batch_ms(fn):
        return cuda_ms(lambda: [fn() for _ in range(BATCH)]) / BATCH

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(BATCH):
                fn()
        return cuda_ms(graph.replay) / BATCH

    for label, A32, k in (("pbmc3k k=20", A_pb, 20),
                          ("movielens k=50", A_ml, 50)):
        m, n = A32.shape
        rs = np.random.RandomState(k)
        F = torch.from_numpy(rs.rand(k, m).astype(np.float32)).cuda()
        H = torch.from_numpy(rs.rand(k, n).astype(np.float32)).cuda()
        A16 = A32.to(torch.bfloat16)
        sms = rhs_tall.device_sms(A32.device)
        for name, fn, plain_fn, X, J, A16_mm in (
                ("rhs_tall", rhs_f, rhs_tall.rhs_tall_plain, F, n, A16),
                ("rhs_tall_t", rhs_t, rhs_tall.rhs_tall_t_plain, H, m,
                 A16.T)):
            X16 = X.to(torch.bfloat16)
            ms = graph_ms(lambda: fn(X, A32))
            lib_ms = graph_ms(lambda: plain_fn(X, A32))
            ms16 = graph_ms(lambda: fn(X, A16))
            lib16_ms = graph_ms(lambda: X16 @ A16_mm)
            bound, by = bound_ms(4 * (m * n + X.numel() + k * J),
                                 2 * k * m * n)
            # products of bfloat16 values: the tensor cores' rate
            bound16, by16 = bound_ms(2 * m * n + 4 * (X.numel() + k * J), 0,
                                     2 * k * m * n)
            plans = []
            for bf16 in (False, True):
                blocks = rhs_tall.plan_tall(m + n - J, J, k, bf16, sms)
                runs = rhs_tall.tall_runs(m + n - J, J, bf16, blocks)
                stages = sorted({sum(c for _, _, c in run) for run in runs})
                plans.append(f"{-(-J // rhs_tall.TALL_COLS)} tiles cut into "
                             f"{blocks} runs of {' or '.join(map(str, stages))} "
                             f"stages")
            print(f"{name} {label}: kernel {ms:.4f} ms, torch.matmul (the "
                  f"plain twin and the library call) {lib_ms:.4f} ms, bound "
                  f"{bound:.5f} ms by {by}; bfloat16 A: kernel {ms16:.4f} ms, "
                  f"torch.matmul of bfloat16 operands (bfloat16 output) "
                  f"{lib16_ms:.4f} ms, bound {bound16:.5f} ms by {by16}; per "
                  f"eager call {batch_ms(lambda: fn(X, A32)):.4f} ms against "
                  f"{batch_ms(lambda: plain_fn(X, A32)):.4f} ms; float32 "
                  f"{plans[0]}, bfloat16 {plans[1]}  [{card}]", flush=True)
            times[f"{name} {label}"] = (ms, lib_ms, bound, by)
            times[f"{name} {label} bf16"] = (ms16, lib16_ms, bound16, by16)
        del A16

    # kernel 5 at the blocks of the masked k=128 fit's H side, beside its
    # float32 bound, the floor of its 3xTF32 tensor-core products (three
    # TF32 products for each float32 one), the twin, and cuBLAS on the
    # Khatri-Rao operand (k^2 x m, 0.9 GB at k=128, built outside the timed
    # window): KR @ w + F @ (w * A)
    for bc in (68, 54):
        F, w, A_blk = wg5_inputs(MASK_K128, m_pb, bc, False, True, seed=bc)
        k, m = F.shape
        ms = cuda_ms(lambda: wg5(F, w, A_blk))
        plain_ms = cuda_ms(lambda: weighted_gram.weighted_gram_plain(
            F, w, A_blk))
        KR = linalg.kr_product(F)
        lib_ms = cuda_ms(lambda: (KR @ w, F @ (w * A_blk)))
        del KR
        # per entry of the block: the k (k + 1) / 2 distinct entries of a
        # symmetric Gram, and b (k)
        flops = 2 * m * bc * (k * (k + 1) // 2 + k)
        bound, by = bound_ms(4 * (k * m + 2 * m * bc + bc * k * k + k * bc),
                             flops)
        floor = 3 * flops / PEAK_TF32_FLOPS * 1e3
        wc, splits, chunk = weighted_gram.plan_weighted_gram(
            k, m, bc, rhs_tall.device_sms(F.device))
        print(f"weighted Gram + RHS k={k} m={m} bc={bc}: kernel {ms:.4f} ms "
              f"({splits} splits of {chunk} rows, {wc} column pairs a "
              f"block), plain twin (a batched product over a (bc, k, m) "
              f"intermediate and a product) {plain_ms:.4f} ms, cuBLAS KR @ w "
              f"+ F @ (w * A) {lib_ms:.4f} ms, bound {bound:.5f} ms by {by}, "
              f"3xTF32 floor {floor:.5f} ms  [{card}]", flush=True)
        times[f"wg5 bc={bc}"] = (ms, plain_ms, bound, by, lib_ms)
        added[f"wg5 bc={bc}"] = {"floor_3xtf32_ms": floor}
        del F, w, A_blk

    # kernel 6 at the solves of the Cholesky fit: device time from a replayed
    # CUDA graph, the time per eager call, the twin, and the calls it
    # replaced (torch.linalg.cholesky reads its status on the host, so it
    # cannot be captured: eager calls, back to back)
    for label, res, A, side in (("(20, 2638) H side", res_ch, A_pb, "H"),
                                ("(20, 13714) W side", res_ch, A_pb, "W"),
                                ("(50, 610) H side", res_ml, A_ml, "H")):
        W_T, H = factors(res)
        F, data = (W_T, A) if side == "H" else (H, A.T)
        G, B = solvers._ridged(linalg.gram(F)), linalg.rhs(F, data)
        k, n = B.shape
        ms = graph_ms(lambda: chol(G, B))
        eager_ms = batch_ms(lambda: chol(G, B))
        plain_ms = cuda_ms(lambda: cholesky_clip.cholesky_clip_plain(G, B))
        lib_ms = batch_ms(lambda: linalg_cholesky_clip(G, B))
        bound, by = bound_ms(4 * (k * k + 2 * k * n),
                             k ** 3 // 3 + 2 * k * k * n)
        plan = cholesky_clip.plan_cholesky_clip(
            k, n, rhs_tall.device_sms(B.device))
        print(f"cholesky_clip {label}: kernel {ms:.4f} ms (one launch, "
              f"{plan.lanes} lanes x {plan.rows} rows a column, "
              f"{plan.threads} threads, {plan.blocks} blocks; per eager call "
              f"{eager_ms:.4f} ms), plain twin {plain_ms:.4f} ms, "
              f"torch.linalg.cholesky + cholesky_solve + clamp per eager "
              f"call {lib_ms:.4f} ms, bound {bound:.5f} ms by {by}  [{card}]",
              flush=True)
        times["chol " + label] = (ms, plain_ms, bound, by, lib_ms)

    # the per-column Cholesky of the CV fit's H side (plain PyTorch, 3k
    # steps of several launches each)
    W_T, H = factors(res_cv)
    Gb_cv, b_cv = linalg.weighted_gram_and_rhs(
        W_T, (~M_pb).float(), A_pb)
    Gb_cv = nmf_cv._rank_ridge(Gb_cv, torch.eye(CV_K, device="cuda"))
    print(f"batched_spd_solve ({n_pb}, {CV_K}, {CV_K}): "
          f"{cuda_ms(lambda: solvers.batched_spd_solve(Gb_cv, b_cv)):.3f} ms "
          f"[{card}]", flush=True)
    del Gb_cv, b_cv

    def fused_flops(m, n, k, maxit, ns_steps=7):
        """Operations of the whole fit, (with A, without A).  With A: the
        two products per iteration, float32 or bfloat16 as A is.  Without:
        per iteration one Gram of each factor (the loss's W W^T is the next
        iteration's H-side Gram), two Ginv . B products and two refines of
        1 + 2 ns_steps k x k products; once, the Grams and refines that seed
        the two inverses."""
        grams = 2 * k * k * (m + n)
        refines = 2 * (1 + 2 * ns_steps) * 2 * k ** 3
        return (maxit * 4 * k * m * n,
                maxit * (2 * grams + refines) + grams + refines)

    for label, (A, shape) in cells.items():
        m, n, k = shape["m"], shape["n"], shape["k"]
        W0, H0 = fused_start(shape)
        for bf16 in (False, True):
            ms = cuda_ms(lambda: fused(A, W0, H0, maxit=MAXIT, a_bf16=bf16))
            plain_ms = cuda_ms(lambda: fused_als.fused_als_plain(
                A, W0, H0, maxit=MAXIT, a_bf16=bf16), reps=3)
            # the function's inputs read once and its outputs written once,
            # against its operations; beside it the traffic of reading A
            # twice per iteration, which is what the card does once A
            # exceeds L2
            io_bytes = (2 if bf16 else 4) * m * n \
                + 4 * (2 * k * (m + n) + k + MAXIT)
            with_a, without_a = fused_flops(m, n, k, MAXIT)
            bound, by = bound_ms(io_bytes, without_a, with_a) if bf16 else \
                bound_ms(io_bytes, with_a + without_a)
            reread_ms = 2 * MAXIT * m * n * (2 if bf16 else 4) \
                / PEAK_BYTES_PER_S * 1e3
            print(f"fused_als {label} k={k} "
                  f"{'bfloat16' if bf16 else 'float32'} A, {MAXIT} "
                  f"iterations: kernel sequence {ms:.3f} ms, "
                  f"plain twin {plain_ms:.3f} ms, bound {bound:.4f} ms by "
                  f"{by} (reading A twice per iteration: {reread_ms:.3f} ms)"
                  f"  [{card}]", flush=True)
            if not bf16:
                times[f"fused_als {label}"] = (ms, plain_ms, bound, by)
    # past k = 128: the k x k section in a cluster of blocks
    wide = dict(MOVIELENS, k=FUSED_WIDE_K)
    W0, H0 = fused_start(wide)
    ms = cuda_ms(lambda: fused(A_ml, W0, H0, maxit=MAXIT))
    plain_ms = cuda_ms(lambda: fused_als.fused_als_plain(A_ml, W0, H0,
                                                         maxit=MAXIT), reps=3)
    m, n, k = MOVIELENS["m"], MOVIELENS["n"], FUSED_WIDE_K
    with_a, without_a = fused_flops(m, n, k, MAXIT)
    bound, by = bound_ms(4 * (m * n + 2 * k * (m + n) + k + MAXIT),
                         with_a + without_a)
    ranks = fused_als.refine_plan(k)[0]
    print(f"fused_als movielens k={k} float32 A, {MAXIT} iterations (k x k "
          f"section in a cluster of {ranks} blocks): kernel sequence "
          f"{ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound {bound:.4f} ms "
          f"by {by}  [{card}]", flush=True)
    times[f"fused_als movielens k={k}"] = (ms, plain_ms, bound, by)

    fits = ((f"pbmc3k k=20 MSE CD, {MAXIT} iterations",
             lambda: mse_cd_fit(rtt, A_pb)),
            (f"pbmc3k k=20 MSE Cholesky, {MAXIT} iterations", lambda: rtt.nmf(
                A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1)),
            (f"movielens k=50 MSE L1 CD, {MAXIT} iterations", lambda: rtt.nmf(
                A_ml, MOVIELENS["k"], L1=(0, 0.01), maxit=MAXIT, tol=0,
                seed=1)),
            (f"pbmc3k k=20 MSE fused_vmem, {MAXIT} iterations",
             lambda: fused_fit(rtt, A_pb, PBMC)),
            (f"pbmc3k k=20 MSE fused_vmem bf16_data, {MAXIT} iterations",
             lambda: fused_fit(rtt, A_pb, PBMC, bf16_data=True)),
            (f"pbmc3k k=20 MSE Cholesky bf16_data, {MAXIT} iterations",
             lambda: rtt.nmf(A_pb, PBMC["k"], bf16_data=True, maxit=MAXIT,
                             tol=0, seed=1)),
            (f"movielens k=50 MSE fused_vmem, {MAXIT} iterations",
             lambda: fused_fit(rtt, A_ml, MOVIELENS)),
            (f"movielens k=50 MSE fused_vmem bf16_data, {MAXIT} iterations",
             lambda: fused_fit(rtt, A_ml, MOVIELENS, bf16_data=True)),
            (f"movielens k=50 MSE Cholesky, {MAXIT} iterations",
             lambda: rtt.nmf(A_ml, MOVIELENS["k"], maxit=MAXIT, tol=0,
                             seed=1)),
            (f"movielens k=50 MSE CD, {MAXIT} iterations",
             lambda: rtt.nmf(A_ml, MOVIELENS["k"], solver="cd", maxit=MAXIT,
                             tol=0, seed=1)),
            (f"(i) pbmc3k counts k={KL_K} KL, {KL_MAXIT} iterations", fit_kl),
            (f"(iii) pbmc3k counts k={NBZI_K} NB zi=row, {NBZI_MAXIT} "
             f"iterations", fit_nbzi))
    for label, fit in fits:
        print(f"fit {label}: {cuda_ms(fit):.3f} ms, peak {peak_mib(fit):.0f} MiB  "
              f"[{card}]", flush=True)
    with fused_wgram():
        print(f"fit (ii) pbmc3k counts k={KL_K} KL with RCPPML_FUSED_WGRAM, "
              f"{KL_MAXIT} iterations: {cuda_ms(fit_kl):.3f} ms, peak "
              f"{peak_mib(fit_kl):.0f} MiB  [{card}]", flush=True)
    print(f"fit pbmc3k k=20 MSE CD through the plain twin (one run): "
          f"{plain_fit_ms:.3f} ms  [{card}]", flush=True)
    with plain_fused_twin():
        for label, (A, shape) in cells.items():
            print(f"fit {label} k={shape['k']} MSE fused_vmem through the "
                  f"plain twin, {MAXIT} iterations: "
                  f"{cuda_ms(lambda: fused_fit(rtt, A, shape), reps=3):.3f} "
                  f"ms  [{card}]", flush=True)

    with linalg_cholesky_solve():
        print(f"fit pbmc3k k=20 MSE Cholesky through torch.linalg.cholesky "
              f"+ cholesky_solve (the solve before cholesky_clip), {MAXIT} "
              f"iterations: "
              f"{cuda_ms(lambda: rtt.nmf(A_pb, PBMC['k'], maxit=MAXIT, tol=0, seed=1)):.3f}"
              f" ms  [{card}]", flush=True)
    cv_fits = (
        (f"(i) pbmc3k CV k={CV_K} CD, {MAXIT} iterations",
         lambda: cv_fit(A_pb, solver="cd"), REPS),
        (f"(ii) pbmc3k CV k={CV_K} Cholesky per column, {MAXIT} iterations",
         lambda: cv_fit(A_pb), REPS),
        (f"(iii) pbmc3k masked k={MASK_K}, {MAXIT} iterations", mask_fit,
         REPS),
        (f"(iv) pbmc3k mask=zeros k={MASK_K}, {ZEROS_MAXIT} iterations",
         zeros_fit, REPS),
        (f"(v) pbmc3k counts KL CV k={CV_K}, {KL_CV_MAXIT} iterations",
         kl_cv_fit, REPS),
        (f"(vi) pbmc3k masked k={MASK_K128}, {K128_MAXIT} iterations (one "
         f"run)", lambda: mask_fit(MASK_K128, K128_MAXIT), 1),
        (f"(vii) planted sweep k={SWEEP_KS} x {len(SWEEP_SEEDS)} seeds",
         sweep, 3),
        ("(vii) planted k=auto with refit (one run)", auto_fit, 1),
        (f"(ix) pbmc3k CV k={CV_K} use_downdate=True, {MAXIT} iterations",
         lambda: downdate_fit(True), REPS),
        (f"(ix) pbmc3k CV k={CV_K} use_downdate=False, {MAXIT} iterations",
         lambda: downdate_fit(False), REPS))
    for label, fit, reps in cv_fits:
        print(f"fit {label}: {cuda_ms(fit, reps=reps, warmup=reps > 1):.3f} "
              f"ms, peak {peak_mib(fit) if reps > 1 else float('nan'):.0f} "
              f"MiB  [{card}]", flush=True)

    kernels = {"cd_nnls_shared": cd_shared, "cd_nnls_batched": cd_batched,
               "weighted_gram_rhs": wg, "fused_als": fused,
               "rhs_tall": rhs_f, "rhs_tall_t": rhs_t, "weighted_gram": wg5,
               "cholesky_clip": chol}
    phase(f"17 truncated SVD at the atlas shape {ATLAS['m']} x "
          f"{ATLAS['n']}, k={ATLAS['k']}")
    t_new = time.perf_counter()
    svd_phases(rtt, card, counted, reset_counts)
    phase(f"18 SVD-seeded NMF at the pbmc3k shape, k={SEEDED['k']}, "
          f"{MAXIT} iterations")
    model_s, A_s, held, seeded_launches, _ = seeded_phases(
        rtt, card, counted, reset_counts, chol)
    phase("19 projections at the pbmc3k shape (nnls, predict)")
    proj = projection_phases(rtt, card, counted, reset_counts, kernels,
                             model_s, A_s, held)
    del A_s, held
    phase(f"20 the KL fit k={KL_K} with profile=True")
    profiled_irls_phase(rtt, card, A_ct, res_kl)
    print(f"phases 17-20: {time.perf_counter() - t_new:.1f} s", flush=True)

    t_new = time.perf_counter()
    phase(f"21-22 rank-2 divisive clustering: bipartition at "
          f"{ATLAS['m']} x {ATLAS['n']}, dclust at {PBMC['m']} x {PBMC['n']}")
    _, cluster_reads = clustering_phases(rtt, card, counted, reset_counts)
    phase(f"23 consensus_nmf at {PBMC['m']} x {PBMC['n']}, "
          f"k={CONSENSUS['k']}, {CONSENSUS['n_runs']} runs")
    _, consensus_launches = consensus_phase(rtt, card, counted, reset_counts,
                                            chol, A_pb)
    phase("24 checkpointed fits at the pbmc3k shape, bit for bit the "
          "uninterrupted ones")
    _, ckpt_launches = checkpoint_phase(rtt, card, counted, reset_counts,
                                        kernels, (
        ("MSE Cholesky k=20", A_pb, PBMC["k"], dict(maxit=MAXIT, tol=0,
                                                    seed=1),
         CKPT_EVERY, "cholesky_clip"),
        ("MSE CD k=20", A_pb, PBMC["k"], dict(solver="cd", maxit=MAXIT,
                                              tol=0, seed=1),
         CKPT_EVERY, "cd_nnls_shared"),
        (f"KL k={KL_K}", A_ct, KL_K, dict(loss="kl", maxit=KL_MAXIT, tol=0,
                                          seed=1),
         CKPT_EVERY, "cd_nnls_batched"),
        (f"NB zi=row k={NBZI_K}", A_nb, NBZI_K, dict(
            loss="nb", zi="row", maxit=NBZI_MAXIT, tol=0, seed=1),
         NBZI_CKPT_EVERY, "cd_nnls_batched")))
    phase(f"25 auto_nmf_distribution on the counts, k={KL_K}")
    _, auto_launches = auto_distribution_phase(rtt, card, counted,
                                               reset_counts, kernels, A_ct)
    print(f"phases 21-25: {time.perf_counter() - t_new:.1f} s; bipartition "
          f"host reads: {cluster_reads}", flush=True)
    t_new = time.perf_counter()
    # what phase 32 reads of phases 26-30: (i)'s file, the single-card
    # streams and nets
    keep_dir = tempfile.TemporaryDirectory()
    keep = {"dir": keep_dir.name}
    stream_times, stream_launches = streaming_phases(rtt, card, counted,
                                                     reset_counts, kernels,
                                                     keep)
    print(f"phases 26-29: {time.perf_counter() - t_new:.1f} s; "
          + ", ".join(f"phase {i} {stream_times[f'phase {i}'] / 1e3:.1f} s"
                      for i in (26, 27, 28, 29)), flush=True)
    t_new = time.perf_counter()
    phase(f"30 the graph engine at the pbmc3k shape: the {GRAPH['k1']} -> "
          f"{GRAPH['k2']} net, {GRAPH['maxit']} sweeps, multi-modal, "
          f"branched, host loop, cross_validate_graph, predict")
    _, graph_launches = graph_phase(rtt, card, counted, reset_counts,
                                    kernels, A_ct, keep)
    print(f"phase 30: {time.perf_counter() - t_new:.1f} s", flush=True)
    t_new = time.perf_counter()
    phase(f"31 the device mesh at the pbmc3k shape: (a) the (1, 1) mesh "
          f"over NCCL, (b) {MESH_RANKS} ranks sharing the card over gloo, "
          f"mesh {MESH_SHAPE}")
    mesh_one = mesh_phase_one_rank(rtt, counted, reset_counts, chol,
                                   cd_shared, A_pb, res_ch, res_cd)
    mesh_data = {"A": A_pb, "counts": A_ct, "mask": M_pb}
    refs = {"MSE default k=20": res_ch, "MSE CD k=20": res_cd,
            "MSE bf16_data k=20": res_bf, f"KL k={KL_K}": res_kl,
            f"CV k={CV_K} CD": res_cv_cd,
            f"masked k={MASK_K} CD": mesh_fit(rtt, mesh_data,
                                              f"masked k={MASK_K} CD")}
    order_refs = {label: mesh_order_fit(mesh_data, label, refs[label])
                  for label in MESH_REORDERED}
    with tempfile.TemporaryDirectory() as rank_dir:
        mesh_launches, consumers = mesh_phase_ranks(
            rtt, card, refs, order_refs, A_pb, A_ct, M_pb,
            {"nb": A_nb, "graph": keep["graph"], "spz": keep["spz"],
             "dir": rank_dir})
        print(f"phase 31: {time.perf_counter() - t_new:.1f} s (with phase "
              "32 in the same ranks)", flush=True)
        phase(f"32 the mesh's consumers on phase 31's ranks and mesh "
              f"{MESH_SHAPE}: (a) checkpointed fits, (b) sharded streams "
              f"of (i), (c) graph nets (a) and (c)")
        consumer_launches, consumer_s = consumers_phase(
            consumers, rank_dir, keep, card, nmf_irls)
    keep_dir.cleanup()
    print(f"phase 32: {consumer_s:.1f} s in the ranks (the paths' "
          f"slowest-rank walls summed)", flush=True)

    # launches of each kernel on the paths after phase 16, each counted
    # from zero
    path_launches = {name: {label: got[name] for label, (got, _) in
                            proj.items() if name in got}
                     for name in kernels}
    path_launches["cholesky_clip"].update(
        {f"nmf seed={seed!r}": n for seed, n in seeded_launches.items()})
    path_launches["cholesky_clip"].update(
        {f"consensus_nmf {method}": n
         for method, n in consensus_launches.items()})
    for label, n in ckpt_launches.items():
        name = ("cholesky_clip" if "Cholesky" in label else "cd_nnls_shared"
                if "MSE CD" in label else "cd_nnls_batched")
        path_launches[name][f"checkpointed {label}"] = n
    for name, n in auto_launches.items():
        path_launches[name]["auto_nmf_distribution"] = n
    for name, by_path in stream_launches.items():
        path_launches[name].update(by_path)
    for name, by_path in graph_launches.items():
        path_launches[name].update(by_path)
    for label, n in mesh_one.items():
        name = "cd_nnls_shared" if "CD" in label else "cholesky_clip"
        path_launches[name][f"mesh (1, 1) NCCL {label}"] = n
    for name, by_path in mesh_launches.items():
        path_launches[name].update(by_path)
    for name, by_path in consumer_launches.items():
        path_launches[name].update(by_path)

    def entry(name, source, replaces, launches, err, rel, key,
              library=False, file="pallas_kernels.py", bf16_key=None):
        """``max_rel_err``: the largest error over the twin's largest entry
        (the fused kernel's Grams reach 1e9, so its absolute error is
        large where its relative error is 1e-5).  ``library``: the plain
        twin is one PyTorch call (``torch.matmul``) computing the same
        function; no single call computes a CD NNLS solve, the weight, Gram
        and RHS together, or a whole fit.  A fifth number in ``times[key]``
        is the time of the PyTorch calls the kernel replaced.  ``bf16_key``:
        the same kernel's times with a bfloat16 A, as extra keys."""
        ms, plain_ms, bound, by, *extra = times[key]
        step = {}
        if name.startswith("cd_nnls"):
            # the CD kernels' fifth number: a step of the slowest column
            step = {"step_us": extra.pop(0)}
        if extra:
            library_ms = extra[0]
        else:
            library_ms = plain_ms if library else None
        return {"name": name, "route": "cuda",
                "source": f"rcppml_tpu_torch/csrc/{source}",
                "replaces": f"rcppml_tpu/ops/{file}:{replaces}",
                "launches": launches, "max_abs_err": err,
                "max_rel_err": rel, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms, **step, **added.get(key, {}),
                **({"launches_by_path": path_launches[name]}
                   if path_launches.get(name) else {}),
                **({} if bf16_key is None else dict(zip(
                    ("bf16_ms", "bf16_library_ms", "bf16_bound_ms"),
                    times[bf16_key][:3])))}

    print(json.dumps({"kernels": [
        entry("cd_nnls_shared", "cd_nnls_shared.cu", 154, launches_shared,
              err_shared, 0.0 if err_shared == 0 else None,
              "shared (20, 2638) H side"),
        entry("cd_nnls_batched", "cd_nnls_batched.cu", 193, launches_batched,
              err_batched, 0.0 if err_batched == 0 else None,
              "batched (16, 2638) H side of fit (i)"),
        entry("weighted_gram_rhs", "wgram_rhs.cu", 636, launches_wgram,
              err_wgram, rel_wgram, "wgram (16, 2638) H side of fit (i)"),
        # one fused_vmem fit: every kernel its one call enqueues
        entry("fused_als", "fused_als.cu", 446, launches_fused, err_fused,
              rel_fused, "fused_als pbmc3k"),
        # the default loop with bf16_data; times at float32, beside matmul
        entry("rhs_tall", "rhs_tall.cu", 319, launches_rhs,
              *errs_rhs["rhs_tall"], "rhs_tall pbmc3k k=20", library=True,
              file="pallas_experiments.py",
              bf16_key="rhs_tall pbmc3k k=20 bf16"),
        entry("rhs_tall_t", "rhs_tall.cu", 365, launches_rhs_t,
              *errs_rhs["rhs_tall_t"], "rhs_tall_t pbmc3k k=20", library=True,
              file="pallas_experiments.py",
              bf16_key="rhs_tall_t pbmc3k k=20 bf16"),
        # the masked k=128 fit's H side
        entry("weighted_gram", "weighted_gram.cu", 29, launches_wg5, err_wg5,
              rel_wg5, "wg5 bc=68", file="pallas_experiments.py"),
        # the default (Cholesky) MSE fit
        entry("cholesky_clip", "cholesky_clip.cu", 188, launches_chol,
              err_chol, rel_chol, "chol (20, 2638) H side",
              file="pallas_experiments.py"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
