"""The host-side plans of kernels 5, 4, 3 and 6 on the CPU.

Kernel 5 (``ops/weighted_gram.py``, ``csrc/tri_gram.cuh``) computes one
triangle of every Gram in units of an m16 row tile by up to four n8 column
tiles, a block of warps a set of those units by pairs of columns, the
reduction over m split across blocks by :func:`plan_weighted_gram`; kernel 4
(``ops/wgram.py``) runs the same tile with the weight formed in a prologue
(``plan_weighted_gram(..., fused=True)``, :func:`plan_wgram`).  Kernel
3 (``ops/fused_als.py``) takes its Grams from ``csrc/cluster_gram.cuh`` or
the FMA tile (:func:`plan_gram`) and runs its k x k section in one block, a
cluster of blocks or device memory (:func:`refine_plan`).  Kernel 6
(``ops/cholesky_clip.py``) solves a column with a group of lanes in one
launch up to k = 64, with two kernels beyond (:func:`plan_cholesky_clip`).
The kernels read these plans as given, so what they promise is held here:
every entry of a triangle covered once, every row of the reduction in one
split, every column and row of a solve owned once, shared memory within the
card's limit, any k accepted.
"""

import pytest

from rcppml_tpu_torch.ops import cholesky_clip as cc
from rcppml_tpu_torch.ops import fused_als, wgram
from rcppml_tpu_torch.ops import weighted_gram as wg5

SHARED_LIMIT = 232448          # one block's shared memory on sm_90


def _units(k):
    """The triangle units as csrc/tri_gram.cuh::unit_tiles walks them:
    (I, first J tile, J tiles)."""
    col_tiles = -(-k // 8)
    out = []
    for i in range(-(-k // 16)):
        j0 = 2 * i
        while j0 < col_tiles:
            out.append((i, j0, min(wg5.TILE_GROUP, col_tiles - j0)))
            j0 += wg5.TILE_GROUP
    return out


@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 9, 13, 15, 16, 17, 20, 31, 32,
                               33, 50, 64, 65, 100, 105, 127, 128, 129, 138,
                               150, 200, 256, 257])
def test_triangle_units_cover_the_triangle_once(k):
    units = _units(k)
    assert wg5.triangle_units(k) == len(units)
    seen = {}
    for i, j0, nj in units:
        for k1 in range(16 * i, min(k, 16 * i + 16)):
            for k2 in range(8 * j0, min(k, 8 * (j0 + nj))):
                if k1 <= k2:
                    seen[(k1, k2)] = seen.get((k1, k2), 0) + 1
    assert len(seen) == k * (k + 1) // 2
    assert set(seen.values()) == {1}
    # at k = 128: 20 units compute 9,216 entries for the 8,256 of a triangle
    if k == 128:
        assert len(units) == 20
        assert sum(16 * 8 * nj for _, _, nj in units) == 9216


@pytest.mark.parametrize("k,m,bc", [
    (128, 13714, 68), (128, 13714, 54), (105, 13714, 83), (138, 2638, 33),
    (5, 1001, 1), (16, 13714, 77), (20, 2638, 1), (50, 3867, 610),
    (200, 1001, 7), (13, 257, 40), (1, 33, 3), (2000, 40, 3),
    (128, 1500, 68), (7, 31, 2), (64, 100000, 16)])
def test_plan_weighted_gram_cuts_every_row_once(k, m, bc):
    wc, splits, chunk = wg5.plan_weighted_gram(k, m, bc)
    pairs = -(-bc // 2)
    assert wc in (2, 4, 8) and (wc >= pairs or wc == 8)
    assert chunk % wg5.TILE_DEPTH == 0
    assert splits * chunk >= m > (splits - 1) * chunk
    assert 1 <= splits <= wg5.MAX_SPLITS
    if splits > 1:
        assert m // splits >= wg5.MIN_SPLIT_ROWS - wg5.TILE_DEPTH
    assert (wc, splits, chunk) == wg5.plan_weighted_gram(k, m, bc)
    assert wg5.scratch_floats(k, bc, splits) == (
        0 if splits == 1 else splits * bc * (k * k + k))
    # the tile's shared memory does not grow with k
    wt = 8 // wc
    stage = (wt * 112 * 36 + 2 * 32 * (2 * wc + 4)) * 4
    assert 3 * stage <= SHARED_LIMIT


@pytest.mark.parametrize("bc", [68, 54])
def test_plan_weighted_gram_fills_the_card_at_the_masked_fit(bc):
    """The masked k=128 fit's blocks: the triangle's units alone give too
    few blocks for 132 multiprocessors, so the reduction is split."""
    wc, splits, _ = wg5.plan_weighted_gram(128, 13714, bc, 132)
    blocks = -(-wg5.triangle_units(128) // (8 // wc)) * -(-(-(-bc // 2)) // wc)
    assert wc == 8 and splits > 1 and blocks * splits >= 132


@pytest.mark.parametrize("R,k", [
    (13714, 20), (2638, 20), (3867, 50), (610, 50), (3867, 150), (610, 150),
    (1000, 256), (1000, 270), (1000, 300), (5, 1), (300, 33), (145, 140),
    (200000, 20), (100000, 150)])
def test_plan_gram_covers_the_reduction(R, k):
    parts, chunk, cluster = fused_als.plan_gram(R, k)
    assert parts <= fused_als.GRAM_MAX_SPLITS
    if cluster:
        assert parts * fused_als.GRAM_CLUSTER * chunk >= R
        nb = -(-k // 4) * (-(-k // 4) + 1) // 2
        shares = 1 if nb >= fused_als.GRAM_THREADS else \
            fused_als.GRAM_THREADS // nb
        floats = -(-k // 4) * 4 * (chunk | 1) + shares * nb * 16
        assert floats * 4 <= SHARED_LIMIT
    else:
        assert parts * chunk >= R and chunk % 32 == 0
    assert (parts, chunk, cluster) == fused_als.plan_gram(R, k)


def test_plan_gram_takes_the_cluster_kernel_at_the_main_shapes():
    for R, k in ((13714, 20), (2638, 20), (3867, 50), (610, 50),
                 (3867, 150), (610, 150)):
        assert fused_als.plan_gram(R, k)[2] == 1


@pytest.mark.parametrize("k", [1, 2, 19, 20, 31, 32, 33, 49, 50, 64, 65, 100,
                               127, 128, 129, 138, 139, 150, 191, 192, 193,
                               200, 255, 256, 257, 300, 500])
def test_refine_plan_routes_every_k(k):
    ranks, rows, threads, scratch = fused_als.refine_plan(k)
    assert threads % 32 == 0 and 128 <= threads <= 1024
    kp = -(-k // 8) * 8
    ld = kp + 4
    if k <= fused_als.KXK_BLOCK_K:
        # one block on float32 multiply-adds, the matrices in its shared
        # memory: three of rows rounded up to 32, row stride 4 mod 8
        assert (ranks, rows, scratch) == (1, 0, 0)
        ld_block = (k + 3) // 8 * 8 + 4
        assert ld_block >= k and ld_block % 8 == 4
        assert (3 * -(-k // 32) * 32 * ld_block + 64) * 4 <= SHARED_LIMIT
    elif k <= 256:
        # a cluster, each block its rows of G, X and T in shared memory
        assert ranks in (2, 4) and rows % 16 == 0 and rows * ranks >= k
        assert scratch == 0
        assert (3 * rows * ld + kp + fused_als.KXK_REDUCTIONS) * 4 \
            <= SHARED_LIMIT
        tiles = rows // 16 * (kp // 8)
        assert tiles <= fused_als.KXK_HELD * threads // 32
    else:
        k16 = -(-k // 16) * 16
        assert (ranks, rows) == (1, k16) and scratch == 4 * k16 * ld
    assert fused_als.kxk_scratch_floats(k) == scratch


def test_workspace_passes_every_plan():
    """The int plan the C entry point reads: blocks of the two products
    (each with a 0), the two Grams' (partials, chunk), the k x k section's
    (ranks, rows, threads) and the two Grams' routes, 13 ints."""
    for m, n, k in ((13714, 2638, 20), (3867, 610, 50), (3867, 610, 150),
                    (600, 500, 257)):
        plan, _, _ = fused_als._workspace(m, n, k, False, False, 132)
        flat = [v for part in plan for v in part]
        assert len(flat) == 13
        assert tuple(flat[8:11]) == fused_als.refine_plan(k)[:3]
        assert tuple(flat[11:]) == (fused_als.plan_gram(m, k)[2],
                                    fused_als.plan_gram(n, k)[2])


# ---------------------------------------------------------------------------
# Kernel 4: the fused weight on kernel 5's tile
# ---------------------------------------------------------------------------

# the KL fit's two sides, and k = 1, 17, 50, 128, 129 at m not a multiple of
# 32 with odd and even bc, one and two column pairs
FUSED_SHAPES = [(16, 13714, 2638), (16, 2638, 13714)] + [
    (k, m, bc) for k in (1, 17, 50, 128, 129)
    for m, bc in ((1001, 333), (13714, 68), (1500, 3), (33, 1))]


@pytest.mark.parametrize("k,m,bc", FUSED_SHAPES)
def test_plan_weighted_gram_fused_cuts_every_row_once(k, m, bc):
    wc, splits, chunk = wg5.plan_weighted_gram(k, m, bc, fused=True)
    pairs = -(-bc // 2)
    assert wc in (2, 4, 8) and (wc >= pairs or wc == 8)
    assert chunk % wg5.TILE_DEPTH == 0
    assert splits * chunk >= m > (splits - 1) * chunk
    assert 1 <= splits <= wg5.MAX_SPLITS
    if splits > 1:
        assert m // splits >= wg5.MIN_SPLIT_ROWS - wg5.TILE_DEPTH
    assert (wc, splits, chunk) == wg5.plan_weighted_gram(k, m, bc,
                                                         fused=True)
    # F's k rows fit every stage at these k: mu reads them from shared memory
    mode, wc4, splits4, chunk4 = wgram.plan_wgram(k, m, bc)
    assert (wc4, splits4, chunk4) == (wc, splits, chunk)
    assert mode == wg5.FUSED_STAGED
    assert wg5.shared_bytes(wc, k, mode) <= SHARED_LIMIT
    # kernel 5's plan is not moved by kernel 4's
    assert wg5.plan_weighted_gram(k, m, bc) == wg5.plan_weighted_gram(
        k, m, bc, fused=False)


@pytest.mark.parametrize("wc", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 16, 75, 129, 340, 341, 2000])
def test_fused_shared_bytes_follow_the_tile(wc, k):
    """``shared_bytes`` is tri_gram::shared_bytes: three stages of the
    units' rows of F (112 rows of 36 floats a unit) and of w and A (32 rows
    of 2 wc + 4), kernel 4 adding F's k rows to a stage where k > 16 (up to
    16 the unit's rows are all of F) and X's 2 wc columns once; F is read
    from device memory where its rows do not fit."""
    stage = (8 // wc) * 112 * 36 + 2 * 32 * (2 * wc + 4)
    assert wg5.shared_bytes(wc, k) == 4 * 3 * stage
    assert wg5.shared_bytes(wc, k, wg5.FUSED_STAGED) == \
        4 * (3 * (stage + (36 * k if k > 16 else 0)) + 2 * wc * k)
    assert wg5.shared_bytes(wc, k, wg5.FUSED_GLOBAL) == \
        4 * (3 * stage + 2 * wc * k)
    mode = wg5.fused_mode(k, wc)
    assert wg5.shared_bytes(wc, k, mode) <= SHARED_LIMIT
    assert (mode == wg5.FUSED_STAGED) == (
        wg5.shared_bytes(wc, k, wg5.FUSED_STAGED) <= SHARED_LIMIT)


def test_plan_wgram_takes_every_k():
    """Past the k whose rows fit a stage mu reads F from device memory; no
    k the previous kernel took (up to about 880) is refused."""
    assert wgram.plan_wgram(340, 1000, 50)[0] == wg5.FUSED_STAGED
    assert wgram.plan_wgram(341, 1000, 50)[0] == wg5.FUSED_GLOBAL
    assert wgram.plan_wgram(880, 1000, 3)[0] == wg5.FUSED_GLOBAL
    with pytest.raises(ValueError, match="shared memory"):
        wg5.fused_mode(5000, 8)


def test_plan_wgram_fills_the_card_at_the_kl_fit():
    """The KL fit's H side has one triangle unit and 165 blocks of columns:
    the reduction is split so that every multiprocessor gets its two
    blocks."""
    for m, bc in ((13714, 2638), (2638, 13714)):
        _, wc, splits, _ = wgram.plan_wgram(16, m, bc, 132)
        blocks = -(-(-(-bc // 2)) // wc) * splits
        assert wc == 8 and blocks >= 2 * 132


# ---------------------------------------------------------------------------
# Kernel 6: Cholesky solve + clip
# ---------------------------------------------------------------------------

CHOL_KS = [1, 2, 15, 16, 17, 20, 24, 31, 32, 33, 50, 63, 64, 65, 138, 200,
           241, 300]
CHOL_NS = [1, 33, 2638, 2639, 13714]


@pytest.mark.parametrize("n", CHOL_NS)
@pytest.mark.parametrize("k", CHOL_KS)
def test_plan_cholesky_clip_owns_every_column_and_row_once(k, n):
    plan = cc.plan_cholesky_clip(k, n)
    assert plan == cc.plan_cholesky_clip(k, n)
    if k > cc.LANES_MAX_K:
        # two kernels: one thread a column in blocks of 128
        assert plan.lanes == 0 and plan.threads == 128
        assert plan.blocks == -(-n // 128)
        return
    g = plan.lanes
    assert g in (1, 2, 4, 8, 16, 32) and plan.rows in cc.LANE_ROWS
    assert plan.threads % 32 == 0 and plan.threads <= cc.LANES_MAX_THREADS
    cols = plan.threads // g
    # column j = block * cols + tid / g: each of the n columns once
    seen = [b * cols + tid // g for b in range(min(plan.blocks, 3))
            for tid in range(0, plan.threads, g)]
    assert seen == list(range(len(seen)))
    assert plan.blocks * cols >= n > (plan.blocks - 1) * cols
    # row l = t + g q, t < g, q < ceil(k / g) <= rows: each of the k rows
    # once (the rest are padding, never an owner)
    rq = -(-k // g)
    assert rq <= plan.rows
    rows = sorted(t + g * q for t in range(g) for q in range(rq))
    assert rows[:k] == list(range(k))
    # the tile: a warp's lanes (g rows by 32 / g columns) on 32 banks
    assert plan.ldx >= cols
    banks = {(t * plan.ldx + c) % 32 for t in range(g)
             for c in range(32 // g)}
    assert len(banks) == 32
    assert plan.shared_bytes == 4 * k * ((k | 1) + plan.ldx)
    assert plan.shared_bytes <= SHARED_LIMIT


@pytest.mark.parametrize("k,n", [(20, 2638), (20, 13714), (50, 610),
                                 (50, 3867), (24, 400), (24, 3000)])
def test_plan_cholesky_clip_fills_the_card_at_the_main_shapes(k, n):
    """The default MSE fits' solves (pbmc3k k=20, movielens k=50, the
    auto-rank refit up to k=24 on 3,000 x 400) take one launch and give
    every multiprocessor a block."""
    plan = cc.plan_cholesky_clip(k, n, 132)
    assert plan.lanes > 0 and plan.blocks >= 132
