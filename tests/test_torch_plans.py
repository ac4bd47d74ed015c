"""The host-side plans of kernels 5 and 3 on the CPU.

Kernel 5 (``ops/weighted_gram.py``, ``csrc/tri_gram.cuh``) computes one
triangle of every Gram in units of an m16 row tile by up to four n8 column
tiles, a block of warps a set of those units by pairs of columns, the
reduction over m split across blocks by :func:`plan_weighted_gram`.  Kernel
3 (``ops/fused_als.py``) takes its Grams from ``csrc/cluster_gram.cuh`` or
the FMA tile (:func:`plan_gram`) and runs its k x k section in one block, a
cluster of blocks or device memory (:func:`refine_plan`).  The kernels read
these plans as given, so what they promise is held here: every entry of a
triangle covered once, every row of the reduction in one split, shared
memory within the card's limit, any k accepted.
"""

import pytest

from rcppml_tpu_torch.ops import fused_als
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
