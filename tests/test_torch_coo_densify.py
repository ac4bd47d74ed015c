"""The COO densify (``ops/coo_densify.py``) on the CPU.

The plain twin against a numpy densify of the same triples, for every row
type (int16 view of uint16, int32) and value type (uint8, int16 view of
uint16, float32), with empty columns, no entries at all, a single column and
uint16 rows and values past 32767; the wrapper's refusals; and the kernel's
plan (``csrc/coo_densify.cu`` reads it as given): a numpy walk of its blocks
(zero a tile, write its columns' entries whose rows fall in it, write it
out) gives the twin's panel, every element written by one block, within the
card's shared memory.  ``tests/test_torch_kernels_gpu.py`` holds the kernel
to the twin bit for bit on the card.
"""

import numpy as np
import pytest
import torch

from rcppml_tpu_torch.ops import coo_densify as cd

SHARED_LIMIT = 232448          # one block's shared memory on sm_90


def _panel(nrows, ncols, density, seed, empty=(), val_kind="uint8"):
    """Canonical CSC triples of a random panel (rows ascending in each
    column) and its dense numpy twin."""
    rs = np.random.RandomState(seed)
    dense = np.zeros((nrows, ncols), np.float32)
    mask = rs.random_sample((nrows, ncols)) < density
    mask[:, list(empty)] = False
    top = {"uint8": 255, "uint16": 65535, "float32": 1000}[val_kind]
    vals = rs.randint(1, top + 1, size=mask.sum()).astype(np.float32)
    if val_kind == "float32":
        vals = vals / 7.0 - 3.0
    r, c = np.nonzero(mask.T)                  # column-major: CSC order
    dense[c, r] = vals
    counts = np.bincount(r, minlength=ncols).astype(np.int32)
    return c, counts, vals, dense


def _wire(rows, counts, vals, row_type, val_kind):
    rows_t = torch.from_numpy(rows.astype(np.uint16).view(np.int16)) \
        if row_type == "int16" else torch.from_numpy(rows.astype(np.int32))
    vals_t = {"uint8": lambda v: torch.from_numpy(v.astype(np.uint8)),
              "uint16": lambda v: torch.from_numpy(
                  v.astype(np.uint16).view(np.int16)),
              "float32": lambda v: torch.from_numpy(v.astype(np.float32))}[
                  val_kind](vals)
    return rows_t, torch.from_numpy(counts), vals_t


@pytest.mark.parametrize("row_type", ["int16", "int32"])
@pytest.mark.parametrize("val_kind", ["uint8", "uint16", "float32"])
def test_twin_is_the_numpy_densify(row_type, val_kind):
    nrows = 40_000 if row_type == "int16" else 70_000
    rows, counts, vals, dense = _panel(nrows, 13, 0.01, 5, empty=(0, 4, 12),
                                       val_kind=val_kind)
    assert rows.max() > 32767
    got = cd.coo_densify(*_wire(rows, counts, vals, row_type, val_kind),
                         nrows)
    assert got.dtype == torch.float32 and got.shape == (nrows, 13)
    assert torch.equal(got, torch.from_numpy(dense))


@pytest.mark.parametrize("case", ["no_entries", "single_column",
                                  "all_columns_empty_but_last",
                                  "full_column"])
def test_twin_edge_panels(case):
    nrows, ncols, density, empty = {
        "no_entries": (50, 7, 0.0, ()),
        "single_column": (300, 1, 0.3, ()),
        "all_columns_empty_but_last": (64, 9, 0.5, tuple(range(8))),
        "full_column": (33, 3, 1.0, (1,))}[case]
    rows, counts, vals, dense = _panel(nrows, ncols, density, 2, empty=empty)
    got = cd.coo_densify(*_wire(rows, counts, vals, "int16", "uint8"), nrows)
    assert torch.equal(got, torch.from_numpy(dense))
    # zeros are +0.0, as the kernel writes them
    assert not torch.signbit(got).any()


@pytest.mark.parametrize("case", ["rows_int64", "counts_int64",
                                  "vals_float64", "vals_int32",
                                  "rows_strided", "vals_strided",
                                  "rows_2d", "lengths_differ",
                                  "devices_differ", "meta_device"])
def test_wrapper_refuses(case):
    rows, counts, vals, _ = _panel(40, 4, 0.5, 3)
    r, c, v = _wire(rows, counts, vals, "int16", "uint8")
    bad = {"rows_int64": lambda: (r.long(), c, v),
           "counts_int64": lambda: (r, c.long(), v),
           "vals_float64": lambda: (r, c, v.double()),
           "vals_int32": lambda: (r, c, v.int()),
           "rows_strided": lambda: (torch.stack([r, r], 1)[:, 0], c, v),
           "vals_strided": lambda: (r, c, torch.stack([v, v], 1)[:, 0]),
           "rows_2d": lambda: (r[:, None], c, v),
           "lengths_differ": lambda: (r, c, v[:-1]),
           "devices_differ": lambda: (r, c, v.to("meta")),
           "meta_device": lambda: (r.to("meta"), c.to("meta"),
                                   v.to("meta"))}[case]()
    err = TypeError if case in ("rows_int64", "counts_int64", "vals_float64",
                                "vals_int32") else ValueError
    with pytest.raises(err, match="coo_densify"):
        cd.coo_densify(*bad, 40)


def _walk_blocks(rows, counts, vals, nrows):
    """csrc/coo_densify.cu's blocks in numpy, as the plan cuts the panel;
    also counts how often each element is written out."""
    ncols = len(counts)
    plan = cd.plan_coo_densify(nrows)
    starts = np.concatenate([[0], np.cumsum(counts)])
    out = np.full((nrows, ncols), np.nan, np.float32)
    writes = np.zeros((nrows, ncols), np.int64)
    gx, gy = -(-ncols // cd.TILE_COLS), -(-nrows // plan.tile_rows)
    for by in range(gy):
        r0 = by * plan.tile_rows
        nr = min(plan.tile_rows, nrows - r0)
        for bx in range(gx):
            c0 = bx * cd.TILE_COLS
            nc = min(cd.TILE_COLS, ncols - c0)
            tile = np.zeros((cd.TILE_COLS, plan.ld), np.float32)
            for w in range(nc):
                for e in range(starts[c0 + w], starts[c0 + w + 1]):
                    i = int(rows[e]) - r0
                    if 0 <= i < nr:
                        tile[w, i] = vals[e]
            out[r0:r0 + nr, c0:c0 + nc] = tile[:nc, :nr].T
            writes[r0:r0 + nr, c0:c0 + nc] += 1
    return out, writes, plan


@pytest.mark.parametrize("nrows,ncols", [(1, 1), (5, 3), (3072, 8),
                                         (3073, 9), (7001, 17), (9216, 64)])
def test_plan_writes_every_element_once(nrows, ncols):
    rows, counts, vals, dense = _panel(nrows, ncols, 0.02, nrows + ncols)
    out, writes, plan = _walk_blocks(rows, counts, vals, nrows)
    assert (writes == 1).all()
    assert np.array_equal(out, dense)
    twin = cd.coo_densify(*_wire(rows, counts, vals, "int16", "uint8"),
                          nrows)
    assert np.array_equal(out, twin.numpy())
    assert plan.tile_rows <= cd.MAX_TILE_ROWS and plan.ld >= plan.tile_rows
    assert plan.ld % 32 == 4
    assert 4 * plan.ld * cd.TILE_COLS <= SHARED_LIMIT


@pytest.mark.parametrize("nrows,tiles,tile_rows", [
    (5_000, 2, 2500),          # a forward panel of hcabm40k
    (40_000, 14, 2858),        # a transposed one
    (13_714, 5, 2743)])
def test_plan_at_the_main_path_shapes(nrows, tiles, tile_rows):
    plan = cd.plan_coo_densify(nrows)
    assert plan.tile_rows == tile_rows
    assert -(-nrows // plan.tile_rows) == tiles
    # two blocks a multiprocessor
    assert 4 * plan.ld * cd.TILE_COLS <= SHARED_LIMIT // 2
    with pytest.raises(ValueError):
        cd.plan_coo_densify(0)
