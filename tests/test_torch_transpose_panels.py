"""The transposed-panel build (``ops/transpose_panels.py``) on the CPU.

The plain twin against numpy's transpose of the same matrix, bit for bit
(NaN payloads, -0.0 and subnormals included), for panels of equal widths
with a ragged last one, widths that are not multiples of 4, one panel, one
row and every place of the transposed rows; the table's checks and its
choice of 16-byte accesses; and the kernel's plan (``csrc/
transpose_panels.cu`` reads it as given): a numpy walk of its blocks, both
access widths, writes every output element once with the twin's bits.
``tests/test_torch_kernels_gpu.py`` holds the kernel to the twin bit for
bit on the card.
"""

import numpy as np
import pytest
import torch

from rcppml_tpu_torch.ops import transpose_panels as tp

TILE, THREADS = 32, 256          # csrc/transpose_panels.cu


def _matrix(m, n, seed):
    rs = np.random.RandomState(seed)
    return rs.standard_normal((m, n)).astype(np.float32)


def _table(A, widths):
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(int)
    # torch's own allocations: 16-byte aligned whatever numpy gives
    panels = [torch.tensor(A[:, s:s + w]) for s, w in zip(starts, widths)]
    return tp.panel_table(panels, starts.tolist())


def _same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


# name: (m, forward widths, (row0, ncols) of the transposed panels)
CASES = {
    "ragged_last": (70, [16, 16, 16, 4], [(0, 32), (32, 32), (64, 6)]),
    "odd_widths": (45, [7, 13, 1, 9], [(0, 45), (3, 5), (44, 1)]),
    "one_panel": (33, [40], [(0, 33), (10, 23)]),
    "one_row": (1, [5, 3], [(0, 1)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_the_numpy_transpose(case):
    m, widths, places = CASES[case]
    A = _matrix(m, sum(widths), 3)
    tab = _table(A, widths)
    assert tab.n == A.shape[1] and tab.m == m and tab.table is None
    for row0, nc in places:
        before = tp.transpose_panels.launches
        got = tp.transpose_panels(tab, row0, nc)
        assert tp.transpose_panels.launches == before      # the twin
        assert got.dtype == torch.float32 and got.shape == (A.shape[1], nc)
        assert got.is_contiguous()
        assert _same_bits(got.numpy(), A[row0:row0 + nc].T)


def test_twin_copies_every_bit():
    A = _matrix(12, 20, 4)
    bits = A.view(np.int32)
    bits[0, 0] = 0x7FC12345                      # a NaN with a payload
    bits[1, 3] = np.int32(-2**31)                # -0.0
    bits[2, 7] = 1                               # the least subnormal
    bits[5, 19] = 0x7F800000                     # +inf
    got = tp.transpose_panels_plain(_table(A, [8, 8, 4]), 0, 12)
    assert _same_bits(got.numpy(), A.T)


@pytest.mark.parametrize("widths,vec", [([512, 512, 64], 4),
                                        ([8, 12, 4], 4),
                                        ([8, 6, 4], 1), ([3], 1)])
def test_table_takes_16_byte_accesses_where_every_width_allows(widths, vec):
    assert _table(_matrix(8, sum(widths), 5), widths).vec == vec


REFUSALS = {
    "no_panels": (lambda F: ([], []), ValueError, "0 panels"),
    "starts_count": (lambda F: ([F, F], [0]), ValueError, "2 panels"),
    "float64": (lambda F: ([F.double()], [0]), TypeError, "float64"),
    "one_dim": (lambda F: ([F[0]], [0]), ValueError, "shape"),
    "no_columns": (lambda F: ([F[:, :0]], [0]), ValueError, "shape"),
    "row_counts": (lambda F: ([F, F[:3]], [0, 6]), ValueError, "shape"),
    "strided": (lambda F: ([F[:, ::2]], [0]), ValueError, "contiguous"),
    "first_start": (lambda F: ([F], [1]), ValueError, "starts at column"),
    "gap": (lambda F: ([F, F], [0, 7]), ValueError, "starts at column"),
    "meta": (lambda F: ([F, F.to("meta")], [0, 6]), ValueError, "on"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_table_refuses(case):
    make, err, match = REFUSALS[case]
    F = torch.from_numpy(_matrix(5, 6, 6))
    with pytest.raises(err, match=match):
        tp.panel_table(*make(F))


@pytest.mark.parametrize("row0,ncols", [(-1, 2), (0, 0), (4, 2), (5, 1)])
def test_wrapper_refuses_rows_outside_the_panels(row0, ncols):
    tab = _table(_matrix(5, 6, 7), [3, 3])
    with pytest.raises(ValueError, match="rows"):
        tp.transpose_panels(tab, row0, ncols)


def _kernel_walk(tab, row0, ncols, vec):
    """Every block of ``csrc/transpose_panels.cu`` in numpy: the load into
    the [c][r] tile, then the write-out, each thread's indices as the
    kernel forms them.  Returns the output and how often each element was
    written."""
    starts = np.asarray(tab.starts)
    flat = [F.numpy().ravel() for F in tab.panels]
    n = tab.n
    out = np.full((n, ncols), np.nan, np.float32)
    writes = np.zeros((n, ncols), int)

    def panel_of(r):
        lo, hi = 0, len(flat) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if starts[mid] <= r else (lo, mid - 1)
        return lo
    for bx in range(-(-n // TILE)):
        for by in range(-(-ncols // TILE)):
            r0, c0 = bx * TILE, by * TILE
            tile = np.full((TILE, TILE + 1), np.nan, np.float32)
            for t in range(THREADS):
                if vec == 4:
                    q, row = t & 7, t >> 3
                    r, c = r0 + 4 * q, c0 + row
                    if r < n and c < ncols:
                        p = panel_of(r)
                        s, w = starts[p], starts[p + 1] - starts[p]
                        at = (row0 + c) * w + (r - s)
                        assert at % 4 == 0 and r - s + 4 <= w
                        tile[row, 4 * q:4 * q + 4] = flat[p][at:at + 4]
                else:
                    x, y = t & 31, t >> 5
                    r = r0 + x
                    if r < n:
                        p = panel_of(r)
                        s, w = starts[p], starts[p + 1] - starts[p]
                        for row in range(y, TILE, THREADS // 32):
                            c = c0 + row
                            if c < ncols:
                                tile[row, x] = flat[p][(row0 + c) * w
                                                       + (r - s)]
            for t in range(THREADS):
                if vec == 4:
                    q, row = t & 7, t >> 3
                    r2, c2 = r0 + row, c0 + 4 * q
                    if r2 < n and c2 < ncols:
                        out[r2, c2:c2 + 4] = tile[4 * q:4 * q + 4, row]
                        writes[r2, c2:c2 + 4] += 1
                else:
                    x, y = t & 31, t >> 5
                    c = c0 + x
                    if c < ncols:
                        for row in range(y, TILE, THREADS // 32):
                            if r0 + row < n:
                                out[r0 + row, c] = tile[x, row]
                                writes[r0 + row, c] += 1
    return out, writes


@pytest.mark.parametrize("widths,row0,ncols,vec", [
    ([64, 64, 8], 4, 36, 4),           # a ragged last panel and tile
    ([40, 24], 0, 68, 4),              # tiles across a panel boundary
    ([7, 13, 30], 2, 33, 1),           # widths no multiple of 4
    ([1], 0, 1, 1),
])
def test_plan_writes_every_element_once(widths, row0, ncols, vec):
    A = _matrix(row0 + ncols + 3, sum(widths), 8)
    tab = _table(A, widths)
    got, writes = _kernel_walk(tab, row0, ncols, vec)
    assert (writes == 1).all()
    assert _same_bits(got, tp.transpose_panels_plain(tab, row0,
                                                     ncols).numpy())
