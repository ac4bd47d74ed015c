"""A sparse column panel's compact triples -> the dense float32 panel: the
CUDA kernel and its plain PyTorch twin.

Replaces no TPU kernel: the JAX package's streaming engine leaves this
scatter to XLA (``rcppml_tpu/models/nmf_chunked.py::_coo_densify``).  It
exists for device memory: the twin holds int64 column ids, an int64 flat
index and a float32 copy of the values beside the panel (60 to 85 MiB for a
40,000 x 512 panel of 3.4M entries), and a stream that keeps its dense
panels on the card (``io/panels.py``) densifies its last panel when
that cache is full.  The CUDA source is ``csrc/coo_densify.cu``: a block owns
a tile of :data:`TILE_COLS` columns by up to :data:`MAX_TILE_ROWS` rows in
shared memory, zeroes it, scatters its columns' entries whose rows fall in
it (a warp a column) and writes it out row by row; it allocates nothing, and
the wrapper allocates only the panel.  What bounds it on the H100 is bytes:
one write of the panel and one read of the triples.

The triples are a panel in canonical CSC order (each (row, column) at most
once), as the streaming engine ships them (``_compact_sparse``): ``rows``
int16 (the wire's view of uint16) or int32, ``vals`` uint8, int16 (the view
of uint16) or float32, each nnz long, and ``counts`` int32, one a column.
Both versions write the entry's value converted to float32 (exact from
uint8 and uint16) and +0.0 elsewhere, so the kernel's panel is the twin's bit
for bit.

:func:`coo_densify` launches the kernel for CUDA tensors and runs
:func:`coo_densify_plain` for CPU tensors; there is no other branch.
``coo_densify.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

KERNEL = "coo_densify"
# csrc/coo_densify.cu: columns of a block's tile (a warp each), and the most
# rows a tile holds (8 x 3,076 floats of shared memory: two blocks a
# multiprocessor)
TILE_COLS = 8
MAX_TILE_ROWS = 3072
ROW_BYTES = {torch.int16: 2, torch.int32: 4}
VAL_KINDS = {torch.uint8: 0, torch.int16: 1, torch.float32: 2}


class DensifyPlan(NamedTuple):
    """How a panel's rows are cut (``csrc/coo_densify.cu``); the kernel runs
    ceil(ncols / TILE_COLS) x ceil(nrows / tile_rows) blocks, each with
    4 * ld * TILE_COLS bytes of dynamic shared memory."""
    tile_rows: int      # rows of a block's tile
    ld: int             # row stride of the tile in shared memory


def plan_coo_densify(nrows: int) -> DensifyPlan:
    """The tiles of a panel of ``nrows`` rows: ceil(nrows / MAX_TILE_ROWS)
    of nearly equal height; the tile's stride is 4 mod 32, so the
    write-out's reads (eight columns by four rows a warp) meet 32 distinct
    banks.  A function of the shape alone."""
    if nrows < 1:
        raise ValueError(f"plan_coo_densify: nrows={nrows} must be positive")
    tile_rows = -(-nrows // -(-nrows // MAX_TILE_ROWS))
    return DensifyPlan(tile_rows, -(-tile_rows // 32) * 32 + 4)


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A wire array back to its values: a uint16 array travels as its int16
    view (torch's uint16 has few kernels) and is widened exactly with
    ``& 0xFFFF``; uint8 and int32 convert as they are."""
    if t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t


def coo_densify_plain(rows: torch.Tensor, counts: torch.Tensor,
                      vals: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain twin: the column ids expanded from the counts
    (``repeat_interleave`` with its ``output_size``, so nothing is read
    back), the entries written into a zeroed panel by a flat-index scatter.
    The (row, column) pairs of canonical CSC are unique, so the panel is
    exactly the host's densified one."""
    ncols = counts.shape[0]
    dev = rows.device
    cols = torch.repeat_interleave(
        torch.arange(ncols, dtype=torch.int64, device=dev),
        counts.to(torch.int64), output_size=rows.shape[0])
    flat = _widen(rows).to(torch.int64) * ncols + cols
    Z = torch.zeros(nrows * ncols, dtype=torch.float32, device=dev)
    Z[flat] = _widen(vals).to(torch.float32)
    return Z.view(nrows, ncols)


def _check(rows, counts, vals):
    for name, t, allowed in (("rows", rows, ROW_BYTES),
                             ("counts", counts, (torch.int32,)),
                             ("vals", vals, VAL_KINDS)):
        if t.dtype not in allowed:
            raise TypeError(f"coo_densify: {name} must be one of "
                            f"{[str(d) for d in allowed]}, got {t.dtype}")
        if t.ndim != 1:
            raise ValueError(f"coo_densify: {name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"coo_densify: {name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"coo_densify: rows are on {rows.device}, "
                             f"{name} on {t.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"coo_densify: no densify on {rows.device}")
    if vals.shape[0] != rows.shape[0]:
        raise ValueError(f"coo_densify: {rows.shape[0]} rows and "
                         f"{vals.shape[0]} values")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.coo_densify_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def coo_densify(rows: torch.Tensor, counts: torch.Tensor, vals: torch.Tensor,
                nrows: int) -> torch.Tensor:
    """The dense (nrows, len(counts)) float32 panel of a column panel's
    compact triples in canonical CSC order: ``rows`` (int16 view of uint16,
    or int32) and ``vals`` (uint8, int16 view of uint16, or float32), 1-D,
    contiguous, of one length, and the per-column ``counts`` (int32), all on
    one device.  On a CUDA device this launches the kernel (it raises if the
    launch fails); on the CPU it runs :func:`coo_densify_plain`."""
    _check(rows, counts, vals)
    if not rows.is_cuda:
        return coo_densify_plain(rows, counts, vals, nrows)
    ncols = counts.shape[0]
    out = torch.empty((nrows, ncols), dtype=torch.float32, device=rows.device)
    if nrows == 0 or ncols == 0:
        return out
    plan = plan_coo_densify(nrows)
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.coo_densify_launch(
            rows.data_ptr(), ROW_BYTES[rows.dtype], counts.data_ptr(),
            vals.data_ptr(), VAL_KINDS[vals.dtype], nrows, ncols,
            plan.tile_rows, plan.ld, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"coo_densify kernel launch failed: CUDA error "
                           f"{err} (nrows={nrows}, ncols={ncols}, "
                           f"nnz={rows.shape[0]})")
    coo_densify.launches += 1
    return out


coo_densify.launches = 0
