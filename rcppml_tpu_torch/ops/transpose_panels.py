"""A stream's transposed column panel, built from the dense forward panels
the device already holds: the CUDA kernel and its plain PyTorch twin.

Replaces no TPU kernel: the JAX package's streaming engine decodes a
``.spz`` file's transpose stream and uploads each of its panels.  Once a
stream's dense panel cache (``io/panels.py``) holds every forward panel,
all of A is on the device, and each transposed panel is a copy out of those
panels in another layout; this builds it there instead of a second decode,
its uploads and its densify launches.  The CUDA source is
``csrc/transpose_panels.cu``: a block moves a 32 x 32 tile through shared
memory, reading along a forward panel's row and writing along the output's
row, 16 bytes a thread where every width is a multiple of 4 and every
address 16-byte aligned (:attr:`PanelTable.vec`).  What bounds it on the
H100 is bytes: the panel read once and written once.  The wrapper allocates
only the output panel.

A forward panel ``p`` is dense float32 (m, w_p), row-major, holding A's
columns [s_p, s_p + w_p); the panels cover A's n columns in order.  The
transposed panel of A's rows [row0, row0 + ncols) is (n, ncols) with
``out[r, c] = F_p[row0 + c, r - s_p]``.  Both versions copy every element's
bits, so the kernel's panel is the twin's bit for bit.

:func:`panel_table` checks the forward panels once and, on a CUDA device,
puts their addresses and column starts in one int64 device table;
:func:`transpose_panels` launches the kernel for a CUDA table and runs
:func:`transpose_panels_plain` for a CPU one; there is no other branch.
``transpose_panels.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

KERNEL = "transpose_panels"


class PanelTable(NamedTuple):
    """The forward panels a transposed panel is read from."""
    panels: tuple       # the dense (m, w_p) float32 panels, in column order
    starts: tuple       # their first columns, then n
    m: int              # rows of every panel (A's rows)
    device: torch.device
    table: Optional[torch.Tensor]  # int64 addresses then starts (CUDA only)
    vec: int            # 4: float4 accesses; 1: one float a thread

    @property
    def n(self) -> int:
        """A's columns: the rows of a transposed panel."""
        return self.starts[-1]


def panel_table(panels: Sequence[torch.Tensor],
                starts: Sequence[int]) -> PanelTable:
    """The table of the dense forward panels ``panels`` whose first columns
    are ``starts``: one device, float32, 2-D, contiguous, one row count, and
    each panel starting where the one before it ends, from column 0.  On a
    CUDA device their addresses and the starts go to the device once, from
    a pinned copy without a host wait (the panels must outlive the table's
    use, which holds them)."""
    panels, starts = tuple(panels), [int(s) for s in starts]
    if not panels or len(panels) != len(starts):
        raise ValueError(f"transpose_panels: {len(panels)} panels and "
                         f"{len(starts)} starts")
    dev = panels[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"transpose_panels: no transpose on {dev}")
    m = panels[0].shape[0] if panels[0].ndim == 2 else -1
    for p, (F, s) in enumerate(zip(panels, starts)):
        if F.dtype != torch.float32:
            raise TypeError(f"transpose_panels: panel {p} is {F.dtype}, "
                            "not torch.float32")
        if F.ndim != 2 or F.shape[0] != m or F.shape[1] < 1:
            raise ValueError(f"transpose_panels: panel {p} has shape "
                             f"{tuple(F.shape)}, not ({m}, >= 1)")
        if not F.is_contiguous():
            raise ValueError(f"transpose_panels: panel {p} must be "
                             "contiguous")
        if F.device != dev:
            raise ValueError(f"transpose_panels: panel 0 is on {dev}, "
                             f"panel {p} on {F.device}")
        want = 0 if p == 0 else starts[p - 1] + panels[p - 1].shape[1]
        if s != want:
            raise ValueError(f"transpose_panels: panel {p} starts at column "
                             f"{s}, not {want}")
    if m < 1:
        raise ValueError("transpose_panels: the panels have no rows")
    starts.append(starts[-1] + panels[-1].shape[1])
    vec = 4 if all(F.shape[1] % 4 == 0 and F.data_ptr() % 16 == 0
                   for F in panels) else 1
    table = None
    if dev.type == "cuda":
        host = torch.tensor([F.data_ptr() for F in panels] + starts,
                            dtype=torch.int64)
        table = host.pin_memory().to(dev, non_blocking=True)
    return PanelTable(panels, tuple(starts), m, dev, table, vec)


def _check(tab: PanelTable, row0: int, ncols: int) -> None:
    if not 0 <= row0 < row0 + ncols <= tab.m:
        raise ValueError(f"transpose_panels: rows [{row0}, {row0 + ncols}) "
                         f"of panels with {tab.m} rows")


def transpose_panels_plain(tab: PanelTable, row0: int,
                           ncols: int) -> torch.Tensor:
    """Plain twin: each forward panel's rows [row0, row0 + ncols) copied,
    transposed, into its rows of the output (a strided ``copy_``)."""
    _check(tab, row0, ncols)
    out = torch.empty((tab.n, ncols), dtype=torch.float32, device=tab.device)
    for F, s, e in zip(tab.panels, tab.starts, tab.starts[1:]):
        out[s:e].copy_(F[row0:row0 + ncols].t())
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.transpose_panels_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                                             ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def transpose_panels(tab: PanelTable, row0: int, ncols: int) -> torch.Tensor:
    """The dense (n, ncols) float32 transposed panel of A's rows
    [row0, row0 + ncols), read from the forward panels of ``tab``.  On a
    CUDA device this launches the kernel (it raises if the launch fails);
    on the CPU it runs :func:`transpose_panels_plain`."""
    if tab.table is None:
        return transpose_panels_plain(tab, row0, ncols)
    _check(tab, row0, ncols)
    vec = tab.vec if ncols % 4 == 0 else 1
    out = torch.empty((tab.n, ncols), dtype=torch.float32, device=tab.device)
    lib = _library()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.transpose_panels_launch(
            tab.table.data_ptr(), len(tab.panels), tab.n, row0, ncols, vec,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"transpose_panels kernel launch failed: CUDA "
                           f"error {err} (n={tab.n}, row0={row0}, "
                           f"ncols={ncols}, vec={vec})")
    transpose_panels.launches += 1
    return out


transpose_panels.launches = 0
