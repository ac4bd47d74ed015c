"""Stream panels onto the device, and the rule for keeping them there.

Shared by the streaming NMF engine's panel source (``io/panels.py``) and the
streaming SVD's product operator (``models/svd.py::_LoaderOp``): both read
column panels from a loader, upload each one, and keep the dense panels on
the device across sweeps when both copies of the matrix fit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.memory import SAFETY_FACTOR
from ..utils.trace import spanned

# bytes of a static budget where the device's memory is not known (a fit
# on the CPU): the JAX package's bound for the panel and wire caches
STATIC_CACHE_BYTES = 4 * 1024 ** 3


def device_bytes(dev: torch.device) -> int:
    """The card's memory in bytes; 0 off the card."""
    return int(torch.cuda.mem_get_info(dev)[1]) if dev.type == "cuda" else 0


def dense_cache_fits(m: int, n: int, dev: torch.device) -> bool:
    """Whether the dense forward and transposed panels of an (m, n) float32
    matrix may both stay on ``dev``: within the card's memory with the fits'
    headroom (``SAFETY_FACTOR``), or within ``STATIC_CACHE_BYTES`` off the
    card."""
    total = device_bytes(dev)
    if total > 0:
        return SAFETY_FACTOR * 2 * m * n * 4 <= total
    return 2.0 * m * n * 4 <= STATIC_CACHE_BYTES


@spanned("rtt.stream.upload")
def upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host array on ``dev``.  To the card it goes from a pinned copy
    (``pin_memory()``) with ``non_blocking=True``; torch's caching host
    allocator reuses a pinned block only once its copy has passed.  A uint16
    array travels as its int16 view (torch's uint16 has few kernels; the
    densify widens it back).  Each call is a ``rtt.stream.upload`` span."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    if dev.type != "cuda":
        return torch.from_numpy(arr).to(dev)
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)
