"""Stream panels onto the device, and the rule for keeping them there.

Shared by the streaming NMF engine (``models/nmf_chunked.py``) and the
streaming SVD's product operator (``models/svd.py::_LoaderOp``): both read
column panels from a loader, upload each one, and keep the dense panels on
the device across sweeps when both copies of the matrix fit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..utils.memory import SAFETY_FACTOR

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


def upload(arr: np.ndarray, dev: torch.device,
           stats: Optional[dict] = None) -> torch.Tensor:
    """One host array on ``dev``.  To the card it goes from a pinned copy
    (``pin_memory()``) with ``non_blocking=True``; torch's caching host
    allocator reuses a pinned block only once its copy has passed.  A uint16
    array travels as its int16 view (torch's uint16 has few kernels; the
    densify widens it back).  On the card ``stats["upload_s"]`` /
    ``["upload_bytes"]`` add the host time and the bytes of the transfer."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    if dev.type != "cuda":
        return torch.from_numpy(arr).to(dev)
    t0 = time.perf_counter()
    out = torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)
    if stats is not None:
        stats["upload_s"] = stats.get("upload_s", 0.0) + \
            time.perf_counter() - t0
        stats["upload_bytes"] = stats.get("upload_bytes", 0) + arr.nbytes
    return out
