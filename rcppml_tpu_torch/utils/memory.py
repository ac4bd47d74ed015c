"""Memory guards — core/memory.hpp + core/platform.hpp re-targeted.

The port of ``rcppml_tpu/utils/memory.py``.  The reference refuses an
in-memory sparse transpose when it would not fit in host RAM with 2x
headroom (core/memory.hpp:152-190, ``check_transpose_memory``) and reads
MemAvailable from /proc/meminfo (core/platform.hpp:42-63).  Here the
dangerous allocations are the host densification of a sparse input and the
copy of A on the card, whose memory ``torch.cuda.mem_get_info`` reports.
"""
from __future__ import annotations

from dataclasses import dataclass

# Require this multiple of the allocation to be free, matching the
# reference's SAFETY_FACTOR = 2.0 (core/memory.hpp:167-169): fits,
# factors, and solver workspaces ride alongside the data matrix.
SAFETY_FACTOR = 2.0


def format_bytes(n: float) -> str:
    """Human-readable byte count (core/memory.hpp format_bytes)."""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TB"


def available_host_bytes() -> int:
    """MemAvailable from /proc/meminfo; 0 = unknown (platform.hpp:42-63)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def device_hbm_bytes() -> int:
    """Device memory of the current CUDA card in bytes (its total, as the
    JAX package reads a device's ``bytes_limit``); 0 = no card."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.mem_get_info()[1])


@dataclass
class MemoryCheckResult:
    """Mirror of core/memory.hpp MemoryCheckResult."""
    fits: bool
    required_bytes: int
    available_bytes: int
    headroom_fraction: float
    message: str


def check_dense_alloc(m: int, n: int, itemsize: int = 4,
                      where: str = "host") -> MemoryCheckResult:
    """Would a dense (m, n) allocation fit with 2x headroom?

    ``where`` selects the budget: "host" (RAM, for densifying sparse
    input) or "device" (the card's memory, for the copy of A there).
    Unknown budgets pass with a note, as in core/memory.hpp:157-165.
    """
    required = int(m) * int(n) * int(itemsize)
    available = (available_host_bytes() if where == "host"
                 else device_hbm_bytes())
    if available == 0:
        return MemoryCheckResult(
            True, required, 0, 0.0,
            f"dense allocation: {format_bytes(required)} "
            f"({where} memory unknown — proceeding)")
    headroom = available / max(required, 1)
    if headroom >= SAFETY_FACTOR:
        return MemoryCheckResult(
            True, required, available, headroom,
            f"dense allocation: {format_bytes(required)} of "
            f"{format_bytes(available)} available ({where}, "
            f"headroom {headroom:.0f}x)")
    return MemoryCheckResult(
        False, required, available, headroom,
        f"INSUFFICIENT {where.upper()} MEMORY for an in-memory dense "
        f"{m} x {n} matrix: needs {format_bytes(required)} "
        f"(x{SAFETY_FACTOR:.0f} headroom) but only "
        f"{format_bytes(available)} is available.\n"
        f"Stream it instead: nmf() switches to the streaming engine for a "
        f"host matrix the card cannot hold; or write it with st_write() "
        f"and fit the .spz path, or pass streaming=True.")


def guard_dense_input(m: int, n: int, itemsize: int = 4) -> None:
    """Raise MemoryError before densifying a sparse input that cannot
    fit in host RAM — the check_transpose_memory refusal re-targeted."""
    res = check_dense_alloc(m, n, itemsize, where="host")
    if not res.fits:
        raise MemoryError(res.message)
