"""SplitMix64 RNG on the host: deterministic factor initialization.

The host half of ``rcppml_tpu/rng.py`` (``:37-74``), copied so that this
package never imports JAX (that module imports ``jax.numpy`` at top level).
It reproduces the reference's RNG contract
(``inst/include/FactorNet/rng/rng.hpp:60-221``): the same integer seed gives
the same W/H initialization as the JAX package, bit for bit.

The sequential stream's state after ``t`` draws is ``seed + t * GOLDEN``, so
the whole stream is generated vectorized in numpy uint64 (exact).  The
holdout-mask hashes wait for the CV slice (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _finalize(z: np.ndarray) -> np.ndarray:
    """SplitMix64 output mixing (rng.hpp:91-94)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


def _canon_seed(seed: int) -> np.uint64:
    """Seed 0 is remapped to 12345 to avoid a degenerate state (rng.hpp:73-74)."""
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    return np.uint64(12345) if s == 0 else s


def next_u64(seed: int, count: int, offset: int = 0) -> np.ndarray:
    """The sequential SplitMix64 stream, vectorized.

    Draw ``t`` (1-based) of the reference's sequential ``next()`` equals
    ``finalize(seed + t * GOLDEN)``; this returns draws
    ``offset+1 .. offset+count``.
    """
    s = _canon_seed(seed)
    t = np.arange(offset + 1, offset + count + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = s + t * _GOLDEN
    return _finalize(z)


def fill_uniform(seed: int, rows: int, cols: int, *, offset: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """Column-major uniform [0,1) fill, identical to ``fill_uniform``
    (rng.hpp:194-201): the sequential stream fills column 0 top-to-bottom,
    then column 1, etc.  Returns a (rows, cols) array.
    """
    z = next_u64(seed, rows * cols, offset)
    # one correctly rounded uint64 -> float conversion, as in C++; the
    # float cast of UINT64_MAX rounds to 2^64 in both C++ and numpy
    u = z.astype(dtype) / dtype(float(int(_U64_MAX)))
    return u.reshape(cols, rows).T
