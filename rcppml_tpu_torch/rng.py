"""SplitMix64 RNG: deterministic factor initialization and holdout masks.

The host half of ``rcppml_tpu/rng.py`` (``:37-113``, the R samplers of
``:116-165``, ``:167-182``, ``:251-256``), copied so that this package never
imports JAX (that module imports ``jax.numpy`` at top level).  It
reproduces the reference's RNG
contract (``inst/include/FactorNet/rng/rng.hpp:60-221``): the same integer
seed gives the same W/H initialization as the JAX package, bit for bit, and a
cross-validation holdout mask is a pure function of ``(seed, i, j)``.

The sequential stream's state after ``t`` draws is ``seed + t * GOLDEN``, so
the whole stream is generated vectorized in numpy uint64 (exact).  The
position hash is evaluated on the host in numpy uint64 (:func:`holdout_mask`)
and on the fit's device in torch int64 (:func:`is_holdout`, the counterpart
of the JAX package's ``is_holdout_traced``); the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_COLMIX = np.uint64(0x6C62272E07BB0142)
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


def position_hash(seed: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Pure position hash (rng.hpp:129-138): ``hash(seed, i, j)``.

    ``i``/``j`` broadcast; uint32 semantics on the indices (matching the
    reference's uint32_t parameters).  The seed is remapped like an engine's
    (0 -> 12345), as ``SplitMix64(seed).is_holdout(...)`` does
    (rng.hpp:178-182).
    """
    s = _canon_seed(seed)
    i64 = np.asarray(i).astype(np.uint32).astype(np.uint64)
    j64 = np.asarray(j).astype(np.uint32).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = s + i64 * _GOLDEN + j64 * _COLMIX
    return _finalize(h)


def holdout_mask(seed: int, rows, cols, inv_prob: int) -> np.ndarray:
    """Dense boolean holdout mask on the host: True where (i, j) is held out.

    ``hash(seed,i,j) < UINT64_MAX / inv_prob`` (rng.hpp:164-170).
    ``rows``/``cols`` may be ints (meaning ``arange``) or index arrays.
    """
    ii = (np.arange(rows, dtype=np.uint32) if np.isscalar(rows)
          else np.asarray(rows, np.uint32))
    jj = (np.arange(cols, dtype=np.uint32) if np.isscalar(cols)
          else np.asarray(cols, np.uint32))
    if inv_prob <= 0:
        return np.zeros((len(ii), len(jj)), dtype=bool)
    h = position_hash(seed, ii[:, None], jj[None, :])
    thresh = _U64_MAX // np.uint64(inv_prob)
    return h < thresh


# ---------------------------------------------------------------------------
# The R samplers (R/random.R), copies of ``rcppml_tpu/rng.py:116-165``: host
# numpy on the same stream and hash, bit for bit the JAX package's.
# ---------------------------------------------------------------------------

def r_matrix(rows: int, cols: int, seed: int = 0,
             transpose_identical: bool = False) -> np.ndarray:
    """Reproducible uniform matrix (R/random.R r_matrix).  With
    ``transpose_identical``, entry (i, j) is a pure position hash so
    ``r_matrix(n, m, s, True).T == r_matrix(m, n, s, True)`` — the
    transpose-consistency testing trick."""
    if transpose_identical:
        # symmetric position hash: unordered pair (min, max)
        ii = np.arange(rows, dtype=np.uint32)[:, None]
        jj = np.arange(cols, dtype=np.uint32)[None, :]
        h = position_hash(seed, np.minimum(ii, jj), np.maximum(ii, jj))
        return (h.astype(np.float64) / float(int(_U64_MAX))).astype(np.float32)
    return fill_uniform(seed, rows, cols)


def r_sparsematrix(rows: int, cols: int, density: float = 0.1, seed: int = 0,
                   transpose_identical: bool = False):
    """Reproducible sparse uniform matrix (R/random.R r_sparsematrix)."""
    import scipy.sparse as sp
    vals = r_matrix(rows, cols, seed, transpose_identical)
    ii = np.arange(rows, dtype=np.uint32)[:, None]
    jj = np.arange(cols, dtype=np.uint32)[None, :]
    if transpose_identical:
        keep_hash = position_hash(seed ^ 0x5BF03635, np.minimum(ii, jj),
                                  np.maximum(ii, jj))
    else:
        keep_hash = position_hash(seed ^ 0x5BF03635, ii, jj)
    keep = keep_hash < np.uint64(density * float(int(_U64_MAX)))
    return sp.csc_matrix(np.where(keep, vals, 0.0))


def r_sample(n: int, size: int, seed: int = 0, replace: bool = False):
    """Reproducible sampling (R/random.R r_sample) via the sequential stream."""
    if replace:
        return (next_u64(seed, size) % np.uint64(n)).astype(np.int64)
    order = np.argsort(next_u64(seed, n), kind="stable")
    return order[:size].astype(np.int64)


def r_unif(count: int, seed: int = 0, lo: float = 0.0, hi: float = 1.0):
    u = next_u64(seed, count).astype(np.float64) / float(int(_U64_MAX))
    return (lo + (hi - lo) * u).astype(np.float32)


def r_binom(count: int, p: float, seed: int = 0):
    u = next_u64(seed, count).astype(np.float64) / float(int(_U64_MAX))
    return (u < p).astype(np.int32)


def subsample_mask_1d(seed: int, count: int, frac: float,
                      use_col_constant: bool = True) -> np.ndarray:
    """Row/column subsample eligibility (speckled_cv.hpp:80-104):
    1-D SplitMix hash with the dedicated subsample seed
    ``seed ^ 0xDEADBEEFCAFEBABE``; columns use the golden-ratio constant,
    rows the column-mix constant, to avoid correlation."""
    if frac >= 1.0:
        return np.ones(count, dtype=bool)
    sub_seed = _canon_seed(seed) ^ np.uint64(0xDEADBEEFCAFEBABE)
    mult = _GOLDEN if use_col_constant else _COLMIX
    idx = np.arange(count, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = sub_seed + idx * mult
    h = _finalize(h)
    thresh = np.uint64(frac * float(int(_U64_MAX)))
    return h < thresh


def seed_to_u32_pair(seed: int) -> np.ndarray:
    """Canonical seed as a (lo32, hi32) uint32 array."""
    s = int(_canon_seed(seed))
    return np.asarray([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF],
                      dtype=np.uint32)


# ---------------------------------------------------------------------------
# The holdout test on the fit's device.  torch has no uint64: the hash runs
# in int64, whose multiply and add wrap like uint64's; ``>>`` is arithmetic
# there, so the shifted-in sign bits are masked off, and ``<`` is signed, so
# both sides have their sign bit flipped first.
# ---------------------------------------------------------------------------

_SIGN = -(1 << 63)
# rows hashed at once: bounds the int64 temporaries to a few hundred MB
_HASH_CHUNK_ELEMS = 1 << 24


def _i64(v: int) -> int:
    """A 64-bit pattern as the Python int of the int64 that holds it."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


def _lshr(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _finalize_i64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _lshr(z, 30)) * _i64(int(_MIX1))
    z = (z ^ _lshr(z, 27)) * _i64(int(_MIX2))
    return z ^ _lshr(z, 31)


def is_holdout(seed: int, m: int, n: int, inv_prob: int,
               device, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """The (m, n) boolean holdout mask of the entries (row0 + i, col0 + j)
    computed on ``device``, bit for bit :func:`holdout_mask` ``(seed, m, n,
    inv_prob)`` when both offsets are 0: nothing is uploaded.  The
    counterpart of ``rcppml_tpu.rng.is_holdout_traced`` over ``arange(m) +
    row0`` x ``arange(n) + col0`` (a streamed panel passes its offsets)."""
    device = torch.device(device)
    if inv_prob <= 0:
        return torch.zeros((m, n), dtype=torch.bool, device=device)
    s = _i64(int(_canon_seed(seed)))
    thresh = _i64(0xFFFFFFFFFFFFFFFF // int(inv_prob)) ^ _SIGN
    tj = ((torch.arange(n, dtype=torch.int64, device=device) + int(col0))
          * _i64(int(_COLMIX)))[None, :]
    out = torch.empty((m, n), dtype=torch.bool, device=device)
    rows = max(1, _HASH_CHUNK_ELEMS // max(n, 1))
    for r0 in range(0, m, rows):
        r1 = min(r0 + rows, m)
        ti = (torch.arange(r0 + int(row0), r1 + int(row0), dtype=torch.int64,
                           device=device) * _i64(int(_GOLDEN)) + s)[:, None]
        h = _finalize_i64(ti + tj)
        out[r0:r1] = (h ^ _SIGN) < thresh
    return out
