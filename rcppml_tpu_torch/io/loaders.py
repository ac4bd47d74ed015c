"""DataLoader abstraction for larger-than-memory NMF.

The port's copy of ``rcppml_tpu/io/loaders.py``, the equivalent of
``inst/include/FactorNet/io/`` (loader.hpp:60 interface, in_memory.hpp,
spz_loader.hpp, caching_loader.hpp, ping_pong_prefetch.hpp): iterate column
panels of A and of A^T, with a background-thread prefetcher that overlaps
host-side decode with device compute (the reference's 2-slot ping-pong
double buffer).

Panels are delivered as host numpy blocks: DENSE float32 (``Chunk``) or
COO (``SparseChunk``).  Everything here runs on the host; the Prefetcher's
worker threads decode and compact panels and make no CUDA call — the
streaming engine (``models/nmf_chunked.py``) uploads them.
"""

from __future__ import annotations

import concurrent.futures
import math
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils.trace import span


class Chunk:
    """One column panel (io/loader.hpp Chunk, :40-50)."""

    __slots__ = ("col_start", "num_cols", "data")

    def __init__(self, col_start: int, data: np.ndarray):
        self.col_start = col_start
        self.num_cols = data.shape[1]
        self.data = data


class SparseChunk:
    """One column panel in COO form — the nnz-proportional ingest option
    (VERDICT r3 #4/#2).  At the target densities (~5%), shipping
    (rows, cols, vals) instead of the dense block cuts host->device
    traffic ~5.5x (12 bytes/nnz vs 4 bytes/element); the panel is
    densified ON DEVICE by a scatter so the downstream dense GEMM path
    is unchanged.  The reference's analogous structure is the CSC chunk
    cuSPARSE consumes (sp_gpu_bridge.cu); sparsity is exploited at the
    TRANSFER, not the FLOP."""

    __slots__ = ("col_start", "num_cols", "nnz", "rows", "counts", "vals")

    def __init__(self, col_start: int, num_cols: int, rows: np.ndarray,
                 counts: np.ndarray, vals: np.ndarray):
        self.col_start = col_start
        self.num_cols = num_cols
        self.nnz = len(vals)
        self.rows = rows        # int32, panel-local row index (CSC order)
        self.counts = counts    # int32 (num_cols,) per-column nnz
        self.vals = vals        # float32

    def cols_expanded(self) -> np.ndarray:
        """Explicit per-entry column ids (host-side consumers only; the
        device path expands counts on device instead)."""
        return np.repeat(np.arange(self.num_cols, dtype=np.int32),
                         self.counts)


def _csc_to_coo_chunk(col_start: int, sub) -> SparseChunk:
    """scipy CSC panel -> SparseChunk (no dense materialization)."""
    counts = np.diff(sub.indptr).astype(np.int32)
    return SparseChunk(col_start, sub.shape[1],
                       np.asarray(sub.indices, dtype=np.int32), counts,
                       np.asarray(sub.data, dtype=np.float32))


class DataLoader:
    """Interface: chunk iteration over A and A^T panels (loader.hpp:60).

    Contract: chunk contents must be IDENTICAL across sweeps — consumers
    (nmf_chunked's panel residency cache, streaming SVD passes) may reuse
    a chunk read in an earlier sweep.  A loader over live/mutating data
    must be fit with ``panel_cache=False``."""

    shape: Tuple[int, int]

    def num_chunks(self, transpose: bool = False) -> int:
        raise NotImplementedError

    def chunk(self, idx: int, transpose: bool = False) -> Chunk:
        raise NotImplementedError

    #: loaders that can deliver COO panels without densifying set True
    supports_sparse: bool = False

    def chunk_coo(self, idx: int, transpose: bool = False) -> SparseChunk:
        raise NotImplementedError(
            f"{type(self).__name__} does not support sparse panels")

    def nnz(self) -> Optional[int]:
        """Total nonzeros when known (None for dense-only loaders)."""
        return None

    def iter_chunks(self, transpose: bool = False) -> Iterator[Chunk]:
        for c in range(self.num_chunks(transpose)):
            yield self.chunk(c, transpose)

    def trace_sq(self) -> float:
        """sum(A^2) accumulated chunk-wise."""
        total = 0.0
        for ch in self.iter_chunks():
            total += float((ch.data.astype(np.float64) ** 2).sum())
        return total


def auto_chunk_cols(m: int, budget_bytes: int = 256 << 20,
                    lo: int = 256, hi: int = 32768) -> int:
    """Panel width ~ a fixed device-transfer budget, clamped [256, 32768]
    (io/chunk_size.hpp semantics)."""
    cols = max(1, budget_bytes // max(4 * m, 1))
    return int(min(max(cols, lo), hi))


class InMemoryLoader(DataLoader):
    """Zero-copy panel views over an in-RAM matrix (io/in_memory.hpp:40)."""

    def __init__(self, A, chunk_cols: Optional[int] = None):
        self._sparse = hasattr(A, "tocsc")
        if self._sparse:
            self.A = A.tocsc()
            self.At = A.tocsr().T.tocsc()   # CSC of A^T
        else:
            self.A = np.asarray(A, dtype=np.float32)
            self.At = None
        self.shape = self.A.shape
        m, n = self.shape
        self.chunk_cols = chunk_cols or auto_chunk_cols(m)
        self.chunk_cols_t = chunk_cols or auto_chunk_cols(n)

    def num_chunks(self, transpose: bool = False) -> int:
        n = self.shape[0] if transpose else self.shape[1]
        cc = self.chunk_cols_t if transpose else self.chunk_cols
        return max(1, math.ceil(n / cc))

    def chunk(self, idx: int, transpose: bool = False) -> Chunk:
        cc = self.chunk_cols_t if transpose else self.chunk_cols
        start = idx * cc
        if transpose:
            stop = min(start + cc, self.shape[0])
            if self._sparse:
                block = np.asarray(self.At[:, start:stop].todense(),
                                   dtype=np.float32)
            else:
                block = np.ascontiguousarray(self.A[start:stop].T)
        else:
            stop = min(start + cc, self.shape[1])
            if self._sparse:
                block = np.asarray(self.A[:, start:stop].todense(),
                                   dtype=np.float32)
            else:
                block = self.A[:, start:stop]
        return Chunk(start, block)

    @property
    def supports_sparse(self) -> bool:       # type: ignore[override]
        return self._sparse

    def nnz(self) -> Optional[int]:
        return int(self.A.nnz) if self._sparse else None

    def chunk_coo(self, idx: int, transpose: bool = False) -> SparseChunk:
        if not self._sparse:
            raise NotImplementedError("dense in-memory data has no sparse "
                                      "panels")
        cc = self.chunk_cols_t if transpose else self.chunk_cols
        start = idx * cc
        src = self.At if transpose else self.A
        stop = min(start + cc, src.shape[1])
        return _csc_to_coo_chunk(start, src[:, start:stop])


class SpzLoader(DataLoader):
    """Chunk-at-a-time decode of a .spz file — v2 sparse or v3 dense panels
    (io/spz_loader.hpp:45, io/dense_spz_loader.hpp:40, version detection per
    fit_streaming_spz.hpp:66-93).

    Requires a transpose stream for W-updates, like the reference
    (fit_streaming_spz.hpp:94-101).
    """

    def __init__(self, path_or_bytes):
        from . import spz as spz_mod
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        self.version = spz_mod.spz_version_bytes(data)
        # whole-file CRC check ONCE at open (the per-chunk reads cannot be
        # individually checksummed — the format carries one footer CRC);
        # catches corrupt files up front instead of silently misdecoding
        # panels mid-fit (r5 fuzz campaign finding)
        if self.version in (2, 3):
            lib = spz_mod._load_lib()
            if lib.spz_verify(spz_mod._as_buf(data), len(data)):
                raise ValueError(
                    f"corrupt .spz: {spz_mod._err(lib)}")
        if self.version == 2:
            self.reader = spz_mod.SpzChunkReader(data)
            info = self.reader.info
            self.shape = (info["m"], info["n"])
            has_t = info["has_transpose"]
        elif self.version == 3:
            import ctypes
            self._data = data
            self._lib = spz_mod._load_lib()
            self._buf = spz_mod._as_buf(data)
            m = ctypes.c_uint32()
            n = ctypes.c_uint32()
            ht = ctypes.c_uint8()
            cd = ctypes.c_uint8()
            if self._lib.spz3_info(self._buf, len(data), ctypes.byref(m),
                                   ctypes.byref(n), ctypes.byref(ht),
                                   ctypes.byref(cd)):
                raise ValueError(spz_mod._err(self._lib))
            self.shape = (m.value, n.value)
            has_t = bool(ht.value)
        else:
            raise ValueError(f"unsupported spz version {self.version}")
        if not has_t:
            raise ValueError(
                "streaming NMF needs a transpose stream; re-write the .spz "
                "with with_transpose=True (st_add_transpose)")

    def num_chunks(self, transpose: bool = False) -> int:
        if self.version == 2:
            return self.reader.num_chunks(transpose)
        import ctypes
        out = ctypes.c_uint32()
        if self._lib.spz3_num_chunks(self._buf, len(self._data),
                                     int(transpose), ctypes.byref(out)):
            from . import spz as spz_mod
            # an unchecked failure here yields 0 chunks -> a silently
            # empty fit downstream
            raise ValueError(spz_mod._err(self._lib))
        return out.value

    def chunk(self, idx: int, transpose: bool = False) -> Chunk:
        if self.version == 2:
            col_start, sub = self.reader.chunk(idx, transpose)
            return Chunk(col_start, np.asarray(sub.todense(),
                                               dtype=np.float32))
        import ctypes
        cs = ctypes.c_uint32()
        nc = ctypes.c_uint32()
        if self._lib.spz3_decode_chunk(self._buf, len(self._data),
                                       int(transpose), idx, ctypes.byref(cs),
                                       ctypes.byref(nc), None):
            from . import spz as spz_mod
            raise ValueError(spz_mod._err(self._lib))
        nrows = self.shape[1] if transpose else self.shape[0]
        out = np.zeros(nrows * nc.value, dtype=np.float32)
        if self._lib.spz3_decode_chunk(
                self._buf, len(self._data), int(transpose), idx,
                ctypes.byref(cs), ctypes.byref(nc),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
            from . import spz as spz_mod
            # the size query above can succeed while the decode fails
            # (truncated payload); proceeding would factorize zeros
            raise ValueError(spz_mod._err(self._lib))
        return Chunk(cs.value, out.reshape((nc.value, nrows)).T)

    @property
    def supports_sparse(self) -> bool:       # type: ignore[override]
        return self.version == 2

    def nnz(self) -> Optional[int]:
        return int(self.reader.info["nnz"]) if self.version == 2 else None

    def chunk_coo(self, idx: int, transpose: bool = False) -> SparseChunk:
        if self.version != 2:
            raise NotImplementedError("v3 panels are dense")
        col_start, p, i, x = self.reader.chunk_arrays(idx, transpose)
        return SparseChunk(col_start, len(p) - 1, i,
                           np.diff(p).astype(np.int32), x)

    def trace_sq(self) -> float:
        """sum(A^2) straight off the value streams — no densification
        and no per-chunk scipy construction (chunk_arrays; csc_matrix
        validation is GIL-held pure-Python work — round-4 review)."""
        if self.version != 2:
            return super().trace_sq()
        total = 0.0
        for c in range(self.num_chunks(False)):
            x = self.reader.chunk_arrays(c, False)[3]
            total += float((x.astype(np.float64) ** 2).sum())
        return total


class CachingLoader(DataLoader):
    """In-RAM decoded-chunk cache wrapper (io/caching_loader.hpp:40)."""

    def __init__(self, inner: DataLoader, max_items: int = 64):
        import threading
        self.inner = inner
        self.shape = inner.shape
        self.max_items = max_items
        self._cache = {}
        # the Prefetcher runs up to depth concurrent workers; check/evict/
        # insert must be atomic or two workers can race the same eviction
        self._lock = threading.Lock()

    def num_chunks(self, transpose: bool = False) -> int:
        return self.inner.num_chunks(transpose)

    def chunk(self, idx: int, transpose: bool = False) -> Chunk:
        key = (idx, transpose)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        val = self.inner.chunk(idx, transpose)
        with self._lock:
            if key not in self._cache and len(self._cache) >= self.max_items:
                self._cache.pop(next(iter(self._cache)), None)
            return self._cache.setdefault(key, val)


class Prefetcher:
    """Background-thread panel pipelining (io/ping_pong_prefetch.hpp:37).

    Generalizes the reference's 2-slot ping-pong: ``depth`` chunks decode
    concurrently on a small worker pool while the current chunk computes
    on device — the native rANS decode releases the GIL, so workers
    genuinely overlap there; the Python-side panel prep does NOT, which
    is why the hot path avoids scipy object construction and column-id
    expansion entirely (chunk_arrays + counts).  ``transform`` runs IN THE
    WORKER on each decoded chunk (e.g. the streaming engine's wire
    compaction) so per-panel host prep leaves the consumer's critical
    path.  ``depth=0`` reads each chunk on the consumer's thread.

    Counted on the consumer's thread, over the chunks taken: ``decoded``,
    ``decode_s`` (the host seconds of each fetch, transform included,
    summed over the workers) and ``wait_s`` (the seconds the consumer was
    blocked on them, each wait a ``rtt.stream.wait`` span)."""

    def __init__(self, loader: DataLoader, transpose: bool,
                 sparse: bool = False, depth: Optional[int] = None,
                 transform=None):
        import os
        self.loader = loader
        self.transpose = transpose
        self.n = loader.num_chunks(transpose)
        fetch = loader.chunk_coo if sparse else loader.chunk
        if transform is not None:
            self._fetch = lambda c, t: transform(fetch(c, t))
        else:
            self._fetch = fetch
        if depth is None:
            depth = max(1, min(3, (os.cpu_count() or 2) - 1))
        self.depth = depth
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=depth) if depth > 0 else None)
        self.decoded = 0
        self.decode_s = 0.0
        self.wait_s = 0.0

    def _timed(self, c: int):
        t0 = time.perf_counter()
        out = self._fetch(c, self.transpose)
        return out, time.perf_counter() - t0

    def __iter__(self):
        if self.n == 0:
            return
        futs = {c: self._pool.submit(self._timed, c)
                for c in range(min(self.depth, self.n))}
        for c in range(self.n):
            t0 = time.perf_counter()
            with span("rtt.stream.wait"):
                chunk, decode_s = (futs.pop(c).result()
                                   if self._pool is not None
                                   else self._timed(c))
            self.wait_s += time.perf_counter() - t0
            self.decode_s += decode_s
            self.decoded += 1
            nxt = c + self.depth
            if self._pool is not None and nxt < self.n:
                futs[nxt] = self._pool.submit(self._timed, nxt)
            yield chunk

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
