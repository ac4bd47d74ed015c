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
streaming engine's panel source (``io/panels.py``) uploads them.
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

    def traces_panels(self, sparse: bool) -> bool:
        """Whether ``chunk_traced`` gives each forward panel of this ingest
        (COO where ``sparse``) with its part of ``trace_sq()``.  Here: the
        dense panels, which the default ``trace_sq`` itself sums; a loader
        that overrides ``trace_sq`` says for itself."""
        return not sparse and type(self).trace_sq is DataLoader.trace_sq

    def chunk_traced(self, idx: int, sparse: bool = False):
        """(forward panel ``idx`` as ``chunk`` gives it, its part of
        ``trace_sq()``), where ``traces_panels(sparse)``: the parts of
        panels 0, 1, ... added in that order to 0.0 are ``trace_sq()`` bit
        for bit."""
        ch = self.chunk(idx)
        return ch, _sq_sum(ch.data)

    def exact_transpose(self) -> bool:
        """Whether every transposed panel holds, value for value, A's
        entries as the forward panels hold them (so a transposed panel may
        be built from the forward ones).  Here: not declared."""
        return False

    def chunk_place(self, idx: int, transpose: bool = False):
        """(col_start, num_cols) of panel ``idx``; here by reading it, a
        loader that can tell without a decode says so itself."""
        ch = self.chunk(idx, transpose)
        return ch.col_start, ch.num_cols


def _sq_sum(x: np.ndarray) -> float:
    """A panel's part of tr(A'A), as ``trace_sq`` computes it."""
    return float((x.astype(np.float64) ** 2).sum())


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

    def exact_transpose(self) -> bool:
        # both sides read one float32 array, or one scipy matrix whose
        # entries are unique (duplicates would be summed per side)
        return not self._sparse or bool(self.A.has_canonical_format)

    def chunk_place(self, idx: int, transpose: bool = False):
        cc = self.chunk_cols_t if transpose else self.chunk_cols
        start = idx * cc
        n = self.shape[0] if transpose else self.shape[1]
        return start, min(cc, n - start)


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

    def _dense_v2(self, col_start, p, i, x, transpose: bool) -> Chunk:
        import scipy.sparse as sp
        rows = self.shape[1] if transpose else self.shape[0]
        sub = sp.csc_matrix((x, i, p), shape=(rows, len(p) - 1))
        return Chunk(col_start, np.asarray(sub.todense(), dtype=np.float32))

    def chunk(self, idx: int, transpose: bool = False) -> Chunk:
        if self.version == 2:
            return self._dense_v2(*self.reader.chunk_arrays(idx, transpose),
                                  transpose)
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

    def traces_panels(self, sparse: bool) -> bool:
        # v2: the value stream under either ingest; v3: the dense panels
        return self.version == 2 or not sparse

    def exact_transpose(self) -> bool:
        # every codec but quant8 (an offset and scale set per chunk, so the
        # two streams round apart) stores each value as itself
        return self.version == 3 or \
            self.reader.info["value_type"] != "quant8"

    def chunk_place(self, idx: int, transpose: bool = False):
        """From the chunk's header (v2) or the decoder's size query (v3):
        no decode."""
        if self.version == 2:
            return self.reader.chunk_info(idx, transpose)[:2]
        import ctypes
        cs = ctypes.c_uint32()
        nc = ctypes.c_uint32()
        if self._lib.spz3_decode_chunk(self._buf, len(self._data),
                                       int(transpose), idx, ctypes.byref(cs),
                                       ctypes.byref(nc), None):
            from . import spz as spz_mod
            raise ValueError(spz_mod._err(self._lib))
        return cs.value, nc.value

    def chunk_traced(self, idx: int, sparse: bool = False):
        """v2: one decode gives the panel (COO, or densified as ``chunk``
        densifies it) and the sum of its squared values, as ``trace_sq``
        sums them."""
        if self.version != 2:
            return super().chunk_traced(idx, sparse)
        if sparse:
            ch = self.chunk_coo(idx)
            return ch, _sq_sum(ch.vals)
        col_start, p, i, x = self.reader.chunk_arrays(idx, False)
        return self._dense_v2(col_start, p, i, x, False), _sq_sum(x)

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

    def exact_transpose(self) -> bool:
        return self.inner.exact_transpose()

    def chunk_place(self, idx: int, transpose: bool = False):
        return self.inner.chunk_place(idx, transpose)

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
    expansion entirely (chunk_arrays + counts).  A worker runs, for each
    chunk: the loader's read (``chunk``, or ``chunk_coo`` where
    ``sparse``); with ``traced`` (forward panels of a loader whose
    ``traces_panels(sparse)`` holds) the read is ``chunk_traced``, which
    also sums the panel's squares as read; then ``transform`` (e.g. the
    streaming engine's wire compaction), so per-panel host prep leaves the
    consumer's critical path.  ``depth=0`` reads each chunk on the
    consumer's thread.

    Counted on the consumer's thread, over the chunks taken: ``decoded``,
    ``decode_s`` (the host seconds of each fetch, transform included,
    summed over the workers) and ``wait_s`` (the seconds the consumer was
    blocked on them, each wait a ``rtt.stream.wait`` span); with ``traced``,
    ``trace_sq`` (the panels' parts of ``loader.trace_sq()`` added in panel
    order: once every panel is taken, that value bit for bit)."""

    def __init__(self, loader: DataLoader, transpose: bool,
                 sparse: bool = False, depth: Optional[int] = None,
                 transform=None, traced: bool = False):
        import os
        self.loader = loader
        self.transpose = transpose
        self.n = loader.num_chunks(transpose)
        read = loader.chunk_coo if sparse else loader.chunk
        prep = transform or (lambda ch: ch)

        def fetch(c, t):
            ch, part = (loader.chunk_traced(c, sparse) if traced
                        else (read(c, t), None))
            return prep(ch), part
        self._fetch = fetch
        if depth is None:
            depth = max(1, min(3, (os.cpu_count() or 2) - 1))
        self.depth = depth
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=depth) if depth > 0 else None)
        self.decoded = 0
        self.decode_s = 0.0
        self.wait_s = 0.0
        self.trace_sq = 0.0 if traced else None

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
                (chunk, part), decode_s = (futs.pop(c).result()
                                           if self._pool is not None
                                           else self._timed(c))
            self.wait_s += time.perf_counter() - t0
            self.decode_s += decode_s
            self.decoded += 1
            if part is not None:
                self.trace_sq += part
            nxt = c + self.depth
            if self._pool is not None and nxt < self.n:
                futs[nxt] = self._pool.submit(self._timed, nxt)
            yield chunk

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
