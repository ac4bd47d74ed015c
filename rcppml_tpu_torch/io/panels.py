"""A stream's column panels, from the loader to dense float32 on the device.

The streaming NMF engine (``models/nmf_chunked.py``) reads every panel
through a :class:`PanelSource`: the choice of dense or compact COO panels
(:func:`_compact_sparse`, densified on the device by ``ops/coo_densify.py``),
the dense and wire caches, the ``Prefetcher``'s reads, the transposed panels
built on the device from the cached forward ones
(``ops/transpose_panels.py``), tr(A'A) for the MSE loss, a mesh rank's block
of each dense panel (``parallel/mesh.py``'s :class:`PanelBlocks`) and the
counters of ``res.misc["stream"]``.
"""

from __future__ import annotations

import time
from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from ..ops.coo_densify import coo_densify
from ..ops.transpose_panels import panel_table, transpose_panels
from ..parallel.mesh import PanelBlocks
from ..utils.trace import span
from .loaders import DataLoader, Prefetcher, SparseChunk
from .upload import STATIC_CACHE_BYTES, dense_cache_fits, device_bytes, upload


# a wire-ready sparse panel with compact dtypes, made off the consumer's
# critical path (in the Prefetcher's workers) by :func:`_compact_sparse`
_CompactChunk = namedtuple("_CompactChunk",
                           "col_start num_cols rows counts vals")
# a panel every copy of which a cache holds: its place only
_CachedChunk = namedtuple("_CachedChunk", "col_start num_cols")
# a transposed panel to build from the cached forward panels: its place only
_FromForward = namedtuple("_FromForward", "col_start num_cols")


def _compact_sparse(ch: SparseChunk, rows_dim: int) -> _CompactChunk:
    """SparseChunk -> wire format: uint16 rows when they fit, integral
    nonneg values in uint8 / uint16 (exact), per-column counts instead of
    explicit column ids.  Unlike the JAX package no bucket padding is added
    (it bounds XLA recompiles, which torch does not have)."""
    rows = ch.rows.astype(np.uint16) if rows_dim < (1 << 16) else \
        np.ascontiguousarray(ch.rows, dtype=np.int32)
    vals = np.ascontiguousarray(ch.vals, dtype=np.float32)
    # integral-nonneg-u16-range test in ONE cast+compare: a fractional,
    # negative, non-finite, or >= 2^16 float can never equal its own
    # uint16 cast (which wraps/truncates into [0, 65536))
    with np.errstate(invalid="ignore"):
        v16 = vals.astype(np.uint16)
    if np.array_equal(v16, vals):
        vals = v16.astype(np.uint8) if int(v16.max(initial=0)) < 256 \
            else v16
    return _CompactChunk(ch.col_start, ch.num_cols, rows,
                         np.ascontiguousarray(ch.counts, dtype=np.int32),
                         vals)


def _coo_wire_bytes(nnz: int, m: int, n: int) -> int:
    """The compact wire bytes of both panel sets of an (m, n) matrix with
    ``nnz`` entries, reckoned before any decode: each entry's row (2 bytes
    where the panel's rows fit uint16, else 4) and value (4 bytes, the worst
    case), and 4 bytes a column for its count."""
    def side(rows_dim: int, ncols: int) -> int:
        return nnz * ((2 if rows_dim < (1 << 16) else 4) + 4) + 4 * ncols
    return side(m, n) + side(n, m)


class PanelSource:
    """The forward and transposed panels of one stream's loader on ``dev``.

    ``panel_cache``: None (auto: the dense cache where both copies of this
    rank's blocks fit the card with headroom, else the wire cache for
    sparse panels, the compact arrays within 0.55 x the card's memory),
    True, ``"wire"`` or False; ``sparse_panels``: None (auto: without a
    mesh, COO panels where the loader has them and either the density is
    below 0.15 or the dense cache is on and the compact wire bytes,
    :func:`_coo_wire_bytes`, are below the dense panels'), True or False.
    ``reads_trace``: whether the fit's loss reads tr(A'A) (:attr:`trAtA`).
    ``stream``: the counters of ``res.misc["stream"]``.

    Once the dense cache holds every forward panel of a fit without a mesh,
    and the loader declares its transposed panels the forward panels'
    exact transposes (``DataLoader.exact_transpose``), the transposed
    panels are not read: each is built on the device from the forward
    panels (``transposed_on_card`` counts them), the same bits."""

    def __init__(self, loader: DataLoader, blocks: PanelBlocks,
                 dev: torch.device, *, panel_cache=None,
                 sparse_panels: Optional[bool] = None,
                 reads_trace: bool = False):
        self.loader, self.blocks, self.dev = loader, blocks, dev
        m, n = loader.shape
        self.rows_dim = {False: m, True: n}
        self.stream = {"decode_s": 0.0, "wait_s": 0.0, "panels_decoded": 0,
                       "upload_s": 0.0, "upload_bytes": 0, "densified": 0,
                       "panel_cache_hits": 0, "sweep_s": [],
                       "trace_passes": 0, "trace_panels": 0,
                       "transposed_on_card": 0}
        if panel_cache is None:
            # the footprint is this rank's: its blocks of both panel sets
            # (the JAX package's n_per); the gate reads the card's memory,
            # so the decision is rank 0's
            self.dense = blocks.ctx.share(
                dense_cache_fits(m, -(-n // blocks.size), dev))
        else:
            # the wire cache is gated below
            self.dense = panel_cache != "wire" and bool(panel_cache)
        if sparse_panels is None:
            # a mesh keeps dense panels (a block is cut from the dense
            # panel); past 0.15 the compact panels go only where the dense
            # cache keeps what the card densified, so a later sweep reads
            # the same panels
            nnz = loader.nnz() if loader.supports_sparse else None
            self.sparse = (not blocks.sharded and nnz is not None
                           and (nnz < 0.15 * m * n
                                or (self.dense and _coo_wire_bytes(nnz, m, n)
                                    < 2 * 4 * m * n)))
        else:
            self.sparse = bool(sparse_panels)
        # the wire cache (sparse ingest): the compact arrays of every panel
        # stay on the device from the first sweep, within a byte budget;
        # over budget the cache is dropped and the fit streams
        self.wire = (self.sparse and not self.dense
                     and panel_cache is not False)
        dev_bytes = device_bytes(dev)
        self.wire_budget = int(0.55 * dev_bytes) if dev_bytes > 0 else \
            STATIC_CACHE_BYTES
        self.wire_bytes = 0
        self._cache: dict = {}
        self._meta: dict = {False: {}, True: {}}   # col_start -> num_cols
        self._forward = None    # the forward panels' table, once built
        # tr(A'A): the first sweep's forward panels give it as they are
        # read (:meth:`panels`), unless this loader cannot give a panel's
        # part bit for bit in this ingest: then one pass over the file
        self.reads_trace = reads_trace
        self.trAtA = None
        if reads_trace and not loader.traces_panels(self.sparse):
            with span("rtt.stream.trace_sq"):
                self.trAtA = loader.trace_sq()
            self.stream["trace_passes"] = 1

    def full(self, transposed: bool) -> bool:
        """Whether a cache holds every panel of a side."""
        meta = self._meta[transposed]
        return bool((self.dense or self.wire) and meta and all(
            (transposed, cs) in self._cache for cs in meta))

    def wire_full(self) -> bool:
        """Whether the wire cache holds every panel of both sides."""
        return self.wire and self.full(False) and self.full(True)

    def panels(self, transposed: bool, prefetch: bool = True):
        """The panels of a side in order; once a cache holds every panel
        of the side, placeholders that :meth:`put` reads from it, and where
        the class's rule holds, transposed placeholders that it builds
        from the cached forward panels.  Without
        ``prefetch`` the panels are read on this thread.  The first read of
        the forward panels of a fit whose loss reads tr(A'A) takes it from
        them (the Prefetcher's ``traced``)."""
        meta = self._meta[transposed]
        if self.full(transposed):
            for cs in sorted(meta):
                yield _CachedChunk(cs, meta[cs])
            return
        if transposed and self.dense and not self.blocks.sharded \
                and self.full(False) and self.loader.exact_transpose():
            # the class's rule: build the transposed panels from the
            # cached forward ones
            if self._forward is None:
                fwd = sorted(self._meta[False])
                self._forward = panel_table(
                    [self._cache[(False, cs)] for cs in fwd], fwd)
            for c in range(self.loader.num_chunks(True)):
                cs, nc = self.loader.chunk_place(c, True)
                meta[cs] = nc
                yield _FromForward(cs, nc)
            return
        rows_dim = self.rows_dim[transposed]
        if self.sparse:
            def prep(ch):
                return _compact_sparse(ch, rows_dim)
        else:
            def prep(ch):
                ch.data = np.ascontiguousarray(ch.data, dtype=np.float32)
                return ch
        traced = self.reads_trace and self.trAtA is None and not transposed
        it = Prefetcher(self.loader, transpose=transposed, sparse=self.sparse,
                        transform=prep, depth=None if prefetch else 0,
                        traced=traced)
        st = self.stream
        try:
            for ch in it:
                meta[ch.col_start] = ch.num_cols
                yield ch
        finally:
            it.close()
            st["decode_s"] += it.decode_s
            st["wait_s"] += it.wait_s
            st["panels_decoded"] += it.decoded
            if traced and it.decoded == it.n:
                self.trAtA = it.trace_sq
                st["trace_panels"] = it.decoded

    def put(self, ch, transposed: bool, check_finite: bool = False):
        """One panel (this rank's block of it) on the device, dense float32
        (rows, cols): from a cache, built from the cached forward panels
        (a transposed panel), or uploaded (dense) / uploaded compact and
        densified there (sparse).  ``check_finite``: refuse a decoded
        panel with a non-finite value (streamed panels bypass the in-memory
        NaN auto-mask)."""
        cs, nc = ch.col_start, ch.num_cols
        if check_finite and not isinstance(ch, _CachedChunk) \
                and not _finite(ch):
            raise ValueError(
                f"non-finite values in columns {cs}..{cs + nc}; streaming "
                "cannot auto-mask NaN/Inf — clean the data or fit "
                "in-memory with mask=")
        key = (transposed, cs)
        rows_dim = self.rows_dim[transposed]
        hit = self._cache.get(key)
        if hit is not None:
            self.stream["panel_cache_hits"] += 1
            if self.dense:
                return hit
            self.stream["densified"] += 1                  # wire triple
            return coo_densify(*hit, rows_dim)
        if isinstance(ch, _FromForward):
            with span("rtt.stream.transpose"):
                out = transpose_panels(self._forward, cs, nc)
            self.stream["transposed_on_card"] += 1
        elif isinstance(ch, _CompactChunk):
            arrays = (ch.rows, ch.counts, ch.vals)
            on_dev = tuple(self._upload(x) for x in arrays)
            if self.wire:
                self.wire_bytes += sum(x.nbytes for x in arrays)
                if self.wire_bytes > self.wire_budget:
                    # over budget: drop the whole wire cache and stream
                    # with the strict O(panel) footprint from here on
                    self._cache.clear()
                    self.wire = False
                else:
                    self._cache[key] = on_dev
            self.stream["densified"] += 1
            out = coo_densify(*on_dev, rows_dim)
        else:
            out = self._upload(self.blocks.block_of(ch.data, nc, transposed))
        if self.dense:
            self._cache[key] = out
        return out

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        out = upload(x, self.dev)
        self.stream["upload_s"] += time.perf_counter() - t0
        self.stream["upload_bytes"] += x.nbytes
        return out


def _finite(ch) -> bool:
    vals = ch.vals if isinstance(ch, _CompactChunk) else ch.data
    if vals.dtype.kind == "u":      # compacted integral values
        return True
    return bool(np.isfinite(vals).all())
