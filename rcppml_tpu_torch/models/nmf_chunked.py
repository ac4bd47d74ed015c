"""Chunked / streaming NMF: larger-than-memory ALS over a DataLoader.

The port of ``rcppml_tpu/models/nmf_chunked.py`` (``nmf/fit_chunked.hpp:
71+`` and the streaming entry ``nmf/fit_streaming_spz.hpp:54-223``):

  per sweep:
    gram(W_T) once (k x k)  ->  forward column panels: per-panel RHS +
    solve for the H panel (the Prefetcher overlaps host decode with device
    compute)  ->  gram(H)  ->  transpose panels: per-panel W_T updates  ->
    scaling  ->  loss accumulated panel by panel, in panel order.

Memory on the device: O(m k + n k + panel), unless a panel cache holds the
matrix there (``panel_cache``): the dense cache keeps every uploaded panel
when forward and transpose copies fit the card's memory with headroom; the
wire cache keeps the compact COO arrays of sparse panels (a byte budget of
0.55 x the card's memory) and densifies them per use.  ``panel_cache=False``
keeps the strict O(panel) footprint.

Each panel solve is one of the port's batched solvers: the shared-Gram
Cholesky solve + clip (kernel 6 on the card) or CD NNLS (kernel 1) for the
MSE panels; ``nmf_cv.masked_mse_solve_batch`` (kernel 2 with ``solver="cd"``,
kernel 5 where k^2 m exceeds ``KR_BUDGET_FLOATS``) for the CV and masked
panels; ``nmf_irls.irls_solve_batch`` (kernel 2, kernel 4 under
``RCPPML_FUSED_WGRAM``) for the IRLS panels.

Sparse panels travel as compact COO (uint16 rows when the panel's rows fit,
uint8 / uint16 values when they are integral, per-column counts) and are
densified on the device by ``ops/coo_densify.py`` (its CUDA kernel on the
card, its plain twin on the CPU), which writes the ``nnz`` real entries and
zeros everywhere else.  No padding is shipped, so no index falls outside the
panel; canonical CSC holds each (row, column) once, so the densify is exact
and a sparse-panel fit is bit for bit the dense-panel one.  A loader that
has COO panels ships them (without a mesh) where the density is below 0.15,
or where the dense panel cache is on and the compact wire bytes, reckoned
before any decode (:func:`_coo_wire_bytes`), are below the dense panels'
bytes: the host then decodes to COO and never densifies or pins a dense
panel, and the cache keeps the panel the card densified once.

Where the JAX package runs a whole cached sweep as one jitted ``lax.scan``
(``_cached_sweep_{mse,cv,irls}``), the port's sweep over a full cache is
the same per-panel loop reading the cached panels, in the same order; a
plain MSE sweep over a full wire cache takes its loss from the matrices the
W update saved (``mse_loss_from_saved``) instead of densifying the forward
panels a third time, as the JAX package's cached sweep does.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Union

import numpy as np
import torch

from .. import rng as rng_mod
from ..config import ZI, Dispersion, Loss, NMFConfig, Solver
from ..device import set_fp32_precision
from ..io.loaders import DataLoader, Prefetcher, SparseChunk, SpzLoader
from ..io.upload import (STATIC_CACHE_BYTES, dense_cache_fits, device_bytes,
                         upload)
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..ops.coo_densify import coo_densify
from ..parallel.mesh import NO_AXIS
from ..result import NMFResult
from ..utils.trace import Syncs, span, spans
from .nmf import fit_device, init_factors

# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

class _CompactChunk:
    """Wire-ready sparse panel with compact dtypes, produced off the
    consumer's critical path (in the Prefetcher worker) by
    :func:`_compact_sparse`."""

    __slots__ = ("col_start", "num_cols", "rows", "counts", "vals")

    def __init__(self, col_start, num_cols, rows, counts, vals):
        self.col_start = col_start
        self.num_cols = num_cols
        self.rows = rows
        self.counts = counts
        self.vals = vals


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


# ---------------------------------------------------------------------------
# Panel solves (one column panel each)
# ---------------------------------------------------------------------------

def _warm(X_warm: torch.Tensor, it: int) -> torch.Tensor:
    """The warm start: the previous factor panel after the first sweep,
    zeros in it (the reference's ``iter > 0``)."""
    return X_warm * float(it > 0)


def _solve_from_B(cfg: NMFConfig, side: str, G, B, X_warm, it: int):
    """The feature + solve tail of a shared-Gram panel solve, B = F @ A
    already formed: the Cholesky solve + clip (kernel 6 on the card) or CD
    NNLS (kernel 1)."""
    fc = cfg.H if side == "H" else cfg.W
    if fc.L1 > 0:
        B = B - fc.L1
    if cfg.solver == Solver.CHOLESKY:
        X = solvers.cholesky_clip_batch(G, B, nonneg=fc.nonneg)
    else:
        X0 = _warm(X_warm, it)
        B_res = B - G @ X0
        X = solvers.cd_nnls_batch_traced(G, B_res, X0, 0.0, nonneg=fc.nonneg,
                                         maxit=cfg.cd_max_iter,
                                         cd_tol=cfg.cd_tol)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


def _panel_train_w(seed: int, col0: int, A_panel, inv_prob: int,
                   mask_zeros: bool, transposed: bool, user_m=None,
                   row0: int = 0):
    """Speckled train weights of a panel whose element (r, c) is
    A[row0 + r, col0 + c] (or A[col0 + c, row0 + r] when ``transposed``:
    the W update's A^T panels), from the same position hash as the
    in-memory path, computed on the panel's device.  ``user_m``: an
    optional panel-aligned bool mask of entries held out besides.
    ``row0``: the first row of a mesh rank's block of the panel."""
    rows, cols = A_panel.shape
    if inv_prob > 0:
        if transposed:
            M = rng_mod.is_holdout(seed, cols, rows, inv_prob,
                                   A_panel.device, row0=col0, col0=row0).T
        else:
            M = rng_mod.is_holdout(seed, rows, cols, inv_prob,
                                   A_panel.device, row0=row0, col0=col0)
        if mask_zeros:
            M = M & (A_panel != 0)
    else:
        M = torch.zeros(A_panel.shape, dtype=torch.bool,
                        device=A_panel.device)
    if user_m is not None:
        M = M | user_m
    return (~M).to(A_panel.dtype).contiguous()


def _panel_solve_cv(cfg: NMFConfig, side: str, F, A_panel, X_warm, it: int,
                    seed: int, col0: int, user_m, G_add, *, inv_prob: int,
                    mask_zeros: bool, transposed: bool, row0: int = 0,
                    axis=NO_AXIS):
    """Masked panel solve: per-column Grams over the train entries only
    (fit_streaming_spz.hpp:267-286), through
    ``nmf_cv.masked_mse_solve_batch``.  ``G_add``: the shared tier-2 k x k
    term (L21).  ``row0`` / ``axis``: a mesh rank's block of the panel
    starts at row ``row0``, and its per-column Grams are summed over
    ``axis`` (the ranks holding the panel's other rows)."""
    from .nmf_cv import masked_mse_solve_batch
    fc = cfg.H if side == "H" else cfg.W
    train_w = _panel_train_w(seed, col0, A_panel, inv_prob, mask_zeros,
                             transposed, user_m, row0)
    X = masked_mse_solve_batch(A_panel, F, train_w, cfg, fc,
                               _warm(X_warm, it), G_add=G_add, axis=axis)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


def _panel_valid(shape, valid_rc, device):
    """The (rows, cols) float32 validity of a mesh rank's zero-padded
    block of a panel whose true part is its top-left ``valid_rc`` corner:
    the pads leave every loss and statistic (JAX ``_panel_valid``).  None
    where nothing is padded."""
    if valid_rc is None or tuple(valid_rc) == tuple(shape):
        return None
    vr, vc = valid_rc
    return ((torch.arange(shape[0], device=device) < vr)[:, None]
            & (torch.arange(shape[1], device=device) < vc)[None, :]).to(
                torch.float32)


def _panel_cv_losses(cfg: NMFConfig, W_T, d, H_panel, A_panel, seed: int,
                     col0: int, theta_row, theta_col, user_m, *,
                     inv_prob: int, mask_zeros: bool, row0: int = 0,
                     valid_rc=None):
    """(train_loss_sum, n_train, test_loss_sum, n_test) of one forward
    panel, as one (4,) tensor: the distribution-aware per-entry losses of
    the in-memory CV accounting.  ``row0`` / ``valid_rc``: a mesh rank's
    block of the panel, its first row and its valid extent."""
    rec = (W_T * d[:, None]).T @ H_panel
    theta = losses._expand_theta(theta_row, theta_col, A_panel)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    train_w = _panel_train_w(seed, col0, A_panel, inv_prob, mask_zeros,
                             False, user_m, row0)
    test_w = 1.0 - train_w
    v = _panel_valid(A_panel.shape, valid_rc, A_panel.device)
    if v is not None:
        train_w = train_w * v
        test_w = test_w * v
    if user_m is not None and inv_prob > 0:
        # CV + user mask: user-masked entries leave BOTH statistics; the
        # test statistic stays a pure speckled-holdout quantity
        # (fit_cv.hpp:1391-1393).  For a pure masked fit the masked
        # entries themselves are the reported held-out set.
        test_w = test_w * (1.0 - user_m.to(test_w.dtype))
    return torch.stack([(sq * train_w).sum(), train_w.sum(),
                        (sq * test_w).sum(), test_w.sum()])


def _panel_solve_irls(cfg: NMFConfig, side: str, F, A_panel, X_warm,
                      it: int, th_row, th_col, seed: int, col0: int,
                      user_m, G_add, *, active_loss: Loss, inv_prob: int,
                      mask_zeros: bool, transposed: bool, counts=None,
                      row0: int = 0, axis=NO_AXIS):
    """IRLS panel solve with fixed dispersion: the reference's chunked
    engine never re-estimates nb_size / theta in streaming mode
    (fit_chunked.hpp:165-172,300-318) and maps GP -> KL.  With ``inv_prob``
    > 0 or a user mask, the train weights join the IRLS weights.
    ``counts``: a dict whose ``inner_iters`` / ``host_syncs`` the solve
    increases.  ``row0`` / ``axis`` as for :func:`_panel_solve_cv`."""
    from .nmf_irls import irls_solve_batch
    fc = cfg.H if side == "H" else cfg.W
    extra_w = None
    if inv_prob > 0 or user_m is not None:
        extra_w = _panel_train_w(seed, col0, A_panel, inv_prob, mask_zeros,
                                 transposed, user_m, row0)
    X = irls_solve_batch(A_panel, F, cfg, active_loss, th_row, th_col, fc,
                         False, extra_w=extra_w, X_warm=_warm(X_warm, it),
                         G_add=G_add, counts=counts, axis=axis)
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    return X


def _panel_irls_loss(cfg: NMFConfig, W_T, d, H_panel, A_panel, theta_row,
                     theta_col, valid_rc=None):
    """Per-entry NLL / deviance summed over one forward panel
    (fit_chunked.hpp:335-390), a 0-d tensor; over its valid extent
    ``valid_rc`` only, for a mesh rank's zero-padded block."""
    rec = (W_T * d[:, None]).T @ H_panel
    theta = losses._expand_theta(theta_row, theta_col, A_panel)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    v = _panel_valid(A_panel.shape, valid_rc, A_panel.device)
    return (sq if v is None else sq * v).sum()


def _zi_prob(S, pi_b, r_b):
    """z = pi / (pi + (1 - pi) p0), p0 = (r / (r + S))^r: the NB E-step's
    posterior that a zero is a dropout."""
    p0 = (r_b / (r_b + S)) ** r_b
    return pi_b / (pi_b + (1.0 - pi_b) * p0 + 1e-30)


def _panel_zi_impute(F, d, X_warm, A_panel, pi_b, r_b):
    """NB soft imputation of one panel's zeros (the streaming analog of
    nmf_irls.zi_em_step's M-side output; fit_cpu.hpp:1285-1552): zero
    entries become z * S with S = (F d)^T X_warm."""
    S = torch.clamp_min((F * d[:, None]).T @ X_warm, 1e-10)
    return torch.where(A_panel == 0, _zi_prob(S, pi_b, r_b) * S, A_panel)


def _panel_irls_loss_zi(cfg: NMFConfig, W_T, d, H_panel, A_panel,
                        theta_row, theta_col, pi_b, r_b, valid_rc=None):
    """Loss + ZI E-step statistics of one forward panel from ONE
    reconstruction: (loss, z row sums, z column sums, zero row counts,
    zero column counts), accumulated across panels for one pi EM update
    per sweep.  ``valid_rc``: a mesh rank's block's valid extent; its pads
    are synthetic zeros and leave the loss and the dropout statistics."""
    rec = (W_T * d[:, None]).T @ H_panel
    theta = losses._expand_theta(theta_row, theta_col, A_panel)
    sq = losses.compute_loss_elements(A_panel, rec, cfg, theta)
    is_zero = A_panel == 0
    v = _panel_valid(A_panel.shape, valid_rc, A_panel.device)
    if v is not None:
        sq = sq * v
        is_zero = is_zero & (v > 0)
    z = torch.where(is_zero, _zi_prob(torch.clamp_min(rec, 1e-10), pi_b, r_b),
                    torch.zeros((), dtype=rec.dtype, device=rec.device))
    return (sq.sum(), z.sum(dim=1), z.sum(dim=0), is_zero.sum(dim=1),
            is_zero.sum(dim=0))


def _panel_cross_term(W_T, d, H_panel, A_panel):
    """Panel contribution to the loss cross term: sum d_i <W_T A_panel, H>."""
    B = W_T @ A_panel                                   # (k, pc)
    return (d[:, None] * B * H_panel).sum()


# ---------------------------------------------------------------------------
# The streaming fit
# ---------------------------------------------------------------------------

def _dense_graph(L, dev, syncs: Syncs):
    if L is None:
        return None
    return syncs.to(torch.from_numpy(np.array(
        L.todense() if hasattr(L, "todense") else L, np.float32,
        order="C")), dev)


def nmf_chunked(loader: Union[DataLoader, str], cfg: NMFConfig, *,
                w_init=None, h_init=None, mask=None, graph_W=None,
                graph_H=None, mesh=None, on_iteration=None,
                checkpoint_path=None, checkpoint_every: int = 1,
                panel_cache=None, sparse_panels: Optional[bool] = None,
                device=None) -> NMFResult:
    """Streaming ALS over a DataLoader or ``.spz`` path
    (nmf/fit_chunked.hpp:71).

    ``mask``: optional (m, n) bool, True = held out of training.
    ``graph_W``/``graph_H``: Laplacians for graph regularization (they
    modify only the k x k Gram).  ``on_iteration(sweep, train_loss,
    test_loss)``: called after every sweep.  ``checkpoint_path``: the loop
    state is atomically saved every ``checkpoint_every`` sweeps and resumed
    bit-exactly when the file exists (``utils/checkpoint.py``'s stream
    state, shared with the JAX package).  ``panel_cache``: None (auto: the
    dense cache where both copies fit the card with headroom, else the wire
    cache for sparse panels), True (dense cache), ``"wire"`` (wire cache)
    or False (neither).  ``sparse_panels``: None (auto: without a mesh, COO
    panels where the loader has them and either the density is below 0.15
    or the dense cache is on and the compact wire bytes are below the dense
    panels'), True or False.
    ``device``: where the fit runs, the CUDA card by default (without a card
    that raises; pass ``device="cpu"`` for the CPU).

    Counters, on every fit: ``res.misc["stream"]`` holds ``decode_s`` (host
    seconds of the panel reads and their preparation, summed over the
    Prefetcher's workers), ``wait_s`` (the seconds this thread waited on
    them), ``panels_decoded``, ``upload_s`` and ``upload_bytes`` (the
    panels' copies to the device: host seconds and bytes), ``densified``
    (the panels densified from COO on the device), ``panel_cache_hits``,
    ``sweep_s`` (wall seconds per sweep), ``trace_passes`` (whole-file
    passes for tr(A'A), 0 or 1: the plain MSE loss reads it, and the pass
    runs only where the loader cannot give a panel's part as the first
    sweep reads it, ``DataLoader.traces_panels``), ``trace_panels`` (the
    forward panels whose parts gave it, in the Prefetcher's workers) and,
    for an IRLS fit, ``inner_iters`` of its panel solves.
    ``res.misc["host_syncs"]`` counts the fit's synchronizing calls
    (``utils.trace.Syncs``; not the checkpoint's reads, a seeding SVD's or
    a mesh's collectives).  Under a profiler the fit opens
    ``rtt.stream.trace_sq`` (the loader's pass for tr(A'A), where
    ``trace_passes`` is 1), ``rtt.loop``
    around its sweeps, ``rtt.stream.sweep`` for each, ``rtt.stream.panel``
    for each panel's put and solve, ``rtt.stream.wait`` where it waits on a
    decode, ``rtt.stream.upload``, ``rtt.stream.loss`` and
    ``rtt.fit.finalize`` (``utils/trace.py``).

    ``mesh``: a ``parallel.mesh.Mesh`` every rank of which calls this
    alike, each with its own loader of the same data: sharded streaming
    (the JAX package's ``nmf_chunked(mesh=)``).  Each panel is zero-padded
    and split (rows, cols) over the mesh, each transposed panel (cols,
    rows); a rank reads whole panels and uploads only its block.  The factor
    tables stay whole on every rank.  A panel's right-hand side (and, for
    CV, masked and IRLS solves, its per-column Grams) is this rank's part
    summed over the ranks holding the panel's other rows; each rank solves
    its columns of the panel (kernels 6, 1 or 2) and the solved slices are
    gathered over the other axis.  Pads carry zero weight in every loss
    and in the ZI statistics.  Dense panels only (``sparse_panels=True``
    raises), no cached-sweep fast path, and every host decision (the
    panel cache's gate, the stop) is rank 0's, shared with every rank."""
    if isinstance(loader, (str, bytes)):
        loader = SpzLoader(loader)
    m, n = loader.shape
    k = cfg.rank
    cfg.validate()
    if cfg.fused_vmem:
        raise ValueError("fused_vmem pins the WHOLE matrix in VMEM — "
                         "incompatible with the chunked/streaming engine")
    if cfg.bf16_data:
        raise ValueError("bf16_data is not supported on the streaming "
                         "path; use the in-memory fit")
    use_irls = cfg.requires_irls()
    if cfg.symmetric:
        raise NotImplementedError(
            "symmetric NMF needs the full square matrix; use the in-memory "
            "path")
    if (graph_W is not None or graph_H is not None) and \
            (cfg.is_cv() or mask is not None or use_irls):
        raise NotImplementedError(
            "streaming graph regularization requires the shared-Gram MSE "
            "path (no CV/mask/IRLS), like the reference chunked engine")
    if use_irls and cfg.has_zi() and (cfg.loss != Loss.NB or cfg.is_cv()
                                      or mask is not None or cfg.mask_zeros):
        # NB+ZI streams (panel-local E-step); GP-family ZI needs the
        # per-iteration theta the chunked engine freezes, and ZI with CV /
        # mask / mask_zeros needs the full matrix (the reference chunked
        # engine has no ZI branch at all, fit_chunked.hpp)
        raise NotImplementedError(
            "streaming zero-inflation supports loss='nb' without "
            "CV/mask/mask_zeros; use the in-memory path otherwise")
    if sparse_panels and mesh is not None:
        raise ValueError("sparse_panels is incompatible with mesh= "
                         "(sharded streams ship dense panels)")
    if sparse_panels and not loader.supports_sparse:
        raise ValueError(
            f"{type(loader).__name__} cannot deliver sparse panels")
    if checkpoint_path is not None and int(checkpoint_every) < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if mask is not None:
        if hasattr(mask, "todense"):
            mask = np.asarray(mask.todense())
        elif isinstance(mask, torch.Tensor):
            mask = mask.detach().cpu().numpy()
        mask = np.asarray(mask).astype(bool)
        if mask.shape != (m, n):
            raise ValueError(f"mask shape {mask.shape} != data {(m, n)}")
    # everything that needs no device is checked by now
    ctx = None
    if mesh is not None:
        from ..parallel.mesh import ShardContext, rank_device
        dev = rank_device(mesh, device)
        ctx = ShardContext(mesh, m, n)
    else:
        dev = fit_device(loader, device)
    set_fp32_precision()
    dev_bytes = device_bytes(dev)
    syncs = Syncs()
    stream = {"decode_s": 0.0, "wait_s": 0.0, "panels_decoded": 0,
              "upload_s": 0.0, "upload_bytes": 0, "densified": 0,
              "panel_cache_hits": 0, "sweep_s": [], "trace_passes": 0,
              "trace_panels": 0}
    irls_counts = {"inner_iters": 0, "host_syncs": 0}

    # ---- panel residency caches ----
    if panel_cache is None:
        # the footprint is this rank's: its blocks of both panel sets
        # (the JAX package's n_per); the gate reads free memory, so the
        # decision is rank 0's
        n_per = n if ctx is None else -(-n // mesh.size)
        _cache_panels = dense_cache_fits(m, n_per, dev)
        if ctx is not None:
            _cache_panels = ctx.share(_cache_panels)
    elif panel_cache == "wire":
        _cache_panels = False           # wire cache gated below
    else:
        _cache_panels = bool(panel_cache)
    _panel_cache: dict = {}
    _panel_meta: dict = {False: {}, True: {}}   # col_start -> num_cols

    # ---- nnz-proportional ingest (sparse device panels) ----
    if sparse_panels is None:
        # a mesh keeps dense panels (a block is cut from the dense panel);
        # past 0.15 the compact panels go only where the dense cache keeps
        # what the card densified, so a later sweep reads the same panels
        _nnz = loader.nnz() if loader.supports_sparse else None
        _sparse_mode = (mesh is None and _nnz is not None
                        and (_nnz < 0.15 * m * n
                             or (_cache_panels and _coo_wire_bytes(_nnz, m, n)
                                 < 2 * 4 * m * n)))
    else:
        _sparse_mode = bool(sparse_panels)

    # ---- wire-resident panel cache (sparse mode): the compact arrays of
    # every panel stay on the device from the first sweep, within a byte
    # budget; over budget the cache is dropped and the fit streams ----
    _wire_cache = (_sparse_mode and not _cache_panels
                   and panel_cache is not False)
    _wire_budget = int(0.55 * dev_bytes) if dev_bytes > 0 else \
        STATIC_CACHE_BYTES
    _wire_bytes = 0

    class _CachedChunk:
        __slots__ = ("col_start", "num_cols")

        def __init__(self, cs, nc):
            self.col_start = cs
            self.num_cols = nc

    def _cache_full(transposed: bool) -> bool:
        meta = _panel_meta[transposed]
        return bool((_cache_panels or _wire_cache) and meta and all(
            (transposed, cs) in _panel_cache for cs in meta))

    def _panels(transposed: bool, prefetch: bool = True):
        """Iterate panels; once a cache holds every panel of a side, yield
        metadata-only chunks so later sweeps skip the host decode.  The
        first read of the forward panels of a fit whose loss reads tr(A'A)
        takes it from them (the Prefetcher's ``traced``)."""
        nonlocal trAtA
        meta = _panel_meta[transposed]
        if _cache_full(transposed):
            for cs in sorted(meta):
                yield _CachedChunk(cs, meta[cs])
            return
        rows_dim = n if transposed else m
        if _sparse_mode:
            def prep(ch):
                return _compact_sparse(ch, rows_dim)
        else:
            def prep(ch):
                ch.data = np.ascontiguousarray(ch.data, dtype=np.float32)
                return ch
        traced = reads_trace and trAtA is None and not transposed
        # without prefetch the panels are read on this thread
        it = Prefetcher(loader, transpose=transposed, sparse=_sparse_mode,
                        transform=prep, depth=None if prefetch else 0,
                        traced=traced)
        try:
            for ch in it:
                meta[ch.col_start] = ch.num_cols
                yield ch
        finally:
            it.close()
            stream["decode_s"] += it.decode_s
            stream["wait_s"] += it.wait_s
            stream["panels_decoded"] += it.decoded
            if traced and it.decoded == it.n:
                trAtA = it.trace_sq
                stream["trace_panels"] = it.decoded

    def _chunk_finite(ch) -> bool:
        vals = ch.vals if isinstance(ch, _CompactChunk) else ch.data
        if vals.dtype.kind == "u":      # compacted integral values
            return True
        return bool(np.isfinite(vals).all())

    def _put_panel(ch, transposed: bool) -> torch.Tensor:
        """One panel on the device, dense float32 (rows, cols): from a
        cache, or uploaded (dense) / uploaded compact and densified there
        (sparse)."""
        nonlocal _wire_cache, _wire_bytes
        key = (transposed, ch.col_start)
        rows_dim = n if transposed else m
        hit = _panel_cache.get(key)
        if hit is not None:
            stream["panel_cache_hits"] += 1
            if _cache_panels:
                return hit
            stream["densified"] += 1                       # wire triple
            return coo_densify(*hit, rows_dim)
        if ctx is not None:
            out = _upload(_block_of(ch.data, ch.num_cols, transposed))
        elif isinstance(ch, _CompactChunk):
            rows_d, counts_d, vals_d = (_upload(x) for x
                                        in (ch.rows, ch.counts, ch.vals))
            if _wire_cache:
                _wire_bytes += (ch.rows.nbytes + ch.counts.nbytes
                                + ch.vals.nbytes)
                if _wire_bytes > _wire_budget:
                    # over budget: drop the whole wire cache and stream
                    # with the strict O(panel) footprint from here on
                    _panel_cache.clear()
                    _wire_cache = False
                else:
                    _panel_cache[key] = (rows_d, counts_d, vals_d)
            stream["densified"] += 1
            out = coo_densify(rows_d, counts_d, vals_d, rows_dim)
        else:
            out = _upload(ch.data)
        if _cache_panels:
            _panel_cache[key] = out
        return out

    def _upload(x: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        out = upload(x, dev)
        stream["upload_s"] += time.perf_counter() - t0
        stream["upload_bytes"] += x.nbytes
        return out

    def _tensor(x):
        return syncs.to(torch.from_numpy(np.array(x, np.float32, order="C")),
                        dev)

    # ---- a mesh rank's block of each panel ----
    def _rows_geom(transposed: bool):
        """(first row, block rows, valid rows) of this rank's block of a
        panel: the forward panels' rows are A's rows, split over the
        mesh's rows; the transposed panels' rows are A's columns, split
        over its columns."""
        if transposed:
            return ctx.col0, ctx.n_blk, ctx.vn
        return ctx.row0, ctx.m_blk, ctx.vm

    def _cols_geom(nc: int, transposed: bool):
        """(first column, block columns, valid columns) of this rank's
        block of a panel of ``nc`` columns, zero-padded to divide the axis
        it is split over ("cols" forward, "rows" transposed)."""
        ri, ci = mesh.coords
        parts, idx = ((mesh.shape["rows"], ri) if transposed
                      else (mesh.shape["cols"], ci))
        pb = -(-nc // parts)
        c0 = idx * pb
        return c0, pb, min(max(nc - c0, 0), pb)

    def _block_of(data, nc: int, transposed: bool) -> np.ndarray:
        """This rank's zero-padded block of a whole host panel."""
        r0, rb, vr = _rows_geom(transposed)
        c0, pb, vc = _cols_geom(nc, transposed)
        out = np.zeros((rb, pb), np.float32)
        out[:vr, :vc] = data[r0:r0 + vr, c0:c0 + vc]
        return out

    def _pad_vec(v, size: int, fill: float):
        if v.shape[0] == size:
            return v.contiguous()
        return torch.cat([v, v.new_full((size - v.shape[0],), fill)])

    def _rows_of(v, transposed: bool, fill: float = 0.0):
        """A (k, rows) factor table (zero-padded) or a vector over the
        panel's rows (padded with ``fill``), cut to this rank's block."""
        if ctx is None:
            return v
        if v.dim() == 2:
            return ctx.col_block(v) if transposed else ctx.row_block(v)
        r0, rb, vr = _rows_geom(transposed)
        return _pad_vec(v[r0:r0 + vr], rb, fill)

    def _cols_of(v, cs: int, nc: int, transposed: bool, fill: float = 0.0):
        """Columns ``cs .. cs + nc`` of a vector (or of a (k, n) table)
        along the panel's columns, this rank's part, zero-padded."""
        if ctx is None:
            return v[..., cs:cs + nc]
        c0, pb, vc = _cols_geom(nc, transposed)
        part = v[..., cs + c0:cs + c0 + vc]
        if v.dim() == 2:
            out = v.new_zeros((v.shape[0], pb))
            out[:, :vc] = part
            return out
        return _pad_vec(part, pb, fill)

    def _row0_col0(cs: int, nc: int, transposed: bool):
        """The global offsets of this rank's block of a panel: its first
        row within the panel and its first column within A's panel."""
        if ctx is None:
            return 0, cs
        return _rows_geom(transposed)[0], cs + _cols_geom(nc, transposed)[0]

    def _valid(nc: int, transposed: bool = False):
        if ctx is None:
            return None
        return _rows_geom(transposed)[2], _cols_geom(nc, transposed)[2]

    # the sum over a panel's rows, and the gather of its solved columns
    sum_f = ctx.rows if ctx is not None else NO_AXIS
    sum_t = ctx.cols if ctx is not None else NO_AXIS

    def _whole(X, nc: int, transposed: bool):
        """A solved block of a panel's columns as the panel's whole
        (k, nc) slice, on every rank."""
        if ctx is None:
            return X
        return (ctx.rows if transposed else ctx.cols).gather(X, dim=1)[
            :, :nc]

    gW = _dense_graph(graph_W, dev, syncs)
    gH = _dense_graph(graph_H, dev, syncs)
    active_loss = Loss.KL if cfg.loss == Loss.GP else cfg.loss
    per_col = cfg.dispersion == Dispersion.PER_COL
    is_nb = cfg.loss == Loss.NB
    # fixed dispersion, like the reference chunked engine
    # (fit_chunked.hpp:165-172): per-row (or per-col) NB size at its init
    nb_vec = (torch.full((n if per_col else m,), cfg.nb_size_init,
                         dtype=torch.float32, device=dev) if is_nb else None)

    # ---- sweep-granular checkpoint resume ----
    _resume = None
    if checkpoint_path is not None:
        # under a mesh rank 0 alone reads the file; every rank follows it
        # (or raises its error)
        from ..utils.checkpoint import load_stream_state
        try:
            if (ctx is None or ctx.is_root) \
                    and os.path.exists(checkpoint_path):
                _resume = load_stream_state(checkpoint_path, cfg)
                if _resume["W_T"].shape != (k, m) \
                        or _resume["H"].shape != (k, n):
                    raise ValueError(
                        "checkpoint factor shapes do not match the data")
            err = None
        except Exception as e:                    # noqa: BLE001
            if ctx is None:
                raise
            err = e
        if ctx is not None:
            err, _resume = ctx.share((err, _resume))
            if err is not None:
                raise err

    # ---- streaming NB zero-inflation: panel-local E-step imputation + one
    # pi EM update per sweep; pi init = min(zero_rate * 0.5, 0.3) as the
    # in-memory _zi_pi_init (fit_cpu.hpp:355-400), streamed in a pre-pass
    is_zi = use_irls and cfg.has_zi()
    zi_row = cfg.zi == ZI.ROW
    pi_vec = None
    if is_zi:
        if cfg.zi_em_iters > 1:
            warnings.warn(
                f"streaming ZI runs ONE pi EM update per sweep; "
                f"zi_em_iters={cfg.zi_em_iters} applies to the in-memory "
                "path only")
        if _resume is not None and _resume.get("pi_vec") is not None:
            pi_vec = _tensor(_resume["pi_vec"])
        else:
            zc_row = np.zeros((m,), np.float64)
            zc_col = np.zeros((n,), np.float64)
            for ch in loader.iter_chunks(transpose=False):
                zp = np.asarray(ch.data) == 0
                zc_row += zp.sum(axis=1)
                zc_col[ch.col_start:ch.col_start + ch.num_cols] += \
                    zp.sum(axis=0)
            rate = (zc_row / n) if zi_row else (zc_col / m)
            pi_vec = _tensor(np.minimum(rate * 0.5, 0.3))

    def _zi_bcast(cs, nc, transposed):
        """(pi_b, r_b) broadcast terms for one panel ((rows, 1) / (1, pc));
        forward panels hold columns of A, transpose panels columns of A^T
        (= rows of A), so the row / column roles swap.  A mesh rank's
        terms cover its block, the pads filled with 0.5 and 1.0 (they
        leave every statistic; these keep the E-step away from 0 / 0)."""
        along_rows = not zi_row if transposed else zi_row
        pi_b = (_rows_of(pi_vec, transposed, 0.5)[:, None] if along_rows
                else _cols_of(pi_vec, cs, nc, transposed, 0.5)[None, :])
        r_rows = per_col if transposed else not per_col
        r_b = (_rows_of(nb_vec, transposed, 1.0)[:, None] if r_rows
               else _cols_of(nb_vec, cs, nc, transposed, 1.0)[None, :])
        return pi_b, r_b

    def _thetas(cs, nc, transposed):
        """(theta_row, theta_col) of a panel: the NB size vector along the
        panel's rows or its columns (the roles swap on the W side,
        fit_cpu.hpp:821-833)."""
        if not is_nb:
            return None, None
        along_rows = per_col if transposed else not per_col
        return ((_rows_of(nb_vec, transposed, 1.0), None) if along_rows
                else (None, _cols_of(nb_vec, cs, nc, transposed, 1.0)))

    if _resume is not None:
        W_T0, H0, d0 = _resume["W_T"], _resume["H"], _resume["d"]
    elif cfg.init_mode in (1, 2) and w_init is None:
        # SVD init out of core: the init SVD itself streams over the
        # loader's panels (the Lanczos leading subspace for both modes)
        from .svd import streaming_svd
        sres = streaming_svd(loader, cfg.rank, method="lanczos",
                             seed=cfg.seed, device=dev)
        sq = np.sqrt(np.maximum(np.asarray(sres.d, np.float64), 0.0))
        W_T0 = (np.abs(np.asarray(sres.U)) * sq[None, :]).T.astype(np.float32)
        H0 = (np.abs(np.asarray(sres.V)) * sq[None, :]).T.astype(np.float32)
        if W_T0.shape[0] < k:
            fill_seed = 54321 if cfg.seed == 0 else cfg.seed + 999
            pad_w = rng_mod.fill_uniform(fill_seed, k - W_T0.shape[0], m)
            pad_h = rng_mod.fill_uniform(fill_seed, k - H0.shape[0], n,
                                         offset=(k - H0.shape[0]) * m)
            W_T0 = np.vstack([W_T0, pad_w])
            H0 = np.vstack([H0, pad_h])
        d0 = np.ones((k,), np.float32)
    else:
        W_T0, H0, d0 = init_factors(cfg, m, n, A=None, w_init=w_init,
                                    h_init=h_init)
    W_T, H, d = _tensor(W_T0), _tensor(H0), _tensor(d0)

    # streaming speckled CV (fit_streaming_spz.hpp:129-386): the panel
    # holdout comes from the position hash on the device, so no mask is
    # ever built on the host
    is_cv = cfg.is_cv()
    cv_seed = int(np.uint32(cfg.cv_seed)) if is_cv else 0
    inv_prob = int(1.0 / cfg.test_fraction) if is_cv else 0
    has_mask = mask is not None
    use_masked = is_cv or has_mask

    def _mask_panel(cs, nc, transposed):
        if not has_mask:
            return None
        sl = mask[cs:cs + nc, :].T if transposed else mask[:, cs:cs + nc]
        if ctx is not None:
            sl = _block_of(sl, nc, transposed).astype(bool)
        return syncs.to(torch.from_numpy(np.ascontiguousarray(sl)), dev,
                        torch.bool)

    # tr(A'A): only the plain MSE loss reads it.  The first sweep's
    # forward panels give it as they are read (``_panels``), unless this
    # loader cannot give a panel's part bit for bit in this ingest: then
    # one pass over the file, before the loop
    reads_trace = not use_masked and not use_irls
    trAtA = None
    if reads_trace and not loader.traces_panels(_sparse_mode):
        with span("rtt.stream.trace_sq"):
            trAtA = loader.trace_sq()
        stream["trace_passes"] = 1

    if _resume is not None:
        prev_loss = _resume["prev_loss"]
        best_test = _resume["best_test"]
        best_iter = _resume["best_iter"]
        patience = _resume["patience"]
        hist = list(_resume["hist"])
        test_hist = list(_resume["test_hist"])
        converged = _resume["converged"]
        it_start = _resume["it"]
    else:
        prev_loss, best_test, best_iter, patience = np.inf, np.inf, -1, 0
        hist, test_hist = [], []
        converged = False
        it_start = 0

    def _saved_loss_ready() -> bool:
        """A plain MSE sweep whose panels all sit in the wire cache takes
        its loss from the W update's saved matrices (the JAX package's
        ``_cached_sweep_mse``)."""
        return (_wire_cache and not use_masked and not use_irls
                and not cfg.projective and gW is None and gH is None
                and _cache_full(False) and _cache_full(True))

    done_sweeps = it_start
    with span("rtt.loop"):
        for it in spans("rtt.stream.sweep",
                        range(it_start, cfg.max_iter)):
            if converged:
                break
            t_sweep = time.perf_counter()
            stop = False
            saved_loss = _saved_loss_ready()

            # ---- H update over forward panels ----
            G_add_H = G_add_W = None
            if not use_masked and not use_irls:
                G = linalg.gram(W_T)
                G, _ = feat.apply_l1_l2(G, None, 0.0, cfg.H.L2)
                G = feat.apply_l21(G, H, cfg.H.L21)
                G = feat.apply_graph_reg(G, gH, H, cfg.H.graph_lambda)
            else:
                # L21 rides the per-column Grams as the shared tier-2 k x k
                # term, as on the in-memory masked / IRLS paths
                G_add_H = feat.tier2_gram_addition(H, cfg.H)
                G_add_W = feat.tier2_gram_addition(W_T, cfg.W)
            H_parts = {}
            W_T_f = _rows_of(W_T, False)            # this rank's rows of W_T
            for ch in spans("rtt.stream.panel", _panels(False)):
                cs, nc = ch.col_start, ch.num_cols
                row0, col0 = _row0_col0(cs, nc, False)
                if it == 0 and not isinstance(ch, _CachedChunk) \
                        and not _chunk_finite(ch):
                    # streamed panels (e.g. .spz) bypass the in-memory NaN
                    # auto-mask, so a corrupt / NaN file must fail here
                    raise ValueError(
                        f"non-finite values in columns {cs}..{cs + nc}; "
                        "streaming cannot auto-mask NaN/Inf — clean the "
                        "data or fit in-memory with mask=")
                A_panel = _put_panel(ch, False)
                X_warm = _cols_of(H, cs, nc, False)
                if cfg.projective:
                    X = sum_f.sum((W_T_f * d[:, None]) @ A_panel)
                elif use_irls:
                    th_row, th_col = _thetas(cs, nc, False)
                    if is_zi and it > 0:
                        # solves see the soft-imputed panel (in-memory: the
                        # iter >= 1 solves read state.A_imp)
                        A_panel = _panel_zi_impute(W_T_f, d, X_warm, A_panel,
                                                   *_zi_bcast(cs, nc, False))
                    X = _panel_solve_irls(
                        cfg, "H", W_T_f, A_panel, X_warm, it, th_row, th_col,
                        cv_seed, col0, _mask_panel(cs, nc, False), G_add_H,
                        active_loss=active_loss, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=False,
                        counts=irls_counts, row0=row0, axis=sum_f)
                elif use_masked:
                    X = _panel_solve_cv(
                        cfg, "H", W_T_f, A_panel, X_warm, it, cv_seed, col0,
                        _mask_panel(cs, nc, False), G_add_H, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=False, row0=row0,
                        axis=sum_f)
                else:
                    X = _solve_from_B(cfg, "H", G, sum_f.sum(W_T_f @ A_panel),
                                      X_warm, it)
                H_parts[cs] = _whole(X, nc, False)
                del A_panel
            H = torch.cat([H_parts[cs] for cs in sorted(H_parts)], dim=1)
            del H_parts
            if cfg.H.angular > 0:
                H = feat.apply_angular_posthoc(H, cfg.H.angular)
            H, d = linalg.extract_scaling(H, cfg.norm)

            # ---- W update over transpose panels ----
            G_w = linalg.gram(H)                             # saved for loss
            if not use_masked and not use_irls:
                G2, _ = feat.apply_l1_l2(G_w, None, 0.0, cfg.W.L2)
                G2 = feat.apply_l21(G2, W_T, cfg.W.L21)
                G2 = feat.apply_graph_reg(G2, gW, W_T, cfg.W.graph_lambda)
            W_parts, B_parts = {}, {}
            H_f = _rows_of(H, True)                 # this rank's columns of H
            for ch in spans("rtt.stream.panel", _panels(True)):
                cs, nc = ch.col_start, ch.num_cols
                row0, col0 = _row0_col0(cs, nc, True)
                At_panel = _put_panel(ch, True)      # (n, pc) columns of A^T
                X_warm = _cols_of(W_T, cs, nc, True)
                if use_irls:
                    th_row, th_col = _thetas(cs, nc, True)
                    if is_zi and it > 0:
                        At_panel = _panel_zi_impute(H_f, d, X_warm, At_panel,
                                                    *_zi_bcast(cs, nc, True))
                    X = _panel_solve_irls(
                        cfg, "W", H_f, At_panel, X_warm, it, th_row, th_col,
                        cv_seed, col0, _mask_panel(cs, nc, True), G_add_W,
                        active_loss=active_loss, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=True,
                        counts=irls_counts, row0=row0, axis=sum_t)
                elif use_masked:
                    X = _panel_solve_cv(
                        cfg, "W", H_f, At_panel, X_warm, it, cv_seed, col0,
                        _mask_panel(cs, nc, True), G_add_W, inv_prob=inv_prob,
                        mask_zeros=cfg.mask_zeros, transposed=True, row0=row0,
                        axis=sum_t)
                else:
                    B = sum_t.sum(H_f @ At_panel)
                    if saved_loss:
                        B_parts[cs] = B
                    X = _solve_from_B(cfg, "W", G2, B, X_warm, it)
                W_parts[cs] = _whole(X, nc, True)
                del At_panel
            W_T = torch.cat([W_parts[cs] for cs in sorted(W_parts)], dim=1)
            del W_parts
            if cfg.W.angular > 0:
                W_T = feat.apply_angular_posthoc(W_T, cfg.W.angular)
            W_T, d = linalg.extract_scaling(W_T, cfg.norm)

            with span("rtt.stream.loss"):
                # ---- loss ----
                W_T_l = _rows_of(W_T, False)
                if use_irls and not is_cv and not has_mask:
                    # per-panel device scalars; f64 host sum
                    tot_parts = []
                    if is_zi:
                        f64 = torch.float64
                        zs_row = torch.zeros((m,), dtype=f64, device=dev)
                        zs_col = torch.zeros((n,), dtype=f64, device=dev)
                        zn_row = torch.zeros((m,), dtype=f64, device=dev)
                        zn_col = torch.zeros((n,), dtype=f64, device=dev)
                        r0, _, vr = ((0, m, m) if ctx is None
                                     else _rows_geom(False))
                    for ch in _panels(False, prefetch=False):
                        cs, nc = ch.col_start, ch.num_cols
                        th_row, th_col = _thetas(cs, nc, False)
                        A_panel = _put_panel(ch, False)
                        H_panel = _cols_of(H, cs, nc, False)
                        if is_zi:
                            pl, sr, sc, cr, cc = _panel_irls_loss_zi(
                                cfg, W_T_l, d, H_panel, A_panel, th_row,
                                th_col, *_zi_bcast(cs, nc, False),
                                valid_rc=_valid(nc))
                            tot_parts.append(pl)
                            # this rank's block's part; under a mesh the
                            # disjoint blocks' parts are summed after the
                            # sweep
                            c0, _, vc = ((0, nc, nc) if ctx is None
                                         else _cols_geom(nc, False))
                            zs_row[r0:r0 + vr] += sr[:vr]
                            zn_row[r0:r0 + vr] += cr[:vr]
                            zs_col[cs + c0:cs + c0 + vc] += sc[:vc]
                            zn_col[cs + c0:cs + c0 + vc] += cc[:vc]
                        else:
                            tot_parts.append(_panel_irls_loss(
                                cfg, W_T_l, d, H_panel, A_panel, th_row,
                                th_col, valid_rc=_valid(nc)))
                        del A_panel
                    if ctx is not None:
                        tot_parts = [ctx.sum_all(torch.stack(tot_parts))]
                        if is_zi:
                            zs_row, zn_row, zs_col, zn_col = (
                                ctx.sum_all(v) for v in (zs_row, zn_row,
                                                         zs_col, zn_col))
                    loss = float(syncs.host(
                        torch.stack(tot_parts).double()).sum()) \
                        if tot_parts else 0.0
                    if is_zi:
                        # pi M-step (zi_em_step's update rule, once per sweep)
                        if zi_row:
                            new_pi = torch.clamp(zs_row / n, 0.001, 0.999)
                            keep = zn_row > 0
                        else:
                            new_pi = torch.clamp(zs_col / m, 0.001, 0.999)
                            keep = zn_col > 0
                        pi_vec = torch.where(keep, new_pi.to(torch.float32),
                                             pi_vec)
                    hist.append(loss)
                    rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
                    if it > 0 and rel < cfg.tol:
                        patience += 1
                        if patience >= cfg.patience:
                            converged = True
                            stop = True
                    else:
                        patience = 0
                    prev_loss = loss

                elif use_masked or use_irls:
                    acc_parts = []
                    for ch in _panels(False, prefetch=False):
                        cs, nc = ch.col_start, ch.num_cols
                        row0, col0 = _row0_col0(cs, nc, False)
                        th_row, th_col = _thetas(cs, nc, False)
                        A_panel = _put_panel(ch, False)
                        acc_parts.append(_panel_cv_losses(
                            cfg, W_T_l, d, _cols_of(H, cs, nc, False),
                            A_panel, cv_seed, col0, th_row, th_col,
                            _mask_panel(cs, nc, False), inv_prob=inv_prob,
                            mask_zeros=cfg.mask_zeros, row0=row0,
                            valid_rc=_valid(nc)))
                        del A_panel
                    acc = torch.stack(acc_parts)
                    if ctx is not None:
                        acc = ctx.sum_all(acc)
                    # one read of the device; a float64 host sum keeps the
                    # entry counts exact and the loss sums below fp32 drift
                    acc = syncs.host(acc).astype(np.float64).sum(axis=0)
                    tr_sse, tr_n, te_sse, te_n = [float(v) for v in acc]
                    loss = tr_sse / max(tr_n, 1.0)
                    test_loss = te_sse / max(te_n, 1.0)
                    hist.append(loss)
                    test_hist.append(test_loss)
                    conv_loss = test_loss if is_cv else loss
                    if is_cv:
                        if test_loss < best_test:
                            best_test = test_loss
                            best_iter = it
                            patience = 0
                        else:
                            patience += 1
                    rel = abs(prev_loss - conv_loss) / (abs(prev_loss)
                                                        + 1e-15)
                    prev_loss = conv_loss
                    if not is_cv:
                        # consecutive sub-tol iterations only
                        if it > 0 and rel < cfg.tol:
                            patience += 1
                        else:
                            patience = 0
                    if (is_cv and (patience >= cfg.cv_patience
                                   or (it > 0 and rel < cfg.tol))) or \
                       (not is_cv and patience >= cfg.patience):
                        converged = True
                        stop = True

                else:
                    if saved_loss:
                        B_w = torch.cat(
                            [B_parts[cs] for cs in sorted(B_parts)], dim=1)
                        loss = float(syncs.host(linalg.mse_loss_from_saved(
                            _tensor(trAtA), W_T, d, B_w, G_w)))
                        del B_w
                    else:
                        # the cross term accumulates on the device in panel
                        # order; one read per sweep
                        cross_d = torch.zeros((), dtype=torch.float32,
                                              device=dev)
                        for ch in _panels(False, prefetch=False):
                            cs, nc = ch.col_start, ch.num_cols
                            A_panel = _put_panel(ch, False)
                            cross_d = cross_d + _panel_cross_term(
                                W_T_l, d, _cols_of(H, cs, nc, False), A_panel)
                            del A_panel
                        if ctx is not None:
                            cross_d = ctx.sum_all(cross_d)
                        cross = float(syncs.host(cross_d))
                        G_wt = linalg.gram(W_T)
                        recon = float(syncs.host(
                            ((d[:, None] * d[None, :]) * G_wt * G_w).sum()))
                        loss = trAtA - 2.0 * cross + recon
                    hist.append(loss)
                    rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
                    if it > 0 and rel < cfg.tol:
                        patience += 1
                        if patience >= cfg.patience:
                            converged = True
                            stop = True
                    else:
                        patience = 0
                    prev_loss = loss
                B_parts.clear()

            # ---- per-sweep observability: callbacks and preemption-safe
            # checkpoints at sweep boundaries ----
            if ctx is not None:
                # every rank holds the same loss; the stop is still rank 0's
                stop = ctx.share(stop)
            done_sweeps = it + 1
            stream["sweep_s"].append(time.perf_counter() - t_sweep)
            if on_iteration is not None:
                on_iteration(it + 1, float(hist[-1]),
                             float(test_hist[-1]) if test_hist
                             else float("nan"))
            if checkpoint_path is not None and (
                    (it + 1) % int(checkpoint_every) == 0 or stop
                    or it + 1 == cfg.max_iter):
                from ..utils.checkpoint import save_stream_state
                if ctx is None or ctx.is_root:
                    # the state is whole on every rank; rank 0 writes it
                    save_stream_state(
                        checkpoint_path, cfg, W_T=W_T, H=H, d=d, it=it + 1,
                        prev_loss=prev_loss, patience=patience,
                        best_test=best_test, best_iter=best_iter, hist=hist,
                        test_hist=test_hist, pi_vec=pi_vec,
                        converged=converged)
                if ctx is not None:
                    ctx.barrier()
            if stop:
                break

    with span("rtt.fit.finalize"):
        host = syncs.host
        res = NMFResult(
            W=host(W_T).T, d=host(d), H=host(H),
            iterations=done_sweeps,
            converged=converged,
            train_loss=float(hist[-1]) if hist else float("nan"),
            test_loss=float(test_hist[-1]) if test_hist else float("nan"),
            best_iter=best_iter,
            loss_history=np.asarray(hist, dtype=np.float64),
            test_loss_history=(np.asarray(test_hist, dtype=np.float64)
                               if test_hist else None),
        )
        if is_cv:
            res.misc["best_test_loss"] = float(best_test)
        if is_nb:
            # fixed at init in streaming mode, like the reference chunked
            # engine
            res.theta = host(nb_vec)
        if is_zi:
            if zi_row:
                res.pi_row = host(pi_vec)
            else:
                res.pi_col = host(pi_vec)
        if cfg.sort_model:
            res.sort()
    if use_irls:
        stream["inner_iters"] = irls_counts["inner_iters"]
    res.misc["stream"] = stream
    res.misc["host_syncs"] = syncs.n + irls_counts["host_syncs"]
    return res
