"""Chunked / streaming NMF: larger-than-memory ALS over a DataLoader.

The port of ``rcppml_tpu/models/nmf_chunked.py`` (``nmf/fit_chunked.hpp:
71+`` and the streaming entry ``nmf/fit_streaming_spz.hpp:54-223``):

  per sweep:
    gram(W_T) once (k x k)  ->  forward column panels: per-panel RHS +
    solve for the H panel (the Prefetcher overlaps host decode with device
    compute)  ->  gram(H)  ->  transpose panels: per-panel W_T updates  ->
    scaling  ->  loss accumulated panel by panel, in panel order.

Three parts, each reading only the one below it:

  * :func:`nmf_chunked`: the checks, the starting state, the sweeps and
    the host's convergence rule (``models/nmf.py::HostConvergence``);
  * :class:`_Sweep`: one side's update over its panels (the H update over
    the forward panels and the W update over the transposed ones are the
    same function) and the loss;
  * the panels: ``io/panels.py::PanelSource`` (ingest, caches, prefetch,
    tr(A'A), the stream's counters) and, on a mesh, this rank's block of
    each panel (``parallel/mesh.py::PanelBlocks``).

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

Sparse panels travel as compact COO and are densified on the device; a
sparse-panel fit is bit for bit the dense-panel one (``io/panels.py``).
Where the dense cache holds every forward panel (no mesh), the W update's
transposed panels are built there from them, not decoded a second time.

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
from ..config import ZI, Dispersion, Loss, NMFConfig
from ..device import set_fp32_precision
from ..io.loaders import DataLoader, SpzLoader
from ..io.panels import PanelSource
from ..ops import features as feat
from ..ops import linalg, losses
from ..parallel.mesh import NO_AXIS, PanelBlocks, ShardContext, rank_device
from ..result import NMFResult
from ..utils.trace import Syncs, span, spans
from .nmf import HostConvergence, _solve, fit_device, init_factors

# ---------------------------------------------------------------------------
# Panel solves (one column panel each)
# ---------------------------------------------------------------------------

def _solve_from_B(cfg: NMFConfig, side: str, G, B, X_warm, it: int):
    """The feature + solve tail of a shared-Gram panel solve, B = F @ A
    already formed: the L1 shift, the in-memory fit's solve
    (``models/nmf.py::_solve``: the Cholesky solve + clip, kernel 6 on the
    card, or CD NNLS, kernel 1) and the upper bound."""
    fc = cfg.H if side == "H" else cfg.W
    if fc.L1 > 0:
        B = B - fc.L1
    X = _solve(cfg, G, B, X_warm, fc, it)
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
                               X_warm * float(it > 0), G_add=G_add, axis=axis)
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
                         False, extra_w=extra_w, X_warm=X_warm * float(it > 0),
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
# One sweep: a side's update over its panels, and the loss
# ---------------------------------------------------------------------------

def _dense_graph(L, dev, syncs: Syncs):
    if L is None:
        return None
    return syncs.to(torch.from_numpy(np.array(
        L.todense() if hasattr(L, "todense") else L, np.float32,
        order="C")), dev)


class _Sweep:
    """What a stream's sweeps read besides the factors: the config, the
    panels (``source``) and this rank's blocks of them (``blocks``), the
    graph Laplacians, the user mask (``mask``), the CV holdout, the NB
    sizes (``nb_vec``, fixed at their init as in the reference chunked
    engine) and the ZI dropout rates (``pi_vec``, one EM update a sweep);
    the IRLS solves' counts (``irls_counts``)."""

    def __init__(self, cfg: NMFConfig, source: PanelSource,
                 blocks: PanelBlocks, syncs: Syncs, dev, *, mask, graph_W,
                 graph_H, resume):
        self.cfg, self.source, self.blocks = cfg, source, blocks
        self.syncs, self.dev = syncs, dev
        self.m, self.n = source.rows_dim[False], source.rows_dim[True]
        self.mask = mask
        self.use_irls = cfg.requires_irls()
        self.is_cv = cfg.is_cv()
        self.use_masked = self.is_cv or mask is not None
        self.plain = not self.use_masked and not self.use_irls
        # streaming speckled CV (fit_streaming_spz.hpp:129-386): the panel
        # holdout comes from the position hash on the device, so no mask is
        # ever built on the host
        self.cv_seed = int(np.uint32(cfg.cv_seed)) if self.is_cv else 0
        self.inv_prob = int(1.0 / cfg.test_fraction) if self.is_cv else 0
        self.graph = {"W": _dense_graph(graph_W, dev, syncs),
                      "H": _dense_graph(graph_H, dev, syncs)}
        self.active_loss = Loss.KL if cfg.loss == Loss.GP else cfg.loss
        self.per_col = cfg.dispersion == Dispersion.PER_COL
        self.is_nb = cfg.loss == Loss.NB
        # fixed dispersion, like the reference chunked engine
        # (fit_chunked.hpp:165-172): per-row (or per-col) NB size at its init
        self.nb_vec = (torch.full((self.n if self.per_col else self.m,),
                                  cfg.nb_size_init, dtype=torch.float32,
                                  device=dev) if self.is_nb else None)
        self.is_zi = self.use_irls and cfg.has_zi()
        self.zi_row = cfg.zi == ZI.ROW
        self.pi_vec = self._zi_start(resume) if self.is_zi else None
        self.irls_counts = {"inner_iters": 0, "host_syncs": 0}
        self.B_parts: dict = {}

    def tensor(self, x) -> torch.Tensor:
        return self.syncs.to(torch.from_numpy(np.array(x, np.float32,
                                                        order="C")), self.dev)

    def _zi_start(self, resume) -> torch.Tensor:
        """Streaming NB zero-inflation: panel-local E-step imputation + one
        pi EM update per sweep; pi init = min(zero_rate * 0.5, 0.3) as the
        in-memory _zi_pi_init (fit_cpu.hpp:355-400), streamed in a
        pre-pass."""
        cfg, m, n = self.cfg, self.m, self.n
        if cfg.zi_em_iters > 1:
            warnings.warn(
                f"streaming ZI runs ONE pi EM update per sweep; "
                f"zi_em_iters={cfg.zi_em_iters} applies to the in-memory "
                "path only")
        if resume is not None and resume.get("pi_vec") is not None:
            return self.tensor(resume["pi_vec"])
        zc_row = np.zeros((m,), np.float64)
        zc_col = np.zeros((n,), np.float64)
        for ch in self.source.loader.iter_chunks(transpose=False):
            zp = np.asarray(ch.data) == 0
            zc_row += zp.sum(axis=1)
            zc_col[ch.col_start:ch.col_start + ch.num_cols] += zp.sum(axis=0)
        rate = (zc_row / n) if self.zi_row else (zc_col / m)
        return self.tensor(np.minimum(rate * 0.5, 0.3))

    def zi_bcast(self, cs, nc, transposed):
        """(pi_b, r_b) broadcast terms for one panel ((rows, 1) / (1, pc));
        forward panels hold columns of A, transpose panels columns of A^T
        (= rows of A), so the row / column roles swap.  A mesh rank's
        terms cover its block, the pads filled with 0.5 and 1.0 (they
        leave every statistic; these keep the E-step away from 0 / 0)."""
        b = self.blocks
        along_rows = not self.zi_row if transposed else self.zi_row
        pi_b = (b.rows_of(self.pi_vec, transposed, 0.5)[:, None] if along_rows
                else b.cols_of(self.pi_vec, cs, nc, transposed, 0.5)[None, :])
        r_rows = self.per_col if transposed else not self.per_col
        r_b = (b.rows_of(self.nb_vec, transposed, 1.0)[:, None] if r_rows
               else b.cols_of(self.nb_vec, cs, nc, transposed, 1.0)[None, :])
        return pi_b, r_b

    def thetas(self, cs, nc, transposed):
        """(theta_row, theta_col) of a panel: the NB size vector along the
        panel's rows or its columns (the roles swap on the W side,
        fit_cpu.hpp:821-833)."""
        if not self.is_nb:
            return None, None
        b = self.blocks
        along_rows = self.per_col if transposed else not self.per_col
        return ((b.rows_of(self.nb_vec, transposed, 1.0), None) if along_rows
                else (None, b.cols_of(self.nb_vec, cs, nc, transposed, 1.0)))

    def mask_panel(self, cs, nc, transposed):
        """The user mask's part of a panel (this rank's block), or None."""
        if self.mask is None:
            return None
        sl = (self.mask[cs:cs + nc, :].T if transposed
              else self.mask[:, cs:cs + nc])
        sl = self.blocks.block_of(sl, nc, transposed, bool)
        return self.syncs.to(torch.from_numpy(np.ascontiguousarray(sl)),
                             self.dev, torch.bool)

    def update(self, it: int, side: str, X, F, d, keep_B: bool = False):
        """One side's update over its panels: ``X`` (H, or W_T with
        ``side="W"``) solved against the other factor ``F``, panel by panel
        (projective H, IRLS with NB-ZI imputation after sweep 0, masked /
        CV, or the shared-Gram solve), joined in panel order, then the
        angular penalty and the scaling.  Returns (X, d, gram(F)); gram(F)
        is formed on the W side always (the MSE loss reads it), on the H
        side only for the shared-Gram solve.  ``keep_B``: keep the
        right-hand sides for the loss (``B_parts``)."""
        cfg, b = self.cfg, self.blocks
        transposed = side == "W"
        fc = cfg.W if transposed else cfg.H
        G = G_f = G_add = None
        if self.plain or transposed:
            G_f = linalg.gram(F)
        if self.plain:
            G, _ = feat.apply_l1_l2(G_f, None, 0.0, fc.L2)
            G = feat.apply_l21(G, X, fc.L21)
            G = feat.apply_graph_reg(G, self.graph[side], X, fc.graph_lambda)
        else:
            # L21 rides the per-column Grams as the shared tier-2 k x k
            # term, as on the in-memory masked / IRLS paths
            G_add = feat.tier2_gram_addition(X, fc)
        parts = {}
        F_b = b.rows_of(F, transposed)          # this rank's rows of F
        axis = b.axis(transposed)
        for ch in spans("rtt.stream.panel", self.source.panels(transposed)):
            cs, nc = ch.col_start, ch.num_cols
            row0, col0 = b.offsets(cs, nc, transposed)
            A_panel = self.source.put(ch, transposed, check_finite=(
                it == 0 and not transposed))
            X_warm = b.cols_of(X, cs, nc, transposed)
            if cfg.projective and not transposed:
                Y = axis.sum((F_b * d[:, None]) @ A_panel)
            elif self.use_irls:
                th_row, th_col = self.thetas(cs, nc, transposed)
                if self.is_zi and it > 0:
                    # solves see the soft-imputed panel (in-memory: the
                    # iter >= 1 solves read state.A_imp)
                    A_panel = _panel_zi_impute(
                        F_b, d, X_warm, A_panel,
                        *self.zi_bcast(cs, nc, transposed))
                Y = _panel_solve_irls(
                    cfg, side, F_b, A_panel, X_warm, it, th_row, th_col,
                    self.cv_seed, col0, self.mask_panel(cs, nc, transposed),
                    G_add, active_loss=self.active_loss,
                    inv_prob=self.inv_prob, mask_zeros=cfg.mask_zeros,
                    transposed=transposed, counts=self.irls_counts,
                    row0=row0, axis=axis)
            elif self.use_masked:
                Y = _panel_solve_cv(
                    cfg, side, F_b, A_panel, X_warm, it, self.cv_seed, col0,
                    self.mask_panel(cs, nc, transposed), G_add,
                    inv_prob=self.inv_prob, mask_zeros=cfg.mask_zeros,
                    transposed=transposed, row0=row0, axis=axis)
            else:
                B = axis.sum(F_b @ A_panel)
                if keep_B:
                    self.B_parts[cs] = B
                Y = _solve_from_B(cfg, side, G, B, X_warm, it)
            parts[cs] = b.whole(Y, nc, transposed)
            del A_panel
        X = torch.cat([parts[cs] for cs in sorted(parts)], dim=1)
        del parts
        if fc.angular > 0:
            X = feat.apply_angular_posthoc(X, fc.angular)
        X, d = linalg.extract_scaling(X, cfg.norm)
        return X, d, G_f

    def loss(self, W_T, H, d, G_w, saved: bool):
        """(train loss, test loss or None) after a sweep, one host read:
        the IRLS loss (and the ZI E-step statistics, then pi's M-step), the
        masked / CV losses, or the MSE loss (from the W update's saved
        matrices with ``saved``, else tr(A'A) - 2 cross + reconstruction).
        The forward panels are read again, on this thread."""
        W_T_l = self.blocks.rows_of(W_T, False)
        if self.use_irls and not self.use_masked:
            return self._irls_loss(W_T_l, H, d), None
        if self.use_masked:
            return self._masked_loss(W_T_l, H, d)
        return self._mse_loss(W_T, W_T_l, H, d, G_w, saved), None

    def _irls_loss(self, W_T_l, H, d) -> float:
        cfg, b, m, n = self.cfg, self.blocks, self.m, self.n
        # per-panel device scalars; f64 host sum
        tot_parts = []
        if self.is_zi:
            zs_row, zs_col, zn_row, zn_col = (
                torch.zeros((size,), dtype=torch.float64, device=self.dev)
                for size in (m, n, m, n))
            r0, _, vr = b.rows_geom(False)
        for ch in self.source.panels(False, prefetch=False):
            cs, nc = ch.col_start, ch.num_cols
            th_row, th_col = self.thetas(cs, nc, False)
            A_panel = self.source.put(ch, False)
            H_panel = b.cols_of(H, cs, nc, False)
            if self.is_zi:
                pl, sr, sc, cr, cc = _panel_irls_loss_zi(
                    cfg, W_T_l, d, H_panel, A_panel, th_row, th_col,
                    *self.zi_bcast(cs, nc, False), valid_rc=b.valid(nc))
                tot_parts.append(pl)
                # this rank's block's part; under a mesh the disjoint
                # blocks' parts are summed after the sweep
                c0, _, vc = b.cols_geom(nc, False)
                zs_row[r0:r0 + vr] += sr[:vr]
                zn_row[r0:r0 + vr] += cr[:vr]
                zs_col[cs + c0:cs + c0 + vc] += sc[:vc]
                zn_col[cs + c0:cs + c0 + vc] += cc[:vc]
            else:
                tot_parts.append(_panel_irls_loss(
                    cfg, W_T_l, d, H_panel, A_panel, th_row, th_col,
                    valid_rc=b.valid(nc)))
            del A_panel
        sum_all = b.ctx.sum_all
        tot = sum_all(torch.stack(tot_parts)) if tot_parts else None
        if self.is_zi:
            zs_row, zn_row, zs_col, zn_col = (
                sum_all(v) for v in (zs_row, zn_row, zs_col, zn_col))
        loss = float(self.syncs.host(tot.double()).sum()) if tot_parts \
            else 0.0
        if self.is_zi:
            # pi M-step (zi_em_step's update rule, once per sweep)
            if self.zi_row:
                new_pi = torch.clamp(zs_row / n, 0.001, 0.999)
                keep = zn_row > 0
            else:
                new_pi = torch.clamp(zs_col / m, 0.001, 0.999)
                keep = zn_col > 0
            self.pi_vec = torch.where(keep, new_pi.to(torch.float32),
                                      self.pi_vec)
        return loss

    def _masked_loss(self, W_T_l, H, d):
        b = self.blocks
        acc_parts = []
        for ch in self.source.panels(False, prefetch=False):
            cs, nc = ch.col_start, ch.num_cols
            row0, col0 = b.offsets(cs, nc, False)
            th_row, th_col = self.thetas(cs, nc, False)
            A_panel = self.source.put(ch, False)
            acc_parts.append(_panel_cv_losses(
                self.cfg, W_T_l, d, b.cols_of(H, cs, nc, False), A_panel,
                self.cv_seed, col0, th_row, th_col,
                self.mask_panel(cs, nc, False), inv_prob=self.inv_prob,
                mask_zeros=self.cfg.mask_zeros, row0=row0,
                valid_rc=b.valid(nc)))
            del A_panel
        acc = b.ctx.sum_all(torch.stack(acc_parts))
        # one read of the device; a float64 host sum keeps the entry counts
        # exact and the loss sums below fp32 drift
        acc = self.syncs.host(acc).astype(np.float64).sum(axis=0)
        tr_sse, tr_n, te_sse, te_n = [float(v) for v in acc]
        return tr_sse / max(tr_n, 1.0), te_sse / max(te_n, 1.0)

    def _mse_loss(self, W_T, W_T_l, H, d, G_w, saved: bool) -> float:
        host, trAtA = self.syncs.host, self.source.trAtA
        if saved:
            B_w = torch.cat([self.B_parts[cs] for cs in sorted(self.B_parts)],
                            dim=1)
            self.B_parts.clear()
            return float(host(linalg.mse_loss_from_saved(
                self.tensor(trAtA), W_T, d, B_w, G_w)))
        # the cross term accumulates on the device in panel order; one read
        # per sweep
        cross_d = torch.zeros((), dtype=torch.float32, device=self.dev)
        for ch in self.source.panels(False, prefetch=False):
            cs, nc = ch.col_start, ch.num_cols
            A_panel = self.source.put(ch, False)
            cross_d = cross_d + _panel_cross_term(
                W_T_l, d, self.blocks.cols_of(H, cs, nc, False), A_panel)
            del A_panel
        cross = float(host(self.blocks.ctx.sum_all(cross_d)))
        G_wt = linalg.gram(W_T)
        recon = float(host(((d[:, None] * d[None, :]) * G_wt * G_w).sum()))
        return trAtA - 2.0 * cross + recon


# ---------------------------------------------------------------------------
# The streaming fit
# ---------------------------------------------------------------------------

def _load_resume(path, cfg: NMFConfig, ctx: ShardContext, shape):
    """The stream state saved at ``path`` (``utils/checkpoint.py``'s, shared
    with the JAX package), or None where there is none.  Under a mesh rank
    0 alone reads the file; every rank follows it (or raises its error)."""
    if path is None:
        return None
    from ..utils.checkpoint import load_stream_state
    state = err = None
    try:
        if ctx.is_root and os.path.exists(path):
            state = load_stream_state(path, cfg)
            if (state["W_T"].shape, state["H"].shape) != shape:
                raise ValueError(
                    "checkpoint factor shapes do not match the data")
    except Exception as e:                    # noqa: BLE001
        err = e
    err, state = ctx.share((err, state))
    if err is not None:
        raise err
    return state


def _start(cfg: NMFConfig, loader: DataLoader, resume, w_init, h_init, dev):
    """The starting (W_T, H, d) on the host: the resumed state, an SVD
    start streamed over the loader's panels, or ``init_factors``'."""
    (m, n), k = loader.shape, cfg.rank
    if resume is not None:
        return resume["W_T"], resume["H"], resume["d"]
    if cfg.init_mode not in (1, 2) or w_init is not None:
        return init_factors(cfg, m, n, A=None, w_init=w_init, h_init=h_init)
    # SVD init out of core: the init SVD itself streams over the loader's
    # panels (the Lanczos leading subspace for both modes)
    from .svd import streaming_svd
    sres = streaming_svd(loader, k, method="lanczos", seed=cfg.seed,
                         device=dev)
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
    return W_T0, H0, np.ones((k,), np.float32)


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
    forward panels whose parts gave it, in the Prefetcher's workers),
    ``transposed_on_card`` (the transposed panels built on the device from
    the cached forward panels instead of read: ``io/panels.py``) and, for
    an IRLS fit, ``inner_iters`` of its panel solves.
    ``res.misc["host_syncs"]`` counts the fit's synchronizing calls
    (``utils.trace.Syncs``; not the checkpoint's reads, a seeding SVD's or
    a mesh's collectives).  Under a profiler the fit opens
    ``rtt.stream.trace_sq`` (the loader's pass for tr(A'A), where
    ``trace_passes`` is 1), ``rtt.loop``
    around its sweeps, ``rtt.stream.sweep`` for each, ``rtt.stream.panel``
    for each panel's put and solve, ``rtt.stream.wait`` where it waits on a
    decode, ``rtt.stream.upload``, ``rtt.stream.transpose`` (a transposed
    panel built from the forward ones), ``rtt.stream.loss`` and
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
    dev = (rank_device(mesh, device) if mesh is not None
           else fit_device(loader, device))
    blocks = PanelBlocks(ShardContext(mesh, m, n))
    ctx = blocks.ctx
    set_fp32_precision()
    syncs = Syncs()
    source = PanelSource(loader, blocks, dev, panel_cache=panel_cache,
                         sparse_panels=sparse_panels,
                         reads_trace=not (cfg.is_cv() or mask is not None
                                          or use_irls))
    resume = _load_resume(checkpoint_path, cfg, ctx, ((k, m), (k, n)))
    sweep = _Sweep(cfg, source, blocks, syncs, dev, mask=mask,
                   graph_W=graph_W, graph_H=graph_H, resume=resume)
    W_T, H, d = (sweep.tensor(x) for x in _start(cfg, loader, resume,
                                                 w_init, h_init, dev))
    rule = HostConvergence(cfg, sweep.is_cv, resume)
    # a plain MSE sweep whose panels all sit in the wire cache takes its
    # loss from the W update's saved matrices (the JAX package's
    # ``_cached_sweep_mse``)
    may_save = (sweep.plain and not cfg.projective and graph_W is None
                and graph_H is None)

    done_sweeps = it_start = resume["it"] if resume is not None else 0
    with span("rtt.loop"):
        for it in spans("rtt.stream.sweep",
                        range(it_start, cfg.max_iter)):
            if rule.converged:
                break
            t_sweep = time.perf_counter()
            saved = may_save and source.wire_full()
            H, d, _ = sweep.update(it, "H", H, W_T, d)
            W_T, d, G_w = sweep.update(it, "W", W_T, H, d, keep_B=saved)
            with span("rtt.stream.loss"):
                stop = rule.update(it, *sweep.loss(W_T, H, d, G_w, saved))
            # every rank holds the same loss; the stop is still rank 0's
            stop = ctx.share(stop)
            done_sweeps = it + 1
            source.stream["sweep_s"].append(time.perf_counter() - t_sweep)
            if on_iteration is not None:
                on_iteration(it + 1, float(rule.hist[-1]),
                             float(rule.test_hist[-1]) if rule.test_hist
                             else float("nan"))
            # preemption-safe checkpoints at sweep boundaries
            if checkpoint_path is not None and (
                    (it + 1) % int(checkpoint_every) == 0 or stop
                    or it + 1 == cfg.max_iter):
                from ..utils.checkpoint import save_stream_state
                if ctx.is_root:
                    # the state is whole on every rank; rank 0 writes it
                    save_stream_state(
                        checkpoint_path, cfg, W_T=W_T, H=H, d=d, it=it + 1,
                        pi_vec=sweep.pi_vec, **rule.state())
                ctx.barrier()
            if stop:
                break

    with span("rtt.fit.finalize"):
        host = syncs.host
        hist, test_hist = rule.hist, rule.test_hist
        res = NMFResult(
            W=host(W_T).T, d=host(d), H=host(H),
            iterations=done_sweeps,
            converged=rule.converged,
            train_loss=float(hist[-1]) if hist else float("nan"),
            test_loss=float(test_hist[-1]) if test_hist else float("nan"),
            best_iter=rule.best_iter,
            loss_history=np.asarray(hist, dtype=np.float64),
            test_loss_history=(np.asarray(test_hist, dtype=np.float64)
                               if test_hist else None),
        )
        if sweep.is_cv:
            res.misc["best_test_loss"] = float(rule.best_test)
        if sweep.is_nb:
            # fixed at init in streaming mode, like the reference chunked
            # engine
            res.theta = host(sweep.nb_vec)
        if sweep.is_zi:
            if sweep.zi_row:
                res.pi_row = host(sweep.pi_vec)
            else:
                res.pi_col = host(sweep.pi_vec)
        if cfg.sort_model:
            res.sort()
    stream = source.stream
    if use_irls:
        stream["inner_iters"] = sweep.irls_counts["inner_iters"]
    res.misc["stream"] = stream
    res.misc["host_syncs"] = syncs.n + sweep.irls_counts["host_syncs"]
    return res
