"""Speckled-holdout cross-validation and masked NMF.

The port of ``rcppml_tpu/models/nmf_cv.py`` (the reference CV engine,
``nmf/fit_cv.hpp:124-1667``, ``nmf/speckled_cv.hpp:58-339``,
``nmf/masked_nnls.hpp:73-178``).

The reference corrects the Gram per column (``G_local = G - W_test W_test^T``,
cv_detail.hpp:54-84).  Here, as in the JAX package, that is a *weighted*
batched solve: the train mask is a dense 0/1 weight field and each column's
Gram is ``F diag(train_j) F^T``, every column of a block solved at once with
a per-column Cholesky or the per-column-Gram CD kernel.

The speckled holdout is a pure function of (seed, i, j), the SplitMix64
position hash of the reference (rng/rng.hpp:129-170), computed on the fit's
device (:func:`rcppml_tpu_torch.rng.is_holdout`); nothing is uploaded.

CV convergence (fit_cv.hpp:1584-1621): patience on test-loss improvement,
plus an immediate stop when the test loss's relative change drops below tol.
``train_loss``/``test_loss`` are per-entry means (fit_cv.hpp:1545-1548).

Where the JAX package runs one ``lax.while_loop``, this is a Python loop over
tensors that stay on the fit's device.  A cross-validated fit reads
``converged`` on the host once per iteration (the patience stop cannot be
ruled out beforehand); a masked fit does so only when ``tol > 0``.  Every
read is counted in ``res.misc["host_syncs"]``.  Everything is float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import rng as rng_mod
from ..config import Dispersion, Loss, NMFConfig, Solver, ZI
from ..device import set_fp32_precision
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..parallel.mesh import NO_AXIS
from ..result import NMFResult
from .nmf import device_matrix, fit_device, init_factors
from .nmf_irls import (_POWER_LOSSES, _block_count, _init_dispersion,
                       _posthoc, _use_kr, _zi_pi_init, gp_theta_update,
                       irls_solve_batch, nb_size_update, phi_update,
                       zi_em_step)


@dataclass
class CVState:
    W_T: torch.Tensor
    H: torch.Tensor
    d: torch.Tensor
    disp_row: torch.Tensor
    disp_col: torch.Tensor
    it: int                          # completed iterations (host count)
    prev_conv_loss: torch.Tensor     # previous test loss (CV) / train (masked)
    patience_ctr: torch.Tensor       # 0-d int32
    converged: torch.Tensor          # 0-d bool
    final_tol: torch.Tensor          # 0-d
    train_hist: torch.Tensor         # (max_iter,), NaN-padded
    test_hist: torch.Tensor
    best_test_loss: torch.Tensor     # 0-d
    best_iter: torch.Tensor          # 0-d int32
    pi_row: torch.Tensor             # (m,) ZI dropout (zeros when no ZI)
    pi_col: torch.Tensor             # (n,)
    A_imp: Optional[torch.Tensor]    # (m, n) soft-imputed data (ZI only)
    inner_iters: int = 0             # IRLS inner iterations so far
    host_syncs: int = 0              # host reads so far


def _rank_ridge(Gb: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """Relative ridge for batched per-column Grams: a column with < k
    observed train entries has a rank-deficient Gram (the reference's
    unpivoted LLT hits the same hazard, cholesky_clip.hpp:92-95); the
    trace-relative ridge keeps the batched Cholesky finite without
    measurably moving well-conditioned columns (1e-6 << fp32 solve error)."""
    k = Gb.shape[-1]
    tr = Gb.diagonal(dim1=1, dim2=2).sum(dim=1) / k
    return Gb + (1e-6 * tr + 1e-12)[:, None, None] * eye[None]


def _solve_block(Gb, b, cfg: NMFConfig, fc, X0, eye):
    """One column block's per-column solve in either solver mode.  Cholesky
    mode applies L1 to the RHS (fused_nnls.hpp:117); CD applies it per
    coordinate visit as the G_ii-scaled threshold (nnls_batch.hpp:92-94), not
    as a subtraction from the RHS, which would shrink by L1 / G_ii instead."""
    if cfg.solver == Solver.CHOLESKY:
        if fc.L1 > 0:
            b = b - fc.L1
        return solvers.cholesky_clip_batched_gram(_rank_ridge(Gb, eye), b,
                                                  nonneg=fc.nonneg)
    B_res = b - solvers.batched_gram_matvec(Gb, X0)
    return solvers.cd_nnls_batched_gram(
        Gb, B_res, X0, fc.L1, nonneg=fc.nonneg, maxit=cfg.cd_max_iter,
        cd_tol=cfg.cd_tol)


def masked_mse_solve_batch(A_data, F, train_w, cfg: NMFConfig, fc, X_warm,
                           G_add=None, target=None, axis=NO_AXIS):
    """MSE masked solve: per-column Gram over train entries only.

    A_data (m, nc), F (k, m), train_w (m, nc) 0/1.  Blocked batched solve;
    equivalent to the reference's per-column Gram correction
    (cv_detail.hpp:54-84) since sum_train w w' = G_full - sum_test w w'.
    Always float32 (the JAX package's ``precise=True``).

    ``G_add``: optional shared k x k tier-2 term (graph reg + L21) added to
    every per-column Gram, the reference's apply_cv_features semantics
    (fit_cv.hpp:417,581).  ``target``: optional (k, nc) enrichment target
    (fc.target_lambda > 0): G.diag += lam, b += lam * T
    (factor_config.hpp:80-102).  ``axis``: under a mesh, the axis A_data's
    rows are split over; each column's Gram and RHS are summed over it
    before the solve.
    """
    k, m = F.shape
    n = A_data.shape[1]
    use_kr = _use_kr(k, m)
    KR = linalg.kr_product(F) if use_kr else None
    bc = _block_count(n, k, m, kr=use_kr)
    eye = torch.eye(k, dtype=A_data.dtype, device=A_data.device)

    def solve_block(lo: int, hi: int):
        Gb, b = linalg.weighted_gram_and_rhs(
            F, train_w[:, lo:hi], A_data[:, lo:hi], KR=KR)
        Gb, b = axis.sum(Gb), axis.sum(b)
        Gb = Gb + (1e-15 + fc.L2) * eye[None]
        if G_add is not None:
            Gb = Gb + G_add[None]
        if target is not None:
            Gb = Gb + fc.target_lambda * eye[None]
            b = b + fc.target_lambda * target[:, lo:hi]
        return _solve_block(Gb, b, cfg, fc, X_warm[:, lo:hi], eye)

    blocks = [solve_block(lo, min(lo + bc, n)) for lo in range(0, n, bc)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def masked_downdate_solve_batch(B_full, F, G_feat, idx, val, cfg: NMFConfig,
                                fc, X_warm, target=None, axis=NO_AXIS):
    """MSE masked solve via gathered per-column Gram downdates.

    ``B_full`` (k, n) = F @ (train .* A), one dense product; ``G_feat``
    (k, k) = full Gram + ridge/L2/tier-2/target-diag; ``idx``/``val`` (T, n)
    = excluded-row indices + validity per column.  Equivalent to
    :func:`masked_mse_solve_batch` for 0/1 train weights, with about
    inv_prob times fewer operations (see linalg.gathered_gram_downdate).
    ``axis``: under a mesh, the axis F's columns are split over (``B_full``
    and ``G_feat`` are summed over it already); the downdates are summed
    over it.
    """
    k, n = B_full.shape
    T = idx.shape[0]
    bc = max(8, min(n, int(1.2e8 / max(k * max(T, 1), 1))))
    eye = torch.eye(k, dtype=B_full.dtype, device=B_full.device)

    def solve_block(lo: int, hi: int):
        b = B_full[:, lo:hi]
        dd = linalg.gathered_gram_downdate(F, idx[:, lo:hi], val[:, lo:hi])
        Gb = G_feat[None] - axis.sum(dd)
        if target is not None:
            b = b + fc.target_lambda * target[:, lo:hi]
        return _solve_block(Gb, b, cfg, fc, X_warm[:, lo:hi], eye)

    blocks = [solve_block(lo, min(lo + bc, n)) for lo in range(0, n, bc)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _excl_indices(train_w: torch.Tensor, t_max: int):
    """Excluded-row indices + validity per column, (T, n) each.

    A stable argsort puts the excluded rows (train weight 0) first in
    ascending row order; computed once per fit (the mask does not change
    between iterations)."""
    excl = train_w == 0
    order = torch.argsort((~excl).to(torch.int8), dim=0, stable=True)[:t_max]
    val = torch.gather(excl, 0, order)
    return order, val.to(train_w.dtype)


# ---------------------------------------------------------------------------
# The masks and weights of a fit (they do not change between iterations)
# ---------------------------------------------------------------------------

@dataclass
class _Weights:
    train_w: torch.Tensor        # (m, n) float32 0/1
    train_w_T: torch.Tensor      # (n, m), contiguous
    test_w: torch.Tensor         # (m, n) float32 0/1
    n_train: torch.Tensor        # 0-d
    n_test: torch.Tensor         # 0-d
    nz: Optional[torch.Tensor]   # (m, n) float32, sparse_zeros only
    zi_valid: Optional[torch.Tensor]   # (m, n) bool, ZI only


def build_weights(cfg: NMFConfig, A: torch.Tensor, masks: dict,
                  sparse_zeros: bool, is_cv: bool, ctx=None) -> _Weights:
    """Train and test weights from the speckled hash (computed on A's
    device), the optional ``user_mask`` (m, n) bool and the optional
    ``rows_ok`` / ``cols_ok`` subsample vectors.

    User-masked entries leave both train and test accounting
    (fit_cv.hpp:1391-1393): the CV test statistic stays a pure
    speckled-holdout quantity.  For a pure masked fit (no CV) the masked
    entries themselves are reported as the held-out set.  ``valid_rows`` /
    ``valid_cols`` (mesh padding): the pads leave train and test.

    ``ctx``: a sharded fit's ``ShardContext``; A and the masks are this
    rank's block, the holdout is hashed at the block's global offsets (bit
    for bit the whole matrix's), the counts are summed over the mesh."""
    m, n = A.shape
    f32 = torch.float32
    row0, col0 = (ctx.row0, ctx.col0) if ctx is not None else (0, 0)
    M_test = None
    if is_cv and cfg.test_fraction > 0:
        inv_prob = int(1.0 / cfg.test_fraction)
        M_test = rng_mod.is_holdout(int(np.uint32(cfg.cv_seed)), m, n,
                                    inv_prob, A.device, row0=row0, col0=col0)
        if cfg.mask_zeros:
            M_test = M_test & (A != 0)
        if "rows_ok" in masks:
            M_test = M_test & masks["rows_ok"][:, None]
        if "cols_ok" in masks:
            M_test = M_test & masks["cols_ok"][None, :]
    um = masks.get("user_mask")
    if M_test is None:
        M_test = um if um is not None else torch.zeros(
            (m, n), dtype=torch.bool, device=A.device)
        um = None
    M_excl = M_test if um is None else (M_test | um)
    if um is not None:
        M_test = M_test & (~um)
    train_ok = ~M_excl
    valid = None
    if "valid_rows" in masks:
        valid = masks["valid_rows"][:, None]
    if "valid_cols" in masks:
        vc = masks["valid_cols"][None, :]
        valid = vc if valid is None else (valid & vc)
    if valid is not None:
        M_test = M_test & valid
        train_ok = train_ok & valid
    train_w = train_ok.to(f32)
    test_w = M_test.to(f32)

    def total(x):
        return x if ctx is None else ctx.sum_all(x)

    n_test = total(test_w.sum())
    nz = None
    if sparse_zeros:
        nz = (A != 0).to(f32)
        n_train = total((nz * train_w).sum())
    else:
        n_train = total(train_w.sum())
    if is_cv and cfg.mask_zeros and cfg.requires_irls():
        # speckled CV + mask_zeros under IRLS: zeros leave the weighted
        # solves entirely (cv_detail.hpp:123-126,222-232 collect only
        # nonzero train entries); MSE keeps zeros in the Gram as the
        # reference does (compute_train_rhs + apply_gram_correction only
        # downdate holdout rows)
        train_w = train_w * (A != 0).to(f32)
        n_train = total(train_w.sum())
    # ZI accounting sees trained entries only: user-masked entries leave all
    # accounting (fit_cv.hpp:1391-1393) and held-out zeros must not inflate
    # the dropout estimates
    zi_valid = train_w > 0 if cfg.has_zi() else None
    return _Weights(train_w, train_w.T.contiguous(), test_w, n_train, n_test,
                    nz, zi_valid)


def init_cv_state(cfg: NMFConfig, A: torch.Tensor, W_T0, H0, d0,
                  disp_row0, disp_col0, zi_valid=None, ctx=None) -> CVState:
    """The state before the first iteration, on A's device (``ctx``: a
    sharded fit's ``ShardContext``; everything is this rank's block)."""
    m, n = A.shape
    dev, f32 = A.device, torch.float32

    def to_dev(x):
        # contiguous copies: a matmul's operand layout selects its kernel
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(dev)

    def scalar(v, dtype=f32):
        return torch.tensor(v, dtype=dtype, device=dev)

    if cfg.has_zi():
        pi_row0, pi_col0 = _zi_pi_init(A, cfg, valid=zi_valid, ctx=ctx)
    else:
        pi_row0 = torch.zeros((m,), dtype=f32, device=dev)
        pi_col0 = torch.zeros((n,), dtype=f32, device=dev)
    return CVState(
        W_T=to_dev(W_T0), H=to_dev(H0), d=to_dev(d0),
        disp_row=to_dev(disp_row0), disp_col=to_dev(disp_col0), it=0,
        prev_conv_loss=scalar(torch.finfo(f32).max),
        patience_ctr=scalar(0, torch.int32),
        converged=scalar(False, torch.bool),
        final_tol=scalar(float("nan")),
        train_hist=torch.full((cfg.max_iter,), float("nan"), dtype=f32,
                              device=dev),
        test_hist=torch.full((cfg.max_iter,), float("nan"), dtype=f32,
                             device=dev),
        best_test_loss=scalar(torch.finfo(f32).max),
        best_iter=scalar(0, torch.int32),
        pi_row=pi_row0, pi_col=pi_col0,
        A_imp=A if cfg.has_zi() else None)


def run_masked(cfg: NMFConfig, A: torch.Tensor, weights: _Weights, aux: dict,
               state: CVState, sparse_zeros: bool, is_cv: bool,
               t_max=None, ctx=None, masks: Optional[dict] = None) -> CVState:
    """The unified masked / CV ALS loop, from ``state`` to convergence or
    ``cfg.max_iter`` (the port of ``_fit_masked_jit``'s loop).

    ``aux`` carries optional graph Laplacians / enrichment targets, applied
    with the reference's CV feature semantics (apply_cv_features,
    fit_cv.hpp:417,581: L2 + graph + L21 on the Gram; L1 in the solver;
    enrichment targets too, which the reference drops in CV).  When
    ``is_cv``: test-loss early stopping and best-iteration tracking;
    otherwise the standard patience on the masked train loss.  ``t_max``:
    (T_h, T_w), the bounds on excluded rows per column that switch the MSE
    solves to the gathered downdate.

    ``ctx``: a sharded fit's ``ShardContext``: A, the weights and the state
    are this rank's blocks; each side's per-column Grams and RHS are summed
    over the axis its data rows are split over before the solve, the row
    norms over the factor's own axis, the losses and counts over the mesh.
    ``masks``: ``valid_rows`` / ``valid_cols`` (mesh padding) multiply the
    pad factors back to exact zeros."""
    train_w, train_w_T = weights.train_w, weights.train_w_T
    test_w, nz = weights.test_w, weights.nz
    n_train = torch.clamp_min(weights.n_train, 1.0)
    n_test = torch.clamp_min(weights.n_test, 1.0)

    is_irls = cfg.requires_irls()
    is_gp = cfg.loss == Loss.GP
    is_nb = cfg.loss == Loss.NB
    is_phi = cfg.loss in _POWER_LOSSES
    per_col = cfg.dispersion == Dispersion.PER_COL
    has_disp = cfg.dispersion != Dispersion.NONE and is_irls
    active_loss = Loss.KL if is_gp else cfg.loss
    # zero inflation rides the CV / masked loop like fit_cv.hpp: the solves
    # see the soft-imputed matrix (:434,485), the EM imputes every zero
    # (:1285-1340), losses stay on the observed A (:1388+)
    is_zi = cfg.has_zi()
    k = cfg.rank
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    counts = {"inner_iters": state.inner_iters,
              "host_syncs": state.host_syncs}
    rows = ctx.rows if ctx is not None else NO_AXIS  # W_T's columns
    cols = ctx.cols if ctx is not None else NO_AXIS  # H's columns
    masks = masks or {}
    keep_cols = keep_rows = None
    if "valid_cols" in masks:
        keep_cols = masks["valid_cols"][None, :].to(A.dtype)
    if "valid_rows" in masks:
        keep_rows = masks["valid_rows"][None, :].to(A.dtype)

    def total(x):
        return x if ctx is None else ctx.sum_all(x)

    # The W side solves on the transpose, kept contiguous (the kernels read
    # rows).  Without ZI it is made once per fit.
    A_T = None if is_zi else A.T.contiguous()

    # gathered-downdate path for the 0/1-weight MSE solves: the excluded
    # indices depend on the masks alone, so the argsort runs once per fit
    dd_h = dd_w = None
    if not is_irls and t_max is not None:
        A_train = A * train_w
        dd_h = (*_excl_indices(train_w, t_max[0]), A_train)
        dd_w = (*_excl_indices(train_w_T, t_max[1]), A_train.T.contiguous())

    def solve_side(A_side, F, w_side, fc, X_warm, it, th_row, th_col, graph,
                   target, dd, data_axis, own_axis):
        # tier-2 features from the previous iterate of the factor being
        # solved, shared by all per-column Grams (cv_detail.hpp:168,272);
        # ``data_axis``: the mesh axis A_side's rows are split over,
        # ``own_axis``: the one the solved factor's columns are split over
        G_add = feat.tier2_gram_addition(X_warm, fc, graph, own_axis)
        tgt = target if (target is not None and fc.target_lambda > 0) else None
        # warm start only after the first iteration, as the JAX package
        Xw = X_warm * float(it > 0)
        if is_irls:
            # ZI fits solve on the imputed matrix: the zeros-get-unit-weight
            # shortcut of a sparse input must not apply
            return irls_solve_batch(A_side, F, cfg, active_loss, th_row,
                                    th_col, fc, sparse_zeros and not is_zi,
                                    extra_w=w_side, X_warm=Xw, G_add=G_add,
                                    target=tgt, counts=counts, axis=data_axis)
        if dd is not None:
            idxs, vals, A_tr = dd
            G_feat = linalg.gram(F, data_axis) + fc.L2 * eye  # adds the 1e-15
            if G_add is not None:
                G_feat = G_feat + G_add
            if tgt is not None:
                G_feat = G_feat + fc.target_lambda * eye
            B_full = data_axis.sum(F @ A_tr)
            return masked_downdate_solve_batch(B_full, F, G_feat, idxs,
                                               vals, cfg, fc, Xw, target=tgt,
                                               axis=data_axis)
        return masked_mse_solve_batch(A_side, F, w_side, cfg, fc, Xw,
                                      G_add=G_add, target=tgt,
                                      axis=data_axis)

    W_T, H, d, it = state.W_T, state.H, state.d, state.it
    disp_row, disp_col = state.disp_row, state.disp_col
    pi_row, pi_col, A_imp = state.pi_row, state.pi_col, state.A_imp
    prev_conv_loss, patience_ctr = state.prev_conv_loss, state.patience_ctr
    converged, final_tol = state.converged, state.final_tol
    best_test, best_iter = state.best_test_loss, state.best_iter
    train_hist, test_hist = state.train_hist.clone(), state.test_hist.clone()
    # a masked fit with tol == 0 cannot converge early: rel < 0 never holds
    check_each_iteration = is_cv or cfg.tol > 0

    while it < cfg.max_iter:
        # ZI: the solves see the imputed matrix from iteration 1 on
        A_solve = A_imp if is_zi else A
        A_solve_T = A_solve.T.contiguous() if is_zi else A_T

        th_row = disp_row if (is_nb and not per_col) else None
        th_col = disp_col if (is_nb and per_col) else None
        H_new = solve_side(A_solve, W_T, train_w, cfg.H, H, it, th_row,
                           th_col, aux.get("graph_H"), aux.get("target_H"),
                           dd_h, rows, cols)
        H_new = _posthoc(H_new, cfg.H, cols)
        if keep_cols is not None:
            # mesh padding: the fully excluded pad columns stay exact zeros
            H_new = H_new * keep_cols
        H, d = linalg.extract_scaling(H_new, cfg.norm, cols)

        th_row_w = disp_col if (is_nb and per_col) else None
        th_col_w = disp_row if (is_nb and not per_col) else None
        W_new = solve_side(A_solve_T, H, train_w_T, cfg.W, W_T, it, th_row_w,
                           th_col_w, aux.get("graph_W"), aux.get("target_W"),
                           dd_w, cols, rows)
        W_new = _posthoc(W_new, cfg.W, rows)
        if keep_rows is not None:
            W_new = W_new * keep_rows
        W_T, d = linalg.extract_scaling(W_new, cfg.norm, rows)

        # --- dispersion updates on train entries only ---
        W_Td = W_T * d[:, None]
        rec = W_Td.T @ H
        S = torch.clamp_min(rec, 1e-10)
        if has_disp and (is_gp or is_nb or is_phi):
            A_train, S_train = A * train_w, S * train_w
            axis = 0 if per_col else 1
            if is_gp:
                disp = gp_theta_update(A_train, S_train,
                                       disp_col if per_col else disp_row,
                                       cfg, axis, ctx)
            elif is_nb:
                disp = nb_size_update(A_train, S_train, cfg, axis, ctx)
            else:
                disp = phi_update(A_train, S_train, cfg, axis, ctx)
            if per_col:
                disp_col = disp
            else:
                disp_row = disp

        # --- ZI EM + soft imputation (fit_cv.hpp:1285-1340) ---
        if is_zi:
            for _ in range(max(1, cfg.zi_em_iters)):
                pi_row, pi_col, A_imp = zi_em_step(
                    A, S, cfg, disp_row, pi_row, pi_col,
                    valid=weights.zi_valid,
                    disp_col=disp_col if per_col else None, ctx=ctx)
            if cfg.theta_min > 0 and is_gp:
                disp_row = torch.clamp_min(disp_row, cfg.theta_min)
                disp_col = torch.clamp_min(disp_col, cfg.theta_min)

        # --- per-entry train / test losses (fit_cv.hpp:1368-1548) ---
        theta = losses._expand_theta(None if per_col else disp_row,
                                     disp_col if per_col else None, A)
        contrib = losses.compute_loss_elements(A, rec, cfg, theta)
        train_contrib = contrib * train_w
        if sparse_zeros:
            train_contrib = train_contrib * nz
        train_loss = total(train_contrib.sum()) / n_train
        test_loss = total((contrib * test_w).sum()) / n_test

        conv_loss = test_loss if is_cv else train_loss
        rel = (prev_conv_loss - conv_loss).abs() / (prev_conv_loss.abs()
                                                    + 1e-15)
        if it > 0:
            final_tol = rel
        if is_cv:
            improved = test_loss < best_test
            best_test = torch.where(improved, test_loss, best_test)
            best_iter = torch.where(improved, torch.full_like(best_iter, it),
                                    best_iter)
            patience_ctr = torch.where(improved,
                                       torch.zeros_like(patience_ctr),
                                       patience_ctr + 1)
            converged = patience_ctr >= cfg.cv_patience
            if it > 0:
                converged = converged | (rel < cfg.tol)
        else:
            loss_conv = (rel < cfg.tol) & (it > 0)
            patience_ctr = torch.where(loss_conv, patience_ctr + 1,
                                       torch.zeros_like(patience_ctr))
            converged = patience_ctr >= cfg.patience
        train_hist[it] = train_loss            # in place: no sync
        test_hist[it] = test_loss
        prev_conv_loss = conv_loss
        it += 1
        if check_each_iteration:
            counts["host_syncs"] += 1
            if bool(converged):
                break
    return CVState(W_T, H, d, disp_row, disp_col, it, prev_conv_loss,
                   patience_ctr, converged, final_tol, train_hist, test_hist,
                   best_test, best_iter, pi_row, pi_col, A_imp,
                   counts["inner_iters"], counts["host_syncs"])


def build_speckled_mask(cfg: NMFConfig, A: np.ndarray) -> np.ndarray:
    """Dense holdout mask on the host from the lazy speckled hash
    (speckled_cv.hpp:58-130): what the fit builds on its device.

    inv_prob = floor(1/test_fraction); seed = uint32(cv_seed), 0 -> 12345.
    mask_zeros restricts eligibility to nonzero entries.
    """
    m, n = A.shape
    inv_prob = int(1.0 / cfg.test_fraction) if cfg.test_fraction > 0 else 0
    seed = int(np.uint32(cfg.cv_seed))
    mask = rng_mod.holdout_mask(seed, m, n, inv_prob)
    if cfg.mask_zeros:
        mask &= (np.asarray(A) != 0)
    # row/col subsampling (speckled_cv.hpp:67-104)
    if cfg.cv_row_subsample < 1.0:
        mask &= rng_mod.subsample_mask_1d(
            seed, m, cfg.cv_row_subsample, use_col_constant=False)[:, None]
    if cfg.cv_col_subsample < 1.0:
        mask &= rng_mod.subsample_mask_1d(
            seed, n, cfg.cv_col_subsample, use_col_constant=True)[None, :]
    return mask


def _downdate_bounds(cfg: NMFConfig, m: int, n: int, user_mask, is_cv: bool,
                     pads=(0, 0)):
    """(T_h, T_w), the most excluded rows a column of A and of A^T can have:
    an 8-sigma binomial tail of the holdout plus the exact user-mask counts
    (plus ``pads``, the mesh padding of each dimension, which is excluded
    too); None when either exceeds half the dimension (the downdate then
    saves nothing)."""
    def cv_bound(dim):
        if not (is_cv and cfg.test_fraction > 0):
            return 0
        # the holdout draws with probability 1/int(1/f), which exceeds f when
        # 1/f is not an integer: bounding with the raw fraction would
        # truncate _excl_indices and leave held-out entries in the Gram
        p = 1.0 / int(1.0 / cfg.test_fraction)
        mean = dim * p
        return int(math.ceil(mean + 8.0 * math.sqrt(max(mean, 1.0))))

    um_col_max = um_row_max = 0
    if user_mask is not None:
        um_col_max = int(user_mask.sum(dim=0).max())
        um_row_max = int(user_mask.sum(dim=1).max())
    t_h = min(m, cv_bound(m) + um_col_max + pads[0])
    t_w = min(n, cv_bound(n) + um_row_max + pads[1])
    if t_h <= m // 2 and t_w <= n // 2:
        return t_h, t_w
    return None


def fit_cv_or_masked(A, cfg: NMFConfig, *, mask=None, aux=None, w_init=None,
                     h_init=None, sparse_zeros: bool = False, mesh=None,
                     use_downdate: bool = False, device=None) -> NMFResult:
    """Host entry point: CV holdout (computed on the device), user mask, or
    both.

    ``A``: an (m, n) numpy array or tensor; ``mask``: optional (m, n)
    boolean array, scipy sparse matrix or tensor, True where an entry is
    missing.  ``device``: where the fit runs, as in ``nmf_fit`` (the CUDA
    card for a host array unless ``device="cpu"``).  ``use_downdate``
    switches the MSE solves to the gathered Gram downdate when the masks are
    sparse enough (opt-in, as in the JAX package).

    ``mesh``: a ``parallel.mesh.Mesh``; every rank calls this with the same
    arguments, fits its (rows, cols) block of A (zero-padded to divide the
    mesh; the pads leave train and test) and returns the whole result.  The
    holdout of each block is hashed at its global offsets, so no mask
    travels; ``device=``, when given, must be the rank's device."""
    cfg.validate()
    if np.ndim(A) != 2:
        raise ValueError("data must be a 2-D matrix")
    m, n = A.shape
    is_cv = cfg.is_cv()
    ctx = None
    if mesh is not None:
        from ..parallel.mesh import ShardContext, rank_device, shard_aux
        dev = rank_device(mesh, device)
        ctx = ShardContext(mesh, m, n)
    else:
        dev = fit_device(A, device)
    set_fp32_precision()
    # the whole matrix goes to the device only where something reads it
    # whole: a fit on one device, or the SVD seeding
    A_full = (device_matrix(A, dev) if ctx is None or cfg.init_mode in (1, 2)
              else None)
    A_dev = A_full if ctx is None else ctx.block(A, dev)

    def rows_part(v):
        return v if ctx is None else _pad_part(v, ctx.row0, ctx.m_blk, m)

    def cols_part(v):
        return v if ctx is None else _pad_part(v, ctx.col0, ctx.n_blk, n)

    masks = {}
    if mask is not None:
        if hasattr(mask, "todense"):
            mask = np.asarray(mask.todense())
        if np.shape(mask) != (m, n):
            raise ValueError(f"mask has shape {tuple(np.shape(mask))}, data "
                             f"{(m, n)}")
        if ctx is not None:
            masks["user_mask"] = ctx.block(mask, dev) > 0
        elif isinstance(mask, torch.Tensor):
            masks["user_mask"] = mask.to(device=dev, dtype=torch.bool)
        else:
            masks["user_mask"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(mask).astype(bool))).to(dev)
    seed32 = int(np.uint32(cfg.cv_seed))
    if is_cv and cfg.cv_row_subsample < 1.0:
        masks["rows_ok"] = rows_part(torch.from_numpy(
            rng_mod.subsample_mask_1d(seed32, m, cfg.cv_row_subsample,
                                      use_col_constant=False)).to(dev))
    if is_cv and cfg.cv_col_subsample < 1.0:
        masks["cols_ok"] = cols_part(torch.from_numpy(
            rng_mod.subsample_mask_1d(seed32, n, cfg.cv_col_subsample,
                                      use_col_constant=True)).to(dev))
    if ctx is not None and (ctx.M, ctx.N) != (m, n):
        # pads leave train and test; their factors are multiplied to zero
        if ctx.M != m:
            masks["valid_rows"] = torch.arange(ctx.m_blk, device=dev) < ctx.vm
        if ctx.N != n:
            masks["valid_cols"] = torch.arange(ctx.n_blk, device=dev) < ctx.vn

    if ctx is None:
        aux_dev = {key: (val if isinstance(val, torch.Tensor) else
                         torch.as_tensor(np.asarray(val, np.float32))
                         ).to(dev, torch.float32)
                   for key, val in (aux or {}).items()
                   if val is not None and not key.endswith("_gram")}
    else:
        # Laplacians zero-padded (zero cross-terms), targets cut to blocks
        aux_dev = shard_aux(ctx, {key: val for key, val in (aux or {}).items()
                                  if not key.endswith("_gram")}, dev,
                            symmetric=cfg.symmetric)
    W_T0, H0, d0 = init_factors(cfg, m, n, A=A_full, w_init=w_init,
                                h_init=h_init)
    mb, nb = A_dev.shape
    disp_row0, disp_col0 = _init_dispersion(cfg, mb, nb, np.float32)
    if ctx is not None:
        W_T0, H0 = ctx.row_block(W_T0), ctx.col_block(H0)

    weights = build_weights(cfg, A_dev, masks, sparse_zeros, is_cv, ctx)
    t_max = None
    if use_downdate and not cfg.requires_irls():
        if ctx is None:
            t_max = _downdate_bounds(cfg, m, n, masks.get("user_mask"), is_cv)
        else:
            # the bound is global, on the padded dimensions, from the whole
            # mask (its most masked column and row)
            um = None
            if mask is not None:
                um = (mask.cpu() if isinstance(mask, torch.Tensor)
                      else torch.from_numpy(np.asarray(mask))).to(torch.bool)
            t_max = _downdate_bounds(cfg, ctx.M, ctx.N, um, is_cv,
                                     pads=(ctx.M - m, ctx.N - n))
    init = init_cv_state(cfg, A_dev, W_T0, H0, d0, disp_row0, disp_col0,
                         zi_valid=weights.zi_valid, ctx=ctx)
    state = run_masked(cfg, A_dev, weights, aux_dev, init, sparse_zeros,
                       is_cv, t_max=t_max, ctx=ctx, masks=masks)
    return finalize_cv_result(cfg, state, ctx)


def _pad_part(v: torch.Tensor, lo: int, width: int, true: int):
    """Entries ``lo .. lo + width`` of a length-``true`` vector, padded with
    False (zeros)."""
    out = torch.zeros((width,), dtype=v.dtype, device=v.device)
    hi = min(lo + width, true)
    if hi > lo:
        out[:hi - lo] = v[lo:hi]
    return out


def finalize_cv_result(cfg: NMFConfig, state: CVState,
                       ctx=None) -> NMFResult:
    """Copy the final CVState (all but A_imp) to a host NMFResult.  ``ctx``:
    a sharded fit's ``ShardContext``: the factors and the per-row
    (per-column) vectors are gathered over "rows" ("cols") and the mesh
    padding is sliced off."""
    def host(t):
        return t.detach().cpu().numpy()

    def rows_of(v):
        if ctx is None:
            return host(v)
        return host(ctx.gather_rows(v))[..., :ctx.m]

    def cols_of(v):
        if ctx is None:
            return host(v)
        return host(ctx.gather_cols(v))[..., :ctx.n]

    it = state.it
    train_hist, test_hist = host(state.train_hist), host(state.test_hist)
    res = NMFResult(
        W=rows_of(state.W_T).T, d=host(state.d), H=cols_of(state.H),
        iterations=it, converged=bool(state.converged),
        final_tol=float(state.final_tol),
        train_loss=float(train_hist[it - 1]) if it > 0 else float("nan"),
        test_loss=float(test_hist[it - 1]) if it > 0 else float("nan"),
        best_iter=int(state.best_iter),
        loss_history=train_hist[:it], test_loss_history=test_hist[:it])
    res.misc["best_test_loss"] = float(state.best_test_loss)
    res.misc["host_syncs"] = state.host_syncs
    if cfg.requires_irls():
        res.misc["irls_inner_iterations"] = state.inner_iters
    per_col = cfg.dispersion == Dispersion.PER_COL
    disp = cols_of(state.disp_col) if per_col else rows_of(state.disp_row)
    if cfg.dispersion == Dispersion.NONE:
        pass    # dispersion='none' estimates nothing and returns nothing
    elif cfg.loss in (Loss.GP, Loss.NB):
        res.theta = disp
    elif cfg.loss in _POWER_LOSSES:
        res.dispersion = disp
    if cfg.has_zi():
        if cfg.zi == ZI.ROW:
            res.pi_row = rows_of(state.pi_row)
        else:
            res.pi_col = cols_of(state.pi_col)
    if cfg.sort_model:
        res.sort()
    return res


def cv_sweep(A, ks, *, cv_seed=0, mask=None, device=None, **kwargs):
    """Multi-rank CV sweep (R/nmf_thin.R:1013-1094).

    ``cv_seed`` may be an int or a list (each entry = one CV repetition).
    Returns a list of dict rows: k, rep, train_mse, test_mse, best_iter.
    A host matrix goes to the fit's device once for all fits.
    """
    from ..api import build_config

    seeds = [cv_seed] if np.isscalar(cv_seed) else list(cv_seed)
    kwargs.setdefault("test_fraction", 0.1)
    user_seed = kwargs.pop("seed", None)
    A = device_matrix(A, fit_device(A, device))
    rows = []
    for rep_idx, rep_seed in enumerate(seeds):
        for k in ks:
            # init seed derived per (rep, rank) as in R/nmf_thin.R:1023
            base = int(user_seed) if user_seed is not None else int(rep_seed)
            init_seed = (base + int(k)) % (2**31 - 1)
            cfg = build_config(int(k), cv_seed=int(rep_seed),
                               seed=init_seed, **kwargs)
            res = fit_cv_or_masked(A, cfg, mask=mask)
            rows.append({
                "k": int(k), "rep": rep_idx + 1,
                "train_mse": res.train_loss, "test_mse": res.test_loss,
                "best_test_loss": res.misc["best_test_loss"],
                "best_iter": res.best_iter, "iterations": res.iterations,
                # distribution columns: NaN for MSE
                "mean_theta": (float(np.mean(res.theta))
                               if res.theta is not None else float("nan")),
                "mean_dispersion": (float(np.mean(res.dispersion))
                                    if res.dispersion is not None
                                    else float("nan")),
            })
    return rows
