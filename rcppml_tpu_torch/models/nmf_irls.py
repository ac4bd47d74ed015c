"""IRLS-distribution NMF: KL / GP / NB / Gamma / InvGauss / Tweedie / robust,
with zero inflation.

The port of ``rcppml_tpu/models/nmf_irls.py``:

  * per-column weighted NNLS (primitives/cpu/nnls_batch_irls.hpp) as a
    column-blocked batched solve: elementwise weight pass -> per-column
    weighted Gram -> batched CD solve with one Gram per column
    (:func:`irls_solve_batch`);
  * GP theta MM update (nmf/fit_cpu.hpp:914-1086, Ohashi et al. 2025 Eq. 24,
    5 inner MM iterations), NB size MoM (fit_cpu.hpp:1094-1265), ZI EM with
    soft imputation (fit_cpu.hpp:1285-1552), Gamma/IG/Tweedie Pearson phi
    (fit_cpu.hpp:1561-1672): masked reductions over the dense residual field.

GP W/H updates use KL weights (same fixed point, stable) and theta is
estimated separately (fit_cpu.hpp:569-575).  Sparse-input semantics (zeros get
unit weight, nnls_batch_irls.hpp:176-186) are a mask on the dense matrix.

Where the JAX package runs two ``lax.while_loop``s and a ``lax.map`` over
column blocks, this is Python loops over tensors that stay on the fit's
device.  The inner IRLS loop reads ``any(active)`` on the host after each
inner iteration but the last possible one, as the JAX loop's condition does;
the outer loop reads nothing per iteration when ``tol == 0``.  Everything is
float32 on every device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import Dispersion, Loss, NMFConfig, ZI
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..ops.wgram import weighted_gram_rhs
from ..parallel.mesh import NO_AXIS
from ..result import NMFResult
from .nmf import FitState, _wait, finalize_result, init_fit_state


@dataclass
class IRLSState:
    W_T: torch.Tensor
    H: torch.Tensor
    d: torch.Tensor
    disp_row: torch.Tensor     # theta / r / phi indexed by rows of A (m,)
    disp_col: torch.Tensor     # the same indexed by columns (n,) (PER_COL)
    pi_row: torch.Tensor       # (m,) ZI dropout
    pi_col: torch.Tensor       # (n,)
    A_imp: torch.Tensor        # (m, n) soft-imputed data (is A when no ZI)
    it: int                    # completed iterations (counted on the host)
    prev_loss: torch.Tensor    # 0-d
    patience_ctr: torch.Tensor  # 0-d int32
    converged: torch.Tensor    # 0-d bool
    final_tol: torch.Tensor    # 0-d
    loss_hist: torch.Tensor    # (max_iter,), NaN-padded
    inner_iters: int = 0       # IRLS inner iterations run so far (= CD solves)
    host_syncs: int = 0        # host reads of any(active) / converged so far


def _block_count(n: int, k: int, m: int, budget_floats: float = 1.2e8,
                 kr: bool = False) -> int:
    """Column block size for the weighted-Gram solve: bound the (BC, k, m)
    intermediate to about ``budget_floats``.  With the Khatri-Rao Gram
    (``kr``) that intermediate does not exist, but each block still holds the
    (m, BC) data panel and weight block plus the (BC, k^2) Gram: about
    2m + 2k^2 floats per column."""
    if kr:
        bc = max(8, int(budget_floats / max(2 * m + 2 * k * k, 1)))
    else:
        bc = max(8, int(budget_floats / max(k * m, 1)))
    return min(bc, n)


def _use_kr(k: int, m: int) -> bool:
    """Whether the Khatri-Rao Gram formulation applies (the operand fits)."""
    return k * k * m <= linalg.KR_BUDGET_FLOATS


_POWER_LOSSES = (Loss.GAMMA, Loss.INVGAUSS, Loss.TWEEDIE)


def _fused_kind(active_loss: Loss) -> Optional[str]:
    """The fused kernel's ``loss_kind`` for a loss, or None."""
    if active_loss == Loss.KL:
        return "kl"
    if active_loss == Loss.NB:
        return "nb"
    if active_loss in _POWER_LOSSES:
        return "power"
    return None


def _power(cfg: NMFConfig, loss: Loss) -> float:
    return (2.0 if loss == Loss.GAMMA else 3.0 if loss == Loss.INVGAUSS
            else float(cfg.tweedie_power))


def irls_solve_batch(A_data, F, cfg: NMFConfig, active_loss: Loss,
                     theta_row, theta_col, fc, sparse_zeros: bool,
                     extra_w=None, X_warm=None, G_add=None, target=None,
                     counts: Optional[dict] = None, axis=NO_AXIS):
    """Solve min over X>=0 of the weighted LS for every column of A_data.

    A_data (m, nc) data panel; F (k, m) fixed factor.  Returns X (k, nc).
    The IRLS loop reweights -> solves -> converges on the per-column relative
    max change < ``irls_tol`` (nnls_batch_irls.hpp:320-328).  ``X_warm`` (the
    previous ALS iteration's factor) seeds the loop, as in the JAX package.

    ``G_add``: optional shared k x k tier-2 term (graph reg + L21) added to
    every per-column weighted Gram.  ``target``: optional (k, nc) enrichment
    target, ``fc.target_lambda > 0``.  ``extra_w``: optional (m, nc) weights
    multiplied into w (the CV path's holdout weights).  ``counts``: optional
    dict; ``inner_iters`` and ``host_syncs`` in it are increased.
    ``axis``: under a mesh, the axis A_data's rows (F's columns) are split
    over: each column's weighted Gram and RHS are summed over it before the
    solve, so every rank of the axis solves the same columns alike.

    With ``RCPPML_FUSED_WGRAM`` set in the environment, the weight, Gram and
    RHS of a ``kl`` / ``power`` / ``nb`` solve without robust or extra
    weights go through :func:`weighted_gram_rhs`: the CUDA kernel for CUDA
    tensors, its plain twin (this function's default arithmetic) for CPU
    tensors.  Column blocks do not change any column's result.
    """
    k, m = F.shape
    n = A_data.shape[1]
    dtype = A_data.dtype
    dev = A_data.device
    wcfg = cfg.replace(loss=active_loss)

    use_kr = _use_kr(k, m)
    KR = linalg.kr_product(F) if use_kr else None
    bc = _block_count(n, k, m, kr=use_kr)

    kind = _fused_kind(active_loss)
    use_fused_wgram = (kind is not None
                       and bool(os.environ.get("RCPPML_FUSED_WGRAM"))
                       and cfg.robust_delta == 0 and extra_w is None
                       and not (kind == "nb" and theta_row is None
                                and theta_col is None))
    eye = torch.eye(k, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def solve_block(lo: int, hi: int):
        whole = lo == 0 and hi == n
        A_blk = A_data if whole else A_data[:, lo:hi].contiguous()
        th_col_blk = theta_col[lo:hi] if theta_col is not None else None
        if th_col_blk is not None:
            theta = th_col_blk[None, :]
        elif theta_row is not None:
            theta = theta_row[:, None]
        else:
            theta = zero
        nz = A_blk != 0 if sparse_zeros else None
        w_extra = extra_w[:, lo:hi] if extra_w is not None else None
        T_blk = target[:, lo:hi] if target is not None else None

        if X_warm is not None:
            X = X_warm[:, lo:hi].contiguous()
        else:
            X = torch.zeros((k, hi - lo), dtype=dtype, device=dev)
        active = torch.ones((hi - lo,), dtype=torch.bool, device=dev)
        for itr in range(cfg.irls_max_iter):
            if use_fused_wgram:
                nb = kind == "nb"
                Gb, b = weighted_gram_rhs(
                    F, X, A_blk,
                    theta_row if nb and th_col_blk is None else None,
                    th_col_blk if nb else None,
                    loss_kind=kind, power=_power(cfg, active_loss)
                    if kind == "power" else 0.0,
                    sparse_zeros=sparse_zeros)
            else:
                mu = F.T @ X                                      # (m, bc)
                w = losses.compute_irls_weight(A_blk, mu, wcfg, theta)
                if sparse_zeros:
                    w = torch.where(nz, w, one)
                if w_extra is not None:
                    w = w * w_extra
                Gb, b = linalg.weighted_gram_and_rhs(F, w, A_blk, KR=KR)
            Gb, b = axis.sum(Gb), axis.sum(b)
            if fc.L2 > 0:
                Gb = Gb + fc.L2 * eye[None]
            if G_add is not None:
                Gb = Gb + G_add[None]
            if T_blk is not None:
                Gb = Gb + fc.target_lambda * eye[None]
                b = b + fc.target_lambda * T_blk

            X_old = X
            B_res = b - solvers.batched_gram_matvec(Gb, X)
            X_new = solvers.cd_nnls_batched_gram(
                Gb, B_res, X, fc.L1, nonneg=fc.nonneg,
                maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)
            X = torch.where(active[None, :], X_new, X_old)
            rel = ((X - X_old).abs() / (X_old.abs() + 1e-12)).amax(dim=0)
            active = active & (rel >= cfg.irls_tol)
            if counts is not None:
                counts["inner_iters"] = counts.get("inner_iters", 0) + 1
            if itr + 1 == cfg.irls_max_iter:
                break
            if counts is not None:
                counts["host_syncs"] = counts.get("host_syncs", 0) + 1
            if not bool(active.any()):
                break
        return X

    blocks = [solve_block(lo, min(lo + bc, n)) for lo in range(0, n, bc)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


# ---------------------------------------------------------------------------
# Dispersion updates
# ---------------------------------------------------------------------------

def _expand(v: torch.Tensor, red: int) -> torch.Tensor:
    return v[:, None] if red == 1 else v[None, :]


# Under a mesh (``ctx``, a ``parallel.mesh.ShardContext``) the statistics
# below run on this rank's block: a sum over a block's columns (``red`` 1,
# statistics per row) is summed over "cols", over its rows over "rows".  A
# global statistic reads every row's (column's) value: the mean sums the
# valid ones over the other axis, the median gathers them.

def _rsum(ctx, red: int, x: torch.Tensor) -> torch.Tensor:
    if ctx is None:
        return x
    return ctx.sum_cols(x) if red == 1 else ctx.sum_rows(x)


def _entities(ctx, red: int):
    """(the axis the entities are split over, the valid ones in this block,
    the block's length, their true count) for per-row (``red`` 1) or
    per-column statistics."""
    if red == 1:
        return ctx.rows, ctx.vm, ctx.m_blk, ctx.m
    return ctx.cols, ctx.vn, ctx.n_blk, ctx.n


def _global_mean(v: torch.Tensor, red: int = 1, ctx=None) -> torch.Tensor:
    """The mean of a per-row (per-column) vector over every valid entry,
    on every entry.  ``v``: this block's entries (valid ones first)."""
    if ctx is None or not ctx.distributed:
        return v.mean().expand_as(v).clone()
    axis, valid, _, total = _entities(ctx, red)
    return (axis.sum(v[:valid].sum()) / total).expand_as(v).clone()


def _global_median(v: torch.Tensor, red: int = 1, ctx=None) -> torch.Tensor:
    """The median as numpy defines it (the mean of the two middle elements
    of an even count); ``torch.median`` would return the lower one.  Under a
    mesh over the gathered valid entries of every block."""
    if ctx is not None and ctx.distributed:
        axis, valid, blk, total = _entities(ctx, red)
        part = torch.zeros((blk,), dtype=v.dtype, device=v.device)
        part[:valid] = v[:valid]
        return torch.quantile(axis.gather(part)[:total],
                              0.5).expand_as(v).clone()
    return torch.quantile(v, 0.5).expand_as(v).clone()


def gp_theta_update(A, S, theta, cfg: NMFConfig, axis: int, ctx=None):
    """MM theta update (fit_cpu.hpp:914-1086; Ohashi et al. 2025 Eq. 24).

    ``axis`` = 1 for per-row (reduce over columns), 0 for per-col.
    S = max(W_Td^T H, 1e-10) reconstruction.  ``ctx``: a sharded fit's
    ``ShardContext`` (A, S and theta are this rank's block).
    """
    red = axis
    sum_y = _rsum(ctx, red, A.sum(dim=red))
    sum_s = _rsum(ctx, red, S.sum(dim=red))
    nz = A >= 1.0
    n_nz = _rsum(ctx, red, nz.sum(dim=red).to(A.dtype))
    cap = cfg.theta_max
    zeros = torch.zeros_like(A)
    am1 = A - 1.0

    for _ in range(5):                                  # THETA_INNER_ITERS
        denom = torch.clamp_min(S + _expand(theta, red) * A, 1e-10)
        eta1 = S / denom
        alpha_d = _rsum(ctx, red, torch.where(nz, am1 * eta1,
                                              zeros).sum(dim=red))
        gamma_d = _rsum(ctx, red, torch.where(nz, am1 * (1.0 - eta1),
                                              zeros).sum(dim=red))
        alpha = alpha_d + n_nz
        beta = (sum_y - sum_s) - gamma_d + alpha
        disc = beta * beta + 4.0 * alpha * gamma_d
        ok = (alpha > 1e-15) & (disc > 0) & torch.isfinite(disc)
        new_th = ((-beta + torch.sqrt(torch.clamp_min(disc, 0.0)))
                  / torch.clamp_min(2.0 * alpha, 1e-30))
        ok = ok & torch.isfinite(new_th) & (new_th >= 0)
        theta = torch.where(ok, torch.clamp_max(new_th, cap), theta)
    if cfg.dispersion == Dispersion.GLOBAL:
        theta = _global_mean(theta, red, ctx)
    return theta


def nb_size_update(A, S, cfg: NMFConfig, axis: int, ctx=None):
    """NB size MoM: r = sum mu^2 / max(sum[(y-mu)^2 - mu], eps)
    (fit_cpu.hpp:1094-1265).  GLOBAL mode takes the median."""
    red = axis
    mu = torch.clamp_min(S, 1e-10)
    resid = A - mu
    sum_mu_sq = _rsum(ctx, red, (mu * mu).sum(dim=red))
    sum_excess = _rsum(ctx, red, (resid * resid - mu).sum(dim=red))
    r_new = sum_mu_sq / torch.clamp_min(sum_excess, 1e-30)
    r_new = torch.clamp(r_new, cfg.nb_size_min, cfg.nb_size_max)
    ok = (sum_excess > 1e-10) & (sum_mu_sq > 1e-10) & torch.isfinite(r_new)
    r = torch.where(ok, r_new, torch.full_like(r_new, cfg.nb_size_max))
    if cfg.dispersion == Dispersion.GLOBAL:
        r = _global_median(r, red, ctx)
    return r


def phi_update(A, S, cfg: NMFConfig, axis: int, ctx=None):
    """Pearson MoM dispersion for Gamma/IG/Tweedie (fit_cpu.hpp:1561-1672).
    Only entries with y > 0 contribute."""
    red = axis
    p = _power(cfg, cfg.loss)
    mu = torch.clamp_min(S, 1e-10)
    pos = A > 0
    v_mu = torch.clamp_min(mu ** p, 1e-20)
    pear = torch.where(pos, (A - mu) ** 2 / v_mu, torch.zeros_like(mu))
    cnt = _rsum(ctx, red, pos.sum(dim=red).to(A.dtype))
    phi_new = _rsum(ctx, red, pear.sum(dim=red)) / torch.clamp_min(cnt, 1.0)
    phi_new = torch.clamp(phi_new, cfg.gamma_phi_min, cfg.gamma_phi_max)
    phi = torch.where((cnt > 0) & torch.isfinite(phi_new), phi_new,
                      torch.ones_like(phi_new))
    if cfg.dispersion == Dispersion.GLOBAL:
        phi = _global_median(phi, red, ctx)
    return phi


def zi_em_step(A, S, cfg: NMFConfig, disp_row, pi_row, pi_col, valid=None,
               disp_col=None, ctx=None):
    """ZI E/M-step + soft imputation (fit_cpu.hpp:1285-1552).

    Returns (pi_row, pi_col, A_imputed): zero entries of A are imputed with
    z_ij * mu_ij, the rest stays.  ``valid``: optional (m, n) bool of the
    entries that count (unobserved ones leave the zero counts and the pi
    denominators; the CV path uses it).  ``disp_col``: the fitted per-column
    dispersion when ``dispersion='per_col'``; without it the dropout prior
    p0 would come from the row dispersion, which that mode never updates.
    ``ctx``: a sharded fit's ``ShardContext`` (every tensor is this rank's
    block; the counts and denominators are summed over the mesh)."""
    m, n = A.shape
    if ctx is not None:
        m, n = ctx.m, ctx.n
    is_zero = A == 0
    if valid is not None:
        is_zero = is_zero & valid
    s = torch.clamp_min(S, 1e-10)
    disp = disp_col[None, :] if disp_col is not None else disp_row[:, None]
    if cfg.loss == Loss.NB:
        r = torch.clamp_min(disp, 1e-10)
        p0 = (r / (r + s)) ** r
    else:  # GP
        p0 = torch.exp(-s / (1.0 + disp))

    pi = pi_row[:, None] if cfg.zi == ZI.ROW else pi_col[None, :]
    z = pi / (pi + (1.0 - pi) * p0 + 1e-30)
    z = torch.where(is_zero, z, torch.zeros_like(z))

    if cfg.zi == ZI.ROW:
        zero_cnt = _rsum(ctx, 1, is_zero.sum(dim=1))
        denom = (torch.clamp_min(_rsum(ctx, 1, valid.sum(dim=1)), 1)
                 if valid is not None else n)
        new_pi = torch.clamp(_rsum(ctx, 1, z.sum(dim=1)) / denom, 0.001,
                             0.999)
        pi_row = torch.where(zero_cnt > 0, new_pi, pi_row)
    else:
        zero_cnt = _rsum(ctx, 0, is_zero.sum(dim=0))
        denom = (torch.clamp_min(_rsum(ctx, 0, valid.sum(dim=0)), 1)
                 if valid is not None else m)
        new_pi = torch.clamp(_rsum(ctx, 0, z.sum(dim=0)) / denom, 0.001,
                             0.999)
        pi_col = torch.where(zero_cnt > 0, new_pi, pi_col)

    A_imp = torch.where(is_zero, z * s, A)
    return pi_row, pi_col, A_imp


# ---------------------------------------------------------------------------
# Main IRLS ALS loop
# ---------------------------------------------------------------------------

def _init_dispersion(cfg: NMFConfig, m: int, n: int, dtype=np.float32):
    """Initial dispersion vectors on the host (fit_cpu.hpp:289-347)."""
    loss = cfg.loss
    if loss == Loss.GP:
        init = cfg.theta_init if cfg.dispersion != Dispersion.NONE else 0.0
    elif loss == Loss.NB:
        init = (cfg.nb_size_init if cfg.dispersion != Dispersion.NONE
                else cfg.nb_size_max)
    elif loss in _POWER_LOSSES:
        init = cfg.gamma_phi_init if cfg.dispersion != Dispersion.NONE else 1.0
    else:
        init = 0.0
    return np.full((m,), init, dtype), np.full((n,), init, dtype)


def _zi_pi_init(A: torch.Tensor, cfg: NMFConfig, valid=None, ctx=None):
    """Data-driven pi init: min(zero_rate * 0.5, 0.3) (fit_cpu.hpp:355-400),
    computed on A's device.  ``valid``: optional (m, n) bool; entries outside
    it leave the zero rate's numerator and denominator.  ``ctx``: a sharded
    fit's ``ShardContext`` (A and valid are this rank's block)."""
    m, n = A.shape
    tm, tn = (m, n) if ctx is None else (ctx.m, ctx.n)
    f32 = torch.float32
    pi_row = torch.zeros((m,), dtype=f32, device=A.device)
    pi_col = torch.zeros((n,), dtype=f32, device=A.device)
    nzm = (A != 0).to(f32)
    if valid is not None:
        v = valid.to(f32)
        nzm = nzm * v
    if cfg.zi == ZI.ROW:
        denom = (torch.clamp_min(_rsum(ctx, 1, v.sum(dim=1)), 1.0)
                 if valid is not None else float(tn))
        zr = 1.0 - _rsum(ctx, 1, nzm.sum(dim=1)) / denom
        pi_row = torch.clamp_max(zr * 0.5, 0.3).to(f32)
    elif cfg.zi == ZI.COL:
        denom = (torch.clamp_min(_rsum(ctx, 0, v.sum(dim=0)), 1.0)
                 if valid is not None else float(tm))
        zr = 1.0 - _rsum(ctx, 0, nzm.sum(dim=0)) / denom
        pi_col = torch.clamp_max(zr * 0.5, 0.3).to(f32)
    return pi_row, pi_col


def _init_irls_state(A_dev: torch.Tensor, cfg: NMFConfig, W_T0, H0,
                     d0, ctx=None) -> IRLSState:
    """The state before the first iteration, on A's device (dispersion and
    ZI priors included).  ``ctx``: the ``ShardContext`` of a sharded fit or
    of a zero-padded A; the pads leave the zero rates of the ZI prior."""
    m, n = A_dev.shape
    dev = A_dev.device
    base = init_fit_state(cfg, W_T0, H0, d0, device=dev)
    disp_row0, disp_col0 = _init_dispersion(cfg, m, n)
    if cfg.has_zi():
        vmask = None
        if ctx is not None and (ctx.M, ctx.N) != (ctx.m, ctx.n):
            vmask = ((torch.arange(m, device=dev) < ctx.vm)[:, None]
                     & (torch.arange(n, device=dev) < ctx.vn)[None, :])
        pi_row0, pi_col0 = _zi_pi_init(A_dev, cfg, valid=vmask, ctx=ctx)
    else:
        pi_row0 = torch.zeros((m,), dtype=torch.float32, device=dev)
        pi_col0 = torch.zeros((n,), dtype=torch.float32, device=dev)
    return IRLSState(
        W_T=base.W_T, H=base.H, d=base.d,
        disp_row=torch.from_numpy(disp_row0).to(dev),
        disp_col=torch.from_numpy(disp_col0).to(dev),
        pi_row=pi_row0, pi_col=pi_col0, A_imp=A_dev, it=0,
        prev_loss=base.prev_loss, patience_ctr=base.patience_ctr,
        converged=base.converged, final_tol=base.final_tol,
        loss_hist=base.loss_hist)


def _posthoc(X, fc, axis=NO_AXIS):
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    if fc.angular > 0:
        X = feat.apply_angular_posthoc(X, fc.angular, axis)
    return X


def _keep_pads(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """A per-row (per-column) vector computed on the valid entries, its pad
    entries left as they were (finite: they meet only zero factors)."""
    if new.shape[0] == old.shape[0]:
        return new
    return torch.cat([new, old[new.shape[0]:]])


def run_irls(cfg: NMFConfig, A: torch.Tensor, aux: dict, state: IRLSState,
             sparse_zeros: bool, seg_end: Optional[int] = None,
             ctx=None) -> IRLSState:
    """Run the IRLS ALS loop from ``state`` to convergence or
    ``cfg.max_iter`` (the port of ``_fit_irls_jit``).  With ``seg_end`` the
    loop stops after that many iterations in all, and a later call carries
    on from the returned state, the same trajectory bit for bit.

    ``ctx``: a ``parallel.mesh.ShardContext``.  Under a mesh A and the state
    are this rank's blocks: the per-column weighted Grams sum over the
    sharded axis before the solves, the row norms over theirs, the
    dispersion, ZI and loss sums over the mesh.  With padding (a mesh, or
    one device's zero-padded A) the accounting (loss, dispersion, ZI) runs
    on the valid region only, and the solves on the padded shapes (pads
    solve to exact zeros)."""
    is_gp = cfg.loss == Loss.GP
    is_nb = cfg.loss == Loss.NB
    is_phi = cfg.loss in _POWER_LOSSES
    per_col = cfg.dispersion == Dispersion.PER_COL
    has_disp = cfg.dispersion != Dispersion.NONE
    is_zi = cfg.has_zi()
    # GP strategy: W/H updates use KL weights; theta estimated separately
    # (fit_cpu.hpp:569-575).  NB uses NB weights directly.
    active_loss = Loss.KL if is_gp else cfg.loss
    solve_sparse = sparse_zeros and not is_zi
    rows = ctx.rows if ctx is not None else NO_AXIS
    cols = ctx.cols if ctx is not None else NO_AXIS
    padded = ctx is not None and ctx.padded
    vm, vn = (ctx.vm, ctx.vn) if padded else A.shape

    def _t(X):
        return X[:vm, :vn] if padded else X

    tgt_h = aux.get("target_H") if cfg.H.target_lambda > 0 else None
    tgt_w = aux.get("target_W") if cfg.W.target_lambda > 0 else None
    graph_H, graph_W = aux.get("graph_H"), aux.get("graph_W")

    W_T, H, d, it = state.W_T, state.H, state.d, state.it
    disp_row, disp_col = state.disp_row, state.disp_col
    pi_row, pi_col, A_imp = state.pi_row, state.pi_col, state.A_imp
    prev_loss, patience_ctr = state.prev_loss, state.patience_ctr
    converged, final_tol = state.converged, state.final_tol
    loss_hist = state.loss_hist.clone()
    counts = {"inner_iters": state.inner_iters,
              "host_syncs": state.host_syncs}
    # The W side solves on the transpose.  It is kept contiguous: the layout
    # of a product's operand selects its kernel, and with it the rounding,
    # and the fused kernel reads rows.  Without ZI it is made once per fit.
    A_T = None if is_zi else A.T.contiguous()
    A_t = _t(A)
    check_each_iteration = cfg.tol > 0
    bound = cfg.max_iter if seg_end is None else min(seg_end, cfg.max_iter)

    while it < bound:
        # data the solver sees: imputed from iter >= 1 when ZI is active
        A_solve = A_imp if is_zi else A
        A_solve_T = A_solve.T.contiguous() if is_zi else A_T

        # NB theta plumbing for the solves (fit_cpu.hpp:595-612)
        th_row = disp_row if (is_nb and not per_col) else None
        th_col = disp_col if (is_nb and per_col) else None

        # --- H update (warm-started from the previous iteration's H) ---
        warm_gate = float(it > 0)
        H_new = irls_solve_batch(
            A_solve, W_T, cfg, active_loss, th_row, th_col, cfg.H,
            solve_sparse, X_warm=H * warm_gate,
            G_add=feat.tier2_gram_addition(H, cfg.H, graph_H, cols),
            target=tgt_h, counts=counts, axis=rows)
        H, d = linalg.extract_scaling(_posthoc(H_new, cfg.H, cols),
                                      cfg.norm, cols)

        # --- W update (on A^T; theta roles swap: fit_cpu.hpp:821-833) ---
        th_row_w = disp_col if (is_nb and per_col) else None
        th_col_w = disp_row if (is_nb and not per_col) else None
        W_new = irls_solve_batch(
            A_solve_T, H, cfg, active_loss, th_row_w, th_col_w, cfg.W,
            solve_sparse, X_warm=W_T * warm_gate,
            G_add=feat.tier2_gram_addition(W_T, cfg.W, graph_W, rows),
            target=tgt_w, counts=counts, axis=cols)
        W_T, d = linalg.extract_scaling(_posthoc(W_new, cfg.W, rows),
                                        cfg.norm, rows)

        # --- dispersion updates on the reconstruction S ---
        W_Td = W_T * d[:, None]
        S_t = _t(torch.clamp_min(W_Td.T @ H, 1e-10))
        if has_disp and (is_gp or is_nb or is_phi):
            axis = 0 if per_col else 1
            if is_gp:
                disp = gp_theta_update(
                    A_t, S_t, disp_col[:vn] if per_col else disp_row[:vm],
                    cfg, axis, ctx)
            elif is_nb:
                disp = nb_size_update(A_t, S_t, cfg, axis, ctx)
            else:
                disp = phi_update(A_t, S_t, cfg, axis, ctx)
            if per_col:
                disp_col = _keep_pads(disp, disp_col)
            else:
                disp_row = _keep_pads(disp, disp_row)

        # --- ZI EM + soft imputation (fit_cpu.hpp:1285-1552) ---
        if is_zi:
            pr, pc = pi_row[:vm], pi_col[:vn]
            for _ in range(max(1, cfg.zi_em_iters)):
                pr, pc, A_imp_t = zi_em_step(
                    A_t, S_t, cfg, disp_row[:vm], pr, pc,
                    disp_col=disp_col[:vn] if per_col else None, ctx=ctx)
            pi_row, pi_col = _keep_pads(pr, pi_row), _keep_pads(pc, pi_col)
            if padded:
                A_imp = torch.zeros_like(A)
                A_imp[:vm, :vn] = A_imp_t
            else:
                A_imp = A_imp_t
            if cfg.theta_min > 0 and is_gp:
                disp_row = torch.clamp_min(disp_row, cfg.theta_min)
                disp_col = torch.clamp_min(disp_col, cfg.theta_min)

        # --- explicit loss on the original A (fit_cpu.hpp:1690-1709) ---
        loss = losses.explicit_loss(
            A_t, W_Td[:, :vm], H[:, :vn], cfg,
            theta_row=None if per_col else disp_row[:vm],
            theta_col=disp_col[:vn] if per_col else None,
            nz_only=sparse_zeros)
        if ctx is not None:
            loss = ctx.sum_all(loss)

        rel = (prev_loss - loss).abs() / (prev_loss.abs() + 1e-15)
        loss_conv = (rel < cfg.tol) & (it > 0)
        patience_ctr = torch.where(loss_conv, patience_ctr + 1,
                                   torch.zeros_like(patience_ctr))
        converged = patience_ctr >= cfg.patience
        if it > 0:
            final_tol = rel
        loss_hist[it] = loss                  # in place: no sync
        prev_loss = loss
        it += 1
        if check_each_iteration:
            counts["host_syncs"] += 1
            if bool(converged):
                break
    return IRLSState(W_T, H, d, disp_row, disp_col, pi_row, pi_col, A_imp, it,
                     prev_loss, patience_ctr, converged, final_tol, loss_hist,
                     counts["inner_iters"], counts["host_syncs"])


def fit_irls(A_dev: torch.Tensor, cfg: NMFConfig, W_T0, H0, d0, aux,
             sparse_zeros: bool = False, valid_dims=None,
             ctx=None) -> NMFResult:
    """Entry of the IRLS path (dispatched from ``models.nmf.nmf_fit`` and
    ``parallel.mesh.fit_sharded``).

    ``A_dev``: the (m, n) float32 matrix on the fit's device; ``W_T0``,
    ``H0``, ``d0``: host arrays.  With ``cfg.enable_profiling`` the same
    loop runs in timed segments (:func:`_fit_irls_profiled`).
    ``valid_dims``: the true (m, n) when A arrives zero-padded beyond them;
    the accounting is then restricted to the valid region.  ``ctx``: a
    sharded fit's ``ShardContext`` (A and the factors are this rank's
    blocks; its valid extents take the place of ``valid_dims``)."""
    if ctx is None and valid_dims is not None:
        from ..parallel.mesh import ShardContext
        ctx = ShardContext(None, *valid_dims, padded=tuple(A_dev.shape))
    aux_dev = {key: val for key, val in (aux or {}).items()
               if val is not None and not key.endswith("_gram")}
    init = _init_irls_state(A_dev, cfg, W_T0, H0, d0, ctx)
    if cfg.enable_profiling:
        return _fit_irls_profiled(cfg, A_dev, aux_dev, init, sparse_zeros,
                                  ctx)
    return finalize_irls_result(
        cfg, run_irls(cfg, A_dev, aux_dev, init, sparse_zeros, ctx=ctx),
        ctx)


def _fit_irls_profiled(cfg: NMFConfig, A_dev: torch.Tensor, aux: dict,
                       init: IRLSState, sparse_zeros: bool,
                       ctx=None) -> NMFResult:
    """Profile the production IRLS loop (``nmf_irls.py:626-668`` of the JAX
    package): :func:`run_irls` in segments of ``max(1, min(32, maxit // 8))``
    iterations, the trajectory bit for bit the unprofiled fit's, each
    segment timed on the host clock after the device has finished it.  The
    iteration is one block (solves, dispersion, ZI), so the map has one
    section, ``irls_iteration``: the best segment's time per iteration times
    the iterations."""
    seg = max(1, min(32, cfg.max_iter // 8 or 1))
    seg_times = []          # (iterations in the segment, seconds)
    state = init
    _wait(A_dev.device)
    t_all0 = time.perf_counter()
    while state.it < cfg.max_iter and not bool(state.converged):
        it0, t0 = state.it, time.perf_counter()
        state = run_irls(cfg, A_dev, aux, state, sparse_zeros,
                         seg_end=it0 + seg, ctx=ctx)
        _wait(A_dev.device)
        state.host_syncs += 1       # the segment end's read of converged
        if state.it > it0:
            seg_times.append((state.it - it0, time.perf_counter() - t0))
    per_iter_s = min((t / k for k, t in seg_times), default=0.0)
    res = finalize_irls_result(cfg, state, ctx)
    res.profile = {
        "irls_iteration": per_iter_s * 1e3 * state.it,
        "fused_total_ms": (time.perf_counter() - t_all0) * 1e3,
        "fused_per_iter_us": per_iter_s * 1e6,
        "iterations": state.it,
        "mode": "fused-segmented",
        "section_basis": "one IRLS block per iteration (solves + "
                         "dispersion + ZI); best-segment steady state",
    }
    return res


def finalize_irls_result(cfg: NMFConfig, state: IRLSState,
                         ctx=None) -> NMFResult:
    """Copy the final IRLSState (all but A_imp) to a host NMFResult.
    ``ctx``: a sharded fit's ``ShardContext``; the per-row (per-column)
    vectors are gathered over "rows" ("cols") as the factors are."""
    def host(t):
        return t.detach().cpu().numpy()

    def rows_of(v):
        return host(v if ctx is None else ctx.gather_rows(v))

    def cols_of(v):
        return host(v if ctx is None else ctx.gather_cols(v))

    per_col = cfg.dispersion == Dispersion.PER_COL
    extra = {}
    disp = cols_of(state.disp_col) if per_col else rows_of(state.disp_row)
    # dispersion='none' estimates nothing and returns nothing
    if cfg.dispersion == Dispersion.NONE:
        pass
    elif cfg.loss in (Loss.GP, Loss.NB):
        extra["theta"] = disp
    elif cfg.loss in _POWER_LOSSES:
        extra["dispersion"] = disp
    if cfg.has_zi():
        if cfg.zi == ZI.ROW:
            extra["pi_row"] = rows_of(state.pi_row)
        else:
            extra["pi_col"] = cols_of(state.pi_col)

    fit_state = FitState(state.W_T, state.H, state.d, state.it,
                         state.prev_loss, state.patience_ctr, state.converged,
                         state.final_tol, state.loss_hist)
    res = finalize_result(cfg, fit_state, extra, ctx)
    res.misc["irls_inner_iterations"] = state.inner_iters
    res.misc["host_syncs"] = state.host_syncs
    return res
