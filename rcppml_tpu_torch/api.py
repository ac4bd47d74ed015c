"""User-facing API of the port, mirroring ``rcppml_tpu/api.py``.

``nmf(A, k, ...)`` takes a dense numpy array, a scipy sparse matrix (made
dense; standard NMF treats zeros as data) or a 2-D tensor, fits on the
``device`` it is given, and returns an :class:`NMFResult`.
:func:`build_config` is the JAX package's, whole.  Branches of the JAX API
that are not ported yet raise ``NotImplementedError`` naming their
ROADMAP.md item; none of them falls back silently.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import constants
from .config import Dispersion, FactorConfig, Loss, NMFConfig, Norm, Solver, ZI
from .models.nmf import nmf_fit, unported
from .result import NMFResult


def _pair(x, name: str):
    """Normalize scalar-or-pair args like the R API's L1 = c(w, h)."""
    if np.isscalar(x):
        return float(x), float(x)
    x = list(x)
    if len(x) == 1:
        return float(x[0]), float(x[0])
    if len(x) != 2:
        raise ValueError(f"{name} must be a scalar or a (W, H) pair")
    return float(x[0]), float(x[1])


def _is_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    return sp.issparse(data)


def _to_dense_f32(data):
    """Return a dense float32 (m, n): numpy and scipy.sparse inputs become a
    host array (NaN and Inf rejected), a tensor stays on its device."""
    if isinstance(data, torch.Tensor):
        if data.ndim != 2:
            raise ValueError("data must be a 2-D matrix")
        return data.to(torch.float32)
    if _is_sparse(data):
        arr = np.asarray(data.todense(), dtype=np.float32)
    else:
        arr = np.asarray(data, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if np.isnan(arr).any():
        # the JAX package masks NaN entries; masked fits are not ported
        raise unported("NaN entries (auto-masked fits)", "Queue 1 item 7")
    if np.isinf(arr).any():
        raise ValueError("data contains infinite values; clip or remove "
                         "them before factorization")
    return arr


def build_config(
    k: int,
    *,
    tol: float = constants.NMF_TOL,
    maxit: int = constants.NMF_MAXIT,
    L1=(0.0, 0.0),
    L2=(0.0, 0.0),
    L21=(0.0, 0.0),
    angular=(0.0, 0.0),
    upper_bound=(0.0, 0.0),
    graph_lambda=(0.0, 0.0),
    target_lambda: float = 0.0,
    seed: Union[int, str, None] = None,
    loss: str = "mse",
    nonneg=(True, True),
    test_fraction: float = 0.0,
    cv_seed: int = 0,
    mask_zeros: bool = False,
    cv_col_subsample: float = 1.0,
    cv_row_subsample: float = 1.0,
    gp_blend: float = 1.0,
    projective: bool = False,
    symmetric: bool = False,
    zi: str = "none",
    robust=False,
    dispersion: str = "per_row",
    theta_init: float = 0.1,
    theta_min: Optional[float] = None,
    theta_max: Optional[float] = None,
    nb_size_init: float = 10.0,
    nb_size_min: Optional[float] = None,
    nb_size_max: Optional[float] = None,
    gamma_phi_init: float = 1.0,
    gamma_phi_min: Optional[float] = None,
    gamma_phi_max: Optional[float] = None,
    huber_delta: float = 1.0,
    zi_em_iters: int = 1,
    track_train_loss: bool = True,
    tweedie_power: float = 1.5,
    irls_max_iter: int = constants.IRLS_MAX_ITER,
    irls_tol: float = constants.IRLS_TOL,
    solver: str = "auto",
    cd_tol: float = constants.CD_TOL,
    cd_maxit: int = constants.CD_MAXIT,
    patience: int = constants.NMF_PATIENCE,
    cv_patience: int = constants.NMF_PATIENCE,
    norm: str = "L1",
    sort_model: bool = True,
    convergence: str = "loss",
    verbose: bool = False,
    profile: bool = False,
    bf16_data: bool = False,
    fused_vmem: bool = False,
    has_mask: bool = False,
    has_graph_W: bool = False,
    has_graph_H: bool = False,
    has_target_H: bool = False,
    has_target_W: bool = False,
) -> NMFConfig:
    """Translate R-style keyword arguments into a static NMFConfig.

    Solver auto-selection follows R/nmf_thin.R:363-388: IRLS -> cd;
    k < 32 and no L1 -> cholesky; else cd.
    """
    if convergence not in ("loss", "factor", "both"):
        raise ValueError(f"convergence={convergence!r}: use 'loss', "
                         "'factor', or 'both'")
    # accepted for R-API compatibility (R/parse_dots.R:63) but the NMF
    # loop is loss-converged in the reference too — its C++ NMFConfig has
    # no convergence field (src/RcppFunctions_nmf.cpp:340-366), only the
    # SVD honors the mode (svd_config.hpp:25).
    l1w, l1h = _pair(L1, "L1")
    l2w, l2h = _pair(L2, "L2")
    l21w, l21h = _pair(L21, "L21")
    angw, angh = _pair(angular, "angular")
    ubw, ubh = _pair(upper_bound, "upper_bound")
    glw, glh = _pair(graph_lambda, "graph_lambda")
    nnw, nnh = (nonneg, nonneg) if isinstance(nonneg, bool) else tuple(nonneg)

    # loss="huber"/"mae" are IRLS reweightings of squared error
    # (math/loss.hpp:39-50, loss_type 1/2): expressed here as MSE +
    # robust delta (huber_delta / the mae 1e-4 floor)
    if loss == "huber":
        loss = "mse"
        if robust is False:
            robust = float(huber_delta)
    elif loss == "mae":
        loss = "mse"
        if robust is False:
            robust = "mae"
    loss_e = Loss(loss)
    # robust: False=0, True=1.345, "mae"=1e-4, numeric (R/nmf_thin.R:341-353)
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif isinstance(robust, str) and robust.lower() == "mae":
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)

    init_mode = 0
    seed_int = 0
    if isinstance(seed, str):
        init_mode = {"random": 0, "lanczos": 1, "irlba": 2,
                     "randomized": 1, "svd": 1}[seed]
    elif seed is not None:
        seed_int = int(seed)

    needs_irls = loss_e != Loss.MSE or robust_delta > 0
    if solver == "auto":
        # Accelerator policy: IRLS needs CD, and any L1 > 0 needs CD too —
        # Cholesky-solve-then-clip is not the stationary solution of the
        # L1-penalized NNLS subproblem (the reference auto-select uses CD
        # whenever L1 != 0, R/nmf_thin.R:371-375).  Otherwise Cholesky+clip,
        # the reference's C++ default (solver_mode=1, core/config.hpp:133).
        solver_e = (Solver.CD if (needs_irls or l1w > 0 or l1h > 0)
                    else Solver.CHOLESKY)
    else:
        solver_e = {"cd": Solver.CD, "cholesky": Solver.CHOLESKY}[solver]
    if solver_e == Solver.CHOLESKY and needs_irls:
        raise ValueError("solver='cholesky' is not supported with non-MSE "
                         "or robust losses; use solver='cd'")

    cfg = NMFConfig(
        rank=int(k), tol=float(tol), max_iter=int(maxit), patience=int(patience),
        W=FactorConfig(L1=l1w, L2=l2w, L21=l21w, angular=angw, nonneg=bool(nnw),
                       upper_bound=ubw, graph_lambda=glw,
                       target_lambda=target_lambda if has_target_W else 0.0),
        H=FactorConfig(L1=l1h, L2=l2h, L21=l21h, angular=angh, nonneg=bool(nnh),
                       upper_bound=ubh, graph_lambda=glh,
                       target_lambda=target_lambda if has_target_H else 0.0),
        loss=loss_e, robust_delta=robust_delta, tweedie_power=float(tweedie_power),
        dispersion=Dispersion(dispersion), theta_init=float(theta_init),
        nb_size_init=float(nb_size_init), gamma_phi_init=float(gamma_phi_init),
        zi=ZI(zi), zi_em_iters=int(zi_em_iters),
        track_loss_history=bool(track_train_loss),
        bf16_data=bool(bf16_data), fused_vmem=bool(fused_vmem),
        solver=solver_e, cd_max_iter=int(cd_maxit), cd_tol=float(cd_tol),
        irls_max_iter=int(irls_max_iter), irls_tol=float(irls_tol),
        seed=seed_int, init_mode=init_mode, norm=Norm(norm),
        projective=projective, symmetric=symmetric, sort_model=sort_model,
        # a cv_seed vector with scalar k uses only its first entry, as the
        # bridge does (src/RcppFunctions_nmf.cpp:358 `cv_seeds[0]`); vectors
        # matter only in the multi-rank sweep (R/nmf_thin.R:1013-1094)
        test_fraction=float(test_fraction),
        cv_seed=int(cv_seed if np.isscalar(cv_seed)
                    else (list(cv_seed) or [0])[0]),
        mask_zeros=bool(mask_zeros),
        cv_patience=int(cv_patience),
        cv_col_subsample=float(cv_col_subsample),
        cv_row_subsample=float(cv_row_subsample),
        gp_blend=float(gp_blend),
        verbose=verbose, enable_profiling=bool(profile),
        has_mask=has_mask, has_graph_W=has_graph_W, has_graph_H=has_graph_H,
        has_target_H=has_target_H, has_target_W=has_target_W,
    )
    # optional dispersion-bound overrides (R/parse_dots.R:24-31)
    bounds = {name: val for name, val in (
        ("theta_min", theta_min), ("theta_max", theta_max),
        ("nb_size_min", nb_size_min), ("nb_size_max", nb_size_max),
        ("gamma_phi_min", gamma_phi_min), ("gamma_phi_max", gamma_phi_max),
    ) if val is not None}
    if bounds:
        import dataclasses
        cfg = dataclasses.replace(cfg, **{k: float(v)
                                          for k, v in bounds.items()})
    cfg.validate()
    return cfg


def _extract_dimnames(data):
    """Pull (row_names, col_names) off a pandas DataFrame, mirroring R's
    dimnames carry-through (tests/testthat/test_dimnames.R: rownames(A) ->
    rownames(W), colnames(A) -> colnames(H))."""
    # R matrices loaded via io.rdata carry dimnames in .attrs
    dn = getattr(data, "attrs", {}).get("dimnames") \
        if not isinstance(data, dict) else None
    if dn is not None and isinstance(dn, list) and len(dn) == 2:
        def arr_or_none(x):
            if x is None:
                return None
            a = np.asarray(x).ravel()
            return a.astype(str) if a.size else None
        return arr_or_none(dn[0]), arr_or_none(dn[1]), data
    if hasattr(data, "index") and hasattr(data, "columns") \
            and hasattr(data, "to_numpy"):
        def names(ix):
            # a default RangeIndex is "no names", like an unnamed R matrix
            if type(ix).__name__ == "RangeIndex" and ix.start == 0 \
                    and ix.step == 1:
                return None
            return np.asarray(ix.astype(str))
        return (names(data.index), names(data.columns),
                data.to_numpy(dtype=np.float32))
    return None, None, data


def nmf(data, k, *, mask=None, graph_W=None, graph_H=None, target_H=None,
        target_W=None, w_init=None, h_init=None, streaming=False,
        chunk_cols=None, on_iteration=None, mesh=None,
        checkpoint_path=None, checkpoint_every=10, device=None, **kwargs):
    """Fit A ~ W diag(d) H.  The main entry point (R/nmf_thin.R:219).

    ``data``: numpy array, scipy sparse matrix or 2-D tensor.  ``k``: an
    int.  ``device``: where the fit runs; by default a tensor's own device,
    and the CPU for a host array.  Other keywords are those of
    :func:`build_config`.
    """
    if isinstance(data, (list, tuple, dict)) and not _is_sparse(data):
        raise unported("multi-modal nmf(list/dict)", "Queue 1 item 12")
    seed_arg = kwargs.get("seed")
    if isinstance(seed_arg, np.ndarray) and seed_arg.ndim == 2:
        # seed = matrix -> custom W init (test_parameters.R:149)
        if np.isscalar(k) and seed_arg.shape[1] != int(k):
            raise ValueError(
                f"Rank mismatch: seed matrix has {seed_arg.shape[1]} "
                f"columns but k = {int(k)}")
        if w_init is None:
            w_init = seed_arg
        kwargs["seed"] = 0
    elif isinstance(seed_arg, (list, tuple)) and len(seed_arg) > 0:
        raise unported("seed=[...] multi-restart", "Queue 1 item 4")
    if isinstance(k, str) or not np.isscalar(k):
        raise unported(f"k={k!r} (rank sweep / auto-rank)", "Queue 1 item 7")
    if mask is not None or kwargs.get("sparse") or kwargs.get("mask_zeros"):
        raise unported("masks (mask=, sparse=True, mask_zeros=True)",
                       "Queue 1 item 7")
    if isinstance(data, str) or streaming:
        raise unported(".spz files, file paths and streaming=True",
                       "Queue 1 item 11")
    if mesh is not None:
        raise unported("mesh=", "Queue 1 item 14")
    if checkpoint_path is not None:
        raise unported("checkpoint_path", "Queue 1 item 4")
    if on_iteration is not None:
        raise unported("on_iteration callbacks", "Queue 1 item 4")

    row_names, col_names, data = _extract_dimnames(data)
    A = _to_dense_f32(data)
    if kwargs.get("symmetric") and A.shape[0] != A.shape[1]:
        raise ValueError(f"symmetric NMF requires a square matrix, got "
                         f"{A.shape[0]} x {A.shape[1]}")
    cfg = build_config(int(k),
                       has_graph_W=graph_W is not None,
                       has_graph_H=graph_H is not None,
                       has_target_H=target_H is not None,
                       has_target_W=target_W is not None,
                       **kwargs)

    aux = {}
    if graph_W is not None:
        aux["graph_W"] = _to_dense_f32(graph_W)
    if graph_H is not None:
        aux["graph_H"] = _to_dense_f32(graph_H)
    for side, target in (("H", target_H), ("W", target_W)):
        if target is None:
            continue
        t = _to_dense_f32(target)
        aux[f"target_{side}"] = t
        if getattr(cfg, side).target_lambda < 0:
            # PROJ_ADV precompute: T @ T.T / n (nmf/fit.hpp:250-274)
            aux[f"target_{side}_gram"] = (t @ t.T) / t.shape[1]

    if cfg.verbose:
        print(f"[nmf] {A.shape[0]} x {A.shape[1]}  k={cfg.rank}  "
              f"loss={cfg.loss.value}  solver={cfg.solver.name.lower()}")
    res = nmf_fit(A, cfg, w_init=w_init, h_init=h_init, aux=aux,
                  device=device)
    res.misc["config"] = cfg
    res.row_names, res.col_names = row_names, col_names
    if cfg.verbose:
        print(f"[nmf] done: {res.iterations} iters, "
              f"converged={res.converged}, loss={res.train_loss:.6g}")
    return res
