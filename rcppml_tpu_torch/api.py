"""User-facing API of the port, mirroring ``rcppml_tpu/api.py``.

``nmf(A, k, ...)`` takes a dense numpy array, a scipy sparse matrix (made
dense) or a 2-D tensor and returns an :class:`NMFResult`.  The fit runs on
the CUDA card unless the caller passes ``device="cpu"`` or a CPU tensor.
:func:`build_config` is the JAX package's, whole.

Cross-validation and masks: ``test_fraction=`` holds out a speckled set and
reports train and test loss per iteration; ``mask=`` (a boolean matrix,
``"zeros"`` or ``"NA"``), ``sparse=True`` and NaN entries (masked with a
warning) fit on the observed entries only.  ``k=[...]`` sweeps the ranks
under cross-validation and returns one row per rank and ``cv_seed``;
``k="auto"`` searches the rank and refits there.

Losses: ``mse`` (Cholesky or CD solver) and, through the IRLS path with the
CD solver, ``kl``, ``gp``, ``nb``, ``gamma``, ``inverse_gaussian``,
``tweedie``, ``huber``, ``mae`` and ``robust=`` on any of them, with
``dispersion`` per row, per column, global or none and ``zi="row"/"col"``
for ``gp`` and ``nb``.  A scipy-sparse input to an IRLS fit gives zeros unit
weight and a loss over the nonzeros.

Dense MSE fits also take ``fused_vmem=True`` (the whole fixed-``maxit`` fit
as one call of the Newton-Schulz ALS kernels, ``tol=0``), ``bf16_data=True``
(the products read a bfloat16 copy of A), ``seed=[...]`` (one restart per
seed, the best train loss wins) and ``on_iteration=`` (a callback per
iteration, step mode).  ``profile=True`` fills ``res.profile`` for dense
MSE and IRLS fits; a cross-validated or masked fit accepts it and times no
section, and with an IRLS loss, cross-validation or a mask ``on_iteration``
is accepted and never called, as in the JAX package.  ``seed="lanczos"`` /
``"irlba"`` start from a truncated SVD of A (``models/svd.py``) on the
fit's device.

The SVD (``svd``, ``pca``) and projection (``nnls``, ``predict``,
``evaluate``, ``mse``) entry points live in ``models/svd.py`` and
``models/project.py``.  A ``.spz`` path, ``streaming=True`` and a host
matrix too large for the card's memory with headroom run the streaming
engine (``models/nmf_chunked.py``), on the card unless ``device="cpu"``;
other file paths load in memory through ``load_data``.  A list or dict of
matrices with the same columns is a multi-modal fit: a shared-H
``factor_net`` (``models/graph.py``) whose W comes back split per input.
``mesh=`` (a ``parallel.mesh.Mesh``, every rank of it calling ``nmf`` with
the same arguments) fits each rank's (rows, cols) block of A and returns
the whole result on every rank: MSE, IRLS, cross-validated and masked fits
(``parallel/mesh.py``), checkpointed fits (rank 0 reads and writes the
file) and streams (each rank reads its own panels and uploads its block
of each, ``models/nmf_chunked.py``); it never falls back silently.  As in
the JAX package, an in-memory mesh fit runs the plain loop:
``on_iteration`` is taken and never called, and ``profile=True`` times no
MSE section.  ``checkpoint_path=`` runs
the dense fit (MSE or IRLS) in segments of ``checkpoint_every`` iterations,
writing the whole state after each and resuming from the file when it
exists (``utils/checkpoint.py``).
``verbose`` and the process-wide level of ``utils/logging.py`` gate a
summary line before and after the fit and, at the DETAILED level, one line
per iteration.
"""

from __future__ import annotations

from typing import Optional, Union

import warnings

import numpy as np
import torch

from . import constants
from .config import Dispersion, FactorConfig, Loss, NMFConfig, Norm, Solver, ZI
from .models.nmf import device_matrix, fit_device, nmf_fit
from .result import NMFResult
from .utils import logging as logmod


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


def _to_dense_f32(data, allow_nan: bool = False):
    """Return a dense float32 (m, n): numpy and scipy.sparse inputs become a
    host array (Inf rejected, and NaN unless ``allow_nan``), a tensor stays
    on its device."""
    if isinstance(data, torch.Tensor):
        if data.ndim != 2:
            raise ValueError("data must be a 2-D matrix")
        return data.to(torch.float32)
    if _is_sparse(data):
        # memory guard before densification (core/memory.hpp:152-190)
        from .utils.memory import guard_dense_input
        guard_dense_input(data.shape[0], data.shape[1])
        arr = np.asarray(data.todense(), dtype=np.float32)
    else:
        arr = np.asarray(data, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if not allow_nan and np.isnan(arr).any():
        raise ValueError("data contains NaN/NA values; impute or mask them "
                         "(use mask= for missing-value factorization)")
    if np.isinf(arr).any():
        raise ValueError("data contains infinite values; clip or remove "
                         "them before factorization")
    return arr


def _resolve_mask(A, mask):
    """NA handling + string masks, matching the reference gateway:

    - ``mask="zeros"`` -> treat zeros as missing (returned as the
      mask_zeros flag; R/nmf_thin.R mask= string form)
    - ``mask="NA"`` -> mask the NaN entries
    - NaN present with no mask -> warn "Detected N NA values" and mask
      them (tests/testthat/test_masking.R:240-262)
    - NaN outside an explicit matrix mask -> error

    Returns (A, mask_or_None, mask_zeros_flag); NaN entries are zero-filled
    so that no NaN reaches the device.  A tensor input is assumed NaN-free
    (no scan), as the JAX package assumes of a device array.
    """
    if isinstance(mask, str):
        key = mask.strip().lower()
        if key == "zeros":
            return A, None, True
        if key != "na":
            raise ValueError(f"mask={mask!r}: use 'zeros', 'NA', or a "
                             "boolean matrix")
        mask = None
        explicit_na = True
    else:
        explicit_na = False
    if isinstance(A, torch.Tensor):
        if explicit_na:
            raise ValueError("mask='NA' requires a host array (tensor "
                             "inputs are assumed NaN-free)")
        return A, mask, False
    nan_mask = np.isnan(A)
    n_nan = int(nan_mask.sum())
    if n_nan == 0:
        return A, mask, False
    A = np.where(nan_mask, np.float32(0), A)
    if mask is None:
        if not explicit_na:
            warnings.warn(f"Detected {n_nan} NA values in data; treating "
                          "them as masked (missing)")
        return A, nan_mask, False
    mask = _host_mask(mask)
    if (nan_mask & ~mask).any():
        raise ValueError("data contains NaN entries outside the supplied "
                         "mask; mask them or impute")
    return A, mask, False


def _host_mask(mask) -> np.ndarray:
    """A user mask (array, scipy sparse matrix or tensor) as a host bool
    array."""
    if isinstance(mask, torch.Tensor):
        return mask.detach().cpu().numpy().astype(bool)
    if _is_sparse(mask):
        return np.asarray(mask.todense()).astype(bool)
    return np.asarray(mask, dtype=bool)


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


def _multi_restart(data, k, seeds, kwargs, rest):
    """``seed=[...]``: one :func:`nmf` per seed, the best train loss wins
    (test_parameters.R:554-578), so each restart equals its standalone fit.
    A dense host matrix goes to the device once; a sparse one stays as it
    is, because an IRLS fit reads from its type that the zeros are
    structural."""
    row_names, col_names, data = _extract_dimnames(data)
    if isinstance(data, np.ndarray):
        A = _to_dense_f32(data, allow_nan=True)
        if not np.isnan(A).any():       # NaN data is masked by each nmf()
            data = device_matrix(A, fit_device(A, rest["device"]))
    runs = []
    for ri, s in enumerate(seeds):
        sub = dict(rest)
        ck = rest["checkpoint_path"]
        if ck is not None:
            # one checkpoint per restart: a shared path would make restart i
            # resume restart i-1's state (a config mismatch)
            root, dot, ext = ck.rpartition(".")
            sub["checkpoint_path"] = (f"{root}.restart{ri}.{ext}" if dot
                                      else f"{ck}.restart{ri}")
        runs.append(nmf(data, k, **sub, **{**kwargs, "seed": s}))
    losses = [float(r.train_loss) for r in runs]
    best_ix = int(np.nanargmin(losses))
    best = runs[best_ix]
    best.misc["all_inits"] = [
        {"init": i, "loss": losses[i], "selected": i == best_ix}
        for i in range(len(runs))]
    best.row_names, best.col_names = row_names, col_names
    return best


def _nmf_multimodal(data, k, *, device, kwargs, streaming, unsupported):
    """``nmf(list/dict)``: a shared-H factor_net of one layer named "L1"
    over the row-stacked matrices (R/nmf_thin.R:279-304), which delegates
    to the same fit as ``nmf`` of the stacked matrix.  Returns a
    GraphResult; W comes back split per input in ``W_blocks``."""
    from .models import graph as graph_mod
    # the shared-H delegation supports config-level settings only — reject
    # (never silently drop) the matrix-shaped arguments that cannot ride
    # through GlobalConfig
    rejected = [n for n, v in unsupported.items() if v is not None]
    if streaming:
        rejected.append("streaming")
    if rejected:
        raise ValueError(
            f"multi-modal nmf(list/dict) does not support "
            f"{', '.join(sorted(rejected))}; build the factor_net "
            "explicitly (rtt.factor_input/factor_shared/nmf_layer) to "
            "control per-layer features")
    named = (list(data.items()) if isinstance(data, dict)
             else [(f"modal{i + 1}", d) for i, d in enumerate(data)])
    if len(named) < 2:
        raise ValueError("multi-modal NMF requires 2+ matrices with "
                         "the same number of columns (samples)")
    if len({np.shape(d)[1] for _, d in named}) != 1:
        raise ValueError("all matrices in multi-modal NMF must share "
                         "the number of columns (samples)")
    inputs = [graph_mod.factor_input(_to_dense_f32(d), nm) for nm, d in named]
    layer = graph_mod.nmf_layer(graph_mod.factor_shared(*inputs), int(k),
                                name="L1")
    # every remaining fit kwarg rides through GlobalConfig: named settings
    # where they exist, everything else via dots (lowest priority,
    # forwarded verbatim to the layer's nmf() call — R/nmf_thin.R:293-302)
    dots = dict(kwargs)
    named_settings = {name: dots.pop(name) for name in (
        "maxit", "tol", "loss", "verbose", "seed", "norm", "solver",
        "test_fraction", "cv_seed", "mask_zeros", "patience")
        if name in dots}
    net = graph_mod.factor_net(
        inputs, layer, config=graph_mod.GlobalConfig(dots=dots,
                                                     **named_settings),
        device=device)
    return graph_mod.fit(net)


def _nmf_streaming(data, k, is_spz: bool, *, mask, graph_W, graph_H, w_init,
                   h_init, chunk_cols, on_iteration, checkpoint_path,
                   checkpoint_every, mesh, device, kwargs):
    """``nmf`` of a ``.spz`` path, or with ``streaming=True``: the chunked
    engine over an SpzLoader or an InMemoryLoader (each rank's own under
    ``mesh``), with the in-memory path's NaN / Inf contract
    (rcppml_tpu/api.py:498-542)."""
    if isinstance(mask, str):
        # mask="zeros" was normalized to mask_zeros before; "NA" needs the
        # full matrix in memory (R/nmf_thin.R:463-465)
        raise ValueError(
            "streaming NMF does not support mask='NA' — NA detection "
            "requires the full matrix in memory; pass an explicit "
            "mask matrix or disable streaming")
    from .io.loaders import InMemoryLoader, SpzLoader
    from .models.nmf_chunked import nmf_chunked
    if not is_spz:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        if _is_sparse(data):
            # sparse input stays sparse (the loader panels it); its zeros
            # cannot be NaN, so the stored values are what is checked
            vals = data.data if hasattr(data, "data") else \
                np.asarray(data.tocsc().data)
            if np.isnan(vals).any():
                raise ValueError(
                    "data contains NaN/NA values; streaming cannot "
                    "auto-mask them — impute, or pass an explicit "
                    "mask= matrix")
            if np.isinf(vals).any():
                raise ValueError("data contains infinite values; clip "
                                 "or remove them before factorization")
        else:
            data = _to_dense_f32(data, allow_nan=True)
            data, mask, mask_zeros = _resolve_mask(data, mask)
            if mask_zeros:
                kwargs.setdefault("mask_zeros", True)
    cfg = build_config(int(k), has_mask=mask is not None,
                       has_graph_W=graph_W is not None,
                       has_graph_H=graph_H is not None, **kwargs)
    loader = (SpzLoader(data) if is_spz
              else InMemoryLoader(data, chunk_cols=chunk_cols))
    return nmf_chunked(loader, cfg, w_init=w_init, h_init=h_init, mask=mask,
                       graph_W=graph_W, graph_H=graph_H, mesh=mesh,
                       on_iteration=on_iteration,
                       checkpoint_path=checkpoint_path,
                       checkpoint_every=checkpoint_every, device=device)


def _aux_arrays(cfg, graph_W, graph_H, target_H, target_W) -> dict:
    """The dense auxiliary arrays of a fit: graph Laplacians, targets and
    the PROJ_ADV target Grams."""
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
    return aux


def _nmf_sharded_input(data, k, mesh, *, mask, graph_W, graph_H, target_H,
                       target_W, w_init, h_init, checkpoint_path,
                       checkpoint_every, device, kwargs):
    """``nmf`` of a ``parallel.mesh.ShardedMatrix`` (no rank holds the whole
    matrix): the plain sharded fit, or with ``checkpoint_path=`` the
    checkpointed one, without a mask or a holdout (those read the whole
    matrix; pass the host matrix for them)."""
    from .parallel.mesh import fit_sharded
    from .utils.checkpoint import fit_checkpointed
    if not np.isscalar(k) or isinstance(k, str):
        raise ValueError("a ShardedMatrix fits one integer rank")
    if (mask is not None or kwargs.get("mask_zeros")
            or float(kwargs.get("test_fraction", 0) or 0)):
        raise ValueError("a ShardedMatrix fits without mask= or "
                         "test_fraction=; pass the host matrix for those")
    cfg = build_config(int(k), has_graph_W=graph_W is not None,
                       has_graph_H=graph_H is not None,
                       has_target_H=target_H is not None,
                       has_target_W=target_W is not None, **kwargs)
    aux = _aux_arrays(cfg, graph_W, graph_H, target_H, target_W)
    if checkpoint_path is not None:
        res = fit_checkpointed(data, cfg, checkpoint_path,
                               every=int(checkpoint_every), w_init=w_init,
                               h_init=h_init, aux=aux, device=device,
                               mesh=mesh)
    else:
        res = fit_sharded(data, cfg, mesh, w_init=w_init, h_init=h_init,
                          aux=aux, device=device)
    res.misc["config"] = cfg
    return res


def nmf(data, k, *, mask=None, graph_W=None, graph_H=None, target_H=None,
        target_W=None, w_init=None, h_init=None, streaming=False,
        chunk_cols=None, on_iteration=None, mesh=None,
        checkpoint_path=None, checkpoint_every=10, device=None, **kwargs):
    """Fit A ~ W diag(d) H.  The main entry point (R/nmf_thin.R:219).

    ``data``: numpy array, scipy sparse matrix or 2-D tensor.  ``k``: an
    int; a list of ints (a cross-validated sweep: one row per rank and
    ``cv_seed`` entry is returned, not a fit); or ``"auto"`` (the rank search
    of ``models.rank_cv.find_optimal_rank``, with ``cv_k_range=(lo, hi)``,
    then a refit at the rank found).  ``mask``: a boolean matrix (True =
    missing), ``"zeros"`` or ``"NA"``; ``sparse=True`` is ``mask="zeros"``.
    NaN entries of a host array are masked, with a warning unless a mask
    covers them.  ``device``: where the fit runs; by default a tensor's own
    device, and the CUDA card for a host array (numpy, scipy sparse,
    DataFrame).  Without a card that raises a ``RuntimeError``; pass
    ``device="cpu"`` to fit on the CPU.  ``seed=[...]`` fits once per seed
    and returns the restart with the best train loss
    (``misc["all_inits"]`` lists them all).  ``data`` may also be a
    ``.spz`` path or come with ``streaming=True`` (``chunk_cols=`` panels
    of an in-memory matrix): the streaming engine fits it panel by panel
    (``models/nmf_chunked.py``), as it does a host matrix that does not fit
    the card's memory with headroom; other file paths are read with
    ``load_data``.
    ``on_iteration(iter, train_loss, nan)`` is called after every iteration
    of a dense MSE fit (with an IRLS loss, cross-validation or a mask it is
    accepted and never called, as in the JAX package).  Other keywords are
    those of :func:`build_config`.
    """
    if isinstance(data, (list, tuple, dict)) and not _is_sparse(data):
        return _nmf_multimodal(
            data, k, device=device, kwargs=kwargs, streaming=streaming,
            unsupported={"mask": mask, "graph_W": graph_W,
                         "graph_H": graph_H, "target_H": target_H,
                         "target_W": target_W, "w_init": w_init,
                         "h_init": h_init, "mesh": mesh,
                         "on_iteration": on_iteration,
                         "checkpoint_path": checkpoint_path})
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
        if not np.isscalar(k) or isinstance(k, str):
            raise ValueError(
                "seed=[...] multi-restart requires a scalar integer k; "
                "for a rank sweep use cv_seed=[...] to control "
                "repetitions")
        return _multi_restart(
            data, k, seed_arg, kwargs,
            dict(mask=mask, graph_W=graph_W, graph_H=graph_H,
                 target_H=target_H, target_W=target_W, w_init=w_init,
                 h_init=h_init, streaming=streaming, chunk_cols=chunk_cols,
                 on_iteration=on_iteration, mesh=mesh,
                 checkpoint_path=checkpoint_path,
                 checkpoint_every=checkpoint_every, device=device))
    if isinstance(k, str) and k != "auto":
        raise ValueError(f"k={k!r}: use an int, a list of ints or 'auto'")
    if isinstance(mask, str) and mask.strip().lower() == "zeros":
        # R string form mask="zeros" == mask_zeros=True (R/nmf_thin.R)
        mask = None
        kwargs.setdefault("mask_zeros", True)
    if kwargs.pop("sparse", False):
        # R sparse=TRUE: treat zeros as missing (R/parse_dots.R:65)
        kwargs.setdefault("mask_zeros", True)
    # streaming / out-of-core dispatch (nmf/fit_streaming_spz.hpp:54)
    is_spz = isinstance(data, str) and data.endswith(".spz")
    from .parallel.mesh import ShardedMatrix
    if isinstance(data, ShardedMatrix) and mesh is None:
        mesh = data.mesh        # no rank holds the matrix: fit on its mesh
    if isinstance(data, ShardedMatrix):
        return _nmf_sharded_input(
            data, k, mesh, mask=mask, graph_W=graph_W, graph_H=graph_H,
            target_H=target_H, target_W=target_W, w_init=w_init,
            h_init=h_init, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, device=device, kwargs=kwargs)
    to_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if (not is_spz and not streaming and to_card and mesh is None
            and not isinstance(data, (str, torch.Tensor))
            and hasattr(data, "shape") and np.isscalar(k)):
        # switch to streaming when the dense fp32 matrix cannot fit the
        # card's memory with headroom (gpu/loader.hpp streaming mode,
        # test_gpu_oom.R:9).  NB+ZI streams too (panel-local E-step);
        # GP-family ZI and symmetric need the whole matrix, so they stay
        # on the in-memory path.
        from .utils.memory import check_dense_alloc
        chk = check_dense_alloc(data.shape[0], data.shape[1],
                                where="device")
        zi_ok = (kwargs.get("zi", "none") in (None, "none")
                 or (kwargs.get("loss") == "nb"
                     and not kwargs.get("test_fraction")
                     and mask is None
                     and not kwargs.get("mask_zeros")))
        if not chk.fits and zi_ok and not kwargs.get("symmetric"):
            logmod.log_summary(
                "[nmf] %d x %d exceeds device memory (%s); streaming in "
                "column panels", data.shape[0], data.shape[1], chk.message,
                verbose=kwargs.get("verbose") or None)
            streaming = True
    if is_spz or streaming:
        return _nmf_streaming(
            data, k, is_spz, mask=mask, graph_W=graph_W, graph_H=graph_H,
            w_init=w_init, h_init=h_init, chunk_cols=chunk_cols,
            on_iteration=on_iteration, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, mesh=mesh, device=device,
            kwargs=kwargs)
    # other file paths load in memory (R/nmf_validation.R:30-120)
    if isinstance(data, str):
        from .utils.resources import load_data
        data = load_data(data)

    row_names, col_names, data = _extract_dimnames(data)
    sparse_input = _is_sparse(data)
    A = _to_dense_f32(data, allow_nan=True)
    A, mask, mask_zeros = _resolve_mask(A, mask)
    if mask_zeros:
        kwargs.setdefault("mask_zeros", True)
    if kwargs.get("symmetric") and A.shape[0] != A.shape[1]:
        raise ValueError(f"symmetric NMF requires a square matrix, got "
                         f"{A.shape[0]} x {A.shape[1]}")
    if kwargs.get("mask_zeros") and not float(kwargs.get("test_fraction", 0)):
        # non-CV mask="zeros": zeros are missing, an exact masked fit where
        # zero entries leave Gram and RHS.  Under speckled CV the flag
        # instead restricts the holdout to nonzeros (models/nmf_cv.py).
        if isinstance(A, torch.Tensor):
            zm = A == 0
            if mask is not None:
                zm = zm | torch.from_numpy(_host_mask(mask)).to(A.device)
            mask = zm
        else:
            zm = A == 0
            mask = zm if mask is None else (_host_mask(mask) | zm)

    # multi-rank CV sweep / auto-rank dispatch (R/nmf_thin.R:922-1094)
    if isinstance(k, str):
        from .models.rank_cv import find_optimal_rank
        if "cv_k_range" in kwargs:      # R cv_k_range = c(lo, hi)
            lo, hi = kwargs.pop("cv_k_range")
            kwargs.setdefault("k_init", int(lo))
            kwargs.setdefault("max_k", int(hi))
        return find_optimal_rank(A, mask=mask, device=device, **kwargs)
    if not np.isscalar(k):
        from .models.nmf_cv import cv_sweep
        return cv_sweep(A, list(k), mask=mask, device=device, **kwargs)

    cfg = build_config(int(k),
                       has_mask=mask is not None,
                       has_graph_W=graph_W is not None,
                       has_graph_H=graph_H is not None,
                       has_target_H=target_H is not None,
                       has_target_W=target_W is not None,
                       **kwargs)

    # with an IRLS loss, cross-validation or a mask the callback is taken
    # and never called, as in the JAX package (its nmf_fit returns the IRLS
    # fit before the callback branch; fit_cv_or_masked takes none)
    masked = cfg.is_cv() or mask is not None
    aux = _aux_arrays(cfg, graph_W, graph_H, target_H, target_W)

    verbose = cfg.verbose or None
    logmod.log_summary(
        "[nmf] %d x %d  k=%d  loss=%s  solver=%s  device=%s",
        A.shape[0], A.shape[1], cfg.rank, cfg.loss.value,
        cfg.solver.name.lower(),
        device if device is not None else getattr(A, "device", "cuda"),
        verbose=verbose)
    if checkpoint_path is not None:
        # preemption-safe segmented fit; resumes from the checkpoint if one
        # exists at the path
        if masked:
            raise ValueError("checkpoint_path currently supports the "
                             "standard dense fit (no CV/mask)")
        from .utils.checkpoint import fit_checkpointed
        res = fit_checkpointed(A, cfg, checkpoint_path,
                               every=int(checkpoint_every), w_init=w_init,
                               h_init=h_init, aux=aux,
                               sparse_zeros=sparse_input, device=device,
                               mesh=mesh)
    elif masked:
        from .models.nmf_cv import fit_cv_or_masked
        res = fit_cv_or_masked(A, cfg, mask=mask, aux=aux, w_init=w_init,
                               h_init=h_init, sparse_zeros=sparse_input,
                               mesh=mesh, device=device)
    elif mesh is not None:
        # the JAX package's mesh branch: the plain loop, no callback
        from .parallel.mesh import fit_sharded
        res = fit_sharded(A, cfg, mesh, w_init=w_init, h_init=h_init,
                          aux=aux, sparse_zeros=sparse_input, device=device)
    else:
        res = nmf_fit(A, cfg, w_init=w_init, h_init=h_init, aux=aux,
                      device=device, sparse_zeros=sparse_input,
                      on_iteration=on_iteration)
    res.misc["config"] = cfg
    res.row_names, res.col_names = row_names, col_names
    # SUMMARY: the final state; DETAILED: the per-iteration losses, replayed
    # from the returned history, so that the loop never syncs for logging
    logmod.log_summary("[nmf] done: %d iters, converged=%s, loss=%.6g",
                       res.iterations, res.converged, res.train_loss,
                       verbose=verbose)
    if res.loss_history is not None:
        hist = np.asarray(res.loss_history, dtype=float)
        for i, loss in enumerate(hist[np.isfinite(hist)]):
            logmod.log_detailed("  iter %4d: loss=%.6g", i + 1, loss,
                                verbose=verbose)
    return res
