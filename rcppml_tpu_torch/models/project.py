"""Projection solvers: ``nnls``, ``predict``, ``evaluate`` and ``mse``.

The port of ``rcppml_tpu/models/project.py:23-135,156-226`` (``R/solve.R:
84-357``, ``R/predict_nmf.R:48`` and the ``evaluate`` / ``mse`` methods of
``R/nmf_methods.R``).  A projection is one solve of the fit's kind against
a fixed factor, on the port's solvers: the Cholesky solve + clip
(``solvers.cholesky_clip_batch``, kernel 6 on the card), CD NNLS
(``solvers.cd_nnls_batch``, kernel 1) and, for the IRLS losses,
``nmf_irls.irls_solve_batch`` (kernel 2, and kernel 4 under
``RCPPML_FUSED_WGRAM``).  Results come back as host numpy arrays.

Every entry point runs on the CUDA card unless given ``device="cpu"`` or a
CPU tensor; without a card it raises.  ``nnls_streaming`` solves panel by
panel over a DataLoader or ``.spz`` file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Loss, NMFConfig
from ..device import set_fp32_precision
from ..ops import features as feat
from ..ops import linalg, losses, solvers
from ..result import NMFResult
from .nmf import device_matrix, fit_device
from .svd import _densify


def _factor(X, dev, transpose: bool = False) -> torch.Tensor:
    """A factor (numpy or tensor) as a contiguous float32 tensor on dev."""
    if isinstance(X, torch.Tensor):
        X = X.to(device=dev, dtype=torch.float32)
        return (X.T if transpose else X).contiguous()
    X = np.asarray(X, dtype=np.float32)
    return device_matrix(X.T if transpose else X, dev)


def nnls(A, w=None, h=None, *, L1: float = 0.0, L2: float = 0.0,
         L21: float = 0.0, angular: float = 0.0, nonneg: bool = True,
         upper_bound: float = 0.0, loss: str = "mse",
         solver: str = "auto", cd_maxit: int = 100, cd_tol: float = 1e-8,
         irls_max_iter: int = 5, irls_tol: float = 1e-4,
         warm_start=None, target_H=None, target_lambda: float = 0.0,
         theta=None, device=None, **fit_kwargs) -> np.ndarray:
    """Solve the projection problem min ||A - w X|| (or min ||A - X h||)
    subject to constraints (R/solve.R:84-357).

    Exactly one of ``w`` (m, k) / ``h`` (k, n) must be given; returns the
    other factor as a host array.  Non-MSE losses run one weighted IRLS
    solve.  ``warm_start``: a previous solution in the return orientation;
    it seeds the CD sweeps and forces the CD solver
    (test_unified_backend.R:143-186).  ``theta``: the NB / GP dispersion, a
    scalar or a vector along either axis of the solve.

    ``L21``, ``target_H``/``target_lambda`` (enrichment > 0, PROJ_ADV < 0)
    and extra ``fit_kwargs`` delegate to one seeded NMF iteration, as the R
    API does (R/solve.R:133-186).  ``device``: where the solve runs; by
    default A's own device for a tensor, else the CUDA card.
    """
    if (w is None) == (h is None):
        raise ValueError("provide exactly one of w=, h=")
    if L1 < 0 or L2 < 0 or L21 < 0:
        # R/nmf_validation.R penalty validators (test_predict.R:62-80)
        raise ValueError("L1/L2/L21 penalties must be >= 0")
    if (target_H is not None and np.any(np.atleast_1d(target_lambda) != 0)) \
            or fit_kwargs or L21 > 0:
        # L21's adaptive ridge needs a factor iterate; the one-iteration
        # NMF delegation applies it exactly like the R API (R/solve.R)
        from ..api import nmf as nmf_api

        def host(X):
            return (X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
                    else np.asarray(X, dtype=np.float32))
        k_t = (np.shape(w)[1] if w is not None else np.shape(h)[0])
        model = nmf_api(A, int(k_t), maxit=1, loss=loss,
                        L1=(L1, L1), L2=(L2, L2), L21=(L21, L21),
                        angular=(angular, angular), nonneg=nonneg,
                        upper_bound=(upper_bound, upper_bound),
                        target_H=target_H, target_lambda=target_lambda,
                        norm="none", device=device,
                        **(dict(w_init=host(w)) if w is not None else
                           dict(h_init=host(h))),
                        **fit_kwargs)
        return (np.asarray(model.H) * np.asarray(model.d)[:, None]
                if w is not None else
                np.asarray(model.W) * np.asarray(model.d)[None, :])

    A = _densify(A)
    # everything that needs no device is checked by now
    dev = fit_device(A, device)
    set_fp32_precision()
    if w is not None:
        F = _factor(w, dev, transpose=True)                   # (k, m)
        data = device_matrix(A, dev)                          # solve (k, n)
    else:
        F = _factor(h, dev)                                   # (k, n)
        data = device_matrix(A, dev)                          # solve (k, m)
        if data.dim() == 2:
            data = data.T.contiguous()

    k = F.shape[0]
    loss_e = Loss(loss)
    if loss_e != Loss.MSE:
        from ..api import build_config
        from .nmf_irls import irls_solve_batch
        cfg = build_config(k, loss=loss, L1=(0.0, L1), L2=(0.0, L2),
                           irls_max_iter=irls_max_iter, irls_tol=irls_tol,
                           cd_maxit=cd_maxit, cd_tol=cd_tol, solver="cd")
        fc = cfg.H.__class__(L1=L1, L2=L2, L21=L21, nonneg=nonneg,
                             upper_bound=upper_bound)
        active = Loss.KL if loss_e == Loss.GP else loss_e
        # dispersion for NB/GP weights: theta= may be a scalar or a vector
        # matching either axis of the solve; without it the weights
        # degenerate to the r->0 limit, inconsistent with a fitted model
        th_row = th_col = None
        if theta is not None and loss_e in (Loss.NB, Loss.GP):
            tv = np.atleast_1d(np.asarray(
                theta.detach().cpu() if isinstance(theta, torch.Tensor)
                else theta, dtype=np.float32))
            if tv.size == 1:
                th_row = torch.full((data.shape[0],), float(tv[0]),
                                    dtype=torch.float32, device=dev)
            elif tv.size == data.shape[0]:
                th_row = torch.from_numpy(tv.copy()).to(dev)
            elif tv.size == data.shape[1]:
                th_col = torch.from_numpy(tv.copy()).to(dev)
            else:
                raise ValueError(
                    f"theta length {tv.size} matches neither axis of the "
                    f"solve {tuple(data.shape)}")
        X = irls_solve_batch(data, F, cfg, active, th_row, th_col, fc, False)
    else:
        G = linalg.gram(F)
        B = linalg.rhs(F, data)
        if L2 > 0:
            G = G + L2 * torch.eye(k, dtype=G.dtype, device=dev)
        if L1 > 0:
            B = B - L1
        X0 = None
        if warm_start is not None:
            # the return orientation is (k, n) for w=, (m, k) for h=
            X0 = _factor(warm_start, dev, transpose=h is not None)
        use_cd = (solver == "cd") or X0 is not None or \
            (solver == "auto" and (L1 > 0 or k >= 32))
        if use_cd:
            X = solvers.cd_nnls_batch(G, B, X0, nonneg=nonneg,
                                      maxit=cd_maxit, cd_tol=cd_tol,
                                      upper_bound=upper_bound,
                                      warm_start=X0 is not None)
        elif B.dim() == 1:
            # a single column A of shape (m,): a (k,) solution, as the JAX
            # package returns (its solve broadcasts over a 1-D B)
            X = solvers.cholesky_clip_batch(G, B[:, None], nonneg=nonneg,
                                            upper_bound=upper_bound)[:, 0]
        else:
            X = solvers.cholesky_clip_batch(G, B, nonneg=nonneg,
                                            upper_bound=upper_bound)
    if angular > 0:
        X = feat.apply_angular_posthoc(X, angular)
    X = X.detach().cpu().numpy()
    return X if w is not None else X.T


def nnls_streaming(path_or_loader, w, *, chunk_cols=None,
                   **kwargs) -> np.ndarray:
    """Streaming projection: solve H panel by panel over a DataLoader /
    ``.spz`` file / host matrix (R/solve.R c_nnls_streaming,
    nmf/nnls_streaming.hpp).  Each panel is one :func:`nnls` call (its
    keywords, ``device=`` included, pass through); returns H (k, n) on the
    host."""
    from ..io.loaders import DataLoader, InMemoryLoader, SpzLoader
    if isinstance(path_or_loader, DataLoader):
        loader = path_or_loader
    elif isinstance(path_or_loader, (str, bytes)):
        loader = SpzLoader(path_or_loader)
    else:
        loader = InMemoryLoader(path_or_loader, chunk_cols=chunk_cols)
    parts = []
    for ch in loader.iter_chunks():
        parts.append((ch.col_start, nnls(np.ascontiguousarray(ch.data),
                                         w=w, **kwargs)))
    parts.sort(key=lambda t: t[0])
    return np.concatenate([p for _, p in parts], axis=1)


def predict(model: NMFResult, newdata, *, L1: Optional[float] = None,
            L2: Optional[float] = None,
            upper_bound: Optional[float] = None,
            loss: Optional[str] = None, device=None) -> np.ndarray:
    """Project new columns onto a fitted model's W (R/predict_nmf.R:48).

    Reuses the model's stored penalty configuration when available via
    ``model.misc['config']``; an explicit argument always wins, explicit
    zeros and ``'mse'`` included (None marks "not given").
    Returns H_new (k, n_new) as a host array."""
    cfg = model.misc.get("config")
    if cfg is not None and isinstance(cfg, NMFConfig):
        L1 = cfg.H.L1 if L1 is None else L1
        L2 = cfg.H.L2 if L2 is None else L2
        upper_bound = cfg.H.upper_bound if upper_bound is None else upper_bound
        loss = cfg.loss.value if loss is None else loss
    L1 = 0.0 if L1 is None else L1
    L2 = 0.0 if L2 is None else L2
    upper_bound = 0.0 if upper_bound is None else upper_bound
    loss = "mse" if loss is None else loss
    W = np.asarray(model.W) * np.asarray(model.d)[None, :]
    # fitted dispersion travels with the projection; per-row theta (length
    # m) transfers to new columns, per-column theta cannot (new samples) —
    # its mean stands in as a global size
    theta = None
    if model.theta is not None and loss in ("nb", "gp"):
        tv = np.asarray(model.theta, dtype=np.float32)
        theta = tv if tv.size == W.shape[0] else float(tv.mean())
    return nnls(newdata, w=W, L1=L1, L2=L2, upper_bound=upper_bound,
                loss=loss, theta=theta, device=device)


def evaluate(model: NMFResult, A, *, mask=None, loss: str = "mse",
             missing_only: bool = False, mask_zeros: bool = False,
             device=None) -> float:
    """Mean per-entry loss of the model on A (R/nmf_methods.R evaluate),
    optionally restricted to masked (missing) or nonzero entries
    (tests/testthat/test_evaluate.R).  The per-entry losses are computed on
    ``device`` (by default A's own device for a tensor, else the CUDA
    card)."""
    if missing_only and mask is None:
        raise ValueError("a mask matrix must be specified with missing_only")
    from ..api import build_config
    cfg = build_config(model.k, loss=loss,
                       solver="cd" if loss != "mse" else "auto")
    A = _densify(A)
    dev = fit_device(A, device)
    set_fp32_precision()
    A_d = device_matrix(A, dev)
    rec = device_matrix(model.reconstruct(), dev)
    # NB/GP losses need the fitted dispersion — zeros would score the
    # model at the r->0 limit (garbage lgamma terms), not its likelihood
    shape = tuple(A_d.shape)
    theta_mn = torch.zeros(shape, dtype=torch.float32, device=dev)
    if model.theta is not None and loss in ("nb", "gp"):
        tv = torch.from_numpy(np.array(model.theta, np.float32)).to(dev)
        if tv.numel() == shape[0]:
            theta_mn = tv[:, None].expand(shape)
        elif tv.numel() == shape[1]:
            theta_mn = tv[None, :].expand(shape)
        else:
            theta_mn = torch.full(shape, float(tv.mean()),
                                  dtype=torch.float32, device=dev)
    contrib = losses.compute_loss_elements(A_d, rec, cfg, theta_mn)
    contrib = contrib.detach().cpu().numpy()
    sel = np.ones(shape, dtype=bool)
    if mask is not None:
        M = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
             else np.asarray(mask)).astype(bool)
        sel = M if missing_only else ~M
    if mask_zeros:
        sel = sel & (A_d != 0).cpu().numpy()
    return float(contrib[sel].mean()) if sel.any() else float("nan")


def mse(model: NMFResult, A, **kw) -> float:
    """Mean squared reconstruction error (R/nmf_methods.R mse)."""
    return evaluate(model, A, loss="mse", **kw)
