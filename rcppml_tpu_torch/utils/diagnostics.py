"""Distribution selection and diagnostics.

Equivalents of ``R/auto_distribution.R``:

* :func:`auto_nmf_distribution` — fit each candidate loss, compare by
  BIC/AIC (R/auto_distribution.R:54-145).
* :func:`score_test_distribution` — power-variance-family score test on
  a fitted model, no refits (R/auto_distribution.R:194-267).
* :func:`diagnose_zero_inflation` — excess-zero diagnostic on a fitted
  model (R/auto_distribution.R:304-367).
* :func:`diagnose_dispersion` — per-row/per-col/global dispersion mode
  recommendation (R/auto_distribution.R:405-460).

All four are pure host-side numpy post-processing; only
``auto_nmf_distribution`` (and the others when no model is given) launch
fits.  A copy of ``rcppml_tpu/utils/diagnostics.py`` whose fits go through
the port's ``nmf``: on the card unless ``device="cpu"`` (or a CPU tensor) is
passed among the fit keywords.  ``data`` may be a tensor on any device; the
float64 host arithmetic reads a host copy of it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

_POWER_LABELS = {0: "gaussian", 1: "gp", 2: "gamma", 3: "inverse_gaussian"}


def _dense(data) -> np.ndarray:
    import torch
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data.todense() if hasattr(data, "todense") else data,
                      dtype=np.float64)


def _mu_matrix(model, min_mu: float = 0.0) -> np.ndarray:
    mu = np.asarray(model.reconstruct(), dtype=np.float64)
    return np.maximum(mu, min_mu) if min_mu > 0 else mu


def auto_nmf_distribution(data, k: int, *,
                          distributions: Sequence[str] = ("mse", "gp", "nb"),
                          criterion: str = "bic", maxit: int = 50,
                          seed: Optional[int] = None, verbose: bool = False,
                          **kwargs) -> dict:
    """Fit each candidate loss and compare by BIC/AIC
    (R/auto_distribution.R:54-145).

    df = k(m+n) + {1 for Gaussian sigma; m for per-row dispersion}.
    MSE SSE is converted to a Gaussian NLL: (N/2)(1 + log(2 pi SSE / N)).

    Returns ``{"loss": best, "comparison": rows, "models": models}``
    mirroring the reference's list fields (``loss``/``comparison``/
    ``models``).
    """
    if criterion not in ("bic", "aic"):
        raise ValueError("criterion must be 'bic' or 'aic'")
    from ..api import nmf as nmf_api
    try:
        import scipy.sparse as sp
        is_sparse = sp.issparse(data)
    except ImportError:
        is_sparse = False
    m, n = data.shape
    # N must match the entries the fitted losses actually span: the fit
    # densifies sparse input and sums over all m*n entries unless
    # mask_zeros restricts it to the stored nonzeros — N = nnz for a
    # default sparse fit would inflate the Gaussian NLL ~1/density-fold
    # and understate the BIC penalty
    N = (data.nnz if (is_sparse and kwargs.get("mask_zeros"))
         else m * n)

    rows = []
    models = {}
    for dist in distributions:
        if verbose:
            print(f"Fitting NMF with loss = {dist} ...")
        model = nmf_api(data, k, loss=dist, maxit=maxit, seed=seed, **kwargs)
        models[dist] = model

        n_factor = k * (m + n)
        if dist == "mse":
            df = n_factor + 1
        elif dist in ("gp", "nb"):
            df = n_factor + m
        else:
            df = n_factor

        raw = model.train_loss
        if dist == "mse":
            nll = (N / 2.0) * (1.0 + math.log(2.0 * math.pi * raw / N))
        else:
            nll = raw
        rows.append({"distribution": dist, "nll": float(nll), "df": int(df),
                     "aic": 2 * nll + 2 * df, "bic": 2 * nll + df * math.log(N)})

    key = "bic" if criterion == "bic" else "aic"
    best = min(rows, key=lambda r: r[key])
    for r in rows:
        r["selected"] = r["distribution"] == best["distribution"]
    if verbose:
        print(f"Best distribution: {best['distribution']}")
    return {"loss": best["distribution"], "comparison": rows,
            "models": models, "criterion": criterion,
            # legacy aliases (pre-round-2 key names)
            "best": best["distribution"], "results": rows}


def score_test_distribution(data, model=None,
                            powers: Sequence[float] = (0, 1, 2, 3),
                            *, test_nb: bool = True,
                            min_mu: float = 1e-6, **fit_kwargs) -> dict:
    """Power-variance-family score test on a fitted model
    (R/auto_distribution.R:194-267).

    For each variance power p, ``T_p = mean(r^2 / mu^p - 1)`` with
    ``r = x - mu``; under the correct model E[T_p] = 0, so the power
    minimizing ``|T_p|`` best matches the observed variance-mean
    relationship (0=gaussian, 1=gp, 2=gamma, 3=inverse_gaussian).
    Sparse inputs are scored over their nonzero entries only.  Integer
    data additionally gets the NB quadratic-overdispersion diagnostic
    ``T_NB = mean((r^2 - mu) / mu^2)`` (> 0.1 -> overdispersed).
    """
    if model is None or isinstance(model, (int, np.integer)):
        # int/None back-compat shim, as in diagnose_dispersion /
        # diagnose_zero_inflation: a rank fits a quick GP model first
        from ..api import nmf as nmf_api
        k = int(model) if model is not None else int(fit_kwargs.pop("k", 10))
        fit_kwargs.setdefault("maxit", 30)
        fit_kwargs.setdefault("seed", 42)
        model = nmf_api(data, k, loss="gp", dispersion="none", **fit_kwargs)
    mu_mat = _mu_matrix(model)
    try:
        import scipy.sparse as sp
        is_sparse = sp.issparse(data)
    except ImportError:
        is_sparse = False
    if is_sparse:
        coo = data.tocoo()
        nz = coo.data != 0
        x_obs = np.asarray(coo.data[nz], dtype=np.float64)
        mu_obs = np.maximum(mu_mat[coo.row[nz], coo.col[nz]], min_mu)
    else:
        x_obs = _dense(data).ravel()
        mu_obs = np.maximum(mu_mat.ravel(), min_mu)
    r2 = (x_obs - mu_obs) ** 2

    scores = []
    for p in powers:
        T_p = float(np.mean(r2 / mu_obs ** p - 1.0))
        label = _POWER_LABELS.get(p, f"power_{p}")
        scores.append({"power": float(p), "T_stat": T_p, "abs_T": abs(T_p),
                       "distribution": label})
    best = min(scores, key=lambda s: s["abs_T"])
    result = {"scores": scores, "best_power": best["power"],
              "best_distribution": best["distribution"]}

    if test_nb and np.all(x_obs == np.round(x_obs)):
        T_NB = float(np.mean((r2 - mu_obs) / mu_obs ** 2))
        result["nb_diagnostic"] = {"T_NB": T_NB,
                                   "overdispersed": T_NB > 0.1}
    return result


def diagnose_zero_inflation(data, model=None, threshold: float = 0.05,
                            **fit_kwargs) -> dict:
    """Excess-zero diagnostic on a fitted model
    (R/auto_distribution.R:304-367).

    Expected zeros under the Poisson baseline ``P(X=0) = exp(-mu)`` are
    compared per row and per column against the observed zero counts;
    the recommended ``zi_mode`` is picked from the variance structure of
    the excess rates.

    ``model`` may be omitted: a quick GP baseline is fitted internally
    (``**fit_kwargs`` forwarded, e.g. ``k=``/``maxit=``).
    """
    if model is None or isinstance(model, (int, np.integer)):
        from ..api import nmf as nmf_api
        k = int(model) if model is not None else int(fit_kwargs.pop("k", 10))
        fit_kwargs.setdefault("maxit", 30)
        fit_kwargs.setdefault("seed", 42)
        model = nmf_api(data, k, loss="gp", dispersion="none", **fit_kwargs)
    m, n = data.shape
    try:
        import scipy.sparse as sp
        is_sparse = sp.issparse(data)
    except ImportError:
        is_sparse = False
    if is_sparse:
        csc = data.tocsc()
        obs_zeros_per_col = m - np.diff(csc.indptr)
        row_nz = np.bincount(csc.indices, minlength=m)
        obs_zeros_per_row = n - row_nz
    else:
        A = _dense(data)
        obs_zeros_per_row = (A == 0).sum(axis=1)
        obs_zeros_per_col = (A == 0).sum(axis=0)

    mu = np.maximum(_mu_matrix(model), 1e-8)
    expected_zero_prob = np.exp(-mu)
    expected_per_row = expected_zero_prob.sum(axis=1)
    expected_per_col = expected_zero_prob.sum(axis=0)

    row_excess = np.maximum(0.0, (obs_zeros_per_row - expected_per_row) / n)
    col_excess = np.maximum(0.0, (obs_zeros_per_col - expected_per_col) / m)
    global_excess = float(np.concatenate([row_excess, col_excess]).mean())
    has_zi = global_excess > threshold

    if not has_zi:
        zi_mode = "none"
    else:
        col_structured = float(np.var(col_excess)) > 0.001
        zi_mode = "col" if col_structured else "row"

    return {"excess_zero_rate": global_excess, "has_zi": has_zi,
            "zi_mode": zi_mode, "row_excess": row_excess,
            "col_excess": col_excess,
            # legacy aliases (pre-round-2 key names)
            "excess_zeros": global_excess, "zero_inflated": has_zi,
            "zi": zi_mode,
            "observed_zero_fraction":
                float(obs_zeros_per_row.sum()) / (m * n)}


def _trimmed_mean(x: np.ndarray, trim: float = 0.1, axis=None):
    """R ``mean(x, trim=)``: drop the floor(trim*n) smallest and largest."""
    x = np.sort(x, axis=axis)
    if axis is None:
        n = x.size
        g = int(math.floor(trim * n))
        return float(x[g:n - g].mean()) if n > 2 * g else float(x.mean())
    n = x.shape[axis]
    g = int(math.floor(trim * n))
    if n <= 2 * g:
        return x.mean(axis=axis)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(g, n - g)
    return x[tuple(sl)].mean(axis=axis)


def diagnose_dispersion(data, model=None, cv_threshold: float = 0.5,
                        min_mu: float = 1e-6, **fit_kwargs) -> dict:
    """Dispersion-mode recommendation (R/auto_distribution.R:405-460).

    Moment estimates ``phi = r^2 / mu^p`` (p from the fitted loss) are
    trimmed-averaged per row and per column; a coefficient of variation
    above ``cv_threshold`` means that axis has structured dispersion.
    """
    if model is None or isinstance(model, (int, np.integer)):
        from ..api import nmf as nmf_api
        k = int(model) if model is not None else int(fit_kwargs.pop("k", 10))
        fit_kwargs.setdefault("maxit", 30)
        fit_kwargs.setdefault("seed", 42)
        model = nmf_api(data, k, loss="gp", dispersion="none", **fit_kwargs)
    mu = np.maximum(_mu_matrix(model), min_mu)

    cfg = model.misc.get("config") if isinstance(model.misc, dict) else None
    loss_type = getattr(getattr(cfg, "loss", None), "value", "mse")
    p = {"mse": 0, "gaussian": 0, "gp": 1, "kl": 1, "gamma": 2,
         "inverse_gaussian": 3, "nb": 1}.get(loss_type, 0)

    A = _dense(data)
    phi_elem = (A - mu) ** 2 / mu ** p

    row_phi = _trimmed_mean(phi_elem, axis=1)
    col_phi = _trimmed_mean(phi_elem, axis=0)
    global_phi = _trimmed_mean(phi_elem.ravel())

    row_cv = float(np.std(row_phi, ddof=1) / np.mean(row_phi))
    col_cv = float(np.std(col_phi, ddof=1) / np.mean(col_phi))

    if row_cv > cv_threshold and col_cv > cv_threshold:
        mode = "per_row" if row_cv >= col_cv else "per_col"
    elif row_cv > cv_threshold:
        mode = "per_row"
    elif col_cv > cv_threshold:
        mode = "per_col"
    else:
        mode = "global"

    # Pearson dispersion (~1 for Poisson) retained from the pre-round-2
    # surface; useful standalone overdispersion signal
    pearson = float(((A - mu) ** 2 / mu).mean())
    return {"mode": mode, "global_phi": float(global_phi),
            "row_cv": row_cv, "col_cv": col_cv,
            "pearson_dispersion": pearson,
            "overdispersed": pearson > 1.5}
