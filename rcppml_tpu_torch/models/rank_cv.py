"""Automatic rank determination via speckled CV (nmf/rank_cv.hpp:114-271).

The port of ``rcppml_tpu/models/rank_cv.py``.

Phase 1: exponential search (k, 2k, 4k, ...) until overfitting: train loss
converged across consecutive ranks while test loss increased.
Phase 2: golden-section refinement inside the [k_low, k_high] bracket.
Returns the conservative lower bound, then refits at k_optimal
(R/nmf_thin.R:922-1009).  Every fit runs on the search's device: the matrix
goes there once.
"""

from __future__ import annotations

import math

import numpy as np

from .nmf import device_matrix, fit_device
from .nmf_cv import fit_cv_or_masked

_PHI = (1.0 + math.sqrt(5.0)) / 2.0


def _evaluate_rank(A, k, base_cfg_kwargs, cache, mask=None):
    if k in cache:
        return cache[k]
    from ..api import build_config
    kw = dict(base_cfg_kwargs)
    # The reference's rank search always runs the CD solver in its CV fits
    # (RcppFunctions_nmf.cpp:217 sets solver_mode=2, which fit_cv.hpp:463-473
    # dispatches to cd_nnls_col_fixed for every mode != 1).  CD descends the
    # per-column objective monotonically; cholesky+clip does not (the clip is
    # a projection, not a solve), and its loss oscillation at k >> k_true
    # destroys the overfitting signal the search depends on.
    kw.setdefault("solver", "cd")
    # Rank-dependent seed for initialization diversity (rank_cv.hpp:79-82)
    seed = kw.get("seed")
    if isinstance(seed, (int, np.integer)) and seed > 0:
        kw["seed"] = int(seed) + int(k)
    cfg = build_config(int(k), **kw)
    # the user mask must hold out of every rank-search fit, not just the
    # final refit: corrupt or missing entries would otherwise drive the
    # train/test losses and the k decision
    res = fit_cv_or_masked(A, cfg, mask=mask)
    ev = {"rank": int(k), "train": res.train_loss, "test": res.test_loss,
          "best_test": res.misc["best_test_loss"], "best_iter": res.best_iter}
    cache[k] = ev
    return ev


def find_optimal_rank(A, *, k_init: int = 2, max_k: int = 50,
                      bracket_tol: int = 2, test_fraction: float = 0.1,
                      cv_seed: int = 0, refit: bool = True, verbose=False,
                      mask=None, criterion: str = "train", device=None,
                      **kwargs):
    """Exponential + golden-section rank search; returns the final NMF fit at
    k_optimal (with ``misc['rank_search']`` holding the evaluations), or the
    search dict when ``refit=False``.

    ``criterion``: ``"train"`` (default) reproduces the reference's bracket
    rule exactly: overfitting is flagged when train loss saturates (<1%
    change across a rank doubling) while test loss rises
    (rank_cv.hpp:139-158).  That rule keys on model capacity, not truth:
    while a model can still fit noise, train keeps dropping >1% and the
    bracket never fires, so the search returns max_k on noisy data.
    ``criterion="test"`` (extension) brackets on the test loss itself,
    overfitting the moment test rises across a doubling, which recovers
    planted ranks on simulateNMF-style data.

    ``device``: where the fits run, as in ``nmf_fit`` (the CUDA card for a
    host array unless ``device="cpu"``)."""
    if criterion not in ("train", "test"):
        raise ValueError("criterion must be 'train' (reference rule) or "
                         "'test'")
    if np.ndim(A) != 2:
        raise ValueError("data must be a 2-D matrix")
    A = device_matrix(A, fit_device(A, device))
    max_k = min(max_k, min(A.shape))
    kwargs.pop("test_fraction", None)
    base = dict(test_fraction=test_fraction, cv_seed=cv_seed, **kwargs)
    cache: dict = {}
    evals = []

    # Phase 1: exponential search (rank_cv.hpp:114-176)
    k_low = k_high = -1
    overfit = False
    k_current = k_init
    prev = prev2 = None
    while k_current <= max_k:
        cur = _evaluate_rank(A, k_current, base, cache, mask=mask)
        evals.append(cur)
        if prev is not None:
            if criterion == "train":
                train_rel = (abs(cur["train"] - prev["train"])
                             / (prev["train"] + 1e-15))
                hit = train_rel < 0.01 and cur["test"] > prev["test"]
                if hit:
                    k_low, k_high = prev["rank"], cur["rank"]
            else:
                # best-iteration test loss (per-fit minimum), not the final
                # iteration's: a fixed maxit lets higher-rank fits drift past
                # their own minimum, biasing the decision low; and require a
                # >0.1% relative rise so a noise-level uptick on a plateau
                # does not end the search early
                hit = (cur["best_test"]
                       > prev["best_test"] * (1.0 + 1e-3))
                if hit:
                    # test rose between prev and cur: the minimum lies in
                    # (prev2, cur); prev is an interior point of the
                    # unimodal bracket, not its lower edge
                    k_low = prev2["rank"] if prev2 is not None else k_init
                    k_high = cur["rank"]
            if hit:
                overfit = True
                break
        prev2, prev = prev, cur
        if k_current * 2 > max_k and k_current < max_k:
            k_current = max_k
        else:
            k_current *= 2

    if overfit:
        # Phase 2: golden-section refinement (rank_cv.hpp:186-229)
        lo, hi = k_low, k_high
        while (hi - lo) > bracket_tol:
            k1 = int(hi - (hi - lo) / _PHI + 0.5)
            k2 = int(lo + (hi - lo) / _PHI + 0.5)
            if k1 <= lo or k2 >= hi or k1 >= k2:
                break
            e1 = _evaluate_rank(A, k1, base, cache, mask=mask)
            e2 = _evaluate_rank(A, k2, base, cache, mask=mask)
            evals.extend([e1, e2])
            if e1["test"] < e2["test"]:
                hi = k2
            else:
                lo = k1
        if criterion == "test":
            # extension semantics: the decision is the test minimum, the
            # argmin of the per-fit best test loss over every rank evaluated
            # (the bracket from a doubling schedule can sit entirely above
            # the optimum)
            k_optimal = min(cache.values(),
                            key=lambda e: e["best_test"])["rank"]
        else:
            k_optimal = lo      # conservative lower bound (rank_cv.hpp:227)
    else:
        k_optimal = evals[-1]["rank"] if evals else k_init

    search = {"k_optimal": int(k_optimal), "overfitting_detected": overfit,
              "k_low": k_low, "k_high": k_high, "evaluations": evals}
    if not refit:
        return search

    # Refit at the selected rank without holdout (R/nmf_thin.R:970-1009)
    from ..api import nmf as nmf_api
    res = nmf_api(A, k_optimal, mask=mask, **kwargs)
    res.misc["rank_search"] = search
    return res
