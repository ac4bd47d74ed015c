"""Guided NMF: compute_target() and refine().

Equivalents of ``R/compute_target.R:52-125`` (label centroids with optional
OAS-ZCA whitening, broadcast to a k x n target) and ``R/refine.R:70-190``
(centroid-shift correction of H + optional W-refit cycles with PROJ_ADV
batch-effect removal).

A copy of ``rcppml_tpu/utils/guided.py``: the numpy arithmetic unchanged, the
``batch=`` refit through the port's ``nmf``, on the card unless
``device="cpu"`` is given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..result import NMFResult


def compute_target(H: np.ndarray, labels, whiten: bool = True) -> np.ndarray:
    """Per-sample class-centroid shift target (R/compute_target.R:52-125).

    Returns a (k, n) matrix: each sample's column is its class centroid
    (optionally OAS-ZCA whitened) minus the grand mean.
    """
    H = np.asarray(H, dtype=np.float64)
    k, n = H.shape
    labels = np.asarray(labels)
    if labels.shape[0] != n:
        raise ValueError("length(labels) must equal ncol(H)")
    lvls, label_idx = np.unique(labels, return_inverse=True)
    C = len(lvls)

    centroids = np.zeros((k, C))
    counts = np.zeros(C, dtype=np.int64)
    for ci in range(C):
        sel = label_idx == ci
        counts[ci] = sel.sum()
        if counts[ci]:
            centroids[:, ci] = H[:, sel].mean(axis=1)
    grand_mean = centroids[:, counts > 0].mean(axis=1)

    if whiten and C > 1:
        wts = np.sqrt(np.maximum(counts, 1))
        X = (centroids - grand_mean[:, None]) * wts[None, :]
        n_eff = counts.sum()
        S = (X @ X.T) / n_eff
        trS = np.trace(S)
        trS2 = float((S * S).sum())
        rho_num = (1 - 2.0 / k) * trS2 + trS ** 2
        rho_den = (n_eff + 1 - 2.0 / k) * (trS2 - trS ** 2 / k)
        rho = 1.0 if abs(rho_den) < 1e-12 else min(1.0, max(0.0, rho_num / rho_den))
        S_shrunk = (1 - rho) * S + rho * (trS / k) * np.eye(k)
        vals, V = np.linalg.eigh(S_shrunk)
        vals = np.maximum(vals, 1e-10)
        W_zca = (V / np.sqrt(vals)[None, :]) @ V.T
        centroids = W_zca @ centroids
        grand_mean = W_zca @ grand_mean

    shift = centroids - grand_mean[:, None]
    target = np.zeros((k, n))
    target[:, :] = shift[:, label_idx]
    return target.astype(np.float32)


def refine(x, labels, *, data=None, batch=None, lambda_: float = 0.8,
           cycles: int = 0, nonneg: bool = True, whiten: bool = True,
           device=None):
    """Centroid-guided refinement of an embedding (R/refine.R:70-190).

    Stage 1: ``H_corr = H + lambda * frobenius_scaled(compute_target(H))``.
    Stage 2 (cycles > 0, needs ``data``): alternately refit W from the
    corrected H and H from the new W; with ``batch`` given, the H-refit runs
    one NMF iteration with negative target_lambda (PROJ_ADV batch removal).
    Returns an NMFResult (when x is one) or the corrected H matrix.
    ``device``: where the ``batch`` refit runs, as for :func:`nmf`.
    """
    is_model = isinstance(x, NMFResult)
    if is_model:
        H = np.asarray(x.H, dtype=np.float64)
        W = np.asarray(x.W, dtype=np.float64)
        d = np.asarray(x.d, dtype=np.float64)
    else:
        H = np.asarray(x, dtype=np.float64)
        W = d = None
    k, n = H.shape
    labels = np.asarray(labels)
    if not (0.0 <= lambda_ <= 1.0):
        raise ValueError("lambda must be in [0, 1]")
    if cycles > 0 and data is None:
        raise ValueError("data is required when cycles > 0")
    if batch is not None and cycles <= 0:
        # stage-2 is where PROJ_ADV batch removal runs; accepting batch=
        # without cycles would silently skip the requested correction
        raise ValueError("batch-effect removal runs in the refit cycles; "
                         "set cycles >= 1 (R/refine.R applies the "
                         "negative-lambda target inside the W/H refits)")

    def corrected(Hm):
        t = compute_target(Hm, labels, whiten=whiten).astype(np.float64)
        fro_h = np.sqrt((Hm ** 2).sum())
        fro_t = np.sqrt((t ** 2).sum())
        if fro_t > 1e-10:
            t = t * (fro_h / fro_t)
        Hc = Hm + lambda_ * t
        if nonneg:
            Hc = np.maximum(Hc, 0.0)
        return Hc

    H_corr = corrected(H)

    if cycles > 0:
        # matrix input works too: the refit derives W from (data, H_corr)
        # each cycle, so no prior W is needed — only a unit scale vector
        if d is None:
            d = np.ones(k)
        from .diagnostics import _dense
        A = _dense(data)
        batch_target = (compute_target(H, batch, whiten=False)
                        if batch is not None else None)
        for _ in range(cycles):
            dH = d[:, None] * H_corr
            G = dH @ dH.T
            B = A @ dH.T
            W_new = np.linalg.solve(G + 1e-8 * np.eye(k), B.T).T
            if nonneg:
                W_new = np.maximum(W_new, 0.0)

            if batch_target is not None:
                from ..api import nmf as nmf_api
                model = nmf_api(A.astype(np.float32), k,
                                w_init=W_new.astype(np.float32), maxit=1,
                                target_H=batch_target,
                                target_lambda=-lambda_, sort_model=False,
                                device=device)
                W_new = np.asarray(model.W, dtype=np.float64)
                d_new = np.asarray(model.d, dtype=np.float64)
                H_new = np.asarray(model.H, dtype=np.float64)
            else:
                WtW = W_new.T @ W_new
                WtA = A.T @ W_new
                H_new = np.linalg.solve(WtW + 1e-8 * np.eye(k), WtA.T)
                if nonneg:
                    H_new = np.maximum(H_new, 0.0)
                d_new = np.sqrt((H_new ** 2).sum(axis=1))
                d_new = np.maximum(d_new, 1e-10)
                H_new = H_new / d_new[:, None]
                W_new = W_new * d_new[None, :]
                d_new = np.sqrt((W_new ** 2).sum(axis=0))
                d_new = np.maximum(d_new, 1e-10)
                W_new = W_new / d_new[None, :]

            W, d, H = W_new, d_new, H_new
            H_corr = corrected(H)

    if is_model:
        out = NMFResult(W=np.asarray(W, np.float32) if W is not None else x.W,
                        d=np.asarray(d, np.float32) if d is not None else x.d,
                        H=H_corr.astype(np.float32),
                        iterations=x.iterations, converged=x.converged,
                        train_loss=x.train_loss)
        out.misc["refined"] = True
        return out
    return H_corr.astype(np.float32)
