"""The result containers (core/result.hpp:71, core/svd_result.hpp:20).

The port's counterparts of ``rcppml_tpu/result.py::NMFResult`` and
``SVDResult``: plain numpy arrays on the host, whatever device the fit ran
on.

Factor model convention (core/types.hpp:99-107):
    ``A ≈ W @ diag(d) @ H`` with W (m, k), d (k,), H (k, n); rows of H and
    columns of W are L1-normalized by default, with scale absorbed into d.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class NMFResult:
    W: np.ndarray                      # (m, k)
    d: np.ndarray                      # (k,)
    H: np.ndarray                      # (k, n)
    iterations: int = 0
    converged: bool = False
    final_tol: float = float("nan")
    train_loss: float = float("nan")
    test_loss: float = float("nan")
    best_iter: int = -1
    loss_history: Optional[np.ndarray] = None       # per-iteration train loss
    test_loss_history: Optional[np.ndarray] = None  # per-iteration test loss (CV)
    theta: Optional[np.ndarray] = None              # GP theta / NB size
    dispersion: Optional[np.ndarray] = None         # Gamma/IG/Tweedie phi
    pi_row: Optional[np.ndarray] = None             # ZI dropout probs per row
    pi_col: Optional[np.ndarray] = None             # ZI dropout probs per col
    # section -> milliseconds, from a profiled or step-mode fit
    profile: Dict[str, Any] = field(default_factory=dict)
    misc: Dict[str, Any] = field(default_factory=dict)
    row_names: Optional[np.ndarray] = None          # A's rownames -> W rows
    col_names: Optional[np.ndarray] = None          # A's colnames -> H cols

    @property
    def k(self) -> int:
        return int(self.d.shape[0])

    @property
    def shape(self):
        return (self.W.shape[0], self.H.shape[1])

    def dimnames(self):
        """(rownames of W, colnames of H)."""
        return (self.row_names, self.col_names)

    def sort(self, decreasing: bool = True) -> "NMFResult":
        """Sort factors by d (result.hpp sort(); R sort(decreasing=))."""
        d = np.asarray(self.d)
        order = np.argsort(-d if decreasing else d, kind="stable")
        self.W = self.W[:, order]
        self.d = self.d[order]
        self.H = self.H[order, :]
        return self

    def head(self, n: int = 6) -> np.ndarray:
        """First rows of W (R head.nmf)."""
        return np.asarray(self.W)[:n]

    def reconstruct(self) -> np.ndarray:
        """W diag(d) H."""
        return (self.W * self.d[None, :]) @ self.H

    def sparsity(self):
        """Per-factor zero fractions (R/nmf_methods.R:222-233): one row per
        factor per side, as a dict of columns (factor, sparsity, model),
        with the side means under "W" and "H"."""
        w = np.asarray(self.W)
        h = np.asarray(self.H)
        k = self.k
        names = [f"factor{i + 1}" for i in range(k)]
        sw = np.mean(w == 0, axis=0)
        sh = np.mean(h == 0, axis=1)
        return {
            "factor": names + names,
            "sparsity": sw.tolist() + sh.tolist(),
            "model": ["w"] * k + ["h"] * k,
            "W": float(sw.mean()),
            "H": float(sh.mean()),
        }

    # -- S4-method equivalents (R/nmf_methods.R:18-498) --------------------

    def subset_factors(self, idx) -> "NMFResult":
        """model[[i]] — keep a subset of factors."""
        idx = np.atleast_1d(np.asarray(idx))
        return NMFResult(W=self.W[:, idx], d=self.d[idx], H=self.H[idx, :],
                         iterations=self.iterations, converged=self.converged,
                         train_loss=self.train_loss,
                         row_names=self.row_names, col_names=self.col_names)

    def subset(self, rows=None, cols=None) -> "NMFResult":
        """model[i, j] — restrict to feature rows / sample columns."""
        W = self.W if rows is None else self.W[np.asarray(rows)]
        H = self.H if cols is None else self.H[:, np.asarray(cols)]

        def _sub(names, idx):
            return (None if names is None else
                    np.asarray(names)[np.asarray(idx)] if idx is not None
                    else names)
        return NMFResult(W=W, d=self.d.copy(), H=H,
                         iterations=self.iterations, converged=self.converged,
                         train_loss=self.train_loss,
                         row_names=_sub(self.row_names, rows),
                         col_names=_sub(self.col_names, cols))

    def t(self) -> "NMFResult":
        """Transpose the model: A' ~ H' diag(d) W'.  ``misc`` and the
        histories travel as they are; the axis-bound fields (pi_row /
        pi_col, the dimnames) swap; theta and dispersion are carried as
        estimated (test_s4_methods.R:47-51)."""
        return NMFResult(W=np.ascontiguousarray(self.H.T), d=self.d.copy(),
                         H=np.ascontiguousarray(self.W.T),
                         iterations=self.iterations, converged=self.converged,
                         train_loss=self.train_loss,
                         test_loss=self.test_loss, final_tol=self.final_tol,
                         best_iter=self.best_iter,
                         loss_history=self.loss_history,
                         test_loss_history=self.test_loss_history,
                         theta=self.theta, dispersion=self.dispersion,
                         pi_row=self.pi_col, pi_col=self.pi_row,
                         profile=self.profile,
                         row_names=self.col_names, col_names=self.row_names,
                         misc=dict(self.misc))

    def prod(self) -> np.ndarray:
        """W diag(d) H (the `prod` S4 method)."""
        return self.reconstruct()

    def predict(self, newdata, **kw) -> np.ndarray:
        """Project new columns onto this model's W (R/predict_nmf.R:48);
        returns H_new (k, n_new).  See :func:`models.project.predict`."""
        from .models.project import predict as _predict
        return _predict(self, newdata, **kw)

    def summary(self, group_by) -> np.ndarray:
        """Mean factor weight per sample group: (k, n_groups), groups in
        sorted order (R/nmf_methods.R summary(group_by)); the input of
        :func:`rcppml_tpu_torch.utils.plots.plot_summary`."""
        groups = np.asarray(group_by)
        lvls = np.unique(groups)
        out = np.zeros((self.k, len(lvls)), dtype=np.float64)
        for gi, g in enumerate(lvls):
            out[:, gi] = np.asarray(self.H)[:, groups == g].mean(axis=1)
        return out

    def align_to(self, ref: "NMFResult",
                 method: str = "cosine") -> "NMFResult":
        """Permute factors to best match a reference model (Hungarian on
        cosine or Pearson correlation; R/nmf_methods.R:261-271 `align`)."""
        W = np.asarray(self.W)
        Wr = np.asarray(ref.W)
        if W.shape != Wr.shape:
            raise ValueError("dimensions of object W and ref W are not "
                             "identical")
        if method == "cosine":
            from .models.clustering import align_factors
            perm, _ = align_factors(Wr, W)
        elif method == "cor":
            from .models.clustering import bipartite_match
            C = np.corrcoef(W, Wr, rowvar=False)[:W.shape[1], W.shape[1]:]
            cost = np.maximum(1.0 - C + 1e-10, 0.0)
            perm = bipartite_match(cost.T)["pairs"][:, 1]
        else:
            raise ValueError(f"align method {method!r}: use 'cosine' or "
                             "'cor'")
        return self.subset_factors(perm)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            rows, cols = key
            return self.subset(rows=rows, cols=cols)
        return self.subset_factors(key)

    def __repr__(self):
        m, n = self.shape
        return (f"NMFResult(k={self.k}, shape=({m}, {n}), "
                f"iters={self.iterations}, converged={self.converged}, "
                f"train_loss={self.train_loss:.6g})")


@dataclass
class SVDResult:
    U: np.ndarray                      # (m, k)
    d: np.ndarray                      # (k,)
    V: np.ndarray                      # (n, k)
    iterations: int = 0
    converged: bool = False
    k_selected: int = 0
    train_loss: float = float("nan")
    test_loss: float = float("nan")
    center: Optional[np.ndarray] = None
    scale: Optional[np.ndarray] = None
    misc: Dict[str, Any] = field(default_factory=dict)
    row_names: Optional[np.ndarray] = None          # A's rownames -> U rows
    col_names: Optional[np.ndarray] = None          # A's colnames -> V rows

    @property
    def k(self) -> int:
        return int(self.d.shape[0])

    def reconstruct(self) -> np.ndarray:
        rec = (self.U * self.d[None, :]) @ self.V.T
        if self.scale is not None:
            rec = rec * self.scale[:, None]
        if self.center is not None:
            rec = rec + self.center[:, None]
        return rec

    def variance_explained(self) -> np.ndarray:
        """Proportion of the total variance per factor: d_i^2 / ||A||_F^2
        where the gateway recorded the denominator (deflation.hpp:396-417),
        else d_i^2 / sum(d^2)."""
        d2 = np.asarray(self.d) ** 2
        fro2 = self.misc.get("frobenius_norm_sq")
        return d2 / (fro2 if fro2 else d2.sum())

    @property
    def shape(self):
        return (self.U.shape[0], self.V.shape[0])

    def subset_factors(self, idx) -> "SVDResult":
        """s[i] factor subsetting (test_svd.R:277-288)."""
        idx = np.atleast_1d(np.asarray(idx))
        return dataclasses.replace(
            self, U=np.asarray(self.U)[:, idx], d=np.asarray(self.d)[idx],
            V=np.asarray(self.V)[:, idx], k_selected=int(idx.size))

    def head(self, n: int = 6) -> np.ndarray:
        """First rows of U scaled by d (R head.svd)."""
        return (np.asarray(self.U) * np.asarray(self.d)[None, :])[:n]

    def __getitem__(self, key):
        return self.subset_factors(key)

    def predict(self, newdata) -> np.ndarray:
        """Project new samples (rows) onto the right singular vectors:
        scores = newdata @ V / d (R/svd_methods.R:141-174); each row of
        newdata is centered on its own mean when the model was centered."""
        X = np.asarray(
            newdata.todense() if hasattr(newdata, "todense") else newdata,
            dtype=np.float32)
        V = np.asarray(self.V)
        if X.shape[1] != V.shape[0]:
            raise ValueError(
                f"newdata has {X.shape[1]} features; model expects "
                f"{V.shape[0]}")
        if self.center is not None:
            X = X - X.mean(axis=1, keepdims=True)
        return (X @ V) / np.asarray(self.d)[None, :]

    def __repr__(self):
        return (f"SVDResult(k={self.k}, shape=({self.U.shape[0]}, "
                f"{self.V.shape[0]}), d[0]={float(self.d[0]):.6g})")
