"""The NMF result container (core/result.hpp:71).

The port's counterpart of ``rcppml_tpu/result.py::NMFResult``: plain numpy
arrays on the host, whatever device the fit ran on.

Factor model convention (core/types.hpp:99-107):
    ``A ≈ W @ diag(d) @ H`` with W (m, k), d (k,), H (k, n); rows of H and
    columns of W are L1-normalized by default, with scale absorbed into d.
"""

from __future__ import annotations

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
    loss_history: Optional[np.ndarray] = None       # per-iteration train loss
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

    def reconstruct(self) -> np.ndarray:
        """W diag(d) H."""
        return (self.W * self.d[None, :]) @ self.H

    def __repr__(self):
        m, n = self.shape
        return (f"NMFResult(k={self.k}, shape=({m}, {n}), "
                f"iters={self.iterations}, converged={self.converged}, "
                f"train_loss={self.train_loss:.6g})")
