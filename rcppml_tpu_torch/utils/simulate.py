"""Synthetic ground-truth generator (R/simulateNMF.R:25).

``simulate_nmf`` is ``rcppml_tpu/utils/simulate.py:16-76``, copied so that
this package never imports JAX: the same seed gives the same matrix in both
packages.  A = W H with known factors, plus noise and dropout scaled to the
signal.
"""

from __future__ import annotations

import numpy as np


def simulate_nmf(m: int = 100, n: int = 100, k: int = 5, *,
                 noise: float = 0.05, dropout: float = 0.0,
                 factor_sparsity: float = 0.5, seed: int = 42,
                 block: bool = False):
    """Generate a nonnegative matrix with known rank-k structure.

    Returns dict with keys A, W (m,k), H (k,n).  Noise is additive Gaussian
    scaled to the signal magnitude; dropout zeroes entries at random
    (recommender-style missingness).

    ``block=True`` uses the reference's block-diagonal construction
    (R/simulateNMF.R:30-56): each factor owns a disjoint row block and
    dominates a disjoint column block, with small cross-talk, factors
    L1-normalized, and noise sd scaled to the MEAN signal — "clearly
    recoverable factors even at moderate noise levels", the construction
    the rank-recovery vignette relies on (cross-validation.Rmd:101).
    """
    rs = np.random.RandomState(seed)
    if block:
        W = np.zeros((m, k), dtype=np.float64)
        bw = m // k
        for i in range(k):
            lo, hi = i * bw, (m if i == k - 1 else (i + 1) * bw)
            W[lo:hi, i] = np.abs(rs.normal(1.0, 0.3, hi - lo))
        W += np.abs(rs.normal(0.0, 0.05, (m, k)))
        H = np.zeros((k, n), dtype=np.float64)
        bh = n // k
        for i in range(k):
            lo, hi = i * bh, (n if i == k - 1 else (i + 1) * bh)
            H[i, lo:hi] = np.abs(rs.normal(1.0, 0.3, hi - lo))
        H += np.abs(rs.normal(0.0, 0.05, (k, n)))
        W = W / W.sum(axis=0, keepdims=True)
        H = H / H.sum(axis=1, keepdims=True)
        A = W @ H
        if noise > 0:
            A = A + rs.normal(0, noise * float(A.mean()), A.shape)
            A = np.maximum(A, 0)
        if dropout > 0:
            A = A * (rs.uniform(size=A.shape) >= dropout)
        return {"A": A.astype(np.float32), "W": W.astype(np.float32),
                "H": H.astype(np.float32)}
    W = rs.uniform(0, 1, (m, k)).astype(np.float32)
    H = rs.uniform(0, 1, (k, n)).astype(np.float32)
    # sparsify factors so they are identifiable
    W[rs.uniform(size=W.shape) < factor_sparsity] = 0
    H[rs.uniform(size=H.shape) < factor_sparsity] = 0
    # guard: every factor keeps some mass
    for i in range(k):
        if W[:, i].sum() == 0:
            W[rs.randint(m), i] = 1.0
        if H[i, :].sum() == 0:
            H[i, rs.randint(n)] = 1.0
    A = W @ H
    if noise > 0:
        sd = noise * float(A.std())
        A = A + rs.normal(0, sd, A.shape).astype(np.float32)
        A = np.maximum(A, 0)
    if dropout > 0:
        A = A * (rs.uniform(size=A.shape) >= dropout)
    return {"A": A.astype(np.float32), "W": W, "H": H}
