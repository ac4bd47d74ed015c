"""Synthetic ground-truth generators (R/simulateNMF.R:25).

``simulate_nmf``, ``simulate_swimmer`` and ``simulate_counts`` are
``rcppml_tpu/utils/simulate.py:16-117`` and ``:157-178``, copied so that this
package never imports JAX: the same seed gives the same matrix in both
packages.  ``simulate_nmf``: A = W H
with known factors, plus noise and dropout scaled to the signal.
``simulate_counts``: Poisson or negative-binomial counts around a gamma W H,
optionally zero-inflated, for the count-distribution fits.
"""

from __future__ import annotations

from typing import Optional

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


def simulate_swimmer(size: int = 32) -> dict:
    """The classic "swimmer" benchmark (R/simulateSwimmer.R:70): 256 images
    of a stick figure with 4 limbs, each in one of 4 positions — an exactly
    rank-17 nonnegative dataset (torso + 16 limb parts).

    Returns {"A": (size*size, 256) image matrix, "images": (256, size, size)}.
    """
    c = size // 2
    torso = np.zeros((size, size), dtype=np.float32)
    torso[c - 4:c + 4, c - 1:c + 1] = 1.0

    def limb(corner: int, pos: int) -> np.ndarray:
        img = np.zeros((size, size), dtype=np.float32)
        # four attachment points around the torso
        anchors = [(c - 4, c - 1), (c - 4, c), (c + 3, c - 1), (c + 3, c)]
        ai, aj = anchors[corner]
        # four limb orientations per corner
        dirs = [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        di, dj = dirs[pos]
        for step in range(1, 7):
            ii = ai + di * step
            jj = aj + dj * step
            if 0 <= ii < size and 0 <= jj < size:
                img[ii, jj] = 1.0
        return img

    images = []
    for p0 in range(4):
        for p1 in range(4):
            for p2 in range(4):
                for p3 in range(4):
                    img = torso.copy()
                    img += limb(0, p0)
                    img += limb(1, p1)
                    img += limb(2, p2)
                    img += limb(3, p3)
                    images.append(np.clip(img, 0, 1))
    images = np.stack(images)
    A = images.reshape(256, size * size).T.astype(np.float32)
    return {"A": A, "images": images}


def simulate_counts(m: int = 80, n: int = 120, k: int = 4, *,
                    theta: float = 0.0, nb_size: Optional[float] = None,
                    zi_pi: float = 0.0, scale: float = 5.0, seed: int = 7):
    """Count-data generator for the IRLS distribution tests.

    mu = scale * W H; samples Poisson / NB(size=nb_size) and optionally
    zero-inflates with per-row dropout probability ``zi_pi``.
    """
    rs = np.random.RandomState(seed)
    W = rs.gamma(1.0, 1.0, (m, k)).astype(np.float64)
    H = rs.gamma(1.0, 1.0, (k, n)).astype(np.float64)
    mu = scale * (W @ H) / k
    if nb_size is not None:
        p = nb_size / (nb_size + mu)
        A = rs.negative_binomial(nb_size, np.clip(p, 1e-12, 1.0)).astype(np.float64)
    else:
        A = rs.poisson(mu).astype(np.float64)
    if zi_pi > 0:
        drop = rs.uniform(size=A.shape) < zi_pi
        A = A * (~drop)
    return {"A": A.astype(np.float32), "W": W.astype(np.float32),
            "H": H.astype(np.float32), "mu": mu}
