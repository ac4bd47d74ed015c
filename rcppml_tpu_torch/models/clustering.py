"""Rank-2 divisive clustering, consensus NMF and factor matching.

The port of ``rcppml_tpu/models/clustering.py`` (``inst/include/FactorNet/
clustering/`` and ``R/{bipartition,dclust,consensus}.R`` of the reference):

  * :func:`bipartition` — rank-2 NMF with the closed-form 2x2 NNLS solve
    (clustering/bipartition.hpp:190-222) over all selected columns at once
    on the fit's device; samples split by the sign of h1 - h2
    (bipartition.hpp:377-407).
  * :func:`dclust` — recursive divisive clustering with binary path ids
    (clustering/dclust.hpp:38-80).  A goes to the device once; each node's
    columns are an ``index_select`` there.
  * :func:`consensus_nmf` — multi-run NMF -> consensus matrix -> cophenetic
    stability (R/consensus.R:75), the consensus summed on the device.
  * :func:`bipartite_match`, :func:`align_factors` — Hungarian factor
    alignment (R/bipartiteMatch.R:20) on scipy's ``linear_sum_assignment``.

Where the JAX package runs the rank-2 ALS as one ``lax.while_loop`` over
blocks of ten sweeps, here the ten sweeps of a block are enqueued on the
device and the host reads the block's convergence scalar once: at most
``max(1, maxit // 10)`` reads a split, counted in ``_rank2_als.host_reads``
as the kernels count their launches.  The ALS is torch operations in
float32 with TF32 off (the JAX package's ``PREC = HIGHEST``); no
hand-written kernel runs here, the fits of ``consensus_nmf`` run the fit
loop's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import rng as rng_mod
from .svd import _on_device


@dataclass
class BipartitionResult:
    v: np.ndarray                  # signed split signal per sample
    dist: float                    # relative-cosine separation (or -1)
    size1: int
    size2: int
    samples1: np.ndarray
    samples2: np.ndarray
    center1: Optional[np.ndarray] = None
    center2: Optional[np.ndarray] = None


@dataclass
class Cluster:
    id: str
    samples: np.ndarray
    center: np.ndarray
    size: int
    dist: float = -1.0
    leaf: bool = True


def _nnls2_batch(a00, a01, a11, b0, b1, nonneg):
    """Closed-form 2x2 (N)NLS for a batch of RHS (bipartition.hpp:190-203)."""
    denom = a00 * a11 - a01 * a01
    denom = torch.where(denom.abs() > 1e-30, denom, 1e-30)
    x0 = (b0 * a11 - b1 * a01) / denom
    x1 = (b1 * a00 - b0 * a01) / denom
    if nonneg:
        x0 = x0.clamp_min(0.0)
        x1 = x1.clamp_min(0.0)
    return x0, x1


def _rank2_body(A_sub, w, nonneg=True):
    """One rank-2 ALS sweep over all selected columns (bipartition.hpp:342-371).

    A_sub (m, ns); w (2, m).  Returns (w_new, h, d)."""
    a = w @ w.T
    B = w @ A_sub                                  # (2, ns)
    h0, h1 = _nnls2_batch(a[0, 0], a[0, 1], a[1, 1], B[0], B[1], nonneg)
    h = torch.stack([h0, h1])
    d = h.abs().sum(dim=1) + 1e-15
    h = h / d[:, None]

    a2 = h @ h.T
    Bw = h @ A_sub.T                               # (2, m)
    w0, w1 = _nnls2_batch(a2[0, 0], a2[0, 1], a2[1, 1], Bw[0], Bw[1], nonneg)
    w_new = torch.stack([w0, w1])
    dw = w_new.abs().sum(dim=1) + 1e-15
    w_new = w_new / dw[:, None]
    return w_new, h, dw


def _rank2_block(A_sub, w, h, d, nonneg=True):
    """Ten ALS sweeps plus the correlation-distance convergence metric
    between the first and last w (cor() tol), a 0-d tensor."""
    w_start = w
    for _ in range(10):
        w, h, d = _rank2_body(A_sub, w, nonneg)
    a = w.reshape(-1)
    b = w_start.reshape(-1)
    am = a - a.mean()
    bm = b - b.mean()
    denom = ((am * am).sum() * (bm * bm).sum()).sqrt()
    cor = torch.where(denom > 0, (am * bm).sum() / denom, 1.0)
    return w, h, d, 1.0 - cor


def _rank2_als(A_sub, w, h, d, tol, max_blocks, nonneg=True):
    """The whole bipartition ALS: blocks of ten sweeps until the block's
    correlation distance falls below ``tol`` or ``max_blocks`` ran (the JAX
    package's ``_rank2_als_full``).  One host read a block, counted in
    ``_rank2_als.host_reads``."""
    cd, blk = float("inf"), 0
    while blk < max_blocks and cd >= tol:
        w, h, d, cd_t = _rank2_block(A_sub, w, h, d, nonneg)
        cd = float(cd_t)
        _rank2_als.host_reads += 1
        blk += 1
    return w, h, d


_rank2_als.host_reads = 0


def _rel_cosine_dev(A_sub, pos):
    """Relative cosine separation (bipartition.hpp:92-130) and the two
    centers, on A's device.  ``pos`` (ns,) bool.  Returns (dist, center1,
    center2) as tensors."""
    posf = pos.to(torch.float32)
    n1 = posf.sum().clamp_min(1.0)
    n2 = (1.0 - posf).sum().clamp_min(1.0)
    center1 = (A_sub @ posf) / n1
    center2 = (A_sub @ (1.0 - posf)) / n2
    c1n = (center1 ** 2).sum().sqrt()
    c2n = (center2 ** 2).sum().sqrt()
    x_c1 = center1 @ A_sub
    x_c2 = center2 @ A_sub
    d1 = (x_c2.clamp_min(0.0).sqrt() * c1n) / \
        (x_c1.clamp_min(1e-30).sqrt() * c2n)
    d2 = (x_c1.clamp_min(0.0).sqrt() * c2n) / \
        (x_c2.clamp_min(1e-30).sqrt() * c1n)
    term = torch.where(pos, d1, d2)
    term = torch.where(term.isnan(), 0.0, term)
    dist = 1.0 - term.sum() / A_sub.shape[1]
    return torch.where((c1n > 0) & (c2n > 0), dist, -1.0), center1, center2


def _split(A_dev, samples, *, tol, maxit, nonneg, seed,
           calc_dist) -> BipartitionResult:
    """One bipartition of the columns ``samples`` (host indices, or None for
    all) of ``A_dev``, a float32 matrix on the fit's device."""
    m, n = A_dev.shape
    dev = A_dev.device
    if samples is None:
        samples = np.arange(n)
        A_sub = A_dev
    else:
        samples = np.asarray(samples)
        A_sub = A_dev.index_select(
            1, torch.from_numpy(samples.astype(np.int64)).to(dev))

    # row-major 2 x m init from the sequential stream (bipartition.hpp:438-444)
    vals = rng_mod.next_u64(seed if seed != 0 else 12345, 2 * m)
    w = torch.from_numpy((vals.astype(np.float32) / np.float32(2 ** 64))
                         .reshape(2, m)).to(dev)
    h = torch.zeros((2, len(samples)), dtype=torch.float32, device=dev)
    d = torch.ones((2,), dtype=torch.float32, device=dev)
    w, h, d = _rank2_als(A_sub, w, h, d, float(np.float32(tol)),
                         max(1, maxit // 10), nonneg=bool(nonneg))

    h_np = h.cpu().numpy()
    d_np = d.cpu().numpy()
    if d_np[0] > d_np[1]:
        v = h_np[0] - h_np[1]
    else:
        v = h_np[1] - h_np[0]
    pos = v > 0
    samples1 = samples[pos]
    samples2 = samples[~pos]

    dist = -1.0
    center1 = center2 = None
    if calc_dist and len(samples1) and len(samples2):
        dist_t, c1, c2 = _rel_cosine_dev(A_sub, torch.from_numpy(pos).to(dev))
        dist = float(dist_t)
        center1, center2 = c1.cpu().numpy(), c2.cpu().numpy()

    return BipartitionResult(v=v, dist=dist, size1=int(pos.sum()),
                             size2=int((~pos).sum()),
                             samples1=samples1, samples2=samples2,
                             center1=center1, center2=center2)


def bipartition(data, *, tol: float = 1e-5, maxit: int = 100,
                nonneg: bool = True, samples=None, seed: int = 0,
                calc_dist: bool = True, device=None) -> BipartitionResult:
    """Rank-2 NMF split of samples (columns) — R/bipartition.R:62,
    clustering/bipartition.hpp:426-452.

    ``data``: numpy array, scipy sparse matrix or 2-D tensor; ``samples``:
    the columns to split (all by default).  ``device``: where the split
    runs; by default a tensor's own device, and the CUDA card for a host
    array (without a card that raises; ``device="cpu"`` runs on the CPU).
    The ALS, the centers and the relative-cosine separation run there; the
    result is numpy."""
    return _split(_on_device(data, device), samples, tol=tol, maxit=maxit,
                  nonneg=nonneg, seed=seed, calc_dist=calc_dist)


def dclust(data, *, min_samples: int = 10, min_dist: float = 0.0,
           tol: float = 1e-5, maxit: int = 100, nonneg: bool = True,
           seed: int = 0, max_depth: int = 100,
           device=None) -> List[Cluster]:
    """Recursive divisive clustering (clustering/dclust.hpp:72+).

    Cluster ids are binary path strings ("0", "01", "011", ...); a node at
    depth ``len(id)`` splits with seed ``seed + depth``.  ``device`` as for
    :func:`bipartition`: A goes there once."""
    A_dev = _on_device(data, device)
    n = A_dev.shape[1]

    result: List[Cluster] = []
    queue = [Cluster(id="0", samples=np.arange(n),
                     center=A_dev.mean(dim=1).cpu().numpy(), size=n)]
    while queue:
        cl = queue.pop(0)
        depth = len(cl.id)
        if cl.size < 2 * min_samples or depth >= max_depth:
            result.append(cl)
            continue
        bp = _split(A_dev, cl.samples, tol=tol, maxit=maxit, nonneg=nonneg,
                    seed=seed + depth, calc_dist=True)
        if (bp.size1 < min_samples or bp.size2 < min_samples or
                (min_dist > 0 and bp.dist < min_dist)):
            cl.dist = bp.dist
            result.append(cl)
            continue
        cl.leaf = False
        queue.append(Cluster(id=cl.id + "0", samples=bp.samples1,
                             center=bp.center1, size=bp.size1, dist=bp.dist))
        queue.append(Cluster(id=cl.id + "1", samples=bp.samples2,
                             center=bp.center2, size=bp.size2, dist=bp.dist))
    return result


def bipartite_match(cost_matrix) -> dict:
    """Hungarian assignment (R/bipartiteMatch.R:20, RcppHungarian.h)."""
    from scipy.optimize import linear_sum_assignment
    cost = np.asarray(cost_matrix, dtype=np.float64)
    rows, cols = linear_sum_assignment(cost)
    return {"cost": float(cost[rows, cols].sum()),
            "pairs": np.stack([rows, cols], axis=1)}


def align_factors(ref_W: np.ndarray, W: np.ndarray):
    """Align factor columns of W to ref_W by Hungarian on cosine distance
    (R/nmf_methods.R `align`)."""
    rn = ref_W / np.maximum(np.linalg.norm(ref_W, axis=0), 1e-15)
    wn = W / np.maximum(np.linalg.norm(W, axis=0), 1e-15)
    cos = rn.T @ wn
    match = bipartite_match(1.0 - cos)
    perm = match["pairs"][:, 1]
    return perm, cos[np.arange(len(perm)), perm]


def _knn_jaccard(H: torch.Tensor, knn: int) -> torch.Tensor:
    """Co-clustering by shared k-NN sets in the embedding H.T (n, k), on
    H's device, in float64: entry (i, j) is ``inter / (2 knn - inter)``
    with ``inter`` the number of neighbours i and j share (0 where none),
    and 1 on the diagonal.

    The squared distances are the JAX package's formula, the sum over the
    k coordinates of the squared differences.  Each sample's ``knn``
    nearest neighbours are its row of a stable sort, the first entry (the
    sample itself) dropped: tied distances order by column index.  The JAX
    package's ``np.argsort`` is not stable, so the two may differ where a
    sample has two neighbours at the same distance, as a duplicated column
    of H has."""
    E = H.T
    n = E.shape[0]
    nbrs = torch.empty((n, knn), dtype=torch.int64, device=E.device)
    # rows at a time: the (rows, n, k) differences stay below ~64 MB
    rows = max(1, (1 << 24) // max(n * E.shape[1], 1))
    for r0 in range(0, n, rows):
        d2 = ((E[r0:r0 + rows, None, :] - E[None]) ** 2).sum(-1)
        order = torch.sort(d2, dim=1, stable=True).indices
        nbrs[r0:r0 + rows] = order[:, 1:knn + 1]
    ind = torch.zeros((n, n), dtype=torch.float32, device=E.device)
    ind.scatter_(1, nbrs, 1.0)
    # sums of at most knn products of 0 and 1: exact in any order
    inter = (ind @ ind.T).to(torch.float64)
    jac = torch.where(inter > 0, inter / (2 * knn - inter), 0.0)
    jac.fill_diagonal_(1.0)
    return jac


def consensus_nmf(data, k: int, *, n_runs: int = 10, seed: int = 0,
                  method: str = "hard", maxit: int = 100, tol: float = 1e-4,
                  **nmf_kwargs) -> dict:
    """Multi-run NMF consensus clustering (R/consensus.R:75).

    Run ``r`` fits with seed ``seed + r * 1000 + 1``.  ``method='hard'``:
    samples co-cluster when their argmax factor matches (a product of
    one-hot label matrices); ``'knn_jaccard'``: the Jaccard index of their
    k-NN sets in H (:func:`_knn_jaccard`).  The consensus is summed on the
    fit's device in float64; ``device=`` among ``nmf_kwargs`` is the fit's
    (A goes there once).  Returns the consensus matrix, the cophenetic
    correlation (scipy, on the host), the runs and the first run's labels.
    """
    from ..api import nmf as nmf_api
    A = _on_device(data, nmf_kwargs.pop("device", None))
    dev = A.device
    n = A.shape[1]
    runs = []
    consensus = torch.zeros((n, n), dtype=torch.float64, device=dev)
    for r in range(n_runs):
        res = nmf_api(A, k, seed=seed + r * 1000 + 1, maxit=maxit, tol=tol,
                      **nmf_kwargs)
        runs.append(res)
        H = torch.from_numpy(res.H).to(dev)
        if method == "knn_jaccard":
            consensus += _knn_jaccard(H, min(15, n - 1))
        else:
            onehot = torch.nn.functional.one_hot(
                H.argmax(dim=0), num_classes=H.shape[0]).to(torch.float64)
            consensus += onehot @ onehot.T
    consensus = (consensus / n_runs).cpu().numpy()

    # cophenetic correlation of the consensus matrix (stability measure)
    from scipy.cluster.hierarchy import cophenet, linkage
    from scipy.spatial.distance import squareform
    dist = 1.0 - consensus
    np.fill_diagonal(dist, 0.0)
    dist = (dist + dist.T) / 2
    cond = squareform(dist, checks=False)
    if cond.size and cond.max() > 0:
        Z = linkage(cond, method="average")
        coph, _ = cophenet(Z, cond)
        coph = float(coph)
    else:
        coph = 1.0
    labels = np.argmax(runs[0].H, axis=0)
    return {"consensus": consensus, "cophenetic": coph, "runs": runs,
            "labels": labels, "k": k}
