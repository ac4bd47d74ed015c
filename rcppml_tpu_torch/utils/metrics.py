"""Embedding assessment: ARI, NMI, silhouette, CV classification, batch
mixing — equivalents of ``R/assess.R:60`` and ``R/classifier_metrics.R``.

Clustering for ARI/NMI uses k-means on the embedding (as the reference's
assess kernels do); classifiers are kNN and multinomial logistic regression
implemented directly (no sklearn in the image).

A copy of ``rcppml_tpu/utils/metrics.py`` with its numpy arithmetic
unchanged: an embedding or a matrix given as a tensor (on any device) is
first taken to the host, and ``assess`` reads the port's ``NMFResult`` and
``SVDResult``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Label-agreement metrics
# ---------------------------------------------------------------------------

def adjusted_rand_index(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    C = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.int64)
    np.add.at(C, (ai, bi), 1)
    n = C.sum()

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(C).sum()
    sum_a = comb2(C.sum(axis=1)).sum()
    sum_b = comb2(C.sum(axis=0)).sum()
    expected = sum_a * sum_b / comb2(n)
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        return 1.0
    return float((sum_ij - expected) / (max_idx - expected))


def normalized_mutual_info(a, b) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    n = len(ai)
    C = np.zeros((ai.max() + 1, bi.max() + 1), dtype=np.float64)
    np.add.at(C, (ai, bi), 1)
    pij = C / n
    pi = pij.sum(axis=1)
    pj = pij.sum(axis=0)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / np.outer(pi, pj)[nz])).sum())

    def ent(p):
        p = p[p > 0]
        return float(-(p * np.log(p)).sum())

    denom = math.sqrt(ent(pi) * ent(pj))
    return mi / denom if denom > 0 else 0.0


def _sq_dists(A, B):
    """Pairwise squared distances via |a|^2 + |b|^2 - 2 a.b — an (n1, n2)
    matmul instead of the (n1, n2, d) broadcast tensor (which is ~d x the
    memory and puts moderate single-cell embeddings out of reach)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    d2 = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
    return np.maximum(d2, 0.0)


def kmeans(X: np.ndarray, k: int, *, seed: int = 0, iters: int = 50):
    """Small k-means (Lloyd) with k-means++ style seeding."""
    rs = np.random.RandomState(seed)
    n = X.shape[0]
    centers = X[rs.choice(n, 1)]
    for _ in range(k - 1):
        d2 = np.min(_sq_dists(X, centers), axis=1)
        p = d2 / max(d2.sum(), 1e-12)
        centers = np.vstack([centers, X[rs.choice(n, p=p)]])
    for _ in range(iters):
        d2 = _sq_dists(X, centers)
        lab = d2.argmin(axis=1)
        new_centers = np.vstack([
            X[lab == c].mean(axis=0) if (lab == c).any() else centers[c]
            for c in range(k)])
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    return lab, centers


def approx_silhouette(X: np.ndarray, labels, *, max_per_class: int = 200,
                      seed: int = 42) -> float:
    """Centroid-approximate silhouette (assess.R sil_samples_per_class)."""
    labels = np.asarray(labels)
    lvls, li = np.unique(labels, return_inverse=True)
    centers = np.vstack([X[li == c].mean(axis=0) for c in range(len(lvls))])
    rs = np.random.RandomState(seed)
    scores = []
    for c in range(len(lvls)):
        idx = np.where(li == c)[0]
        if len(idx) > max_per_class:
            idx = rs.choice(idx, max_per_class, replace=False)
        d = np.sqrt(_sq_dists(X[idx], centers))
        a = d[:, c]
        other = np.delete(d, c, axis=1)
        b = other.min(axis=1)
        s = (b - a) / np.maximum(np.maximum(a, b), 1e-12)
        scores.append(s)
    return float(np.concatenate(scores).mean())


# ---------------------------------------------------------------------------
# Classifiers (R/classifier_metrics.R:49-387)
# ---------------------------------------------------------------------------

def knn_classify(X_train, y_train, X_test, k: int = 15):
    d2 = _sq_dists(X_test, X_train)
    nn = np.argsort(d2, axis=1)[:, :k]
    votes = y_train[nn]
    out = np.empty(len(X_test), dtype=y_train.dtype)
    for i in range(len(X_test)):
        vals, cnt = np.unique(votes[i], return_counts=True)
        out[i] = vals[cnt.argmax()]
    return out


def logistic_classify(X_train, y_train, X_test, *, l2: float = 1e-3,
                      iters: int = 200):
    """Multinomial logistic regression via scipy L-BFGS."""
    from scipy.optimize import minimize
    lvls, yi = np.unique(y_train, return_inverse=True)
    C = len(lvls)
    n, p = X_train.shape
    Xb = np.hstack([X_train, np.ones((n, 1))])
    Y = np.eye(C)[yi]

    def loss_grad(w):
        W = w.reshape(p + 1, C)
        Z = Xb @ W
        Z -= Z.max(axis=1, keepdims=True)
        P = np.exp(Z)
        P /= P.sum(axis=1, keepdims=True)
        nll = -np.log(np.maximum((P * Y).sum(axis=1), 1e-12)).sum() / n
        nll += 0.5 * l2 * (W[:-1] ** 2).sum()
        G = Xb.T @ (P - Y) / n
        G[:-1] += l2 * W[:-1]
        return nll, G.ravel()

    res = minimize(loss_grad, np.zeros((p + 1) * C), jac=True,
                   method="L-BFGS-B", options={"maxiter": iters})
    W = res.x.reshape(p + 1, C)
    Xt = np.hstack([X_test, np.ones((len(X_test), 1))])
    return lvls[(Xt @ W).argmax(axis=1)]


class _Tree:
    """Depth-limited CART on quantile thresholds (gini)."""

    __slots__ = ("feature", "threshold", "left", "right", "label")

    def __init__(self):
        self.feature = -1
        self.label = 0

    def fit(self, X, yi, n_classes, depth, rs, max_depth, min_leaf=3):
        counts = np.bincount(yi, minlength=n_classes)
        self.label = int(counts.argmax())
        if depth >= max_depth or len(yi) < 2 * min_leaf or counts.max() == len(yi):
            return self
        p = X.shape[1]
        feats = rs.choice(p, max(1, int(np.sqrt(p))), replace=False)
        best = (None, None, 1e18)
        for f in feats:
            vals = X[:, f]
            for q in (0.25, 0.5, 0.75):
                t = np.quantile(vals, q)
                left = vals <= t
                nl = left.sum()
                if nl < min_leaf or len(yi) - nl < min_leaf:
                    continue
                gl = 1 - ((np.bincount(yi[left], minlength=n_classes) /
                           nl) ** 2).sum()
                gr = 1 - ((np.bincount(yi[~left], minlength=n_classes) /
                           (len(yi) - nl)) ** 2).sum()
                g = (nl * gl + (len(yi) - nl) * gr) / len(yi)
                if g < best[2]:
                    best = (f, t, g)
        if best[0] is None:
            return self
        self.feature, self.threshold = best[0], best[1]
        mask = X[:, self.feature] <= self.threshold
        self.left = _Tree().fit(X[mask], yi[mask], n_classes, depth + 1, rs,
                                max_depth, min_leaf)
        self.right = _Tree().fit(X[~mask], yi[~mask], n_classes, depth + 1,
                                 rs, max_depth, min_leaf)
        return self

    def predict(self, X):
        out = np.full(len(X), self.label, dtype=np.int64)
        if self.feature < 0:
            return out
        mask = X[:, self.feature] <= self.threshold
        if mask.any():
            out[mask] = self.left.predict(X[mask])
        if (~mask).any():
            out[~mask] = self.right.predict(X[~mask])
        return out


def rf_classify(X_train, y_train, X_test, *, n_trees: int = 30,
                max_depth: int = 6, seed: int = 0):
    """Random-forest classifier (the reference's classify_rf analog,
    R/classifier_metrics.R) — bootstrap + sqrt-feature CART ensemble."""
    lvls, yi = np.unique(y_train, return_inverse=True)
    C = len(lvls)
    rs = np.random.RandomState(seed)
    votes = np.zeros((len(X_test), C), dtype=np.int64)
    n = len(yi)
    for _ in range(n_trees):
        idx = rs.randint(0, n, n)
        tree = _Tree().fit(X_train[idx], yi[idx], C, 0, rs, max_depth)
        pred = tree.predict(X_test)
        votes[np.arange(len(X_test)), pred] += 1
    return lvls[votes.argmax(axis=1)]


def cv_classification_accuracy(X, y, *, classifier: str = "knn",
                               n_folds: int = 5, seed: int = 42,
                               k_nn: int = 15) -> float:
    rs = np.random.RandomState(seed)
    n = len(y)
    order = rs.permutation(n)
    folds = np.array_split(order, n_folds)
    correct = 0
    for f in range(n_folds):
        test = folds[f]
        train = np.concatenate([folds[g] for g in range(n_folds) if g != f])
        if classifier == "knn":
            pred = knn_classify(X[train], y[train], X[test], k=k_nn)
        elif classifier == "lr":
            pred = logistic_classify(X[train], y[train], X[test])
        elif classifier == "rf":
            pred = rf_classify(X[train], y[train], X[test], seed=seed)
        else:
            raise ValueError(f"unknown classifier {classifier!r}")
        correct += (pred == y[test]).sum()
    return correct / n


def batch_mixing_entropy(X, batch, *, k: int = 50, seed: int = 42,
                         n_samples: int = 500) -> float:
    """kNN batch-mixing entropy: 1 = perfectly mixed batches."""
    batch = np.asarray(batch)
    lvls, bi = np.unique(batch, return_inverse=True)
    B = len(lvls)
    if B < 2:
        return float("nan")
    rs = np.random.RandomState(seed)
    n = len(bi)
    idx = rs.choice(n, min(n_samples, n), replace=False)
    d2 = _sq_dists(X[idx], X)
    nn = np.argsort(d2, axis=1)[:, 1:k + 1]
    ents = []
    for row in nn:
        cnt = np.bincount(bi[row], minlength=B).astype(np.float64)
        p = cnt / cnt.sum()
        p = p[p > 0]
        ents.append(-(p * np.log(p)).sum() / math.log(B))
    return float(np.mean(ents))


# ---------------------------------------------------------------------------
# The assess() entry (R/assess.R:60)
# ---------------------------------------------------------------------------

def _host(x):
    """A tensor (on any device) as a numpy array; anything else unchanged."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _extract_embedding(x) -> np.ndarray:
    from ..result import NMFResult, SVDResult
    if isinstance(x, NMFResult):
        return np.asarray(x.H).T            # samples x k
    if isinstance(x, SVDResult):
        return np.asarray(x.V) * np.asarray(x.d)[None, :]
    return np.asarray(_host(x), dtype=np.float64)


def assess(x, labels, *, batch=None, metrics="all", n_folds: int = 5,
           classifiers: Sequence[str] = ("knn", "lr"), k_nn: int = 15,
           seed: int = 42, min_class_size: int = 10) -> dict:
    """Embedding quality assessment (R/assess.R:60)."""
    X = _extract_embedding(x)
    labels = np.asarray(_host(labels))
    if len(labels) != X.shape[0]:
        raise ValueError("length(labels) must equal the number of samples")

    lvls, cnts = np.unique(labels, return_counts=True)
    keep_lvls = lvls[cnts >= min_class_size]
    if len(keep_lvls) < 2:
        raise ValueError(f"fewer than 2 classes with >= {min_class_size} samples")
    keep = np.isin(labels, keep_lvls)
    X = X[keep]
    labels = labels[keep]
    if batch is not None:
        batch = np.asarray(batch)[keep]

    all_metrics = ["ari", "nmi", "silhouette", "classification",
                   "batch_mixing"]
    if metrics == "all":
        todo = [m for m in all_metrics if m != "batch_mixing" or batch is not None]
    else:
        # a bare string must stay one metric name — list("ari") would
        # split it into characters and silently compute nothing
        todo = [metrics] if isinstance(metrics, str) else list(metrics)
        unknown = sorted(set(todo) - set(all_metrics))
        if unknown:
            raise ValueError(f"unknown metrics {unknown}; valid: "
                             f"{all_metrics} or 'all'")
        if "batch_mixing" in todo and batch is None:
            raise ValueError("metrics='batch_mixing' requires batch=")

    out: dict = {"n_samples": int(X.shape[0]),
                 "n_classes": int(len(np.unique(labels)))}
    if "ari" in todo or "nmi" in todo:
        km_labels, _ = kmeans(X, len(np.unique(labels)), seed=seed)
        if "ari" in todo:
            out["ari"] = adjusted_rand_index(km_labels, labels)
        if "nmi" in todo:
            out["nmi"] = normalized_mutual_info(km_labels, labels)
    if "silhouette" in todo:
        out["silhouette"] = approx_silhouette(X, labels, seed=seed)
    if "classification" in todo:
        out["classification"] = {
            c: cv_classification_accuracy(X, labels, classifier=c,
                                          n_folds=n_folds, seed=seed,
                                          k_nn=k_nn)
            for c in classifiers}
    if "batch_mixing" in todo and batch is not None:
        out["batch_mixing"] = batch_mixing_entropy(X, batch, seed=seed)
    return out


def cosine(a, b=None) -> np.ndarray:
    """Column-wise cosine similarity (R/cosine.R:21).

    Accepts dense or scipy-sparse matrices and 1-D vectors (treated as a
    single column, matching the R matrix/vector dispatch,
    tests/testthat/test_cosine.R:35-70); a lone vector with ``b=None``
    errors like R's ``cosine(x)`` on a vector.
    """
    def _as2d(x):
        x = _host(x)
        if hasattr(x, "todense"):
            x = np.asarray(x.todense())
        x = np.asarray(x, dtype=np.float64)
        return x[:, None] if x.ndim == 1 else x

    a_is_vec = not hasattr(a, "todense") and np.ndim(_host(a)) == 1
    if b is None and a_is_vec:
        raise ValueError("cosine of a single vector needs a second "
                         "argument (R/cosine.R vector dispatch)")
    A = _as2d(a)
    B = A if b is None else _as2d(b)
    An = A / np.maximum(np.linalg.norm(A, axis=0), 1e-15)
    Bn = B / np.maximum(np.linalg.norm(B, axis=0), 1e-15)
    return An.T @ Bn


# ---------------------------------------------------------------------------
# R-style classifier evaluations (R/classifier_metrics.R:49-470)
# ---------------------------------------------------------------------------

def _classifier_eval(X, labels, predict_fn, *, test_fraction=0.2,
                     test_idx=None, seed=None):
    """Split, fit, and score; returns the reference's eval structure
    (accuracy, confusion, per_class, macro_f1, predictions, test_idx)."""
    X = np.asarray(_host(X), dtype=np.float64)
    labels = np.asarray(_host(labels))
    n = X.shape[0]
    if labels.shape[0] != n:
        raise ValueError("len(labels) must equal nrow(embedding)")
    if test_idx is None:
        rs = np.random.RandomState(42 if seed is None else seed)
        n_test = max(1, int(round(n * test_fraction)))
        test_idx = rs.choice(n, size=n_test, replace=False)
    test_idx = np.asarray(test_idx)
    train = np.setdiff1d(np.arange(n), test_idx)
    preds = np.asarray(predict_fn(X[train], labels[train], X[test_idx]))
    truth = labels[test_idx]
    classes = np.unique(labels)
    ci = {c: i for i, c in enumerate(classes)}
    confusion = np.zeros((len(classes), len(classes)), dtype=np.int64)
    for t, p in zip(truth, preds):
        confusion[ci[t], ci[p]] += 1
    per_class = []
    f1s = []
    for i, c in enumerate(classes):
        tp = confusion[i, i]
        prec = tp / max(confusion[:, i].sum(), 1)
        rec = tp / max(confusion[i, :].sum(), 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        f1s.append(f1)
        per_class.append({"class": c, "precision": float(prec),
                          "recall": float(rec), "f1": float(f1),
                          "support": int(confusion[i, :].sum())})
    return {
        "accuracy": float(np.mean(preds == truth)),
        "confusion": confusion,
        "classes": classes,
        "per_class": per_class,
        "macro_f1": float(np.mean(f1s)),
        "predictions": preds,
        "test_idx": test_idx,
    }


def classify_embedding(embedding, labels, *, test_fraction=0.2,
                       test_idx=None, k: int = 5, seed=None,
                       distance: str = "euclidean") -> dict:
    """kNN classification of an embedding (R/classifier_metrics.R:49)."""
    if distance not in ("euclidean", "cosine"):
        raise ValueError("distance must be 'euclidean' or 'cosine'")

    def predict(Xtr, ytr, Xte):
        if distance == "cosine":
            Xtr = Xtr / np.maximum(np.linalg.norm(Xtr, axis=1,
                                                  keepdims=True), 1e-12)
            Xte = Xte / np.maximum(np.linalg.norm(Xte, axis=1,
                                                  keepdims=True), 1e-12)
        return knn_classify(Xtr, ytr, Xte, k=k)
    return _classifier_eval(embedding, labels, predict,
                            test_fraction=test_fraction, test_idx=test_idx,
                            seed=seed)


def classify_logistic(embedding, labels, *, test_fraction=0.2,
                      test_idx=None, seed=None) -> dict:
    """Multinomial logistic evaluation (R/classifier_metrics.R:219)."""
    return _classifier_eval(
        embedding, labels,
        lambda Xtr, ytr, Xte: logistic_classify(Xtr, ytr, Xte),
        test_fraction=test_fraction, test_idx=test_idx, seed=seed)


def classify_rf(embedding, labels, *, test_fraction=0.2, test_idx=None,
                n_trees: int = 100, seed=None) -> dict:
    """Random-forest evaluation (R/classifier_metrics.R:315)."""
    return _classifier_eval(
        embedding, labels,
        lambda Xtr, ytr, Xte: rf_classify(Xtr, ytr, Xte, n_trees=n_trees,
                                          seed=0 if seed is None else seed),
        test_fraction=test_fraction, test_idx=test_idx, seed=seed)
