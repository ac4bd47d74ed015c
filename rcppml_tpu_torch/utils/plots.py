"""Plotting helpers (R/plot_nmf.R:41,373, R/nmf_plots.R, plot.dclust,
plot.consensus_nmf, biplot).

All functions return the matplotlib Figure so callers can save/show;
importing matplotlib is deferred so headless library use stays light.
A copy of ``rcppml_tpu/utils/plots.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_nmf(result, type: str = "loss", **kw):
    """plot(model, type=) dispatcher (R/plot_nmf.R:41-59):
    loss / convergence / regularization / sparsity."""
    if type == "loss":
        return plot_loss(result, **kw)
    if type == "convergence":
        return plot_convergence(result, **kw)
    if type == "sparsity":
        return plot_factor_sparsity(result, **kw)
    if type == "regularization":
        # per-iteration penalty breakdown is not stored; the reference
        # plots the objective with an active-penalty annotation
        # (R/plot_nmf.R plot_nmf_regularization)
        fig = plot_loss(result, **kw)
        cfg = result.misc.get("config")
        active = []
        if cfg is not None:
            if getattr(cfg.W, "L1", 0) or getattr(cfg.H, "L1", 0):
                active.append("L1 (sparsity)")
            if getattr(cfg.W, "L2", 0) or getattr(cfg.H, "L2", 0):
                active.append("L2 (ridge)")
        sub = ("Active penalties: " + ", ".join(active)) if active \
            else "No regularization penalties active"
        fig.axes[0].set_title(f"NMF objective (with regularization)\n{sub}")
        return fig
    raise ValueError(
        "type must be one of loss/convergence/regularization/sparsity")


def plot_loss(result, *, log: bool = True, ax=None):
    """Training (and test) loss curves (plot.nmf type='loss')."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    h = np.asarray(result.loss_history)
    ax.plot(np.arange(1, len(h) + 1), h, label="train", lw=2)
    if getattr(result, "test_loss_history", None) is not None:
        t = np.asarray(result.test_loss_history)
        ax.plot(np.arange(1, len(t) + 1), t, label="test", lw=2)
    if log:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.legend()
    ax.set_title("NMF convergence")
    return fig if fig is not None else ax.figure


def plot_cv(rows: Sequence[dict], *, metric: str = "test_mse", ax=None,
            show_train: Optional[bool] = None):
    """Rank-selection curve from a CV sweep (plot.nmfCrossValidate).

    ``show_train``: overlay the train curve (dashed) alongside the test
    curve — default mirrors R/plot_nmf.R:447-463 (on when train data is
    present and the metric is the test loss)."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    if show_train is None:
        show_train = (metric == "test_mse"
                      and all("train_mse" in r for r in rows))
    reps = sorted({r["rep"] for r in rows})
    for rep in reps:
        sub = sorted((r for r in rows if r["rep"] == rep), key=lambda r: r["k"])
        line, = ax.plot([r["k"] for r in sub], [r[metric] for r in sub],
                        marker="o", label=f"rep {rep}")
        if show_train and metric == "test_mse":
            ax.plot([r["k"] for r in sub], [r["train_mse"] for r in sub],
                    marker=".", linestyle="--", color=line.get_color(),
                    alpha=0.6, label=f"rep {rep} (train)")
    ax.set_xlabel("rank k")
    ax.set_ylabel(metric)
    ax.legend()
    ax.set_title("Cross-validation rank selection")
    return fig if fig is not None else ax.figure


def plot_factor_sparsity(result, ax=None):
    """Per-factor sparsity bars (plot.nmf type='sparsity')."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    k = result.k
    sw = (np.asarray(result.W) == 0).mean(axis=0)
    sh = (np.asarray(result.H) == 0).mean(axis=1)
    x = np.arange(k)
    ax.bar(x - 0.2, sw, width=0.4, label="W")
    ax.bar(x + 0.2, sh, width=0.4, label="H")
    ax.set_xlabel("factor")
    ax.set_ylabel("sparsity")
    ax.legend()
    return fig if fig is not None else ax.figure


def biplot(result, *, f1: int = 0, f2: int = 1, ax=None):
    """Sample biplot on two factors (R/nmf_methods.R biplot)."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5))
    H = np.asarray(result.H)
    ax.scatter(H[f1], H[f2], s=8, alpha=0.6)
    ax.set_xlabel(f"factor {f1 + 1}")
    ax.set_ylabel(f"factor {f2 + 1}")
    return fig if fig is not None else ax.figure


def plot_dclust(clusters, ax=None):
    """Divisive-clustering dendrogram sketch (plot.dclust)."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 4))
    leaves = sorted(clusters, key=lambda c: c.id)
    xs = {}
    for i, c in enumerate(leaves):
        xs[c.id] = i
        ax.plot([i, i], [0, len(c.id)], color="gray", lw=1)
        ax.text(i, -0.3, c.id, ha="center", fontsize=8, rotation=90)
        ax.scatter([i], [0], s=max(c.size, 5), alpha=0.7)
    ax.set_ylabel("depth")
    ax.set_xticks([])
    ax.invert_yaxis()
    ax.set_title("divisive clustering")
    return fig if fig is not None else ax.figure


def plot_consensus(consensus_out, ax=None, *, cluster_rows: bool = True,
                   show_clusters: bool = True):
    """Consensus-matrix heatmap (plot.consensus_nmf, R/consensus.R:184).

    ``cluster_rows``: reorder samples by cluster label (the reference's
    hclust reorder; labels come from the consensus clustering itself).
    ``show_clusters``: draw cluster-boundary lines as the sidebar analog.
    """
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5))
    C = np.asarray(consensus_out["consensus"])
    labels = np.asarray(consensus_out["labels"])
    order = np.argsort(labels) if cluster_rows else np.arange(len(labels))
    im = ax.imshow(C[np.ix_(order, order)], cmap="viridis", vmin=0, vmax=1)
    ax.figure.colorbar(im, ax=ax, shrink=0.8)
    if show_clusters and cluster_rows:
        bounds = np.flatnonzero(np.diff(labels[order])) + 0.5
        for b in bounds:
            ax.axhline(b, color="white", lw=0.8)
            ax.axvline(b, color="white", lw=0.8)
    ax.set_title(f"consensus (cophenetic={consensus_out['cophenetic']:.3f})")
    return fig if fig is not None else ax.figure


def plot_summary(stats, group_names: Optional[Sequence[str]] = None,
                 ax=None):
    """Stacked per-factor group-representation bars (plot.nmfSummary,
    R/nmf_plots.R:21-31): each factor's bar shows the PROPORTION of its
    mean weight contributed by each sample group (position='fill').

    ``stats``: the (k, n_groups) matrix returned by
    ``result.summary(group_by)``."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    S = np.asarray(stats, dtype=np.float64)
    k, g = S.shape
    tot = np.maximum(S.sum(axis=1, keepdims=True), 1e-300)
    frac = S / tot
    x = np.arange(k)
    bottom = np.zeros(k)
    names = (list(group_names) if group_names is not None
             else [f"group {i}" for i in range(g)])
    for gi in range(g):
        ax.bar(x, frac[:, gi], bottom=bottom, label=str(names[gi]))
        bottom += frac[:, gi]
    ax.set_xlabel("NMF factor")
    ax.set_ylabel("Representation in group")
    ax.set_xticks(x, [f"f{i + 1}" for i in range(k)])
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    return fig if fig is not None else ax.figure


def compare_nmf(results: Sequence, labels: Optional[Sequence[str]] = None,
                ax=None):
    """Overlay loss histories of multiple fits (R compare_nmf)."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    for i, r in enumerate(results):
        lab = labels[i] if labels else f"model {i + 1}"
        ax.plot(np.asarray(r.loss_history), label=lab, lw=2)
    ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("train loss")
    ax.legend()
    return fig if fig is not None else ax.figure


def plot_convergence(result, *, ax=None):
    """Per-iteration relative loss change vs tolerance
    (plot.nmf type='convergence')."""
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    h = np.asarray(result.loss_history, dtype=np.float64)
    if len(h) < 2:
        raise ValueError("need >= 2 recorded iterations to plot convergence")
    rel = np.abs(np.diff(h)) / (np.abs(h[:-1]) + 1e-15)
    ax.plot(np.arange(2, len(h) + 1), rel, lw=2)
    ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel("relative loss change")
    ax.set_title("convergence")
    return ax.figure if fig is None else fig
