"""The port's analysis utilities against the JAX package's, on the CPU.

* The R samplers (``r_*``), ``simulate_swimmer``, the metrics (ARI, NMI,
  k-means, silhouette, the kNN / logistic / random-forest classifiers,
  ``assess``, ``cosine``), ``compute_target``, ``refine`` without ``batch``
  and the diagnostics given the same model are numpy copies: bit for bit.
* ``refine(batch=)`` refits through the port's ``nmf``: its H within 2e-3
  of the largest entry (the MSE fit's factor bar, ``PERF.md`` §2).
* ``auto_nmf_distribution`` and the diagnostics that fit their own model:
  every row's nll, df, aic and bic within 1e-4 relative, the same loss or
  mode selected.
* The training log round trip, the plots (where matplotlib is installed),
  the logging levels and the ``verbose`` lines of ``nmf``, device
  introspection, the memory guards and the namespace.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rcppml_tpu as rt
from rcppml_tpu import rng as ref_rng
from rcppml_tpu.utils import diagnostics as ref_diag
from rcppml_tpu.utils import guided as ref_guided
from rcppml_tpu.utils import metrics as ref_metrics
from rcppml_tpu.utils import simulate as ref_simulate
from rcppml_tpu.utils import training_log as ref_tlog

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert, rng
from rcppml_tpu_torch.utils import diagnostics, guided, memory, metrics
from rcppml_tpu_torch.utils import logging as logmod
from rcppml_tpu_torch.utils import simulate, training_log
from rcppml_tpu_torch.utils.simulate import simulate_nmf


@pytest.fixture(scope="module")
def embedding():
    """Three separated classes of 30 samples in 5 dimensions, a batch
    label, and the matching H (k x n)."""
    rs = np.random.RandomState(0)
    labels = np.repeat(np.array(["a", "b", "c"]), 30)
    X = rs.rand(90, 5) + 2.0 * (labels[:, None] == np.array(
        ["a", "b", "c", "a", "b"])[None, :])
    batch = np.tile([0, 1], 45)
    return X.astype(np.float64), labels, batch


@pytest.fixture(scope="module")
def counts():
    mean = simulate_nmf(60, 40, 3, noise=0.0, dropout=0.0, seed=3)["A"]
    rs = np.random.RandomState(4)
    return rs.poisson(4.0 * mean.astype(np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# samplers and simulators
# ---------------------------------------------------------------------------

SAMPLERS = {
    "r_matrix": (lambda m: m.r_matrix(7, 5, seed=3)),
    "r_matrix_transpose_identical": (
        lambda m: m.r_matrix(6, 9, seed=0, transpose_identical=True)),
    "r_sparsematrix": (lambda m: m.r_sparsematrix(
        30, 20, density=0.2, seed=4).toarray()),
    "r_sparsematrix_transpose_identical": (lambda m: m.r_sparsematrix(
        12, 12, density=0.3, seed=2, transpose_identical=True).toarray()),
    "r_sample": (lambda m: m.r_sample(50, 10, seed=9)),
    "r_sample_replace": (lambda m: m.r_sample(7, 40, seed=1, replace=True)),
    "r_unif": (lambda m: m.r_unif(25, seed=5, lo=-2.0, hi=3.0)),
    "r_binom": (lambda m: m.r_binom(100, 0.3, seed=8)),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_match_reference_bit_for_bit(name):
    port, want = SAMPLERS[name](rng), SAMPLERS[name](ref_rng)
    assert port.dtype == want.dtype
    np.testing.assert_array_equal(port, want)


def test_transpose_identical_matrix_is_symmetric_in_its_indices():
    np.testing.assert_array_equal(rtt.r_matrix(4, 6, 1, True).T,
                                  rtt.r_matrix(6, 4, 1, True))


def test_simulate_swimmer_matches_reference():
    port, want = simulate.simulate_swimmer(), ref_simulate.simulate_swimmer()
    for key in ("A", "images"):
        np.testing.assert_array_equal(port[key], want[key])
    assert rtt.simulateSwimmer is simulate.simulate_swimmer
    assert rtt.simulateNMF is simulate.simulate_nmf


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

METRICS = {
    "ari": lambda m, X, y, b: m.adjusted_rand_index(y, np.roll(y, 3)),
    "nmi": lambda m, X, y, b: m.normalized_mutual_info(y, np.roll(y, 5)),
    "kmeans": lambda m, X, y, b: np.concatenate(
        [m.kmeans(X, 3, seed=2)[0], m.kmeans(X, 3, seed=2)[1].ravel()]),
    "silhouette": lambda m, X, y, b: m.approx_silhouette(X, y,
                                                         max_per_class=20),
    "knn": lambda m, X, y, b: m.knn_classify(X[::2], y[::2], X[1::2], k=5),
    "logistic": lambda m, X, y, b: m.logistic_classify(X[::2], y[::2],
                                                       X[1::2]),
    "rf": lambda m, X, y, b: m.rf_classify(X[::2], y[::2], X[1::2],
                                           n_trees=5),
    "cv_accuracy": lambda m, X, y, b: [
        m.cv_classification_accuracy(X, y, classifier=c, n_folds=3)
        for c in ("knn", "lr")],
    "batch_mixing": lambda m, X, y, b: m.batch_mixing_entropy(X, b, k=10),
    "cosine": lambda m, X, y, b: m.cosine(X),
    "cosine_two": lambda m, X, y, b: m.cosine(sp.csc_matrix(X), X[:, :2]),
    "cosine_vectors": lambda m, X, y, b: m.cosine(X[:, 0], X[:, 1]),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metrics_match_reference_bit_for_bit(name, embedding):
    X, y, b = embedding
    np.testing.assert_array_equal(METRICS[name](metrics, X, y, b),
                                  METRICS[name](ref_metrics, X, y, b))


def _same_eval(port, want):
    for key in ("accuracy", "macro_f1"):
        assert port[key] == want[key]
    for key in ("confusion", "classes", "predictions", "test_idx"):
        np.testing.assert_array_equal(port[key], want[key])
    assert port["per_class"] == want["per_class"]


@pytest.mark.parametrize("name,kw", [
    ("classify_embedding", dict(k=5)),
    ("classify_embedding", dict(k=3, distance="cosine", seed=4)),
    ("classify_logistic", dict(seed=1)),
    ("classify_rf", dict(n_trees=5, seed=2))])
def test_classifier_evaluations_match_reference(name, kw, embedding):
    X, y, _ = embedding
    _same_eval(getattr(rtt, name)(X, y, **kw),
               getattr(ref_metrics, name)(X, y, **kw))


def test_assess_matches_reference_on_tensors_and_results(embedding):
    X, y, b = embedding
    want = ref_metrics.assess(X, y, batch=b, classifiers=("knn",))
    got = rtt.assess(torch.from_numpy(X), torch.from_numpy(
        np.unique(y, return_inverse=True)[1]), batch=b, classifiers=("knn",))
    want_int = ref_metrics.assess(X, np.unique(y, return_inverse=True)[1],
                                  batch=b, classifiers=("knn",))
    assert got == want_int
    assert want["ari"] == want_int["ari"]
    # an NMFResult is read as H.T, an SVDResult as V diag(d)
    res = rtt.NMFResult(W=np.ones((4, 5), np.float32),
                        d=np.ones(5, np.float32), H=X.T.astype(np.float32))
    assert rtt.assess(res, y, metrics="ari") == ref_metrics.assess(
        X.astype(np.float32), y, metrics="ari")
    svd = rtt.SVDResult(U=np.ones((4, 5)), d=np.full(5, 2.0), V=X)
    assert rtt.assess(svd, y, metrics=["nmi"]) == ref_metrics.assess(
        2.0 * X, y, metrics=["nmi"])


# ---------------------------------------------------------------------------
# guided NMF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("whiten", [True, False])
def test_compute_target_matches_reference(whiten, embedding):
    X, y, _ = embedding
    np.testing.assert_array_equal(
        rtt.compute_target(X.T, y, whiten=whiten),
        ref_guided.compute_target(X.T, y, whiten=whiten))


@pytest.mark.parametrize("kw", [dict(), dict(lambda_=0.3, nonneg=False),
                                dict(cycles=2), dict(cycles=1,
                                                     whiten=False)])
def test_refine_without_batch_matches_reference(kw, embedding):
    X, y, _ = embedding
    rs = np.random.RandomState(1)
    H = np.abs(X.T[:4]).astype(np.float32)
    A = (rs.rand(20, 4) @ H).astype(np.float32)
    if kw.get("cycles"):
        kw = dict(kw, data=A)
    np.testing.assert_array_equal(rtt.refine(H, y, **kw),
                                  ref_guided.refine(H, y, **kw))
    model = rtt.NMFResult(W=rs.rand(20, 4).astype(np.float32),
                          d=np.ones(4, np.float32), H=H)
    ref_model = rt.NMFResult(W=model.W, d=model.d, H=H)
    port, want = rtt.refine(model, y, **kw), ref_guided.refine(ref_model, y,
                                                               **kw)
    assert port.misc["refined"]
    for name in ("W", "d", "H"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(want, name)))


def test_refine_with_batch_matches_reference_within_the_fit_bar():
    sim = simulate_nmf(40, 60, 3, seed=6)
    labels = np.repeat([0, 1, 2], 20)
    batch = np.tile([0, 1], 30)
    kw = dict(data=sim["A"], batch=batch, cycles=1, lambda_=0.5)
    port = rtt.refine(sim["H"], labels, device="cpu", **kw)
    want = ref_guided.refine(sim["H"], labels, **kw)
    assert np.abs(port - want).max() <= 2e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="cycles"):
        rtt.refine(sim["H"], labels, batch=batch)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def _close_rows(port_rows, want_rows):
    assert [r["distribution"] for r in port_rows] == \
        [r["distribution"] for r in want_rows]
    for p, w in zip(port_rows, want_rows):
        assert p["df"] == w["df"] and p["selected"] == w["selected"]
        for key in ("nll", "aic", "bic"):
            assert abs(p[key] - w[key]) <= 1e-4 * abs(w[key]), key


@pytest.mark.parametrize("criterion", ["bic", "aic"])
def test_auto_nmf_distribution_matches_reference(criterion, counts):
    kw = dict(distributions=("mse", "gp", "nb"), criterion=criterion,
              maxit=8)
    port = rtt.auto_nmf_distribution(counts, 3, device="cpu", **kw)
    want = ref_diag.auto_nmf_distribution(counts, 3, **kw)
    assert port["loss"] == want["loss"] == port["best"]
    _close_rows(port["comparison"], want["comparison"])
    assert sorted(port["models"]) == ["gp", "mse", "nb"]


def _same_dict(port, want):
    assert sorted(port) == sorted(want)
    for key, w in want.items():
        if isinstance(w, (list, tuple)):
            assert port[key] == w, key
        elif isinstance(w, dict):
            _same_dict(port[key], w)
        else:
            np.testing.assert_array_equal(port[key], w, err_msg=key)


@pytest.mark.parametrize("name", ["score_test_distribution",
                                  "diagnose_zero_inflation",
                                  "diagnose_dispersion"])
@pytest.mark.parametrize("sparse", [False, True])
def test_diagnostics_on_one_model_match_reference(name, sparse, counts):
    """Given the same fitted model (the JAX package's, carried across by
    ``convert``), the numpy arithmetic is the JAX package's, bit for bit."""
    model = rt.nmf(counts, 3, loss="gp", maxit=6, seed=1)
    data = sp.csc_matrix(counts) if sparse else counts
    _same_dict(getattr(diagnostics, name)(
        data, convert.nmf_result_from_reference(model)),
        getattr(ref_diag, name)(data, model))


@pytest.mark.parametrize("name,keys", [
    ("score_test_distribution", ("best_power", "best_distribution")),
    ("diagnose_zero_inflation", ("zi_mode", "has_zi")),
    ("diagnose_dispersion", ("mode", "overdispersed"))])
def test_diagnostics_that_fit_match_reference(name, keys, counts):
    port = getattr(rtt, name)(counts, 3, maxit=6, device="cpu")
    want = getattr(ref_diag, name)(counts, 3, maxit=6)
    for key in keys:
        assert port[key] == want[key], key
    for key, w in want.items():
        if isinstance(w, float):
            assert abs(port[key] - w) <= 1e-4 * abs(w) + 1e-9, key


# ---------------------------------------------------------------------------
# training log, plots
# ---------------------------------------------------------------------------

def test_training_log_round_trip(tmp_path):
    A = simulate_nmf(30, 20, 3, seed=1)["A"]
    logger = rtt.training_logger(snapshot_every=2)
    res = rtt.nmf(A, 3, maxit=6, tol=0, seed=1, on_iteration=logger,
                  device="cpu")
    assert [r["iter"] for r in logger.export()] == list(range(1, 7))
    np.testing.assert_array_equal([r["train_loss"] for r in logger.records],
                                  res.loss_history.astype(np.float64))
    logger(8, 1.0, model=res)
    assert list(logger.snapshots) == [8]
    path = tmp_path / "log.csv"
    rows = rtt.export_log(logger, str(path))
    assert len(path.read_text().strip().splitlines()) == len(rows) + 1
    # attach_history: the JAX package's records
    want = ref_tlog.TrainingLogger().attach_history(res).export()
    got = training_log.TrainingLogger().attach_history(res).export()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["iter"] == w["iter"] and g["train_loss"] == w["train_loss"]
    empty = tmp_path / "empty.csv"
    rtt.export_log(rtt.training_logger(), str(empty))
    assert "train_loss" in empty.read_text()


@pytest.fixture(scope="module")
def fitted():
    A = simulate_nmf(40, 30, 4, seed=3)["A"]
    return A, rtt.nmf(A, 4, seed=1, maxit=10, device="cpu")


PLOTS = {
    "plot_nmf_loss": lambda A, res: rtt.plot_nmf(res, type="loss"),
    "plot_nmf_convergence": lambda A, res: rtt.plot_nmf(
        res, type="convergence"),
    "plot_nmf_sparsity": lambda A, res: rtt.plot_nmf(res, type="sparsity"),
    "plot_nmf_regularization": lambda A, res: rtt.plot_nmf(
        res, type="regularization"),
    "biplot": lambda A, res: rtt.biplot(res, f1=1, f2=2),
    "compare_nmf": lambda A, res: rtt.compare_nmf([res, res], labels=["a",
                                                                     "b"]),
    "plot_cv": lambda A, res: rtt.plot_cv(rtt.nmf(
        A, [2, 3], seed=1, maxit=5, test_fraction=0.1, cv_seed=1,
        device="cpu")),
    "plot_dclust": lambda A, res: rtt.plot_dclust(rtt.dclust(
        A, min_samples=5, device="cpu")),
    "plot_consensus": lambda A, res: rtt.plot_consensus(rtt.consensus_nmf(
        A, 3, n_runs=2, maxit=5, device="cpu")),
    # the (k, groups) mean weights of result.summary(group_by)
    "plot_summary": lambda A, res: rtt.plot_summary(np.stack(
        [res.H[:, g::3].mean(axis=1) for g in range(3)], axis=1)),
}


@pytest.mark.parametrize("name", list(PLOTS))
def test_plots_return_figures(name, fitted, tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    from matplotlib.figure import Figure
    fig = PLOTS[name](*fitted)
    assert isinstance(fig, Figure)
    fig.savefig(str(tmp_path / f"{name}.png"))
    plt.close(fig)


# ---------------------------------------------------------------------------
# logging, devices, memory, namespace
# ---------------------------------------------------------------------------

@pytest.fixture
def silent():
    prev = logmod.set_verbosity(0)
    yield
    logmod.set_verbosity(prev)


def test_logging_levels(silent, capsys):
    L = rtt.LogLevel
    assert L.SILENT < L.SUMMARY < L.DETAILED < L.DEBUG
    logmod.log_summary("hidden")
    assert capsys.readouterr().out == ""
    assert rtt.set_verbosity("DETAILED") == L.SILENT
    assert rtt.get_verbosity() == L.DETAILED
    logmod.log_detailed("d %d", 7)
    logmod.log_debug("g")
    assert capsys.readouterr().out == "d 7\n"
    rtt.set_verbosity(0)
    logmod.log_summary("per-call", verbose=True)
    assert "per-call" in capsys.readouterr().out
    assert logmod.effective_level("3") == L.DEBUG
    with pytest.raises(ValueError):
        rtt.set_verbosity("LOUD")


@pytest.mark.parametrize("level", ["SUMMARY", "DETAILED"])
def test_nmf_log_lines_match_reference(level, silent, capsys):
    """The port's lines are the JAX package's, but for the device name."""
    A = simulate_nmf(20, 15, 3, seed=0)["A"]
    lines = {}
    for name, pkg, kw in (("port", rtt, dict(device="cpu")), ("jax", rt, {})):
        (rtt if name == "port" else rt).set_verbosity(level)
        try:
            pkg.nmf(A, 3, maxit=5, seed=1, tol=0, **kw)
        finally:
            (rtt if name == "port" else rt).set_verbosity(0)
        lines[name] = capsys.readouterr().out.splitlines()
    port, want = lines["port"], lines["jax"]
    assert port[0].endswith("device=cpu")
    assert port[0].split("device=")[0] == want[0].split("device=")[0]
    assert len(port) == len(want) == (2 if level == "SUMMARY" else 7)
    # the losses printed with 6 digits, within the fits' 1e-4
    for p, w in zip(port[1:], want[1:]):
        assert p.split("loss=")[0] == w.split("loss=")[0]
        lp, lw = float(p.split("loss=")[1]), float(w.split("loss=")[1])
        assert abs(lp - lw) <= 1e-4 * abs(lw)


def test_nmf_is_silent_by_default(silent, capsys):
    rtt.nmf(simulate_nmf(20, 15, 3, seed=0)["A"], 3, maxit=3, device="cpu")
    assert capsys.readouterr().out == ""
    rtt.nmf(simulate_nmf(20, 15, 3, seed=0)["A"], 3, maxit=3, device="cpu",
            verbose=True)
    assert "done: 3 iters" in capsys.readouterr().out


def test_device_introspection():
    assert rtt.gpu_available() == torch.cuda.is_available()
    assert rtt.accelerator_available is rtt.gpu_available
    info = rtt.gpu_info()
    assert info["num_devices"] == len(info["devices"]) == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert rtt.accelerator_info is rtt.gpu_info
    assert not hasattr(rtt, "tpu_available")


def test_memory_guards(monkeypatch):
    assert memory.format_bytes(2048) == "2.0 KB"
    assert memory.check_dense_alloc(100, 100).fits
    huge = memory.check_dense_alloc(10 ** 7, 10 ** 7)
    assert not huge.fits and "streaming" in huge.message
    monkeypatch.setattr(memory, "available_host_bytes", lambda: 10_000)
    with pytest.raises(MemoryError, match="INSUFFICIENT HOST MEMORY"):
        rtt.nmf(sp.random(200, 100, density=0.01, format="csc"), 3,
                maxit=2, device="cpu")
    monkeypatch.setattr(memory, "available_host_bytes", lambda: 0)
    assert memory.check_dense_alloc(10 ** 7, 10 ** 7).fits


def test_a_matrix_the_card_cannot_hold_is_refused(monkeypatch):
    """Where the JAX package streams, the port streams too: a matrix the
    card cannot hold with headroom goes to the streaming engine instead of
    the in-memory fit (the card is pretended for the decision only; the
    fit itself runs on the CPU).  On the CPU no switch is made."""
    from rcppml_tpu_torch import api
    A = simulate_nmf(60, 50, 3, seed=0)["A"]
    plain = rtt.nmf(A, 3, maxit=2, tol=0, device="cpu")
    streams = []
    real = api._nmf_streaming

    def on_cpu(*args, **kwargs):
        streams.append(args[2])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        return real(*args, **dict(kwargs, device="cpu"))
    monkeypatch.setattr(api, "_nmf_streaming", on_cpu)
    monkeypatch.setattr(memory, "device_hbm_bytes", lambda: 20_000)
    assert rtt.nmf(A, 3, maxit=2, tol=0, device="cpu").iterations == 2
    assert streams == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    res = rtt.nmf(A, 3, maxit=2, tol=0)
    assert streams == [False] and res.iterations == 2
    assert abs(res.train_loss - plain.train_loss) <= \
        1e-4 * abs(plain.train_loss)


SLICE_NAMES = (
    "bipartition", "dclust", "consensus_nmf", "bipartiteMatch",
    "bipartite_match", "align", "auto_nmf_distribution",
    "score_test_distribution", "diagnose_zero_inflation",
    "diagnose_dispersion", "assess", "cosine", "classify_embedding",
    "classify_logistic", "classify_rf", "compute_target", "refine",
    "simulateNMF", "simulateSwimmer", "simulate_nmf", "simulate_swimmer",
    "training_logger", "export_log", "compare_nmf", "biplot", "plot_nmf",
    "plot_cv", "plot_dclust", "plot_consensus", "plot_summary", "r_matrix",
    "r_sparsematrix", "r_sample", "r_unif", "r_binom",
    "accelerator_available", "accelerator_info", "gpu_available",
    "gpu_info", "set_verbosity", "get_verbosity", "LogLevel")


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_slice_names_resolve_on_the_package(name):
    assert name in rtt.__all__
    assert callable(getattr(rtt, name))
    # the JAX package exports the same name
    assert getattr(rt, name) is not None
