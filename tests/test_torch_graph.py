"""The port's FactorNet graph engine against the JAX package's, on the CPU.

Each test of ``tests/test_graph.py`` has a counterpart here that builds the
same net in both packages (``rcppml_tpu.models.graph`` and
``rcppml_tpu_torch.models.graph``) on the same seeded numpy inputs and
compares the fits.  Bars:

* MSE layers: total and per-layer losses within rtol 1e-4 plus the
  cancellation floor 10·eps·tr(BᵀB)/|B| of each layer's input B (a single
  layer's loss is ``nmf``'s sum of squares: 10·eps·tr(BᵀB)); W, d, H
  within 2e-3 of their largest entry; equal iteration counts.
* IRLS and CV layers: losses within rtol 2e-4 (test losses too), factors
  within 1e-4 of their largest entry (``tests/test_torch_irls_fit.py``).
* Structure and errors: equal shapes, names and block keys; the same
  exception type (and message) where the JAX package raises.

Data: the JAX tests' fixture (``modalities``: planted rank 3, noise
0.02) wherever a layer's k is at most 3 or the comparison holds there.
Nets with a layer past the planted rank (k = 5, 6, 8) run on ``ranked``
(the same shape, planted rank 8): on the rank-3 fixture their Grams are
near singular and the fits chaotic in the JAX package itself — a one-ulp
change of one of A's rows moves its own W by up to 0.39 at k=5, 0.88 with
the graph Laplacian and 0.02 in the k=8 -> 3 net, against the 2e-3 bar
(``test_over_ranked_fixture_is_chaotic_in_the_jax_package``), as
``ROADMAP.md`` queue 3 records for rank-deficient data.  Where a fit stops by the relative tolerance, the stopping iteration
is a knife edge (the same one-ulp change moves the JAX package's mixed
SVD/NMF net from 6 sweeps to 5): those nets are fitted as the JAX test fits
them, for structure, and compared over a fixed count (``tol=0``).

The port's multi-layer fits run the outer ALS on the CPU device
(``device="cpu"``).  ``mesh=`` runs here on a (1, 1) mesh of one process;
the 8-rank mesh, against the JAX package's sharded nets, is
``tests/test_torch_mesh_consumers.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rcppml_tpu as rt
from rcppml_tpu.models import graph as jg
from rcppml_tpu.utils.simulate import simulate_nmf as ref_simulate_nmf

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.models import graph as tg

CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)
MSE_LOSS_RTOL, MSE_FACTOR_TOL = 1e-4, 2e-3
IRLS_LOSS_RTOL, IRLS_FACTOR_TOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def modalities():
    s1 = ref_simulate_nmf(m=40, n=60, k=3, noise=0.02, seed=1)
    s2 = ref_simulate_nmf(m=25, n=60, k=3, noise=0.02, seed=2)
    return s1["A"], s2["A"]


@pytest.fixture(scope="module")
def ranked():
    """The first modality's shape at planted rank 8 (module docstring)."""
    return ref_simulate_nmf(m=40, n=60, k=8, noise=0.02, seed=1)["A"]


def _bump_row(A, row):
    """A with one row one ulp larger."""
    A = A.copy()
    A[row] = np.nextafter(A[row], np.float32(np.inf))
    return A


def _fit_both(build, **fit_kw):
    """``build(G)`` -> a net of graph module G; returns (JAX result, port
    result, port net)."""
    want = jg.fit(build(jg), **fit_kw)
    net = build(tg)
    return want, tg.fit(net, device="cpu", **fit_kw), net


def _loss_floors(net, ref):
    """Per layer 10·eps·tr(BᵀB)/|B|, B the layer's input as the JAX
    factors make it (the port's host-side effective input); a single
    layer's loss is ``nmf``'s train loss, a sum: 10·eps·tr(BᵀB)."""
    data_map = net._data_map()
    states = [ref[l.name] for l in net._layers]
    floors = []
    for i in range(net.n_layers):
        B = np.asarray(net._effective_input(i, states, data_map), np.float64)
        size = 1 if net.n_layers == 1 else B.size
        floors.append(10 * EPS32 * float((B * B).sum()) / size)
    return floors


def _loss_floor(net, ref):
    return sum(_loss_floors(net, ref))


def _close(p, r, rtol, atol=0.0):
    assert abs(p - r) <= rtol * abs(r) + atol, (p, r, abs(p - r) / abs(r))


def _same_factors(p, r, tol):
    for name in ("W", "d", "H"):
        a = np.asarray(getattr(p, name), np.float64)
        b = np.asarray(getattr(r, name), np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err < tol, (name, err)
    if r.W_blocks is not None:
        assert set(p.W_blocks) == set(r.W_blocks)
        for key, block in r.W_blocks.items():
            assert np.abs(p.W_blocks[key] - block).max() \
                <= tol * np.abs(r.W).max()


def _same_graph_fit(port, ref, net, irls=False, cv=False):
    """Every layer and the total held to the bars of the module docstring."""
    rtol = IRLS_LOSS_RTOL if irls or cv else MSE_LOSS_RTOL
    ftol = IRLS_FACTOR_TOL if irls else MSE_FACTOR_TOL
    floor = 0.0 if irls else _loss_floor(net, ref)
    assert port.total_iterations == ref.total_iterations
    assert port.converged == ref.converged
    assert port.chain_topology == ref.chain_topology
    _close(port.total_loss, ref.total_loss, rtol, floor)
    assert list(port.layers) == list(ref.layers)
    for name, r in ref.layers.items():
        p = port[name]
        assert p.iterations == r.iterations and p.converged == r.converged
        _close(p.loss, r.loss, rtol, floor)
        for key in ("test_loss", "best_test_loss"):
            if np.isnan(getattr(r, key)):
                assert np.isnan(getattr(p, key)), key
            else:
                _close(getattr(p, key), getattr(r, key), rtol, 1e-12)
        _same_factors(p, r, ftol)


def _raise_alike(call_ref, call_port, exc, match=None):
    with pytest.raises(exc, match=match):
        call_ref()
    with pytest.raises(exc, match=match):
        call_port()


# ---------------------------------------------------------------------------
# counterparts of tests/test_graph.py
# ---------------------------------------------------------------------------

def test_single_layer_delegates(modalities):
    A, _ = modalities

    def build(G):
        inp = G.Input(A, "x")
        return G.factor_net(inp, G.NMFLayer(inp, 3, name="L1"), maxit=40,
                            seed=42)

    want, port, net = _fit_both(build)
    assert port["L1"].W.shape == (40, 3) and port["L1"].H.shape == (3, 60)
    _same_graph_fit(port, want, net)


def test_shared_multimodal_splits_w(modalities):
    A1, A2 = modalities

    def build(G):
        i1, i2 = G.Input(A1, "rna"), G.Input(A2, "atac")
        return G.factor_net([i1, i2], G.NMFLayer(G.Shared(i1, i2), 3,
                                                 name="joint"),
                            maxit=40, seed=42)

    want, port, net = _fit_both(build)
    lr = port["joint"]
    assert lr.W.shape == (65, 3)
    assert list(lr.W_blocks) == ["rna", "atac"]
    assert lr.W_blocks["rna"].shape == (40, 3)
    assert lr.W_blocks["atac"].shape == (25, 3)
    _same_graph_fit(port, want, net)


def test_two_layer_deep(modalities):
    A, _ = modalities

    def build(G):
        inp = G.Input(A, "x")
        l2 = G.NMFLayer(G.NMFLayer(inp, 6, name="L1"), 2, name="L2")
        return G.factor_net(inp, l2, maxit=20, seed=42)

    want, port, net = _fit_both(build)
    assert port["L2"].W.shape == (60, 2) and port["L2"].H.shape == (2, 6)
    assert net._fused_fn is not None
    _same_graph_fit(port, want, net)


def test_condition_appends_covariates(modalities):
    A, _ = modalities
    Z = np.random.RandomState(0).rand(60, 2).astype(np.float32)

    def build(G):
        inp = G.Input(A, "x")
        l2 = G.NMFLayer(G.Condition(G.NMFLayer(inp, 4, name="L1"), Z), 2,
                        name="L2")
        return G.factor_net(inp, l2, maxit=10, seed=42)

    want, port, net = _fit_both(build)
    assert port["L2"].H.shape == (2, 6) and port["L2"].W.shape == (60, 2)
    _same_graph_fit(port, want, net)


def test_concat_branches(modalities):
    A1, A2 = modalities

    def build(G):
        i1, i2 = G.Input(A1, "a"), G.Input(A2, "b")
        top = G.NMFLayer(G.Concat(G.NMFLayer(i1, 3, name="b1"),
                                  G.NMFLayer(i2, 2, name="b2")), 2,
                         name="top")
        return G.factor_net([i1, i2], top, maxit=10, seed=42)

    want, port, net = _fit_both(build)
    assert port["top"].W.shape == (60, 2) and port["top"].H.shape == (2, 5)
    assert not port.chain_topology
    _same_graph_fit(port, want, net)


def test_add_branches(modalities):
    A1, _ = modalities

    def build(G):
        i1 = G.Input(A1, "a")
        top = G.NMFLayer(G.Add(G.NMFLayer(i1, 3, name="b1"),
                               G.NMFLayer(i1, 3, name="b2")), 2, name="top")
        return G.factor_net(i1, top, maxit=8, seed=42)

    want, port, net = _fit_both(build)
    assert port["top"].H.shape == (2, 3)
    _same_graph_fit(port, want, net)


def test_compile_validation(modalities):
    A, _ = modalities
    for G in (jg, tg):
        inp = G.Input(A, "x")
        with pytest.raises(ValueError, match="no factorization layers"):
            G.factor_net(inp, inp)
        l2 = G.NMFLayer(G.NMFLayer(inp, 2, name="same"), 2, name="same")
        with pytest.raises(ValueError, match="unique"):
            G.factor_net(inp, l2)


@pytest.fixture(scope="module")
def cv_grid(modalities):
    """cross_validate_graph of the JAX test, through both packages."""
    A1, _ = modalities
    out = {}
    for G, kw in ((jg, {}), (tg, dict(device="cpu"))):
        inp = G.Input(A1, "x")
        out[G] = G.cross_validate_graph(
            inp, lambda p, G=G, inp=inp: G.NMFLayer(inp, p["k"], name="L"),
            params={"k": [2, 3]}, config=G.factor_config(maxit=20, seed=42),
            reps=2, seed=7, **kw)
    return out[jg], out[tg]


def _same_cv_rows(port, ref):
    assert len(port.results) == len(ref.results)
    for p, r in zip(port.results, ref.results):
        assert {k: v for k, v in p.items() if "loss" not in k} == \
            {k: v for k, v in r.items() if "loss" not in k}
        for key in ("test_loss", "train_loss"):
            if np.isnan(r[key]):
                assert np.isnan(p[key])
            else:
                _close(p[key], r[key], IRLS_LOSS_RTOL, 1e-12)
    assert port.best_params == ref.best_params
    assert [s["combo"] for s in port.summary] == \
        [s["combo"] for s in ref.summary]
    assert port.strategy == ref.strategy and port.reps == ref.reps


def test_cross_validate_graph_grid(cv_grid):
    ref, port = cv_grid
    _same_cv_rows(port, ref)
    assert len(port.results) == 4
    r0 = [r for r in port.results if r["combo"] == 0]
    assert r0[0]["test_loss"] != r0[1]["test_loss"]
    assert port.best_params["k"] == 3
    assert port.summary[0]["mean_test_loss"] <= \
        port.summary[-1]["mean_test_loss"]
    assert "factor_net cross-validation" in repr(port)


def test_cross_validate_graph_multiparam_random(modalities):
    A1, _ = modalities
    out = {}
    for G, kw in ((jg, {}), (tg, dict(device="cpu"))):
        inp = G.Input(A1, "x")
        out[G] = G.cross_validate_graph(
            inp, lambda p, G=G, inp=inp: G.NMFLayer(
                inp, p["k"], W=G.W(L1=p["L1"]), name="L"),
            params={"k": [2, 3], "L1": [0.0, 0.01, 0.1]},
            config=G.factor_config(maxit=10, seed=42),
            reps=1, strategy="random", n_random=3, seed=5, **kw)
    _same_cv_rows(out[tg], out[jg])
    assert len(out[tg].results) == 3
    assert set(out[tg].best_params) == {"k", "L1"}


def test_cross_validate_graph_failed_combo_is_nan(modalities):
    A1, _ = modalities
    out = {}
    for G, kw in ((jg, {}), (tg, dict(device="cpu"))):
        inp = G.Input(A1, "x")

        def bad_layer(p, G=G, inp=inp):
            if p["k"] == 99:
                raise ValueError("boom")
            return G.NMFLayer(inp, p["k"], name="L")

        with pytest.warns(UserWarning, match="boom"):
            out[G] = G.cross_validate_graph(inp, bad_layer,
                                            params={"k": [2, 99]}, reps=1,
                                            seed=1, **kw)
    _same_cv_rows(out[tg], out[jg])
    bad = [r for r in out[tg].results if r["k"] == 99]
    assert len(bad) == 1 and np.isnan(bad[0]["test_loss"])
    assert out[tg].best_params["k"] == 2


def test_global_factor_config_propagates(modalities):
    A1, _ = modalities

    def build_cv(G):
        inp = G.Input(A1, "x")
        cfg = G.factor_config(maxit=15, seed=3, test_fraction=0.1, cv_seed=9)
        return G.factor_net(inp, G.NMFLayer(inp, 3, name="L"), config=cfg)

    want, port, net = _fit_both(build_cv)
    assert np.isfinite(port["L"].test_loss)
    _same_graph_fit(port, want, net, cv=True)

    def build_plain(G):
        inp = G.Input(A1, "x")
        return G.factor_net(inp, G.NMFLayer(inp, 3, name="L"), maxit=15,
                            seed=3)

    want, port, net = _fit_both(build_plain)
    assert np.isnan(port["L"].test_loss)
    _same_graph_fit(port, want, net)


def _deep_fused_net(G, A):
    inp = G.Input(A, "x")
    l2 = G.NMFLayer(G.NMFLayer(inp, 6, name="L1"), 2, name="L2")
    return G.factor_net(inp, l2, maxit=8, tol=0.0, seed=42)


@pytest.fixture(scope="module")
def deep_fused(modalities):
    """The JAX test's fused 2-layer net (8 sweeps, tol=0): the JAX fit and
    its host-loop fit, the port's two, and the port's fused net."""
    A, _ = modalities
    ref_f = jg.fit(_deep_fused_net(jg, A))
    net_h = _deep_fused_net(jg, A)
    net_h._fit_deep_fused = lambda data_map, **kw: None
    ref_h = jg.fit(net_h)
    net_f = _deep_fused_net(tg, A)
    port_f = tg.fit(net_f, device="cpu")
    net_ph = _deep_fused_net(tg, A)
    net_ph._fit_deep_fused = lambda data_map, *a, **kw: None
    port_h = tg.fit(net_ph, device="cpu")
    return ref_f, ref_h, port_f, port_h, net_f


def test_fused_deep_matches_host_loop(deep_fused):
    """The port's on-device outer ALS against its host-driven loop (the JAX
    test's bars), and each against the JAX package's."""
    ref_f, ref_h, port_f, port_h, net_f = deep_fused
    assert net_f._fused_fn is not None
    assert port_f.total_iterations == port_h.total_iterations == 8
    np.testing.assert_allclose(port_f.total_loss, port_h.total_loss,
                               rtol=1e-3)
    for name in ("L1", "L2"):
        np.testing.assert_allclose(port_f[name].W, port_h[name].W,
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(port_f[name].H, port_h[name].H,
                                   rtol=2e-3, atol=2e-4)
    _same_graph_fit(port_f, ref_f, net_f)
    _same_graph_fit(port_h, ref_h, net_f)


def test_host_loop_layer_loss_is_the_total(deep_fused):
    """The JAX package's host loop gives each layer the total loss; the
    fused path gives each its own history entry."""
    _, ref_h, port_f, port_h, _ = deep_fused
    for name in ("L1", "L2"):
        assert port_h[name].loss == port_h.total_loss
        assert ref_h[name].loss == ref_h.total_loss
    assert port_f["L1"].loss != port_f["L2"].loss


def test_fused_deep_with_branches(modalities):
    A1, A2 = modalities
    Z = np.random.RandomState(0).rand(60, 2).astype(np.float32)

    def build(G):
        i1, i2 = G.Input(A1, "a"), G.Input(A2, "b")
        top = G.NMFLayer(G.Condition(G.Concat(G.NMFLayer(i1, 3, name="b1"),
                                              G.NMFLayer(i2, 2, name="b2")),
                                     Z), 2, name="top")
        return G.factor_net([i1, i2], top, maxit=6, seed=42)

    want, port, net = _fit_both(build)
    assert net._fused_fn is not None
    assert port["top"].W.shape == (60, 2) and port["top"].H.shape == (2, 7)
    _same_graph_fit(port, want, net)


def test_deep_irls_loss_falls_back_to_host(modalities):
    A, _ = modalities
    X = np.round(A * 4)

    def build(G):
        inp = G.Input(X, "x")
        l2 = G.NMFLayer(G.NMFLayer(inp, 4, name="L1", loss="gp",
                                   solver="cd"), 2, name="L2")
        return G.factor_net(inp, l2, maxit=3, seed=42)

    want, port, net = _fit_both(build)
    assert net._fused_fn is None
    assert np.isfinite(port.total_loss)
    _same_graph_fit(port, want, net, irls=True)


def test_svd_layer(modalities):
    A, _ = modalities

    def build(G):
        inp = G.Input(A, "x")
        return G.factor_net(inp, G.SVDLayer(inp, 3, name="S1"), maxit=25,
                            seed=42)

    want, port, net = _fit_both(build)
    assert port["S1"].W.shape == (40, 3)
    assert (port["S1"].W < 0).any() or (port["S1"].H < 0).any()
    _same_graph_fit(port, want, net)


def test_layer_with_irls_loss(modalities):
    X = np.round(modalities[0] * 4)

    def build(G):
        x = G.factor_input(X)
        return G.factor_net([x], G.nmf_layer(x, 3, loss="tweedie",
                                             tweedie_power=1.4, maxit=4,
                                             solver="cd", name="tw"))

    want, port, net = _fit_both(build)
    assert port["tw"].W.shape[1] == 3
    _same_graph_fit(port, want, net, irls=True)


def test_layer_with_W_H_builders(modalities):
    def build(G, **over):
        x = G.factor_input(modalities[0])
        return G.factor_net([x], G.nmf_layer(x, 3, W=G.W(L1=0.05),
                                             H=G.H(L2=0.01), maxit=5,
                                             name="reg"), **over)

    # the JAX test's net stops by tol after 18 / 19 iterations (port / JAX
    # 3.8e-6 apart in loss): a knife edge, so the trajectory is compared
    # over a fixed count
    want, port, net = _fit_both(build)
    assert np.isfinite(port.total_loss) and port.converged == want.converged
    assert abs(port.total_iterations - want.total_iterations) <= 1
    want, port, net = _fit_both(lambda G: build(G, maxit=20, tol=0.0))
    _same_graph_fit(port, want, net)


def _multimodal_data(seed):
    rs = np.random.RandomState(seed)
    return (np.abs(rs.rand(30, 25)).astype(np.float32),
            np.abs(rs.rand(18, 25)).astype(np.float32))


def test_nmf_list_input_dispatches_to_factor_net():
    X1, X2 = _multimodal_data(0)
    for data, kw in (({"rna": X1, "adt": X2}, dict(maxit=20)),
                     ([X1, X2], dict(maxit=10))):
        want = rt.nmf(data, 4, seed=42, **kw)
        port = rtt.nmf(data, 4, seed=42, device="cpu", **kw)
        assert isinstance(port, tg.GraphResult)
        assert list(port["L1"].W_blocks) == list(want["L1"].W_blocks)
        assert port["L1"].H.shape == (4, 25)
        net = tg.factor_net([tg.Input(X1), tg.Input(X2)], tg.NMFLayer(
            tg.Shared(tg.Input(X1), tg.Input(X2)), 4))
        assert port.total_iterations == want.total_iterations
        _same_factors(port["L1"], want["L1"], MSE_FACTOR_TOL)
        _close(port.total_loss, want.total_loss, MSE_LOSS_RTOL,
               _loss_floor(net, {net._layers[0].name: want["L1"]}))
    assert set(port["L1"].W_blocks) == {"modal1", "modal2"}
    _raise_alike(lambda: rt.nmf([X1], 4), lambda: rtt.nmf([X1], 4),
                 ValueError, "2\\+")
    _raise_alike(lambda: rt.nmf([X1, X2[:, :10]], 4),
                 lambda: rtt.nmf([X1, X2[:, :10]], 4), ValueError,
                 "columns")


# every argument the shared-H delegation rejects, and a value for it
MULTIMODAL_REJECTED = {
    "mask": np.zeros((48, 25), bool), "graph_W": np.eye(48),
    "graph_H": np.eye(25), "target_H": np.ones((4, 25)),
    "target_W": np.ones((4, 48)), "w_init": np.ones((48, 4)),
    "h_init": np.ones((4, 25)), "mesh": object(),
    "on_iteration": lambda *a: None, "checkpoint_path": "x.npz",
    "streaming": True}


@pytest.mark.parametrize("name", list(MULTIMODAL_REJECTED))
def test_nmf_list_input_rejects_what_it_cannot_forward(name):
    X1, X2 = _multimodal_data(0)
    kw = {name: MULTIMODAL_REJECTED[name]}
    _raise_alike(lambda: rt.nmf([X1, X2], 4, **kw),
                 lambda: rtt.nmf([X1, X2], 4, device="cpu", **kw),
                 ValueError, f"does not support {name}")


@pytest.fixture(scope="module")
def predict_fits(ranked):
    """The JAX test's two predict nets fitted by both packages, and the
    new columns."""
    X = ranked
    out = {}
    for G, kw in ((jg, {}), (tg, dict(device="cpu"))):
        inp = G.factor_input(X, "X")
        single = G.fit(G.factor_net([inp], G.nmf_layer(inp, 5, name="L1"),
                                    maxit=50, tol=1e-5, seed=42), **kw)
        deep = G.fit(G.factor_net([inp], G.nmf_layer(G.nmf_layer(
            inp, 6, name="L1"), 3, name="L2"), maxit=20, seed=42), **kw)
        out[G] = (single, deep)
    rs = np.random.RandomState(1)
    X_new = np.abs(rs.rand(X.shape[0], 10)).astype(np.float32)
    return out[jg], out[tg], X, X_new


def test_graph_result_predict(predict_fits):
    (ref_s, ref_d), (port_s, port_d), X, X_new = predict_fits
    H_pred = port_s.predict(X, device="cpu")
    assert H_pred.shape == (5, X.shape[1])
    assert port_s.predict(X_new, device="cpu").shape == (5, 10)
    out = port_d.predict(X_new, device="cpu")
    assert set(out) == {"L1", "L2"}
    assert out["L1"].shape == (6, 10) and out["L2"].shape == (3, 10)
    # projections of the two packages' own fits, within the fits' factor bar
    for port, ref, data in ((port_s, ref_s, X), (port_s, ref_s, X_new)):
        p, r = port.predict(data, device="cpu"), np.asarray(ref.predict(data))
        assert np.abs(p - r).max() <= MSE_FACTOR_TOL * np.abs(r).max()
    want = ref_d.predict(X_new)
    for name in ("L1", "L2"):
        r = np.asarray(want[name])
        assert np.abs(out[name] - r).max() <= MSE_FACTOR_TOL * np.abs(r).max()


def test_predict_on_carried_across_factors(predict_fits):
    """The JAX fit carried into the port (``convert``) projects as the JAX
    package projects it: one solve on identical factors, 1e-5 of the
    largest entry (the projection bar)."""
    (ref_s, ref_d), _, X, X_new = predict_fits
    for ref in (ref_s, ref_d):
        carried = convert.graph_result_from_reference(ref)
        assert isinstance(carried, tg.GraphResult)
        got, want = carried.predict(X_new, device="cpu"), ref.predict(X_new)
        if not isinstance(want, dict):
            got, want = {"L1": got}, {"L1": want}
        for name, r in want.items():
            r = np.asarray(r)
            assert np.abs(got[name] - r).max() <= 1e-5 * np.abs(r).max()


def test_predict_refuses_branched_nets(modalities):
    A1, A2 = modalities
    i1, i2 = tg.Input(A1, "a"), tg.Input(A2, "b")
    top = tg.NMFLayer(tg.Concat(tg.NMFLayer(i1, 3, name="b1"),
                                tg.NMFLayer(i2, 2, name="b2")), 2, name="top")
    res = tg.fit(tg.factor_net([i1, i2], top, maxit=3, seed=1),
                 device="cpu")
    with pytest.raises(ValueError, match="linear-chain"):
        res.predict(A1, device="cpu")


def test_factor_input_spz(tmp_path):
    from rcppml_tpu.io.spz import st_write
    rs = np.random.RandomState(2)
    X = np.abs(rs.rand(25, 20)).astype(np.float32)
    X[X < 0.4] = 0
    p = str(tmp_path / "g.spz")
    st_write(sp.csc_matrix(X), p)
    inp_p = tg.factor_input(p, "xs")
    np.testing.assert_array_equal(inp_p.data, jg.factor_input(p, "xs").data)

    def build(G):
        inp = G.factor_input(p, "xs")
        return G.factor_net([inp], G.nmf_layer(inp, 3, name="L1"), maxit=10,
                            seed=1)

    want, port, net = _fit_both(build)
    assert port["L1"].W.shape == (25, 3)
    _same_graph_fit(port, want, net)
    _raise_alike(lambda: jg.factor_input(str(tmp_path / "missing.spz")),
                 lambda: tg.factor_input(str(tmp_path / "missing.spz")),
                 ValueError, "no such")
    _raise_alike(lambda: jg.factor_input("/tmp/file.csv"),
                 lambda: tg.factor_input("/tmp/file.csv"), ValueError, "spz")


def test_layer_side_config_does_not_leak(modalities):
    X = modalities[0]
    cfg = tg.GlobalConfig(maxit=5, seed=1, dots={"L1": [0.0, 0.0]})
    inp = tg.factor_input(X, "X")
    l1 = tg.nmf_layer(inp, 4, name="L1", W=tg.W(L1=0.4))
    net = tg.factor_net([inp], l1, config=cfg)
    port = tg.fit(net, device="cpu")
    assert cfg.dots == {"L1": [0.0, 0.0]}
    kw, _ = net._layer_kwargs(l1)
    assert kw["L1"] == [0.4, 0.0] and cfg.dots["L1"] == [0.0, 0.0]

    gc = jg.GlobalConfig(maxit=5, seed=1, dots={"L1": [0.0, 0.0]})
    inp_j = jg.factor_input(X, "X")
    want = jg.fit(jg.factor_net([inp_j], jg.nmf_layer(
        inp_j, 4, name="L1", W=jg.W(L1=0.4)), config=gc))
    _same_graph_fit(port, want, net)


def test_multimodal_dispatch_forwards_kwargs():
    X1, X2 = _multimodal_data(5)
    data = {"a": X1, "b": X2}
    kw = dict(maxit=15, seed=42, device="cpu")
    plain = rtt.nmf(data, 3, **kw)
    reg = rtt.nmf(data, 3, L1=(0.0, 0.3), **kw)
    assert (reg["L1"].H == 0).mean() > (plain["L1"].H == 0).mean()
    _same_factors(reg["L1"], rt.nmf(data, 3, maxit=15, seed=42,
                                    L1=(0.0, 0.3))["L1"], MSE_FACTOR_TOL)
    cv = rtt.nmf(data, 3, test_fraction=0.1, cv_seed=1, **kw)
    want = rt.nmf(data, 3, maxit=15, seed=42, test_fraction=0.1, cv_seed=1)
    assert np.isfinite(cv["L1"].test_loss)
    _close(cv["L1"].test_loss, want["L1"].test_loss, IRLS_LOSS_RTOL, 1e-12)


def test_single_layer_matches_nmf_exactly(ranked):
    """The single layer is ``nmf`` itself: bit for bit in the port, and
    within the bars of the JAX package's (over a fixed count: with tol=1e-4
    the two stop at 37 and 36 iterations, 3.9e-5 apart in loss)."""
    A = ranked
    inp = tg.factor_input(A, "X")
    net = tg.factor_net(inp, tg.nmf_layer(inp, 5, name="L1"),
                        config=rtt.factor_config(maxit=50, tol=1e-4,
                                                 seed=42))
    fn = tg.fit(net, device="cpu")["L1"]
    direct = rtt.nmf(A, 5, maxit=50, tol=1e-4, seed=42, device="cpu")
    for name in ("W", "d", "H"):
        np.testing.assert_array_equal(getattr(fn, name),
                                      getattr(direct, name))
    fixed = rtt.nmf(A, 5, maxit=50, tol=0, seed=42, device="cpu")
    want = rt.nmf(A, 5, maxit=50, tol=0, seed=42)
    assert fixed.iterations == want.iterations == 50
    _same_factors(fixed, jg.LayerResult(W=np.asarray(want.W),
                                     d=np.asarray(want.d),
                                     H=np.asarray(want.H)), MSE_FACTOR_TOL)


def test_multimodal_matches_concatenated_nmf(modalities):
    A1, A2 = modalities
    i1, i2 = tg.factor_input(A1, "m1"), tg.factor_input(A2, "m2")
    net = tg.factor_net([i1, i2], tg.nmf_layer(tg.Shared(i1, i2), 4,
                                               name="J"),
                        config=rtt.factor_config(maxit=50, seed=42))
    fn = tg.fit(net, device="cpu")["J"]
    cat = rtt.nmf(np.vstack([A1, A2]), 4, maxit=50, seed=42, device="cpu")
    np.testing.assert_array_equal(
        np.vstack([fn.W_blocks["m1"], fn.W_blocks["m2"]]), cat.W)
    np.testing.assert_array_equal(fn.d, cat.d)
    want = rt.nmf(np.vstack([A1, A2]), 4, maxit=50, seed=42)
    np.testing.assert_allclose(np.sort(fn.d)[::-1],
                               np.sort(np.asarray(want.d))[::-1], rtol=1e-4)


def test_layer_W_H_override_hierarchy(modalities):
    A, _ = modalities

    def build(G):
        inp = G.factor_input(A, "X")
        layer = G.nmf_layer(inp, 5, name="L1", L1=0.01, H=G.H(L1=0.05))
        return G.factor_net(inp, layer, config=G.factor_config(maxit=30,
                                                               seed=42))

    want, port, net = _fit_both(build)
    assert (port["L1"].d > 0).all()
    _same_graph_fit(port, want, net)


def test_single_layer_cv_test_loss(modalities):
    A, _ = modalities

    def build(G):
        inp = G.factor_input(A, "X")
        return G.factor_net(inp, G.nmf_layer(inp, 5, name="L1"),
                            config=G.factor_config(
                                maxit=30, tol=1e-4, seed=42,
                                test_fraction=0.1, cv_seed=99, patience=5))

    want, port, net = _fit_both(build)
    lr = port["L1"]
    assert lr.test_loss > 0 and lr.best_test_loss > 0 and lr.loss > 0
    _same_graph_fit(port, want, net, cv=True)


def test_training_logger_deep_fit(ranked):
    A = ranked
    loggers = {}
    results = {}
    for G, mod, kw in ((jg, rt, {}), (tg, rtt, dict(device="cpu"))):
        loggers[G] = mod.training_logger()
        inp = G.factor_input(A, "X")
        net = G.factor_net(inp, G.nmf_layer(G.nmf_layer(inp, 8, name="enc"),
                                            3, name="bot"),
                           config=G.factor_config(maxit=10, tol=1e-8,
                                                  seed=42))
        results[G] = G.fit(net, logger=loggers[G], **kw)
    port, ref = loggers[tg].records, loggers[jg].records
    assert results[tg].logger is loggers[tg]
    assert len(port) == len(ref) > 0
    _same_graph_fit(results[tg], results[jg], net)
    floors = dict(zip(("enc", "bot"), _loss_floors(net, results[jg])))
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert p["iter"] == r["iter"]
        _close(p["train_loss"], r["train_loss"], MSE_LOSS_RTOL,
               sum(floors.values()))
        for name, floor in floors.items():
            _close(p[f"{name}_loss"], r[f"{name}_loss"], MSE_LOSS_RTOL,
                   floor)
            # the norm of W diag(d) H: within the factors' bar
            _close(p[f"{name}_frobenius"], r[f"{name}_frobenius"],
                   MSE_FACTOR_TOL)


def test_graph_regularization_changes_w(ranked):
    A = ranked
    m = A.shape[0]
    lap = (np.diag(np.full(m, 2.0)) + np.diag(np.full(m - 1, -1.0), 1)
           + np.diag(np.full(m - 1, -1.0), -1)).astype(np.float32)

    def build(G, reg):
        inp = G.factor_input(A, "X")
        side = dict(W=G.W(graph=lap, graph_lambda=1.0)) if reg else {}
        return G.factor_net(inp, G.nmf_layer(inp, 5, name="L", **side),
                            config=G.factor_config(maxit=30, seed=42))

    plain = tg.fit(build(tg, False), device="cpu")["L"]
    want, port, net = _fit_both(lambda G: build(G, True))
    assert np.max(np.abs(plain.W - port["L"].W)) > 1e-4
    assert (port["L"].W >= -1e-10).all() and (port["L"].H >= -1e-10).all()
    _same_graph_fit(port, want, net)


def test_mixed_svd_nmf_deep(ranked):
    A = ranked

    def build(G, **over):
        inp = G.factor_input(A, "X")
        l2 = G.nmf_layer(G.svd_layer(inp, 8, name="pca"), 3, name="top")
        return G.factor_net(inp, l2, config=G.factor_config(maxit=10,
                                                            seed=42), **over)

    # the fused loop stops at the first sweep whose relative change is
    # below tol, without patience: the JAX package's own stopping sweep
    # moves under a one-ulp change of A (10 -> 2 here), so the structure
    # is checked as the JAX test fits it and the trajectory over 10 sweeps
    want, port, net = _fit_both(build)
    assert port["top"].W.shape[1] == 3 and np.isfinite(port.total_loss)
    want, port, net = _fit_both(lambda G: build(G, tol=0.0))
    _same_graph_fit(port, want, net)


def test_svd_layer_signed_factors(modalities):
    A, _ = modalities
    B = A - A.mean()

    def build(G):
        inp = G.factor_input(B, "X")
        return G.factor_net(inp, G.svd_layer(inp, 3, name="S"),
                            config=G.factor_config(maxit=10, seed=1))

    want, port, net = _fit_both(build)
    assert (port["S"].W < 0).any() or (port["S"].H < 0).any()
    _same_graph_fit(port, want, net)


def test_factor_input_rejects_missing_spz(tmp_path):
    _raise_alike(lambda: jg.factor_input(str(tmp_path / "nope.spz"), "X"),
                 lambda: tg.factor_input(str(tmp_path / "nope.spz"), "X"),
                 ValueError, "spz")


def test_graph_repr_methods(modalities):
    A, _ = modalities
    inp = tg.factor_input(A, "X")
    net = tg.factor_net(inp, tg.nmf_layer(inp, 3, name="L1"),
                        config=rtt.factor_config(maxit=5, seed=1))
    assert repr(net)
    assert repr(tg.fit(net, device="cpu"))


def test_cycle_raises(modalities):
    A, _ = modalities
    for G in (jg, tg):
        inp = G.Input(A, "x")
        l1 = G.NMFLayer(inp, 2, name="a")
        l2 = G.NMFLayer(l1, 2, name="b")
        l1.input = l2
        with pytest.raises(ValueError, match="cycle"):
            G.factor_net(inp, l2)


def _error_net(G, case, modalities):
    A, B = modalities
    i1 = G.Input(A, "a")
    if case == "shared_columns":
        i2 = G.Input(np.random.RandomState(0).rand(10, 59).astype(
            np.float32), "b")
        return G.factor_net([i1, i2], G.NMFLayer(G.Shared(i1, i2), 2,
                                                 name="s"), maxit=3)
    if case == "concat_samples":
        i2 = G.Input(B[:, :50], "b")
        top = G.Concat(G.NMFLayer(i1, 2, name="a"),
                       G.NMFLayer(i2, 2, name="b"))
    elif case == "concat_not_layer":
        i2 = G.Input(B, "b")
        top = G.Concat(G.NMFLayer(i1, 2, name="a"), i2)
    else:
        i2 = G.Input(B, "b")
        top = G.Add(G.NMFLayer(i1, 2, name="a"), G.NMFLayer(i2, 3, name="b"))
    return G.factor_net([i1, i2], G.NMFLayer(top, 2, name="top"), maxit=3)


@pytest.mark.parametrize("case,match", [
    ("shared_columns", "equal columns"),
    ("concat_samples", "mismatched sample"),
    ("concat_not_layer", "not a layer"),
    ("add_rank", "mismatched H shapes")])
def test_topology_errors_match(modalities, case, match):
    """The four edge cases of the JAX tests (shared inputs with unequal
    columns, concat branches over different samples or not a layer, add
    branches of different rank): the same ValueError in both packages."""
    _raise_alike(lambda: jg.fit(_error_net(jg, case, modalities)),
                 lambda: tg.fit(_error_net(tg, case, modalities),
                                device="cpu"),
                 ValueError, match)


def test_per_layer_losses_differ(ranked):
    A = ranked

    def build(G):
        inp = G.Input(A, "x")
        l2 = G.NMFLayer(G.NMFLayer(inp, 5, name="L1"), 2, name="L2")
        return G.factor_net(inp, l2, maxit=25, seed=7)

    want, port, net = _fit_both(build)
    assert port["L1"].loss != port["L2"].loss
    _same_graph_fit(port, want, net)


# the JAX package's mesh tests, on a (1, 1) mesh of one process
MESH_NETS = {
    "fit_on_mesh_matches_single": lambda A1, A2: tg.factor_net(
        [tg.Input(A1, "rna")], tg.NMFLayer(tg.NMFLayer(tg.Shared(
            tg.Input(A1, "rna"), tg.Input(A2, "adt")), 4, name="J"), 2,
            name="T"), maxit=6, tol=0.0, seed=3),
    "mesh_rejects_host_loop_layers": lambda A1, A2: tg.factor_net(
        tg.Input(A1, "x"), tg.NMFLayer(tg.NMFLayer(
            tg.Input(A1, "x"), 3, name="a", loss="nb"), 2, name="b"),
        maxit=3),
    "mesh_with_condition_covariates": lambda A1, A2: tg.factor_net(
        tg.Input(A1, "x"), tg.NMFLayer(tg.Condition(tg.NMFLayer(
            tg.Input(A1, "x"), 4, name="L1"), np.ones((60, 3), np.float32)),
            2, name="L2"), maxit=5, tol=0.0, seed=11),
    "mesh_loss_normalized_by_true_size": lambda A1, A2: tg.factor_net(
        tg.Input(A1, "x"), tg.NMFLayer(tg.NMFLayer(
            tg.Input(A1, "x"), 4, name="L1"), 2, name="L2"),
        maxit=5, tol=0.0, seed=7),
    "single_layer": lambda A1, A2: tg.factor_net(
        tg.Input(A1, "x"), tg.NMFLayer(tg.Input(A1, "x"), 2, name="L"),
        maxit=3)}


# the nets a mesh refuses, as the JAX package does, and the words it says
MESH_REFUSED = {"mesh_rejects_host_loop_layers": "mesh",
                "single_layer": "single-layer"}


@pytest.mark.parametrize("case", list(MESH_NETS))
def test_graph_mesh_raises_unported(modalities, case):
    """``fit(net, mesh=)`` raised ``NotImplementedError`` until the graph
    under a mesh was ported.  Now a net of the fused outer ALS fits on a
    (1, 1) mesh bit for bit as it does without one (every collective is a
    no-op there), and a single-layer net or one that needs the host loop
    raises ``ValueError`` as the JAX package does."""
    from rcppml_tpu_torch.parallel.mesh import default_mesh
    mesh = default_mesh(devices=["cpu"])
    net = MESH_NETS[case](*modalities)
    if case in MESH_REFUSED:
        with pytest.raises(ValueError, match=MESH_REFUSED[case]):
            tg.fit(net, mesh=mesh, device="cpu")
        return
    on_mesh = tg.fit(net, mesh=mesh, device="cpu")
    plain = tg.fit(MESH_NETS[case](*modalities), device="cpu")
    assert on_mesh.total_iterations == plain.total_iterations
    assert on_mesh.total_loss == plain.total_loss
    for name, lr in plain.layers.items():
        for attr in ("W", "d", "H"):
            np.testing.assert_array_equal(getattr(on_mesh[name], attr),
                                          getattr(lr, attr), err_msg=attr)
        assert on_mesh[name].loss == lr.loss
        if lr.W_blocks:
            assert sorted(on_mesh[name].W_blocks) == sorted(lr.W_blocks)


def test_graph_dev_cache_invalidates_on_new_data(monkeypatch):
    rs = np.random.RandomState(2)
    A1 = np.abs(rs.rand(30, 40)).astype(np.float32)
    A2 = np.abs(rs.rand(30, 40)).astype(np.float32)
    uploads = []
    real = tg.device_matrix
    monkeypatch.setattr(tg, "device_matrix",
                        lambda A, dev: uploads.append(1) or real(A, dev))

    def build(G):
        inp = G.Input(A1, "x")
        l2 = G.NMFLayer(G.NMFLayer(inp, 3, name="L1"), 2, name="L2")
        return G.factor_net(inp, l2, maxit=5, tol=0.0, seed=3), inp

    net, inp = build(tg)
    r1 = tg.fit(net, device="cpu")
    again = tg.fit(net, device="cpu")
    assert len(uploads) == 1                       # a refit uploads nothing
    assert again.total_loss == r1.total_loss
    inp.data = A2
    r2 = tg.fit(net, device="cpu")
    assert len(uploads) == 2                       # new data: one upload
    assert abs(r1.total_loss - r2.total_loss) > 1e-6
    r3 = tg.fit(net, device="cpu")
    assert len(uploads) == 2 and r3.total_loss == r2.total_loss

    net_j, inp_j = build(jg)
    w1 = jg.fit(net_j)
    inp_j.data = A2
    w2 = jg.fit(net_j)
    for port, want in ((r1, w1), (r2, w2)):
        _close(port.total_loss, want.total_loss, MSE_LOSS_RTOL, 1e-9)


# ---------------------------------------------------------------------------
# the port's own seams
# ---------------------------------------------------------------------------

def test_fused_loop_from_the_jax_warm_states(modalities):
    """The outer loop alone: the JAX package's warm states (its own warmup
    fits, as ``_fit_deep_fused`` runs them) carried into the port's loop
    through ``convert.graph_states_from_numpy``; both loops' sweeps from
    those states within the MSE bars of the JAX fused result."""
    A, A2 = modalities
    Z = np.random.RandomState(3).rand(60, 2).astype(np.float32)

    def build(G):
        i1, i2 = G.Input(A, "a"), G.Input(A2, "b")
        top = G.NMFLayer(G.Condition(G.Concat(G.NMFLayer(i1, 4, name="b1"),
                                              G.NMFLayer(i2, 3, name="b2")),
                                     Z), 2, name="top")
        return G.factor_net([i1, i2], top, maxit=6, tol=0.0, seed=5)

    net_j = build(jg)
    want = jg.fit(net_j)
    # the JAX warmups, replayed as its fused path runs them
    data_map = {id(n): net_j._input_matrix(n) for n in (
        net_j._resolve_source(l.input)[0] for l in net_j._layers)
        if isinstance(n, (jg.Input, jg.Shared))}
    warm = [None] * net_j.n_layers
    for i, layer in enumerate(net_j._layers):
        inp = net_j._effective_input(i, warm, data_map)
        res = net_j._fit_layer(layer, inp, maxit=min(10, net_j.maxit),
                               seed=5 + i)
        warm[i] = jg.LayerResult(W=np.asarray(res.W), d=np.asarray(res.d),
                                 H=np.asarray(res.H))
    net_t = build(tg)
    port = net_t._fit_deep_fused(
        net_t._data_map(), CPU, warm_states=convert.graph_states_from_numpy(
            [(s.W.T, s.H, s.d) for s in warm], device=CPU))
    assert not hasattr(net_t, "_warm_iterations")   # no warmup fit ran
    _same_graph_fit(port, want, net_t)


@pytest.mark.parametrize("tol", [0.0, 1e-12])
def test_fused_loop_host_reads(modalities, tol):
    """With tol == 0 the outer loop reads nothing on the host until the end
    and runs every sweep; with tol > 0 it reads one flag a sweep."""
    A, _ = modalities
    inp = tg.Input(A, "x")
    net = tg.factor_net(inp, tg.NMFLayer(tg.NMFLayer(inp, 4, name="L1"), 2,
                                         name="L2"), maxit=7, tol=tol,
                        seed=2)
    before = tg._outer_als.host_reads
    res = tg.fit(net, device="cpu")
    reads = tg._outer_als.host_reads - before
    if tol == 0:
        assert res.total_iterations == 7 and reads == 0
    else:
        assert reads == res.total_iterations >= 1


def test_fused_warmups_follow_the_reference_seeds(modalities):
    """Warmups: min(10, maxit) iterations a layer, seeded seed or 42 plus the
    layer's index (``self.seed`` is 0 without a seed)."""
    A, _ = modalities
    inp = tg.Input(A, "x")
    net = tg.factor_net(inp, tg.NMFLayer(tg.NMFLayer(inp, 4, name="L1"), 2,
                                         name="L2"), maxit=3, tol=0.0)
    assert net.seed == 0
    seeds = []
    real = tg.FactorNet._fit_layer

    def spy(self, layer, data, **kw):
        seeds.append((layer.name, kw.get("seed"), kw["maxit"]))
        return real(self, layer, data, **kw)

    tg.FactorNet._fit_layer = spy
    try:
        tg.fit(net, device="cpu")
    finally:
        tg.FactorNet._fit_layer = real
    assert seeds == [("L1", 42, 3), ("L2", 43, 3)]


def test_entry_points_need_a_card_or_device_cpu(modalities, monkeypatch):
    """Without a card and without ``device="cpu"`` every graph entry point
    raises; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, _ = modalities
    inp = tg.Input(A, "x")
    net = tg.factor_net(inp, tg.NMFLayer(tg.NMFLayer(inp, 3, name="L1"), 2,
                                         name="L2"), maxit=2)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tg.fit(net)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        rtt.nmf([A, A[:10]], 3, maxit=2)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tg.cross_validate_graph(inp, lambda p: tg.NMFLayer(inp, p["k"]),
                                params={"k": [2]}, reps=1)
    res = tg.fit(net, device="cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        res.predict(A)
    # a net built for the CPU fits there; a CPU tensor fits on its device
    assert tg.fit(tg.factor_net(inp, tg.NMFLayer(inp, 2), maxit=2,
                                device="cpu")).total_iterations == 2
    t_inp = tg.Input(torch.from_numpy(A), "t")
    assert tg.fit(tg.factor_net(t_inp, tg.NMFLayer(tg.NMFLayer(
        t_inp, 3, name="a"), 2, name="b"), maxit=2)).total_iterations == 2


def test_tensor_inputs_fit_as_host_arrays(modalities):
    """Tensor inputs (and a SHARED node mixing a tensor and a host array)
    give the host arrays' fit bit for bit."""
    A1, A2 = modalities

    def build(d1, d2):
        i1, i2 = tg.Input(d1, "a"), tg.Input(d2, "b")
        l2 = tg.NMFLayer(tg.NMFLayer(tg.Shared(i1, i2), 4, name="J"), 2,
                         name="T")
        return tg.factor_net([i1, i2], l2, maxit=4, tol=0.0, seed=9)

    host = tg.fit(build(A1, A2), device="cpu")
    mixed = tg.fit(build(torch.from_numpy(A1), A2))
    for name in ("J", "T"):
        for f in ("W", "d", "H"):
            np.testing.assert_array_equal(getattr(mixed[name], f),
                                          getattr(host[name], f))
    np.testing.assert_array_equal(mixed["J"].W_blocks["b"],
                                  host["J"].W_blocks["b"])


def test_global_config_from_reference():
    gc = jg.factor_config(maxit=7, tol=1e-3, loss="gp", seed=4,
                          solver="cd", test_fraction=0.2, cv_seed=3,
                          patience=2, L2=[0.1, 0.2])
    port = convert.global_config_from_reference(gc)
    assert isinstance(port, tg.GlobalConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(gc)
    assert port.dots is not gc.dots


def test_lazy_names_resolve_in_the_port():
    """Every lazy name of the JAX package resolves in the port, except the
    TPU probes (the port never runs on a TPU); ``default_mesh`` resolves
    since queue 1 item 14a."""
    import rcppml_tpu
    missing = [name for name in rcppml_tpu._LAZY
               if not hasattr(rtt, name)]
    assert sorted(missing) == ["tpu_available", "tpu_info"]
    for name in tg.__dict__.keys() & set(rtt.__all__):
        assert getattr(rtt, name) is getattr(tg, name)


OVER_RANKED = {
    "single layer k=5": lambda G, A: G.factor_net(
        G.factor_input(A, "X"), G.nmf_layer(G.factor_input(A, "X"), 5,
                                            name="L1"),
        config=G.factor_config(maxit=50, tol=1e-4, seed=42)),
    "graph-regularized k=5": lambda G, A: G.factor_net(
        G.factor_input(A, "X"), G.nmf_layer(
            G.factor_input(A, "X"), 5, name="L", W=G.W(
                graph=(2 * np.eye(40) - np.eye(40, k=1)
                       - np.eye(40, k=-1)).astype(np.float32),
                graph_lambda=1.0)),
        config=G.factor_config(maxit=30, seed=42)),
    "deep k=8 -> 3": lambda G, A: G.factor_net(
        G.factor_input(A, "X"), G.nmf_layer(G.nmf_layer(
            G.factor_input(A, "X"), 8, name="enc"), 3, name="bot"),
        config=G.factor_config(maxit=10, tol=1e-8, seed=42))}


@pytest.mark.parametrize("case", list(OVER_RANKED))
def test_over_ranked_fixture_is_chaotic_in_the_jax_package(modalities,
                                                           case):
    """Why the nets with a layer past the planted rank run on ``ranked``:
    on the rank-3 fixture the JAX package's own W moves past the 2e-3 bar
    under a one-ulp change of one of A's rows (rows 0, 1, 5, 17)."""
    A, _ = modalities
    a = jg.fit(OVER_RANKED[case](jg, A))
    spread = 0.0
    for row in (0, 1, 5, 17):
        b = jg.fit(OVER_RANKED[case](jg, _bump_row(A, row)))
        spread = max(spread, max(
            float(np.abs(a[name].W - b[name].W).max()
                  / np.abs(a[name].W).max()) for name in a.layers))
    assert spread > MSE_FACTOR_TOL, spread
