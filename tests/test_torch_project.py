"""The port's projection API (``nnls``, ``predict``, ``evaluate``, ``mse``)
against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs: a ``simulate_nmf`` matrix
and nonnegative factors.  Every ``nnls`` route (Cholesky + clip, CD, L1,
L2, ``upper_bound``, ``warm_start``, KL and NB / GP with each form of
``theta``, the one-iteration NMF delegation for L21 and targets) is held
within 1e-5 of the JAX package's largest entry; the power losses within
1e-4 (the IRLS fits' factor bar), and the delegation from ``h=``, which is
a whole NMF iteration from a random W, within 2e-3 (the NMF fits' bar).
``predict``, ``evaluate`` and ``mse`` on a model fitted by the JAX package
and carried across by ``convert.nmf_result_from_reference`` within rtol
1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rcppml_tpu as rt
from rcppml_tpu.models import project as ref_project

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.models import project
from rcppml_tpu_torch.utils.simulate import simulate_nmf

M, N, K = 120, 90, 5
TOL = 1e-5


@pytest.fixture(scope="module")
def sim():
    return simulate_nmf(M, N, K, seed=8)


@pytest.fixture(scope="module")
def counts(sim):
    return np.round(sim["A"] * 3).astype(np.float32)


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max(), \
        np.abs(port - ref).max() / np.abs(ref).max()


def _wide_factor(k, seed):
    return np.random.RandomState(seed).uniform(
        0.1, 1.0, (M, k)).astype(np.float32)


ROUTES = {
    "cholesky": dict(),
    "cholesky_nonneg_off": dict(nonneg=False),
    "cd": dict(solver="cd"),
    "L1": dict(L1=0.01),
    "L2": dict(L2=0.1),
    "upper_bound": dict(upper_bound=0.05),
    "cd_upper_bound": dict(solver="cd", upper_bound=0.05),
    "angular": dict(angular=0.1),
    "k40_auto_cd": dict(k=40),
    "warm_start": dict(warm_start=True),
    "h_side": dict(side="h"),
    "h_side_warm_start": dict(side="h", warm_start=True),
    "cd_tol": dict(solver="cd", cd_maxit=7, cd_tol=1e-3),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_nnls_mse_routes_match_reference(case, sim):
    kw = dict(ROUTES[case])
    k = kw.pop("k", K)
    side = kw.pop("side", "w")
    A = sim["A"]
    if side == "w":
        F = sim["W"] if k == K else _wide_factor(k, 1)
        fkw = dict(w=F)
    else:
        fkw = dict(h=sim["H"])
    if kw.pop("warm_start", False):
        start = ref_project.nnls(A, **fkw)
        kw["warm_start"] = start * 0.9
    ref = ref_project.nnls(A, **fkw, **kw)
    port = rtt.nnls(A, **fkw, device="cpu", **kw)
    _close(port, ref)


THETA = {"none": None, "scalar": 2.0, "per_row": "row", "per_col": "col"}


@pytest.mark.parametrize("theta", list(THETA))
@pytest.mark.parametrize("loss", ["nb", "gp"])
def test_nnls_dispersion_losses_match_reference(loss, theta, sim, counts):
    th = THETA[theta]
    rs = np.random.RandomState(3)
    if th == "row":
        th = rs.uniform(0.5, 5.0, M).astype(np.float32)
    elif th == "col":
        th = rs.uniform(0.5, 5.0, N).astype(np.float32)
    kw = dict(w=sim["W"], loss=loss, theta=th)
    _close(rtt.nnls(counts, device="cpu", **kw),
           ref_project.nnls(counts, **kw))


@pytest.mark.parametrize("kw", [dict(loss="kl"), dict(loss="kl", L1=0.01),
                                dict(loss="gamma"), dict(loss="tweedie"),
                                dict(loss="inverse_gaussian"),
                                dict(loss="kl", irls_max_iter=2),
                                dict(loss="kl", upper_bound=0.02)],
                         ids=["kl", "kl_L1", "gamma", "tweedie",
                              "inverse_gaussian", "kl_two_inner",
                              "kl_upper_bound"])
def test_nnls_irls_losses_match_reference(kw, sim, counts):
    """KL within 1e-5; the power losses, whose weights 1/mu^p amplify the
    last bits of mu, within the IRLS fits' factor bar 1e-4."""
    A = counts + (1.0 if kw["loss"] in ("gamma", "inverse_gaussian") else 0.0)
    _close(rtt.nnls(A, w=sim["W"], device="cpu", **kw),
           ref_project.nnls(A, w=sim["W"], **kw),
           tol=TOL if kw["loss"] == "kl" else 1e-4)


def test_nnls_fused_wgram_route(sim, counts, monkeypatch):
    """Under ``RCPPML_FUSED_WGRAM`` the KL solve goes through kernel 4's
    twin on the CPU: the default route's result bit for bit."""
    plain = rtt.nnls(counts, w=sim["W"], loss="kl", device="cpu")
    monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    fused = rtt.nnls(counts, w=sim["W"], loss="kl", device="cpu")
    np.testing.assert_array_equal(fused, plain)


@pytest.mark.parametrize("kw", [dict(L21=0.05), dict(L21=0.05, side="h"),
                                dict(target=1.0), dict(target=-0.5),
                                dict(maxit_kw=True)],
                         ids=["L21", "L21_h", "target_enrich",
                              "target_proj_adv", "fit_kwargs"])
def test_nnls_nmf_delegation_matches_reference(kw, sim):
    kw = dict(kw)
    A = sim["A"]
    fkw = dict(h=sim["H"]) if kw.pop("side", "w") == "h" else dict(w=sim["W"])
    if "target" in kw:
        lam = kw.pop("target")
        T = np.random.RandomState(2).uniform(0, 0.1, (K, N)).astype(
            np.float32)
        kw.update(target_H=T, target_lambda=lam)
    if kw.pop("maxit_kw", False):
        kw["cd_maxit"] = 50
        kw["seed"] = 3
        kw["solver"] = "cd"
    ref = ref_project.nnls(A, **fkw, **kw)
    port = rtt.nnls(A, **fkw, device="cpu", **kw)
    # with h= the delegation runs a whole NMF iteration from a random W
    # (an h_init without a w_init is ignored, in both packages): two chained
    # solves from a random start, held to the NMF fits' factor bar
    _close(port, ref, tol=2e-3 if "h" in fkw else TOL)


def test_nnls_inputs_and_errors(sim, tmp_path):
    A = sim["A"]
    base = rtt.nnls(A, w=sim["W"], device="cpu")
    np.testing.assert_array_equal(
        rtt.nnls(sp.csr_matrix(A), w=sim["W"], device="cpu"), base)
    np.testing.assert_array_equal(
        rtt.nnls(torch.from_numpy(A), w=torch.from_numpy(sim["W"])), base)
    with pytest.raises(ValueError, match="exactly one"):
        rtt.nnls(A, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        rtt.nnls(A, w=sim["W"], h=sim["H"], device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        rtt.nnls(A, w=sim["W"], L1=-1.0, device="cpu")
    with pytest.raises(ValueError, match="theta length"):
        rtt.nnls(A, w=sim["W"], loss="nb", theta=np.ones(7), device="cpu")
    # a .spz file projects panel by panel, as the whole matrix does
    # (tests/test_torch_streaming.py holds it to the JAX package)
    path = str(tmp_path / "x.spz")
    rtt.st_write(A, path, value_type="float32", chunk_cols=32)
    _close(project.nnls_streaming(path, sim["W"], device="cpu"), base)


# ---------------------------------------------------------------------------
# predict / evaluate / mse on a model fitted by the JAX package
# ---------------------------------------------------------------------------

MODELS = {
    "mse": dict(),
    "mse_L1": dict(L1=(0.0, 0.05), solver="cd"),
    "kl": dict(loss="kl"),
    "nb_row": dict(loss="nb"),
    "nb_col": dict(loss="nb", dispersion="per_col"),
    "gp": dict(loss="gp"),
}


@pytest.fixture(scope="module")
def fitted(counts):
    return {name: rt.nmf(counts, K, maxit=4, tol=0, seed=1, **kw)
            for name, kw in MODELS.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_predict_evaluate_mse_on_reference_model(name, fitted, counts):
    ref_model = fitted[name]
    model = convert.nmf_result_from_reference(ref_model)
    assert isinstance(model, rtt.NMFResult)
    assert model.misc["config"].loss.value == \
        ref_model.misc["config"].loss.value
    new = np.round(np.random.RandomState(5).uniform(0, 2, (M, 17))).astype(
        np.float32)
    _close(rtt.predict(model, new, device="cpu"),
           ref_project.predict(ref_model, new))
    _close(model.predict(new, device="cpu"), ref_model.predict(new))
    loss = MODELS[name].get("loss", "mse")
    for kw in (dict(loss=loss), dict(loss="mse"),
               dict(loss=loss, mask_zeros=True)):
        assert rtt.evaluate(model, counts, device="cpu", **kw) == \
            pytest.approx(ref_project.evaluate(ref_model, counts, **kw),
                          rel=1e-5)
    assert rtt.mse(model, counts, device="cpu") == pytest.approx(
        ref_project.mse(ref_model, counts), rel=1e-5)


def test_predict_explicit_arguments_win(fitted, counts):
    ref_model = fitted["mse_L1"]
    model = convert.nmf_result_from_reference(ref_model)
    new = counts[:, :11]
    for kw in (dict(L1=0.0), dict(L2=0.2), dict(upper_bound=0.1),
               dict(loss="kl")):
        _close(rtt.predict(model, new, device="cpu", **kw),
               ref_project.predict(ref_model, new, **kw))


def test_evaluate_masks_match_reference(fitted, counts):
    ref_model = fitted["kl"]
    model = convert.nmf_result_from_reference(ref_model)
    mask = np.random.RandomState(7).rand(M, N) < 0.2
    for kw in (dict(mask=mask), dict(mask=mask, missing_only=True),
               dict(mask=mask, mask_zeros=True, loss="kl")):
        assert rtt.evaluate(model, counts, device="cpu", **kw) == \
            pytest.approx(ref_project.evaluate(ref_model, counts, **kw),
                          rel=1e-5)
    with pytest.raises(ValueError, match="missing_only"):
        rtt.evaluate(model, counts, missing_only=True, device="cpu")


def test_port_fitted_model_round_trip(counts):
    """A model the port fits projects its own training columns close to
    its H (predict solves against W diag(d), so the scale stays in d), and
    the generics agree with the methods."""
    model = rtt.nmf(counts, K, maxit=30, tol=0, seed=1, device="cpu")
    H = rtt.predict(model, counts, device="cpu")
    assert np.abs(H - model.H).max() <= 0.05 * np.abs(model.H).max()
    assert rtt.sparsity(model) == model.sparsity()
    np.testing.assert_array_equal(rtt.reconstruct(model),
                                  model.reconstruct())
    ref = rt.nmf(counts, K, maxit=30, tol=0, seed=1)
    assert model.sparsity()["factor"] == ref.sparsity()["factor"]


# ---------------------------------------------------------------------------
# A single column: a (k,) solution, as the JAX package returns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(upper_bound=0.2),
                                dict(nonneg=False), dict(L2=0.1)],
                         ids=["cholesky", "upper_bound", "nonneg_off", "L2"])
@pytest.mark.parametrize("side", ["w", "h"])
def test_nnls_of_one_column_matches_reference(side, kw, sim):
    rs = np.random.RandomState(21)
    if side == "w":
        F = _wide_factor(K, 22)
        a = sim["A"][:, 3].copy()
        port = rtt.nnls(a, w=F, device="cpu", **kw)
        ref = rt.nnls(a, w=F, **kw)
    else:
        F = rs.uniform(0.1, 1.0, (K, N)).astype(np.float32)
        a = sim["A"][4].copy()
        port = rtt.nnls(a, h=F, device="cpu", **kw)
        ref = rt.nnls(a, h=F, **kw)
    assert port.shape == np.shape(ref) == (K,)
    _close(port, ref)
    # the column's solution is the one of the same column inside a matrix
    whole = (rtt.nnls(sim["A"][:, 3:4], w=F, device="cpu", **kw)[:, 0]
             if side == "w" else
             rtt.nnls(sim["A"][4:5], h=F, device="cpu", **kw)[0])
    _close(port, whole)


@pytest.mark.parametrize("kw", [dict(solver="cd"), dict(L1=0.01),
                                dict(warm_start=np.ones(K, np.float32)),
                                dict(loss="kl")])
def test_nnls_of_one_column_raises_as_reference_on_other_routes(kw, sim):
    a = sim["A"][:, 3].copy()
    F = _wide_factor(K, 22)
    errors = []
    for fn, extra in ((rt.nnls, {}), (rtt.nnls, {"device": "cpu"})):
        with pytest.raises(Exception) as exc:
            fn(a, w=F, **kw, **extra)
        errors.append(exc.value)
    assert type(errors[0]) is type(errors[1]), errors
    assert str(errors[0]) == str(errors[1])


def test_predict_of_one_column_matches_reference(fitted, counts):
    ref_model = fitted["mse"]
    model = convert.nmf_result_from_reference(ref_model)
    col = counts[:, 7].copy()
    port = rtt.predict(model, col, device="cpu")
    ref = ref_project.predict(ref_model, col)
    assert port.shape == np.shape(ref) == (K,)
    _close(port, ref)
