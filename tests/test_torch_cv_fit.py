"""The port's cross-validated and masked fits, the rank sweep and the rank
search against the JAX package's, on the CPU.

Both packages get the same seeded matrix, the same seed and, where given, the
same ``w_init`` / ``h_init``.  Held here: MSE fits, train and test loss
histories within rtol 2e-4 and W / d / H within 2e-3 of their largest entry
(the bars of ``tests/test_torch_nmf.py``); IRLS fits, the bars of
``tests/test_torch_irls_fit.py`` (histories rtol 2e-4, factors 1e-4, theta /
dispersion / pi rtol 5e-3); ``best_iter`` and ``iterations`` equal.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rcppml_tpu as rt
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.models import nmf_cv as ref_cv
from rcppml_tpu.models import nmf_irls as ref_irls
from rcppml_tpu.models import rank_cv as ref_rank

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.models import nmf_cv, rank_cv
from rcppml_tpu_torch.utils.simulate import simulate_nmf

K = 4
M, N = 80, 60
LOSS_RTOL = 2e-4
MSE_FACTOR_TOL = 2e-3
IRLS_FACTOR_TOL = 1e-4
EXTRA_RTOL = 5e-3


@pytest.fixture(scope="module")
def data():
    return simulate_nmf(M, N, K, noise=0.3, seed=8)["A"]


@pytest.fixture(scope="module")
def holey():
    """A matrix with about 40% zeros."""
    return simulate_nmf(M, N, K, noise=0.3, dropout=0.4, seed=8)["A"]


@pytest.fixture(scope="module")
def counts():
    mean = simulate_nmf(M, N, K, noise=0.0, dropout=0.0, seed=3)["A"]
    return np.random.RandomState(4).poisson(
        5.0 * mean.astype(np.float64)).astype(np.float32)


@pytest.fixture(scope="module")
def user_mask():
    return np.random.RandomState(11).rand(M, N) < 0.1


def _assert_same_fit(port, ref, factor_tol=MSE_FACTOR_TOL, iterations=None):
    assert port.iterations == ref.iterations
    if iterations is not None:
        assert port.iterations == iterations
    assert port.best_iter == ref.best_iter
    assert port.converged == ref.converged
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port.test_loss_history, ref.test_loss_history,
                               rtol=LOSS_RTOL, atol=1e-12)
    np.testing.assert_allclose(port.train_loss, ref.train_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(port.test_loss, ref.test_loss, rtol=LOSS_RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(port.misc["best_test_loss"],
                               ref.misc["best_test_loss"], rtol=LOSS_RTOL)
    for name in ("W", "d", "H"):
        p = np.asarray(getattr(port, name), np.float64)
        r = np.asarray(getattr(ref, name), np.float64)
        assert np.abs(p - r).max() <= factor_tol * np.abs(r).max(), name
    for name in ("theta", "dispersion", "pi_row", "pi_col"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if r is not None:
            np.testing.assert_allclose(p, np.asarray(r), rtol=EXTRA_RTOL,
                                       err_msg=name)


def _both(A, k=K, **kw):
    return (rtt.nmf(A, k, device="cpu", **kw), rt.nmf(A, k, **kw))


# ---------------------------------------------------------------------------
# MSE: speckled CV, masks, NaN
# ---------------------------------------------------------------------------

CV = dict(test_fraction=0.1, cv_seed=3, seed=1, maxit=8, tol=0,
          cv_patience=100)

MSE_FITS = {
    "cholesky": dict(),
    "cd": dict(solver="cd"),
    "fraction_0.3": dict(test_fraction=0.3),       # 1 / 0.3 is floored to 3
    "cv_seed_0": dict(cv_seed=0),
    "row_col_subsample": dict(cv_row_subsample=0.5, cv_col_subsample=0.6),
    "L1_cd": dict(L1=(0.02, 0.05)),
    "L1_cholesky": dict(L1=(0.02, 0.05), solver="cholesky"),
    "L2": dict(L2=(0.1, 0.05)),
    "L21_upper": dict(L21=0.05, upper_bound=(0.0, 0.4), solver="cd"),
    "angular": dict(angular=(0.05, 0.0)),
    "signed_H": dict(nonneg=(True, False)),
    "norm_L2": dict(norm="L2", solver="cd"),
}


@pytest.mark.parametrize("case", list(MSE_FITS))
def test_cv_mse_fit_matches_reference(case, data):
    kw = {**CV, **MSE_FITS[case]}
    port, ref = _both(data, **kw)
    _assert_same_fit(port, ref, iterations=8)
    assert np.isfinite(port.test_loss_history).all()
    assert port.misc["host_syncs"] == 8        # one read per iteration
    if case in ("cholesky", "cd"):             # no penalty: the loss falls
        assert port.loss_history[-1] < port.loss_history[0]


@pytest.mark.parametrize("solver", ["cholesky", "cd"])
def test_cv_fit_from_given_factors(solver, data):
    rs = np.random.RandomState(5)
    w_init = rs.uniform(size=(M, K)).astype(np.float32)
    h_init = rs.uniform(size=(K, N)).astype(np.float32)
    port, ref = _both(data, w_init=w_init, h_init=h_init, solver=solver, **CV)
    _assert_same_fit(port, ref, iterations=8)


@pytest.mark.parametrize("side", ["H", "W"])
def test_cv_fit_with_graph_and_target(side, data):
    rs = np.random.RandomState(2)
    n_side = N if side == "H" else M
    adj = (rs.rand(n_side, n_side) < 0.1).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0.0)
    lap = (np.diag(adj.sum(1)) - adj).astype(np.float32)
    target = rs.uniform(size=(K, n_side)).astype(np.float32)
    kw = {f"graph_{side}": lap, f"target_{side}": target,
          "graph_lambda": (0.05, 0.0) if side == "W" else (0.0, 0.05),
          "target_lambda": 0.2}
    for solver in ("cholesky", "cd"):
        port, ref = _both(data, solver=solver, **kw, **CV)
        _assert_same_fit(port, ref, iterations=8)


@pytest.mark.parametrize("solver", ["cholesky", "cd"])
def test_masked_fit_matches_reference(solver, data, user_mask):
    kw = dict(mask=user_mask, seed=1, maxit=8, tol=0, solver=solver)
    port, ref = _both(data, **kw)
    _assert_same_fit(port, ref, iterations=8)
    assert port.best_iter == 0 and port.misc["host_syncs"] == 0
    # the masked entries are reported as the held-out set
    rec = (port.W * port.d) @ port.H
    np.testing.assert_allclose(port.test_loss,
                               ((data - rec)[user_mask] ** 2).mean(),
                               rtol=1e-4)
    np.testing.assert_allclose(port.train_loss,
                               ((data - rec)[~user_mask] ** 2).mean(),
                               rtol=1e-4)
    # a sparse mask and a tensor mask are the same mask
    for form in (sp.csr_matrix(user_mask), torch.from_numpy(user_mask)):
        again = rtt.nmf(data, K, device="cpu", **{**kw, "mask": form})
        np.testing.assert_array_equal(again.W, port.W)


def test_masked_entries_do_not_move_the_factors(data, user_mask):
    moved = np.where(user_mask, data + 7.0, data).astype(np.float32)
    kw = dict(mask=user_mask, seed=1, maxit=5, tol=0, device="cpu")
    a, b = rtt.nmf(data, K, **kw), rtt.nmf(moved, K, **kw)
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.test_loss_history, b.test_loss_history)


def test_held_out_entries_do_not_move_the_factors(data):
    cfg = rtt.build_config(K, **CV)
    held = nmf_cv.build_speckled_mask(cfg, data)
    assert 0.05 < held.mean() < 0.15
    moved = np.where(held, data + 7.0, data).astype(np.float32)
    a = rtt.nmf(data, K, device="cpu", **CV)
    b = rtt.nmf(moved, K, device="cpu", **CV)
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.test_loss_history, b.test_loss_history)


def test_user_mask_with_cv_matches_reference(data, user_mask):
    """User-masked entries leave both the train and the test set."""
    port, ref = _both(data, mask=user_mask, **CV)
    _assert_same_fit(port, ref, iterations=8)
    moved = np.where(user_mask, data + 7.0, data).astype(np.float32)
    other = rtt.nmf(moved, K, mask=user_mask, device="cpu", **CV)
    np.testing.assert_array_equal(other.test_loss_history,
                                  port.test_loss_history)
    np.testing.assert_array_equal(other.W, port.W)


@pytest.mark.parametrize("form", ["mask_zeros_string", "sparse_true",
                                  "mask_zeros_flag", "sparse_matrix_input"])
def test_mask_zeros_matches_reference(form, holey):
    kw = {"mask_zeros_string": dict(mask="zeros"),
          "sparse_true": dict(sparse=True),
          "mask_zeros_flag": dict(mask_zeros=True),
          "sparse_matrix_input": dict(mask="zeros")}[form]
    A = sp.csc_matrix(holey) if form == "sparse_matrix_input" else holey
    port, ref = _both(A, seed=1, maxit=8, tol=0, **kw)
    _assert_same_fit(port, ref, iterations=8)
    assert port.misc["config"].has_mask and port.misc["config"].mask_zeros
    # the fit is that of the explicit zero mask
    explicit = rtt.nmf(holey, K, mask=holey == 0, seed=1, maxit=8, tol=0,
                       device="cpu")
    np.testing.assert_array_equal(explicit.W, port.W)


@pytest.mark.parametrize("solver", ["cholesky", "cd"])
def test_mask_zeros_under_cv_matches_reference(solver, holey):
    """Under CV the flag restricts the holdout to nonzeros; an MSE fit keeps
    the zeros in its train set."""
    port, ref = _both(holey, mask_zeros=True, solver=solver, **CV)
    _assert_same_fit(port, ref, iterations=8)
    plain = rtt.nmf(holey, K, device="cpu", solver=solver, **CV)
    assert not np.array_equal(plain.test_loss_history, port.test_loss_history)


def test_nan_entries_are_masked_with_a_warning(data):
    A = data.copy()
    A[3, 4] = A[10, 2] = A[50, 50] = np.nan
    kw = dict(seed=1, maxit=6, tol=0)
    with pytest.warns(UserWarning, match="Detected 3 NA values"):
        port = rtt.nmf(A, K, device="cpu", **kw)
    with pytest.warns(UserWarning, match="Detected 3 NA values"):
        ref = rt.nmf(A, K, **kw)
    _assert_same_fit(port, ref, iterations=6)
    assert np.isfinite(port.W).all() and np.isfinite(port.loss_history).all()
    # mask="NA" and a mask that covers the NaN entries say the same, silently
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        by_name = rtt.nmf(A, K, mask="NA", device="cpu", **kw)
        by_mask = rtt.nmf(A, K, mask=np.isnan(A), device="cpu", **kw)
    np.testing.assert_array_equal(by_name.W, port.W)
    np.testing.assert_array_equal(by_mask.W, port.W)
    # under CV and in a multi-restart too
    with pytest.warns(UserWarning, match="NA values"):
        port_cv, ref_cv_fit = _both(A, **CV)
    _assert_same_fit(port_cv, ref_cv_fit, iterations=8)
    with pytest.warns(UserWarning, match="NA values"):
        multi = rtt.nmf(A, K, seed=[1, 2], maxit=6, tol=0, device="cpu")
    assert len(multi.misc["all_inits"]) == 2
    assert min(r["loss"] for r in multi.misc["all_inits"]) <= port.train_loss


def test_mask_errors():
    A = np.ones((6, 5), np.float32)
    A[1, 1] = np.nan
    with pytest.raises(ValueError, match="outside the supplied mask"):
        rtt.nmf(A, 2, mask=np.zeros((6, 5), bool), device="cpu")
    with pytest.raises(ValueError, match="use 'zeros', 'NA'"):
        rtt.nmf(np.ones((6, 5), np.float32), 2, mask="holes", device="cpu")
    with pytest.raises(ValueError, match="requires a host array"):
        rtt.nmf(torch.ones((6, 5)), 2, mask="NA")
    with pytest.raises(ValueError, match="mask has shape"):
        rtt.nmf(np.ones((6, 5), np.float32), 2, mask=np.zeros((5, 6), bool),
                device="cpu")
    with pytest.raises(ValueError, match="use an int"):
        rtt.nmf(np.ones((6, 5), np.float32), "best", device="cpu")
    # mesh= raised until queue 1 item 14a was ported: a (1, 1) mesh now
    # fits as the JAX package's does, and device= must be the rank's
    A = simulate_nmf(30, 20, 2, noise=0.05, seed=0)["A"]
    kw = dict(test_fraction=0.2, cv_seed=3, maxit=4, tol=0, seed=1,
              sort_model=False)
    one = rtt.default_mesh(devices=["cpu"], shape=(1, 1))
    port = nmf_cv.fit_cv_or_masked(A, rtt.build_config(2, **kw), mesh=one,
                                   device="cpu")
    import jax
    from rcppml_tpu.parallel.mesh import default_mesh as ref_mesh
    ref = ref_cv.fit_cv_or_masked(A, rt.build_config(2, **kw),
                                  mesh=ref_mesh(jax.devices()[:1], (1, 1)))
    np.testing.assert_allclose(port.test_loss_history, ref.test_loss_history,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="disagrees"):
        nmf_cv.fit_cv_or_masked(A, rtt.build_config(2, **kw), mesh=one,
                                device="cuda")
    # a callback is taken and never called here, as in the JAX package
    # (it raised until queue 1 item 6 was ported)
    calls = []
    rtt.nmf(np.ones((6, 5), np.float32), 2, test_fraction=0.2, maxit=2,
            on_iteration=lambda *a: calls.append(a), device="cpu")
    assert calls == []
    with pytest.raises(ValueError, match="bf16_data"):
        rtt.nmf(np.ones((6, 5), np.float32), 2, test_fraction=0.2,
                bf16_data=True, device="cpu")


def test_multi_restart_with_a_mask(data, user_mask):
    kw = dict(mask=user_mask, maxit=5, tol=0)
    port = rtt.nmf(data, K, seed=[1, 2, 3], device="cpu", **kw)
    ref = rt.nmf(data, K, seed=[1, 2, 3], **kw)
    assert [r["selected"] for r in port.misc["all_inits"]] == \
        [r["selected"] for r in ref.misc["all_inits"]]
    for p, r in zip(port.misc["all_inits"], ref.misc["all_inits"]):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=LOSS_RTOL)
    _assert_same_fit(port, ref)


# ---------------------------------------------------------------------------
# Early stopping
# ---------------------------------------------------------------------------

def test_cv_stops_on_patience(data):
    """Overfitting a rank far above the planted one: the test loss stops
    improving and ``cv_patience`` ends the fit."""
    kw = dict(test_fraction=0.2, cv_seed=1, seed=2, maxit=60, tol=0,
              cv_patience=3, solver="cd")
    port, ref = _both(data, k=12, **kw)
    assert port.converged and port.iterations < 60
    assert port.iterations == port.best_iter + 1 + 3
    _assert_same_fit(port, ref, factor_tol=1e-2)
    assert port.misc["best_test_loss"] == port.test_loss_history.min()
    assert port.misc["host_syncs"] == port.iterations


def test_cv_stops_on_tol(data):
    kw = dict(test_fraction=0.1, cv_seed=1, seed=2, maxit=200, tol=1e-3,
              cv_patience=1000)
    port, ref = _both(data, **kw)
    assert port.converged and ref.converged and port.iterations < 200
    assert abs(port.iterations - ref.iterations) <= 1
    assert port.final_tol < 1e-3
    n = min(port.iterations, ref.iterations)
    np.testing.assert_allclose(port.test_loss_history[:n],
                               ref.test_loss_history[:n], rtol=1e-3)


def test_masked_fit_stops_on_tol(data, user_mask):
    kw = dict(mask=user_mask, seed=2, maxit=200, tol=1e-3)
    port, ref = _both(data, **kw)
    assert port.converged and ref.converged and port.iterations < 200
    assert abs(port.iterations - ref.iterations) <= 1
    assert port.misc["host_syncs"] == port.iterations


# ---------------------------------------------------------------------------
# IRLS losses under CV and masks
# ---------------------------------------------------------------------------

IRLS_CV = dict(test_fraction=0.15, cv_seed=2, seed=1, maxit=3, tol=0,
               cv_patience=100)

IRLS_FITS = {
    "kl": dict(loss="kl"),
    "gp": dict(loss="gp"),
    "nb": dict(loss="nb"),
    "nb_per_col": dict(loss="nb", dispersion="per_col"),
    "nb_zi_row": dict(loss="nb", zi="row"),
    "gp_zi_col": dict(loss="gp", zi="col"),
    "gamma": dict(loss="gamma"),
    "gamma_global": dict(loss="gamma", dispersion="global"),
    "tweedie": dict(loss="tweedie", tweedie_power=1.5),
    "robust_mse": dict(loss="mse", robust=True),
    "kl_L1_L2": dict(loss="kl", L1=(0.02, 0.05), L2=(0.1, 0.05)),
    "kl_mask_zeros": dict(loss="kl", mask_zeros=True),
    "nb_none": dict(loss="nb", dispersion="none"),
}
POSITIVE_DATA = ("gamma", "gamma_global", "tweedie")


@pytest.mark.parametrize("case", list(IRLS_FITS))
def test_cv_irls_fit_matches_reference(case, counts):
    A = counts + 0.5 if case in POSITIVE_DATA else counts
    port, ref = _both(A.astype(np.float32), **IRLS_FITS[case], **IRLS_CV)
    _assert_same_fit(port, ref, factor_tol=IRLS_FACTOR_TOL, iterations=3)
    assert port.misc["irls_inner_iterations"] >= 2 * 3
    assert np.isfinite(port.test_loss_history).all()


@pytest.mark.parametrize("kw", [dict(loss="kl"), dict(loss="nb", zi="row")],
                         ids=["kl", "nb_zi_row"])
def test_masked_irls_fit_matches_reference(kw, counts, user_mask):
    port, ref = _both(counts, mask=user_mask, seed=1, maxit=3, tol=0, **kw)
    _assert_same_fit(port, ref, factor_tol=IRLS_FACTOR_TOL, iterations=3)


def test_cv_kl_fit_of_a_sparse_input(counts):
    """A scipy-sparse input: the zeros get unit weight in the solves and
    leave the train loss."""
    A = sp.csr_matrix(counts)
    port, ref = _both(A, loss="kl", **IRLS_CV)
    _assert_same_fit(port, ref, factor_tol=IRLS_FACTOR_TOL, iterations=3)
    dense = rtt.nmf(counts, K, loss="kl", device="cpu", **IRLS_CV)
    assert not np.allclose(dense.loss_history, port.loss_history)


# ---------------------------------------------------------------------------
# One iteration of both loops from the same state; the downdate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(solver="cd"), dict(loss="nb")],
                         ids=["cholesky", "cd", "nb"])
def test_one_iteration_from_the_same_state(kw, data, counts):
    A = counts if "loss" in kw else data
    ref_cfg = rt.build_config(K, test_fraction=0.1, cv_seed=4, maxit=1,
                              tol=0, sort_model=False, **kw)
    rs = np.random.RandomState(6)
    W_T = rs.uniform(size=(K, M)).astype(np.float32)
    H = rs.uniform(size=(K, N)).astype(np.float32)
    d = np.ones(K, np.float32)
    disp_row, disp_col = ref_irls._init_dispersion(ref_cfg, M, N, np.float32)
    ref = ref_cv._fit_masked_jit(
        ref_cfg.device_static(), jnp.asarray(A), {}, {}, jnp.asarray(W_T),
        jnp.asarray(H), jnp.asarray(d), jnp.asarray(disp_row),
        jnp.asarray(disp_col),
        jnp.asarray(ref_nmf.rng_mod.seed_to_u32_pair(4)), False, True)
    cfg = convert.config_from_reference(ref_cfg)
    A_t = torch.from_numpy(A)
    state = convert.cv_state_from_numpy(
        W_T, H, d, disp_row=disp_row, disp_col=disp_col,
        pi_row=np.zeros(M), pi_col=np.zeros(N), device="cpu", max_iter=1)
    weights = nmf_cv.build_weights(cfg, A_t, {}, False, True)
    out = nmf_cv.run_masked(cfg, A_t, weights, {}, state, False, True)
    assert out.it == int(ref.it) == 1
    tol = IRLS_FACTOR_TOL if "loss" in kw else 1e-5
    for name in ("W_T", "H", "d", "disp_row"):
        p, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert np.abs(p - r).max() <= tol * max(np.abs(r).max(), 1e-30), name
    np.testing.assert_allclose(out.train_hist.numpy(),
                               np.asarray(ref.train_hist), rtol=LOSS_RTOL)
    np.testing.assert_allclose(out.test_hist.numpy(),
                               np.asarray(ref.test_hist), rtol=LOSS_RTOL)
    assert int(out.best_iter) == int(ref.best_iter) == 0
    # and the state carries on: a second iteration from the first's state
    cfg2 = cfg.replace(max_iter=2)
    mid = convert.cv_state_from_numpy(
        out.W_T.numpy(), out.H.numpy(), out.d.numpy(),
        disp_row=out.disp_row.numpy(), disp_col=out.disp_col.numpy(),
        pi_row=np.zeros(M), pi_col=np.zeros(N), device="cpu", max_iter=2,
        it=1, prev_conv_loss=float(out.prev_conv_loss),
        train_hist=out.train_hist.numpy(), test_hist=out.test_hist.numpy(),
        best_test_loss=float(out.best_test_loss), best_iter=0,
        patience_ctr=int(out.patience_ctr))
    two = nmf_cv.run_masked(cfg2, A_t, weights, {}, mid, False, True)
    whole = nmf_cv.run_masked(
        cfg2, A_t, weights, {}, convert.cv_state_from_numpy(
            W_T, H, d, disp_row=disp_row, disp_col=disp_col,
            pi_row=np.zeros(M), pi_col=np.zeros(N), device="cpu", max_iter=2),
        False, True)
    assert two.it == whole.it == 2
    assert torch.equal(two.W_T, whole.W_T)
    assert torch.equal(two.test_hist, whole.test_hist)


@pytest.mark.parametrize("kw", [dict(), dict(solver="cd"),
                                dict(L1=(0.02, 0.02), L2=(0.1, 0.1))],
                         ids=["cholesky", "cd", "L1_L2"])
def test_downdate_path_matches_reference_and_the_weighted_path(kw):
    # large enough for the excluded rows of a column to stay under half of
    # the dimension, which is what switches the downdate on
    M, N = 200, 150
    data = simulate_nmf(M, N, K, noise=0.3, seed=8)["A"]
    user_mask = np.random.RandomState(11).rand(M, N) < 0.05
    ref_cfg = rt.build_config(K, **{**CV, **kw})
    cfg = convert.config_from_reference(ref_cfg)
    ref = ref_cv.fit_cv_or_masked(data, ref_cfg, mask=user_mask,
                                  use_downdate=True)
    port = nmf_cv.fit_cv_or_masked(data, cfg, mask=user_mask,
                                   use_downdate=True, device="cpu")
    _assert_same_fit(port, ref, iterations=8)
    weighted = nmf_cv.fit_cv_or_masked(data, cfg, mask=user_mask,
                                       device="cpu")
    np.testing.assert_allclose(port.loss_history, weighted.loss_history,
                               rtol=LOSS_RTOL)
    assert np.abs(port.W - weighted.W).max() <= MSE_FACTOR_TOL * np.abs(
        weighted.W).max()
    # the bound on excluded rows: an 8-sigma tail plus the mask's own counts
    t_h, t_w = nmf_cv._downdate_bounds(cfg, M, N, torch.from_numpy(user_mask),
                                       True)
    assert nmf_cv._downdate_bounds(cfg, 40, 30, None, True) is None
    held = nmf_cv.build_speckled_mask(cfg, data) | user_mask
    assert held.sum(0).max() <= t_h <= M // 2
    assert held.sum(1).max() <= t_w <= N // 2
    # a dense holdout switches the downdate off
    assert nmf_cv._downdate_bounds(cfg.replace(test_fraction=0.5), M, N, None,
                                   True) is None


# ---------------------------------------------------------------------------
# The sweep and the rank search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    return simulate_nmf(150, 100, 3, noise=0.4, seed=5)["A"]


def _assert_rows_close(rows, ref_rows):
    assert [(r["k"], r["rep"]) for r in rows] == \
        [(r["k"], r["rep"]) for r in ref_rows]
    for p, r in zip(rows, ref_rows):
        assert sorted(p) == sorted(r)
        assert p["best_iter"] == r["best_iter"]
        assert p["iterations"] == r["iterations"]
        for key in ("train_mse", "test_mse", "best_test_loss"):
            np.testing.assert_allclose(p[key], r[key], rtol=LOSS_RTOL)
        assert np.isnan(p["mean_theta"]) == np.isnan(r["mean_theta"])


@pytest.mark.parametrize("kw", [
    dict(cv_seed=[1, 2]), dict(cv_seed=3, solver="cd"),
    dict(cv_seed=[1], seed=7, test_fraction=0.2),
    dict(cv_seed=2, loss="kl", maxit=3)],
    ids=["two_reps", "cd", "user_seed", "kl"])
def test_cv_sweep_matches_reference(kw, planted):
    kw = {"maxit": 10, "tol": 0, **kw}
    A = np.round(planted * 4) if kw.get("loss") else planted
    rows = rtt.nmf(A, [2, 3, 6], device="cpu", **kw)
    ref_rows = rt.nmf(A, [2, 3, 6], **kw)
    _assert_rows_close(rows, ref_rows)
    if "loss" not in kw:
        by_k = {k: np.mean([r["test_mse"] for r in rows if r["k"] == k])
                for k in (2, 3, 6)}
        assert by_k[3] < by_k[2]
    else:
        assert all(np.isnan(r["mean_theta"]) for r in rows)   # KL: no theta


def test_cv_sweep_with_a_mask(planted):
    mask = np.random.RandomState(0).rand(*planted.shape) < 0.05
    kw = dict(cv_seed=1, maxit=6, tol=0, mask=mask)
    _assert_rows_close(rtt.nmf(planted, [2, 4], device="cpu", **kw),
                       rt.nmf(planted, [2, 4], **kw))


@pytest.mark.parametrize("criterion", ["train", "test"])
@pytest.mark.parametrize("refit", [True, False])
def test_find_optimal_rank_matches_reference(criterion, refit, planted):
    kw = dict(k_init=2, max_k=12, cv_seed=1, seed=3, maxit=12,
              criterion=criterion, refit=refit)
    port = rank_cv.find_optimal_rank(planted, device="cpu", **kw)
    ref = ref_rank.find_optimal_rank(planted, **kw)
    search, ref_search = (port, ref) if not refit else (
        port.misc["rank_search"], ref.misc["rank_search"])
    for key in ("k_optimal", "overfitting_detected", "k_low", "k_high"):
        assert search[key] == ref_search[key], key
    assert [e["rank"] for e in search["evaluations"]] == \
        [e["rank"] for e in ref_search["evaluations"]]
    for p, r in zip(search["evaluations"], ref_search["evaluations"]):
        assert p["best_iter"] == r["best_iter"]
        for key in ("train", "test", "best_test"):
            np.testing.assert_allclose(p[key], r[key], rtol=LOSS_RTOL)
    if criterion == "test":
        assert abs(search["k_optimal"] - 3) <= 1
    if refit:
        assert port.k == ref.k == search["k_optimal"]
        np.testing.assert_allclose(port.loss_history, ref.loss_history,
                                   rtol=1e-3)
        assert np.isnan(port.test_loss)          # the refit has no holdout


def test_auto_rank_through_nmf(planted):
    kw = dict(cv_k_range=(2, 10), criterion="test", maxit=10, seed=1)
    port = rtt.nmf(planted, "auto", device="cpu", **kw)
    ref = rt.nmf(planted, "auto", **kw)
    assert port.k == ref.k == port.misc["rank_search"]["k_optimal"]
    assert port.misc["rank_search"]["evaluations"][0]["rank"] == 2
    mask = np.random.RandomState(0).rand(*planted.shape) < 0.05
    masked = rtt.nmf(planted, "auto", mask=mask, device="cpu", **kw)
    ref_masked = rt.nmf(planted, "auto", mask=mask, **kw)
    assert masked.k == ref_masked.k
    assert masked.test_loss_history is not None   # the refit is a masked fit
    with pytest.raises(ValueError, match="criterion"):
        rtt.nmf(planted, "auto", criterion="aic", device="cpu")


def test_result_to_numpy_carries_the_cv_fields(data):
    port, ref = _both(data, loss="nb", zi="row", **{**IRLS_CV, "maxit": 2})
    a, b = convert.result_to_numpy(port), convert.result_to_numpy(ref)
    assert sorted(a) == sorted(b)
    for key in ("test_loss_history", "pi_row", "theta"):
        assert a[key] is not None and a[key].shape == b[key].shape
    assert a["best_iter"] == b["best_iter"]
    np.testing.assert_allclose(a["best_test_loss"], b["best_test_loss"],
                               rtol=LOSS_RTOL)
    plain = convert.result_to_numpy(rtt.nmf(data, K, maxit=2, device="cpu"))
    assert plain["test_loss_history"] is None and plain["best_iter"] == -1
    assert plain["best_test_loss"] is None and np.isnan(plain["test_loss"])


def test_config_from_reference_copies_the_cv_fields():
    ref = rt.build_config(3, test_fraction=0.25, cv_seed=9, mask_zeros=True,
                          cv_patience=7, cv_row_subsample=0.5,
                          cv_col_subsample=0.75, has_mask=True)
    cfg = convert.config_from_reference(ref)
    assert (cfg.test_fraction, cfg.cv_seed, cfg.mask_zeros, cfg.cv_patience,
            cfg.cv_row_subsample, cfg.cv_col_subsample, cfg.has_mask) == \
        (0.25, 9, True, 7, 0.5, 0.75, True)
    assert cfg.is_cv()
    assert cfg == rtt.build_config(
        3, test_fraction=0.25, cv_seed=9, mask_zeros=True, cv_patience=7,
        cv_row_subsample=0.5, cv_col_subsample=0.75, has_mask=True)
