"""The port's IRLS fit against the JAX package's, on the CPU.

Both packages get the same seeded count matrix and the same seed, and run
3-4 ALS iterations of up to 5 inner IRLS iterations each.  Off the TPU the JAX
package runs its lax CD loop and its float32 weighted Gram, which the port's
twins mirror.  Held here, a little above the largest difference these cases
show: loss history within rtol 2e-4, W/d/H and the reconstruction
W diag(d) H within 1e-4 of their largest entry (1e-3 for ``mae``, after two
iterations: see there), theta / dispersion / pi within rtol 5e-3
(1.9e-3 seen: the NB size is a ratio of moments whose denominator nearly
cancels).  The inner loop's ``rel >= irls_tol`` test can flip a column's
freeze on a last-bit difference, so these bars are looser than what the MSE
fit is held to.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rcppml_tpu as rt
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.models import nmf_irls as ref_irls

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.models import nmf as port_nmf
from rcppml_tpu_torch.models import nmf_irls
from rcppml_tpu_torch.ops import cd_nnls_batched, wgram
from rcppml_tpu_torch.utils.simulate import simulate_nmf

K = 4
M, N = 60, 40
LOSS_RTOL = 2e-4
FACTOR_TOL = 1e-4
EXTRA_RTOL = 5e-3


@pytest.fixture(scope="module")
def counts():
    """Poisson counts around the W H of sparse factors, about half zeros."""
    mean = simulate_nmf(M, N, K, noise=0.0, dropout=0.0, seed=3)["A"]
    rs = np.random.RandomState(4)
    return rs.poisson(5.0904767709068 * mean.astype(np.float64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def positive(counts):
    rs = np.random.RandomState(0)
    return (counts + rs.uniform(0.2, 1.0, counts.shape)).astype(np.float32)


def _reconstruction(res):
    W, d, H = (np.asarray(getattr(res, name), np.float64) for name in "WdH")
    return (W * d) @ H


def _assert_same_fit(port, ref, maxit, factor_tol=FACTOR_TOL):
    assert port.iterations == ref.iterations == maxit
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)
    for name in ("W", "d", "H"):
        p = np.asarray(getattr(port, name), np.float64)
        r = np.asarray(getattr(ref, name), np.float64)
        assert np.abs(p - r).max() <= factor_tol * np.abs(r).max(), name
    p, r = _reconstruction(port), _reconstruction(ref)
    assert np.abs(p - r).max() <= factor_tol * np.abs(r).max()
    for name in ("theta", "dispersion", "pi_row", "pi_col"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if r is not None:
            np.testing.assert_allclose(p, np.asarray(r), rtol=EXTRA_RTOL,
                                       err_msg=name)


FITS = {
    "kl": dict(loss="kl"),
    "gp": dict(loss="gp"),
    "nb": dict(loss="nb"),
    "gamma": dict(loss="gamma"),
    "inverse_gaussian": dict(loss="inverse_gaussian"),
    "tweedie": dict(loss="tweedie", tweedie_power=1.5),
    "robust_mse": dict(loss="mse", robust=True),
    "huber": dict(loss="huber"),
    "mae": dict(loss="mae"),
    "robust_kl": dict(loss="kl", robust=2.0),
    "gp_zi_row": dict(loss="gp", zi="row"),
    "gp_zi_col": dict(loss="gp", zi="col"),
    "nb_zi_row": dict(loss="nb", zi="row"),
    "nb_zi_col": dict(loss="nb", zi="col", zi_em_iters=2),
    "nb_per_col": dict(loss="nb", dispersion="per_col"),
    "nb_zi_row_per_col": dict(loss="nb", zi="row", dispersion="per_col"),
    "gp_per_col": dict(loss="gp", dispersion="per_col"),
    "gp_global": dict(loss="gp", dispersion="global"),
    "nb_global": dict(loss="nb", dispersion="global"),
    "gamma_global": dict(loss="gamma", dispersion="global"),
    "gamma_per_col": dict(loss="gamma", dispersion="per_col"),
    "gp_none": dict(loss="gp", dispersion="none"),
    "nb_none": dict(loss="nb", dispersion="none"),
    "kl_L1_L2": dict(loss="kl", L1=(0.02, 0.05), L2=(0.1, 0.05)),
    "kl_L21_upper": dict(loss="kl", L21=0.05, upper_bound=(0.0, 0.4)),
    "kl_norm_L2": dict(loss="kl", norm="L2"),
}
POSITIVE_DATA = ("gamma", "inverse_gaussian", "tweedie", "gamma_global",
                 "gamma_per_col")


@pytest.mark.parametrize("case", list(FITS))
def test_irls_fit_matches_reference(case, counts, positive):
    kw = FITS[case]
    A = positive if case in POSITIVE_DATA else counts
    # "mae" is Huber with delta = 1e-4: nearly every weight is delta / |r|,
    # an L1 fit in which a last-bit difference grows about a hundredfold per
    # iteration (W off by 7.8e-5 of its largest entry after one iteration,
    # 4.5e-4 after two, 4.1e-2 after three), so it is held after two
    maxit = 2 if case == "mae" else 3
    ref = rt.nmf(A, K, seed=1, maxit=maxit, tol=0, **kw)
    port = rtt.nmf(A, K, seed=1, maxit=maxit, tol=0, device="cpu", **kw)
    _assert_same_fit(port, ref, maxit,
                     factor_tol=1e-3 if case == "mae" else FACTOR_TOL)
    assert port.misc["irls_inner_iterations"] >= 2 * maxit
    if kw.get("dispersion") == "none":
        assert port.theta is None and port.dispersion is None


def test_sparse_input_gives_zeros_unit_weight(counts):
    """A scipy-sparse input: unit weight at zeros in the solves, loss over
    the nonzeros; a dense input of the same numbers fits differently."""
    A = sp.csr_matrix(counts)
    ref = rt.nmf(A, K, seed=1, maxit=3, tol=0, loss="kl")
    port = rtt.nmf(A, K, seed=1, maxit=3, tol=0, loss="kl", device="cpu")
    _assert_same_fit(port, ref, 3)
    dense = rtt.nmf(counts, K, seed=1, maxit=3, tol=0, loss="kl",
                    device="cpu")
    assert port.loss_history[-1] < 0.9 * dense.loss_history[-1]


def test_graph_and_target_match_reference(counts):
    rs = np.random.RandomState(2)
    adj = (rs.uniform(size=(N, N)) < 0.1).astype(np.float32)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    lap = (np.diag(adj.sum(1)) - adj).astype(np.float32)
    target = rs.uniform(0, 0.05, size=(K, N)).astype(np.float32)
    kw = dict(loss="kl", graph_H=lap, graph_lambda=(0.0, 0.1),
              target_H=target, target_lambda=0.3)
    ref = rt.nmf(counts, K, seed=1, maxit=3, tol=0, **kw)
    port = rtt.nmf(counts, K, seed=1, maxit=3, tol=0, device="cpu", **kw)
    _assert_same_fit(port, ref, 3)


def test_irls_fit_converges_with_tol_like_reference(counts):
    ref = rt.nmf(counts, K, seed=2, maxit=60, tol=1e-2, loss="kl")
    port = rtt.nmf(counts, K, seed=2, maxit=60, tol=1e-2, loss="kl",
                   device="cpu")
    assert ref.converged and port.converged
    assert abs(port.iterations - ref.iterations) <= 1
    assert port.final_tol < 1e-2
    # one host read per ALS iteration on top of the inner loops'
    assert port.misc["host_syncs"] >= port.iterations


def test_tensor_input_and_w_init(counts):
    W0 = np.random.RandomState(5).uniform(size=(M, K)).astype(np.float32)
    ref = rt.nmf(counts, K, maxit=2, tol=0, loss="nb", w_init=W0)
    port = rtt.nmf(torch.from_numpy(counts), K, maxit=2, tol=0, loss="nb",
                   w_init=W0)                    # a CPU tensor stays there
    _assert_same_fit(port, ref, 2)


def test_one_more_iteration_from_the_reference_state(counts):
    """Both packages carry on from the JAX package's state after three
    iterations of an NB + ZI fit: factors, dispersion, dropout, imputed
    matrix.  The next iteration agrees to rtol 1e-4."""
    ref_cfg = rt.build_config(K, seed=1, maxit=3, tol=0, loss="nb",
                              zi="row")
    A = jnp.asarray(counts)
    W_T0, H0, d0 = ref_nmf.init_factors(ref_cfg, M, N)
    mid = ref_irls._fit_irls_jit(
        ref_cfg.device_static(), A, {},
        ref_irls._init_irls_state(A, ref_cfg, W_T0, H0, d0), False)
    assert int(mid.it) == 3

    one = ref_cfg.replace(max_iter=4)     # a fourth, warm-started iteration
    start = mid._replace(loss_hist=jnp.concatenate(
        [mid.loss_hist, jnp.full((1,), jnp.nan, jnp.float32)]))
    nxt_ref = ref_irls._fit_irls_jit(one.device_static(), A, {}, start, False)
    assert int(nxt_ref.it) == 4

    state = convert.irls_state_from_numpy(
        np.asarray(mid.W_T), np.asarray(mid.H), np.asarray(mid.d),
        disp_row=np.asarray(mid.disp_row), disp_col=np.asarray(mid.disp_col),
        pi_row=np.asarray(mid.pi_row), pi_col=np.asarray(mid.pi_col),
        A_imp=np.asarray(mid.A_imp), device="cpu", max_iter=4, it=3)
    nxt = nmf_irls.run_irls(convert.config_from_reference(one),
                            torch.from_numpy(counts), {}, state, False)
    assert nxt.it == 4
    for name in ("W_T", "H", "d", "disp_row", "pi_row", "A_imp"):
        np.testing.assert_allclose(
            getattr(nxt, name).numpy(), np.asarray(getattr(nxt_ref, name)),
            rtol=1e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(nxt.loss_hist[3]),
                               float(nxt_ref.loss_hist[3]), rtol=1e-4)


@pytest.mark.parametrize("case", ["kl", "gamma", "nb", "nb_per_col",
                                  "kl_sparse"])
def test_fused_wgram_on_cpu_is_the_default_path_bitwise(case, counts,
                                                        positive,
                                                        monkeypatch):
    """With RCPPML_FUSED_WGRAM set, a CPU fit goes through the fused
    wrapper's plain twin, which is the default path's own arithmetic."""
    kw = dict(FITS.get(case, dict(loss="kl")))
    A = positive if case == "gamma" else counts
    if case == "kl_sparse":
        A = sp.csr_matrix(counts)
    monkeypatch.delenv("RCPPML_FUSED_WGRAM", raising=False)
    default = rtt.nmf(A, K, seed=1, maxit=2, tol=0, device="cpu", **kw)
    calls = []
    real = wgram.weighted_gram_rhs
    monkeypatch.setattr(nmf_irls, "weighted_gram_rhs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    fused = rtt.nmf(A, K, seed=1, maxit=2, tol=0, device="cpu", **kw)
    assert len(calls) == fused.misc["irls_inner_iterations"] > 0
    np.testing.assert_array_equal(fused.loss_history, default.loss_history)
    for name in ("W", "d", "H"):
        np.testing.assert_array_equal(getattr(fused, name),
                                      getattr(default, name))


@pytest.mark.parametrize("kw", [dict(loss="gp"), dict(loss="kl", robust=True),
                                dict(loss="mse", robust=True)],
                         ids=["gp_weights_are_kl", "robust_kl", "robust_mse"])
def test_fused_wgram_opt_in_conditions(kw, counts, monkeypatch):
    """GP solves with KL weights, so it takes the fused call; a robust fit
    never does."""
    calls = []
    real = wgram.weighted_gram_rhs
    monkeypatch.setattr(nmf_irls, "weighted_gram_rhs",
                        lambda *a, **k: calls.append(k["loss_kind"])
                        or real(*a, **k))
    monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    rtt.nmf(counts, K, seed=1, maxit=1, tol=0, device="cpu", **kw)
    if kw.get("robust"):
        assert calls == []
    else:
        assert calls and set(calls) == {"kl"}


def test_cpu_fit_counts_no_kernel_launch(counts, monkeypatch):
    monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    before = (cd_nnls_batched.cd_nnls_batched.launches,
              wgram.weighted_gram_rhs.launches)
    rtt.nmf(counts, K, seed=1, maxit=2, tol=0, loss="kl", device="cpu")
    assert before == (cd_nnls_batched.cd_nnls_batched.launches,
                      wgram.weighted_gram_rhs.launches)


def test_same_seed_same_factors(counts):
    a = rtt.nmf(counts, K, seed=4, maxit=3, tol=0, loss="nb", zi="row",
                device="cpu")
    b = rtt.nmf(counts, K, seed=4, maxit=3, tol=0, loss="nb", zi="row",
                device="cpu")
    for name in ("W", "d", "H", "theta", "pi_row"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_result_to_numpy_carries_the_irls_fields(counts):
    res = rtt.nmf(counts, K, seed=1, maxit=2, tol=0, loss="nb", zi="col",
                  device="cpu")
    out = convert.result_to_numpy(res)
    assert out["theta"].shape == (M,) and out["pi_col"].shape == (N,)
    assert out["dispersion"] is None and out["pi_row"] is None


# ---------------------------------------------------------------------------
# Default device, and the branches still left out
# ---------------------------------------------------------------------------

def test_host_array_without_a_card_raises(counts, monkeypatch):
    """``device=None`` sends a host array to the CUDA card; without one the
    fit raises and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for data in (counts, sp.csr_matrix(counts)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            rtt.nmf(data, K, maxit=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_nmf.nmf_fit(counts, rtt.build_config(K, maxit=1))
    # a CPU tensor keeps its own device, and device="cpu" is honoured
    assert rtt.nmf(torch.from_numpy(counts), K, maxit=1).iterations == 1
    assert rtt.nmf(counts, K, maxit=1, device="cpu").iterations == 1


def test_validation_errors_come_before_the_device(counts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError):
        rtt.nmf(counts, 200)                         # rank > min(m, n)
    with pytest.raises(ValueError):
        rtt.nmf(counts, K, symmetric=True)           # not square
    with pytest.raises(ValueError):
        rtt.nmf(counts, K, L1=1.5)
    with pytest.raises(ValueError):
        rtt.nmf(counts, K, loss="kl", solver="cholesky")
    bad = counts.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ValueError):
        rtt.nmf(bad, K)


IRLS_UNPORTED = {
    "profile": (dict(profile=True), "Queue 1 item 6"),
    "cv": (dict(test_fraction=0.1), None),
    "mask_zeros": (dict(mask="zeros"), None),
    "on_iteration": (dict(on_iteration=lambda *a: None), "Queue 1 item 6"),
}


@pytest.mark.parametrize("branch", list(IRLS_UNPORTED))
def test_unported_irls_branch_raises(branch, counts):
    """An IRLS branch that is not ported raises NotImplementedError naming
    its ROADMAP item.  Cross-validation and ``mask="zeros"`` did so until they
    were ported (item None); now they fit, with finite train and test losses
    of the asked length.  ``profile=True`` and ``on_iteration`` did so until
    queue 1 item 6 was ported: the profiled fit now has the JAX package's
    profile keys and the unprofiled fit's history bit for bit, and the
    callback is taken and never called, as in the JAX package."""
    kw, item = IRLS_UNPORTED[branch]
    if branch == "profile":
        common = dict(tol=0, maxit=4, loss="kl", device="cpu")
        res = rtt.nmf(counts, K, **common, **kw)
        plain = rtt.nmf(counts, K, **common)
        ref = rt.nmf(counts, K, tol=0, maxit=4, loss="kl", **kw)
        assert sorted(res.profile) == sorted(ref.profile)
        np.testing.assert_array_equal(res.loss_history, plain.loss_history)
        return
    if branch == "on_iteration":
        calls = []
        res = rtt.nmf(counts, K, tol=0, maxit=3, loss="kl", device="cpu",
                      on_iteration=lambda *a: calls.append(a))
        rt.nmf(counts, K, tol=0, maxit=3, loss="kl",
               on_iteration=lambda *a: calls.append(a))
        assert calls == [] and res.iterations == 3
        return
    if item is None:
        res = rtt.nmf(counts, K, tol=0, maxit=3, loss="kl", device="cpu",
                      cv_patience=4, **kw)
        assert res.iterations == 3
        assert np.isfinite(res.loss_history).all()
        assert res.test_loss_history.shape == (3,)
        assert np.isfinite(res.test_loss_history).all()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        rtt.nmf(counts, K, tol=0, loss="kl", device="cpu", **kw)


def test_valid_dims_is_not_ported(counts):
    """``valid_dims`` (A zero-padded beyond the true (m, n), the accounting
    on the valid region) raised until queue 1 item 14a was ported; now the
    fit is held to the JAX package's ``fit_irls(valid_dims=)`` on the same
    padded matrix and factors, NB with per-row dispersion and per-row zero
    inflation, and its pads stay exact zeros."""
    kw = dict(loss="nb", zi="row", maxit=3, tol=0, sort_model=False)
    cfg, ref_cfg = rtt.build_config(K, **kw), rt.build_config(K, **kw)
    W_T0, H0, d0 = port_nmf.init_factors(cfg, M, N)
    pm, pn = 3, 5
    A_p = np.pad(counts, ((0, pm), (0, pn)))
    W_p, H_p = np.pad(W_T0, ((0, 0), (0, pm))), np.pad(H0, ((0, 0), (0, pn)))
    port = nmf_irls.fit_irls(torch.from_numpy(A_p), cfg, W_p, H_p, d0, {},
                             valid_dims=(M, N))
    ref = ref_irls.fit_irls(jnp.asarray(A_p), ref_cfg, jnp.asarray(W_p),
                            jnp.asarray(H_p), jnp.asarray(d0), {},
                            valid_dims=(M, N))
    for res in (port, ref):
        res.theta, res.pi_row = res.theta[:M], res.pi_row[:M]
    assert not port.W[M:].any() and not port.H[:, N:].any()
    _assert_same_fit(port, ref, 3)
