"""The port's checkpointed fits (``nmf(..., checkpoint_path=)``,
``utils/checkpoint.py``), on the CPU.

* Within the port: a fit run in segments of ``every`` iterations, or stopped
  and resumed, equals the uninterrupted fit bit for bit (W, d, H, the loss
  history, theta and the ZI dropout), for MSE, KL and NB + ZI by row.
* Across packages (test side only): a file the JAX package wrote at
  iteration 5, resumed by the port to iteration 20, meets the parity bars of
  ``PERF.md`` §2 against the JAX package's uninterrupted fit (MSE: loss rtol
  1e-4 + 10 eps tr(A'A), W / d / H 2e-3 of the largest entry; IRLS: loss
  rtol 2e-4, factors 1e-4, theta and pi rtol 5e-3).  A file the port wrote
  loads with the JAX package's ``load_fit_state`` / ``load_irls_state`` /
  ``load_model`` into equal arrays, and the config JSON of both packages is
  the same for the same keywords.  A resume restores the layout of the
  loop's factors, which the file records where they were column-major.
"""

import json
import os

import numpy as np
import pytest
import torch

import rcppml_tpu as rt
from rcppml_tpu.utils import checkpoint as ref_ck

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch.utils import checkpoint as ck
from rcppml_tpu_torch.utils.simulate import simulate_nmf

K = 4
EPS32 = float(np.finfo(np.float32).eps)
FITS = {"mse": dict(), "kl": dict(loss="kl"),
        "nb_zi": dict(loss="nb", zi="row")}


@pytest.fixture(scope="module")
def data():
    return simulate_nmf(70, 50, K, seed=2)["A"]


@pytest.fixture(scope="module")
def counts(data):
    rs = np.random.RandomState(5)
    return rs.poisson(4.0 * data.astype(np.float64)).astype(np.float32)


def _matrix(fit, data, counts):
    return data if fit == "mse" else counts


def _fit(A, maxit, path=None, every=10, **kw):
    return rtt.nmf(A, K, maxit=maxit, tol=0, seed=1, device="cpu",
                   checkpoint_path=path, checkpoint_every=every, **kw)


def _bitwise(a, b):
    for name in ("W", "d", "H", "loss_history", "theta", "pi_row"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.iterations == b.iterations and a.converged == b.converged


@pytest.mark.parametrize("every", [1, 3, 5])
@pytest.mark.parametrize("fit", list(FITS))
def test_segmented_fit_is_the_uninterrupted_fit(fit, every, data, counts,
                                                tmp_path):
    A = _matrix(fit, data, counts)
    maxit = 7 if fit == "nb_zi" else 12
    path = str(tmp_path / "ck.npz")
    res = _fit(A, maxit, path, every, **FITS[fit])
    _bitwise(res, _fit(A, maxit, **FITS[fit]))
    with np.load(path) as z:
        assert int(z["scalars"][0]) == maxit
        assert ("A_imp" in z.files) == (fit == "nb_zi")
        assert tuple(z["mesh_shape"]) == (0, 0)


@pytest.mark.parametrize("fit", list(FITS))
def test_stop_and_resume_is_the_uninterrupted_fit(fit, data, counts,
                                                  tmp_path):
    """A fit stopped at maxit=10 and resumed at maxit=20: the whole maxit
    must not leak into the first run (its history is sized 10, then padded
    to 20 on resume)."""
    A = _matrix(fit, data, counts)
    path = str(tmp_path / "ck.npz")
    first = _fit(A, 10, path, 4, **FITS[fit])
    _bitwise(first, _fit(A, 10, **FITS[fit]))
    resumed = _fit(A, 20, path, 4, **FITS[fit])
    _bitwise(resumed, _fit(A, 20, **FITS[fit]))


def test_resume_restores_the_loops_layout(tmp_path):
    """On the CPU the Cholesky solve returns its solution column-major; at
    this size the layout of a product's operand changes its rounding, so
    the file names the column-major factors and a resume restores them (the
    JAX package reads the file all the same)."""
    A = np.abs(np.random.RandomState(0).rand(600, 800)).astype(np.float32)
    path = str(tmp_path / "ck.npz")
    kw = dict(tol=0, seed=1, device="cpu")
    rtt.nmf(A, 6, maxit=3, checkpoint_path=path, checkpoint_every=2, **kw)
    with np.load(path) as z:
        assert json.loads(str(z["layout"])) == ["W_T", "H"]
    resumed = rtt.nmf(A, 6, maxit=6, checkpoint_path=path,
                      checkpoint_every=2, **kw)
    _bitwise(resumed, rtt.nmf(A, 6, maxit=6, **kw))
    state = ref_ck.load_fit_state(path, rt.build_config(6, maxit=6, tol=0,
                                                         seed=1))
    assert int(state.it) == 6


def test_resume_with_tol_converges_where_the_fit_does(tmp_path):
    rs = np.random.RandomState(13)
    A = (np.abs(rs.rand(40, 3)) @ np.abs(rs.rand(3, 30))
         + 0.3 * rs.rand(40, 30)).astype(np.float32)
    path = str(tmp_path / "ck.npz")
    kw = dict(maxit=100, tol=5e-3, seed=4, device="cpu")
    res = rtt.nmf(A, 3, checkpoint_path=path, checkpoint_every=5, **kw)
    plain = rtt.nmf(A, 3, **kw)
    assert res.converged and res.iterations < 60
    _bitwise(res, plain)
    # a converged file resumes to the same result without iterating
    _bitwise(rtt.nmf(A, 3, checkpoint_path=path, checkpoint_every=7, **kw),
             plain)


@pytest.mark.parametrize("fit", ["mse", "kl"])
def test_maxit_may_shrink_down_to_the_iterations_run(fit, data, counts,
                                                     tmp_path):
    """A state at iteration 10 of a maxit=20 fit resumes at maxit=12 into
    the uninterrupted 12-iteration fit; maxit below 10 is refused."""
    from rcppml_tpu_torch.models import nmf as nmf_mod
    from rcppml_tpu_torch.models import nmf_irls
    A = _matrix(fit, data, counts)
    cfg20 = rtt.build_config(K, maxit=20, tol=0, seed=1, **FITS[fit])
    W_T0, H0, d0 = nmf_mod.init_factors(cfg20, *A.shape)
    A_t = torch.from_numpy(A)
    path = str(tmp_path / "ck.npz")
    if fit == "mse":
        state = nmf_mod.fit_mse(cfg20, A_t, nmf_mod.init_fit_state(
            cfg20, W_T0, H0, d0, device="cpu"), seg_end=10)
        ck.save_fit_state(state, cfg20, path)
    else:
        state = nmf_irls.run_irls(cfg20, A_t, {}, nmf_irls._init_irls_state(
            A_t, cfg20, W_T0, H0, d0), False, seg_end=10)
        ck.save_irls_state(state, cfg20, path)
    cfg12 = rtt.build_config(K, maxit=12, tol=0, seed=1, **FITS[fit])
    if fit == "mse":
        assert ck.load_fit_state(path, cfg12).loss_hist.shape == (12,)
    _bitwise(_fit(A, 12, path, 5, **FITS[fit]), _fit(A, 12, **FITS[fit]))
    with pytest.raises(ValueError, match="maxit"):
        _fit(A, 9, str(tmp_path / "ck.npz"), 5, **FITS[fit])


def test_config_mismatch_names_the_fields_as_the_jax_package(data,
                                                             tmp_path):
    path = str(tmp_path / "ck.npz")
    _fit(data, 3, path)
    with pytest.raises(ValueError, match="config mismatch") as port:
        _fit(data, 6, path, L1=0.1)
    jpath = str(tmp_path / "j.npz")
    rt.nmf(data, K, maxit=3, tol=0, seed=1, checkpoint_path=jpath)
    with pytest.raises(ValueError, match="config mismatch") as jax_err:
        rt.nmf(data, K, maxit=6, tol=0, seed=1, checkpoint_path=jpath,
               L1=0.1)
    assert str(port.value) == str(jax_err.value)
    assert "['H', 'W', 'solver']" in str(port.value)


@pytest.mark.parametrize("kw,match", [
    (dict(test_fraction=0.2), "no CV/mask"),
    (dict(mask="zeros"), "no CV/mask"),
    (dict(fused_vmem=True), "fused_vmem"),
    (dict(checkpoint_every=0), "checkpoint_every")])
def test_refused_fits(kw, match, data, tmp_path):
    path = str(tmp_path / "ck.npz")
    with pytest.raises(ValueError, match=match):
        rtt.nmf(data, K, maxit=3, tol=0, seed=1, device="cpu",
                checkpoint_path=path, **kw)
    assert not os.path.exists(path)


def test_a_file_written_under_a_mesh_is_refused(data, tmp_path):
    path = str(tmp_path / "ck.npz")
    _fit(data, 3, path)
    with np.load(path) as z:
        payload = {name: z[name] for name in z.files}
    payload["mesh_shape"] = np.asarray((2, 2), np.int64)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="mesh 2x2"):
        _fit(data, 6, path)


def test_seed_list_writes_one_file_per_restart(data, tmp_path):
    path = str(tmp_path / "ck.npz")
    best = rtt.nmf(data, K, seed=[1, 2], maxit=6, tol=0, device="cpu",
                   checkpoint_path=path, checkpoint_every=2)
    for ri, seed in enumerate((1, 2)):
        file = tmp_path / f"ck.restart{ri}.npz"
        assert file.exists()
        alone = rtt.nmf(data, K, seed=seed, maxit=6, tol=0, device="cpu")
        with np.load(file) as z:
            np.testing.assert_array_equal(z["H"], _unsorted_H(alone, z))
    assert len(best.misc["all_inits"]) == 2
    assert not (tmp_path / "ck.npz").exists()


def _unsorted_H(res, z):
    """The file holds the loop's state, before the result sorts its factors
    by d: put the fit's H in the file's order."""
    order = np.argsort(-z["d"], kind="stable")
    H = np.empty_like(res.H)
    H[order] = res.H
    return H


def test_fit_on_the_card_by_default(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        rtt.nmf(data, K, maxit=3, checkpoint_path=str(tmp_path / "c.npz"))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(loss="kl"),
                                dict(loss="nb", zi="row"), dict(L1=0.1),
                                dict(loss="gp", dispersion="per_col")])
def test_config_json_is_the_jax_packages(kw):
    assert json.loads(ck._cfg_to_json(rtt.build_config(K, **kw))) == \
        json.loads(ref_ck._cfg_to_json(rt.build_config(K, **kw)))


def _assert_mse_bars(port, want, A):
    trAtA = float((np.asarray(A, np.float64) ** 2).sum())
    lp = np.asarray(port.loss_history, np.float64)
    lr = np.asarray(want.loss_history, np.float64)
    assert np.all(np.abs(lp - lr) <= 1e-4 * np.abs(lr) + 10 * EPS32 * trAtA)
    for name in ("W", "d", "H"):
        p, r = getattr(port, name), np.asarray(getattr(want, name))
        assert np.abs(p - r).max() <= 2e-3 * np.abs(r).max(), name


def _assert_irls_bars(port, want):
    np.testing.assert_allclose(port.loss_history, want.loss_history,
                               rtol=2e-4)
    for name in ("W", "d", "H"):
        p, r = getattr(port, name), np.asarray(getattr(want, name))
        assert np.abs(p - r).max() <= 1e-4 * np.abs(r).max(), name
    for name in ("theta", "pi_row"):
        p, r = getattr(port, name), getattr(want, name)
        assert (p is None) == (r is None), name
        if r is not None:
            np.testing.assert_allclose(p, np.asarray(r), rtol=5e-3)


@pytest.mark.parametrize("fit", list(FITS))
def test_port_resumes_a_jax_checkpoint(fit, data, counts, tmp_path):
    A = _matrix(fit, data, counts)
    path = str(tmp_path / "ck.npz")
    kw = dict(tol=0, seed=1, **FITS[fit])
    rt.nmf(A, K, maxit=5, checkpoint_path=path, checkpoint_every=5, **kw)
    with np.load(path) as z:
        assert int(z["scalars"][0]) == 5
    port = rtt.nmf(A, K, maxit=20, checkpoint_path=path, checkpoint_every=5,
                   device="cpu", **kw)
    want = rt.nmf(A, K, maxit=20, **kw)
    assert port.iterations == 20
    if fit == "mse":
        _assert_mse_bars(port, want, A)
    else:
        _assert_irls_bars(port, want)


@pytest.mark.parametrize("fit", list(FITS))
def test_jax_package_loads_a_port_checkpoint(fit, data, counts, tmp_path):
    A = _matrix(fit, data, counts)
    path = str(tmp_path / "ck.npz")
    _fit(A, 6, path, 3, **FITS[fit])
    cfg_p = rtt.build_config(K, maxit=6, tol=0, seed=1, **FITS[fit])
    cfg_j = rt.build_config(K, maxit=6, tol=0, seed=1, **FITS[fit])
    if fit == "mse":
        port, want = ck.load_fit_state(path, cfg_p), \
            ref_ck.load_fit_state(path, cfg_j)
        names = ("W_T", "H", "d", "loss_hist")
    else:
        A_t = torch.from_numpy(A)
        port = ck.load_irls_state(path, cfg_p, A_t)
        want = ref_ck.load_irls_state(path, cfg_j, np.asarray(A))
        names = ck._IRLS_VECS + ("A_imp",)
    for name in names:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert port.it == int(want.it) == 6
    assert float(port.prev_loss) == float(want.prev_loss)


def test_models_round_trip_across_packages(data, tmp_path):
    res = _fit(data, 5)
    path = str(tmp_path / "model.npz")
    ck.save_model(res, path, cfg=res.misc["config"])
    for loaded in (ck.load_model(path), ref_ck.load_model(path)):
        for name in ("W", "d", "H", "loss_history"):
            np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                          getattr(res, name))
        assert loaded.iterations == 5
        assert json.loads(loaded.misc["config_json"])["rank"] == K
    kw = ck.resume_kwargs(path)
    np.testing.assert_array_equal(kw["h_init"], res.H)
    cb = ck.CheckpointCallback(str(tmp_path / "cb.npz"), every=2)
    cb.update_state(res)
    cb(1, 0.0)
    assert not (tmp_path / "cb.npz").exists()
    cb(2, 0.0)
    np.testing.assert_array_equal(ck.load_model(str(tmp_path / "cb.npz")).W,
                                  res.W)
