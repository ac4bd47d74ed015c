"""The port's truncated SVD / PCA, SVD-seeded NMF and profiled IRLS fit
against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs: a 300 x 200 matrix with a
planted, well-separated spectrum (eight singular values 10 * 0.7^i plus
noise), and a nonnegative one of the same shape whose factors live on
interleaved rows and columns.  Singular vectors are defined up to sign, so
each column is compared after aligning its sign with the JAX package's.

Bars: Lanczos, IRLBA, randomized and Krylov ``d`` within rtol 1e-4, ``U``
and ``V`` within atol 1e-3, ``iterations``, ``converged`` and the method
equal.  Deflation ``d`` within rtol 1e-3, ``U`` / ``V`` within 1e-3,
``iterations`` and ``k_selected`` equal, the CV test-loss trajectory of the
same length and ``test_loss`` within rtol 1e-3.  The robust (Huber IRLS)
deflation is held to ``d`` and ``k_selected`` only: its rank-1 iteration
is chaotic in float32 (a last-bit change of A moves the JAX package's own
iteration count on this matrix from 14 to 16 or 17), so the iteration
counts of two correct implementations differ.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rcppml_tpu as rt
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.models import svd as ref_svd
from rcppml_tpu.config import SVDConfig as RefSVDConfig
from rcppml_tpu.config import FactorConfig as RefFactorConfig

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.config import FactorConfig, SVDConfig
from rcppml_tpu_torch.models import nmf as port_nmf
from rcppml_tpu_torch.models import svd as port_svd
from rcppml_tpu_torch.utils.simulate import simulate_nmf

REPO = Path(__file__).resolve().parent.parent
M, N, RANK = 300, 200, 8
K = 5
EPS32 = float(np.finfo(np.float32).eps)


def planted(seed=0, noise=0.01):
    rs = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rs.randn(M, RANK))
    V, _ = np.linalg.qr(rs.randn(N, RANK))
    s = 10.0 * 0.7 ** np.arange(RANK)
    return ((U * s) @ V.T + noise * rs.randn(M, N)).astype(np.float32)


def planted_nonneg(seed=0, noise=0.01, zeros=0.0):
    """Nonnegative factors on interleaved rows / columns (row i belongs to
    factor i mod RANK), so they are orthogonal; ``zeros``: the share of
    entries set to zero."""
    rs = np.random.RandomState(seed)
    A = noise * rs.rand(M, N)
    for f in range(RANK):
        u = np.where(np.arange(M) % RANK == f, rs.rand(M) + 0.5, 0.0)
        v = np.where(np.arange(N) % RANK == f, rs.rand(N) + 0.5, 0.0)
        A += 10.0 * 0.7 ** f * np.outer(u / np.linalg.norm(u),
                                        v / np.linalg.norm(v))
    if zeros:
        A[rs.rand(M, N) < zeros] = 0.0
    return A.astype(np.float32)


@pytest.fixture(scope="module")
def A():
    return planted()


@pytest.fixture(scope="module")
def A_nn():
    return planted_nonneg()


def _aligned(port, ref):
    """``port`` with each column's sign set by its dot with ``ref``'s."""
    sign = np.sign(np.sum(np.asarray(port, np.float64) * ref, axis=0))
    sign[sign == 0] = 1.0
    return port * sign


def _compare(port, ref, *, d_rtol, vec_atol=1e-3, iterations=True,
             vec_cols=None):
    """``vec_cols``: compare only the leading singular vectors (past the
    planted rank the spectrum is noise, whose vectors are not defined)."""
    assert port.k_selected == ref.k_selected
    assert port.d.shape == np.shape(ref.d)
    np.testing.assert_allclose(port.d, ref.d, rtol=d_rtol,
                               atol=d_rtol * float(np.max(ref.d)))
    if vec_atol is not None:
        for name in ("U", "V"):
            p, r = getattr(port, name), np.asarray(getattr(ref, name))
            assert p.shape == r.shape
            p, r = p[:, :vec_cols], r[:, :vec_cols]
            np.testing.assert_allclose(_aligned(p, r), r, atol=vec_atol)
    if iterations:
        assert port.iterations == ref.iterations
        assert port.converged == ref.converged
    assert port.misc.get("method") == ref.misc.get("method")
    for name in ("center", "scale"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is not None:
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def _laplacian(n, seed):
    rs = np.random.RandomState(seed)
    Wg = (rs.rand(n, n) < 0.05).astype(np.float32)
    Wg = np.triu(Wg, 1)
    Wg = Wg + Wg.T
    return (np.diag(Wg.sum(axis=1)) - Wg).astype(np.float32)


# ---------------------------------------------------------------------------
# Lanczos, IRLBA, randomized, Krylov
# ---------------------------------------------------------------------------

METHODS = {
    "lanczos": dict(method="lanczos"),
    "lanczos_center": dict(method="lanczos", center=True),
    "lanczos_scale": dict(method="lanczos", scale=True),
    "irlba": dict(method="irlba"),
    "irlba_center": dict(method="irlba", center=True),
    # a tolerance float32 never meets: three thick restarts, unconverged
    "irlba_restarts": dict(method="irlba", tol=1e-12, maxit=3),
    "randomized": dict(method="randomized"),
    "randomized_center": dict(method="randomized", center=True,
                              power_iters=0, oversample=5),
    "krylov": dict(method="krylov"),
    "auto": dict(),
    "auto_k40": dict(k=40),
    "auto_k70": dict(k=70),
}
KRYLOV = {
    "nonneg": dict(nonneg=True),
    "nonneg_loss": dict(nonneg=True, convergence="loss"),
    "nonneg_both": dict(nonneg=True, convergence="both"),
    "L1": dict(L1=0.01),
    "L2_upper_bound": dict(L2=0.1, upper_bound=(0.5, 0.0)),
    "L21": dict(L21=0.05),
    "angular": dict(angular=0.1, nonneg=True),
    "graph": dict(graph_lambda=0.05, graph=True),
    "cv": dict(test_fraction=0.1, cv_seed=3),
    "cv_nonneg_center": dict(test_fraction=0.1, nonneg=True, center=True),
    "auto_constraints_k8": dict(method="auto", nonneg=True, k=8),
}


@pytest.mark.parametrize("case", list(METHODS))
def test_methods_match_reference(case, A):
    kw = dict(METHODS[case])
    k = kw.pop("k", K)
    ref = ref_svd.svd(A, k, **kw)
    port = port_svd.svd(A, k, device="cpu", **kw)
    _compare(port, ref, d_rtol=1e-4, vec_cols=RANK)
    assert port.misc["frobenius_norm_sq"] == pytest.approx(
        ref.misc["frobenius_norm_sq"], rel=1e-6)


@pytest.mark.parametrize("case", list(KRYLOV))
def test_krylov_matches_reference(case, A_nn):
    kw = dict(KRYLOV[case])
    k = kw.pop("k", K)
    kw.setdefault("method", "krylov")
    if kw.pop("graph", False):
        kw["graph_U"] = _laplacian(M, 1)
        kw["graph_V"] = _laplacian(N, 2)
    ref = ref_svd.svd(A_nn, k, **kw)
    port = port_svd.svd(A_nn, k, device="cpu", **kw)
    _compare(port, ref, d_rtol=1e-4)
    if "test_fraction" in kw:
        assert port.test_loss == pytest.approx(ref.test_loss, rel=1e-4)
        assert len(port.misc["test_loss_trajectory"]) == \
            len(ref.misc["test_loss_trajectory"])


def test_auto_select_method_matches_reference():
    for k in (2, 8, 31, 32, 63, 64, 200):
        for fc in (dict(), dict(nonneg=True), dict(L1=0.1), dict(L21=0.1),
                   dict(angular=0.1), dict(graph_lambda=0.1)):
            for extra in (dict(), dict(robust_delta=1.345),
                          dict(test_fraction=0.1)):
                fck = {"nonneg": False, **fc}
                port = SVDConfig(k=k, u=FactorConfig(**fck), **extra)
                ref = RefSVDConfig(k=k, u=RefFactorConfig(**fck), **extra)
                assert port_svd._auto_select_method(port, k) == \
                    ref_svd._auto_select_method(ref, k)


# ---------------------------------------------------------------------------
# Deflation
# ---------------------------------------------------------------------------

DEFLATION = {
    "plain": dict(),
    "center": dict(center=True),
    "scale": dict(scale=True),
    "nonneg": dict(nonneg=True),
    "semi_nonneg": dict(nonneg=(True, False)),
    "L1": dict(L1=0.01),
    "L2": dict(L2=0.5),
    "L21": dict(L21=0.1),
    "upper_bound": dict(upper_bound=0.2, nonneg=True),
    "angular": dict(angular=0.1),
    "graph": dict(graph_lambda=0.05, graph=True),
    "loss": dict(convergence="loss"),
    "both": dict(convergence="both"),
    "robust": dict(robust=True),
    "robust_delta": dict(robust=2.0),
    "masked": dict(mask="matrix"),
    "cv": dict(test_fraction=0.1),
    "cv_center_scale": dict(test_fraction=0.1, center=True, scale=True),
    "cv_masked": dict(test_fraction=0.2, cv_seed=5, mask="matrix"),
    "cv_mask_zeros": dict(test_fraction=0.1, mask="zeros"),
    "cv_mask_zeros_matrix": dict(test_fraction=0.1, mask="zeros+matrix"),
    "auto_rank": dict(k="auto", k_max=12),
    "auto_rank_patience": dict(k="auto", k_max=12, patience=1, cv_seed=9),
}


@pytest.mark.parametrize("case", list(DEFLATION))
def test_deflation_matches_reference(case):
    kw = dict(DEFLATION[case])
    k = kw.pop("k", K)
    data = planted_nonneg(zeros=0.3) if "zeros" in str(kw.get("mask")) \
        else planted(seed=1)
    obs = np.random.RandomState(4).rand(M, N) < 0.1
    mask = kw.pop("mask", None)
    if mask == "matrix":
        kw["mask"] = obs
    elif mask == "zeros":
        kw["mask"] = "zeros"
    elif mask == "zeros+matrix":
        kw["mask"] = ("zeros", obs)
    if kw.pop("graph", False):
        kw["graph_U"] = _laplacian(M, 3)
    robust = "robust" in kw
    ref = ref_svd.svd(data, k, method="deflation", **kw)
    port = port_svd.svd(data, k, method="deflation", device="cpu", **kw)
    _compare(port, ref, d_rtol=1e-3, vec_atol=None if robust else 1e-3,
             iterations=not robust)
    if not robust:
        assert port.misc["iters_per_factor"] == ref.misc["iters_per_factor"]
    traj, ref_traj = (port.misc["test_loss_trajectory"],
                      ref.misc["test_loss_trajectory"])
    assert len(traj) == len(ref_traj)
    np.testing.assert_allclose(traj, ref_traj, rtol=1e-3)
    if ref_traj:
        assert port.test_loss == pytest.approx(ref.test_loss, rel=1e-3)
    assert port.misc["host_syncs"] > 0


# ---------------------------------------------------------------------------
# PCA, inputs, results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(scale=True),
                                dict(method="deflation"),
                                dict(method="randomized", scale=True)],
                         ids=["centered", "scaled", "deflation",
                              "randomized_scaled"])
def test_pca_matches_reference(kw, A):
    ref = ref_svd.pca(A, K, **kw)
    port = port_svd.pca(A, K, device="cpu", **kw)
    _compare(port, ref, d_rtol=1e-3 if "method" in kw else 1e-4)
    np.testing.assert_allclose(port.misc["sdev"], ref.misc["sdev"],
                               rtol=1e-4)
    np.testing.assert_allclose(port.variance_explained(),
                               ref.variance_explained(), rtol=1e-4)


def test_inputs_tensor_sparse_and_dataframe(A_nn):
    """A CPU tensor runs on the CPU without ``device=`` and gives the numpy
    input's result; a scipy sparse matrix is made dense."""
    base = port_svd.svd(A_nn, K, device="cpu")
    from_tensor = port_svd.svd(torch.from_numpy(A_nn), K)
    from_sparse = port_svd.svd(sp.csc_matrix(A_nn), K, device="cpu")
    for res in (from_tensor, from_sparse):
        np.testing.assert_allclose(res.d, base.d, rtol=1e-6)
        np.testing.assert_allclose(np.abs(res.U), np.abs(base.U), atol=1e-5)
    assert from_sparse.misc["frobenius_norm_sq"] == pytest.approx(
        base.misc["frobenius_norm_sq"], rel=1e-6)
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(A_nn, index=[f"g{i}" for i in range(M)])
    named = port_svd.svd(df, K, device="cpu")
    assert list(named.row_names[:2]) == ["g0", "g1"]


def test_svd_result_methods_match_reference(A):
    """The port's SVDResult methods on a JAX-fitted result carried across
    by ``convert.svd_result_from_reference``."""
    ref = ref_svd.pca(A, K, method="lanczos")
    port = convert.svd_result_from_reference(ref)
    assert isinstance(port, rtt.SVDResult)
    np.testing.assert_allclose(port.reconstruct(), ref.reconstruct(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rtt.variance_explained(port),
                                  ref.variance_explained())
    np.testing.assert_array_equal(port.head(4), ref.head(4))
    sub, ref_sub = port[[0, 2]], ref[[0, 2]]
    assert sub.k_selected == ref_sub.k_selected == 2
    np.testing.assert_array_equal(sub.U, ref_sub.U)
    new = np.random.RandomState(3).rand(7, N).astype(np.float32)
    np.testing.assert_allclose(port.predict(new), ref.predict(new),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="features"):
        port.predict(new[:, :-1])
    assert repr(port) == repr(ref).replace("SVDResult", "SVDResult")


ARG_ERRORS = [
    (dict(typo=1), ValueError, "unknown parameter"),
    (dict(convergence="fast"), ValueError, "convergence"),
    (dict(mask="holes"), ValueError, "mask string"),
    (dict(mask=("ones", None)), ValueError, "mask sequence"),
    (dict(mask=np.zeros((3, 3), bool)), ValueError, "mask dimensions"),
    (dict(mask=np.zeros((M, N), bool), method="lanczos"), ValueError,
     "deflation"),
    (dict(method="qr"), ValueError, "unknown SVD method"),
]


@pytest.mark.parametrize("kw,err,match", ARG_ERRORS,
                         ids=[m.replace(" ", "_") for _, _, m in ARG_ERRORS])
def test_argument_checks_match_reference(kw, err, match, A):
    kw = dict(kw)
    k = kw.pop("k", K)
    with pytest.raises(err, match=match):
        ref_svd.svd(A, k, **kw)
    with pytest.raises(err, match=match):
        port_svd.svd(A, k, device="cpu", **kw)


def test_nan_spz_and_warnings(A, tmp_path):
    bad = A.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        port_svd.svd(bad, K, device="cpu")
    # a .spz path streams (tests/test_torch_streaming.py holds every
    # method to the JAX package)
    path = str(tmp_path / "data.spz")
    rtt.st_write(A, path, value_type="float32")
    np.testing.assert_allclose(
        port_svd.svd(path, K, method="lanczos", device="cpu").d,
        ref_svd.svd(path, K, method="lanczos").d, rtol=1e-4)
    with pytest.warns(UserWarning, match="does not support cross-validation"):
        res = port_svd.svd(A, K, method="lanczos", test_fraction=0.1,
                           device="cpu")
    assert np.isnan(res.test_loss)
    with pytest.warns(UserWarning, match="has no effect"):
        port_svd.svd(A, K, method="deflation", mask="zeros", device="cpu")
    with pytest.warns(UserWarning, match="does not support"):
        port_svd.svd(A, K, method="randomized", nonneg=True, device="cpu")
    # scale implies center, as in the JAX package
    res = port_svd.svd(A, K, scale=True, device="cpu")
    assert res.center is not None and res.scale is not None


def test_entry_points_need_a_card_without_device(A, monkeypatch):
    """With no device given, a host array goes to the CUDA card; without
    one every new entry point raises (after the argument checks) and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = rtt.nmf(np.abs(A), 3, maxit=2, device="cpu")
    calls = [lambda: rtt.svd(A, K), lambda: rtt.pca(A, K),
             lambda: port_svd.lanczos_svd(A, SVDConfig(k=K)),
             lambda: rtt.nnls(np.abs(A), w=model.W),
             lambda: rtt.predict(model, np.abs(A)),
             lambda: rtt.evaluate(model, np.abs(A)),
             lambda: rtt.mse(model, np.abs(A)),
             lambda: rtt.nmf(np.abs(A), 3, seed="lanczos")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    with pytest.raises(ValueError, match="unknown parameter"):
        rtt.svd(A, K, typo=1)


def test_import_with_jax_blocked():
    """The port and its new modules import with ``jax`` unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import rcppml_tpu_torch as rtt; "
            "import rcppml_tpu_torch.models.svd, "
            "rcppml_tpu_torch.models.project, rcppml_tpu_torch.convert; "
            "import numpy as np; "
            "A = np.random.RandomState(0).rand(30, 20).astype(np.float32); "
            "print(rtt.svd(A, 2, device='cpu').k, "
            "rtt.nnls(A, w=np.ones((30, 2), np.float32), device='cpu').shape)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "(2,", "20)"]


# ---------------------------------------------------------------------------
# SVD-seeded NMF
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nmf_data():
    return simulate_nmf(120, 90, K, seed=8)["A"]


def _assert_loss_close(port_hist, ref_hist, A):
    lp = np.asarray(port_hist, np.float64)
    lr = np.asarray(ref_hist, np.float64)
    assert lp.shape == lr.shape
    trAtA = float((np.asarray(A, np.float64) ** 2).sum())
    allow = 1e-4 * np.abs(lr) + 10 * EPS32 * trAtA
    assert np.all(np.abs(lp - lr) <= allow), np.abs(lp - lr) / allow


def _assert_factors_close(port, ref, tol=2e-3):
    for name in ("W", "d", "H"):
        p = np.asarray(getattr(port, name), np.float64)
        r = np.asarray(getattr(ref, name), np.float64)
        err = np.abs(p - r).max() / np.abs(r).max()
        assert err < tol, (name, err)


@pytest.mark.parametrize("seed", ["lanczos", "irlba"])
@pytest.mark.parametrize("case", ["k5", "full_rank"])
def test_svd_init_matches_reference(seed, case, nmf_data):
    """The initial factors within 1e-4 of the JAX package's largest entry.
    ``full_rank``: k = min(m, n) on a 24 x 10 matrix of rank 10 with a
    well-separated spectrum; IRLBA gives k - 1 factors there, and the last
    row is filled at random from the reference's ``fill_seed`` stream."""
    if case == "full_rank":
        rs = np.random.RandomState(0)
        U, _ = np.linalg.qr(rs.randn(24, 10))
        V, _ = np.linalg.qr(rs.randn(10, 10))
        data = ((U * (10 * 0.6 ** np.arange(10))) @ V.T).astype(np.float32)
        k = 10
    else:
        data, k = nmf_data, K
    cfg = rtt.build_config(k, seed=seed)
    port = port_nmf.init_factors(cfg, *data.shape, A=torch.from_numpy(data))
    ref = ref_nmf.init_factors(rt.build_config(k, seed=seed),
                               *data.shape, A=data)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.shape == r.shape
        assert np.abs(p - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("kw", [dict(), dict(solver="cd"),
                                dict(test_fraction=0.1, cv_patience=20),
                                dict(mask="zeros")],
                         ids=["cholesky", "cd", "cv", "mask_zeros"])
@pytest.mark.parametrize("seed", ["lanczos", "irlba"])
def test_svd_seeded_fit_matches_reference(seed, kw, nmf_data):
    common = dict(maxit=12, tol=0, seed=seed, **kw)
    ref = rt.nmf(nmf_data, K, **common)
    port = rtt.nmf(nmf_data, K, device="cpu", **common)
    _assert_loss_close(port.loss_history, ref.loss_history, nmf_data)
    _assert_factors_close(port, ref)
    if "test_fraction" in kw:
        _assert_loss_close(port.test_loss_history, ref.test_loss_history,
                           nmf_data)


def test_svd_seeded_irls_fit_matches_reference(nmf_data):
    A = np.round(nmf_data * 3)
    ref = rt.nmf(A, K, loss="kl", maxit=6, tol=0, seed="lanczos")
    port = rtt.nmf(A, K, loss="kl", maxit=6, tol=0, seed="lanczos",
                   device="cpu")
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=2e-4)
    _assert_factors_close(port, ref, tol=1e-3)


# ---------------------------------------------------------------------------
# The profiled IRLS fit and callbacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(loss="kl", maxit=9, tol=0),
    dict(loss="kl", maxit=40, tol=1e-3),
    dict(loss="nb", zi="row", maxit=6, tol=0),
    dict(loss="gamma", maxit=5, tol=0),
    dict(robust=True, maxit=5, tol=0)],
    ids=["kl", "kl_converging", "nb_zi", "gamma", "robust"])
def test_profiled_irls_fit(kw, nmf_data):
    """Same profile keys as the JAX package, the history bit for bit the
    unprofiled port fit's, the iterations those of the JAX fit."""
    A = np.round(nmf_data * 3) + (1.0 if kw.get("loss") == "gamma" else 0.0)
    plain = rtt.nmf(A, K, seed=1, device="cpu", **kw)
    prof = rtt.nmf(A, K, seed=1, device="cpu", profile=True, **kw)
    ref = rt.nmf(A, K, seed=1, profile=True, **kw)
    assert sorted(prof.profile) == sorted(ref.profile)
    np.testing.assert_array_equal(prof.loss_history, plain.loss_history)
    for name in ("W", "d", "H"):
        np.testing.assert_array_equal(getattr(prof, name),
                                      getattr(plain, name))
    assert prof.iterations == plain.iterations == ref.iterations
    assert prof.profile["iterations"] == prof.iterations
    assert prof.profile["mode"] == ref.profile["mode"]
    assert prof.profile["irls_iteration"] > 0


@pytest.mark.parametrize("kw", [dict(loss="kl"), dict(test_fraction=0.1),
                                dict(mask="zeros"),
                                dict(loss="nb", test_fraction=0.1)],
                         ids=["irls", "cv", "mask", "irls_cv"])
def test_on_iteration_is_never_called_like_reference(kw, nmf_data):
    """With an IRLS loss, cross-validation or a mask both packages take the
    callback and never call it."""
    A = np.round(nmf_data * 3)
    calls, ref_calls = [], []
    port = rtt.nmf(A, K, maxit=4, tol=0, seed=1, device="cpu",
                   on_iteration=lambda *a: calls.append(a), **kw)
    ref = rt.nmf(A, K, maxit=4, tol=0, seed=1,
                 on_iteration=lambda *a: ref_calls.append(a), **kw)
    assert calls == [] and ref_calls == []
    assert port.iterations == ref.iterations == 4
