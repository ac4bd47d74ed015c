"""The port's NMF fit against the JAX package's, on the CPU.

Both packages get the same ``simulate_nmf`` matrix and the same seed.  Loss
histories must agree within rtol 1e-4 + 10 * eps * tr(A'A), the Gram-trick
cancellation floor of an fp32 loss; W, d and H after sorting within 2e-3 of
their largest entry, the golden-oracle bar (PARITY.md:541-543).

The data is ``simulate_nmf(120, 90, 5, seed=8)``.  On data where an ALS
iterate passes close to a change of active set, the two fp32 trajectories
separate by more than the loss bar for a few iterations (seen with other
seeds: factors still within 2e-3, one loss 0.2% apart at iteration 13), so
the seed is fixed.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import rcppml_tpu as rt
from rcppml_tpu import rng as ref_rng
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.utils.simulate import simulate_counts as ref_simulate_counts
from rcppml_tpu.utils.simulate import simulate_nmf as ref_simulate_nmf

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert, rng
from rcppml_tpu_torch.models import nmf as port_nmf
from rcppml_tpu_torch.ops import cd_nnls
from rcppml_tpu_torch.utils.simulate import simulate_counts, simulate_nmf

K = 5
MAXIT = 15
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def data():
    return simulate_nmf(120, 90, K, seed=8)["A"]


@pytest.fixture(scope="module")
def square(data):
    S = data[:90, :90]
    return ((S + S.T) / 2).astype(np.float32)


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


def test_simulate_nmf_matches_reference():
    a, b = simulate_nmf(50, 40, 3, seed=2), ref_simulate_nmf(50, 40, 3, seed=2)
    for key in ("A", "W", "H"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("kw", [dict(), dict(nb_size=1.5, scale=2.0),
                                dict(zi_pi=0.3, seed=9)],
                         ids=["poisson", "nb", "zero_inflated"])
def test_simulate_counts_matches_reference(kw):
    a, b = simulate_counts(30, 20, 3, **kw), ref_simulate_counts(30, 20, 3, **kw)
    for key in ("A", "W", "H", "mu"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("seed,offset", [(0, 0), (7, 0), (123, 50)])
def test_fill_uniform_bitwise(seed, offset):
    np.testing.assert_array_equal(
        rng.fill_uniform(seed, 9, 13, offset=offset),
        ref_rng.fill_uniform(seed, 9, 13, offset=offset))


@pytest.mark.parametrize("init", ["random", "w_only", "w_and_h"])
def test_init_factors_bitwise(init):
    m, n, seed = 30, 20, 5
    rs = np.random.RandomState(0)
    kw = {}
    if init != "random":
        kw["w_init"] = rs.uniform(size=(m, K)).astype(np.float32)
    if init == "w_and_h":
        kw["h_init"] = rs.uniform(size=(K, n)).astype(np.float32)
    port = port_nmf.init_factors(rtt.build_config(K, seed=seed), m, n, **kw)
    ref = ref_nmf.init_factors(rt.build_config(K, seed=seed), m, n, **kw)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    # the JAX fit's on-device random init is the same stream
    if init == "random":
        W_T, H, _ = ref_nmf._init_random_device(
            K, m, n, jnp.asarray(ref_rng.seed_to_u32_pair(seed)))
        np.testing.assert_array_equal(port[0], np.asarray(W_T))
        np.testing.assert_array_equal(port[1], np.asarray(H))


VARIANTS = {
    "cholesky": {},
    "cd": dict(solver="cd"),
    "L1": dict(L1=(0, 0.1)),
    "L2": dict(L2=0.1),
    # the bound clips about 12% of the entries of H * d here; far tighter
    # bounds make the clipped ALS erratic, and then neither package's fp32
    # trajectory is reproducible to the loss bar
    "upper_bound": dict(upper_bound=20.0),
    # the first projective Gram, of H = W_T0 A with a uniform W_T0, is
    # nearly rank one; its Cholesky solve amplifies fp32 rounding to ~1% in
    # both packages alike, so the projective case runs the CD solver
    "projective": dict(projective=True, solver="cd"),
    "symmetric": dict(symmetric=True),
    "norm_L2": dict(norm="L2"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fit_matches_reference(variant, data, square):
    kw = VARIANTS[variant]
    A = square if kw.get("symmetric") else data
    ref = rt.nmf(A, K, seed=1, maxit=MAXIT, tol=0, **kw)
    port = rtt.nmf(A, K, seed=1, maxit=MAXIT, tol=0, device="cpu", **kw)
    assert port.iterations == ref.iterations == MAXIT
    _assert_loss_close(port.loss_history, ref.loss_history, A)
    _assert_factors_close(port, ref)
    if variant == "upper_bound":
        assert (port.H * port.d[:, None] >= 0.999 * 20.0).mean() > 0.05


def test_fit_converges_with_tol_like_reference(data):
    ref = rt.nmf(data, K, seed=3, maxit=200, tol=1e-3)
    port = rtt.nmf(data, K, seed=3, maxit=200, tol=1e-3, device="cpu")
    assert ref.converged and port.converged
    assert abs(port.iterations - ref.iterations) <= 1
    assert port.final_tol < 1e-3


def test_sparse_and_tensor_inputs_match_dense(data):
    dense = rtt.nmf(data, K, seed=2, maxit=5, tol=0, device="cpu")
    for A, device in ((sp.csr_matrix(data), "cpu"),
                      (torch.from_numpy(data), None)):   # a tensor's own
        other = rtt.nmf(A, K, seed=2, maxit=5, tol=0, device=device)
        np.testing.assert_array_equal(other.loss_history, dense.loss_history)
        np.testing.assert_array_equal(other.W, dense.W)


def test_cd_fit_counts_no_kernel_launch_on_cpu(data):
    before = cd_nnls.cd_nnls_shared.launches
    rtt.nmf(data, K, seed=2, maxit=3, tol=0, solver="cd", device="cpu")
    assert cd_nnls.cd_nnls_shared.launches == before


def test_fit_keeps_float32_matmuls_out_of_tf32(data):
    """The counterpart of the JAX package's ``PREC = HIGHEST``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        rtt.nmf(data, K, seed=1, maxit=1, tol=0, device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def test_dimnames_carry_through(data):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(data, index=[f"g{i}" for i in range(data.shape[0])],
                      columns=[f"c{j}" for j in range(data.shape[1])])
    res = rtt.nmf(df, K, seed=1, maxit=3, tol=0, device="cpu")
    rows, cols = res.dimnames()
    assert rows[0] == "g0" and cols[-1] == f"c{data.shape[1] - 1}"


# ---------------------------------------------------------------------------
# State carried across (convert.py)
# ---------------------------------------------------------------------------

def test_config_round_trip_gives_the_same_fit(data):
    ref_cfg = rt.build_config(K, seed=4, maxit=MAXIT, tol=0, L1=(0.05, 0.1),
                              L2=0.01, solver="cd", norm="L2")
    cfg = convert.config_from_reference(ref_cfg)
    assert isinstance(cfg, rtt.NMFConfig)
    for f in dataclasses.fields(cfg):
        p, r = getattr(cfg, f.name), getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(p):
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
        else:
            assert getattr(p, "value", p) == getattr(r, "value", r), f.name
    port = convert.result_to_numpy(port_nmf.nmf_fit(data, cfg, device="cpu"))
    ref = convert.result_to_numpy(ref_nmf.nmf_fit(data, ref_cfg))
    assert port["iterations"] == ref["iterations"] == MAXIT
    _assert_loss_close(port["loss_history"], ref["loss_history"], data)


def test_factors_handed_across_give_the_same_first_loss(data):
    """A JAX fit's factors start both packages: ``w_init``/``h_init`` through
    the API, and ``state_from_numpy`` into the port's loop directly."""
    ref_cfg = rt.build_config(K, seed=6, maxit=4, tol=0)
    mid = ref_nmf.nmf_fit(data, ref_cfg)
    W, H, d = np.asarray(mid.W), np.asarray(mid.H), np.asarray(mid.d)
    one = rt.build_config(K, maxit=1, tol=0)
    ref = convert.result_to_numpy(ref_nmf.nmf_fit(data, one, w_init=W,
                                                  h_init=H))
    port = convert.result_to_numpy(rtt.nmf(data, K, maxit=1, tol=0, w_init=W,
                                           h_init=H, device="cpu"))
    _assert_loss_close(port["loss_history"], ref["loss_history"], data)

    cfg = convert.config_from_reference(one)
    state = convert.state_from_numpy(W.T, H, d, device="cpu", max_iter=1)
    out = port_nmf.fit_mse(cfg, torch.from_numpy(data), state)
    state_ref = ref_nmf._fit_mse(one.replace(seed=0, sort_model=False),
                                 jnp.asarray(data), jnp.asarray(W.T),
                                 jnp.asarray(H), jnp.asarray(d), {})
    _assert_loss_close(out.loss_hist.numpy(), np.asarray(state_ref.loss_hist),
                       data)


# ---------------------------------------------------------------------------
# Branches not ported yet
# ---------------------------------------------------------------------------

UNPORTED = {
    "profile_irls": dict(profile=True, loss="kl"),
    "checkpoint": dict(checkpoint_path="fit.ckpt"),
    "multi_restart_checkpoint": dict(seed=[1, 2], checkpoint_path="fit.ckpt"),
    "svd_init": dict(seed="lanczos"),
    "streaming": dict(streaming=True),
    "mesh": dict(mesh=(1, 1)),
}


@pytest.mark.parametrize("branch", list(UNPORTED))
def test_unported_branch_raises(branch, data, tmp_path):
    """A branch that is not ported raises NotImplementedError naming its
    ROADMAP item.  The profiled IRLS fit, the SVD-seeded init and the
    checkpointed fits did so until they were ported; now they fit, the
    first with the JAX package's profile keys, the second from the JAX
    package's initial factors (``tests/test_torch_svd.py`` holds both to
    the JAX package in full), the checkpointed ones bit for bit the plain
    fit, one file per restart (``tests/test_torch_checkpoint.py`` holds
    them in full).  ``streaming=True`` runs the streaming engine, within
    the fit bars of the JAX package's streaming fit
    (``tests/test_torch_streaming.py`` holds it in full).  ``mesh=`` fits on
    a (1, 1) mesh as the JAX package does (``tests/test_torch_parallel.py``
    holds the sharded fits in full)."""
    kw = UNPORTED[branch]
    if branch == "mesh":
        import jax
        from rcppml_tpu.parallel.mesh import default_mesh as ref_mesh
        shape = kw["mesh"]
        res = rtt.nmf(data, K, tol=0, maxit=4, seed=1, device="cpu",
                      mesh=rtt.default_mesh(devices=["cpu"], shape=shape))
        ref = rt.nmf(data, K, tol=0, maxit=4, seed=1,
                     mesh=ref_mesh(jax.devices()[:1], shape))
        _assert_loss_close(res.loss_history, ref.loss_history, data)
        assert np.abs(res.W - ref.W).max() <= 2e-3 * np.abs(ref.W).max()
        assert "config" in res.misc
        return
    if "checkpoint_path" in kw:
        path = tmp_path / kw["checkpoint_path"]
        kw = dict(kw, checkpoint_path=str(path))
        res = rtt.nmf(data, K, tol=0, maxit=4, device="cpu", **kw)
        del kw["checkpoint_path"]
        plain = rtt.nmf(data, K, tol=0, maxit=4, device="cpu", **kw)
        np.testing.assert_array_equal(res.W, plain.W)
        np.testing.assert_array_equal(res.loss_history, plain.loss_history)
        files = sorted(f.name for f in tmp_path.iterdir())
        assert files == (["fit.ckpt"] if branch == "checkpoint"
                         else ["fit.restart0.ckpt", "fit.restart1.ckpt"])
        return
    if branch == "profile_irls":
        A = np.round(data * 3)
        res = rtt.nmf(A, K, tol=0, maxit=4, device="cpu", **kw)
        ref = rt.nmf(A, K, tol=0, maxit=4, **kw)
        assert sorted(res.profile) == sorted(ref.profile)
        assert res.profile["iterations"] == 4
        assert np.isfinite(res.loss_history).all()
        return
    if branch == "streaming":
        res = rtt.nmf(data, K, tol=0, maxit=4, seed=1, device="cpu", **kw)
        ref = rt.nmf(data, K, tol=0, maxit=4, seed=1, **kw)
        _assert_loss_close(res.loss_history, ref.loss_history, data)
        assert np.abs(res.W - ref.W).max() <= 2e-3 * np.abs(ref.W).max()
        return
    if branch == "svd_init":
        cfg = rtt.build_config(K, **kw)
        W_T, H, _ = port_nmf.init_factors(cfg, *data.shape,
                                          A=torch.from_numpy(data))
        W_r, H_r, _ = ref_nmf.init_factors(rt.build_config(K, **kw),
                                           *data.shape, A=data)
        for p, r in ((W_T, W_r), (H, H_r)):
            assert np.abs(p - np.asarray(r)).max() <= 1e-4 * np.abs(r).max()
        res = rtt.nmf(data, K, tol=0, maxit=4, device="cpu", **kw)
        assert np.isfinite(res.loss_history).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rtt.nmf(data, K, tol=0, device="cpu", **kw)


PORTED = {
    "fused_vmem": dict(fused_vmem=True),
    "bf16_data": dict(bf16_data=True),
    "profile": dict(profile=True),
    "on_iteration": dict(on_iteration=lambda *a: None),
    "multi_restart": dict(seed=[1, 2]),
    "cv": dict(test_fraction=0.1, cv_patience=7),
    "mask_matrix": dict(mask=np.zeros((120, 90), bool)),
    "mask_zeros": dict(mask="zeros"),
    "sparse_zeros": dict(sparse=True),
}


@pytest.mark.parametrize("branch", list(PORTED))
def test_ported_branch_runs(branch, data):
    """The branches that raised NotImplementedError before they were ported
    now fit, with a finite falling loss of the asked length."""
    res = rtt.nmf(data, K, tol=0, maxit=6, device="cpu", **PORTED[branch])
    assert res.iterations == 6 and res.loss_history.shape == (6,)
    assert np.isfinite(res.loss_history).all()
    assert res.loss_history[-1] < res.loss_history[0]
    assert res.W.shape == (120, K) and res.H.shape == (K, 90)
    if branch in ("cv", "mask_matrix", "mask_zeros", "sparse_zeros"):
        assert res.test_loss_history.shape == (6,)
        assert res.misc["config"].is_cv() == (branch == "cv")


# ---------------------------------------------------------------------------
# Multi-restart, callbacks and the profiled fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(solver="cd"),
                                dict(fused_vmem=True), dict(loss="kl")],
                         ids=["cholesky", "cd", "fused_vmem", "kl"])
def test_multi_restart_matches_reference(kw, data):
    """The selected restart and every restart's loss are the JAX package's;
    each restart equals its standalone fit."""
    seeds = [1, 2, 3]
    A = np.round(data * 3) if "loss" in kw else data
    common = dict(maxit=8, tol=0, **kw)
    ref = rt.nmf(A, K, seed=seeds, **common)
    port = rtt.nmf(A, K, seed=seeds, device="cpu", **common)
    ref_inits, inits = ref.misc["all_inits"], port.misc["all_inits"]
    assert [r["init"] for r in inits] == [0, 1, 2]
    assert [r["selected"] for r in inits] == [r["selected"] for r in ref_inits]
    assert sum(r["selected"] for r in inits) == 1
    trAtA = float((A.astype(np.float64) ** 2).sum())
    for r, p in zip(ref_inits, inits):
        assert abs(p["loss"] - r["loss"]) <= 2e-4 * abs(r["loss"]) \
            + 10 * EPS32 * trAtA
    best = [r["selected"] for r in inits].index(True)
    assert inits[best]["loss"] == min(r["loss"] for r in inits)
    assert port.misc["config"].seed == seeds[best]
    alone = rtt.nmf(A, K, seed=seeds[best], device="cpu", **common)
    np.testing.assert_array_equal(alone.loss_history, port.loss_history)
    np.testing.assert_array_equal(alone.W, port.W)
    _assert_loss_close(port.loss_history, ref.loss_history, A)
    _assert_factors_close(port, ref)


def test_multi_restart_with_extras_loops_over_nmf(data):
    """Every keyword of ``nmf`` reaches each restart (here a callback), and
    the selection is that of the same restarts without it."""
    calls = []
    res = rtt.nmf(data, K, seed=[1, 2], maxit=4, tol=0, device="cpu",
                  on_iteration=lambda it, train, test: calls.append(it))
    plain = rtt.nmf(data, K, seed=[1, 2], maxit=4, tol=0, device="cpu")
    assert calls == [1, 2, 3, 4] * 2
    assert [r["selected"] for r in res.misc["all_inits"]] == \
        [r["selected"] for r in plain.misc["all_inits"]]
    _assert_loss_close(res.loss_history, plain.loss_history, data)
    with pytest.raises(ValueError, match="scalar integer k"):
        rtt.nmf(data, [3, 4], seed=[1, 2], device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(solver="cd"),
                                dict(bf16_data=True)],
                         ids=["cholesky", "cd", "bf16_data"])
def test_on_iteration_matches_reference(kw, data):
    ref_calls, calls = [], []
    ref = rt.nmf(data, K, seed=1, maxit=8, tol=0,
                 on_iteration=lambda *a: ref_calls.append(a), **kw)
    port = rtt.nmf(data, K, seed=1, maxit=8, tol=0, device="cpu",
                   on_iteration=lambda *a: calls.append(a), **kw)
    assert [c[0] for c in calls] == [c[0] for c in ref_calls] \
        == list(range(1, 9))
    assert all(np.isnan(c[2]) for c in calls)
    rtol = 1e-2 if kw.get("bf16_data") else 1e-4
    trAtA = float((data.astype(np.float64) ** 2).sum())
    floor = (2.0 ** -8 if kw.get("bf16_data") else 10 * EPS32) * trAtA
    for c, r in zip(calls, ref_calls):
        assert abs(c[1] - r[1]) <= rtol * abs(r[1]) + floor
    np.testing.assert_array_equal(port.loss_history,
                                  np.float32([c[1] for c in calls]))
    assert sorted(port.profile) == sorted(ref.profile) \
        == ["h_update", "loss", "w_update"]
    assert all(v > 0 for v in port.profile.values())
    assert port.iterations == ref.iterations == 8
    if not kw.get("bf16_data"):
        # step mode is the loop, section by section: the same fit
        loop = rtt.nmf(data, K, seed=1, maxit=8, tol=0, device="cpu", **kw)
        np.testing.assert_array_equal(port.loss_history, loop.loss_history)
        np.testing.assert_array_equal(port.W, loop.W)


def test_on_iteration_stops_with_tol_like_the_loop(data):
    calls = []
    port = rtt.nmf(data, K, seed=3, maxit=200, tol=1e-3, device="cpu",
                   on_iteration=lambda *a: calls.append(a[0]))
    loop = rtt.nmf(data, K, seed=3, maxit=200, tol=1e-3, device="cpu")
    ref = rt.nmf(data, K, seed=3, maxit=200, tol=1e-3,
                 on_iteration=lambda *a: None)
    assert port.converged and port.iterations == loop.iterations
    assert abs(port.iterations - ref.iterations) <= 1
    assert calls == list(range(1, port.iterations + 1))
    assert port.final_tol < 1e-3


@pytest.mark.parametrize("kw", [dict(maxit=20, tol=0),
                                dict(maxit=200, tol=1e-3),
                                dict(maxit=5, tol=0, solver="cd")],
                         ids=["fixed", "converging", "short"])
def test_profile_matches_reference(kw, data):
    ref = rt.nmf(data, K, seed=1, profile=True, **kw)
    port = rtt.nmf(data, K, seed=1, profile=True, device="cpu", **kw)
    assert sorted(port.profile) == sorted(ref.profile)
    assert port.profile["mode"] == ref.profile["mode"] == "fused-segmented"
    assert port.profile["iterations"] == port.iterations
    assert abs(port.iterations - ref.iterations) <= (1 if kw["tol"] else 0)
    for key in ("h_update", "w_update", "loss", "fused_total_ms",
                "fused_per_iter_us"):
        assert port.profile[key] > 0
    # the segmented loop is the production loop: bitwise the unprofiled fit
    loop = rtt.nmf(data, K, seed=1, device="cpu", **kw)
    assert loop.iterations == port.iterations
    np.testing.assert_array_equal(loop.loss_history, port.loss_history)
    np.testing.assert_array_equal(loop.W, port.W)
    assert loop.profile == {}
    if not kw["tol"]:
        _assert_loss_close(port.loss_history, ref.loss_history, data)


@pytest.mark.parametrize("args", [
    ("data", [2, 3]), ("data", "auto"), ("x.spz", 3), ("list", 3),
    ("nan", 3), ("dict", 3)],
    ids=["k_list", "k_auto", "spz_path", "multimodal", "nan",
         "multimodal_dict"])
def test_unported_inputs_raise(args, data, tmp_path):
    """Inputs that are not ported raise NotImplementedError naming their
    ROADMAP item.  A list of ranks, ``"auto"``, NaN entries and ``.spz``
    paths did so until cross-validation, masks and streaming were ported;
    now a list of ranks gives one row per rank, ``"auto"`` a fit at the rank
    it chose, NaN entries a masked fit and a warning, a ``.spz`` path the
    streaming fit of the file, within the fit bars of the JAX package's.
    A list or dict of matrices did so until the graph engine was ported;
    now it is a shared-H fit whose W comes back split per matrix, within
    the fit bars of the JAX package's (``tests/test_torch_graph.py`` holds
    it in full)."""
    what, k = args
    if what == "x.spz":
        path = str(tmp_path / what)
        rtt.st_write(data, path, chunk_cols=32)
        res = rtt.nmf(path, k, tol=0, maxit=4, seed=1, device="cpu")
        ref = rt.nmf(path, k, tol=0, maxit=4, seed=1)
        _assert_loss_close(res.loss_history, ref.loss_history, data)
        return
    if what == "data" and k == "auto":
        res = rtt.nmf(data, "auto", cv_k_range=(2, 6), maxit=4, device="cpu")
        assert res.k == res.misc["rank_search"]["k_optimal"]
        assert 2 <= res.k <= 6 and np.isfinite(res.loss_history).all()
    elif what == "data":
        rows = rtt.nmf(data, k, maxit=4, device="cpu")
        assert [r["k"] for r in rows] == k
        assert all(np.isfinite(r["test_mse"]) for r in rows)
    elif what == "nan":
        A = data.copy()
        A[0, 0] = np.nan
        with pytest.warns(UserWarning, match="Detected 1 NA values"):
            res = rtt.nmf(A, k, maxit=4, device="cpu")
        assert np.isfinite(res.W).all() and res.test_loss_history.shape == (4,)
    else:
        A = {"list": [data, data], "dict": {"a": data, "b": data}}[what]
        res = rtt.nmf(A, k, tol=0, maxit=4, seed=1, device="cpu")
        ref = rt.nmf(A, k, tol=0, maxit=4, seed=1)
        names = ["modal1", "modal2"] if what == "list" else ["a", "b"]
        assert list(res["L1"].W_blocks) == list(ref["L1"].W_blocks) == names
        assert res.total_iterations == ref.total_iterations == 4
        stacked = np.vstack([data, data])
        trAtA = float((stacked.astype(np.float64) ** 2).sum())
        assert abs(res.total_loss - ref.total_loss) <= \
            1e-4 * abs(ref.total_loss) + 10 * EPS32 * trAtA
        _assert_factors_close(res["L1"], ref["L1"])


def test_invalid_inputs_raise_value_errors(data):
    with pytest.raises(ValueError):
        rtt.nmf(data, 200, device="cpu")            # rank > min(m, n)
    with pytest.raises(ValueError):
        rtt.nmf(data, K, symmetric=True, device="cpu")   # not square
    bad = data.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ValueError):
        rtt.nmf(bad, K, mask="zeros", device="cpu")
    with pytest.raises(ValueError):
        rtt.nmf(bad, K, device="cpu")
    with pytest.raises(ValueError):
        rtt.nmf(data, K, L1=1.5, device="cpu")
