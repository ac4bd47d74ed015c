"""The port's streaming engine (``models/nmf_chunked.py``), streaming SVD
(``models/svd.py::streaming_svd``), ``nnls_streaming``, the stream
checkpoints and the API dispatch, against the JAX package on the CPU.

The same loader configuration and config go through ``rcppml_tpu``'s
``nmf_chunked`` and the port's.  Bars (the port's fit bars, ``PERF.md``
§2): MSE train loss within rtol 1e-4 plus 10 eps tr(A'A) (the Gram-trick
loss's cancellation floor), W / d / H within 2e-3 of the largest entry;
IRLS losses within rtol 2e-4 and factors within 1e-4; CV histories within
2e-4 with the same ``best_iter``.  Within the port, sparse panels and the
dense panel cache are bit for bit the uncached dense-panel fit, the wire
cache (whose later sweeps take the saved-matrix loss) within 1e-5, and a
stream stopped and resumed from its checkpoint bit for bit the
uninterrupted one.  ``streaming_svd``: ``d`` within rtol 1e-4 (deflation
1e-3), sign-aligned U and V within 1e-3, on a matrix with a separated
spectrum.  ``nnls_streaming`` within 1e-5 of the largest entry.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import rcppml_tpu as rt
from rcppml_tpu.io import loaders as ref_loaders
from rcppml_tpu.io import spz as ref_spz
from rcppml_tpu.models import nmf_chunked as ref_chunked
from rcppml_tpu.models import project as ref_project
from rcppml_tpu.models import svd as ref_svd
from rcppml_tpu.utils import checkpoint as ref_ck

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import api
from rcppml_tpu_torch.io import loaders
from rcppml_tpu_torch.io.panels import _compact_sparse
from rcppml_tpu_torch.io.upload import upload
from rcppml_tpu_torch.models import nmf_chunked
from rcppml_tpu_torch.ops import coo_densify
from rcppml_tpu_torch.utils import checkpoint as ck
from rcppml_tpu_torch.utils import memory
from rcppml_tpu_torch.utils.simulate import simulate_nmf

K = 4
EPS32 = float(np.finfo(np.float32).eps)
MAXIT = 6


@pytest.fixture(scope="module")
def data():
    A = simulate_nmf(60, 90, K, noise=0.05, seed=3)["A"]
    rs = np.random.RandomState(1)
    counts = rs.poisson(3.0 * A).astype(np.float32)
    S = sp.random(120, 100, density=0.08, random_state=rs, format="csc",
                  dtype=np.float32)
    S.data = np.ceil(S.data * 9)
    Z = A * (A > 0.3)
    return {"dense": A, "counts": counts, "sparse": S, "zeros": Z}


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _trace(M):
    return float((M.toarray() if sp.issparse(M) else M).astype(
        np.float64).__pow__(2).sum())


def _hold_mse(port, ref, M):
    tol = 1e-4 * abs(ref.train_loss) + 10 * EPS32 * _trace(M)
    assert abs(port.train_loss - ref.train_loss) <= tol
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=1e-4, atol=10 * EPS32 * _trace(M))
    for f in ("W", "d", "H"):
        assert _max_rel(getattr(port, f), getattr(ref, f)) < 2e-3, f


def _hold_irls(port, ref):
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=2e-4)
    for f in ("W", "d", "H"):
        assert _max_rel(getattr(port, f), getattr(ref, f)) < 1e-4, f
    for f in ("theta", "pi_row", "pi_col"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=5e-3)


def _hold_cv(port, ref):
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=2e-4)
    np.testing.assert_allclose(port.test_loss_history,
                               ref.test_loss_history, rtol=2e-4)
    assert port.best_iter == ref.best_iter
    assert ("best_test_loss" in port.misc) == ("best_test_loss" in ref.misc)
    if "best_test_loss" in ref.misc:
        assert port.misc["best_test_loss"] == pytest.approx(
            ref.misc["best_test_loss"], rel=2e-4)
    for f in ("W", "d", "H"):
        assert _max_rel(getattr(port, f), getattr(ref, f)) < 2e-3, f


def _chain_laplacian(n):
    return (np.diag(np.r_[1, np.full(n - 2, 2.0), 1])
            - np.eye(n, k=1) - np.eye(n, k=-1)).astype(np.float32)


# name: (matrix, config keywords, engine keywords, bar)
FITS = {
    "mse_cholesky": ("dense", {}, {}, "mse"),
    "mse_cd": ("dense", dict(solver="cd"), {}, "mse"),
    "mse_l1_l2": ("dense", dict(L1=(0.05, 0.02), L2=(0.1, 0.0), solver="cd"),
                  {}, "mse"),
    "mse_l21_upper_bound": ("dense", dict(L21=(0.02, 0.0),
                                          upper_bound=(0.0, 0.5)), {},
                            "mse"),
    "mse_graph_H": ("dense", dict(graph_lambda=(0.0, 0.05),
                                  has_graph_H=True), dict(graph="H"), "mse"),
    # the first projective Gram, of H = W_T0 A with a uniform W_T0, is
    # nearly rank one; its Cholesky solve amplifies fp32 rounding to ~1% in
    # both packages alike (tests/test_torch_nmf.py), so it runs CD
    "mse_projective": ("dense", dict(projective=True, solver="cd"), {},
                       "mse"),
    "mse_sparse_panels": ("sparse", {}, dict(sparse_panels=True,
                                             panel_cache=False), "mse"),
    "mse_wire_cache": ("sparse", {}, dict(panel_cache="wire"), "mse"),
    "mse_panel_cache": ("sparse", {}, dict(panel_cache=True,
                                           sparse_panels=False), "mse"),
    "cv": ("dense", dict(test_fraction=0.15, cv_seed=4, cv_patience=100),
           {}, "cv"),
    "cv_cd": ("dense", dict(test_fraction=0.15, cv_seed=4, cv_patience=100,
                            solver="cd"), {}, "cv"),
    "cv_mask_zeros": ("zeros", dict(test_fraction=0.15, cv_seed=4,
                                    cv_patience=100, mask_zeros=True), {},
                      "cv"),
    "cv_sparse_wire": ("sparse", dict(test_fraction=0.1, cv_seed=7,
                                      cv_patience=100),
                       dict(panel_cache="wire"), "cv"),
    "user_mask": ("dense", dict(has_mask=True), dict(mask=True), "cv"),
    "kl": ("counts", dict(loss="kl"), {}, "irls"),
    "gp_as_kl": ("counts", dict(loss="gp", dispersion="none"), {}, "irls"),
    "nb": ("counts", dict(loss="nb", dispersion="per_row"), {}, "irls"),
    "nb_per_col": ("counts", dict(loss="nb", dispersion="per_col"), {},
                   "irls"),
    "nb_zi_row": ("counts", dict(loss="nb", zi="row"), {}, "irls"),
    "nb_zi_col": ("counts", dict(loss="nb", zi="col", dispersion="per_col"),
                  {}, "irls"),
    "kl_sparse_wire": ("sparse", dict(loss="kl"), dict(panel_cache="wire"),
                       "irls"),
}


def _engine_kwargs(ekw, M):
    ekw = dict(ekw)
    if ekw.pop("graph", None):
        ekw["graph_H"] = _chain_laplacian(M.shape[1])
    if ekw.pop("mask", None):
        ekw["mask"] = np.random.RandomState(8).uniform(size=M.shape) < 0.15
    return ekw


@pytest.mark.parametrize("name", list(FITS))
def test_streaming_fit_matches_the_jax_engine(name, data):
    key, kw, ekw, bar = FITS[name]
    M = data[key]
    ekw = _engine_kwargs(ekw, M)
    cfg_kw = dict(seed=2, maxit=MAXIT, tol=0.0, sort_model=False, **kw)
    ref = ref_chunked.nmf_chunked(ref_loaders.InMemoryLoader(M, chunk_cols=32),
                                  rt.build_config(K, **cfg_kw), **ekw)
    port = nmf_chunked.nmf_chunked(loaders.InMemoryLoader(M, chunk_cols=32),
                                   rtt.build_config(K, **cfg_kw),
                                   device="cpu", **ekw)
    assert port.iterations == ref.iterations == MAXIT
    assert np.isfinite(port.loss_history).all()
    {"mse": lambda: _hold_mse(port, ref, M), "irls": lambda: _hold_irls(
        port, ref), "cv": lambda: _hold_cv(port, ref)}[bar]()


def test_streaming_svd_seeded_fit_matches(data):
    M = data["dense"]
    cfg_kw = dict(seed="lanczos", maxit=MAXIT, tol=0.0, sort_model=False)
    ref = ref_chunked.nmf_chunked(ref_loaders.InMemoryLoader(M, chunk_cols=32),
                                  rt.build_config(K, **cfg_kw))
    port = nmf_chunked.nmf_chunked(loaders.InMemoryLoader(M, chunk_cols=32),
                                   rtt.build_config(K, **cfg_kw),
                                   device="cpu")
    _hold_mse(port, ref, M)


def test_streaming_converges_early_as_the_jax_engine(data):
    """With tol > 0 both stop at the same sweep (on counts, whose loss is
    far above the fp32 cancellation floor, where a relative change would
    be rounding noise)."""
    M = data["counts"]
    cfg_kw = dict(seed=2, maxit=50, tol=1e-3, sort_model=False)
    ref = ref_chunked.nmf_chunked(ref_loaders.InMemoryLoader(M, chunk_cols=32),
                                  rt.build_config(K, **cfg_kw))
    port = nmf_chunked.nmf_chunked(loaders.InMemoryLoader(M, chunk_cols=32),
                                   rtt.build_config(K, **cfg_kw),
                                   device="cpu")
    assert port.converged and ref.converged
    assert port.iterations == ref.iterations < 50
    _hold_mse(port, ref, M)


def _refusal(case, data):
    """(matrix, config keywords, engine keywords) that both engines
    refuse."""
    A, C = data["dense"], data["counts"]
    return {
        "fused_vmem": (A, dict(fused_vmem=True, tol=0), {}),
        "bf16_data": (A, dict(bf16_data=True), {}),
        "symmetric": (A[:, :60] @ A[:, :60].T, dict(symmetric=True), {}),
        "graph_with_cv": (A, dict(test_fraction=0.1, graph_lambda=(0, 0.1),
                                  has_graph_H=True),
                          dict(graph_H=_chain_laplacian(A.shape[1]))),
        "gp_zi": (C, dict(loss="gp", dispersion="per_row", zi="row"), {}),
        "zi_with_cv": (C, dict(loss="nb", zi="row", test_fraction=0.1,
                               cv_seed=1), {}),
        "zi_with_mask_zeros": (C, dict(loss="nb", zi="row",
                                       mask_zeros=True), {}),
        "sparse_panels_of_dense_data": (A, {}, dict(sparse_panels=True)),
        "mask_shape": (A, dict(has_mask=True),
                       dict(mask=np.zeros((3, 3), bool))),
        "checkpoint_every_0": (A, {}, dict(checkpoint_path="unused.npz",
                                           checkpoint_every=0)),
    }[case]


@pytest.mark.parametrize("case", [
    "fused_vmem", "bf16_data", "symmetric", "graph_with_cv", "gp_zi",
    "zi_with_cv", "zi_with_mask_zeros", "sparse_panels_of_dense_data",
    "mask_shape", "checkpoint_every_0"])
def test_refusals_raise_as_the_jax_engine(case, data, tmp_path):
    M, kw, ekw = _refusal(case, data)
    if "checkpoint_path" in ekw:
        ekw["checkpoint_path"] = str(tmp_path / ekw["checkpoint_path"])
    errors = []
    for mod, chunked, build in ((ref_loaders, ref_chunked, rt.build_config),
                                (loaders, nmf_chunked, rtt.build_config)):
        extra = {} if mod is ref_loaders else {"device": "cpu"}
        with pytest.raises(Exception) as exc:
            chunked.nmf_chunked(mod.InMemoryLoader(M, chunk_cols=32),
                                build(K, maxit=3, **kw), **ekw, **extra)
        errors.append(exc.value)
    assert type(errors[0]) is type(errors[1]), errors
    assert str(errors[0]) == str(errors[1])


def test_zi_em_iters_warns_as_the_jax_engine(data):
    cfg_kw = dict(loss="nb", zi="row", maxit=2, tol=0.0, zi_em_iters=4)
    for mod, chunked, build, extra in (
            (ref_loaders, ref_chunked, rt.build_config, {}),
            (loaders, nmf_chunked, rtt.build_config, {"device": "cpu"})):
        with pytest.warns(UserWarning, match="ONE pi EM update"):
            chunked.nmf_chunked(mod.InMemoryLoader(data["counts"],
                                                   chunk_cols=32),
                                build(K, **cfg_kw), **extra)


def test_one_rank_mesh_stream_is_the_single_device_stream(data):
    """On a (1, 1) mesh, where every collective is a no-op, the stream is
    the single-device stream bit for bit, and sparse panels are refused as
    the JAX package refuses them (``tests/test_torch_parallel.py`` holds
    the 8-rank stream in full)."""
    cfg = rtt.build_config(K, maxit=2, tol=0.0)
    one = rtt.default_mesh(devices=["cpu"])
    on_mesh = nmf_chunked.nmf_chunked(
        loaders.InMemoryLoader(data["dense"], chunk_cols=32), cfg, mesh=one)
    plain = nmf_chunked.nmf_chunked(
        loaders.InMemoryLoader(data["dense"], chunk_cols=32), cfg,
        device="cpu")
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(on_mesh, name),
                                      getattr(plain, name), err_msg=name)
    with pytest.raises(ValueError, match="sparse_panels is incompatible"):
        nmf_chunked.nmf_chunked(loaders.InMemoryLoader(data["dense"]), cfg,
                                mesh=one, sparse_panels=True)


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("shape", [None, (2, 2)], ids=["no_mesh", "mesh22"])
def test_panel_blocks_cut_each_panel(shape, transposed):
    """``parallel/mesh.py::PanelBlocks``.  Without a mesh every cut is its
    argument itself (the same storage and strides: a product's operand
    layout selects its kernel and its rounding).  On a (2, 2) mesh (each
    rank's ``Mesh`` built alone: the cut needs no process group) the four
    blocks of a panel tile it and its zero pads; a forward panel's rows
    split over the mesh's rows and its columns over its columns, a
    transposed panel's the other way round."""
    import torch

    from rcppml_tpu_torch.parallel.mesh import Mesh, PanelBlocks, ShardContext
    m, n, k = 7, 23, 3
    cs, nc = (2, 5) if transposed else (10, 5)
    rows, true = (n, m) if transposed else (m, n)   # panel rows, A's columns
    rs = np.random.RandomState(0)
    panel = rs.rand(rows, nc).astype(np.float32) + 1.0
    F = torch.from_numpy(rs.rand(k, rows).astype(np.float32))
    X = torch.from_numpy(rs.rand(k, true).astype(np.float32))
    vec = torch.from_numpy(rs.rand(rows).astype(np.float32))
    if shape is None:
        b = PanelBlocks(ShardContext(None, m, n))
        assert b.block_of(panel, nc, transposed) is panel
        for got, arg in ((b.rows_of(F, transposed), F),
                         (b.rows_of(vec, transposed, 0.5), vec),
                         (b.cols_of(X, cs, nc, transposed), X),
                         (b.whole(X, nc, transposed), X),
                         (b.axis(transposed).sum(X), X)):
            assert got.untyped_storage().data_ptr() == \
                arg.untyped_storage().data_ptr()
            assert got.stride() == arg.stride()
        assert b.cols_of(X, cs, nc, transposed).data_ptr() == \
            X[:, cs:].data_ptr()
        assert b.offsets(cs, nc, transposed) == (0, cs)
        assert b.valid(nc, transposed) is None
        return
    r, c = shape
    rb, pb = -(-rows // (c if transposed else r)), -(-nc // (r if transposed
                                                              else c))
    whole = np.full((2 * rb, 2 * pb), np.nan, np.float32)
    devices = np.empty(shape, object)
    devices[...] = torch.device("cpu")
    for rank in range(r * c):
        b = PanelBlocks(ShardContext(Mesh(devices, rank, {}), m, n))
        ri, ci = divmod(rank, c)
        i, j = (ci, ri) if transposed else (ri, ci)
        r0, c0 = i * rb, j * pb
        vr, vc = min(max(rows - r0, 0), rb), min(max(nc - c0, 0), pb)
        assert b.offsets(cs, nc, transposed) == (r0, cs + c0)
        assert b.valid(nc, transposed) == (vr, vc)
        blk = b.block_of(panel, nc, transposed)
        assert blk.shape == (rb, pb)
        assert np.isnan(whole[r0:r0 + rb, c0:c0 + pb]).all()
        whole[r0:r0 + rb, c0:c0 + pb] = blk
        # the factor table, a vector and a slice of the other factor, cut
        # and padded as the block is
        F_pad = np.zeros((k, 2 * rb), np.float32)
        F_pad[:, :rows] = F.numpy()
        assert np.array_equal(b.rows_of(F, transposed).numpy(),
                              F_pad[:, r0:r0 + rb])
        v_pad = np.full(2 * rb, 0.5, np.float32)
        v_pad[:rows] = vec.numpy()
        assert np.array_equal(b.rows_of(vec, transposed, 0.5).numpy(),
                              v_pad[r0:r0 + rb])
        X_pad = np.zeros((k, 2 * pb), np.float32)
        X_pad[:, :nc] = X.numpy()[:, cs:cs + nc]
        assert np.array_equal(b.cols_of(X, cs, nc, transposed).numpy(),
                              X_pad[:, c0:c0 + pb])
    assert np.array_equal(whole[:rows, :nc], panel)
    pads = np.ones(whole.shape, bool)
    pads[:rows, :nc] = False
    assert (whole[pads] == 0).all()


# ---------------------------------------------------------------------------
# Within the port: panel modes and caches
# ---------------------------------------------------------------------------

def _port_fit(M, ekw=None, chunk_cols=32, **kw):
    cfg = rtt.build_config(5, seed=3, maxit=MAXIT, tol=0.0, sort_model=False,
                           **kw)
    return nmf_chunked.nmf_chunked(loaders.InMemoryLoader(
        M, chunk_cols=chunk_cols), cfg, device="cpu", **(ekw or {}))


def _bitwise(a, b):
    for f in ("W", "d", "H", "loss_history"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# the config keywords of a fit on data["sparse"] (8% dense), or the dense
# cache (on or off) of an auto-ingest fit on a .spz past the 0.15 density
PANEL_CASES = {"cholesky": {}, "cd": dict(solver="cd"),
               "nb": dict(loss="nb", dispersion="per_row"),
               "cv": dict(test_fraction=0.1, cv_seed=2),
               "auto_spz_cached": True, "auto_spz_uncached": False}


@pytest.mark.parametrize("case", list(PANEL_CASES))
def test_sparse_panels_and_panel_cache_are_bitwise_the_dense_stream(
        case, data, tmp_path):
    """Sparse panels, the dense cache and both together are the uncached
    dense-panel stream bit for bit.  On a .spz at 16.5% density the auto
    rule ships the compact panels where the dense cache is on (their bytes
    are below the dense panels'), and the card densifies each forward panel
    once and builds the transposed ones from them; with the cache off it
    keeps the dense panels."""
    kw = PANEL_CASES[case]
    if isinstance(kw, dict):
        S = data["sparse"]
        plain = _port_fit(S, dict(sparse_panels=False, panel_cache=False),
                          **kw)
        _bitwise(_port_fit(S, dict(sparse_panels=True, panel_cache=False),
                           **kw), plain)
        _bitwise(_port_fit(S, dict(sparse_panels=False, panel_cache=True),
                           **kw), plain)
        return
    rs = np.random.RandomState(4)
    m, n = 150, 240
    A = sp.random(m, n, density=0.165, random_state=rs, format="csc",
                  dtype=np.float32)
    A.data = np.ceil(A.data * 200)
    path = str(tmp_path / "dense16.spz")
    rtt.st_write(A, path, chunk_cols=32)
    cfg = rtt.build_config(5, seed=3, maxit=MAXIT, tol=0.0, sort_model=False)

    def fit(**engine):
        return nmf_chunked.nmf_chunked(loaders.SpzLoader(path), cfg,
                                       device="cpu", **engine)
    ld = loaders.SpzLoader(path)
    assert ld.nnz() >= 0.15 * m * n
    cached = kw
    auto = fit() if cached else fit(panel_cache=False)
    st = auto.misc["stream"]
    _bitwise(auto, fit(sparse_panels=False, panel_cache=cached))
    fwd = ld.num_chunks(False)
    if cached:
        compact = sum(sum(x.nbytes for x in (ch.rows, ch.counts, ch.vals))
                      for ch in (_compact_sparse(ld.chunk_coo(c), m)
                                 for c in range(fwd)))
        assert st["upload_bytes"] == compact < 4 * m * n
        assert st["densified"] == st["panels_decoded"] == fwd
        assert st["transposed_on_card"] == ld.num_chunks(True)
    else:
        assert st["densified"] == st["transposed_on_card"] == 0
        assert st["upload_bytes"] == MAXIT * 3 * 4 * m * n


# name: (data, config keywords, engine keywords, whether the loss reads
# tr(A'A) and the panels give it: True (from the first sweep's forward
# panels), False (one pass over the loader, the fallback) or None (no loss
# reads it))
TRACE_CASES = {
    "spz_coo_dense_cache": ("spz", {}, dict(sparse_panels=True,
                                            panel_cache=True), True),
    "spz_coo_wire_cache": ("spz", {}, dict(sparse_panels=True,
                                           panel_cache="wire"), True),
    "spz_coo_uncached": ("spz", {}, dict(sparse_panels=True,
                                         panel_cache=False), True),
    "spz_dense_panels": ("spz", {}, dict(sparse_panels=False), True),
    "spz_v3_dense": ("spz3", {}, {}, True),
    "memory_dense": ("dense", {}, {}, True),
    "memory_sparse_dense_panels": ("sparse", {}, dict(sparse_panels=False),
                                   True),
    "memory_sparse_coo": ("sparse", {}, dict(sparse_panels=True), False),
    "mesh": ("dense", {}, dict(mesh=True), True),
    "resumed": ("spz", {}, dict(resume=True), True),
    "kl": ("spz", dict(loss="kl"), {}, None),
    "cv": ("spz", dict(test_fraction=0.1, cv_seed=2, cv_patience=100), {},
           None),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_comes_from_the_first_sweeps_panels(case, data, tmp_path):
    """The plain MSE loss's tr(A'A) is the sum of the parts the first
    sweep's forward panels give as they are read, in panel order: the fit
    is bit for bit the fit whose tr(A'A) is ``loader.trace_sq()`` (the
    loader made to refuse the parts), and it reads the file once less.
    The in-memory scipy loader's COO panels cannot give the dense blocks'
    sum and keep the pass; IRLS and CV losses read tr(A'A) neither way."""
    key, kw, ekw, from_panels = TRACE_CASES[case]
    ekw = dict(ekw)
    # values whose squares round, so that a sum in another order or
    # precision shows in the loss
    S = data["sparse"].copy()
    S.data = np.random.RandomState(6).uniform(0.1, 3.0, S.nnz).astype(
        np.float32)
    M = S if key in ("spz", "sparse") else data["dense"]
    if key in ("spz", "spz3"):
        path = str(tmp_path / "a.spz")
        if key == "spz":
            rtt.st_write(M, path, chunk_cols=32)
        else:
            rtt.st_write_dense(M, path, chunk_cols=32)

        def make():
            return loaders.SpzLoader(path)
    else:
        def make():
            return loaders.InMemoryLoader(M, chunk_cols=32)
    if ekw.pop("mesh", False):
        ekw["mesh"] = rtt.default_mesh(devices=["cpu"])
    else:
        ekw["device"] = "cpu"
    cfg = rtt.build_config(K, seed=2, maxit=MAXIT, tol=0.0,
                           sort_model=False, **kw)
    ckpts = [None, None]
    if ekw.pop("resume", False):
        ckpts = [str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]
        nmf_chunked.nmf_chunked(
            make(), rtt.build_config(K, seed=2, maxit=3, tol=0.0,
                                     sort_model=False, **kw),
            checkpoint_path=ckpts[0], **ekw)
        with open(ckpts[0], "rb") as f, open(ckpts[1], "wb") as g:
            g.write(f.read())

    def fit(ld, ckpt):
        return nmf_chunked.nmf_chunked(ld, cfg, checkpoint_path=ckpt, **ekw)
    ld = make()
    fwd = ld.num_chunks(False)
    res = fit(ld, ckpts[0])
    passing = make()
    passing.traces_panels = lambda sparse: False
    ref = fit(passing, ckpts[1])
    _bitwise(res, ref)
    st = res.misc["stream"]
    want = {True: (0, fwd), False: (1, 0), None: (0, 0)}[from_panels]
    assert (st["trace_passes"], st["trace_panels"]) == want
    assert ref.misc["stream"]["trace_passes"] == (from_panels is not None)
    assert ref.misc["stream"]["trace_panels"] == 0
    if ckpts[0] is not None:
        assert res.iterations == MAXIT and len(res.loss_history) == MAXIT


@pytest.mark.parametrize("kw", [{}, dict(L1=(0.0, 0.05), solver="cd"),
                                dict(L2=(0.1, 0.0)),
                                dict(test_fraction=0.1, cv_seed=7,
                                     cv_patience=10**6),
                                dict(loss="kl")],
                         ids=["mse", "l1_cd", "l2", "cv", "kl"])
def test_wire_cache_matches_the_uncached_stream(kw):
    """The wire cache's later sweeps (the JAX package's cached sweeps) are
    within 1e-5 of the per-panel stream; the MSE loss there comes from the
    W update's saved matrices."""
    rs = np.random.RandomState(0)
    A = sp.random(300, 500, density=0.05, random_state=rs, format="csc",
                  dtype=np.float32)
    if kw.get("loss") == "kl":
        A.data = np.ceil(A.data * 5)
    off = _port_fit(A, dict(panel_cache=False), chunk_cols=97, **kw)
    wire = _port_fit(A, dict(panel_cache="wire"), chunk_cols=97, **kw)
    assert np.abs(wire.W - off.W).max() < 1e-5
    assert abs(wire.train_loss - off.train_loss) <= \
        1e-5 * abs(off.train_loss)
    if "test_fraction" in kw:
        assert abs(wire.test_loss - off.test_loss) <= \
            1e-5 * abs(off.test_loss)
        assert wire.best_iter == off.best_iter


def test_densify_of_real_spz_chunks(tmp_path):
    """The scatter densify of every chunk ``st_write`` wrote equals the
    loader's host-densified chunk, forward and transposed (a sorted-index
    fast path once dropped entries of real chunks only)."""
    import torch
    g = np.random.RandomState(11)
    m, n = 700, 300
    rows = g.choice(m, 9000)
    cols = g.choice(n, 9000)
    A = sp.csc_matrix((g.geometric(0.4, 9000).astype(np.float32),
                       (rows, cols)), shape=(m, n))
    A.sum_duplicates()
    path = str(tmp_path / "real.spz")
    rtt.st_write(A, path, chunk_cols=64)
    ld = loaders.SpzLoader(path)
    dev = torch.device("cpu")
    for transposed, rows_dim in ((False, m), (True, n)):
        for c in range(ld.num_chunks(transposed)):
            wire = _compact_sparse(ld.chunk_coo(c, transposed), rows_dim)
            got = coo_densify.coo_densify(
                *(upload(x, dev)
                  for x in (wire.rows, wire.counts, wire.vals)), rows_dim)
            assert np.array_equal(got.numpy(), ld.chunk(c, transposed).data)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", ["mse", "nb_zi", "cv"])
def test_port_resume_is_bitwise_the_uninterrupted_stream(fit, data,
                                                         tmp_path):
    M, kw = {"mse": (data["dense"], {}),
             "nb_zi": (data["counts"], dict(loss="nb", zi="row")),
             "cv": (data["dense"], dict(test_fraction=0.1, cv_seed=3,
                                        cv_patience=100))}[fit]
    path = str(tmp_path / "s.npz")

    def run(maxit, ckpt=None):
        cfg = rtt.build_config(K, seed=2, maxit=maxit, tol=0.0,
                               sort_model=False, **kw)
        return nmf_chunked.nmf_chunked(
            loaders.InMemoryLoader(M, chunk_cols=32), cfg,
            checkpoint_path=ckpt, checkpoint_every=2, device="cpu")
    whole = run(8)
    run(3, path)
    resumed = run(8, path)
    _bitwise(resumed, whole)
    for f in ("test_loss_history", "pi_row", "theta"):
        a, b = getattr(resumed, f), getattr(whole, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert resumed.best_iter == whole.best_iter


@pytest.mark.parametrize("fit", ["mse", "kl"])
def test_jax_stream_state_resumes_in_the_port(fit, data, tmp_path):
    M, kw, hold = {"mse": (data["dense"], {}, "mse"),
                   "kl": (data["counts"], dict(loss="kl"), "irls")}[fit]
    path = str(tmp_path / "s.npz")
    cfg_kw = dict(seed=2, tol=0.0, sort_model=False, **kw)
    ref_chunked.nmf_chunked(ref_loaders.InMemoryLoader(M, chunk_cols=32),
                            rt.build_config(K, maxit=3, **cfg_kw),
                            checkpoint_path=path)
    port = nmf_chunked.nmf_chunked(
        loaders.InMemoryLoader(M, chunk_cols=32),
        rtt.build_config(K, maxit=8, **cfg_kw), checkpoint_path=path,
        device="cpu")
    ref = ref_chunked.nmf_chunked(ref_loaders.InMemoryLoader(M, chunk_cols=32),
                                  rt.build_config(K, maxit=8, **cfg_kw))
    if hold == "mse":
        _hold_mse(port, ref, M)
    else:
        _hold_irls(port, ref)
    # and the file the port wrote loads in the JAX package, equal
    mine, theirs = (ck.load_stream_state(path, rtt.build_config(
        K, maxit=8, **cfg_kw)), ref_ck.load_stream_state(
        path, rt.build_config(K, maxit=8, **cfg_kw)))
    assert sorted(mine) == sorted(theirs)
    for key, val in theirs.items():
        if isinstance(val, np.ndarray):
            assert np.array_equal(mine[key], val), key
        else:
            assert mine[key] == val, key


def test_stream_state_config_mismatch_raises_as_the_jax_package(data,
                                                                tmp_path):
    path = str(tmp_path / "s.npz")
    M = data["dense"]
    nmf_chunked.nmf_chunked(loaders.InMemoryLoader(M, chunk_cols=32),
                            rtt.build_config(K, seed=2, maxit=2),
                            checkpoint_path=path, device="cpu")
    errors = []
    for load, build in ((ck.load_stream_state, rtt.build_config),
                        (ref_ck.load_stream_state, rt.build_config)):
        with pytest.raises(ValueError) as exc:
            load(path, build(K, seed=3, maxit=2))
        errors.append(str(exc.value))
        with pytest.raises(ValueError, match="already has 2 sweeps"):
            load(path, build(K, seed=2, maxit=1))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Streaming SVD and projection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spectrum_spz(tmp_path_factory):
    """A 90 x 140 matrix with a separated spectrum (8, 6.4, 5.1, ...) plus a
    little noise, written with ``st_write``."""
    rs = np.random.RandomState(12)
    U, _ = np.linalg.qr(rs.normal(size=(90, 6)))
    V, _ = np.linalg.qr(rs.normal(size=(140, 6)))
    d = 8.0 * 0.8 ** np.arange(6)
    A = ((U * d) @ V.T + 0.01 * rs.normal(size=(90, 140))).astype(np.float32)
    path = str(tmp_path_factory.mktemp("svd") / "a.spz")
    ref_spz.st_write(sp.csc_matrix(A), path, value_type="float32",
                     chunk_cols=32)
    return path, A


def _aligned(X, Y):
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    signs = np.sign((X * Y).sum(axis=0))
    return np.abs(X * signs - Y).max()


@pytest.mark.parametrize("method,kw", [
    ("randomized", {}), ("randomized", dict(center=True)),
    ("lanczos", {}), ("lanczos", dict(center=True)), ("irlba", {}),
    ("krylov", {}), ("krylov", dict(nonneg=True)),
    ("deflation", {}), ("deflation", dict(nonneg=(True, False))),
    ("deflation", dict(robust=True))])
def test_streaming_svd_matches_the_jax_package(method, kw, spectrum_spz):
    path, _ = spectrum_spz
    ref = ref_svd.streaming_svd(path, 4, method=method, seed=1, **kw)
    port = rtt.streaming_svd(path, 4, method=method, seed=1, device="cpu",
                             **kw)
    if method == "deflation":
        np.testing.assert_allclose(port.d, ref.d, rtol=1e-3)
    else:
        np.testing.assert_allclose(port.d, ref.d, rtol=1e-4)
    if method != "deflation" or not kw:
        assert _aligned(port.U, ref.U) < 1e-3
        assert _aligned(port.V, ref.V) < 1e-3
    if kw.get("center"):
        np.testing.assert_allclose(port.center, ref.center, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["randomized", "lanczos", "irlba",
                                    "deflation"])
def test_svd_gateway_streams_a_spz_path(method, spectrum_spz):
    path, A = spectrum_spz
    ref = rt.svd(path, 4, method=method)
    port = rtt.svd(path, 4, method=method, device="cpu")
    np.testing.assert_allclose(port.d, ref.d, rtol=1e-3)
    # and against the in-memory decomposition of the same matrix
    np.testing.assert_allclose(port.d, np.linalg.svd(A, compute_uv=False)[:4],
                               rtol=1e-3)


def test_pca_of_a_spz_path(spectrum_spz):
    path, _ = spectrum_spz
    ref, port = rt.pca(path, 3, method="lanczos"), rtt.pca(
        path, 3, method="lanczos", device="cpu")
    np.testing.assert_allclose(port.d, ref.d, rtol=1e-4)
    np.testing.assert_allclose(port.misc["sdev"], ref.misc["sdev"],
                               rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(scale=True), dict(L21=0.1),
                                dict(test_fraction=0.1)])
def test_svd_spz_refusals_as_the_jax_package(kw, spectrum_spz):
    path, _ = spectrum_spz
    errors = []
    for fn, extra in ((rt.svd, {}), (rtt.svd, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            fn(path, 3, **kw, **extra)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("source", ["spz", "dense", "loader"])
def test_nnls_streaming_matches(source, spectrum_spz):
    path, A = spectrum_spz
    A = np.abs(A)
    W = np.abs(np.random.RandomState(13).rand(A.shape[0], 5)).astype(
        np.float32)
    if source == "spz":
        p = path.replace("a.spz", "abs.spz")
        ref_spz.st_write(sp.csc_matrix(A), p, value_type="float32",
                         chunk_cols=32)
        ref_in, port_in = p, p
    elif source == "dense":
        ref_in, port_in = A, A
    else:
        ref_in = ref_loaders.InMemoryLoader(A, chunk_cols=25)
        port_in = loaders.InMemoryLoader(A, chunk_cols=25)
    ref = ref_project.nnls_streaming(ref_in, W, chunk_cols=30)
    port = rtt.nnls_streaming(port_in, W, chunk_cols=30, device="cpu")
    scale = np.abs(ref).max()
    assert np.abs(port - ref).max() <= 1e-5 * scale
    whole = rtt.nnls(A, w=W, device="cpu")
    assert np.abs(port - whole).max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# API dispatch
# ---------------------------------------------------------------------------

def test_nmf_of_a_spz_path(data, tmp_path):
    path = str(tmp_path / "a.spz")
    rtt.st_write(data["sparse"], path, chunk_cols=32)
    ref = rt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, sort_model=False)
    port = rtt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, sort_model=False,
                   device="cpu")
    _hold_mse(port, ref, data["sparse"])
    ref = rt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, test_fraction=0.2,
                 cv_seed=5, mask_zeros=True)
    port = rtt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, test_fraction=0.2,
                   cv_seed=5, mask_zeros=True, device="cpu")
    _hold_cv(port, ref)


def test_nmf_of_a_v3_dense_spz_path(data, tmp_path):
    path = str(tmp_path / "d.spz")
    rtt.st_write_dense(data["dense"], path, chunk_cols=32)
    ref = rt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, sort_model=False)
    port = rtt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, sort_model=False,
                   device="cpu")
    _hold_mse(port, ref, data["dense"])


@pytest.mark.parametrize("kind", ["dense", "sparse", "nan"])
def test_nmf_streaming_true(kind, data):
    M = {"dense": data["dense"], "sparse": data["sparse"],
         "nan": np.where(data["dense"] > 0.9, np.nan, data["dense"])}[kind]
    kw = dict(seed=1, maxit=MAXIT, tol=0, sort_model=False, streaming=True,
              chunk_cols=40)
    if kind == "nan":
        with pytest.warns(UserWarning, match="NA values"):
            ref = rt.nmf(M, K, **kw)
        with pytest.warns(UserWarning, match="NA values"):
            port = rtt.nmf(M, K, device="cpu", **kw)
        _hold_cv(port, ref)
        return
    _hold_mse(rtt.nmf(M, K, device="cpu", **kw), rt.nmf(M, K, **kw), M)


def test_streaming_nan_contracts_as_the_jax_package(data, tmp_path):
    S = data["sparse"].copy()
    S.data[3] = np.nan
    A = data["dense"]
    bad = S.copy()
    bad.data[3] = np.inf
    for M, kw in ((S, {}), (bad, {}), (A, dict(mask="NA"))):
        errors = []
        for fn, extra in ((rt.nmf, {}), (rtt.nmf, {"device": "cpu"})):
            with pytest.raises(ValueError) as exc:
                fn(M, K, maxit=2, streaming=True, **kw, **extra)
            errors.append(str(exc.value))
        assert errors[0] == errors[1]
    # a NaN inside a .spz file is found on the first sweep
    path = str(tmp_path / "nan.spz")
    ref_spz.st_write(S, path, value_type="float32", chunk_cols=32)
    errors = []
    for fn, extra in ((rt.nmf, {}), (rtt.nmf, {"device": "cpu"})):
        with pytest.raises(ValueError) as exc:
            fn(path, K, maxit=2, **extra)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "non-finite" in errors[0]


def test_nmf_switches_to_streaming_when_the_card_cannot_hold_A(
        data, monkeypatch):
    """A host matrix over the card's memory (2x headroom) streams; with
    ``device_hbm_bytes`` patched small, as the JAX package is tested.  The
    card is only pretended for the dispatch decision: the fit itself is
    sent to the CPU."""
    import torch
    A = data["dense"]
    kw = dict(seed=1, maxit=MAXIT, tol=0, sort_model=False)
    calls = []
    real = api._nmf_streaming

    def on_cpu(*args, **kwargs):
        calls.append(args[2])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        return real(*args, **dict(kwargs, device="cpu"))
    monkeypatch.setattr(memory, "device_hbm_bytes", lambda: 4 * A.size)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "_nmf_streaming", on_cpu)
    port = rtt.nmf(A, K, **kw)
    assert calls == [False]
    ref = rt.nmf(A, K, streaming=True, **kw)
    _hold_mse(port, ref, A)
    # GP zero inflation needs the whole matrix: no switch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(Exception):
        rtt.nmf(data["counts"], K, loss="gp", zi="row", maxit=1)
    assert calls == [False]


def test_other_paths_load_in_memory(data, tmp_path):
    path = str(tmp_path / "a.npy")
    np.save(path, data["dense"])
    ref = rt.nmf(path, K, seed=1, maxit=MAXIT, tol=0)
    port = rtt.nmf(path, K, seed=1, maxit=MAXIT, tol=0, device="cpu")
    _hold_mse(port, ref, data["dense"])


def test_streaming_callback_and_checkpoint_through_the_api(data, tmp_path):
    seen = []
    path = str(tmp_path / "ck.npz")
    res = rtt.nmf(data["dense"], K, streaming=True, maxit=3, tol=0,
                  checkpoint_path=path, device="cpu",
                  on_iteration=lambda *a: seen.append(a))
    assert [s[0] for s in seen] == [1, 2, 3]
    assert [s[1] for s in seen] == list(res.loss_history)
    assert os.path.exists(path)


@pytest.mark.parametrize("mode", ["dense_cache", "sparse_dense_cache",
                                  "wire", "uncached"])
def test_caches_decode_each_panel_once(mode, data):
    """A cached stream decodes each panel once (the first sweep; the loss
    pass and later sweeps read the cache), and the dense cache only the
    forward panels (the transposed ones are built from them); an uncached
    one decodes every panel of both sides and the forward panels again for
    the loss, every sweep.  Besides, tr(A'A) reads the forward panels once before the
    first sweep where they travel as COO, whose parts this loader cannot
    give; the dense panels give it as the first sweep reads them."""
    S = data["sparse"]
    ekw = {"dense_cache": dict(sparse_panels=False, panel_cache=True),
           "sparse_dense_cache": dict(sparse_panels=True, panel_cache=True),
           "wire": dict(sparse_panels=True, panel_cache="wire"),
           "uncached": dict(sparse_panels=True, panel_cache=False)}[mode]
    ld = loaders.InMemoryLoader(S, chunk_cols=32)
    calls = []
    for name in ("chunk", "chunk_coo"):
        real = getattr(ld, name)
        setattr(ld, name, lambda c, t=False, real=real: (
            calls.append((c, t)), real(c, t))[1])
    fwd, trp = ld.num_chunks(False), ld.num_chunks(True)
    res = nmf_chunked.nmf_chunked(ld, rtt.build_config(K, maxit=3, tol=0),
                                  device="cpu", **ekw)
    assert res.iterations == 3
    want = {"dense_cache": fwd, "sparse_dense_cache": fwd,
            "wire": fwd + trp, "uncached": 3 * (2 * fwd + trp)}[mode]
    passes = 0 if mode == "dense_cache" else 1
    assert res.misc["stream"]["trace_passes"] == passes
    assert len(calls) == passes * fwd + want
    assert res.misc["stream"]["transposed_on_card"] == \
        (trp if "dense_cache" in mode else 0)


# ---------------------------------------------------------------------------
# Transposed panels built from the cached forward panels
# ---------------------------------------------------------------------------

class _Withheld:
    """Another loader's panels, without its guarantee that the transposed
    panels are the forward panels' exact transposes."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def exact_transpose(self):
        return False


def _counts_matrix(m, n, top, seed, fractional=False):
    """A sparse (m, n) CSC matrix at 16.5% density with values in
    [1, top] (a fraction added where ``fractional``)."""
    rs = np.random.RandomState(seed)
    S = sp.random(m, n, density=0.165, random_state=rs, format="csc",
                  dtype=np.float32)
    S.data = np.ceil(S.data * top)
    if fractional:
        S.data += rs.uniform(0.01, 0.99, S.nnz).astype(np.float32)
    return S


# name: (how the loader's file or matrix is made, the loader's value type:
# the v2 type st_write names, "raw" for v3, None in memory)
EXACT_LOADERS = {
    "spz_uint8": ("spz", dict(top=200), "uint8"),
    "spz_uint16": ("spz", dict(top=60000), "uint16"),
    "spz_float32": ("spz", dict(top=50, fractional=True), "float32"),
    "spz_float16": ("spz", dict(top=50, fractional=True), "float16"),
    "spz3_raw": ("spz3", dict(top=50, fractional=True), "raw"),
    "memory_sparse": ("sparse", dict(top=50, fractional=True), None),
    "memory_dense": ("dense", dict(top=50, fractional=True), None),
}


def _exact_loader(case, tmp_path, m=90, n=140):
    kind, mk, vt = EXACT_LOADERS[case]
    S = _counts_matrix(m, n, seed=13, **mk)
    path = str(tmp_path / f"{case}.spz")
    if kind == "spz":
        rtt.st_write(S, path, chunk_cols=32, value_type=vt)
        return loaders.SpzLoader(path)
    if kind == "spz3":
        rtt.st_write_dense(S.toarray(), path, chunk_cols=32)
        return loaders.SpzLoader(path)
    return loaders.InMemoryLoader(S if kind == "sparse" else S.toarray(),
                                  chunk_cols=32)


@pytest.mark.parametrize("case", list(EXACT_LOADERS))
def test_transposed_panels_from_the_forward_cache_are_the_loaders(
        case, tmp_path):
    """Once the dense cache holds every forward panel, each transposed
    panel the panel source builds from them equals, bit for bit, the panel
    the loader decodes, at the place the loader gives without a decode; no
    transposed panel is read."""
    import torch
    from rcppml_tpu_torch.io.panels import PanelSource, _FromForward
    from rcppml_tpu_torch.parallel.mesh import PanelBlocks, ShardContext
    ld = _exact_loader(case, tmp_path)
    m, n = ld.shape
    assert ld.exact_transpose()
    if case.startswith("spz") and case != "spz3_raw":
        assert ld.reader.info["value_type"] == EXACT_LOADERS[case][2]
    for t in (False, True):
        for c in range(ld.num_chunks(t)):
            ch = ld.chunk(c, t)
            assert ld.chunk_place(c, t) == (ch.col_start, ch.num_cols)
    src = PanelSource(ld, PanelBlocks(ShardContext(None, m, n)),
                      torch.device("cpu"), panel_cache=True)
    for ch in src.panels(False):
        src.put(ch, False)
    built = [(ch, src.put(ch, True)) for ch in src.panels(True)]
    assert len(built) == ld.num_chunks(True)
    for c, (ch, panel) in enumerate(built):
        assert isinstance(ch, _FromForward)
        want = ld.chunk(c, True).data
        assert panel.shape == want.shape
        assert np.array_equal(panel.numpy().view(np.int32),
                              np.ascontiguousarray(want).view(np.int32))
    st = src.stream
    assert st["transposed_on_card"] == ld.num_chunks(True)
    assert st["panels_decoded"] == ld.num_chunks(False)
    assert src.full(True)


# name: (loader, engine keywords, transposed reads a fit of MAXIT sweeps
# makes: the transposed panels once, or every sweep)
OFF_CASES = {
    "quant8": ("quant8", {}, 1),
    "mesh": ("spz", dict(mesh=True), 1),
    "wire": ("spz", dict(panel_cache="wire", sparse_panels=True), 1),
    "uncached": ("spz", dict(panel_cache=False), MAXIT),
    "undeclared": ("withheld", {}, 1),
}


@pytest.mark.parametrize("case", list(OFF_CASES))
def test_transposed_panels_are_read_where_the_rule_is_off(case, tmp_path):
    """No transposed panel is built from the forward ones, and the
    transpose stream is read as before, for a quant8 file (its two streams
    round apart), a mesh stream, the wire cache, no cache, and a loader
    that does not declare the guarantee."""
    kind, ekw, reads = OFF_CASES[case]
    S = _counts_matrix(90, 140, 200, 14)
    path = str(tmp_path / "a.spz")
    rtt.st_write(S, path, chunk_cols=32,
                 value_type="quant8" if kind == "quant8" else "auto")
    ld = loaders.SpzLoader(path)
    assert ld.exact_transpose() == (kind != "quant8")
    if kind == "withheld":
        ld = _Withheld(ld)
    calls = []
    for name in ("chunk", "chunk_coo"):
        real = getattr(ld, name)
        setattr(ld, name, lambda c, t=False, real=real: (
            calls.append(t), real(c, t))[1])
    ekw = dict(ekw)
    if ekw.pop("mesh", False):
        ekw["mesh"] = rtt.default_mesh(devices=["cpu"])
    else:
        ekw["device"] = "cpu"
    res = nmf_chunked.nmf_chunked(
        ld, rtt.build_config(K, maxit=MAXIT, tol=0.0), **ekw)
    assert res.misc["stream"]["transposed_on_card"] == 0
    assert calls.count(True) == reads * ld.num_chunks(True)


@pytest.mark.parametrize("source", ["spz", "memory_sparse"])
@pytest.mark.parametrize("fit", ["mse", "kl", "cv"])
def test_stream_fits_with_transposed_panels_built_on_the_device(fit, source,
                                                                 tmp_path):
    """MSE, KL and CV streams whose transposed panels come from the cached
    forward panels are, bit for bit, the same fits through a loader that
    withholds the guarantee (and so reads its transpose stream)."""
    kw = {"mse": {}, "kl": dict(loss="kl"),
          "cv": dict(test_fraction=0.1, cv_seed=3, cv_patience=100)}[fit]
    S = _counts_matrix(90, 140, 9, 15)
    if source == "spz":
        path = str(tmp_path / "a.spz")
        rtt.st_write(S, path, chunk_cols=32)

        def make():
            return loaders.SpzLoader(path)
    else:
        def make():
            return loaders.InMemoryLoader(S, chunk_cols=32)
    cfg = rtt.build_config(K, seed=2, maxit=MAXIT, tol=0.0,
                           sort_model=False, **kw)
    built = nmf_chunked.nmf_chunked(make(), cfg, device="cpu",
                                    panel_cache=True)
    read = nmf_chunked.nmf_chunked(_Withheld(make()), cfg, device="cpu",
                                   panel_cache=True)
    _bitwise(built, read)
    if fit == "cv":
        assert np.array_equal(built.test_loss_history,
                              read.test_loss_history)
    trp = make().num_chunks(True)
    assert built.misc["stream"]["transposed_on_card"] == trp
    assert read.misc["stream"]["transposed_on_card"] == 0
    assert read.misc["stream"]["panels_decoded"] == \
        built.misc["stream"]["panels_decoded"] + trp
