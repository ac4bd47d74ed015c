"""The port's device mesh against the JAX package's, on the CPU.

The JAX package runs its sharded fits on its 8 virtual CPU devices
(``tests/conftest.py``).  The port runs one process per rank: a fixture
starts 8 gloo ranks once for the module (``tests/torch_mesh_worker.py``),
which run every case of ``worker.CASES`` and the special cases and write
each rank's result under ``tmp_path``; the fixture joins them with a
timeout of its own, kills them past it and fails with their logs.

Each case's rank-0 result is held against the JAX package's sharded fit on
the same mesh shape and against the port's own single-device fit, with the
bars of ``tests/test_parallel.py``: the MSE loss within 1e-6 tr(A'A) (the
Gram-trick loss is a difference of O(tr(A'A)) float32 terms), W within
rtol 2e-3 / atol 2e-4, IRLS losses within rtol 1e-5, CV test losses within
rtol 1e-4.  A sharded fit adds each sum's block partials in rank order,
and two fits carry that last-bit difference further:

  * with ``bf16_data`` a last-bit difference in a factor can round it to
    another bfloat16 value (twenty-odd times the bars above after eight
    iterations): the single-device fit it is held to is the one with its
    sums made in the mesh's order (``tests/torch_mesh_order.py``), with the
    bars above; against the JAX package's sharded fit the loss is held
    within the bar the port's single-device tests hold bfloat16 fits to the
    JAX package's (rtol 1e-2 plus 2^-8 tr(A'A); the two packages round the
    products' operands apart), W to the bar above;
  * the graph-regularized fit is held at graph_lambda 0.1: at 0.5 the loss
    moves 1.4e-6 tr(A'A) on one device when only the Gram's sum is split in
    two halves, as a mesh splits it.

The MSE and IRLS fits whose every sum is a Gram, a right-hand side or a row
norm (``MESH_ORDER_CASES``) are the single-device fit in the mesh's order
bit for bit: W, d and H.

Two of the JAX package's sharded fits part from its own single-device
fits, and the port follows the single-device fits there
(``test_jax_sharded_fits_part_from_their_single_device_fits``): its
``fit_sharded`` takes no graph Laplacian (it passes an empty ``aux``), and
its sharded CV fit averages a global dispersion over the mesh's pad rows
too.  Those two cases are held to its single-device fit, and so is the
symmetric case (its padded W and H differ in width there).
Every other rank's result must equal rank 0's bit for bit: each rank
returns the whole result.  A (1, 1) mesh is the plain fit bit for bit.

The same ranks then run the mesh's three consumers (``worker.CONSUMERS``)
on the JAX package's mesh tests' shapes, which do not divide a (2, 4)
mesh (``tests/test_mesh_streaming.py``, ``tests/test_graph.py``):

  * checkpointed mesh fits (MSE with both solvers, KL, NB + ZI by row)
    resume bit for bit as the uninterrupted sharded fit, write the JAX
    package's file (its keys, padded shapes and ``mesh_shape``), resume a
    file the JAX package wrote on the same mesh within the bars above, and
    refuse another mesh shape, a file without one and graph auxiliaries;
  * sharded streams (MSE, CV, NB + ZI, a ``.spz`` path, a resumed stream
    checkpoint) are held to the port's single-device stream and to the
    JAX package's mesh stream with that test's bars: W and H within
    1e-4, the loss within 1e-3 of itself, the CV test loss within 1e-4,
    the ZI dropouts within 1e-4;
  * graph nets under a mesh (two modalities through ``Shared``, a
    ``Condition`` in both orientations of Z) are held to the single-device
    net with ``tests/test_graph.py``'s bars (W within 1e-4 and 1e-5) and to
    the JAX package's mesh net within the bars ``tests/test_torch_graph.py``
    holds the two packages' nets to (2e-3 of the largest entry).
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rcppml_tpu as rt
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.models import nmf_cv as ref_cv
from rcppml_tpu.models import nmf_irls as ref_irls
from rcppml_tpu.parallel import mesh as ref_mesh

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.models import nmf as port_nmf
from rcppml_tpu_torch.models import nmf_cv, nmf_irls
from rcppml_tpu_torch.parallel import mesh as port_mesh
from rcppml_tpu_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_worker as worker  # noqa: E402
from torch_mesh_order import mesh_order_fit  # noqa: E402

RANKS = worker.WORLD
RUN_TIMEOUT_S = 240.0
LOSS_TR = 1e-6
W_RTOL, W_ATOL = 2e-3, 2e-4
IRLS_RTOL = 1e-5
CV_RTOL = 1e-4
THETA_RTOL = 5e-3


def _run_ranks(script, n, out_dir, args_of, timeout):
    """Start ``n`` processes of ``script``, join them within ``timeout``
    seconds (killing every one past it) and fail with their logs unless all
    exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), *args_of(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    logs, timed_out = [], False
    for p in procs:
        try:
            log, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if timed_out or any(p.returncode != 0 for p in procs):
        pytest.fail(("ranks timed out after %.0f s\n" % timeout if timed_out
                     else "a rank failed\n") + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))


def _consumer_files(out):
    """The files the consumer cases read: checkpoints the JAX package wrote
    half way on a (2, 4) mesh (a copy of each kept, since the ranks resume
    them in place), a port checkpoint written without a mesh, and the
    ``.spz`` file of the stream case."""
    import scipy.sparse as sp
    for case, src in worker.JAX_RESUME.items():
        data, kw, every, half = worker.CKPT[src]
        kw = dict(kw)
        k = kw.pop("k")
        path = out / f"{case}.npz"
        rt.nmf(worker.consumer_data(data)["A"], k, mesh=_jax_mesh((2, 4)),
               checkpoint_path=str(path), checkpoint_every=every,
               **dict(kw, maxit=half))
        shutil.copy(path, out / f"{case}.orig.npz")
    rtt.nmf(worker.consumer_data("rand61")["A"], 4, seed=42, maxit=5,
            tol=0.0, sort_model=False, checkpoint_path=str(
                out / "no_mesh.npz"), device="cpu")
    rtt.st_write(sp.csc_matrix(worker.consumer_data("sparse67")["A"]),
                 str(out / "sparse67.spz"), chunk_cols=worker.STREAM_CHUNK)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 gloo ranks' results: a directory of ``<case>.r<rank>.npz``."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    _consumer_files(out)
    store = out / "store"
    _run_ranks("torch_mesh_worker.py", RANKS, out,
               lambda r: [str(r), str(RANKS), str(store), str(out)],
               RUN_TIMEOUT_S)
    return out


def _result(out, case, rank=0) -> dict:
    with np.load(out / f"{case}.r{rank}.npz") as z:
        return {name: z[name] for name in z.files}


def _kind(case) -> str:
    _, _, entry, kw = worker.CASES[case]
    if entry == "cv" or kw.get("test_fraction"):
        return "cv"
    return "irls" if kw.get("loss", "mse") != "mse" else "mse"


def _inputs(case):
    data, shape, entry, kw = worker.CASES[case]
    kw = dict(kw)
    return worker.case_data(data), shape, entry, kw.pop("k"), kw


def _jax_mesh(shape):
    devs = jax.devices()[:shape[0] * shape[1]]
    return ref_mesh.default_mesh(devs, shape)


def _graph_aux(inputs):
    return {key: inputs[key] for key in ("graph_W", "graph_H")
            if key in inputs}


def _port_single(case):
    inputs, _, entry, k, kw = _inputs(case)
    A = inputs["A"]
    if entry == "cv":
        dd = kw.pop("use_downdate", False)
        return nmf_cv.fit_cv_or_masked(A, rtt.build_config(k, **kw),
                                       mask=inputs.get("mask"), device="cpu",
                                       use_downdate=dd)
    if entry == "nmf":
        return rtt.nmf(A, k, graph_W=inputs.get("graph_W"),
                       graph_H=inputs.get("graph_H"), device="cpu", **kw)
    return port_nmf.nmf_fit(A, rtt.build_config(k, **kw), device="cpu")


def _jax_reference(case):
    """The JAX package's sharded fit of the case on the same mesh shape; its
    single-device fit for the graph and symmetric cases."""
    inputs, shape, entry, k, kw = _inputs(case)
    A = inputs["A"]
    if case == "graph":
        cfg = rt.build_config(k, has_graph_W=True, has_graph_H=True, **kw)
        return ref_nmf.nmf_fit(A, cfg, aux=_graph_aux(inputs))
    if case == "symmetric":
        return ref_nmf.nmf_fit(A, rt.build_config(k, **kw))
    if case == "cv_gp_global":
        return ref_cv.fit_cv_or_masked(A, rt.build_config(k, **kw))
    mesh = _jax_mesh(shape)
    if entry == "cv":
        dd = kw.pop("use_downdate", False)
        return ref_cv.fit_cv_or_masked(A, rt.build_config(k, **kw),
                                       mask=inputs.get("mask"), mesh=mesh,
                                       use_downdate=dd)
    if entry == "nmf":
        return rt.nmf(A, k, mesh=mesh, **kw)
    return ref_mesh.fit_sharded(A, rt.build_config(k, **kw), mesh)


def _assert_close(case, got: dict, ref, jax_ref: bool = False):
    """``got`` (a rank's saved result) against a reference result (the JAX
    package's with ``jax_ref``), with the case's bars."""
    inputs = _inputs(case)[0]
    A = inputs["A"].astype(np.float64)
    ref_W = np.asarray(ref.W)
    assert got["W"].shape == ref_W.shape
    assert int(got["iterations"]) == int(ref.iterations)
    kind = _kind(case)
    if kind in ("cv", "irls"):
        if kind == "cv":
            np.testing.assert_allclose(float(got["test_loss"]),
                                       float(ref.test_loss), rtol=CV_RTOL)
        else:
            np.testing.assert_allclose(float(got["train_loss"]),
                                       float(ref.train_loss), rtol=IRLS_RTOL)
        np.testing.assert_allclose(got["W"], ref_W, rtol=W_RTOL, atol=W_ATOL)
        for name in ("theta", "dispersion", "pi_row", "pi_col"):
            r = getattr(ref, name, None)
            assert (name in got) == (r is not None), name
            if r is not None:
                np.testing.assert_allclose(got[name], np.asarray(r),
                                           rtol=THETA_RTOL, err_msg=name)
    else:
        tr = float((A * A).sum())
        if case == "bf16" and jax_ref:
            allow = 1e-2 * abs(float(ref.train_loss)) + 2.0 ** -8 * tr
        else:
            allow = LOSS_TR * tr
        assert abs(float(got["train_loss"]) - float(ref.train_loss)) < allow
        np.testing.assert_allclose(got["W"], ref_W, rtol=W_RTOL, atol=W_ATOL)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_sharded_fit_matches_jax_sharded_fit(ranks, case):
    _assert_close(case, _result(ranks, case), _jax_reference(case),
                  jax_ref=True)


# cases whose fit turns the last bit of a sum further than the bars: held to
# the single-device fit with its sums in the mesh's order
ORDER_SENSITIVE = ("bf16",)
# cases whose every sum mesh_order_fit makes in the mesh's order
MESH_ORDER_CASES = ("fit", "fit_cd", "shape_1x8", "shape_2x4", "shape_4x2",
                    "shape_8x1", "l1", "nondiv", "bf16", "nondiv_gp", "irls")


def _mesh_order_single(case):
    inputs, shape, entry, k, kw = _inputs(case)
    assert entry == "sharded"
    A = torch.from_numpy(np.asarray(inputs["A"], np.float32))
    return mesh_order_fit(A, rtt.build_config(k, **kw), shape)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_sharded_fit_matches_single_device_fit(ranks, case):
    ref = (_mesh_order_single(case) if case in ORDER_SENSITIVE
           else _port_single(case))
    _assert_close(case, _result(ranks, case), ref)


@pytest.mark.parametrize("case", MESH_ORDER_CASES)
def test_sharded_fit_is_the_single_device_fit_in_mesh_order(ranks, case):
    got, ref = _result(ranks, case), _mesh_order_single(case)
    assert int(got["iterations"]) == ref.iterations
    for name in "WdH":
        np.testing.assert_array_equal(got[name], getattr(ref, name),
                                      err_msg=name)
    _assert_close(case, got, ref)


@pytest.mark.parametrize("case", list(worker.CASES) + ["device_input"]
                         + list(worker.CONSUMERS))
def test_every_rank_returns_the_whole_result(ranks, case):
    first = _result(ranks, case)
    for rank in range(1, RANKS):
        other = _result(ranks, case, rank)
        assert sorted(other) == sorted(first)
        for name in first:
            if name == "block_ok":
                continue
            np.testing.assert_array_equal(other[name], first[name],
                                          err_msg=f"rank {rank}: {name}")


# ---------------------------------------------------------------------------
# The counterparts of tests/test_parallel.py's other tests
# ---------------------------------------------------------------------------

def test_jax_sharded_fits_part_from_their_single_device_fits():
    """The two differences from the JAX package that these tests show
    (ROADMAP.md queue 3): its sharded fit drops the graph Laplacians, and
    its sharded CV fit counts the pad rows in a global dispersion.  The
    port's sharded fits of both cases equal its single-device fits
    (``test_sharded_fit_matches_single_device_fit[graph]`` and
    ``[cv_gp_global]``)."""
    inputs, shape, _, k, kw = _inputs("graph")
    mesh = _jax_mesh(shape)
    with_graph = rt.nmf(inputs["A"], k, mesh=mesh,
                        graph_W=inputs["graph_W"], graph_H=inputs["graph_H"],
                        **kw)
    plain_kw = {key: v for key, v in kw.items() if key != "graph_lambda"}
    without = rt.nmf(inputs["A"], k, mesh=mesh, **plain_kw)
    np.testing.assert_array_equal(with_graph.W, without.W)
    assert not np.array_equal(with_graph.W, _jax_reference("graph").W)

    inputs, shape, _, k, kw = _inputs("cv_gp_global")
    cfg = rt.build_config(k, **kw)
    sharded = ref_cv.fit_cv_or_masked(inputs["A"], cfg, mesh=_jax_mesh(shape))
    single = ref_cv.fit_cv_or_masked(inputs["A"], cfg)
    assert abs(sharded.theta[0] / single.theta[0] - 1) > THETA_RTOL


def test_eight_ranks(ranks):
    """The 8 virtual devices of the JAX tests are 8 processes here."""
    got = _result(ranks, "info")
    assert int(got["process_count"]) == int(got["global_devices"]) == RANKS
    assert len(jax.devices()) == RANKS


def test_default_mesh_shape(ranks):
    got = _result(ranks, "info")
    assert int(got["mesh_size"]) == RANKS
    assert set(got["axis_names"].tolist()) == {"rows", "cols"}
    assert tuple(got["mesh_shape"]) == tuple(
        ref_mesh.default_mesh().devices.shape) == (2, 4)


@pytest.mark.parametrize("case", ["shape_1x8", "shape_2x4", "shape_4x2",
                                  "shape_8x1"])
def test_sharded_mesh_shapes(ranks, case):
    got = _result(ranks, case)
    assert np.isfinite(float(got["train_loss"]))


def test_sharded_irls_fit(ranks):
    got = _result(ranks, "irls")
    assert np.isfinite(float(got["train_loss"]))
    assert (got["W"] >= 0).all()


def test_api_mesh_kwarg(ranks):
    got = _result(ranks, "api")
    assert np.isfinite(float(got["train_loss"]))
    assert bool(got["has_config"])


def test_api_mesh_cv_dispatch(ranks):
    got = _result(ranks, "api_cv")
    assert np.isfinite(float(got["test_loss"]))
    assert len(got["test_loss_history"]) == int(got["iterations"])


def test_sharded_nondivisible_dims(ranks):
    """Pads solve to exact zeros and leave every account: shapes and the
    per-row NB theta sliced to the true length."""
    nondiv = _result(ranks, "nondiv")
    assert nondiv["W"].shape == (81, 3) and nondiv["H"].shape == (3, 97)
    nb = _result(ranks, "nondiv_nb")
    assert nb["theta"].shape == (33,) and np.isfinite(nb["theta"]).all()
    zi = _result(ranks, "nondiv_nb_zi")
    assert zi["pi_row"].shape == (33,) and zi["theta"].shape == (33,)


def test_irls_convergence_is_read_alike_on_every_rank(ranks):
    """With tol > 0 each rank reads the all-reduced loss: every rank stops
    at the same iteration, the single-device fit's."""
    got = _result(ranks, "irls_tol")
    assert 1 < int(got["iterations"]) < 30
    assert int(got["iterations"]) == _port_single("irls_tol").iterations


def test_shard_host_data(ranks):
    """Every rank passes an eighth of the columns (of the rows); each holds
    only its (rows, cols) block, with the global shape."""
    for rank in range(RANKS):
        got = _result(ranks, "device_input", rank)
        assert bool(got["block_ok"])
        assert tuple(got["shape"]) == (64, 96)


def test_fit_sharded_device_input(ranks):
    got = _result(ranks, "device_input")
    np.testing.assert_allclose(got["W"], got["W_host"], rtol=1e-5, atol=1e-6)
    # rtt.nmf of the ShardedMatrix is the same fit
    np.testing.assert_array_equal(got["W_api"], got["W"])
    assert "does not divide" in str(_result(ranks, "not_divisible")["error"])


def test_semi_nmf_l1_padding_guard(ranks):
    assert "unsound with mesh zero-padding" in str(
        _result(ranks, "semi_l1_guard")["error"])
    with pytest.raises(ValueError, match="unsound"):
        port_mesh.check_pad_soundness(
            rtt.build_config(3, nonneg=(False, True), L1=(0.1, 0.0)), 1, 0)
    port_mesh.check_pad_soundness(
        rtt.build_config(3, nonneg=(False, True), L1=(0.1, 0.0)), 0, 0)


def test_fused_vmem_rejected(ranks):
    assert "fused_vmem" in str(_result(ranks, "fused_vmem_rejected")["error"])
    with pytest.raises(ValueError, match="fused_vmem"):
        port_mesh.fit_sharded(np.ones((4, 4), np.float32),
                              rtt.build_config(2, fused_vmem=True, tol=0.0),
                              rtt.default_mesh(devices=["cpu"]))


def test_device_must_be_the_ranks(ranks):
    assert "disagrees" in str(_result(ranks, "device_disagrees")["error"])


def test_device_health_check(ranks, monkeypatch):
    got = _result(ranks, "health")
    assert int(got["n_checked"]) == 1 and int(got["mesh_size"]) == RANKS
    assert port_mesh.check_device_health(devices=["cpu", "cpu"]) == [
        torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.check_device_health()


def test_two_process_distributed_fit(tmp_path):
    """Two processes each pass only their column half through
    ``shard_host_data`` on a (1, 2) mesh; the fit equals the JAX package's
    single-process fit."""
    out = tmp_path / "mp.npz"
    store = tmp_path / "store"
    _run_ranks("torch_multiproc_worker.py", 2, tmp_path,
               lambda r: [str(r), str(store), str(out)], 120.0)
    z = np.load(out)
    rs = np.random.RandomState(0)
    A = np.abs(rs.rand(24, 32)).astype(np.float32)
    ref = rt.nmf(A, 4, seed=42, maxit=20, tol=0.0, sort_model=False)
    assert int(z["iterations"]) == ref.iterations
    np.testing.assert_allclose(z["W"], ref.W, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z["H"], ref.H, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Without ranks: the mesh object, the (1, 1) mesh, the seams
# ---------------------------------------------------------------------------

def test_a_mesh_wider_than_the_world_raises():
    """A JAX-style 8-device mesh inside one process has no torch
    counterpart: the world here is one process."""
    with pytest.raises(ValueError, match="needs 8 ranks"):
        rtt.default_mesh(devices=["cpu"] * 8)
    mesh = rtt.default_mesh(devices=["cpu"])
    assert mesh.shape == {"rows": 1, "cols": 1}
    assert mesh.axis_names == ("rows", "cols")
    assert mesh.devices.shape == (1, 1) and mesh.device == torch.device("cpu")


def test_a_rank_without_a_card_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        multihost._resolve_device(None, 0)
    monkeypatch.setattr(multihost, "_RANK_DEVICE", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.local_device()
    assert rtt.gpu_info()["default_mesh"] is None


ONE_BY_ONE = {
    "mse": dict(k=3, seed=11, maxit=6, tol=0.0),
    "cd_l1": dict(k=3, seed=11, maxit=6, tol=0.0, solver="cd",
                  L1=(0.01, 0.02), angular=(0.1, 0.0)),
    "projective": dict(k=3, seed=11, maxit=6, tol=0.0, projective=True),
    "kl": dict(k=3, seed=11, maxit=3, tol=0.0, loss="kl"),
    "nb_zi": dict(k=3, seed=11, maxit=3, tol=0.0, loss="nb", zi="row"),
    "cv": dict(k=3, seed=11, maxit=4, tol=0.0, test_fraction=0.2,
               cv_seed=1),
}


@pytest.mark.parametrize("case", list(ONE_BY_ONE))
def test_one_by_one_mesh_is_the_plain_fit_bitwise(case):
    """A (1, 1) mesh runs every collective as a no-op: the fit is the plain
    fit bit for bit."""
    kw = dict(ONE_BY_ONE[case])
    k = kw.pop("k")
    A = worker.case_data("counts32" if "loss" in kw else "sim64")["A"]
    mesh = rtt.default_mesh(devices=["cpu"], shape=(1, 1))
    on_mesh = rtt.nmf(A, k, mesh=mesh, **kw)
    plain = rtt.nmf(A, k, device="cpu", **kw)
    for name in ("W", "d", "H", "loss_history", "test_loss_history",
                 "theta", "pi_row"):
        a, b = getattr(on_mesh, name), getattr(plain, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_the_no_op_context_leaves_the_updates_bitwise():
    """``make_updates`` with a mesh-less ShardContext is the plain one."""
    A = torch.from_numpy(worker.case_data("sim64")["A"])
    cfg = rtt.build_config(3, seed=11, maxit=5, tol=0.0, L21=(0.05, 0.1),
                           angular=(0.1, 0.1))
    W_T0, H0, d0 = port_nmf.init_factors(cfg, *A.shape)
    ctx = port_mesh.ShardContext(None, *A.shape)
    runs = [port_nmf.fit_mse(cfg, A, port_nmf.init_fit_state(
        cfg, W_T0, H0, d0, device="cpu"), ctx=c) for c in (None, ctx)]
    for name in ("W_T", "H", "d", "loss_hist"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))


@pytest.mark.parametrize("loss", ["kl", "gp_global", "gamma_col", "nb_zi_col"])
def test_valid_dims_matches_jax(loss):
    """``fit_irls(valid_dims=)`` on a zero-padded A against the JAX
    package's: the accounting (loss, dispersion, zero inflation) on the true
    (m, n) only, the pads solving to exact zeros."""
    kw = {"kl": dict(loss="kl"),
          "gp_global": dict(loss="gp", dispersion="global"),
          "gamma_col": dict(loss="gamma", dispersion="per_col"),
          "nb_zi_col": dict(loss="nb", zi="col", dispersion="per_col")}[loss]
    kw = dict(kw, maxit=3, tol=0.0, sort_model=False)
    A = worker.case_data("counts33")["A"]
    if loss == "gamma_col":
        A = A + 0.5
    m, n = A.shape
    cfg, ref_cfg = rtt.build_config(2, **kw), rt.build_config(2, **kw)
    W_T0, H0, d0 = port_nmf.init_factors(cfg, m, n)
    A_p = np.pad(A, ((0, 3), (0, 5)))
    W_p, H_p = np.pad(W_T0, ((0, 0), (0, 3))), np.pad(H0, ((0, 0), (0, 5)))
    port = nmf_irls.fit_irls(torch.from_numpy(A_p), cfg, W_p, H_p, d0, {},
                             valid_dims=(m, n))
    ref = ref_irls.fit_irls(jnp.asarray(A_p), ref_cfg, jnp.asarray(W_p),
                            jnp.asarray(H_p), jnp.asarray(d0), {},
                            valid_dims=(m, n))
    assert not port.W[m:].any() and not port.H[:, n:].any()
    np.testing.assert_allclose(port.loss_history, ref.loss_history,
                               rtol=IRLS_RTOL * 20)
    np.testing.assert_allclose(port.W, ref.W, rtol=W_RTOL, atol=W_ATOL)
    for name in ("theta", "dispersion", "pi_row", "pi_col"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if r is not None:
            size = n if cfg.dispersion.value == "per_col" or name == \
                "pi_col" else m
            np.testing.assert_allclose(p[:size], np.asarray(r)[:size],
                                       rtol=THETA_RTOL, err_msg=name)


@pytest.mark.parametrize("loss", ["mse", "kl"])
def test_valid_rows_and_cols_match_jax(loss):
    """The CV loop on a zero-padded A with the ``valid_rows`` /
    ``valid_cols`` masks against the JAX package's masked loop: the pads
    leave train and test, and their factors stay exact zeros."""
    A = worker.case_data("sim48" if loss == "mse" else "counts33")["A"]
    m, n = A.shape
    pm, pn = 2, 3
    kw = dict(maxit=4, tol=0.0, test_fraction=0.2, cv_seed=4, seed=3,
              cv_patience=10, sort_model=False, loss=loss)
    cfg, ref_cfg = rtt.build_config(2, **kw), rt.build_config(2, **kw)
    W_T0, H0, d0 = port_nmf.init_factors(cfg, m, n)
    A_p = np.pad(A, ((0, pm), (0, pn)))
    W_p, H_p = np.pad(W_T0, ((0, 0), (0, pm))), np.pad(H0, ((0, 0), (0, pn)))
    valid_rows = np.arange(m + pm) < m
    valid_cols = np.arange(n + pn) < n
    disp_row0, disp_col0 = nmf_irls._init_dispersion(cfg, m + pm, n + pn)

    A_t = torch.from_numpy(A_p)
    masks = {"valid_rows": torch.from_numpy(valid_rows),
             "valid_cols": torch.from_numpy(valid_cols)}
    weights = nmf_cv.build_weights(cfg, A_t, masks, False, True)
    init = nmf_cv.init_cv_state(cfg, A_t, W_p, H_p, d0, disp_row0,
                                disp_col0, zi_valid=weights.zi_valid)
    port = nmf_cv.finalize_cv_result(cfg, nmf_cv.run_masked(
        cfg, A_t, weights, {}, init, False, True, masks=masks))

    from rcppml_tpu import rng as ref_rng
    seed_pair = jnp.asarray(ref_rng.seed_to_u32_pair(4))
    state = ref_cv._fit_masked_jit(
        ref_cfg.device_static(), jnp.asarray(A_p),
        {"valid_rows": jnp.asarray(valid_rows),
         "valid_cols": jnp.asarray(valid_cols)}, {},
        jnp.asarray(W_p), jnp.asarray(H_p), jnp.asarray(d0),
        jnp.asarray(disp_row0), jnp.asarray(disp_col0), seed_pair, False,
        True)
    assert not port.W[m:].any() and not port.H[:, n:].any()
    np.testing.assert_allclose(port.test_loss_history,
                               np.asarray(state.test_hist), rtol=CV_RTOL)
    np.testing.assert_allclose(port.W, np.asarray(state.W_T).T, rtol=W_RTOL,
                               atol=W_ATOL)


def test_shard_state_from_numpy_starts_the_sharded_loop():
    """``convert.shard_state_from_numpy`` lays whole factors onto a block:
    here the one block of a zero-padded A, from which the port's loop runs
    as the JAX package's does on the same padded arrays."""
    A = worker.case_data("sim81")["A"]
    m, n = A.shape
    ctx = port_mesh.ShardContext(None, m, n, padded=(m + 1, n + 3))
    kw = dict(seed=7, maxit=6, tol=0.0, sort_model=False)
    cfg, ref_cfg = rtt.build_config(3, **kw), rt.build_config(3, **kw)
    W_T0, H0, d0 = ref_nmf.init_factors(ref_cfg, m, n)
    state = convert.shard_state_from_numpy(W_T0, H0, d0, ctx, device="cpu",
                                           max_iter=cfg.max_iter)
    assert state.W_T.shape == (3, m + 1) and state.H.shape == (3, n + 3)
    assert not state.W_T[:, m:].any() and not state.H[:, n:].any()
    np.testing.assert_array_equal(state.W_T[:, :m].numpy(), W_T0)
    A_p = np.pad(A, ((0, 1), (0, 3)))
    port = port_nmf.fit_mse(cfg, torch.from_numpy(A_p), state, ctx=ctx)
    ref = ref_nmf._fit_mse(ref_cfg.replace(seed=0), jnp.asarray(A_p),
                           jnp.asarray(np.asarray(state.W_T)),
                           jnp.asarray(np.asarray(state.H)),
                           jnp.asarray(d0), {})
    # the first losses are far above tr(A'A) (a random start): the history
    # is held as the port's single-device tests hold it, the last loss to
    # the mesh bar
    lp = port.loss_hist.numpy().astype(np.float64)
    lr = np.asarray(ref.loss_hist, np.float64)
    tr = float((A.astype(np.float64) ** 2).sum())
    assert np.all(np.abs(lp - lr) <= 1e-4 * np.abs(lr)
                  + 10 * np.finfo(np.float32).eps * tr)
    assert abs(lp[-1] - lr[-1]) < LOSS_TR * tr


def test_the_consumers_left_for_later_still_raise(tmp_path):
    """Checkpointed fits and streaming under a mesh raised
    ``NotImplementedError`` until the mesh's consumers were ported.  On a
    (1, 1) mesh, where every collective is a no-op, the checkpointed fit
    is now the plain fit bit for bit and the stream the single-device
    stream (the 8-rank cases above hold both in full)."""
    A = worker.case_data("sim32")["A"]
    one = rtt.default_mesh(devices=["cpu"])
    kw = dict(seed=5, maxit=6, tol=0.0, sort_model=False)
    path = str(tmp_path / "f.npz")
    rtt.nmf(A, 2, mesh=one, checkpoint_path=path, checkpoint_every=2,
            **dict(kw, maxit=3))
    resumed = rtt.nmf(A, 2, mesh=one, checkpoint_path=path,
                      checkpoint_every=2, **kw)
    plain = rtt.nmf(A, 2, device="cpu", **kw)
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(resumed, name),
                                      getattr(plain, name), err_msg=name)
    with np.load(path) as z:
        assert tuple(z["mesh_shape"]) == (1, 1)
    stream = rtt.nmf(A, 2, mesh=one, streaming=True, chunk_cols=20, **kw)
    single = rtt.nmf(A, 2, device="cpu", streaming=True, chunk_cols=20,
                     **kw)
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(stream, name),
                                      getattr(single, name), err_msg=name)


def test_padding_and_placement_on_one_rank():
    """``pad_to_mesh`` pads as the JAX package's does; ``shard_arrays`` of a
    (1, 1) mesh is the whole model on the rank's device."""
    rs = np.random.RandomState(0)
    A = rs.rand(7, 5).astype(np.float32)
    W_T, H = rs.rand(2, 7).astype(np.float32), rs.rand(2, 5).astype(np.float32)
    d = np.ones(2, np.float32)
    ref = ref_mesh.pad_to_mesh(_jax_mesh((2, 4)), jnp.asarray(A),
                               jnp.asarray(W_T), jnp.asarray(H))

    class Shape:
        shape = {"rows": 2, "cols": 4}

    got = port_mesh.pad_to_mesh(Shape, A, W_T, H)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert port_mesh.mesh_padding(Shape, 7, 5) == (1, 3)
    one = rtt.default_mesh(devices=["cpu"])
    A_b, W_b, H_b, d_b = port_mesh.shard_arrays(one, A, W_T, H, d)
    np.testing.assert_array_equal(A_b.numpy(), A)
    np.testing.assert_array_equal(W_b.numpy(), W_T)
    assert H_b.shape == (2, 5) and d_b.shape == (2,)


# ---------------------------------------------------------------------------
# The mesh's consumers: checkpointed fits, sharded streams, graph nets
# ---------------------------------------------------------------------------

STREAM_ATOL, STREAM_LOSS_RTOL, STREAM_TEST_ATOL, STREAM_PI_ATOL = (
    1e-4, 1e-3, 1e-4, 1e-4)
GRAPH_ATOL = {"gr_shared": 1e-4, "gr_cond": 1e-5, "gr_cond_t": 1e-5}
GRAPH_JAX_REL = 2e-3


def _ckpt_inputs(case):
    data, kw, every, half = worker.CKPT[case]
    kw = dict(kw)
    return worker.consumer_data(data)["A"], kw.pop("k"), kw


def _assert_mesh_bars(got: dict, ref, A, irls: bool):
    """A rank's saved fit against a reference fit with the mesh bars of
    this module: the loss (the IRLS loss to rtol 1e-5, the MSE loss to
    1e-6 tr(A'A)), W to rtol 2e-3 / atol 2e-4, the dispersion and dropouts
    to rtol 5e-3."""
    assert int(got["iterations"]) == int(ref.iterations)
    if irls:
        np.testing.assert_allclose(float(got["train_loss"]),
                                   float(ref.train_loss), rtol=IRLS_RTOL)
    else:
        tr = float((A.astype(np.float64) ** 2).sum())
        assert abs(float(got["train_loss"]) - float(ref.train_loss)) \
            < LOSS_TR * tr
    np.testing.assert_allclose(got["W"], np.asarray(ref.W), rtol=W_RTOL,
                               atol=W_ATOL)
    for name in ("theta", "dispersion", "pi_row", "pi_col"):
        r = getattr(ref, name, None)
        assert (name in got) == (r is not None), name
        if r is not None:
            np.testing.assert_allclose(got[name], np.asarray(r),
                                       rtol=THETA_RTOL, err_msg=name)


@pytest.mark.parametrize("case", list(worker.CKPT) + ["ck_sharded_input"])
def test_checkpointed_mesh_fit_resumes_bitwise(ranks, case):
    """Stopped half way and resumed from its file, the mesh fit is the
    uninterrupted sharded fit bit for bit; a ``ShardedMatrix`` input (no
    rank holds the whole matrix) too."""
    got = _result(ranks, case)
    for name in worker.FIELDS:
        assert (name in got) == (f"ref_{name}" in got), name
        if name in got:
            np.testing.assert_array_equal(got[name], got[f"ref_{name}"],
                                          err_msg=name)
    assert float(got["train_loss"]) == float(got["ref_train_loss"])


@pytest.mark.parametrize("case", list(worker.CKPT))
def test_checkpointed_mesh_fit_matches_jax_sharded_fit(ranks, case):
    A, k, kw = _ckpt_inputs(case)
    ref = ref_mesh.fit_sharded(A, rt.build_config(k, **kw), _jax_mesh((2, 4)))
    _assert_mesh_bars(_result(ranks, case), ref, A, "loss" in kw)


@pytest.mark.parametrize("case", ["ck_mse", "ck_nb_zi"])
def test_mesh_checkpoint_file_is_the_jax_file(ranks, case):
    """The port's file after the interrupted run and the JAX package's
    after the same run on the same mesh: the same keys (the port may add
    ``layout``), the padded shapes, ``mesh_shape`` and config, and the
    state within the mesh bars."""
    jax_case = {v: key for key, v in worker.JAX_RESUME.items()}[case]
    with np.load(ranks / f"{case}.half.npz") as port, \
            np.load(ranks / f"{jax_case}.orig.npz") as ref:
        assert set(port.files) - {"layout"} == set(ref.files)
        for key in ref.files:
            assert port[key].shape == ref[key].shape, key
        A, k, _ = _ckpt_inputs(case)
        m, n = A.shape
        assert port["W_T"].shape == (k, m + (-m) % 2)
        assert port["H"].shape == (k, n + (-n) % 4)
        assert tuple(port["mesh_shape"]) == tuple(ref["mesh_shape"]) \
            == (2, 4)
        assert json.loads(str(port["config"])) == json.loads(
            str(ref["config"]))
        np.testing.assert_array_equal(port["scalars"][0], ref["scalars"][0])
        np.testing.assert_allclose(port["W_T"], ref["W_T"], rtol=W_RTOL,
                                   atol=W_ATOL)
        if "A_imp" in ref.files:
            np.testing.assert_allclose(port["A_imp"], ref["A_imp"],
                                       rtol=W_RTOL, atol=W_ATOL)


@pytest.mark.parametrize("case", list(worker.JAX_RESUME))
def test_jax_mesh_checkpoint_resumes_in_the_port(ranks, case):
    """A file the JAX package wrote half way on a (2, 4) mesh, resumed by
    the port on (2, 4): the end is within the mesh bars of the JAX
    package's uninterrupted sharded fit."""
    A, k, kw = _ckpt_inputs(worker.JAX_RESUME[case])
    ref = ref_mesh.fit_sharded(A, rt.build_config(k, **kw), _jax_mesh((2, 4)))
    _assert_mesh_bars(_result(ranks, case), ref, A, "loss" in kw)


@pytest.mark.parametrize("case", ["no_mesh_file", "other_shape",
                                  "mesh_file_without_mesh"])
def test_mesh_checkpoint_shape_refusals(ranks, case, tmp_path):
    """A file resumes only on the mesh shape that wrote it, both ways, with
    the JAX package's words."""
    if case == "no_mesh_file":
        got = _result(ranks, "ck_refuse_no_mesh_file")
        assert str(got["kind"]) == "ValueError"
        assert "written under no mesh but resume runs under mesh 2x4" in \
            str(got["error"])
    elif case == "other_shape":
        got = _result(ranks, "ck_refuse_other_shape")
        assert str(got["kind"]) == "ValueError"
        assert "written under mesh 2x4 but resume runs under mesh 4x2" in \
            str(got["error"])
    else:
        A, k, kw = _ckpt_inputs("ck_mse")
        for pkg, extra in ((rtt, {"device": "cpu"}), (rt, {})):
            path = tmp_path / f"{pkg.__name__}.npz"
            shutil.copy(ranks / "ck_mse.ckpt.npz", path)
            with pytest.raises(ValueError, match="written under mesh 2x4 "
                               "but resume runs under no mesh"):
                pkg.nmf(A, k, checkpoint_path=str(path), **kw, **extra)


@pytest.mark.parametrize("case", ["aux", "cv", "mask", "fused_vmem"])
def test_mesh_checkpoint_refusals(ranks, case, tmp_path):
    """What a checkpointed mesh fit refuses, as the JAX package refuses it:
    graph auxiliaries (on the 8 ranks), CV, a mask and ``fused_vmem`` (on
    a (1, 1) mesh and one JAX device, before anything is sharded)."""
    A = worker.consumer_data("rand61")["A"]
    words = {"aux": "does not support graph/target auxiliaries yet",
             "cv": "no CV/mask", "mask": "no CV/mask",
             "fused_vmem": "fused_vmem"}[case]
    if case == "aux":
        got = _result(ranks, "ck_refuse_aux")
        assert str(got["kind"]) == "ValueError"
        assert words in str(got["error"])
        kw = dict(graph_H=worker.chain_laplacian(85),
                  graph_lambda=(0.0, 0.1))
    else:
        kw = {"cv": dict(test_fraction=0.2), "mask": dict(mask="zeros"),
              "fused_vmem": dict(fused_vmem=True)}[case]
    common = dict(seed=1, maxit=4, tol=0.0)
    one = rtt.default_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match=words):
        rtt.nmf(A, 3, mesh=one, checkpoint_path=str(tmp_path / "p.npz"),
                **common, **kw)
    with pytest.raises(ValueError, match=words):
        rt.nmf(A, 3, mesh=ref_mesh.default_mesh(jax.devices()[:1], (1, 1)),
               checkpoint_path=str(tmp_path / "j.npz"), **common, **kw)


def _stream_inputs(case):
    data, entry, kw = worker.STREAMS[case]
    kw = dict(kw)
    return worker.consumer_data(data)["A"], kw.pop("k"), kw


def _assert_stream_bars(case, got: dict, ref):
    """The JAX package's mesh-stream bars (``tests/test_mesh_streaming.py``):
    W and H within 1e-4, the loss within 1e-3 of itself; with CV both
    losses within 1e-4; with ZI the dropouts within 1e-4 and the loss
    within 1e-2."""
    np.testing.assert_allclose(got["W"], np.asarray(ref.W),
                               atol=STREAM_ATOL)
    np.testing.assert_allclose(got["H"], np.asarray(ref.H),
                               atol=STREAM_ATOL)
    assert int(got["iterations"]) == int(ref.iterations)
    if case == "st_cv":
        assert abs(float(got["test_loss"]) - ref.test_loss) < STREAM_TEST_ATOL
        assert abs(float(got["train_loss"]) - ref.train_loss) \
            < STREAM_TEST_ATOL
    elif case == "st_nb_zi":
        np.testing.assert_allclose(got["pi_row"], np.asarray(ref.pi_row),
                                   atol=STREAM_PI_ATOL)
        assert abs(float(got["train_loss"]) - ref.train_loss) < 1e-2
    else:
        assert abs(float(got["train_loss"]) - ref.train_loss) \
            < STREAM_LOSS_RTOL * abs(ref.train_loss)


STREAM_FITS = ["st_mse", "st_cv", "st_nb_zi"]


@pytest.mark.parametrize("case", STREAM_FITS)
def test_mesh_stream_matches_single_device_stream(ranks, case):
    from rcppml_tpu_torch.io.loaders import InMemoryLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    A, k, kw = _stream_inputs(case)
    ref = nmf_chunked(InMemoryLoader(A, chunk_cols=worker.STREAM_CHUNK),
                      rtt.build_config(k, **kw), device="cpu")
    _assert_stream_bars(case, _result(ranks, case), ref)


@pytest.mark.parametrize("case", STREAM_FITS)
def test_mesh_stream_matches_jax_mesh_stream(ranks, case):
    from rcppml_tpu.io.loaders import InMemoryLoader
    from rcppml_tpu.models.nmf_chunked import nmf_chunked
    A, k, kw = _stream_inputs(case)
    ref = nmf_chunked(InMemoryLoader(A, chunk_cols=worker.STREAM_CHUNK),
                      rt.build_config(k, **kw), mesh=_jax_mesh((2, 4)))
    _assert_stream_bars(case, _result(ranks, case), ref)


@pytest.mark.parametrize("against", ["port_in_memory", "jax_spz"])
def test_mesh_stream_of_spz(ranks, against):
    """``rtt.nmf("x.spz", k, mesh=)`` against the port's in-memory sharded
    fit of the same matrix (the JAX test's comparison) and against the JAX
    package's mesh stream of the same file."""
    got = _result(ranks, "st_spz")
    A, k, kw = _stream_inputs("st_spz")
    if against == "port_in_memory":
        np.testing.assert_allclose(got["W"], got["mem_W"], atol=STREAM_ATOL)
        ref_loss = float(got["mem_train_loss"])
    else:
        ref = rt.nmf(str(ranks / "sparse67.spz"), k, mesh=_jax_mesh((2, 4)),
                     **kw)
        _assert_stream_bars("st_spz", got, ref)
        ref_loss = ref.train_loss
    assert abs(float(got["train_loss"]) - ref_loss) \
        < STREAM_LOSS_RTOL * abs(ref_loss)


def test_mesh_stream_checkpoint_resumes_bitwise(ranks):
    got = _result(ranks, "st_resume")
    np.testing.assert_array_equal(got["W"], got["full_W"])
    np.testing.assert_array_equal(got["H"], got["full_H"])
    assert float(got["train_loss"]) == float(got["full_train_loss"])
    assert int(got["iterations"]) == int(got["full_iterations"])


def test_sparse_panels_refused_under_mesh():
    from rcppml_tpu.io.loaders import InMemoryLoader as RefLoader
    from rcppml_tpu.models.nmf_chunked import nmf_chunked as ref_chunked
    from rcppml_tpu_torch.io.loaders import InMemoryLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    A = worker.consumer_data("sparse67")["A"]
    words = "sparse_panels is incompatible with mesh="
    with pytest.raises(ValueError, match=words):
        nmf_chunked(InMemoryLoader(A, chunk_cols=40), rtt.build_config(3),
                    mesh=rtt.default_mesh(devices=["cpu"]),
                    sparse_panels=True)
    with pytest.raises(ValueError, match=words):
        ref_chunked(RefLoader(A, chunk_cols=40), rt.build_config(3),
                    mesh=_jax_mesh((2, 4)), sparse_panels=True)


def _graph_layers(got: dict) -> list:
    return sorted({key.split(".")[0] for key in got if "." in key})


@pytest.mark.parametrize("case", list(GRAPH_ATOL))
def test_mesh_graph_matches_single_device_net(ranks, case):
    from rcppml_tpu_torch.models import graph as tg
    got = _result(ranks, case)
    ref = tg.fit(worker.graph_net(case, tg), device="cpu")
    assert int(got["iterations"]) == ref.total_iterations
    assert _graph_layers(got) == sorted(ref.layers)
    for name, lr in ref.layers.items():
        assert got[f"{name}.W"].shape == lr.W.shape
        np.testing.assert_allclose(got[f"{name}.W"], lr.W,
                                   atol=GRAPH_ATOL[case], err_msg=name)


@pytest.mark.parametrize("case", list(GRAPH_ATOL))
def test_mesh_graph_matches_jax_mesh_net(ranks, case):
    from rcppml_tpu.models import graph as jg
    got = _result(ranks, case)
    ref = jg.fit(worker.graph_net(case, jg), mesh=_jax_mesh((2, 4)))
    assert int(got["iterations"]) == ref.total_iterations
    for name, lr in ref.layers.items():
        for attr in ("W", "d", "H"):
            want = np.asarray(getattr(lr, attr))
            np.testing.assert_allclose(
                got[f"{name}.{attr}"], want,
                atol=GRAPH_JAX_REL * np.abs(want).max(), err_msg=name)


def test_mesh_graph_w_blocks(ranks):
    got = _result(ranks, "gr_shared")
    assert tuple(got["J.blocks.rna"]) == (40, 4)
    assert tuple(got["J.blocks.adt"]) == (25, 4)
    assert not any(key.startswith("T.blocks") for key in got)


def test_mesh_graph_loss_over_true_size(ranks):
    """Pads add nothing to a layer's sum of squares and nothing to its
    element count (``tests/test_graph.py``'s bar)."""
    from rcppml_tpu_torch.models import graph as tg
    got = _result(ranks, "gr_loss")
    ref = tg.fit(worker.graph_net("gr_loss", tg), device="cpu")
    np.testing.assert_allclose(float(got["L1.loss"]), ref["L1"].loss,
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["total_loss"]), ref.total_loss,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["gr_refuse_single_layer",
                                  "gr_refuse_host_loop"])
def test_mesh_graph_refusals(ranks, case):
    """A single-layer net and one that needs the host loop raise
    ``ValueError`` naming the mesh, on every rank, as the JAX package's."""
    from rcppml_tpu.models import graph as jg
    got = _result(ranks, case)
    assert str(got["kind"]) == "ValueError"
    assert "mesh" in str(got["error"])
    with pytest.raises(ValueError, match="mesh") as ref:
        jg.fit(worker.graph_net(case, jg), mesh=_jax_mesh((2, 4)))
    assert str(ref.value) == str(got["error"])
