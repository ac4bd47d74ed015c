"""One rank of the port's mesh tests: a gloo process group on the CPU.

    python tests/torch_mesh_worker.py <rank> <world> <init_file> <out_dir>

Every rank joins the group through the ``file://`` store ``init_file``,
then runs every case of :data:`CASES` in order (each builds its mesh, which
every rank must do together) and writes what its fit returned to
``<out_dir>/<case>.r<rank>.npz``.  ``tests/test_torch_parallel.py`` starts the
ranks, holds rank 0's results to the JAX package's sharded fits and to the
port's single-device fits, and every other rank's to rank 0's.

The data of each case is made from a seed (:func:`case_data`), so that the
test builds the same matrices.  Imports ``rcppml_tpu_torch`` and never JAX.
"""

import os
import shutil
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import rcppml_tpu_torch as rtt  # noqa: E402
from rcppml_tpu_torch.models.nmf_cv import fit_cv_or_masked  # noqa: E402
from rcppml_tpu_torch.parallel import multihost  # noqa: E402
from rcppml_tpu_torch.parallel.mesh import (  # noqa: E402
    check_device_health, default_mesh, fit_sharded)
from rcppml_tpu_torch.utils.simulate import (  # noqa: E402
    simulate_counts, simulate_nmf)

WORLD = 8


def chain_laplacian(n: int) -> np.ndarray:
    """The graph Laplacian of a path over n nodes."""
    L = np.zeros((n, n), np.float32)
    idx = np.arange(n - 1)
    L[idx, idx + 1] = L[idx + 1, idx] = -1.0
    L[np.arange(n), np.arange(n)] = -L.sum(axis=1)
    return L


def case_data(name: str) -> dict:
    """The inputs of a data set by name: ``A`` and, where it has them,
    ``mask`` and the Laplacians."""
    if name == "sim64":
        return {"A": simulate_nmf(m=64, n=96, k=3, noise=0.02, seed=9)["A"]}
    if name == "sim40":
        return {"A": simulate_nmf(m=40, n=64, k=2, noise=0.02, seed=4)["A"]}
    if name == "sim81":
        return {"A": simulate_nmf(m=81, n=97, k=3, noise=0.05, seed=5)["A"]}
    if name == "noisy81":
        return {"A": simulate_nmf(m=81, n=97, k=3, noise=0.5, seed=6)["A"]}
    if name == "counts32":
        return {"A": simulate_counts(m=32, n=48, k=2, seed=4)["A"]}
    if name == "counts33":
        return {"A": simulate_counts(m=33, n=49, k=2, seed=4)["A"]}
    if name == "sim48":
        return {"A": simulate_nmf(m=48, n=64, k=3, noise=0.05, seed=21)["A"]}
    if name == "sim32":
        return {"A": simulate_nmf(m=32, n=48, k=2, noise=0.02, seed=8)["A"]}
    if name == "sim32cv":
        return {"A": simulate_nmf(m=32, n=48, k=2, noise=0.05, seed=9)["A"]}
    if name == "masked":
        rs = np.random.RandomState(3)
        A = simulate_nmf(m=32, n=40, k=2, noise=0.05, seed=10)["A"]
        return {"A": A, "mask": rs.uniform(size=A.shape) < 0.1}
    if name == "graph81":
        A = simulate_nmf(m=81, n=97, k=3, noise=0.05, seed=5)["A"]
        return {"A": A, "graph_W": chain_laplacian(81),
                "graph_H": chain_laplacian(97)}
    if name == "square":
        S = simulate_nmf(m=50, n=50, k=3, noise=0.1, seed=2)["A"]
        return {"A": ((S + S.T) / 2).astype(np.float32)}
    raise KeyError(name)


# case -> (data set, mesh shape, entry point, keywords).  The entry points:
# "sharded" parallel.mesh.fit_sharded(A, build_config(**kw), mesh),
# "nmf" rtt.nmf(A, mesh=mesh, **kw), "cv" fit_cv_or_masked(A,
# build_config(**kw), mesh=mesh[, mask=][, use_downdate=])
MSE = dict(k=3, seed=11, maxit=15, tol=0.0, sort_model=False)
SHAPES = dict(k=2, seed=5, maxit=3, tol=0.0)
NONDIV = dict(k=3, seed=7, maxit=8, tol=0.0, sort_model=False)
CASES = {
    "fit": ("sim64", (2, 4), "sharded", MSE),
    "fit_cd": ("sim64", (2, 4), "sharded", dict(MSE, solver="cd")),
    **{f"shape_{r}x{c}": ("sim40", (r, c), "sharded", SHAPES)
       for r, c in ((1, 8), (2, 4), (4, 2), (8, 1))},
    "l1": ("sim81", (2, 4), "sharded", dict(NONDIV, L1=(0.02, 0.05))),
    "l21": ("sim81", (2, 4), "sharded", dict(NONDIV, L21=(0.05, 0.1))),
    "angular": ("sim81", (2, 4), "sharded", dict(NONDIV, angular=(0.1, 0.2))),
    "graph": ("graph81", (2, 4), "nmf",
              dict(NONDIV, graph_lambda=(0.1, 0.1))),
    "bf16": ("noisy81", (2, 4), "sharded", dict(NONDIV, bf16_data=True)),
    "projective": ("sim81", (2, 4), "sharded", dict(NONDIV, projective=True)),
    "symmetric": ("square", (2, 4), "sharded",
                  dict(NONDIV, symmetric=True, maxit=10)),
    "nondiv": ("sim81", (2, 4), "sharded", NONDIV),
    "nondiv_cv": ("sim81", (2, 4), "nmf",
                  dict(k=3, seed=2, maxit=8, tol=0.0, test_fraction=0.2,
                       cv_seed=1, sort_model=False)),
    "nondiv_gp": ("counts33", (2, 4), "sharded",
                  dict(k=2, loss="gp", dispersion="none", seed=3, maxit=4,
                       tol=0.0, solver="cd", sort_model=False)),
    "nondiv_nb": ("counts33", (2, 4), "sharded",
                  dict(k=2, loss="nb", dispersion="per_row", seed=3, maxit=3,
                       tol=0.0, solver="cd", sort_model=False)),
    "nondiv_nb_zi": ("counts33", (2, 4), "sharded",
                     dict(k=2, loss="nb", zi="row", seed=3, maxit=3,
                          tol=0.0, sort_model=False)),
    "nondiv_gp_global": ("counts33", (4, 2), "sharded",
                         dict(k=2, loss="gp", dispersion="global", seed=3,
                              maxit=3, tol=0.0, sort_model=False)),
    "irls": ("counts32", (2, 4), "sharded",
             dict(k=2, loss="gp", dispersion="none", seed=3, maxit=3,
                  tol=0.0, solver="cd", sort_model=False)),
    "irls_tol": ("counts32", (2, 4), "sharded",
                 dict(k=2, loss="kl", seed=3, maxit=30, tol=1e-3,
                      sort_model=False)),
    "api": ("sim32", (2, 4), "nmf",
            dict(k=2, seed=5, maxit=5, tol=0.0, sort_model=False)),
    "cv": ("sim48", (2, 4), "cv",
           dict(k=3, seed=7, maxit=10, tol=0.0, test_fraction=0.15,
                cv_seed=5, sort_model=False)),
    "cv_downdate": ("sim48", (2, 4), "cv",
                    dict(k=3, seed=7, maxit=10, tol=0.0, test_fraction=0.15,
                         cv_seed=5, sort_model=False, use_downdate=True)),
    "cv_irls": ("counts33", (2, 4), "cv",
                dict(k=2, loss="kl", seed=3, maxit=4, tol=0.0,
                     test_fraction=0.2, cv_seed=2, cv_patience=10,
                     sort_model=False)),
    "cv_gp_global": ("counts33", (2, 4), "cv",
                     dict(k=2, loss="gp", dispersion="global", seed=3,
                          maxit=3, tol=0.0, test_fraction=0.2, cv_seed=2,
                          cv_patience=10, sort_model=False)),
    "api_cv": ("sim32cv", (2, 4), "nmf",
               dict(k=2, seed=5, maxit=6, tol=0.0, test_fraction=0.2,
                    cv_seed=3, sort_model=False)),
    "masked": ("masked", (4, 2), "cv",
               dict(k=2, seed=2, maxit=5, tol=0.0, has_mask=True,
                    sort_model=False)),
    "masked_cd": ("masked", (2, 4), "cv",
                  dict(k=2, seed=2, maxit=5, tol=0.0, has_mask=True,
                       solver="cd", sort_model=False)),
}
# ---------------------------------------------------------------------------
# The mesh's consumers: checkpointed fits, sharded streams, graph nets
# ---------------------------------------------------------------------------

def consumer_data(name: str) -> dict:
    """The inputs of the consumer cases, the JAX package's mesh tests'
    (``tests/test_mesh_streaming.py``, ``tests/test_graph.py``): shapes
    that do not divide a (2, 4) mesh."""
    if name == "rand61":
        return {"A": np.random.RandomState(3).rand(61, 85).astype(
            np.float32)}
    if name == "counts61":
        return {"A": np.random.RandomState(5).poisson(
            1.5, size=(61, 85)).astype(np.float32)}
    if name == "rand67":
        return {"A": np.random.RandomState(0).rand(67, 93).astype(
            np.float32)}
    if name == "counts67":
        return {"A": np.random.RandomState(1).poisson(
            1.5, size=(67, 93)).astype(np.float32)}
    if name == "sparse67":
        rs = np.random.RandomState(2)
        return {"A": (rs.rand(67, 93) * (rs.rand(67, 93) < 0.3)).astype(
            np.float32)}
    if name == "modalities":
        return {"A1": simulate_nmf(m=40, n=60, k=3, noise=0.02, seed=1)["A"],
                "A2": simulate_nmf(m=25, n=60, k=3, noise=0.02, seed=2)["A"]}
    if name == "cond37":
        rs = np.random.RandomState(0)
        A = np.abs(rs.rand(37, 61)).astype(np.float32)
        return {"A": A, "Z": rs.rand(61, 3).astype(np.float32)}
    if name == "loss37":
        return {"A": np.abs(np.random.RandomState(1).rand(37, 61)).astype(
            np.float32)}
    raise KeyError(name)


# checkpointed mesh fits: case -> (data, keywords, checkpoint_every, the
# iterations of the interrupted run)
CKPT = {
    "ck_mse": ("rand61", dict(k=4, seed=42, maxit=12, tol=0.0,
                              sort_model=False), 5, 5),
    "ck_cd": ("rand61", dict(k=4, seed=42, maxit=12, tol=0.0, solver="cd",
                             sort_model=False), 5, 5),
    "ck_kl": ("counts61", dict(k=3, seed=1, maxit=6, tol=0.0, loss="kl",
                               sort_model=False), 2, 3),
    "ck_nb_zi": ("counts61", dict(k=3, seed=1, maxit=6, tol=0.0, loss="nb",
                                  zi="row", dispersion="per_row",
                                  sort_model=False), 3, 3),
}
# files the JAX package wrote on a (2, 4) mesh (the test's fixture writes
# them before the ranks start), resumed here: case -> the CKPT case
JAX_RESUME = {"jax_resume_mse": "ck_mse", "jax_resume_nb_zi": "ck_nb_zi"}
# sharded streams: case -> (data, entry point, keywords); "chunked" is
# nmf_chunked(InMemoryLoader(A, chunk_cols=40), cfg, mesh=), "api"
# rtt.nmf(A, streaming=True, chunk_cols=40, mesh=), "spz" rtt.nmf of the
# .spz file the fixture wrote, "resume" a stream checkpoint resumed
STREAMS = {
    "st_mse": ("rand67", "chunked", dict(k=5, seed=42, maxit=8, tol=0.0,
                                         sort_model=False)),
    "st_cv": ("rand67", "api", dict(k=4, seed=42, maxit=6, tol=0.0,
                                    test_fraction=0.2, cv_seed=7,
                                    sort_model=False)),
    "st_nb_zi": ("counts67", "chunked", dict(k=3, seed=1, maxit=4, tol=0.0,
                                             loss="nb", zi="row",
                                             dispersion="per_row",
                                             sort_model=False)),
    "st_spz": ("sparse67", "spz", dict(k=5, seed=42, maxit=8, tol=0.0,
                                       sort_model=False)),
    "st_resume": ("rand67", "resume", dict(k=4, seed=42, maxit=10, tol=0.0,
                                           sort_model=False)),
}
STREAM_CHUNK = 40
# graph nets: case -> data
GRAPHS = {"gr_shared": "modalities", "gr_cond": "cond37",
          "gr_cond_t": "cond37", "gr_loss": "loss37"}
# what each consumer case refuses, run on every rank
REFUSALS = ("ck_refuse_no_mesh_file", "ck_refuse_other_shape",
            "ck_refuse_aux", "gr_refuse_single_layer", "gr_refuse_host_loop")


def graph_net(case: str, G):
    """The net of a graph case, built with the graph module ``G`` (the
    port's or the JAX package's)."""
    data = consumer_data(GRAPHS.get(case, "loss37"))
    if case == "gr_shared":
        i1, i2 = G.Input(data["A1"], "rna"), G.Input(data["A2"], "adt")
        top = G.NMFLayer(G.NMFLayer(G.Shared(i1, i2), 4, name="J"), 2,
                         name="T")
        return G.factor_net([i1, i2], top, maxit=6, tol=0.0, seed=3)
    inp = G.Input(data["A"], "x")
    if case in ("gr_cond", "gr_cond_t"):
        Z = data["Z"] if case == "gr_cond" else data["Z"].T.copy()
        top = G.NMFLayer(G.Condition(G.NMFLayer(inp, 4, name="L1"), Z), 2,
                         name="L2")
        return G.factor_net(inp, top, maxit=5, tol=0.0, seed=11)
    if case == "gr_refuse_single_layer":
        return G.factor_net(inp, G.NMFLayer(inp, 2, name="L"), maxit=3)
    if case == "gr_refuse_host_loop":
        top = G.NMFLayer(G.NMFLayer(inp, 3, name="a", loss="nb"), 2,
                         name="b")
        return G.factor_net(inp, top, maxit=3)
    top = G.NMFLayer(G.NMFLayer(inp, 4, name="L1"), 2, name="L2")
    return G.factor_net(inp, top, maxit=5, tol=0.0, seed=7)


def run_checkpoint(case: str, rank: int, out_dir: str) -> None:
    """The uninterrupted sharded fit, then the checkpointed fit stopped at
    half its iterations and resumed; rank 0 keeps a copy of each file."""
    data, kw, every, half = CKPT[case]
    A = consumer_data(data)["A"]
    mesh = mesh_of((2, 4))
    kw = dict(kw)
    k = kw.pop("k")
    ref = fit_sharded(A, rtt.build_config(k, **kw), mesh)
    path = os.path.join(out_dir, f"{case}.ckpt.npz")
    rtt.nmf(A, k, mesh=mesh, checkpoint_path=path, checkpoint_every=every,
            **dict(kw, maxit=half))
    if rank == 0:
        shutil.copy(path, os.path.join(out_dir, f"{case}.half.npz"))
    torch.distributed.barrier()
    res = rtt.nmf(A, k, mesh=mesh, checkpoint_path=path,
                  checkpoint_every=every, **kw)
    save(out_dir, case, rank, res,
         **{f"ref_{name}": getattr(ref, name) for name in FIELDS
            if getattr(ref, name, None) is not None},
         ref_train_loss=ref.train_loss)


def run_checkpoint_sharded(case: str, rank: int, out_dir: str) -> None:
    """A ``ShardedMatrix`` (each rank passes an eighth of the columns)
    checkpoints too: stopped half way and resumed, the uninterrupted
    sharded fit of it."""
    A = case_data("sim64")["A"]
    mesh = mesh_of((2, 4))
    cols = A.shape[1] // WORLD
    A_dev = multihost.shard_host_data(A[:, rank * cols:(rank + 1) * cols],
                                      mesh, axis="cols")
    kw = dict(seed=11, maxit=10, tol=0.0, sort_model=False)
    ref = fit_sharded(A_dev, rtt.build_config(3, **kw), mesh)
    path = os.path.join(out_dir, f"{case}.ckpt.npz")
    rtt.nmf(A_dev, 3, checkpoint_path=path, checkpoint_every=5,
            **dict(kw, maxit=5))
    res = rtt.nmf(A_dev, 3, checkpoint_path=path, checkpoint_every=5, **kw)
    save(out_dir, case, rank, res,
         **{f"ref_{name}": getattr(ref, name) for name in FIELDS
            if getattr(ref, name, None) is not None},
         ref_train_loss=ref.train_loss)


def run_jax_resume(case: str, rank: int, out_dir: str) -> None:
    data, kw, every, _ = CKPT[JAX_RESUME[case]]
    A = consumer_data(data)["A"]
    kw = dict(kw)
    k = kw.pop("k")
    res = rtt.nmf(A, k, mesh=mesh_of((2, 4)),
                  checkpoint_path=os.path.join(out_dir, f"{case}.npz"),
                  checkpoint_every=every, **kw)
    save(out_dir, case, rank, res)


def run_stream(case: str, rank: int, out_dir: str) -> None:
    from rcppml_tpu_torch.io.loaders import InMemoryLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    data, entry, kw = STREAMS[case]
    A = consumer_data(data)["A"]
    mesh = mesh_of((2, 4))
    kw = dict(kw)
    k = kw.pop("k")
    extra = {}
    if entry == "chunked":
        res = nmf_chunked(InMemoryLoader(A, chunk_cols=STREAM_CHUNK),
                          rtt.build_config(k, **kw), mesh=mesh)
    elif entry == "api":
        res = rtt.nmf(A, k, streaming=True, chunk_cols=STREAM_CHUNK,
                      mesh=mesh, **kw)
    elif entry == "spz":
        res = rtt.nmf(os.path.join(out_dir, "sparse67.spz"), k, mesh=mesh,
                      **kw)
        mem = fit_sharded(A, rtt.build_config(k, **kw), mesh)
        extra = {"mem_W": mem.W, "mem_train_loss": mem.train_loss}
    else:
        stream = dict(streaming=True, chunk_cols=STREAM_CHUNK, mesh=mesh)
        full = rtt.nmf(A, k, **stream, **kw)
        path = os.path.join(out_dir, f"{case}.ckpt.npz")
        rtt.nmf(A, k, checkpoint_path=path, checkpoint_every=2, **stream,
                **dict(kw, maxit=4))
        res = rtt.nmf(A, k, checkpoint_path=path, **stream, **kw)
        extra = {"full_W": full.W, "full_H": full.H,
                 "full_train_loss": full.train_loss,
                 "full_iterations": full.iterations}
    save(out_dir, case, rank, res, **extra)


def run_graph(case: str, rank: int, out_dir: str) -> None:
    from rcppml_tpu_torch.models import graph
    res = graph.fit(graph_net(case, graph), mesh=mesh_of((2, 4)))
    arrays = {"total_loss": res.total_loss,
              "iterations": res.total_iterations}
    for name, lr in res.layers.items():
        for attr in ("W", "d", "H", "loss"):
            arrays[f"{name}.{attr}"] = np.asarray(getattr(lr, attr))
        for block, W in (lr.W_blocks or {}).items():
            arrays[f"{name}.blocks.{block}"] = np.asarray(W.shape)
    save(out_dir, case, rank, **arrays)


def run_refusal(case: str, rank: int, out_dir: str) -> None:
    """Each refusal on every rank: the error's type and words."""
    from rcppml_tpu_torch.models import graph
    A = consumer_data("rand61")["A"]
    kw = dict(seed=42, maxit=12, tol=0.0, sort_model=False)
    try:
        if case == "ck_refuse_no_mesh_file":
            # the fixture wrote the file without a mesh
            rtt.nmf(A, 4, mesh=mesh_of((2, 4)), checkpoint_every=5,
                    checkpoint_path=os.path.join(out_dir, "no_mesh.npz"),
                    **kw)
        elif case == "ck_refuse_other_shape":
            path = os.path.join(out_dir, "ck_mse.ckpt.npz")
            rtt.nmf(A, 4, mesh=mesh_of((4, 2)), checkpoint_path=path,
                    checkpoint_every=5, **kw)
        elif case == "ck_refuse_aux":
            rtt.nmf(A, 4, mesh=mesh_of((2, 4)), graph_lambda=(0.0, 0.1),
                    graph_H=chain_laplacian(85),
                    checkpoint_path=os.path.join(out_dir, "aux.npz"), **kw)
        else:
            graph.fit(graph_net(case, graph), mesh=mesh_of((2, 4)))
        save(out_dir, case, rank, error="", kind="")
    except Exception as e:                        # noqa: BLE001
        save(out_dir, case, rank, error=str(e), kind=type(e).__name__)


CONSUMERS = {**{case: run_checkpoint for case in CKPT},
             "ck_sharded_input": run_checkpoint_sharded,
             **{case: run_jax_resume for case in JAX_RESUME},
             **{case: run_stream for case in STREAMS},
             **{case: run_graph for case in GRAPHS},
             **{case: run_refusal for case in REFUSALS}}


# cases whose run is not one fit
SPECIAL = ("info", "device_input", "not_divisible", "semi_l1_guard",
           "fused_vmem_rejected", "health", "device_disagrees")
FIELDS = ("W", "d", "H", "loss_history", "test_loss_history", "theta",
          "dispersion", "pi_row", "pi_col")


_MESHES: dict = {}


def mesh_of(shape):
    """The mesh of a shape, made once per run (every rank makes the same
    meshes in the same order)."""
    if shape not in _MESHES:
        _MESHES[shape] = default_mesh(shape=shape)
    return _MESHES[shape]


def save(out_dir: str, case: str, rank: int, res=None, **extra) -> None:
    arrays = dict(extra)
    if res is not None:
        for name in FIELDS:
            val = getattr(res, name, None)
            if val is not None:
                arrays[name] = np.asarray(val)
        arrays["iterations"] = res.iterations
        arrays["train_loss"] = res.train_loss
        arrays["test_loss"] = res.test_loss
        arrays["has_config"] = "config" in res.misc
    np.savez(os.path.join(out_dir, f"{case}.r{rank}.npz"), **arrays)


def run_case(case: str):
    data, shape, entry, kw = CASES[case]
    inputs = case_data(data)
    A = inputs["A"]
    mesh = mesh_of(shape)
    kw = dict(kw)
    k = kw.pop("k")
    if entry == "sharded":
        return fit_sharded(A, rtt.build_config(k, **kw), mesh)
    if entry == "cv":
        dd = kw.pop("use_downdate", False)
        return fit_cv_or_masked(A, rtt.build_config(k, **kw), mesh=mesh,
                                mask=inputs.get("mask"), use_downdate=dd)
    return rtt.nmf(A, k, mesh=mesh, graph_W=inputs.get("graph_W"),
                   graph_H=inputs.get("graph_H"), **kw)


def run_special(case: str, rank: int, out_dir: str) -> None:
    if case == "info":
        info = multihost.initialize()
        mesh = default_mesh()
        save(out_dir, case, rank, process_count=info["process_count"],
             global_devices=info["global_devices"],
             mesh_size=mesh.devices.size, mesh_shape=tuple(
                 mesh.shape[a] for a in mesh.axis_names),
             axis_names=np.asarray(mesh.axis_names))
    elif case == "device_input":
        A = case_data("sim64")["A"]
        mesh = mesh_of((2, 4))
        # each rank holds an eighth of the columns; no rank the whole
        cols = A.shape[1] // WORLD
        A_dev = multihost.shard_host_data(A[:, rank * cols:(rank + 1) * cols],
                                          mesh, axis="cols")
        rows = A.shape[0] // WORLD
        A_rows = multihost.shard_host_data(A[rank * rows:(rank + 1) * rows],
                                           mesh, axis="rows")
        cfg = rtt.build_config(3, seed=11, maxit=10, tol=0.0,
                               sort_model=False)
        res_dev = fit_sharded(A_dev, cfg, mesh)
        res_host = fit_sharded(A, cfg, mesh)
        res_api = rtt.nmf(A_dev, 3, seed=11, maxit=10, tol=0.0,
                          sort_model=False)     # on the matrix's own mesh
        i, j = mesh.coords
        blk = A[i * 32:(i + 1) * 32, j * 24:(j + 1) * 24]
        save(out_dir, case, rank, res_dev, W_host=res_host.W,
             W_api=res_api.W,
             block_ok=bool(np.array_equal(A_dev.block.numpy(), blk)
                           and np.array_equal(A_rows.block.numpy(), blk)),
             shape=A_dev.shape)
    elif case == "not_divisible":
        A = case_data("sim64")["A"][:63]
        mesh = mesh_of((2, 4))
        cfg = rtt.build_config(3, seed=11, maxit=10, tol=0.0)
        try:
            fit_sharded(torch.from_numpy(A), cfg, mesh)
            msg = ""
        except ValueError as e:
            msg = str(e)
        save(out_dir, case, rank, error=msg)
    elif case == "semi_l1_guard":
        A = case_data("sim81")["A"]
        mesh = mesh_of((2, 4))
        cfg = rtt.build_config(3, nonneg=(False, True), L1=(0.1, 0.0),
                               maxit=2)
        try:
            fit_sharded(A, cfg, mesh)
            msg = ""
        except ValueError as e:
            msg = str(e)
        save(out_dir, case, rank, error=msg)
    elif case == "fused_vmem_rejected":
        mesh = mesh_of((2, 4))
        cfg = rtt.build_config(3, fused_vmem=True, tol=0.0, maxit=2)
        try:
            fit_sharded(case_data("sim64")["A"], cfg, mesh)
            msg = ""
        except ValueError as e:
            msg = str(e)
        save(out_dir, case, rank, error=msg)
    elif case == "health":
        devs = check_device_health(devices=["cpu"])
        mesh = default_mesh(health_check=True)
        save(out_dir, case, rank, n_checked=len(devs),
             mesh_size=mesh.devices.size)
    elif case == "device_disagrees":
        mesh = mesh_of((2, 4))
        try:
            fit_sharded(case_data("sim64")["A"], rtt.build_config(3),
                        mesh, device="cuda")
            msg = ""
        except ValueError as e:
            msg = str(e)
        save(out_dir, case, rank, error=msg)


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out_dir = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{init_file}",
                         num_processes=world, process_id=rank, device="cpu")
    for case in SPECIAL:
        run_special(case, rank, out_dir)
    for case in CASES:
        try:
            res = run_case(case)
        except Exception:
            # the traceback goes to the log the test prints; the other
            # ranks would wait in a collective, so the run stops here
            traceback.print_exc()
            raise
        save(out_dir, case, rank, res)
    for case, run in CONSUMERS.items():
        try:
            run(case, rank, out_dir)
        except Exception:
            traceback.print_exc()
            raise
    print(f"rank {rank} done", flush=True)
    # every rank leaves its last collective before any tears its group down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
