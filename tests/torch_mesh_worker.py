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
    print(f"rank {rank} done", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
