"""Worker of the port's two-process test (run through subprocess).

    python tests/torch_multiproc_worker.py <process_id> <init_file> <out.npz>
        [<device>]

Each process joins a gloo group of two through the ``file://`` store
``init_file`` (both ranks on ``device``, default ``cpu``; ``cuda``: both on
card 0, which NCCL would refuse), passes only its own column half of the
data through
``multihost.shard_host_data`` on a (1, 2) mesh, runs the sharded fit, and
process 0 writes the result for the test to compare: no process ever holds
the whole matrix.  Imports ``rcppml_tpu_torch`` and never JAX.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import rcppml_tpu_torch as rtt  # noqa: E402
from rcppml_tpu_torch.parallel import multihost  # noqa: E402
from rcppml_tpu_torch.parallel.mesh import default_mesh, fit_sharded  # noqa


def main() -> None:
    pid, init_file, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    torch.set_num_threads(1)
    if device != "cpu":
        rtt.set_fp32_precision()
    info = multihost.initialize(init_method=f"file://{init_file}",
                                num_processes=2, process_id=pid,
                                backend="gloo", device=device)
    if info["process_count"] != 2 or info["backend"] != "gloo":
        raise RuntimeError(f"unexpected group: {info}")

    # deterministic data, columns split across the two processes
    rs = np.random.RandomState(0)
    A = np.abs(rs.rand(24, 32)).astype(np.float32)
    local = A[:, pid * 16:(pid + 1) * 16]
    del A

    mesh = default_mesh(shape=(1, 2))
    A_global = multihost.shard_host_data(local, mesh, axis="cols")
    if tuple(A_global.shape) != (24, 32):
        raise RuntimeError(f"global shape {A_global.shape}")
    cfg = rtt.build_config(4, seed=42, maxit=20, tol=0.0, sort_model=False)
    res = fit_sharded(A_global, cfg, mesh)
    if pid == 0:
        from rcppml_tpu_torch.ops import cholesky_clip
        np.savez(out, W=res.W, H=res.H, d=res.d,
                 train_loss=res.train_loss, iterations=res.iterations,
                 launches=cholesky_clip.cholesky_clip.launches)
    print(f"proc {pid} done", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
