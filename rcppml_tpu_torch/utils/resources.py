"""Device introspection: the ``gpu_available()`` / ``gpu_info()`` analog
(core/resources.hpp:48-149, R/gpu_backend.R:68-143) on ``torch.cuda``.

The port of ``rcppml_tpu/utils/resources.py``, whose accelerator is JAX's
default backend.  Here it is the CUDA card; there is no TPU variant.
``load_data`` is the auto-detecting matrix loader behind ``nmf(path)``.
"""

from __future__ import annotations

import torch


def gpu_available() -> bool:
    """True when a CUDA card is visible."""
    return torch.cuda.is_available()


def _default_mesh_shape():
    """The shape ``default_mesh()`` gives over this process's world, or None
    where it cannot be made (no card for this rank)."""
    from ..parallel.mesh import default_mesh
    try:
        return dict(default_mesh().shape)
    except (RuntimeError, ValueError):
        return None


def gpu_info() -> dict:
    """The cards: name, compute capability, memory and count, whether the
    hand-written kernels (sm_90a) can run on card 0, and ``default_mesh``,
    the (rows, cols) shape of the default mesh over the process group's
    ranks (None without a card).  Every rank of a process group calls it
    together, as it does ``default_mesh``."""
    from ..device import kernels_available
    if not gpu_available():
        return {"backend": "cpu", "num_devices": 0, "devices": [],
                "kernels_available": False, "default_mesh": None}
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({"name": props.name,
                        "capability": (props.major, props.minor),
                        "total_memory": int(props.total_memory),
                        "multiprocessors": int(props.multi_processor_count)})
    return {"backend": "cuda", "num_devices": len(devices),
            "devices": devices, "kernels_available": kernels_available(),
            "default_mesh": _default_mesh_shape()}


def select_resources(nnz: int = 0, n: int = 0) -> str:
    """Dispatch heuristic analog (GPU_README.md:67-74: accelerator when
    nnz >= 100K or n >= 5000).  Returns 'gpu' or 'cpu' — informational:
    the entry points take ``device=``."""
    if gpu_available() and (nnz >= 100_000 or n >= 5_000 or nnz == n == 0):
        return "gpu"
    return "cpu"


def load_data(path: str):
    """Auto-detecting matrix loader (R/nmf_validation.R:30-120
    validate_data): .spz / .mtx / .csv / .h5ad / .loom / .h5 / .rda / .rds
    / .npz / .npy / .tsv, the JAX package's ``load_data``."""
    import os
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such data file: {path}")
    lower = path.lower()
    if lower.endswith((".tsv", ".tsv.gz", ".txt")):
        import numpy as np
        return np.loadtxt(path, delimiter="\t", ndmin=2)
    if lower.endswith(".spz"):
        from ..io.spz import st_read_auto
        return st_read_auto(path)
    if lower.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread
        return mmread(path).tocsc()
    if lower.endswith((".csv", ".csv.gz")):
        import numpy as np
        try:
            return np.loadtxt(path, delimiter=",", ndmin=2)
        except ValueError:
            # header row / rowname column (R's read.csv tolerates both,
            # R/nmf_validation.R): let pandas sniff them
            import pandas as pd
            df = pd.read_csv(path)
            first = df.columns[0]
            if not pd.api.types.is_numeric_dtype(df[first]):  # rownames col
                df = df.set_index(first)
                df.index.name = None
            return df                            # DataFrame: names carry
    if lower.endswith(".h5ad"):
        from ..io.spz import _read_h5ad_x
        return _read_h5ad_x(path)
    if lower.endswith(".loom"):
        from ..io.spz import _read_loom
        return _read_loom(path)
    if lower.endswith(".h5"):
        from ..io.spz import _read_10x_h5
        return _read_10x_h5(path)
    if lower.endswith((".rda", ".rdata")):
        from ..io.rdata import read_rda
        objs = read_rda(path)
        if len(objs) == 1:
            return next(iter(objs.values()))
        return objs
    if lower.endswith(".rds"):
        from ..io.rdata import read_rds
        return read_rds(path)
    if lower.endswith(".npz"):
        import numpy as np
        import scipy.sparse as sp
        try:
            return sp.load_npz(path)
        except Exception:
            with np.load(path) as z:
                return z[z.files[0]]
    if lower.endswith(".npy"):
        import numpy as np
        return np.load(path)
    raise ValueError(f"unrecognized data format: {path}")


accelerator_available = gpu_available
accelerator_info = gpu_info
