"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with tiny cells added as new files only (configuration,
traffic, limits and entries in BENCHMARK.json), as a later change would add
them."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny cells: (workload, config, config file body, traffic, traffic body)
TINY_CONFIGS = {
    "tiny": {"m": 300, "n": 200, "generator": "lowrank_poisson",
             "zero_share": 0.938, "planted_rank": 6,
             "factor_sparsity": 0.5},
    "tinyw": {"m": 200, "n": 600, "generator": "planted_blocks",
              "density": 0.165, "blocks": 5, "top": 2.0, "decay": 0.85},
}
TINY_TRAFFIC = {
    "tiny_mse": {"input": "dense", "k": 5, "nmf": {"maxit": 6, "tol": 0,
                                                   "seed": 1},
                 "work": "mse", "reference": "mse"},
    "tiny_stream": {"input": "spz", "chunk_cols": 128, "k": 5,
                    "nmf": {"maxit": 6, "tol": 0, "seed": 1},
                    "work": "stream", "reference": "mse",
                    "sweep_clock": True},
}
# the CPU twins in float32 against the float64 reference at these sizes
TINY_LIMITS = {"hist3_rel": 1e-5, "d_gap": 1e-2, "recon_gap": 1e-4,
               "fix_gap": 1e-4}
TINY_CELLS = [("tiny.mse", "tiny", "tiny_mse"),
              ("tinyw.mse", "tinyw", "tiny_mse"),
              ("tinyw.stream", "tinyw", "tiny_stream")]
# the cell each tiny cell copies: it reports the metrics that cell reports
TWIN = {"tiny.mse": "pbmc3k.mse", "tinyw.mse": "hcabm40k.mse",
        "tinyw.stream": "hcabm40k.stream"}


def make_tiny_root(root: Path) -> Path:
    """A checkout at ``root``: BENCHMARK.json and a copy of the benchmark,
    with the tiny cells added as new files and entries."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    for name, body in TINY_CONFIGS.items():
        (b / "configs" / f"{name}.json").write_text(json.dumps(body))
        spec["configs"].append({"name": name, "source": "tiny test shape",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": ["m", "n"], "why": "CPU test"})
    for name, body in TINY_TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(body))
    for wl, cfg, tr in TINY_CELLS:
        (b / "limits" / f"{wl}.json").write_text(json.dumps(TINY_LIMITS))
        spec["workloads"].append({"name": wl, "config": cfg, "traffic": tr,
                                  "chips": 1, "why": "CPU test"})
    for mt in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in mt:
            mt["workloads"] += [wl for wl, real in TWIN.items()
                                if real in mt["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
