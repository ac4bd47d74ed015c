"""Readings for the limits of a cell's comparison: on each seed, the numbers
that one fit of the program and the control (the plain reference computed
with TF32 products) give against the float64 reference, at the cell's own
size, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control]

from the root of a checkout, on the card.  Prints one JSON line per seed and
side.  The benchmark's own runs never run this.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

import harness  # noqa: E402


def readings(cell, seed: int, control: bool, device: str = "cuda") -> list:
    import torch
    import rcppml_tpu_torch as rtt
    rtt.set_fp32_precision()
    m, n, k = int(cell.config["m"]), int(cell.config["n"]), \
        int(cell.traffic["k"])
    gen = cell.plugin("generators", cell.config["generator"])
    A = gen.make(cell.config, seed, device)
    W0, H0 = harness.draw_init(seed, m, n, k, device)
    workdir = tempfile.mkdtemp(prefix="nmfbench-")
    out = []
    try:
        data, keep = cell.plugin("inputs", cell.traffic["input"]).prepare(
            A, cell.traffic, workdir)
        t0 = time.perf_counter()
        res, _ = harness.make_fit(cell, data, W0, H0, device)()
        fit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    prog = {"W": res.W, "d": res.d, "H": res.H,
            "loss_history": res.loss_history}
    t0 = time.perf_counter()
    nums = harness.reference_numbers(cell, A, W0, prog, device)
    out.append({"seed": seed, "side": "program", "fit_s": fit_s,
                "reference_s": time.perf_counter() - t0, **nums})
    if control:
        t0 = time.perf_counter()
        nums = harness.reference_numbers(cell, A, W0, None, device,
                                         control=True)
        out.append({"seed": seed, "side": "control",
                    "reference_s": time.perf_counter() - t0, **nums})
    del A
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, args.control):
            print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
