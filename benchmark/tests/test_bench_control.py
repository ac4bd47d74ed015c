"""The control: the plain reference computed with TF32 products (the
precision below the configurations' float32), put in the program's place at
each cell's own size on three seeds, has to come out not correct under the
cell's limits.  Needs the card: ``python3 -m pytest -m gpu
benchmark/tests/test_bench_control.py`` from the root of a checkout on it."""

import json

import pytest

import harness
from conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control is read on the card at the cell's size")
    c = harness.load_cell(REPO, cell)
    m, n, k = int(c.config["m"]), int(c.config["n"]), int(c.traffic["k"])
    gen = c.plugin("generators", c.config["generator"])
    for seed in SEEDS:
        A = gen.make(c.config, seed, "cuda")
        W0, _ = harness.draw_init(seed, m, n, k, "cuda")
        nums = harness.reference_numbers(c, A, W0, None, "cuda",
                                         control=True)
        correct, checks = harness.judge(nums, c.limits)
        assert not correct, (seed, checks)
        del A
        torch.cuda.empty_cache()
