"""A cell added as new files only is found by name and runs end to end at a
tiny size on the CPU; its result line has the five keys a result carries,
and the numbers compared come last."""

import json
import subprocess
import sys
import time

import pytest

import harness
from conftest import REPO, TINY_CELLS

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_tiny_cell_runs_correct(tiny_root, cell, trace):
    line, checks = harness.run_cell(tiny_root, cell, 2**31 + 3, 0.3, trace,
                                    "cpu", time.perf_counter())
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(checks) == set(harness.load_json(
        tiny_root / "benchmark" / "limits" / f"{cell}.json"))
    json.dumps(line)                      # one JSON object
    loaded = harness.load_cell(tiny_root, cell)
    named = {mt["name"] for mt in (loaded.per_layer if trace
                                   else loaded.end_to_end)}
    if not trace:
        # every end-to-end metric of the cell it copies, bar the card's
        # memory, which a CPU run does not read
        assert set(line["metrics"]) == named - {"peak_mem_mib"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= named
        # a cell without fit_ms end to end reports it per layer
        if "fit_ms" not in {mt["name"] for mt in loaded.end_to_end}:
            assert line["metrics"]["fit_ms.host"]["value"] > 0


def test_every_cell_names_its_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        tr = cell.traffic
        for kind, name in (("generators", cell.config["generator"]),
                           ("inputs", tr["input"]), ("work", tr["work"]),
                           ("reference", tr["reference"])):
            assert (cell.bench / kind / f"{name}.py").exists()
        assert cell.limits
    for mt in spec["end_to_end"] + spec["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{mt['name']}.py").exists()


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pbmc3k.mse",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("value,correct", [
    (0.5, True), (2.0, False), (float("inf"), False), (float("nan"), False),
    (None, False)])
def test_judge_and_strict_json(value, correct):
    """A number over its limit, non-finite or missing fails; the checks stay
    strict JSON (a non-finite number is given as null)."""
    nums = {} if value is None else {"gap": value}
    ok, checks = harness.judge(nums, {"gap": 1.0})
    assert ok is correct
    text = json.dumps(checks, allow_nan=False)
    assert json.loads(text)["gap"]["limit"] == 1.0
