"""The per-layer metrics that read the program's own counters
(``res.misc["host_syncs"]``, ``res.misc["stream"]``), and the traced
breakdown naming idle time by the program's spans.

A program without the counters (an older commit) gives no value and no
error; the tiny copies of the cells report each metric in a traced run."""

import time
from types import SimpleNamespace

import pytest

import harness
from conftest import BENCH

STREAM = {"decode_s": 0.25, "wait_s": 0.125, "panels_decoded": 10,
          "upload_s": 0.5, "upload_bytes": 3 * 2**20,
          "panel_cache_hits": 4, "sweep_s": [0.5, 0.1]}
READS = {"host_syncs": 46.0, "stream.decode_ms": 250.0,
         "stream.wait_ms": 125.0, "stream.upload_mib": 3.0}


def read(name, run):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read(run)


@pytest.mark.parametrize("name", sorted(READS))
def test_counter_readers(name):
    sample = SimpleNamespace(misc={"host_syncs": 46, "stream": STREAM})
    assert read(name, SimpleNamespace(sample=sample)) == READS[name]


@pytest.mark.parametrize("name", sorted(READS))
@pytest.mark.parametrize("sample", [None, SimpleNamespace(misc={})])
def test_counter_readers_without_the_counters(name, sample):
    """No sample, or a program that counts nothing: no value."""
    assert read(name, SimpleNamespace(sample=sample)) is None


@pytest.mark.parametrize("cell,expect", [
    # the CPU fits count their reads only: 6 iterations at tol=0 end in
    # seven reads; the stream reads its loss twice a sweep, then W, d, H;
    # its dense panels go up once (200 x 600 float32, both sides)
    ("tinyw.mse", {"host_syncs": 7.0}),
    ("tinyw.stream", {"host_syncs": 2 * 6 + 3.0,
                      "stream.upload_mib": 2 * 200 * 600 * 4 / 2**20}),
])
def test_tiny_cells_report_the_counters(tiny_root, cell, expect):
    line, _ = harness.run_cell(tiny_root, cell, 2**31 + 11, 0.3, True,
                               "cpu", time.perf_counter())
    got = {name: v["value"] for name, v in line["metrics"].items()}
    for name, value in expect.items():
        assert got[name] == pytest.approx(value), name
    if cell.endswith("stream"):
        assert got["stream.decode_ms"] > 0 and got["stream.wait_ms"] > 0


def test_idle_inside_a_span_is_named_by_it():
    """The breakdown names an idle gap after the innermost host event open
    at its middle; a program span is one, so the time it holds the device
    idle with no operator running is named by it and not as Python between
    operations."""
    from rcppml_tpu_torch.utils.trace import span
    reduce = harness.load_module(BENCH / "trace_reduce.py")

    def fit():
        with span("rtt.test.wait"):
            time.sleep(0.05)
    summary = reduce.trace_fits(fit, "cpu", 0.0)
    assert summary.launches == 0
    assert summary.breakdown["idle_gaps"][0][0] == "rtt.test.wait"
