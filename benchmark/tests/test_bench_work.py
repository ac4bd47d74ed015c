"""The work counts against hand counts at a tiny shape."""

from types import SimpleNamespace

import pytest

import harness
from conftest import BENCH


def work(name):
    return harness.load_module(BENCH / "work" / f"{name}.py")


def test_mse_counts():
    # m=3, n=4, k=2, 2 iterations: products 4*2*3*4 = 96, Grams
    # 2*4*(3+4) = 56 an iteration; A twice 8*12 = 96 bytes, factors
    # 8*2*7 = 112 bytes an iteration
    res = SimpleNamespace(iterations=2)
    assert work("mse").count(3, 4, 2, {}, res) == (2 * 152.0, 2 * 208.0)


def test_stream_adds_the_file(tmp_path):
    path = tmp_path / "x.spz"
    path.write_bytes(b"\0" * 1000)
    res = SimpleNamespace(iterations=2)
    assert work("stream").count(3, 4, 2, {}, res, str(path)) == \
        (2 * 152.0, 2 * 208.0 + 1000.0)


def test_least_time_and_shares():
    peaks = harness.load_json(BENCH / "peaks.json")
    assert peaks["flops_per_s"] == 495e12 / 3
    assert peaks["bytes_per_s"] == 3.35e12
    trace = SimpleNamespace(fits=2, device_s=2 * 4e-3, busy_s=1e-3,
                            window_s=4e-3, launches=10)
    fits = [SimpleNamespace(wall_s=0.01, sweep_marks=[0.002, 0.003, 0.005])]
    run = SimpleNamespace(trace=trace, work=(165e9, 3.35e9), peaks=peaks,
                          fits=fits, window_s=0.01)

    def read(name):
        return harness.load_module(BENCH / "metrics" / f"{name}.py").read(run)
    # least time max(1 ms, 1 ms) over 4 ms of device time a fit
    assert abs(read("kernels_roofline") - 25.0) < 1e-9
    assert abs(read("device_idle") - 75.0) < 1e-9
    assert abs(read("fit_mfu") - 10.0) < 1e-9     # 1 ms of 10 ms a fit
    assert read("launches_per_fit") == 5
    assert abs(read("stream.first_sweep_ms") - 2.0) < 1e-9
    assert abs(read("stream.sweep_ms") - 1.5) < 1e-9


@pytest.mark.parametrize("base", ["fit_ms", "fit_p95_ms", "launches_per_fit",
                                  "kernels_roofline", "device_idle",
                                  "fit_mfu"])
def test_host_readers_read_as_their_base(base):
    """A ``<metric>.host`` reader reads what ``<metric>`` reads: the cell
    reports it per layer, not another quantity."""
    trace = SimpleNamespace(fits=2, device_s=2 * 4e-3, busy_s=1e-3,
                            window_s=4e-3, launches=10)
    fits = [SimpleNamespace(wall_s=0.01 + 1e-3 * i, sweep_marks=[])
            for i in range(20)]
    run = SimpleNamespace(trace=trace, work=(165e9, 3.35e9),
                          peaks=harness.load_json(BENCH / "peaks.json"),
                          fits=fits, window_s=0.3)

    def read(name):
        return harness.load_module(BENCH / "metrics" / f"{name}.py").read(run)
    assert read(base) is not None and read(f"{base}.host") == read(base)
