"""The import guard: JAX and the JAX package are refused by whole top-level
name, the port (whose name starts with the JAX package's) is not; a run of
the harness loads neither."""

import subprocess
import sys
import types

import pytest

import harness
from conftest import BENCH, REPO


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("rcppml_tpu", True), ("rcppml_tpu.models.nmf", True),
    ("rcppml_tpu_torch", False), ("rcppml_tpu_torch.api", False),
    ("jaxtyping", False)])
def test_guard_by_whole_top_level_name(monkeypatch, name, refused):
    for key in [k for k in sys.modules
                if k.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == refused


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell run on the CPU in a fresh process leaves neither JAX nor
    the JAX package in sys.modules."""
    code = (
        "import sys, time; from pathlib import Path\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, "
        f"{str(REPO)!r}]\n"
        "from conftest import make_tiny_root\n"
        "import harness\n"
        f"root = make_tiny_root(Path({str(tmp_path)!r}))\n"
        "harness.run_cell(root, 'tiny.mse', 1, 0.2, True, 'cpu', "
        "time.perf_counter())\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
