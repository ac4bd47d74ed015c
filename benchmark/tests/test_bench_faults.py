"""With the timed path broken underneath, a run's ``correct`` comes out
false, under each cell's own limits, for each fault an NMF fit on one card
can have: a step that returns its state unchanged; half of the batch (the
columns a solve returns) left out, the mean of the rest taken in its place;
an answer altered where it is produced.  (No cell spans cards, so no
exchange between chips can be left out.)  The faults are planted in the
program's CPU path of a tiny copy of each cell of BENCHMARK.json, and, on
the card (``python3 -m pytest -m gpu -s benchmark/tests/
test_bench_faults.py`` from the root of a checkout there), in each cell
itself at its own size; ``-s`` prints each planted run's numbers."""

import json
import time

import pytest
import torch

import harness
from conftest import BENCH

# tiny cell -> the real cell whose limits it is held to
REAL = {"tiny.mse": "pbmc3k.mse", "tinyw.mse": "hcabm40k.mse",
        "tinyw.stream": "hcabm40k.stream"}
# the function of each path that returns a solved factor, and how the
# solved factor and the warm start are passed to it
DENSE = ("rcppml_tpu_torch.models.nmf", "_solve", lambda a, kw: a[3])
SOLVES = {
    "tiny.mse": DENSE, "tinyw.mse": DENSE,
    "tinyw.stream": ("rcppml_tpu_torch.models.nmf_chunked", "_solve_from_B",
                     lambda a, kw: a[4]),
}


def unchanged(real, warm_of):
    def solve(*a, **kw):
        X = real(*a, **kw)
        warm = warm_of(a, kw)
        return warm.clone() if warm is not None else torch.zeros_like(X)
    return solve


def half_left_out(real, warm_of):
    def solve(*a, **kw):
        X = real(*a, **kw).clone()
        X[:, 1::2] = X[:, ::2].mean(dim=1, keepdim=True)
        return X
    return solve


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out}


def run(root, cell):
    line, checks = harness.run_cell(root, cell, 2**31 + 5, 0.2, False, "cpu",
                                    time.perf_counter())
    return line, checks


@pytest.fixture
def real_limits(tiny_root, monkeypatch):
    def use(cell):
        limits = harness.load_json(BENCH / "limits" / f"{REAL[cell]}.json")
        (tiny_root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    yield use
    from conftest import TINY_LIMITS
    for cell in REAL:
        (tiny_root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(REAL))
def test_broken_solve_is_not_correct(tiny_root, real_limits, monkeypatch,
                                     cell, fault):
    import importlib
    real_limits(cell)
    mod_name, fn, warm_of = SOLVES[cell]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, fn, FAULTS[fault](getattr(mod, fn), warm_of))
    line, checks = run(tiny_root, cell)
    assert line["correct"] is False, checks


def altered_sort(real_sort):
    """An answer altered where the result is produced, after the factors
    are ordered: the largest scale d[0] moved by a hundredth."""
    def sort(self, decreasing=True):
        out = real_sort(self, decreasing)
        out.d = out.d.copy()
        out.d[0] *= 1.01
        return out
    return sort


@pytest.mark.parametrize("cell", sorted(REAL))
def test_altered_answer_is_not_correct(tiny_root, real_limits, monkeypatch,
                                       cell):
    from rcppml_tpu_torch.result import NMFResult
    real_limits(cell)
    monkeypatch.setattr(NMFResult, "sort", altered_sort(NMFResult.sort))
    line, checks = run(tiny_root, cell)
    assert line["correct"] is False, checks


@pytest.mark.parametrize("cell", sorted(REAL))
def test_sound_run_is_correct_under_real_limits(tiny_root, real_limits,
                                                cell):
    """The unbroken tiny cells pass the real cells' limits, so the faults
    above fail for the fault and not for the size."""
    real_limits(cell)
    line, checks = run(tiny_root, cell)
    assert line["correct"] is True, checks


CARD_CELLS = sorted(REAL.values())
CARD_SEEDS = {"unchanged": 2**31 + 11, "half_left_out": 2**31 + 12,
              "altered": 2**31 + 13}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(CARD_SEEDS))
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_fault_at_the_cells_size_is_not_correct(monkeypatch, cell, fault):
    """Each fault planted in the cell itself, on the card, at its own size,
    with a window of a second."""
    import importlib
    import torch
    from conftest import REPO
    from rcppml_tpu_torch.result import NMFResult
    if not torch.cuda.is_available():
        pytest.skip("the faults at the cells' sizes are read on the card")
    tiny = {v: k for k, v in REAL.items()}[cell]
    if fault == "altered":
        monkeypatch.setattr(NMFResult, "sort", altered_sort(NMFResult.sort))
    else:
        mod_name, fn, warm_of = SOLVES[tiny]
        mod = importlib.import_module(mod_name)
        monkeypatch.setattr(mod, fn, FAULTS[fault](getattr(mod, fn),
                                                   warm_of))
    line, checks = harness.run_cell(REPO, cell, CARD_SEEDS[fault], 1.0,
                                    False, "cuda", time.perf_counter())
    print(json.dumps({"cell": cell, "fault": fault,
                      "correct": line["correct"], "checks": checks}))
    assert line["correct"] is False, checks
    torch.cuda.empty_cache()
