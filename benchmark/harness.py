"""The benchmark's core: find a cell's files by name, set it up, time its
fits, read its trace, judge its answers against the plain reference.

Everything that belongs to one configuration, traffic, work count, input
kind, reference or metric is a file of its own under this directory, found
by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json        sizes and the generator that makes the data
  generators/<generator>.py    ``make(config, seed, device)`` -> dense A
  traffic/<traffic>.json       the fit's options, input kind, work, reference
  inputs/<input>.py            ``prepare(A, traffic, workdir)`` -> the data
                               handed to ``nmf`` (a tensor, a .spz path)
  work/<work>.py               ``count(m, n, k, traffic, result)`` -> the
                               operations and bytes a fit needs
  reference/<reference>.py     ``fit(A, W0, traffic)`` -> W, d, H, losses;
                               ``w_update(A, H)``: a fit's last W update
                               taken again from its own final H
  limits/<workload>.json       the limit of each number compared
  metrics/<metric>.py          ``read(run)`` -> the metric's value or None

The program under test is ``rcppml_tpu_torch``; this file and the files
above import it only through :func:`run_cell`'s fits, and the references
import nothing of it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

BENCH = Path(__file__).resolve().parent
# modules whose presence in sys.modules refuses a run: JAX and the JAX
# package, compared by whole top-level name (the port's name starts with
# the JAX package's and passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "rcppml_tpu")
# mixed into the seed of the starting factors, so that they are not drawn
# from the same stream as the data
INIT_SALT = 0x5EED


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by path (its name may hold dots, as metric names do),
    once per process."""
    name = "bench_" + re.sub(r"\W", "_", str(Path(path).resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with every file it names, loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench: Path

    def plugin(self, kind: str, name: str):
        return load_module(self.bench / kind / f"{name}.py")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; the benchmark's files
    are read from the directory beside this file (the first of ``paths``)."""
    spec = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(wl)})")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = (root / cfg_entry["file"]).resolve().parents[1]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[mt for mt in spec["end_to_end"] if applies(mt, name)],
        per_layer=[mt for mt in spec["per_layer"] if applies(mt, name)],
        bench=bench)


# ---------------------------------------------------------------------------
# Inputs and the fit
# ---------------------------------------------------------------------------

def draw_init(seed: int, m: int, n: int, k: int, device):
    """W0 (m, k) and H0 (k, n), uniform [0, 1), drawn on ``device`` from
    the seed and handed to the program and the reference alike (as host
    arrays: the program takes ``w_init`` / ``h_init`` as numpy)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ INIT_SALT) % 2**63)
    W0 = torch.rand((m, k), generator=gen, device=device)
    H0 = torch.rand((k, n), generator=gen, device=device)
    return W0.cpu().numpy(), H0.cpu().numpy()


@dataclass
class FitRecord:
    wall_s: float
    sweep_marks: list          # host clock at each sweep's callback


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def make_fit(cell: Cell, data, W0, H0, device):
    """A closure that runs one fit of the cell's traffic through the
    program's public entry and returns (NMFResult, FitRecord)."""
    import rcppml_tpu_torch as rtt
    tr = cell.traffic
    opts = dict(tr["nmf"])
    clock = bool(tr.get("sweep_clock"))

    def fit():
        marks = []
        extra = {}
        if clock:
            # the streaming engine reads each sweep's loss on the host
            # already; the callback only notes the time
            extra["on_iteration"] = lambda *_: marks.append(
                time.perf_counter())
        t0 = time.perf_counter()
        res = rtt.nmf(data, int(tr["k"]), w_init=W0, h_init=H0,
                      device=device, **opts, **extra)
        sync(device)
        t1 = time.perf_counter()
        return res, FitRecord(t1 - t0, [t - t0 for t in marks])
    return fit


# ---------------------------------------------------------------------------
# Judging the answers
# ---------------------------------------------------------------------------

def _match(Wp, Wr):
    """The permutation of the program's factors that best matches the
    reference's (by |cosine| of W's columns): ``sort_model`` orders both by
    d, and two nearly equal d may fall in either order."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    a = Wp / (np.linalg.norm(Wp, axis=0, keepdims=True) + 1e-300)
    b = Wr / (np.linalg.norm(Wr, axis=0, keepdims=True) + 1e-300)
    _, perm = linear_sum_assignment(-np.abs(b.T @ a))
    return perm


def numbers(prog: dict, ref: dict, Wd) -> dict:
    """Every number the comparison can hold to a limit, relative gaps all.

    ``prog``: the judged fit's W (m, k), d (k,), H (k, n) and loss_history;
    ``ref``: the reference's W, d, H and loss_history (float64); ``Wd``:
    the reference's ``w_update`` of the judged fit's own final H.

    ``hist3_rel``: the widest loss gap of the first three iterations;
    ``d_gap``: the widest scale gap against the largest d, after matching
    the factors; ``recon_gap``: the gap of the two reconstructions;
    ``fix_gap``: the widest entry gap of the fit's W diag(d) against its
    last update taken again from its own H, against that update's largest
    entry."""
    import numpy as np
    names = ("hist3_rel", "d_gap", "recon_gap", "fix_gap")
    out = dict.fromkeys(names, math.inf)
    hp = np.asarray(prog["loss_history"], np.float64)
    hr = np.asarray(ref["loss_history"], np.float64)
    if hp.shape == hr.shape:
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(hp - hr) / np.abs(hr)
        out["hist3_rel"] = float(np.where(np.isfinite(rel), rel,
                                          np.inf)[:3].max())
    Wp, dp, Hp = (np.asarray(prog[key], np.float64) for key in "WdH")
    Wr, dr, Hr = (np.asarray(ref[key], np.float64) for key in "WdH")
    if Wp.shape != Wr.shape or Hp.shape != Hr.shape or not (
            np.isfinite(Wp).all() and np.isfinite(Hp).all()
            and np.isfinite(dp).all()):
        return out
    p = _match(Wp, Wr)
    out["d_gap"] = float(np.abs(dp[p] - dr).max() / np.abs(dr).max())
    out["recon_gap"] = recon_gap((Wp, dp, Hp), (Wr, dr, Hr))
    out["fix_gap"] = float(np.abs(Wp * dp[None, :] - Wd).max()
                           / np.abs(Wd).max())
    return out


def recon_gap(prog, ref, device=None, block: int = 4096) -> float:
    """|| W d H - W_r d_r H_r ||_F / || W_r d_r H_r ||_F in float64, a
    block of columns at a time on ``device`` (default: the card if there
    is one): the gap of the two models' reconstructions, which does not
    depend on how the factors are ordered or split."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    f64 = torch.float64
    Wp, Wr = (torch.as_tensor(w * d[None, :], dtype=f64, device=device)
              for w, d, _ in (prog, ref))
    num = den = 0.0
    for j0 in range(0, prog[2].shape[1], block):
        Hp = torch.as_tensor(prog[2][:, j0:j0 + block], dtype=f64,
                             device=device)
        Hr = torch.as_tensor(ref[2][:, j0:j0 + block], dtype=f64,
                             device=device)
        R = Wr @ Hr
        num += float(((Wp @ Hp - R) ** 2).sum())
        den += float((R ** 2).sum())
    return math.sqrt(num / den)


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; a missing or non-finite number fails and is given as None (the
    result line is strict JSON)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = nums.get(name, math.nan)
        finite = math.isfinite(value)
        checks[name] = {"value": value if finite else None, "limit": limit}
        if not (finite and value <= limit):
            ok = False
    return ok, checks


def reference_numbers(cell: Cell, A, W0, prog: dict, device,
                      control: bool = False) -> dict:
    """Run the cell's plain reference on A and W0 and return :func:`numbers`
    of the program's answers against it.  ``control``: judge instead the
    reference itself computed in TF32 (float32 data, TF32 products), the
    precision below the configuration's float32."""
    import numpy as np
    import torch
    ref_mod = load_module(cell.bench / "reference"
                          / f"{cell.traffic['reference']}.py")
    f64 = torch.float64
    A64 = A.to(device, f64)
    ref = ref_mod.fit(A64, torch.as_tensor(W0).to(device, f64),
                      cell.traffic)
    if control:
        prog = ref_mod.fit_control(A.to(device, torch.float32),
                                   torch.as_tensor(W0).to(device,
                                                          torch.float32),
                                   cell.traffic)
    Wd = ref_mod.w_update(A64, torch.as_tensor(
        np.asarray(prog["H"], np.float64)).to(device))
    return numbers(prog, ref, Wd)


# ---------------------------------------------------------------------------
# One run of a cell
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    fits: list                          # FitRecord of every window fit
    window_s: float
    peak_bytes: Optional[int]
    sample: Any                         # one window fit's NMFResult
    work: tuple                         # (operations, bytes) of one fit
    peaks: dict
    trace: Optional[Any] = None         # trace_reduce.TraceSummary


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             fault=None) -> tuple[dict, dict]:
    """Set up, time and judge one run of cell ``name``.  Returns (the
    result line as a dict, the checks) — the caller prints them.

    ``fault``: for the harness's own tests, a function that takes the fit
    closure and returns a broken one; never used by a benchmark run."""
    import numpy as np
    import torch
    import rcppml_tpu_torch as rtt

    cell = load_cell(root, name)
    on_card = device.startswith("cuda")
    rtt.set_fp32_precision()
    m, n = int(cell.config["m"]), int(cell.config["n"])
    k = int(cell.traffic["k"])
    gen_mod = cell.plugin("generators", cell.config["generator"])
    input_mod = cell.plugin("inputs", cell.traffic["input"])
    work_mod = cell.plugin("work", cell.traffic["work"])
    peaks = load_json(cell.bench / "peaks.json")

    def mark(what):
        print(f"set-up: {what} at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr, flush=True)

    mark("imports done")
    A = gen_mod.make(cell.config, seed, device)
    W0, H0 = draw_init(seed, m, n, k, device)
    sync(device)
    mark("data made")
    workdir = tempfile.mkdtemp(prefix="nmfbench-")
    try:
        data, keep_A = input_mod.prepare(A, cell.traffic, workdir)
        if not keep_A:
            del A               # made again from the seed for the reference
        if on_card:
            torch.cuda.empty_cache()
        mark("input prepared")
        fit = make_fit(cell, data, W0, H0, device)
        if fault is not None:
            fit = fault(fit)
        fit()                   # warm-up: the cell's own shapes, once
        setup_s = time.perf_counter() - t_start
        mark("warm-up fit done")

        # ---- the measured window: closed loop, one caller ----
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(seed)
        records, sample, attempted, failed = [], None, 0, 0
        # no collection pauses inside the window: what set-up left is
        # collected and frozen, and the collector is off until the close
        gc.collect()
        gc.freeze()
        gc.disable()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                res, rec = fit()
            except Exception as exc:             # counted, reported, judged
                failed += 1
                print(f"fit failed: {exc!r}", file=sys.stderr)
                continue
            records.append(rec)
            # a reservoir of one: every fit equally likely to be judged
            if rng.random() * len(records) < 1.0:
                sample = res
        window_s = time.perf_counter() - t0
        gc.enable()
        gc.unfreeze()
        peak_bytes = int(torch.cuda.max_memory_allocated()) if on_card \
            else None

        summary = None
        if trace:
            summary = load_module(BENCH / "trace_reduce.py").trace_fits(
                fit, device, window_s / max(1, len(records)))
        work = work_mod.count(m, n, k, cell.traffic, sample, data) \
            if sample is not None else None
        run = Run(cell, setup_s, records, window_s, peak_bytes, sample,
                  work, peaks, summary)
        del fit, data
        # the process's peak, read before the reference runs on the card
        proc_peak = max(setup_peak, int(torch.cuda.max_memory_allocated())) \
            if on_card else 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()

    # ---- the answers against the plain reference ----
    if sample is not None:
        if not keep_A:
            A = gen_mod.make(cell.config, seed, device)
        prog = {"W": sample.W, "d": sample.d, "H": sample.H,
                "loss_history": sample.loss_history}
        nums = reference_numbers(cell, A, W0, prog, device)
        del A
    else:
        nums = {}
    correct, checks = judge(nums, cell.limits)
    correct = correct and failed == 0 and sample is not None

    metrics = {}
    for mt in (cell.per_layer if trace else cell.end_to_end):
        value = cell.plugin("metrics", mt["name"]).read(run)
        if value is not None:
            metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": proc_peak}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown
    line["checks"] = checks
    return line, checks


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that a run may not hold."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})

