#!/usr/bin/env python3
"""The port's spans and sync counter in one benchmark cell, on the card.

    PYTHONPATH=. python3 tools/torch_fit_spans.py --workload <cell> \\
        --seed <n> [--fits 5] [--out chiprun_out/spans.json]

from the root of a checkout.  The cell's data, starting factors and input
are made as ``benchmark/run.py`` makes them (``benchmark/harness.py``); one
warm-up fit, then

  * two fits under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing calls torch reports in each (and the Python line of
    each) against the fit's own count, ``res.misc["host_syncs"]``;
  * ``--fits`` fits under ``torch.profiler`` (host and device), reduced as
    the benchmark's ``trace_reduce.py`` reduces them (device activity,
    busy and idle time), and besides: the device records named after a
    ``rtt.*`` span (none are expected), the table of the program's spans
    (count, total and self ms a fit; self = total less the spans opened
    inside), the idle time by the innermost span open ("(no span)" where
    none is), the fit's time outside its loop (``rtt.nmf`` less
    ``rtt.loop``) and the loop's enqueue time (``rtt.fit.h_update`` +
    ``w_update`` + ``loss``), each a fit.

Prints one JSON object.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import shutil
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from pathlib import Path

NO_SPAN = "(no span)"
WINDOW = "tool.traced_fits"


def span_table(spans) -> dict:
    """{name: [count, total s, self s]} of nested spans (s, e, name), times
    in us; self is the total less the direct children."""
    table, stack = {}, []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        dur = (e - s) * 1e-6
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dur
        row[2] += dur
        if stack:
            table[stack[-1][2]][2] -= dur
        stack.append((s, e, name))
    return table


def idle_by_span(spans, gaps) -> dict:
    """The seconds of ``gaps`` [(s, e)] by the name of the innermost span
    open: constant between consecutive span boundaries."""
    points = sorted({x for s, e, _ in spans for x in (s, e)})
    steps, stack, j = [], [], 0
    ordered = sorted(spans, key=lambda x: (x[0], -x[1]))
    for a, b in zip(points[:-1], points[1:]):
        mid = 0.5 * (a + b)
        while j < len(ordered) and ordered[j][0] <= mid:
            stack.append(ordered[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        steps.append(stack[-1][2] if stack else NO_SPAN)
    out = defaultdict(float)
    for s, e in gaps:
        k = bisect.bisect_right(points, s) - 1
        while s < e:
            end = min(e, points[k + 1]) if k + 1 < len(points) else e
            out[steps[k] if 0 <= k < len(steps) else NO_SPAN] += \
                (end - s) * 1e-6
            s, k = end, k + 1
    return dict(out)


def reduce(events, fits: int) -> dict:
    from torch.autograd import DeviceType
    win = [e for e in events
           if e.name == WINDOW and e.device_type == DeviceType.CPU][0]
    w0, w1 = win.time_range.start, win.time_range.end
    dev, spans, span_dev = [], [], 0
    for e in events:
        if e.name == WINDOW:
            continue
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((s, t))
            span_dev += e.name.startswith("rtt.")
        elif e.name.startswith("rtt.") and w0 <= s and t <= w1:
            spans.append((s, t, e.name))
    merged = []
    for s, t in sorted((max(s, w0), min(t, w1)) for s, t in dev
                       if t > w0 and s < w1):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    window_s = (w1 - w0) * 1e-6
    busy_s = sum(t - s for s, t in merged) * 1e-6
    idle_s = window_s - busy_s
    table = span_table(spans)
    idle = idle_by_span(spans, gaps)

    def total(name):
        return table.get(name, [0, 0.0, 0.0])[1]
    per_fit = {name: {"count": row[0] / fits, "total_ms": row[1] / fits * 1e3,
                      "self_ms": row[2] / fits * 1e3}
               for name, row in sorted(table.items())}
    return {
        "fits": fits, "wall_ms_per_fit_under_profiler": window_s / fits * 1e3,
        "device_events_per_fit": len(dev) / fits,
        "device_records_named_rtt": span_dev,
        "device_idle_pct": 100.0 * idle_s / window_s,
        "spans_per_fit": per_fit,
        "idle_ms_per_fit_by_span": {k: v / fits * 1e3 for k, v in
                                    sorted(idle.items(), key=lambda kv:
                                           -kv[1])},
        "idle_unspanned_pct": 100.0 * idle.get(NO_SPAN, idle_s) / idle_s
        if idle_s > 0 else None,
        "outside_loop_ms": (total("rtt.nmf") - total("rtt.loop")) / fits
        * 1e3,
        "dispatch_ms": sum(total(f"rtt.fit.{p}") for p in
                           ("h_update", "w_update", "loss")) / fits * 1e3,
        "loop_ms": total("rtt.loop") / fits * 1e3,
    }


# what torch warns at each synchronizing call in "warn" mode (the mode's
# own first warning, that it is a prototype, is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"


def synced_calls(fit):
    """fit()'s result and the synchronizing calls torch reports during it,
    each as the "file:line" of the Python line that made it."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fit()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if SYNC_WARNING in str(w.message)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fits", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    root = Path.cwd()
    sys.path.insert(0, str(root / "benchmark"))
    import harness
    import rcppml_tpu_torch as rtt
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = "cuda"
    rtt.set_fp32_precision()
    cell = harness.load_cell(root, args.workload)
    m, n, k = (int(cell.config["m"]), int(cell.config["n"]),
               int(cell.traffic["k"]))
    A = cell.plugin("generators", cell.config["generator"]).make(
        cell.config, args.seed, dev)
    W0, H0 = harness.draw_init(args.seed, m, n, k, dev)
    workdir = tempfile.mkdtemp(prefix="nmfspans-")
    try:
        data, _ = cell.plugin("inputs", cell.traffic["input"]).prepare(
            A, cell.traffic, workdir)
        opts = dict(cell.traffic["nmf"])

        def fit():
            return rtt.nmf(data, k, w_init=W0, h_init=H0, device=dev,
                           **opts)
        fit()
        synced = [synced_calls(fit) for _ in range(2)]
        res = synced[-1][0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(args.fits):
                    fit()
                    torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = {"workload": args.workload, "seed": args.seed,
               "card": torch.cuda.get_device_name(0),
               "host_syncs": res.misc.get("host_syncs"),
               "syncs_torch_reports": [len(sites) for _, sites in synced],
               "sync_sites": [sites for _, sites in synced],
               "stream": res.misc.get("stream"),
               **reduce(prof.events(), args.fits)}
        out["reduce_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
