"""Trace a few fits with ``torch.profiler`` and reduce the trace to what the
per-layer metrics and the breakdown read.

Device activity is every CUDA event of the trace (kernels, copies, memsets).
The traced window is a ``record_function`` span around the fits, so device
and host times share the trace's clock.  Busy time is the union of the
device intervals inside the window; an idle gap is a stretch of the window
with none, named after the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from dataclasses import dataclass, field

# traced fits: enough to span about TRACE_S seconds, at least one, at most
# TRACE_MAX_FITS (the trace of a streamed fit holds ~26,000 device events)
TRACE_S, TRACE_MAX_FITS = 1.0, 5
# idle gaps named one by one, longest first; the rest are summed as one
NAMED_GAPS = 5000
WINDOW = "bench.traced_fits"


@dataclass
class TraceSummary:
    fits: int
    window_s: float
    busy_s: float
    device_s: float
    launches: int
    breakdown: dict = field(default_factory=dict)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """The name of the shortest host event that contains time t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "(Python between operations)"


def trace_fits(fit, device, wall_s: float = 0.0) -> TraceSummary:
    """Trace ``fit()`` a few times after it has run warm; ``wall_s`` is a
    fit's usual wall time (sets how many fits are traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = str(device).startswith("cuda")
    count = 1 if wall_s <= 0 else max(1, min(TRACE_MAX_FITS,
                                             math.ceil(TRACE_S / wall_s)))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(count):
                fit()
    events = prof.events()
    win = [e for e in events
           if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        return TraceSummary(count, 0.0, 0.0, 0.0, 0)
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.name == WINDOW:        # the span's host and device records
            continue
        s, t = e.time_range.start, e.time_range.end
        (dev if e.device_type == DeviceType.CUDA else host).append(
            (s, t, e.name))
    by_name = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
    device_s = sum(by_name.values())
    merged = _merge([(max(s, w0), min(t, w1)) for s, t, _ in dev
                     if t > w0 and s < w1])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    # idle gaps inside the window, named by what the host was doing
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for length, s, e in gaps[:NAMED_GAPS]:
        idle[_innermost(host, starts, 0.5 * (s + e))] += length * 1e-6
    rest = sum(g[0] for g in gaps[NAMED_GAPS:]) * 1e-6
    if rest > 0:
        idle["(shorter gaps)"] += rest
    top = lambda d: [[k, v] for k, v in                      # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return TraceSummary(
        fits=count, window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        device_s=device_s, launches=len(dev),
        breakdown={"device_ops": top(by_name), "idle_gaps": top(idle)})
