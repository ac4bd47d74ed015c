"""Spans and counters inside the fits.

``span(name)`` is a profiler range while a profiler records on the calling
thread (``torch.profiler``, or ``torch.autograd.profiler.emit_nvtx()`` for
an Nsight run), and one shared null context otherwise: tracing has no
switch of its own.  A range is the span's record (name, start, end), on
the profiler's clock beside the kernels; nesting on the thread gives its
parent.  Every name starts with ``rtt.``; each ``nmf`` call is one
``rtt.nmf`` range (the fits a call makes through ``nmf`` again, as the
restarts of ``seed=[...]`` do, nest theirs inside it).

The range is one of the scope torch's own operators have
(``torch._C._profiler._RecordFunctionFast``), not the user scope of
``torch.profiler.record_function``: for a user-scope range the profiler
also lays a device record over the kernels launched inside it, which a
trace reader would count as one more device activity covering them all.

``Syncs`` counts a fit's synchronizing calls where they are made, always:
every host read of a device value and every blocking copy of a host array
to a card (``res.misc["host_syncs"]``).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared null context (a fraction of a microsecond)."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def spans(name: str, items):
    """Yield each of ``items`` inside a ``span(name)`` of its own: the span
    covers the body of the loop that takes it, and not the wait for the
    next item."""
    for item in items:
        with span(name):
            yield item


def spanned(name: str):
    """Decorate a function so that each call is one ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Syncs:
    """The count of one fit's synchronizing calls, made at each call site:
    a device value read on the host waits for the device to reach it, and
    a blocking upload waits for its copy."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as a host array: one read."""
        self.n += 1
        return t.detach().cpu().numpy()

    def to(self, t: torch.Tensor, dev: torch.device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``t`` as ``dtype`` on ``dev``: one blocking copy where it moves
        between the host and a card (a CPU fit copies nothing)."""
        if t.device.type != dev.type:
            self.n += 1
        return t.to(dev, dtype)
