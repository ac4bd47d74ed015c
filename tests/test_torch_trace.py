"""The spans and counters inside the port's fits (``utils/trace.py``).

Under ``torch.profiler`` an in-memory MSE fit and a ``.spz`` stream open
their ``rtt.*`` ranges as ``models/nmf.py`` and ``models/nmf_chunked.py``
document them, nested as documented, and fit the same bits as without the
profiler.  Without a profiler a span is one shared null context.  The
counters are on in every fit: ``res.misc["host_syncs"]`` counts each host
read of a device value (on the CPU only those: a CPU fit makes no
copies), and the stream's ``res.misc["stream"]`` counts its panels, their
bytes and the host seconds of their reads and copies.

The tests marked ``gpu`` hold the counter to what torch itself reports on
the card (``torch.cuda.set_sync_debug_mode``) and check that no span lays a
device record over the kernels; they skip without a card and import no
JAX:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_trace.py
"""

import contextlib
import inspect
import threading
import warnings
from collections import Counter

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch.io import loaders, upload
from rcppml_tpu_torch.io.panels import _compact_sparse
from rcppml_tpu_torch.models import nmf_chunked
from rcppml_tpu_torch.utils import trace

K, MAXIT, SWEEPS = 4, 20, 3
M, N, CHUNK = 60, 40, 16
# a dense fit's reads at its end: W, d, H, converged, final_tol, the
# train loss and the loss history (``finalize_result``)
FINAL_READS = 7


@pytest.fixture(scope="module")
def A():
    rs = np.random.RandomState(5)
    return (rs.poisson(2.0, size=(M, N)) * (rs.random_sample((M, N)) < 0.5)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def spz_path(A, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "a.spz")
    rtt.st_write(sp.csc_matrix(A), path, chunk_cols=CHUNK)
    return path


def panels(path):
    ld = loaders.SpzLoader(path)
    return ld.num_chunks(False), ld.num_chunks(True)


def traced(fn):
    """fn()'s result and the ``rtt.*`` host ranges it opened, as (start,
    end, name) sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("rtt."))
    return res, spans


def counts(spans):
    return Counter(name for _, _, name in spans)


def inside(spans, child, parent):
    """Each ``child`` range lies within some ``parent`` range."""
    outer = [(s, e) for s, e, name in spans if name == parent]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e, name in spans if name == child)


def fit_mse(A, **kw):
    return rtt.nmf(A, K, maxit=MAXIT, tol=0, seed=1, device="cpu", **kw)


def fit_stream(path, **kw):
    return rtt.nmf(path, K, maxit=SWEEPS, tol=0, seed=1, device="cpu", **kw)


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first = trace.span("rtt.a")
    assert isinstance(first, contextlib.nullcontext)
    assert trace.span("rtt.b") is first
    with first:
        pass


def test_span_is_a_range_of_its_own_under_the_profiler():
    """A range with the name, around the operators inside it, and of
    the operators' scope, not a user annotation (which the profiler
    would shadow on the device with a record covering the kernels)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("rtt.unit"):
            torch.ones(3).add_(1)
    ev = [e for e in prof.events() if e.name == "rtt.unit"]
    assert len(ev) == 1 and not ev[0].is_user_annotation
    assert {c.name for c in ev[0].cpu_children} >= {"aten::ones",
                                                    "aten::add_"}


def test_no_knob_turns_tracing_on():
    """The fits take no tracing argument and read no environment variable
    for it; the streaming engine and the upload take no ``stats=``."""
    for fn in (nmf_chunked.nmf_chunked, upload.upload):
        assert "stats" not in inspect.signature(fn).parameters
    assert not hasattr(nmf_chunked, "_TimedLoader")
    src = inspect.getsource(trace)
    assert "environ" not in src and "getenv" not in src


def test_mse_fit_spans_nest_as_documented(A):
    _, spans = traced(lambda: fit_mse(A))
    assert counts(spans) == {"rtt.nmf": 1, "rtt.fit.prepare": 1,
                             "rtt.loop": 1, "rtt.fit.h_update": MAXIT,
                             "rtt.fit.w_update": MAXIT,
                             "rtt.fit.loss": MAXIT, "rtt.fit.finalize": 1}
    for child in ("rtt.fit.prepare", "rtt.loop", "rtt.fit.finalize"):
        assert inside(spans, child, "rtt.nmf"), child
    for child in ("rtt.fit.h_update", "rtt.fit.w_update", "rtt.fit.loss"):
        assert inside(spans, child, "rtt.loop"), child
    # prepare, loop and finalize follow each other
    order = [name for _, _, name in spans
             if name in ("rtt.fit.prepare", "rtt.loop", "rtt.fit.finalize")]
    assert order == ["rtt.fit.prepare", "rtt.loop", "rtt.fit.finalize"]


def test_stream_spans_nest_as_documented(spz_path, A):
    fwd, tr = panels(spz_path)
    res, spans = traced(lambda: fit_stream(spz_path))
    c = counts(spans)
    assert c["rtt.nmf"] == c["rtt.loop"] == c["rtt.fit.finalize"] == 1
    # tr(A'A) comes from the first sweep's forward panels: no pass of its
    # own
    assert c["rtt.stream.trace_sq"] == 0
    assert res.misc["stream"]["trace_passes"] == 0
    assert res.misc["stream"]["trace_panels"] == fwd
    assert c["rtt.stream.sweep"] == c["rtt.stream.loss"] == SWEEPS
    assert c["rtt.stream.panel"] == (fwd + tr) * SWEEPS
    # the panels stay on the device after the first sweep: it alone reads
    # and uploads the forward ones, and only reads are waited on.  The file
    # is 43% dense and the dense cache is on, so its panels travel compact,
    # three arrays each, and are densified on the device once; the
    # transposed panels are built there from the forward ones, each in its
    # span inside its panel's
    assert c["rtt.stream.wait"] == fwd
    assert c["rtt.stream.upload"] == 3 * fwd
    assert c["rtt.stream.transpose"] == tr
    assert res.misc["stream"]["panels_decoded"] == fwd
    assert res.misc["stream"]["densified"] == fwd
    assert res.misc["stream"]["transposed_on_card"] == tr
    first = min((s, e) for s, e, name in spans
                if name == "rtt.stream.sweep")
    assert all(first[0] <= s and e <= first[1]
               for s, e, name in spans if name == "rtt.stream.wait")
    for child, parent in (("rtt.stream.sweep", "rtt.loop"),
                          ("rtt.loop", "rtt.nmf"),
                          ("rtt.stream.panel", "rtt.stream.sweep"),
                          ("rtt.stream.wait", "rtt.stream.sweep"),
                          ("rtt.stream.loss", "rtt.stream.sweep"),
                          ("rtt.stream.upload", "rtt.stream.panel"),
                          ("rtt.stream.transpose", "rtt.stream.panel"),
                          ("rtt.fit.finalize", "rtt.nmf")):
        assert inside(spans, child, parent), (child, parent)
    # a panel span holds the put and solve, never the wait for the panel
    waits = [(s, e) for s, e, name in spans if name == "rtt.stream.wait"]
    assert not any(s0 <= s and e <= e0 for s, e in waits
                   for s0, e0, name in spans if name == "rtt.stream.panel")
    # a loader that cannot give its COO panels' parts (the in-memory scipy
    # loader's) keeps one pass, in its span, before the loop
    res, spans = traced(lambda: fit_stream(sp.csc_matrix(A), streaming=True,
                                           chunk_cols=CHUNK))
    assert res.misc["stream"]["densified"] == fwd          # COO panels
    assert res.misc["stream"]["transposed_on_card"] == tr
    assert counts(spans)["rtt.stream.trace_sq"] == 1
    assert res.misc["stream"]["trace_passes"] == 1
    assert res.misc["stream"]["trace_panels"] == 0
    assert inside(spans, "rtt.stream.trace_sq", "rtt.nmf")
    loop = min(s for s, _, name in spans if name == "rtt.loop")
    assert all(e <= loop for _, e, name in spans
               if name == "rtt.stream.trace_sq")


@pytest.mark.parametrize("kind", ["mse", "stream"])
def test_the_profiler_changes_no_bit(kind, A, spz_path):
    fit = (lambda: fit_mse(A)) if kind == "mse" else \
        (lambda: fit_stream(spz_path))
    plain = fit()
    under, spans = traced(fit)
    assert spans
    for f in ("W", "d", "H", "loss_history"):
        assert np.array_equal(getattr(plain, f), getattr(under, f)), f


@pytest.mark.parametrize("case", ["dense", "uncached", "sparse"])
def test_stream_counts_its_panels_and_bytes(case, A, spz_path):
    """Uploads count the bytes handed to the device: the dense forward
    panels once (a cached stream, which builds its transposed panels on the
    device from them), the forward panels again in every loss pass and
    both sides every sweep (no cache), or the compact COO arrays of each
    panel (sparse panels, the wire cache)."""
    fwd, tr = panels(spz_path)
    ld = loaders.SpzLoader(spz_path)
    cfg = rtt.build_config(K, maxit=SWEEPS, tol=0, seed=1)
    engine = {"dense": dict(panel_cache=True, sparse_panels=False),
              "uncached": dict(panel_cache=False, sparse_panels=False),
              "sparse": dict(panel_cache="wire", sparse_panels=True)}[case]
    res = nmf_chunked.nmf_chunked(ld, cfg, device="cpu", **engine)
    st = res.misc["stream"]
    dense = 4 * M * N
    if case == "dense":
        assert st["upload_bytes"] == dense
        assert st["panels_decoded"] == fwd
        assert st["transposed_on_card"] == tr
        assert st["panel_cache_hits"] == fwd + (SWEEPS - 1) * (2 * fwd + tr)
    elif case == "uncached":
        assert st["upload_bytes"] == SWEEPS * 3 * dense
        assert st["panels_decoded"] == SWEEPS * (2 * fwd + tr)
        assert st["transposed_on_card"] == 0
        assert st["panel_cache_hits"] == 0
    else:
        compact = sum(sum(x.nbytes for x in (ch.rows, ch.counts, ch.vals))
                      for t in (False, True)
                      for ch in (_compact_sparse(ld.chunk_coo(c, t),
                                                 N if t else M)
                                 for c in range(ld.num_chunks(t))))
        assert st["upload_bytes"] == compact
        assert st["panels_decoded"] == fwd + tr
        assert st["transposed_on_card"] == 0
    assert len(st["sweep_s"]) == SWEEPS
    assert st["decode_s"] > 0 and st["wait_s"] > 0 and st["upload_s"] > 0
    assert "inner_iters" not in st


def test_irls_stream_counts_its_inner_iterations(spz_path):
    res = rtt.nmf(spz_path, K, loss="kl", maxit=2, tol=0, seed=1,
                  device="cpu")
    assert res.misc["stream"]["inner_iters"] > 0
    # a loss read a sweep, W, d, H, and the panel solves' own reads
    assert res.misc["host_syncs"] > 2 + 3


@pytest.mark.parametrize("case,syncs", [
    # the final reads only: tol=0 reads nothing in the loop, and a CPU fit
    # copies nothing
    ("mse", FINAL_READS),
    # tol > 0 reads `converged` before each iteration and once after
    ("mse_tol", None),
    # two loss reads a sweep (cross and reconstruction terms), W, d, H
    ("stream", 2 * SWEEPS + 3),
    # the wire cache's later sweeps read the saved-matrix loss once
    ("stream_wire", 2 + (SWEEPS - 1) + 3),
])
def test_host_syncs_is_a_fixed_count(case, syncs, A, spz_path):
    if case == "mse":
        res = fit_mse(A)
    elif case == "mse_tol":
        res = rtt.nmf(A, K, maxit=MAXIT, tol=1e-4, seed=1, device="cpu")
        syncs = res.iterations + res.converged + FINAL_READS
        assert 0 < res.iterations
    elif case == "stream":
        res = fit_stream(spz_path)
    else:
        res = nmf_chunked.nmf_chunked(
            loaders.SpzLoader(spz_path),
            rtt.build_config(K, maxit=SWEEPS, tol=0, seed=1), device="cpu",
            panel_cache="wire", sparse_panels=True)
    assert res.misc["host_syncs"] == syncs


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_counts_on_the_consumers_thread(depth, spz_path):
    """Every chunk in order, each read counted once; with depth 0 the reads
    run on the consumer's own thread."""
    ld = loaders.SpzLoader(spz_path)
    seen = []

    def transform(ch):
        seen.append(threading.get_ident())
        return ch
    pf = loaders.Prefetcher(ld, transpose=False, depth=depth,
                            transform=transform)
    try:
        got = [ch.col_start for ch in pf]
    finally:
        pf.close()
    assert got == [ld.chunk(c).col_start for c in range(ld.num_chunks())]
    assert pf.decoded == ld.num_chunks()
    assert pf.decode_s > 0 and pf.wait_s > 0
    me = threading.get_ident()
    assert all(t == me for t in seen) == (depth == 0)


def test_span_table_and_idle_by_span():
    """``tools/torch_fit_spans.py``'s reduction of nested spans (times in
    us): self time is the total less the direct children, and idle time
    goes to the innermost span open, split where spans begin and end."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_fit_spans.py"
    spec = importlib.util.spec_from_file_location("torch_fit_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    spans = [(0, 100, "a"), (10, 40, "b"), (50, 60, "b"), (20, 30, "c")]
    table = {k: [v[0], round(v[1] * 1e6), round(v[2] * 1e6)]
             for k, v in tool.span_table(spans).items()}
    assert table == {"a": [1, 100, 60], "b": [2, 40, 30], "c": [1, 10, 10]}
    idle = {k: round(v * 1e6) for k, v in tool.idle_by_span(
        spans, [(5, 25), (45, 55), (90, 120)]).items()}
    assert idle == {"a": 20, "b": 15, "c": 5, tool.NO_SPAN: 20}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    from rcppml_tpu_torch.device import kernels_available, set_fp32_precision
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if not kernels_available():
        pytest.skip("the kernels are built for sm_90a "
                    "(compute capability 9.0)")
    set_fp32_precision()
    return torch.device("cuda")


# what torch warns at each synchronizing call in "warn" mode (the mode's
# own first warning, that it is a prototype, is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"


def synced(fn):
    """fn()'s result and the synchronizing calls torch reports during it,
    each as the "file:line" that made it."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, [f"{w.filename}:{w.lineno}" for w in caught
                 if SYNC_WARNING in str(w.message)]


def card_fits(A, path, dev):
    rs = np.random.RandomState(2)
    W0 = rs.random_sample((M, K)).astype(np.float32)
    H0 = rs.random_sample((K, N)).astype(np.float32)
    A_dev = torch.from_numpy(A).to(dev)
    cfg = rtt.build_config(K, maxit=5, tol=0, seed=1)
    return {
        # the benchmark's in-memory call: A on the card, starting factors
        # from the host
        "tensor": lambda: rtt.nmf(A_dev, K, w_init=W0, h_init=H0, maxit=5,
                                  tol=0, seed=1),
        "host_array": lambda: rtt.nmf(A, K, maxit=5, tol=0, seed=1),
        "tol": lambda: rtt.nmf(A_dev, K, maxit=30, tol=1e-3, seed=1),
        "stream": lambda: rtt.nmf(path, K, w_init=W0, h_init=H0, maxit=5,
                                  tol=0, seed=1),
        "stream_wire": lambda: nmf_chunked.nmf_chunked(
            loaders.SpzLoader(path), cfg, panel_cache="wire",
            sparse_panels=True),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tensor", "host_array", "tol", "stream",
                                  "stream_wire"])
def test_host_syncs_is_what_torch_reports_on_the_card(cuda, case, A,
                                                      spz_path):
    fit = card_fits(A, spz_path, cuda)[case]
    fit()                                   # kernels loaded, memory held
    res, reported = synced(fit)
    assert res.misc["host_syncs"] == len(reported), Counter(reported)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tensor", "stream"])
def test_spans_lay_no_device_record_on_the_card(cuda, case, A, spz_path):
    fit = card_fits(A, spz_path, cuda)[case]
    fit()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    names = [(e.name, e.device_type) for e in prof.events()]
    assert any(n.startswith("rtt.") and d == DeviceType.CPU
               for n, d in names)
    assert not any(n.startswith("rtt.") and d == DeviceType.CUDA
                   for n, d in names)
