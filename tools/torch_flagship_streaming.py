#!/usr/bin/env python3
"""The flagship streaming workload on the port, on one CUDA card.

The reference's headline streampress workload is a 38,606 x 278,676 scRNA
matrix with 554M nonzeros: 43 GB as dense float32, far more than a card
holds (BASELINE.md:29).  This tool

  * ``--gen``: synthesizes a matrix of that shape and sparsity with the
    distribution of ``tools/flagship_streaming.py::synthesize`` (gene
    popularity lognormal(0, 1.6), cell depth lognormal(0, 0.35), values
    1 + geometric(0.42), coordinates drawn, sorted and deduplicated; its
    own copy, as the port's tools import nothing of the JAX package) and
    writes it through the port's ``st_write`` (forward and transpose
    streams, 2,048 columns a chunk);
  * ``--fit``: runs ``models/nmf_chunked.py::nmf_chunked`` on the file,
    k=20, ``--sweeps`` sweeps, on the card (sparse panels and the wire
    cache, as the engine's auto rules pick them there), and prints for each
    sweep its wall time, the host time the Prefetcher's workers spent
    decoding and compacting (summed over the workers), the host time of the
    uploads, the device time (``torch.profiler``, kernels and copies on the
    card) and the device busy share (device time over wall time).

Usage, on a machine with the card, from the repository's root:

    PYTHONPATH=. python3 tools/torch_flagship_streaming.py --gen --fit \\
        --sweeps 2 --out flagship.json

The file goes to ``--path`` (default ``$TMPDIR/flagship.spz``, about a
gigabyte); ``--m``/``--n``/``--nnz`` shrink the workload for a smoke run.  Imports
no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def synthesize(m: int, n: int, target_nnz: int, seed: int = 0):
    """scRNA-shaped sparse counts with the distribution of
    ``tools/flagship_streaming.py::synthesize``: (indptr, rows, vals) of a
    CSC matrix.

    Coordinates are i.i.d. draws, column ~ cell depth, row ~ gene
    popularity, deduplicated; values 1 + geometric(0.42).  Here the column
    of the draws comes as multinomial counts (the exact law of the column
    counts of i.i.d. draws, and already in order) and the rows by inverse
    CDF on the card; each column's rows are then sorted and deduplicated
    through one int64 key.  The JAX tool oversamples by a fixed 3.5%, which
    the heavy head of the popularity leaves 15% short of the target after
    deduplication (its runs had 469M nonzeros, FLAGSHIP_r05.json); here the
    draws start 29% over the target (what a tenth of the workload needed)
    and are redrawn with the oversampling raised by the shortfall until the
    unique count is within 1% of the target."""
    import torch
    rs = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.time()
    pop = rs.lognormal(0.0, 1.6, m)
    cdf = torch.from_numpy(np.cumsum(pop / pop.sum())).cuda()
    depth = rs.lognormal(0.0, 0.35, n)
    depth = depth / depth.sum()
    factor = 1.29
    for _ in range(4):
        draw = int(target_nnz * factor)
        # column of each draw ~ depth, row ~ popularity
        counts = rs.multinomial(draw, depth)
        key = np.repeat(np.arange(n, dtype=np.int64) * m, counts)
        for lo in range(0, draw, 1 << 26):
            hi = min(lo + (1 << 26), draw)
            u = torch.rand(hi - lo, dtype=torch.float64, device="cuda",
                           generator=gen)
            key[lo:hi] += torch.searchsorted(cdf, u).clamp_max(
                m - 1).cpu().numpy()
        key.sort()
        keep = np.empty(draw, bool)
        keep[0] = True
        np.not_equal(key[1:], key[:-1], out=keep[1:])
        key = key[keep]
        del keep
        nnz = len(key)
        print(f"[gen] {draw} draws (oversampling {factor:.3f}): {nnz} "
              f"unique", flush=True)
        if nnz >= 0.99 * target_nnz:
            break
        factor *= 1.02 * target_nnz / nnz
    cols, rows = np.divmod(key, m)
    del key
    vals = (1.0 + rs.geometric(0.42, nnz).astype(np.float32))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=n), out=indptr[1:])
    print(f"[gen] {m} x {n} nnz={nnz} (density {nnz / (m * n) * 100:.3f}%) "
          f"in {time.time() - t0:.1f} s", flush=True)
    return indptr, rows.astype(np.int32), vals


def write_spz(indptr, rows, vals, m, n, path):
    import scipy.sparse as sp

    from rcppml_tpu_torch.io.spz import st_write
    A = sp.csc_matrix((vals, rows, indptr), shape=(m, n))
    t0 = time.time()
    info = st_write(A, path, chunk_cols=2048, with_transpose=True)
    dt = time.time() - t0
    raw = len(vals) * 8 + (n + 1) * 8        # the reference's raw-CSC basis
    size = os.path.getsize(path)
    print(f"[spz] wrote {size / 1e9:.3f} GB in {dt:.1f} s (values "
          f"{info['value_type']}, {raw / size:.2f}x smaller than raw CSC)",
          flush=True)
    return {"file_gb": size / 1e9, "write_seconds": dt,
            "compression_ratio_vs_raw_csc": raw / size,
            "value_type": info["value_type"], "nnz": int(len(vals))}


def run_fit(path: str, k: int, sweeps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.io.loaders import SpzLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked

    class TimedLoader(SpzLoader):
        """Sums the host seconds of the decodes (in the workers)."""
        decode_s = 0.0

        def chunk_coo(self, idx, transpose=False):
            t0 = time.perf_counter()
            out = super().chunk_coo(idx, transpose)
            TimedLoader.decode_s += time.perf_counter() - t0
            return out

        def chunk(self, idx, transpose=False):
            t0 = time.perf_counter()
            out = super().chunk(idx, transpose)
            TimedLoader.decode_s += time.perf_counter() - t0
            return out

    loader = TimedLoader(path)
    m, n = loader.shape
    nnz = loader.nnz()
    panels = (loader.num_chunks(False), loader.num_chunks(True))
    print(f"[fit] {m} x {n} nnz={nnz} panels {panels[0]} forward + "
          f"{panels[1]} transpose, k={k}, {sweeps} sweeps", flush=True)
    stats: dict = {}
    sweeps_out = []
    state = {"prof": None, "t0": 0.0, "decode": 0.0, "upload": 0.0}

    def start():
        state["prof"] = profile(activities=[ProfilerActivity.CUDA])
        state["prof"].__enter__()
        state["t0"] = time.perf_counter()
        state["decode"] = TimedLoader.decode_s
        state["upload"] = stats.get("upload_s", 0.0)

    def on_sweep(sweep, loss, _test):
        torch.cuda.synchronize()
        wall = time.perf_counter() - state["t0"]
        prof = state["prof"]
        prof.__exit__(None, None, None)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_s = sum(e.self_device_time_total for e in rows) / 1e6
        rec = {"sweep": sweep, "wall_s": wall,
               "host_decode_s": TimedLoader.decode_s - state["decode"],
               "upload_host_s": stats.get("upload_s", 0.0) - state["upload"],
               "device_s": device_s, "device_busy": device_s / wall,
               "device_kernels": sum(e.count for e in rows), "loss": loss}
        sweeps_out.append(rec)
        print(f"[sweep {sweep}] wall {wall:.2f} s, host decode "
              f"{rec['host_decode_s']:.2f} s (summed over the workers), "
              f"upload {rec['upload_host_s']:.2f} s of host time, device "
              f"{device_s:.3f} s ({100 * rec['device_busy']:.1f}% busy, "
              f"{rec['device_kernels']} kernels and copies), loss {loss:.8g}",
              flush=True)
        start()

    cfg = rtt.build_config(k, seed=1, maxit=sweeps, tol=0.0,
                           sort_model=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start()
    res = nmf_chunked(loader, cfg, on_iteration=on_sweep, stats=stats)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    state["prof"].__exit__(None, None, None)
    print(f"[fit] {total:.2f} s for {res.iterations} sweeps (with the "
          f"profiler's start-ups; the sweeps themselves "
          f"{sum(r['wall_s'] for r in sweeps_out):.2f} s); "
          f"{stats.get('upload_bytes', 0) / 2**30:.2f} GiB uploaded; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    return {"shape": [m, n], "nnz": nnz, "k": k, "panels": list(panels),
            "total_seconds": total, "sweeps": sweeps_out,
            "upload_gib": stats.get("upload_bytes", 0) / 2**30,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "train_loss": float(res.train_loss)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--m", type=int, default=38606)
    ap.add_argument("--n", type=int, default=278676)
    ap.add_argument("--nnz", type=int, default=554_000_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--path", default=os.path.join(tempfile.gettempdir(),
                                                   "flagship.spz"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flagship_streaming: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "workload": {"m": args.m, "n": args.n,
                                         "target_nnz": args.nnz}}
    if args.gen:
        indptr, rows, vals = synthesize(args.m, args.n, args.nnz)
        record["spz"] = write_spz(indptr, rows, vals, args.m, args.n,
                                  args.path)
        del indptr, rows, vals
    if args.fit:
        record["fit"] = run_fit(args.path, args.k, args.sweeps)
    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
