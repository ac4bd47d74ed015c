"""Run one cell of the benchmark of ``rcppml_tpu_torch`` on this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Set-up (imports,
the kernels' load or build into ``rcppml_tpu_torch/_build/``, the data made
on the card from the seed, the input written, one warm-up fit) is timed as
``setup_s``; then fits run back to back for ``--seconds``.  With ``--trace
1`` a few more fits run under ``torch.profiler`` and the per-layer metrics
are reported instead of the end-to-end ones.  After the window the sampled
fit's answers are compared with the plain reference (``reference/``); each
number compared is printed beside its limit as the last lines on standard
error.  The last line on standard output is the result as one JSON object.

Exits with 2, printing no result, without a CUDA card or with fewer cards
than the cell asks for; with 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the run stays on fixed cores, the last CORES the machine allows, set
# before any thread starts so that every later thread (the card's, the
# stream's decode workers) inherits them: a fit loop bound by the host's
# launches times less steadily when it moves between cores
CORES = 4
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-CORES:])

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

import harness  # noqa: E402


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc!r}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: int(w["chips"]) for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", flush=True)
    line, checks = harness.run_cell(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace), "cuda",
                                    T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: the run loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in checks.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
