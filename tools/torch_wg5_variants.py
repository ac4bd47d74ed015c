#!/usr/bin/env python3
"""Take kernel 5's tile (``csrc/tri_gram.cuh``) apart on the card.

    python3 tools/torch_wg5_variants.py VARIANT [VARIANT ...]

Each VARIANT is ``base`` (the header as it is) or names joined with ``+``
from ``VARIANTS`` below, each a text edit of a copy of the header:
``nocopy`` (no ``cp.async`` is issued: the products alone, on whatever lies
in shared memory), ``noconv`` (F at k2 is not split into its TF32 planes),
``single`` (one TF32 product instead of three: the a_lo and b_lo terms
dropped), ``nomma`` (no Gram product at all), ``oneblock`` (the launch
bounds ask for one block a multiprocessor, so no register is spilled) and
``stages2`` (a ring of two stages).  Every variant is built side by side
with ``nvcc`` into ``rcppml_tpu_torch/_build/variants/``, from
``csrc/weighted_gram.cu`` with the edited header first on the include path.

For the two column blocks of the masked k=128 fit's H side, (k, m, bc) =
(128, 13,714, 68) and (128, 13,714, 54), at the plan of
``ops/weighted_gram.py::plan_weighted_gram``, it prints each variant's device
time (CUDA events, median of 7 after a warm-up) and, for ``base``, the error
against the twin.  Needs a CUDA card of compute capability 9.0; imports no
JAX.
"""

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from rcppml_tpu_torch.ops import _build  # noqa: E402
from rcppml_tpu_torch.ops import rhs_tall  # noqa: E402
from rcppml_tpu_torch.ops import weighted_gram as wg5  # noqa: E402

OUT = os.path.join(str(_build.BUILD_DIR), "variants")
MMA_SMALL = ("          tf32::mma(part[c][jt], al[c], x[0], x[1]);\n"
             "          tf32::mma(part[c][jt], ah[c], x[2], x[3]);\n")
MMA_BIG = "          tf32::mma(part[c][jt], ah[c], x[0], x[1]);\n"
VARIANTS = {
    "nocopy": [("if (next < n_stages) issue(", "if (false) issue("),
               ("if (s < n_stages) issue(", "if (false) issue(")],
    "noconv": [("for (int i = 0; i < kWt * kRowsJ / kWarps; ++i) {",
                "for (int i = 0; i < 0; ++i) {")],
    "single": [(MMA_SMALL, "")],
    "nomma": [(MMA_SMALL + MMA_BIG, "")],
    "oneblock": [("__launch_bounds__(kThreads, 2)",
                  "__launch_bounds__(kThreads, 1)")],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def build(variant):
    """Compile weighted_gram.cu against an edited copy of the headers."""
    src_dir = os.path.join(OUT, variant.replace("+", "_"))
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(str(_build.CSRC), src_dir)
    path = os.path.join(src_dir, "tri_gram.cuh")
    text = open(path).read()
    for name in ([] if variant == "base" else variant.split("+")):
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the header")
            text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(src_dir, "libwg5.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
           os.path.join(src_dir, "weighted_gram.cu")]
    return cmd, lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_wg5_variants: CUDA is not available")
    variants = sys.argv[1:] or ["base"]
    os.makedirs(OUT, exist_ok=True)
    jobs = [build(v) for v in variants]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, _ in jobs]
    libs = {}
    for v, (cmd, lib), p in zip(variants, jobs, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {v}:\n{out}")
        regs = sorted({line.split(":")[-1].strip() for line in
                       out.splitlines() if "registers" in line
                       or "spill" in line})
        print(f"{v}: {'; '.join(regs)}", flush=True)
        fn = ctypes.CDLL(lib).weighted_gram_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[v] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    k, m = 128, 13714
    F = torch.rand((k, m), device="cuda", generator=gen)
    sms = rhs_tall.device_sms(F.device)
    for bc in (68, 54):
        wide = torch.rand((m, bc + 40), device="cuda", generator=gen)
        w = (wide >= 0.1).float()[:, 17:17 + bc]
        A = torch.poisson(wide * 0.8)[:, 17:17 + bc]
        wc, splits, chunk = wg5.plan_weighted_gram(k, m, bc, sms)
        n = wg5.scratch_floats(k, bc, splits)
        scratch = torch.empty((max(n, 1),), device="cuda")
        Gb = torch.empty((bc, k, k), device="cuda")
        b = torch.empty((k, bc), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for v, fn in libs.items():
            def call():
                err = fn(F.data_ptr(), w.data_ptr(), A.data_ptr(),
                         Gb.data_ptr(), b.data_ptr(), k, m, bc, w.stride(0),
                         A.stride(0), wc, splits, chunk, scratch.data_ptr(),
                         stream)
                if err:
                    raise RuntimeError(f"{v}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(7):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            note = ""
            if v == "base":
                Gp, bp = wg5.weighted_gram_plain(F, w, A)
                note = (f", Gb off by "
                        f"{float((Gb - Gp).abs().max() / Gp.abs().max()):.2e}"
                        f" of the largest entry")
            print(f"bc={bc} ({splits} splits, {wc} column pairs a block) "
                  f"{v}: {statistics.median(times):.4f} ms{note}", flush=True)


if __name__ == "__main__":
    main()
