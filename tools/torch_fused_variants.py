#!/usr/bin/env python3
"""Take kernel 3 (``csrc/fused_als.cu`` and its headers) apart on the card.

    python3 tools/torch_fused_variants.py VARIANT [VARIANT ...]

Each VARIANT is ``base`` (the sources as they are) or names joined with
``+`` from ``VARIANTS`` below, each a text edit of a copy of ``csrc/``:
``nosteps`` (no Newton-Schulz step: the k x k section's set-up and rescale
alone), ``noproducts`` (the k x k products return at once), ``alltc`` (the
last Newton-Schulz step on the tensor cores too), ``localb`` (every B
operand read from the block's own rows: the cost of distributed shared
memory; the fit is no longer right), ``empty`` (the
k x k kernel returns at once, leaving the inverses as they were: the time of
its launch alone, and a fit that is no longer right), ``clocks`` (prints the
cycles between phases of the last k x k section: set-up and partial sums,
trace and ridge, seed, rescale product, norm, then each step's two
products), ``nonorms`` (the
norms of the k x k section are 1), ``nopartials`` (the k x k section reads
one Gram partial instead of all of them).  Every variant is built side by
side with ``nvcc`` into ``rcppml_tpu_torch/_build/variants/`` and loaded in
place of the package's library.

For the whole fit of 20 iterations at pbmc3k (13,714 x 2,638, k=20) and
movielens (3,867 x 610, k=50 and k=150), float32, it prints each variant's
time (CUDA events, median of 5 after a warm-up) and, from ``torch.profiler``
over one call, the device time of each kernel of the sequence summed by
name, and the time between kernels (the call's device span less the kernels'
sum).  Needs a CUDA card of compute capability 9.0; imports no JAX.
"""

import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from rcppml_tpu_torch.ops import _build  # noqa: E402
from rcppml_tpu_torch.ops import fused_als  # noqa: E402

OUT = os.path.join(str(_build.BUILD_DIR), "variants")
VARIANTS = {
    "nosteps": [("kxk_refine.cuh",
                 "for (int step = 0; step < ns_steps; ++step) {",
                 "for (int step = 0; step < 0; ++step) {")],
    "noproducts": [("kxk_refine.cuh",
                    "  const int warp = threadIdx.x / 32, warps = blockDim.x "
                    "/ 32;\n  const int cols",
                    "  if (s.k > 0) { sync_all(s); return; }\n"
                    "  const int warp = threadIdx.x / 32, warps = blockDim.x "
                    "/ 32;\n  const int cols")],
    "empty": [("kxk_refine.cuh", "float shared[];\n  cg::cluster_group "
               "cluster = cg::this_cluster();\n  Shape s;",
               "float shared[];\n  if (k > 0) return;\n  cg::cluster_group "
               "cluster = cg::this_cluster();\n  Shape s;"),
              ("kxk_block.cuh", "float shared[];\n  const int ld = "
               "row_stride(k);",
               "float shared[];\n  if (k > 0) return;\n  const int ld = "
               "row_stride(k);")],
    # clock64 of thread 0 of block 0 at the k x k section's phases, into a
    # device array that clock_read copies out (the last refine's stamps)
    "clocks": [
        ("kxk_refine.cuh", "namespace kxk {\n",
         "namespace kxk {\n__device__ long long clocks[40];\n"
         "#define STAMP(i) if (threadIdx.x == 0 && blockIdx.x == 0) "
         "clocks[i] = clock64();\n"),
        ("kxk_refine.cuh", "  const size_t kk = static_cast<size_t>(k) * k;\n",
         "  const size_t kk = static_cast<size_t>(k) * k;\n  STAMP(0)\n"),
        ("kxk_refine.cuh", "  __syncthreads();\n  if (tid == 0) {\n    float tr",
         "  __syncthreads();\n  STAMP(1)\n  if (tid == 0) {\n    float tr"),
        ("kxk_refine.cuh", "  sync_all(s);   // G is final everywhere",
         "  STAMP(2)\n  sync_all(s);   // G is final everywhere"),
        ("kxk_refine.cuh",
         "  product<kSmem, false>(G, rX, T, s, false, false);",
         "  STAMP(3)\n  product<kSmem, false>(G, rX, T, s, false, false);"),
        ("kxk_refine.cuh", "  const float alpha = 1.f / sqrtf(",
         "  STAMP(4)\n  const float alpha = 1.f / sqrtf("),
        ("kxk_refine.cuh", "    const bool last = step + 1 == ns_steps;\n",
         "    const bool last = step + 1 == ns_steps;\n    STAMP(5 + 2 * step)\n"),
        ("kxk_refine.cuh",
         "      product<kSmem, true>(X, rT, X, s, false, last);",
         "      STAMP(6 + 2 * step)\n"
         "      product<kSmem, true>(X, rT, X, s, false, last);"),
        ("kxk_refine.cuh", "  for (int e = tid; e < s.rows * k; e += nthreads)\n    ginv[",
         "  STAMP(5 + 2 * ns_steps)\n  for (int e = tid; e < s.rows * k; e += nthreads)\n    ginv["),
        ("fused_als.cu", "// Buffers of the workspace",
         "extern \"C\" int clock_read(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, kxk::clocks, sizeof(kxk::clocks));\n}\n\n"
         "// Buffers of the workspace")],
    "alltc": [("kxk_refine.cuh", "const bool last = step + 1 == ns_steps;",
               "const bool last = false;")],
    # every read of the B operand from this block's own rows: the time
    # without distributed shared memory (and a fit that is no longer right)
    "localb": [("kxk_refine.cuh", "                   : \"r\"(B.sa[r] + 4u * off));\n"
                "    } else {",
                "                   : \"r\"(B.sa[B.own] + 4u * off));\n"
                "    } else {")],
    "nonorms": [("kxk_refine.cuh",
                 "                              float* red) {\n",
                 "                              float* red) {\n"
                 "  if (s.k > 0) return 1.f;\n")],
    "nopartials": [("kxk_refine.cuh",
                    "G[(e / k) * s.ld + j] = sum_partials(\n"
                    "        P, kk, static_cast<size_t>(min(i, j)) * k + "
                    "max(i, j), splits);",
                    "G[(e / k) * s.ld + j] = sum_partials(\n"
                    "        P, kk, static_cast<size_t>(min(i, j)) * k + "
                    "max(i, j), 1);")],
}


def build(variant):
    """Compile fused_als.cu from an edited copy of the sources."""
    src_dir = os.path.join(OUT, "fused_" + variant.replace("+", "_"))
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(str(_build.CSRC), src_dir)
    for name in ([] if variant == "base" else variant.split("+")):
        for file, old, new in VARIANTS[name]:
            path = os.path.join(src_dir, file)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {file}")
            open(path, "w").write(text.replace(old, new))
    lib = os.path.join(src_dir, "libfused.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
           os.path.join(src_dir, "fused_als.cu")]
    return cmd, lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_variants: CUDA is not available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
            raise SystemExit(f"nvcc failed on {v}:\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and any(
                    key in line for key in ("refine", "gram_kernel")):
                print(f"{v}: {line.split('for ')[-1][:40]}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}",
                      flush=True)
        libs[v] = lib
    torch.backends.cuda.matmul.allow_tf32 = False
    A_pb, A_ml = smoke.simulated(smoke.PBMC), smoke.simulated(smoke.MOVIELENS)
    cells = (("pbmc3k k=20", A_pb, smoke.PBMC),
             ("movielens k=50", A_ml, smoke.MOVIELENS),
             ("movielens k=150", A_ml, dict(smoke.MOVIELENS, k=150)))
    for v, lib in libs.items():
        # the wrapper's cached library, swapped for the variant's
        fused_als._library.cache_clear()
        real = _build.load
        _build.load = lambda name, lib=lib: ctypes.CDLL(lib)
        try:
            fused_als._library()
        finally:
            _build.load = real
        for label, A, shape in cells:
            W0, H0 = smoke.fused_start(shape)

            def call():
                return fused_als.fused_als(A, W0, H0, maxit=smoke.MAXIT)
            ms = smoke.cuda_ms(call)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            kernels = [e for e in events if any(
                key in e.name for key in ("rhs_tall", "kxk", "cluster_gram",
                                          "row_normalize", "loss_kernel"))]
            span = (max(e.time_range.end for e in kernels)
                    - min(e.time_range.start for e in kernels)) / 1e3
            by = {}
            for e in kernels:
                key = e.name.split("(")[0][:48]
                t, n = by.get(key, (0.0, 0))
                by[key] = (t + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
            busy = sum(t for t, _ in by.values())
            parts = "; ".join(f"{key} {t:.3f} ms / {n}" for key, (t, n) in
                              sorted(by.items(), key=lambda x: -x[1][0]))
            print(f"{v} {label}: {ms:.3f} ms; device span {span:.3f} ms, "
                  f"kernels {busy:.3f} ms, between kernels "
                  f"{span - busy:.3f} ms; {parts}", flush=True)
            if "clocks" in v:
                stamps = (ctypes.c_longlong * 40)()
                ctypes.CDLL(lib).clock_read(stamps)
                steps = [stamps[i + 1] - stamps[i] for i in range(19)
                         if stamps[i + 1] > 0]
                print(f"{v} {label}: cycles between the last refine's "
                      f"stamps: {steps}", flush=True)


if __name__ == "__main__":
    main()
