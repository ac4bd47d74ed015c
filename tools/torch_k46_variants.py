#!/usr/bin/env python3
"""Take kernels 6 (``cholesky_clip``) and 4 (``weighted_gram_rhs``) apart on
the card.

    python3 tools/torch_k46_variants.py [VARIANT ...]

Each VARIANT is ``base`` (the sources as they are) or names joined with
``+`` from ``VARIANTS`` below, each a text edit of a copy of ``csrc``:

  * kernel 6: ``nofactor`` (warp 0 writes an identity for L instead of
    factoring G), ``noload`` (B is not copied: the tile is zero),
    ``nosolve`` (no substitution step is run), ``clocks`` (clock64 stamps
    of block 0 at the phase boundaries, written over X's first entries and
    printed), ``fdiv`` (the solve divides with ``__fdiv_rn`` instead of the
    double-precision reciprocal: the same bits), ``run1`` (the factor's
    update breaks after every column instead of every eight: the same
    bits), ``fclocks`` (clock64 stamps of block 0's factor: loading G, then
    its k steps);
  * kernel 4: ``nomu`` (mu is not summed: the weight of mu = 0), ``nomma``
    (no Gram product), ``nocopy`` (no ``cp.async`` is issued), ``noweight``
    (no prologue at all: w is what lies in shared memory), ``oneblock``
    (the launch bounds ask for one block a multiprocessor, so no register
    is spilled), ``stages4`` (a ring of four stages), ``flush2`` (the
    tensor-core sums go into the float32 accumulators every second stage,
    as for kernel 5, not every stage), ``roundlo`` (the A operands' low TF32 parts rounded to
    nearest, not cut by the tensor core).  For kernel 4 it also prints how
    far the KL fit of ``chip_smoke.py`` phase 8 through the kernel
    (``RCPPML_FUSED_WGRAM``) ends from the default path's loss history.

Every variant is built side by side with ``nvcc`` into
``rcppml_tpu_torch/_build/variants/`` and loaded in place of the kernel's
library.  For kernel 6 it prints the device time (a replayed CUDA graph of
20 calls, median of 5) at (k, n) = (20, 2,638), (20, 13,714), (50, 610),
(50, 3,867) and (64, 2,638) for every plan route 1 can take and for route 2,
the base variant checked bitwise against the twin; for kernel 4 the time
(CUDA events, median of 5 after a warm-up) at the KL fit's sides, (16,
13,714, 2,638) and (16, 2,638, 13,714).  A variant other than ``base``
computes something else: only its time means anything.  Needs a CUDA card
of compute capability 9.0; imports no JAX.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from rcppml_tpu_torch.ops import _build  # noqa: E402
from rcppml_tpu_torch.ops import cholesky_clip as cc  # noqa: E402
from rcppml_tpu_torch.ops import wgram  # noqa: E402

OUT = os.path.join(str(_build.BUILD_DIR), "variants")
MMA = ("          tf32::mma(part[c][jt], al[c], x[0], x[1]);\n"
       "          tf32::mma(part[c][jt], ah[c], x[2], x[3]);\n"
       "          tf32::mma(part[c][jt], ah[c], x[0], x[1]);\n")
# name: (kernel source, [(file, old, new), ...])
VARIANTS = {
    "nofactor": ("cholesky_clip", [(
        "cholesky_clip.cu",
        "if (tid < 32) factor_warp<kP>(G, Ls, k, ldl, lane);",
        "for (int e = tid; e < k * ldl; e += blockDim.x) "
        "Ls[e] = e % ldl == e / ldl ? 1.f : 0.f;")]),
    "noload": ("cholesky_clip", [(
        "cholesky_clip.cu", "    if (j0 + c < n) {\n      const uint32_t d =",
        "    if (false) {\n      const uint32_t d =")]),
    "clocks": ("cholesky_clip", [
        ("cholesky_clip.cu",
         "  // the block's columns of B into the tile, zero past n\n",
         "  const long long c0 = clock64();\n"
         "  // the block's columns of B into the tile, zero past n\n"),
        ("cholesky_clip.cu",
         "  if (tid < 32) factor_warp<kP>(G, Ls, k, ldl, lane);\n"
         "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
         "  __syncthreads();\n",
         "  if (tid < 32) factor_warp<kP>(G, Ls, k, ldl, lane);\n"
         "  const long long cf = clock64();\n"
         "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
         "  __syncthreads();\n"
         "  const long long c1 = clock64();\n"),
        ("cholesky_clip.cu",
         "  __syncthreads();\n\n  // solve, then clip (clipping inside",
         "  const long long c2 = clock64();\n"
         "  __syncthreads();\n\n  // solve, then clip (clipping inside"),
        ("cholesky_clip.cu",
         "    X[l * sn + j0 + c] = v;\n  }\n}",
         "    X[l * sn + j0 + c] = v;\n  }\n"
         "  const long long c3 = clock64();\n  __syncthreads();\n"
         "  if (blockIdx.x == 0 && tid == 0) {\n"
         "    X[0] = static_cast<float>(cf - c0);\n"
         "    X[1] = static_cast<float>(c1 - c0);\n"
         "    X[2] = static_cast<float>(c2 - c1);\n"
         "    X[3] = static_cast<float>(c3 - c2);\n  }\n}")]),
    "fdiv": ("cholesky_clip", [(
        "cholesky_clip.cu",
        "  return __double2float_rn(static_cast<double>(x) * rd);",
        "  return __fdiv_rn(x, static_cast<float>(rd));"), (
        "cholesky_clip.cu",
        "  return __drcp_rn(static_cast<double>(d));",
        "  return static_cast<double>(d);")]),
    "run1": ("cholesky_clip", [(
        "cholesky_clip.cu", "constexpr int kFactorRun = 8;",
        "constexpr int kFactorRun = 1;")]),
    "fclocks": ("cholesky_clip", [
        ("cholesky_clip.cu", "#include <stdint.h>\n",
         "#include <stdint.h>\n__device__ float g_fclk[2];\n"),
        ("cholesky_clip.cu",
         "  constexpr int kF = 32 * kP;\n  float r[kP][kF];\n",
         "  constexpr int kF = 32 * kP;\n  float r[kP][kF];\n"
         "  const long long fcl = clock64();\n"),
        ("cholesky_clip.cu",
         "  for (int j = 0; j < k; ++j) {\n    // the owner's pivot",
         "  const long long fc0 = clock64();\n"
         "  for (int j = 0; j < k; ++j) {\n    // the owner's pivot"),
        ("cholesky_clip.cu",
         "          r[p][i] = __fsub_rn(r[p][i + 1], __fmul_rn(l[p], lm));\n"
         "        }\n      }\n    }\n  }\n}",
         "          r[p][i] = __fsub_rn(r[p][i + 1], __fmul_rn(l[p], lm));\n"
         "        }\n      }\n    }\n  }\n"
         "  if (lane == 0 && blockIdx.x == 0) {\n"
         "    g_fclk[0] = static_cast<float>(fc0 - fcl);\n"
         "    g_fclk[1] = static_cast<float>(clock64() - fc0);\n  }\n}"),
        ("cholesky_clip.cu",
         "    X[l * sn + j0 + c] = v;\n  }\n}",
         "    X[l * sn + j0 + c] = v;\n  }\n  __syncthreads();\n"
         "  if (blockIdx.x == 0 && tid == 0) {\n"
         "    X[0] = g_fclk[0];\n    X[1] = g_fclk[1];\n  }\n}")]),
    "flush2": ("wgram_rhs", [("tri_gram.cuh",
                              "if (!kFusedW && st % 2 == 0 && st + 1 < n_stages)",
                              "if (st % 2 == 0 && st + 1 < n_stages)")]),
    "roundlo": ("wgram_rhs", [
        ("tri_gram.cuh",
         "al[c][q] = __float_as_uint(a - __uint_as_float(ah[c][q]));",
         "al[c][q] = tf32::low(a, ah[c][q]);"),
        ("tri_gram.cuh",
         "fl[q] = __float_as_uint(f[q] - __uint_as_float(fh[q]));",
         "fl[q] = tf32::low(f[q], fh[q]);")]),
    "stages4": ("wgram_rhs", [("tri_gram.cuh", "constexpr int kStages = 3;",
                               "constexpr int kStages = 4;")]),
    "nosolve": ("cholesky_clip", [
        ("cholesky_clip.cu", "for (int ti = 0; ti < steps; ++ti) {",
         "for (int ti = 0; ti < 0; ++ti) {"),
        ("cholesky_clip.cu", "for (int ti = steps - 1; ti >= 0; --ti) {",
         "for (int ti = -1; ti >= 0; --ti) {")]),
    "nomu": ("wgram_rhs", [("tri_gram.cuh",
                            "  if (r < valid) {\n"
                            "    if constexpr (kMode == kFusedStaged) {",
                            "  if (false) {\n"
                            "    if constexpr (kMode == kFusedStaged) {")]),
    "nomma": ("wgram_rhs", [("tri_gram.cuh", MMA, "")]),
    "nocopy": ("wgram_rhs", [
        ("tri_gram.cuh", "if (next < n_stages) issue(", "if (false) issue("),
        ("tri_gram.cuh", "if (s < n_stages) issue(", "if (false) issue(")]),
    "oneblock": ("wgram_rhs", [("tri_gram.cuh",
                                "__launch_bounds__(kThreads, 2)",
                                "__launch_bounds__(kThreads, 1)")]),
    "noweight": ("wgram_rhs", [("tri_gram.cuh",
                                "    if constexpr (kFusedW) {\n"
                                "      const int r0 = r_begin + st * kDepth;",
                                "    if constexpr (false) {\n"
                                "      const int r0 = r_begin + st * kDepth;")]),
}
KERNELS = {"cholesky_clip": cc, "wgram_rhs": wgram}


def build(variant, kernel):
    """The nvcc command for ``kernel`` against an edited copy of csrc."""
    names = [] if variant == "base" else variant.split("+")
    src_dir = os.path.join(OUT, f"{kernel}_{variant.replace('+', '_')}")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(str(_build.CSRC), src_dir)
    for name in names:
        for fname, old, new in VARIANTS[name][1]:
            path = os.path.join(src_dir, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {fname}")
            open(path, "w").write(text.replace(old, new))
    lib = os.path.join(src_dir, f"lib{kernel}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
           os.path.join(src_dir, f"{kernel}.cu")]
    return cmd, lib


# each wrapper's own loader (it sets the entry point's C signature)
LOADERS = {module: module._library.__wrapped__
           for module in KERNELS.values()}


def use(module, lib_path):
    """Make ``module``'s wrapper launch the library at ``lib_path``."""
    real = _build.load
    _build.load = lambda name: ctypes.CDLL(lib_path)
    try:
        lib = LOADERS[module]()
    finally:
        _build.load = real
    module._library = functools.cache(lambda: lib)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k46_variants: CUDA is not available")
    import chip_smoke as smoke
    import rcppml_tpu_torch as rtt
    rtt.set_fp32_precision()
    variants = sys.argv[1:] or ["base"]
    jobs = []
    for v in variants:
        kernels = list(KERNELS) if v == "base" else \
            sorted({VARIANTS[n][0] for n in v.split("+")})
        for kernel in kernels:
            jobs.append((v, kernel, *build(v, kernel)))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _, _, cmd, _ in jobs]
    for (v, kernel, _, _), proc in zip(jobs, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {kernel} {v}:\n{out}")
        print(f"built {kernel} {v} (all started together; "
              f"{time.perf_counter() - t0:.1f} s so far)", flush=True)
        for line in out.splitlines():
            if "registers" in line or "bytes stack" in line:
                print("  ptxas:", line.strip(), flush=True)
    card = torch.cuda.get_device_name(0)
    batch = 20

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(batch):
                fn()
        return smoke.cuda_ms(graph.replay) / batch

    real_plan = cc.plan_cholesky_clip
    A_ct = None
    for v, kernel, _, lib in jobs:
        use(KERNELS[kernel], lib)
        if kernel == "cholesky_clip":
            for k, n in ((20, 2638), (20, 13714), (50, 610), (50, 3867),
                         (64, 2638)):
                G, B = smoke.chol_system(k, n, seed=1)
                plain = cc.cholesky_clip_plain(G, B)
                rows = []
                for plan in plans(k, n):
                    cc.plan_cholesky_clip = \
                        lambda k_, n_, sms=132, plan=plan: plan
                    out = cc.cholesky_clip(G, B)
                    torch.cuda.synchronize()
                    if v == "base" and not torch.equal(out, plain):
                        print(f"    DIFFERS from the twin: {tuple(plan)}",
                              flush=True)
                    rows.append((graph_ms(lambda: cc.cholesky_clip(G, B)),
                                 plan))
                cc.plan_cholesky_clip = real_plan
                chosen = real_plan(k, n)
                rows.sort(key=lambda r: r[0])
                print(f"{v} cholesky_clip ({k}, {n}), plan {tuple(chosen)}: "
                      f"{graph_ms(lambda: cc.cholesky_clip(G, B)):.4f} ms  "
                      f"[{card}]", flush=True)
                if "fclocks" in v:
                    cyc = cc.cholesky_clip(G, B, nonneg=False)[0, :2].tolist()
                    print(f"    clock64 cycles of block 0's factor: loading "
                          f"G {cyc[0]:.0f}, the {k} steps {cyc[1]:.0f}",
                          flush=True)
                elif "clocks" in v:
                    cyc = cc.cholesky_clip(G, B, nonneg=False)[0, :4].tolist()
                    print(f"    clock64 cycles of block 0: factor "
                          f"{cyc[0]:.0f} (from the start), B landed and "
                          f"factor done {cyc[1]:.0f}, solve {cyc[2]:.0f}, "
                          f"clip and store {cyc[3]:.0f}", flush=True)
                for ms, plan in rows[:6] + [r for r in rows
                                            if r[1].lanes == 0]:
                    print(f"    {ms:.4f} ms  lanes {plan.lanes} rows "
                          f"{plan.rows} threads {plan.threads} blocks "
                          f"{plan.blocks}", flush=True)
        else:
            if A_ct is None:
                A_ct, _ = smoke.pbmc_counts(smoke.KL_K)
                res = smoke.kl_fit(rtt, A_ct)
                W_T = torch.from_numpy(np.ascontiguousarray(res.W.T)).cuda()
                H = torch.from_numpy(np.ascontiguousarray(res.H)).cuda()
                A_T = A_ct.T.contiguous()
            for side, F, X, A_blk in (("H", W_T, H, A_ct), ("W", H, W_T, A_T)):
                ms = smoke.cuda_ms(lambda: wgram.weighted_gram_rhs(
                    F, X, A_blk, loss_kind="kl"))
                err = ""
                if v == "base":
                    Gb, b = wgram.weighted_gram_rhs(F, X, A_blk, loss_kind="kl")
                    Gp, bp = wgram.weighted_gram_rhs_plain(F, X, A_blk,
                                                           loss_kind="kl")
                    err = (f", off the twin by "
                           f"{float((Gb - Gp).abs().max() / Gp.abs().max()):.2e}"
                           f" (Gram), "
                           f"{float((b - bp).abs().max() / bp.abs().max()):.2e}"
                           f" (b) of the largest entry")
                print(f"{v} weighted_gram_rhs {side} side (16, {F.shape[1]}, "
                      f"{X.shape[1]}), plan "
                      f"{wgram.plan_wgram(16, F.shape[1], X.shape[1])}: "
                      f"{ms:.4f} ms{err}  [{card}]", flush=True)
            with smoke.fused_wgram():
                fused = smoke.kl_fit(rtt, A_ct).loss_history
            off = float(np.abs(np.asarray(fused) / np.asarray(
                res.loss_history) - 1).max())
            print(f"{v} KL fit through the kernel: loss history within "
                  f"{off:.3e} of the default path's", flush=True)


def plans(k, n):
    """Every launch of route 1 at (k, n), and route 2's."""
    out = [cc.CholPlan(0, 0, 128, 0, 0, -(-n // 128))]
    for lanes in (1, 2, 4, 8, 16, 32):
        rows = next((r for r in cc.LANE_ROWS if r >= -(-k // lanes)), None)
        for warps in (1, 2, 4, 8):
            threads = 32 * warps
            ldx = cc.tile_stride(threads // lanes, lanes)
            shared = 4 * k * ((k | 1) + ldx)
            if rows is not None and k <= cc.LANES_MAX_K \
                    and shared <= cc.SHARED_OPTIN:
                out.append(cc.CholPlan(lanes, rows, threads, ldx, shared,
                                       -(-n // (threads // lanes))))
    return out


if __name__ == "__main__":
    main()
