#!/usr/bin/env python3
"""Take the tall product of ``csrc/rhs_tall.cuh`` (kernels 7 and 8, and the
products with A inside kernel 3) apart on the card.

    python3 tools/torch_rhs_variants.py [--sweep] VARIANT [VARIANT ...]

Each VARIANT is ``base`` (the header as it is) or names joined with ``+``
from ``VARIANTS`` below, each a text edit of a copy of the header:
``nocompute`` (the consumers only hand stages back: the copies alone),
``nocopy`` (no ``cp.async`` is issued: the products alone, on whatever lies
in shared memory), ``noX`` (the small operand is not copied), ``xsplit``
(a float32 small operand is kept whole and split into TF32 parts by the
consumers), ``prod4`` (four producer warps a block), ``oneblock`` (the
launch bounds ask for one block a multiprocessor) and ``stage128`` (a stage
covers 128 bytes of each row of A, as first designed).  Every variant is
built side by side with ``nvcc`` into ``rcppml_tpu_torch/_build/variants/``
with a small C shim that launches the preparation, the product and the sum
of its pieces one by one.

For the products with A at the pbmc3k (13,714 x 2,638, k=20) and movielens
(3,867 x 610, k=50) shapes, both directions and both types, it prints the
device time (replayed CUDA graph of 20 calls, median of 7 replays) of the
whole call and of each of its three kernels at the block count of
``ops/rhs_tall.py::plan_tall``, beside ``torch.matmul`` on the same
operands, and the error against it; before them, the rate at which one
PyTorch reduction (``A.sum()``) reads A, the yardstick of a read of A.
``--sweep`` times the whole call at other block counts as well.  Needs a
CUDA card of compute capability 9.0; imports no JAX.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from rcppml_tpu_torch.ops import _build  # noqa: E402
from rcppml_tpu_torch.ops import rhs_tall as rt  # noqa: E402

OUT = os.path.join(str(_build.BUILD_DIR), "variants")
SHIM = r'''
#include "rhs_tall.cuh"
extern "C" int v_prep(const float* X, int ldx, void* P, int ldp, int k,
                      int R, int bf16, void* s) {
  return rhs_tall::launch_prepare(X, ldx, P, ldp, k, R, bf16 != 0,
                                  (cudaStream_t)s);
}
extern "C" int v_tall(const void* P, int ldp, const void* Y, int ldy,
                      int bf16, int trans, float* part, int k, int J, int R,
                      int blocks, void* s) {
  return rhs_tall::launch_tall(P, ldp, Y, ldy, bf16 != 0, trans != 0, part,
                               k, J, R, blocks, (cudaStream_t)s);
}
extern "C" int v_reduce(const float* part, int blocks, int k, int J, int R,
                        int bf16, float* out, void* s) {
  return rhs_tall::launch_tall_reduce(part, blocks, k, J, R, bf16 != 0, 0.f,
                                      out, nullptr, (cudaStream_t)s);
}
'''

VARIANTS = {
    "nocompute": [
        ("      stage_bf16<kTrans, NT>(tile",
         "      if (R < 0) stage_bf16<kTrans, NT>(tile"),
        ("      stage_f32<kTrans, NT>(tile",
         "      if (R < 0) stage_f32<kTrans, NT>(tile")],
    "nocopy": [
        ('  asm volatile("cp.async.cg.shared.global',
         '  if (bytes < 0) asm volatile("cp.async.cg.shared.global')],
    "noX": [
        ("for (int q = 0; q < Kind<T>::kXTiles; ++q) {",
         "for (int q = 0; q < (R < 0) * Kind<T>::kXTiles; ++q) {")],
    "xsplit": [
        ("static constexpr int kXTiles = 2;",
         "static constexpr int kXTiles = 1;"),
        ("    const uint32_t hi = tf32::round(x);\n"
         "    uint32_t* w = static_cast<uint32_t*>(P);\n"
         "    w[at] = hi;\n"
         "    w[at + plane] = tf32::round(x - __uint_as_float(hi));",
         "    static_cast<float*>(P)[at] = x;"),
        ("      const uint32_t bh0 = Xh[off], bh1 = Xh[off + 4];\n"
         "      const uint32_t bl0 = Xl[off], bl1 = Xl[off + 4];",
         "      const float x0 = __uint_as_float(Xh[off]);\n"
         "      const float x1 = __uint_as_float(Xh[off + 4]);\n"
         "      const uint32_t bh0 = tf32::round(x0), bh1 = tf32::round(x1);\n"
         "      const uint32_t bl0 = tf32::round(x0 - __uint_as_float(bh0));\n"
         "      const uint32_t bl1 = tf32::round(x1 - __uint_as_float(bh1));")],
    "prod4": [("constexpr int kProducers = 64;",
               "constexpr int kProducers = 128;")],
    "oneblock": [("static constexpr int kBlocksPerSm = NT <= 4 ? 2 : 1;",
                  "static constexpr int kBlocksPerSm = 1;")],
    "stage128": [
        ("constexpr int kStageBytes = 256;", "constexpr int kStageBytes = 128;"),
        ("static constexpr int kDepth = 64;  ", "static constexpr int kDepth = 32;  "),
        ("static constexpr int kDepth = 128;", "static constexpr int kDepth = 64;")],
}
# variants whose stage covers another share of each row than TALL_DEPTH says
DEPTH_SCALE = {"stage128": 0.5}
SHAPES = {"pbmc3k": (13714, 2638, 20), "movielens": (3867, 610, 50)}


def variant_source(name):
    with open(os.path.join(str(_build.CSRC), "rhs_tall.cuh")) as f:
        src = f.read()
    for part in name.split("+"):
        if part == "base":
            continue
        for old, new in VARIANTS[part]:
            if old not in src:
                raise SystemExit(f"variant {part}: the header changed")
            src = src.replace(old, new)
    return src


def build(names):
    """Every variant's shim library, nvcc processes side by side."""
    running = {}
    for name in names:
        where = os.path.join(OUT, name.replace("+", "_"))
        os.makedirs(where, exist_ok=True)
        with open(os.path.join(where, "rhs_tall.cuh"), "w") as f:
            f.write(variant_source(name))
        with open(os.path.join(where, "shim.cu"), "w") as f:
            f.write(SHIM)
        lib = os.path.join(where, "libshim.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", where, "-o", lib,
               os.path.join(where, "shim.cu")]
        running[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(path)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.v_prep.argtypes = [P, I, P, I, I, I, I, P]
        lib.v_tall.argtypes = [P, I, P, I, I, I, P, I, I, I, I, P]
        lib.v_reduce.argtypes = [P, I, I, I, I, I, P, P]
        libs[name] = lib
    return libs


def graph_ms(fn, batch=20, reps=7):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def depth_of(name, dtype):
    scale = 1
    for part in name.split("+"):
        scale *= DEPTH_SCALE.get(part, 1)
    return int(rt.TALL_DEPTH[dtype] * scale)


def product(lib, X, Y, trans, blocks, depth):
    """The three launches of one product, each a callable, and its output.
    The stream is asked at every launch: a graph captures on its own."""
    k, R = X.shape
    J = Y.shape[0] if trans else Y.shape[1]
    bf16 = Y.dtype == torch.bfloat16
    ldp = -(-R // depth) * depth
    P = torch.empty(k * ldp // 2 if bf16 else 2 * k * ldp, device="cuda")
    part = torch.empty(rt.pieces_floats(k, blocks), device="cuda")
    out = torch.empty((k, J), device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def prep():
        assert lib.v_prep(X.data_ptr(), R, P.data_ptr(), ldp, k, R,
                          int(bf16), stream()) == 0

    def tall():
        assert lib.v_tall(P.data_ptr(), ldp, Y.data_ptr(), Y.shape[1],
                          int(bf16), int(trans), part.data_ptr(), k, J, R,
                          blocks, stream()) == 0

    def reduce():
        assert lib.v_reduce(part.data_ptr(), blocks, k, J, R, int(bf16),
                            out.data_ptr(), stream()) == 0

    return prep, tall, reduce, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_rhs_variants: CUDA is not available")
    args = sys.argv[1:]
    sweep = "--sweep" in args
    names = [a for a in args if a != "--sweep"] or ["base"]
    libs = build(names)
    sms = rt.device_sms(torch.device("cuda"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, (m, n, k) in SHAPES.items():
        A = torch.rand((m, n), device="cuda", generator=gen) * (
            torch.rand((m, n), device="cuda", generator=gen) < 0.1)
        for dtype in (torch.float32, torch.bfloat16):
            # the yardstick of a read of A: one PyTorch reduction over it
            B = A.to(dtype)
            ms = graph_ms(lambda: B.sum(dtype=torch.float32))
            print(f"{shape} A.sum() in {dtype}: {ms:.4f} ms, "
                  f"{B.numel() * B.element_size() / ms / 1e9:.3f} TB/s  "
                  f"[{card}]", flush=True)
            del B
        for trans in (False, True):
            J, R = (m, n) if trans else (n, m)
            X = torch.rand((k, R), device="cuda", generator=gen)
            for bf16 in (False, True):
                Y = A.to(torch.bfloat16) if bf16 else A
                Xr = rt._round_small(X, Y)
                Ym = Y.T if trans else Y
                want = Xr @ Ym.float()
                X16 = X.to(torch.bfloat16)
                mm = graph_ms(lambda: (X16 if bf16 else X) @ Ym)
                plan = rt.plan_tall(R, J, k, bf16, sms)
                tiles = -(-J // rt.TALL_COLS)
                counts = [plan]
                if sweep:
                    counts += sorted({tiles * max(1, 2 * sms // tiles),
                                      tiles * max(1, sms // tiles), sms,
                                      2 * sms} - {plan})
                label = (f"{shape} {'H A^T' if trans else 'F A'} "
                         f"{'bf16' if bf16 else 'f32'}")
                for name, lib in libs.items():
                    depth = depth_of(name, Y.dtype)
                    units = tiles * -(-R // depth)
                    cells = []
                    for blocks in counts:
                        if not tiles <= blocks <= units:
                            continue
                        prep, tall, reduce, out = product(lib, X, Y, trans,
                                                          blocks, depth)

                        def call():
                            prep()
                            tall()
                            reduce()

                        call()
                        torch.cuda.synchronize()
                        err = float((out - want).abs().max()
                                    / want.abs().max())
                        cell = f"{blocks} blocks {graph_ms(call):.4f} ms"
                        if blocks == plan:
                            cell += (f" (prepare {graph_ms(prep):.4f}, "
                                     f"product {graph_ms(tall):.4f}, "
                                     f"reduce {graph_ms(reduce):.4f}; "
                                     f"error {err:.1e})")
                        cells.append(cell)
                    print(f"{label} {name}: {'; '.join(cells)}; "
                          f"torch.matmul {mm:.4f} ms  [{card}]", flush=True)


if __name__ == "__main__":
    main()
