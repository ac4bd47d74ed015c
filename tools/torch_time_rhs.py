#!/usr/bin/env python3
"""Time the single-pass products with A (kernels 7 and 8) and the whole-fit
kernel that contains them (kernel 3) from one checkout.

    cd <checkout> && python3 <path to this file> <label>

Imports ``chip_smoke.py`` and ``rcppml_tpu_torch`` from the current directory
and builds their data on the card (pbmc3k and movielens shapes, seeded, as
``chip_smoke.py`` does).  Prints one line per product and shape: device time
from a replayed CUDA graph of 20 calls (median of 7 replays) of the kernel
with a float32 and a bfloat16 A, beside ``torch.matmul`` on float32 operands
and on bfloat16 operands (bfloat16 output), and the byte bounds; then one
line with the whole-fit kernel's time (CUDA events, median of 5) at both
shapes with both types, and the ``rtt.nmf`` fits that run these kernels.
To compare two commits on one card, unpack both side by side and run this
from each in turn within one job (parent, change, change, parent).  Needs a
CUDA card of compute capability 9.0; imports no JAX.
"""

import importlib.util
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

BATCH = 20


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_rhs: CUDA is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import _build, fused_als, rhs_tall
    rtt.set_fp32_precision()
    _build.build_all([rhs_tall.KERNEL, fused_als.KERNEL])
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(BATCH):
                fn()
        return smoke.cuda_ms(graph.replay, reps=7) / BATCH

    cells = {"pbmc3k": (smoke.simulated(smoke.PBMC), smoke.PBMC),
             "movielens": (smoke.simulated(smoke.MOVIELENS), smoke.MOVIELENS)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for cell, (A32, shape) in cells.items():
        m, n, k = shape["m"], shape["n"], shape["k"]
        A16 = A32.to(torch.bfloat16)
        for name, J, A16_mm in (("rhs_tall", n, A16), ("rhs_tall_t", m,
                                                       A16.T)):
            fn = getattr(rhs_tall, name)
            X = torch.rand((k, m + n - J), device="cuda", generator=gen)
            X16 = X.to(torch.bfloat16)
            plain = getattr(rhs_tall, name + "_plain")
            times = dict(f32=graph_ms(lambda: fn(X, A32)),
                         bf16=graph_ms(lambda: fn(X, A16)),
                         matmul_f32=graph_ms(lambda: plain(X, A32)),
                         matmul_bf16=graph_ms(lambda: X16 @ A16_mm))
            bytes_out = 4 * (X.numel() + k * J)
            bounds = dict(
                bound_f32=smoke.bound_ms(4 * m * n + bytes_out,
                                         2 * k * m * n)[0],
                bound_bf16=smoke.bound_ms(2 * m * n + bytes_out, 0,
                                          2 * k * m * n)[0])
            print(label, f"{name} {cell} k={k}",
                  " ".join(f"{key}={ms:.4f}ms" for key, ms in
                           {**times, **bounds}.items()), flush=True)
    fits = {}
    for cell, (A, shape) in cells.items():
        W0, H0 = smoke.fused_start(shape)
        for bf16 in (False, True):
            fits[f"fused_als_{cell}_{'bf16' if bf16 else 'f32'}"] = \
                smoke.cuda_ms(lambda: fused_als.fused_als(
                    A, W0, H0, maxit=smoke.MAXIT, a_bf16=bf16))
    A_pb = cells["pbmc3k"][0]
    for name, kw in (("fit_fused_vmem", dict(fused_vmem=True)),
                     ("fit_fused_vmem_bf16", dict(fused_vmem=True,
                                                  bf16_data=True)),
                     ("fit_cholesky_bf16", dict(bf16_data=True)),
                     ("fit_cholesky", {})):
        fits[f"{name}_pbmc3k"] = smoke.cuda_ms(lambda: rtt.nmf(
            A_pb, smoke.PBMC["k"], maxit=smoke.MAXIT, tol=0, seed=1, **kw))
    print(label, " ".join(f"{key}={ms:.3f}ms" for key, ms in fits.items()),
          flush=True)


if __name__ == "__main__":
    main()
