#!/usr/bin/env python3
"""Time kernel 5 (``weighted_gram``), the masked k=128 fit that runs it, and
kernel 3 (``fused_als``), from one checkout.

    cd <checkout> && python3 <path to this file> <label>

Imports ``chip_smoke.py`` and ``rcppml_tpu_torch`` from the current directory
and builds their data on the card as ``chip_smoke.py`` does (pbmc3k and
movielens shapes, seeded).  One line each, device time by CUDA events, median
of 5 after a warm-up (the fits median of 3):

  * kernel 5 at the two column blocks of the masked k=128 fit's H side,
    (k, m, bc) = (128, 13,714, 68) and (128, 13,714, 54);
  * the masked k=128 fit itself, 2 iterations (78 launches of kernel 5);
  * kernel 3, 20 iterations in one call: pbmc3k k=20 with a float32 and a
    bfloat16 A, movielens k=50 float32, movielens k=150 float32.

To compare two commits on one card, unpack both side by side and run this
from each in turn within one job (parent, change, change, parent): every
input is made the same way, so both time the same work.  Needs a CUDA card of
compute capability 9.0; imports no JAX.
"""

import importlib.util
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_wg5: CUDA is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import _build, fused_als, weighted_gram
    rtt.set_fp32_precision()
    _build.build_all([weighted_gram.KERNEL, fused_als.KERNEL])
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    m_pb, k128 = smoke.PBMC["m"], smoke.MASK_K128

    for bc in (68, 54):
        F, w, A_blk = smoke.wg5_inputs(k128, m_pb, bc, False, True, seed=bc)
        ms = smoke.cuda_ms(lambda: weighted_gram.weighted_gram(F, w, A_blk))
        print(label, f"weighted_gram (k={k128}, m={m_pb}, bc={bc}): "
              f"{ms:.4f} ms", flush=True)
        del F, w, A_blk

    A_pb, A_ml = smoke.simulated(smoke.PBMC), smoke.simulated(smoke.MOVIELENS)
    gen = torch.Generator(device="cuda").manual_seed(3)
    M_pb = torch.rand(A_pb.shape, device="cuda", generator=gen) \
        < smoke.MASK_SHARE

    def masked_fit():
        return rtt.nmf(A_pb, k128, mask=M_pb, maxit=smoke.K128_MAXIT, tol=0,
                       seed=1)

    print(label, f"fit masked k={k128}, {smoke.K128_MAXIT} iterations: "
          f"{smoke.cuda_ms(masked_fit, reps=3):.3f} ms", flush=True)

    for name, A, shape, bf16 in (
            ("pbmc3k k=20 float32", A_pb, smoke.PBMC, False),
            ("pbmc3k k=20 bfloat16", A_pb, smoke.PBMC, True),
            ("movielens k=50 float32", A_ml, smoke.MOVIELENS, False),
            (f"movielens k={smoke.FUSED_WIDE_K} float32", A_ml,
             dict(smoke.MOVIELENS, k=smoke.FUSED_WIDE_K), False)):
        W0, H0 = smoke.fused_start(shape)
        ms = smoke.cuda_ms(lambda: fused_als.fused_als(
            A, W0, H0, maxit=smoke.MAXIT, a_bf16=bf16))
        print(label, f"fused_als {name}, {smoke.MAXIT} iterations: "
              f"{ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
