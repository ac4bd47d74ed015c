#!/usr/bin/env python3
"""Time the PyTorch / CUDA port's fits of ``chip_smoke.py`` from one checkout.

    cd <checkout> && python3 <path to this file> <label>

Imports ``chip_smoke.py`` and ``rcppml_tpu_torch`` from the current directory,
builds their data on the card (pbmc3k and movielens shapes, seeded) and prints
one line: the label and the median of 7 CUDA-event timings, after a warm-up,
of the MSE fit with the CD solver, the MSE fit with the Cholesky solver, the
movielens-shape L1 fit, the KL fit, the NB fit with zero inflation per row and,
where the checkout has them, the cross-validated fits at k=16 with both solvers
and the masked fit at k=20 (a checkout from before they were ported prints
``unported``).
To compare two commits on one card, unpack both side by side and run this from
each in turn within one job (parent, change, change, parent).  Needs a CUDA
card of compute capability 9.0; imports no JAX.
"""

import importlib.util
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_fits: CUDA is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import rcppml_tpu_torch as rtt
    rtt.set_fp32_precision()
    os.environ.pop("RCPPML_FUSED_WGRAM", None)
    A_pb, A_ml = smoke.simulated(smoke.PBMC), smoke.simulated(smoke.MOVIELENS)
    A_ct, _ = smoke.pbmc_counts(smoke.KL_K)
    A_nb, _ = smoke.pbmc_counts(smoke.NBZI_K, **smoke.NBZI_DATA)
    fits = {
        "mse_cd": lambda: smoke.mse_cd_fit(rtt, A_pb),
        "mse_cholesky": lambda: rtt.nmf(A_pb, smoke.PBMC["k"],
                                        maxit=smoke.MAXIT, tol=0, seed=1),
        "movielens_l1": lambda: rtt.nmf(A_ml, smoke.MOVIELENS["k"],
                                        L1=(0, 0.01), maxit=smoke.MAXIT,
                                        tol=0, seed=1),
        "kl": lambda: smoke.kl_fit(rtt, A_ct),
        "nb_zi_row": lambda: smoke.nbzi_fit(rtt, A_nb),
    }
    cv = dict(test_fraction=0.1, cv_seed=1, maxit=smoke.MAXIT, tol=0,
              cv_patience=smoke.MAXIT + 1, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    M_pb = torch.rand(A_pb.shape, device="cuda", generator=gen) < 0.1
    fits.update({
        "cv_k16_cd": lambda: rtt.nmf(A_pb, 16, solver="cd", **cv),
        "cv_k16_cholesky": lambda: rtt.nmf(A_pb, 16, **cv),
        "masked_k20": lambda: rtt.nmf(A_pb, 20, mask=M_pb, maxit=smoke.MAXIT,
                                      tol=0, seed=1),
    })

    def timed(fit):
        try:
            return f"{smoke.cuda_ms(fit, reps=7):.3f}ms"
        except NotImplementedError:
            return "unported"

    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    print(label, " ".join(f"{name}={timed(fit)}"
                          for name, fit in fits.items()), flush=True)


if __name__ == "__main__":
    main()
