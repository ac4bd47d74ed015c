#!/usr/bin/env python3
"""Time the two CD NNLS kernels (1 ``cd_nnls_shared``, 2 ``cd_nnls_batched``)
and the fits that run them, from one checkout.

    cd <checkout> && python3 <path to this file> <label>

Imports ``chip_smoke.py`` and ``rcppml_tpu_torch`` from the current directory
and builds their data on the card (pbmc3k and movielens shapes, seeded, as
``chip_smoke.py`` does).  The solves are the main path's: the next solve of a
finished fit (kernel 1: the MSE CD fit's two sides at pbmc3k k=20, the
movielens L1 fit's two sides at k=50; kernel 2: the KL fit's two sides at
k=16, and chip_smoke's movielens-shaped (50, 3,867) batch).  One line per
solve: device time (CUDA events, median of 5 after a warm-up), the sweeps the
twin counts (mean and max) and the time of one coordinate step of the
slowest column, time / (max sweeps x k); for kernel 2 also the solve's peak
device memory (``torch.cuda.max_memory_allocated``).  Then one line per fit:
MSE CD, movielens L1, KL, NB + ZI and CV k=16 with CD, 20 iterations (NB + ZI
5), median of 5.  To compare two commits on one card, unpack both side by
side and run this from each in turn within one job (parent, change, change,
parent): every input is made the same way and the fits' results are bitwise
equal, so both time the same work.  Needs a CUDA card of compute capability
9.0; imports no JAX.
"""

import importlib.util
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_cd: CUDA is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import (_build, cd_nnls, cd_nnls_batched,
                                      linalg, solvers, wgram)
    rtt.set_fp32_precision()
    _build.build_all([cd_nnls.KERNEL, cd_nnls_batched.KERNEL])
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    MAXIT = smoke.MAXIT

    A_pb, A_ml = smoke.simulated(smoke.PBMC), smoke.simulated(smoke.MOVIELENS)
    A_ct, _ = smoke.pbmc_counts(smoke.KL_K)
    A_nb, _ = smoke.pbmc_counts(smoke.NBZI_K, **smoke.NBZI_DATA)

    def factors(res):
        return (torch.from_numpy(np.ascontiguousarray(res.W.T)).cuda(),
                torch.from_numpy(np.ascontiguousarray(res.H)).cuda())

    def report(name, k, n, ms, sweeps, extra=""):
        step_us = ms * 1e3 / (int(sweeps.max()) * k)
        print(label, f"{name} ({k}, {n}): {ms:.4f} ms, sweeps "
              f"{float(sweeps.float().mean()):.2f} mean {int(sweeps.max())} "
              f"max, {step_us:.4f} us a step{extra}", flush=True)

    fits = {
        f"MSE CD pbmc3k k=20, {MAXIT} iterations":
            lambda: smoke.mse_cd_fit(rtt, A_pb),
        f"movielens k=50 L1=(0, 0.01), {MAXIT} iterations":
            lambda: rtt.nmf(A_ml, smoke.MOVIELENS["k"], L1=(0, 0.01),
                            maxit=MAXIT, tol=0, seed=1),
        f"KL pbmc3k counts k={smoke.KL_K}, {smoke.KL_MAXIT} iterations":
            lambda: smoke.kl_fit(rtt, A_ct),
        f"NB zi=row k={smoke.NBZI_K}, {smoke.NBZI_MAXIT} iterations":
            lambda: smoke.nbzi_fit(rtt, A_nb),
        f"CV k={smoke.CV_K} CD pbmc3k, {MAXIT} iterations":
            lambda: rtt.nmf(A_pb, smoke.CV_K, test_fraction=smoke.CV_FRACTION,
                            cv_seed=1, maxit=MAXIT, tol=0,
                            cv_patience=MAXIT + 1, seed=1, solver="cd"),
    }
    done = {name: fit() for name, fit in fits.items()}
    res_cd, res_ml, res_kl = list(done.values())[:3]

    # kernel 1: the next solve of each side of the two MSE CD fits
    for res, A, side in ((res_cd, A_pb, "H"), (res_cd, A_pb, "W"),
                         (res_ml, A_ml, "H"), (res_ml, A_ml, "W")):
        W_T, H = factors(res)
        F, X0, data = (W_T, H, A) if side == "H" else (H, W_T, A.T)
        G, B = linalg.gram(F), linalg.rhs(F, data)
        B_res = B - G @ X0
        ms = smoke.cuda_ms(lambda: cd_nnls.cd_nnls_shared(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100))
        _, sweeps = cd_nnls.cd_nnls_shared_plain(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100,
            return_sweeps=True)
        report(f"cd_nnls_shared {side} side", *B_res.shape, ms, sweeps)

    # kernel 2: the first inner solve of each side of the next KL iteration,
    # and chip_smoke's movielens-shaped batch
    W_T, H = factors(res_kl)
    rs = np.random.RandomState(5)
    F_ml = torch.from_numpy(np.abs(rs.normal(size=(50, 610))).astype(
        np.float32)).cuda()
    X_ml = torch.from_numpy((np.abs(rs.normal(size=(50, 3867))) / 50).astype(
        np.float32)).cuda()
    for name, (F, X, A_blk) in (("H side", (W_T, H, A_ct)),
                                ("W side", (H, W_T, A_ct.T.contiguous())),
                                ("movielens W side",
                                 (F_ml, X_ml, A_ml.T.contiguous()))):
        Gb, b = wgram.weighted_gram_rhs_plain(F, X, A_blk, loss_kind="kl",
                                              sparse_zeros=False,
                                              KR=linalg.kr_product(F))
        B_res = b - solvers.batched_gram_matvec(Gb, X)

        def solve():
            return cd_nnls_batched.cd_nnls_batched(
                Gb, B_res, X, 0.0, 5e-6, nonneg=True, maxit=100)
        ms = smoke.cuda_ms(solve)
        base = torch.cuda.memory_allocated()
        mib = (smoke.peak_mib(solve) - base / 2**20)
        _, sweeps = cd_nnls_batched.cd_nnls_batched_plain(
            Gb, B_res, X, 0.0, 5e-6, nonneg=True, maxit=100,
            return_sweeps=True)
        report(f"cd_nnls_batched {name}", *B_res.shape, ms, sweeps,
               f", peak {mib:.1f} MiB above the inputs (Gram batch "
               f"{Gb.numel() * 4 / 2**20:.1f} MiB)")
        del Gb, b, B_res

    for name, fit in fits.items():
        print(label, f"fit {name}: {smoke.cuda_ms(fit):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
