#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``rcppml_tpu_torch``) on one H100.

    python3 chip_smoke.py

It builds the CD NNLS kernel from ``rcppml_tpu_torch/csrc``, checks it bit
for bit against its plain PyTorch twin, drives the port's main path
(``rcppml_tpu_torch.nmf`` on a matrix on the card) with both solvers at the
pbmc3k (13,714 x 2,638, k=20) and movielens (3,867 x 610, k=50) shapes, and
times kernel, twin and fits with CUDA events.  Each phase prints its own
lines and any failure raises, so the exit code is non-zero.  There is no CPU
fallback: without a CUDA card of compute capability 9.0 it fails.

The second line from the end is one JSON object about the kernels; the last
line is ``{"ok": true, "device": {...}}``.  The matrices are synthetic
(``simulate_nmf``, seeded), with the shapes and the share of zeros of the
real data sets.  Imports no JAX.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PBMC = dict(m=13714, n=2638, k=20, dropout=0.9)      # BASELINE.md:20
MOVIELENS = dict(m=3867, n=610, k=50, dropout=0.95)  # bench.py:123-126
MAXIT = 20
REPS = 5
ULP_LIMIT = 4
# (k, n, L1, upper_bound, dead coordinate): every k at every n of the main
# path's solves, with and without L1, then the special cases; k=128 puts G
# above 48 KB of shared memory and k=256 beyond it (read-only cache path)
CD_CASES = [(k, n, l1, 0.0, False) for k in (8, 20, 50, 100, 128)
            for n in (610, 2638, 13714) for l1 in (0.0, 0.25)]
CD_CASES += [(20, 2638, 0.0, 0.0, True), (50, 610, 0.25, 0.0, True),
             (20, 2638, 0.0, 2.0, False), (100, 610, 0.25, 2.0, False),
             (256, 610, 0.0, 0.0, False)]


def check(ok, what):
    """Fail the run (a plain ``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def simulated(shape, seed=0):
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(shape["m"], shape["n"], shape["k"], noise=0.5,
                     dropout=shape["dropout"], seed=seed)["A"]
    return torch.from_numpy(A).cuda()


def cuda_ms(fn, reps=REPS):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_ulp(a, b):
    """Largest distance in units in the last place between two fp32 tensors."""
    def ordered(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@contextlib.contextmanager
def plain_cd_twin():
    """Route the fit's CD solves to the plain twin: a test hook, used only to
    compare a fit through the kernel with the same fit without it."""
    from rcppml_tpu_torch.ops import cd_nnls, solvers
    kernel = solvers.cd_nnls_shared
    solvers.cd_nnls_shared = cd_nnls.cd_nnls_shared_plain
    try:
        yield
    finally:
        solvers.cd_nnls_shared = kernel


def cd_system(k, n, seed, dead=False):
    """A warm-started shared-Gram NNLS system in residual form."""
    rs = np.random.RandomState(seed)
    p = max(2 * k, 64)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    Y = (np.abs(rs.normal(size=(p, n)))
         * (rs.uniform(size=(p, n)) < 0.3)).astype(np.float32)
    G = F @ F.T
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    B_res = (F @ Y - G @ X0).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (G, B_res, X0)]


def check_losses(res, A, *, monotone):
    hist = np.asarray(res.loss_history, np.float64)
    check(hist.shape == (MAXIT,) and np.isfinite(hist).all(),
          f"finite loss history of {MAXIT}: {hist}")
    if monotone:
        rise = (hist[1:] - hist[:-1]) / np.abs(hist[:-1])
        check(rise.max() <= 1e-5, f"loss rose by {rise.max():.3g} relative")
    check(hist[-1] < hist[0], f"last loss below the first: {hist}")
    W = torch.from_numpy(np.ascontiguousarray(res.W)).cuda()
    H = torch.from_numpy(np.ascontiguousarray(res.H)).cuda()
    d = torch.from_numpy(res.d).cuda()
    mse = float(((A - (W * d) @ H) ** 2).mean())
    var = float(A.var())
    check(mse < var, f"reconstruction MSE {mse} below var(A) {var}")
    return hist, mse, var


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on the card")
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import _build, cd_nnls, linalg

    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    print(card, flush=True)
    if not rtt.kernels_available():
        raise SystemExit("chip_smoke: the kernels need compute capability "
                         "9.0 (sm_90a)")
    rtt.set_fp32_precision()

    phase("2 build")
    path, seconds = _build.build(cd_nnls.KERNEL)
    print(f"built {path.name} in {seconds:.2f} s", flush=True)
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line:
            print("  ptxas:", line.split(":", 1)[1].strip(), flush=True)

    phase("3 kernel against plain twin")
    max_abs_err = 0.0
    for k, n, l1, ub, dead in CD_CASES:
        G, B_res, X0 = cd_system(k, n, seed=k * 100003 + n, dead=dead)
        out = cd_nnls.cd_nnls_shared(G, B_res, X0, l1, 5e-6, nonneg=True,
                                     maxit=100, upper_bound=ub)
        torch.cuda.synchronize()
        plain = cd_nnls.cd_nnls_shared_plain(G, B_res, X0, l1, 5e-6,
                                             nonneg=True, maxit=100,
                                             upper_bound=ub)
        check(bool(torch.isfinite(out).all()), "finite CD solution")
        equal = torch.equal(out, plain)
        ulp = 0 if equal else max_ulp(out, plain)
        max_abs_err = max(max_abs_err, float((out - plain).abs().max()))
        print(f"k={k:3d} n={n:5d} L1={l1} ub={ub} dead={dead}: "
              f"{'bitwise equal' if equal else f'max {ulp} ulp'}, "
              f"{float((out > 0).float().mean()):.3f} of x > 0", flush=True)
        check(ulp <= ULP_LIMIT, f"kernel within {ULP_LIMIT} ulp of the twin at "
              f"k={k} n={n} L1={l1} ub={ub} dead={dead}: {ulp}")
        if dead:
            check(torch.equal(out[k // 2], X0[k // 2]),
                  "a dead coordinate keeps its warm start")

    phase("4 main path, CD solver")
    A_pb = simulated(PBMC)
    cd_nnls.cd_nnls_shared.launches = 0
    res_cd = rtt.nmf(A_pb, PBMC["k"], solver="cd", maxit=MAXIT, tol=0, seed=1)
    launches = cd_nnls.cd_nnls_shared.launches
    print(f"pbmc3k shape, k=20, CD: {launches} kernel launches", flush=True)
    check(launches == 2 * MAXIT, f"{2 * MAXIT} kernel launches, got {launches}")
    hist, mse, var = check_losses(res_cd, A_pb, monotone=True)
    print(f"  loss {hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < "
          f"var(A) {var:.6g}", flush=True)
    with plain_cd_twin():
        res_plain = rtt.nmf(A_pb, PBMC["k"], solver="cd", maxit=MAXIT, tol=0,
                            seed=1)
    check(np.array_equal(res_plain.loss_history, res_cd.loss_history),
          "the fit through the plain twin has the same loss history")
    print("  the same fit through the plain twin: identical loss history",
          flush=True)

    A_ml = simulated(MOVIELENS)
    cd_nnls.cd_nnls_shared.launches = 0
    res_ml = rtt.nmf(A_ml, MOVIELENS["k"], L1=(0, 0.01), maxit=MAXIT, tol=0,
                     seed=1)
    ml_launches = cd_nnls.cd_nnls_shared.launches
    print(f"movielens shape, k=50, L1=(0, 0.01), solver "
          f"{res_ml.misc['config'].solver.name}: {ml_launches} kernel "
          f"launches", flush=True)
    check(ml_launches == 2 * MAXIT,
          f"{2 * MAXIT} kernel launches, got {ml_launches}")
    hist, mse, var = check_losses(res_ml, A_ml, monotone=False)
    print(f"  loss {hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < "
          f"var(A) {var:.6g}", flush=True)

    phase("5 main path, default solver (Cholesky)")
    cd_nnls.cd_nnls_shared.launches = 0
    res_ch = rtt.nmf(A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1)
    check(res_ch.misc["config"].solver.name == "CHOLESKY",
          "auto selects Cholesky at k=20 without L1")
    check(cd_nnls.cd_nnls_shared.launches == 0,
          "the Cholesky fit launches no CD kernel")
    hist, mse, var = check_losses(res_ch, A_pb, monotone=True)
    print(f"pbmc3k shape, k=20, Cholesky: 0 kernel launches; loss "
          f"{hist[0]:.6g} -> {hist[-1]:.6g}; mse {mse:.6g} < var(A) "
          f"{var:.6g}", flush=True)

    phase(f"6 times (CUDA events, median of {REPS} after a warm-up) on "
          f"{card}")

    def solve_inputs(res, A, side):
        """The next iteration's solve of a finished fit, as the loop
        builds it: Gram, RHS and warm start in residual form."""
        W_T = torch.from_numpy(np.ascontiguousarray(res.W.T)).cuda()
        H = torch.from_numpy(np.ascontiguousarray(res.H)).cuda()
        F, X0, data = (W_T, H, A) if side == "H" else (H, W_T, A.T)
        G, B = linalg.gram(F), linalg.rhs(F, data)
        return G, B - G @ X0, X0

    solve_times = {}
    for label, res, A, side in (("(20, 2638) H side", res_cd, A_pb, "H"),
                                ("(20, 13714) W side", res_cd, A_pb, "W"),
                                ("(50, 610) H side", res_ml, A_ml, "H")):
        G, B_res, X0 = solve_inputs(res, A, side)
        ms = cuda_ms(lambda: cd_nnls.cd_nnls_shared(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100))
        plain_ms = cuda_ms(lambda: cd_nnls.cd_nnls_shared_plain(
            G, B_res, X0, 0.0, 5e-6, nonneg=True, maxit=100))
        solve_times[label] = (ms, plain_ms)
        print(f"solve {label}: kernel {ms:.4f} ms, plain twin "
              f"{plain_ms:.4f} ms  [{card}]", flush=True)

    fits = (("pbmc3k k=20 CD", lambda: rtt.nmf(
                A_pb, PBMC["k"], solver="cd", maxit=MAXIT, tol=0, seed=1)),
            ("pbmc3k k=20 Cholesky", lambda: rtt.nmf(
                A_pb, PBMC["k"], maxit=MAXIT, tol=0, seed=1)),
            ("movielens k=50 L1 CD", lambda: rtt.nmf(
                A_ml, MOVIELENS["k"], L1=(0, 0.01), maxit=MAXIT, tol=0,
                seed=1)))
    for label, fit in fits:
        print(f"fit {label}, {MAXIT} iterations: {cuda_ms(fit):.3f} ms  "
              f"[{card}]", flush=True)
    with plain_cd_twin():
        plain_fit_ms = cuda_ms(fits[0][1], reps=3)
    print(f"fit pbmc3k k=20 CD through the plain twin (median of 3): "
          f"{plain_fit_ms:.3f} ms  [{card}]", flush=True)

    ms, plain_ms = solve_times["(20, 2638) H side"]
    print(json.dumps({"kernels": [{
        "name": "cd_nnls_shared", "route": "cuda",
        "source": "rcppml_tpu_torch/csrc/cd_nnls_shared.cu",
        "replaces": "rcppml_tpu/ops/pallas_kernels.py:154",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
