#!/usr/bin/env python3
"""Time kernels 4 (``weighted_gram_rhs``), 5 (``weighted_gram``) and 6
(``cholesky_clip``) from one checkout, and fingerprint kernel 5's results.

    cd <checkout> && python3 <path to this file> <label>

Imports ``chip_smoke.py`` and ``rcppml_tpu_torch`` from the current directory
and builds their data on the card as ``chip_smoke.py`` does (pbmc3k and
movielens shapes, seeded).  One line each, device time by CUDA events:

  * kernel 6 at the solves of the default MSE fits, (k, n) = (20, 2,638),
    (20, 13,714) and (50, 610), from a replayed CUDA graph of 20 calls,
    median of 5 (G and B: the next iteration's solve of a finished
    Cholesky fit);
  * kernel 4 at the KL fit's two sides, (k, m, bc) = (16, 13,714, 2,638)
    and (16, 2,638, 13,714) (F and X from a finished KL fit), median of 5
    after a warm-up;
  * kernel 5 at the masked k=128 fit's column blocks, (128, 13,714, 68) and
    (128, 13,714, 54), median of 5 after a warm-up;
  * a SHA-256 of kernel 5's Gram and right-hand side at every case of
    ``chip_smoke.WG5_CASES``: two checkouts whose lines agree computed the
    same bits;
  * a SHA-256 of the instructions ``cuobjdump -sass`` shows for kernel 5's
    library, function names and addresses left out: two checkouts whose
    lines agree run the same machine code.

To compare two commits on one card, unpack both side by side and run this
from each in turn within one job (parent, change, change, parent): every
input is made the same way, so both time the same work.  Needs a CUDA card of
compute capability 9.0; imports no JAX.
"""

import hashlib
import importlib.util
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_k456: CUDA is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import (_build, cholesky_clip, linalg, solvers,
                                      weighted_gram, wgram)
    rtt.set_fp32_precision()
    _build.build_all([cholesky_clip.KERNEL, wgram.KERNEL,
                      weighted_gram.KERNEL])
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    batch = 20

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(batch):
                fn()
        return smoke.cuda_ms(graph.replay) / batch

    def factors(res):
        return (torch.from_numpy(np.ascontiguousarray(res.W.T)).cuda(),
                torch.from_numpy(np.ascontiguousarray(res.H)).cuda())

    A_pb, A_ml = smoke.simulated(smoke.PBMC), smoke.simulated(smoke.MOVIELENS)
    for name, A, k in (("pbmc3k", A_pb, smoke.PBMC["k"]),
                       ("movielens", A_ml, smoke.MOVIELENS["k"])):
        res = rtt.nmf(A, k, maxit=smoke.MAXIT, tol=0, seed=1)
        W_T, H = factors(res)
        sides = (("H", W_T, A), ("W", H, A.T)) if name == "pbmc3k" else \
            (("H", W_T, A),)
        for side, F, data in sides:
            G, B = solvers._ridged(linalg.gram(F)), linalg.rhs(F, data)
            ms = graph_ms(lambda: cholesky_clip.cholesky_clip(G, B))
            print(label, f"cholesky_clip {side} side (k={B.shape[0]}, "
                  f"n={B.shape[1]}): {ms:.4f} ms", flush=True)

    A_ct, _ = smoke.pbmc_counts(smoke.KL_K)
    res = smoke.kl_fit(rtt, A_ct)
    W_T, H = factors(res)
    for side, F, X, A_blk in (("H", W_T, H, A_ct),
                              ("W", H, W_T, A_ct.T.contiguous())):
        ms = smoke.cuda_ms(lambda: wgram.weighted_gram_rhs(
            F, X, A_blk, loss_kind="kl"))
        print(label, f"weighted_gram_rhs {side} side (k={F.shape[0]}, "
              f"m={F.shape[1]}, bc={X.shape[1]}): {ms:.4f} ms", flush=True)
    del A_ct

    m_pb, k128 = smoke.PBMC["m"], smoke.MASK_K128
    for bc in (68, 54):
        F, w, A_blk = smoke.wg5_inputs(k128, m_pb, bc, False, True, seed=bc)
        ms = smoke.cuda_ms(lambda: weighted_gram.weighted_gram(F, w, A_blk))
        print(label, f"weighted_gram (k={k128}, m={m_pb}, bc={bc}): "
              f"{ms:.4f} ms", flush=True)
        del F, w, A_blk

    digest = hashlib.sha256()
    for k, m, bc, real, strided in smoke.WG5_CASES:
        F, w, A_blk = smoke.wg5_inputs(k, m, bc, real, strided,
                                       seed=k * 1013 + bc)
        Gb, b = weighted_gram.weighted_gram(F, w, A_blk)
        digest.update(Gb.cpu().numpy().tobytes())
        digest.update(b.cpu().numpy().tobytes())
        del F, w, A_blk, Gb, b
    print(label, f"weighted_gram results at the {len(smoke.WG5_CASES)} "
          f"cases of WG5_CASES: sha256 {digest.hexdigest()}", flush=True)

    # each function's instructions alone ("/*0f30*/  MUFU.RSQ R3, R0 ;
    # /* encoding */"), hashed, the hashes sorted: neither the functions'
    # names nor their order in the library count
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         str(_build.library_path(weighted_gram.KERNEL))],
        capture_output=True, text=True, check=True).stdout
    functions = sorted(
        hashlib.sha256("\n".join(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", part)).encode()).hexdigest()
        for part in sass.split("Function :")[1:])
    print(label, f"weighted_gram machine code: {len(functions)} functions, "
          f"sha256 {hashlib.sha256(' '.join(functions).encode()).hexdigest()}",
          flush=True)


if __name__ == "__main__":
    main()
