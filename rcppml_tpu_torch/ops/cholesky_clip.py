"""Shared-Gram Cholesky solve + clip for a whole column batch: the CUDA kernel
and its plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_experiments.py::
cholesky_clip_pallas`` (body ``_make_chol_kernel``).  The CUDA source is
``csrc/cholesky_clip.cu``: one C call enqueues the factorization (one block,
k Schur-complement steps) and the solve (one thread per column: forward and
back substitution against a broadcast L, then the clip).  What bounds it on
the H100 is float32 arithmetic outside the tensor cores, k^3 / 3 + 2 k^2 n
operations; what it waits for is the latency of the k sequential pivot steps
and of each column's two dependent chains.

:func:`cholesky_clip` launches the kernel for a CUDA tensor and runs
:func:`cholesky_clip_plain` for a CPU tensor; there is no other branch.
``cholesky_clip.launches`` counts the C calls (two kernels each).  The port
reaches it from :func:`rcppml_tpu_torch.ops.solvers.cholesky_clip_batch` for
a CUDA tensor: the solve of every default MSE fit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

KERNEL = "cholesky_clip"
# a pivot that is not above this is replaced by it
PIVOT_FLOOR = 1e-30


def cholesky_factor_plain(G: torch.Tensor) -> torch.Tensor:
    """L (k, k), lower triangular, with G = L L^T: k Schur-complement steps on
    the lower triangle, each an elementwise divide, multiply and subtract, in
    the kernel's order.  A pivot that is not above ``PIVOT_FLOOR`` (G not
    positive definite, or NaN) is replaced by G's own diagonal entry, or by
    ``PIVOT_FLOOR`` where that is not above it either: a rank-deficient
    fp32 Gram whose rounding drives a pivot to zero or below then gives a
    damped, finite solution instead of dividing by 1e-15."""
    k = G.shape[0]
    S = G.clone()
    floor = torch.tensor(PIVOT_FLOOR, dtype=G.dtype, device=G.device)
    diag = torch.diagonal(G)
    stand_in = torch.where(diag > floor, diag, floor)
    for j in range(k):
        piv = S[j, j]
        d = torch.sqrt(torch.where(piv > floor, piv, stand_in[j]))
        col = S[j + 1:, j] / d
        S[j, j] = d
        S[j + 1:, j] = col
        # in place: S is ours
        S[j + 1:, j + 1:] -= col[:, None] * col[None, :]
    return torch.tril(S)


def cholesky_clip_plain(G: torch.Tensor, B: torch.Tensor, *,
                        nonneg: bool = True,
                        upper_bound: float = 0.0) -> torch.Tensor:
    """Plain twin: :func:`cholesky_factor_plain`, then forward and back
    substitution in column-oriented form (after row i is final, its multiple
    is subtracted from the rows that still wait), which gives every entry the
    same sequence of operations as the kernel's running sums, then the clip.
    G (k, k) with the caller's ridge, B (k, n) -> X (k, n)."""
    k = G.shape[0]
    L = cholesky_factor_plain(G)
    X = B.clone(memory_format=torch.contiguous_format)
    for i in range(k):                                   # L y = b
        X[i] = X[i] / L[i, i]
        X[i + 1:] -= L[i + 1:, i:i + 1] * X[i:i + 1]
    for i in range(k - 1, -1, -1):                       # L^T x = y
        X[i] = X[i] / L[i, i]
        X[:i] -= L[i, :i, None] * X[i:i + 1]
    if nonneg:
        X = torch.clamp_min(X, 0.0)
    if upper_bound > 0:
        X = torch.clamp_max(X, upper_bound)
    return X


def _check(G, B):
    if G.ndim != 2 or B.ndim != 2 or G.shape != (B.shape[0], B.shape[0]):
        raise ValueError(f"cholesky_clip: G {tuple(G.shape)} and B "
                         f"{tuple(B.shape)} do not fit together")
    for name, t in (("G", G), ("B", B)):
        if t.dtype != torch.float32:
            raise TypeError(f"cholesky_clip: {name} must be float32, "
                            f"got {t.dtype}")
    if G.device != B.device:
        raise ValueError(f"cholesky_clip: G is on {G.device}, B on "
                         f"{B.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.cholesky_clip_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def cholesky_clip(G: torch.Tensor, B: torch.Tensor, *, nonneg: bool = True,
                  upper_bound: float = 0.0) -> torch.Tensor:
    """Solve G X = B for all columns by Cholesky, then clip: G (k, k)
    symmetric positive definite (the caller adds any ridge; only the lower
    triangle is read), B (k, n) -> X (k, n), float32, any k and n.

    A pivot that is not above 1e-30 is replaced by G's own diagonal entry
    (or by 1e-30 where that is not above it) instead of raising as
    ``torch.linalg.cholesky`` would: a G that is not positive definite gives
    a finite solution (a NaN in G gives NaN), it does not hang and there is
    no host read.  A positive definite G never meets the rule.  On a CUDA
    tensor this launches the kernels (and raises if a launch fails); on a
    CPU tensor it runs :func:`cholesky_clip_plain`.
    """
    _check(G, B)
    if not B.is_cuda:
        return cholesky_clip_plain(G, B, nonneg=nonneg,
                                   upper_bound=upper_bound)
    k, n = B.shape
    X = torch.empty((k, n), dtype=torch.float32, device=B.device)
    if k == 0 or n == 0:
        return X
    L = torch.empty((k, k), dtype=torch.float32, device=B.device)
    G_c, B_c = G.contiguous(), B.contiguous()
    lib = _library()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.cholesky_clip_launch(
            G_c.data_ptr(), B_c.data_ptr(), L.data_ptr(), X.data_ptr(), k, n,
            int(bool(nonneg)), float(np.float32(upper_bound)), stream)
    if err != 0:
        raise RuntimeError(f"cholesky_clip kernel launch failed: CUDA error "
                           f"{err} (k={k}, n={n})")
    cholesky_clip.launches += 1
    return X


cholesky_clip.launches = 0
