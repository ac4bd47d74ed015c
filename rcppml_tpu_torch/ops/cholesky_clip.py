"""Shared-Gram Cholesky solve + clip for a whole column batch: the CUDA kernel
and its plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_experiments.py::
cholesky_clip_pallas`` (body ``_make_chol_kernel``).  The CUDA source is
``csrc/cholesky_clip.cu``.  Up to k = :data:`LANES_MAX_K` one launch does
everything: each block's warp 0 factors G in registers (a lane a row, one
shuffle a pivot and a trailing entry) while the block copies its columns of
B into shared memory, then a group of lanes solves each column, the lanes
holding its rows in registers and a shuffle handing each y_i and x_i to the
group (:func:`plan_cholesky_clip` sets the group width and the block).
Beyond, two kernels: the factor in one block, then one thread per column.
What bounds it on the H100 is bytes (one read of G and B, one write of X)
against k^3 / 3 + 2 k^2 n float32 operations; what it waits for is the
latency of the k sequential pivot steps and each column's 2k steps.

:func:`cholesky_clip` launches the kernel for a CUDA tensor and runs
:func:`cholesky_clip_plain` for a CPU tensor; there is no other branch.
``cholesky_clip.launches`` counts the C calls (one kernel each up to
:data:`LANES_MAX_K`, two beyond).  The port reaches it from
:func:`rcppml_tpu_torch.ops.solvers.cholesky_clip_batch` for a CUDA tensor:
the solve of every default MSE fit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .rhs_tall import H100_SMS, device_sms

KERNEL = "cholesky_clip"
# a pivot that is not above this is replaced by it
PIVOT_FLOOR = 1e-30
# csrc/cholesky_clip.cu: route 1 (one launch, lane groups) up to this k; its
# rows a lane (template instances) and largest block
LANES_MAX_K = 64
LANE_ROWS = (1, 2, 4, 8)
LANES_MAX_THREADS = 256
SHARED_OPTIN = 232448
# the rows a lane holds (route 1): two up to FEW_COLUMNS columns, else
# MANY_ROWS, each for (k <= 32, k > 32); measured on an H100 at the main
# path's solves over every group width and block (tools/torch_k46_variants.py).
# Past k = 32 the factor's 156 registers a thread hold a multiprocessor to
# 12 warps, and the wide groups lose
FEW_COLUMNS, MANY_ROWS = (8192, 1024), (4, 8)
LANES_THREADS = 128


class CholPlan(NamedTuple):
    """How a (k, n) solve is launched (``csrc/cholesky_clip.cu``)."""
    lanes: int          # lanes of a column's group (route 1); 0: route 2
    rows: int           # rows a lane holds: a template instance >= k / lanes
    threads: int        # threads of a block
    ldx: int            # row stride of the block's column tile
    shared_bytes: int   # dynamic shared memory of a block (route 1)
    blocks: int


def tile_stride(cols: int, lanes: int) -> int:
    """Row stride of the column tile: at least ``cols``, and congruent to
    32 / lanes mod 32, so that the lanes of a warp (lanes rows by 32 / lanes
    columns) meet 32 distinct banks."""
    return -(-cols // 32) * 32 + (32 // lanes) % 32


def plan_cholesky_clip(k: int, n: int, sms: int = H100_SMS) -> CholPlan:
    """The launch of a (k, n) solve.

    Past :data:`LANES_MAX_K`, route 2 (one block factors, one thread a
    column solves).  Up to it, route 1 with the rows a lane holds set by k
    and n as measured fastest on the H100 (:data:`FEW_COLUMNS`,
    :data:`MANY_ROWS`): two for k <= 32 up to n = 8,192 columns and four
    beyond; past k = 32 two up to n = 1,024 and eight beyond.  A column's group is the smallest power of two of
    lanes that holds k rows at that many a lane (at most 32); a block is
    128 threads, halved while that leaves a multiprocessor without a block.
    A function of the shapes and the card alone."""
    if k < 1 or n < 1:
        raise ValueError(f"plan_cholesky_clip: k={k} and n={n} must be "
                         "positive")
    if k > LANES_MAX_K:
        return CholPlan(0, 0, 128, 0, 0, -(-n // 128))
    wide = int(k > 32)
    target = MANY_ROWS[wide] if n > FEW_COLUMNS[wide] else 2
    lanes = 1
    while lanes < 32 and -(-k // lanes) > target:
        lanes *= 2
    need = -(-k // lanes)
    rows = next(r for r in LANE_ROWS if r >= need)
    threads = LANES_THREADS
    while threads > 32 and -(-n // (threads // lanes)) < sms:
        threads //= 2
    cols = threads // lanes
    ldx = tile_stride(cols, lanes)
    return CholPlan(lanes, rows, threads, ldx, 4 * k * ((k | 1) + ldx),
                    -(-n // cols))


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
    tensor this launches the kernel (:func:`plan_cholesky_clip`; it raises
    if a launch fails); on a CPU tensor it runs :func:`cholesky_clip_plain`.
    """
    _check(G, B)
    if not B.is_cuda:
        return cholesky_clip_plain(G, B, nonneg=nonneg,
                                   upper_bound=upper_bound)
    k, n = B.shape
    X = torch.empty((k, n), dtype=torch.float32, device=B.device)
    if k == 0 or n == 0:
        return X
    plan = plan_cholesky_clip(k, n, device_sms(B.device))
    # route 2's factor goes to device memory
    L = torch.empty((k, k), dtype=torch.float32, device=B.device) \
        if plan.lanes == 0 else None
    G_c, B_c = G.contiguous(), B.contiguous()
    lib = _library()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.cholesky_clip_launch(
            G_c.data_ptr(), B_c.data_ptr(),
            L.data_ptr() if L is not None else None, X.data_ptr(), k, n,
            int(bool(nonneg)), float(np.float32(upper_bound)), plan.lanes,
            plan.rows, plan.threads, plan.ldx, stream)
    if err != 0:
        raise RuntimeError(f"cholesky_clip kernel launch failed: CUDA error "
                           f"{err} (k={k}, n={n})")
    cholesky_clip.launches += 1
    return X


cholesky_clip.launches = 0
