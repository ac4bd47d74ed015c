"""Coordinate-descent NNLS with one Gram per column: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::
cd_nnls_pallas_batched`` (body ``_make_cd_kernel(batched=True)``).  The CUDA
source is ``csrc/cd_nnls_batched.cu`` with its device code in
``csrc/cd_nnls.cuh``, which kernel 1 (:mod:`.cd_nnls`) shares: a group of
lanes per column, each lane holding the residual and solution of its rows in
registers for the whole solve, the owner lane of a coordinate handing the
step to the group with one shuffle.  The Grams are read from the (n, k, k)
batch as it lies, no transposed copy: on the main route each group copies
its column's Gram once per solve into shared memory (row stride k | 1); a
Gram too large for eight columns to stay resident on a multiprocessor
(k > 83) is read from device memory at each step instead.  :func:`plan_cd`
chooses.

What bounds it on the H100 is the dependent chain of the slowest column
(max sweeps x k coordinate steps) and the issue rate of all columns' steps;
then one read of the n k^2 4 bytes of Grams.  The order of operations is the
twin's (a coordinate step reduces nothing; the sweep's tol runs over the
coordinates in order), so the kernel equals :func:`cd_nnls_batched_plain`
bit for bit.

:func:`cd_nnls_batched` launches the kernel for a CUDA tensor and runs
:func:`cd_nnls_batched_plain` for a CPU tensor; there is no other branch.
``cd_nnls_batched.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .cd_nnls import (BLOCK_RESERVED, LAUNCH_ARGTYPES, SM_SHARED, CDPlan,
                      _scalars, gram_bytes, lanes_rows, launch, loop_groups)

KERNEL = "cd_nnls_batched"
# columns that must stay resident on a multiprocessor for a Gram to be kept
# in shared memory; threads of a block that reads its Grams from device
# memory
GRAM_GROUPS_PER_SM, THREADS = 8, 128


def plan_cd(k: int, n: int) -> CDPlan:
    """The launch of the per-column-Gram kernel for a (k, n) solve.  A
    column's Gram goes to shared memory once per solve while eight such
    columns fit a multiprocessor (k <= 83), in blocks of one warp: a block
    holds its shared memory until its slowest column freezes, and one warp
    a block hands it on soonest (measured at (50, 3,867): 1.13 ms against
    1.24 with four warps).  Beyond, each group reads its Gram from device
    memory at every step, in blocks of 128 threads."""
    if k < 1 or n < 1:
        raise ValueError(f"plan_cd: k={k} and n={n} must be positive")
    lanes, rows = lanes_rows(k, n)
    if rows == 0:
        groups = loop_groups(k, THREADS // 32)
        return CDPlan(32, 0, 32 * groups, groups * 8 * k, False,
                      -(-n // groups))
    per = gram_bytes(k)
    if GRAM_GROUPS_PER_SM * (per + BLOCK_RESERVED) <= SM_SHARED:
        groups = 32 // lanes
        return CDPlan(lanes, rows, 32, groups * per, True, -(-n // groups))
    return CDPlan(lanes, rows, THREADS, 0, False,
                  -(-n // (THREADS // lanes)))


def cd_nnls_batched_plain(Gb: torch.Tensor, B_res: torch.Tensor,
                          X0: torch.Tensor, L1: float, cd_tol: float, *,
                          nonneg: bool, maxit: int,
                          upper_bound: float = 0.0,
                          return_sweeps: bool = False):
    """Plain twin of the lax loop in ``rcppml_tpu/ops/solvers.py::
    cd_nnls_batched_gram``: the same names, the same order of operations.

    Gb (n, k, k), B_res (k, n) the residual ``b_j - G_j x0_j``, X0 (k, n).
    The rank-1 update reads COLUMN i of each Gram, ``Gb[j, :, i]``, as the
    lax loop does; the Grams are symmetric only in exact arithmetic.  Reads
    ``any(active)`` on the host once per sweep.  With ``return_sweeps`` it
    returns ``(X, sweeps)``, ``sweeps`` an (n,) int64 tensor of the sweeps
    each column ran before it froze.
    """
    k, n = B_res.shape
    dev, dtype = B_res.device, B_res.dtype
    l1_, tol_, inv_k_, abs_tol_ = _scalars(k, L1, cd_tol)
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    L1_t, cd_tol_t, inv_k, abs_tol = as_t(l1_), as_t(tol_), as_t(inv_k_), \
        as_t(abs_tol_)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    ub = as_t(np.float32(upper_bound))
    gdiag = torch.diagonal(Gb, dim1=1, dim2=2).T.contiguous()      # (k, n)

    X = X0.clone(memory_format=torch.contiguous_format)
    B = B_res.clone(memory_format=torch.contiguous_format)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    sweeps = torch.zeros((n,), dtype=torch.int64, device=dev)
    it = 0
    while it < maxit and bool(active.any()):
        sweeps += active
        tol_sum = torch.zeros((n,), dtype=dtype, device=dev)
        for i in range(k):
            g = gdiag[i]
            b_i = B[i]
            x_i = X[i]
            ok = g > 0
            # dead coordinates (g <= 0) are skipped entirely, L1 included
            diff = torch.where(ok, b_i / torch.where(ok, g, one) - L1_t, zero)
            new_val = x_i + diff
            if nonneg:
                new_val = torch.maximum(new_val, zero)
            if upper_bound > 0:
                new_val = torch.minimum(new_val, ub)
            actual = (new_val - x_i) * active          # frozen columns stay
            x_new = x_i + actual
            g_col = Gb[:, :, i].T                      # (k, n): column i
            B -= g_col * actual[None, :]               # in place
            tol_sum = tol_sum + torch.abs(actual) / (torch.abs(x_new)
                                                     + abs_tol)
            X[i] = x_new                               # in place: row i only
        still = tol_sum * inv_k >= cd_tol_t
        active = active & still
        it += 1
    return (X, sweeps) if return_sweeps else X


def _check(Gb, B_res, X0):
    k, n = B_res.shape
    if Gb.shape != (n, k, k) or X0.shape != (k, n):
        raise ValueError(f"cd_nnls_batched: Gb {tuple(Gb.shape)}, B_res "
                         f"{tuple(B_res.shape)} and X0 {tuple(X0.shape)} do "
                         "not fit together")
    for name, t in (("Gb", Gb), ("B_res", B_res), ("X0", X0)):
        if t.dtype != torch.float32:
            raise TypeError(f"cd_nnls_batched: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != B_res.device:
            raise ValueError(f"cd_nnls_batched: {name} is on {t.device}, "
                             f"B_res on {B_res.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.cd_nnls_batched_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def cd_nnls_batched(Gb: torch.Tensor, B_res: torch.Tensor, X0: torch.Tensor,
                    L1: float, cd_tol: float, *, nonneg: bool, maxit: int,
                    upper_bound: float = 0.0) -> torch.Tensor:
    """Per-column-Gram CD NNLS: Gb (n, k, k), B_res/X0 (k, n) in residual
    form -> X (k, n).

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`cd_nnls_batched_plain`.
    """
    _check(Gb, B_res, X0)
    if not B_res.is_cuda:
        return cd_nnls_batched_plain(Gb, B_res, X0, L1, cd_tol, nonneg=nonneg,
                                     maxit=maxit, upper_bound=upper_bound)
    k, n = B_res.shape
    if n == 0 or maxit <= 0:
        return X0.clone(memory_format=torch.contiguous_format)
    X = launch(_library().cd_nnls_batched_launch, KERNEL, Gb, B_res, X0, L1,
               cd_tol, nonneg, maxit, upper_bound, plan_cd(k, n))
    cd_nnls_batched.launches += 1
    return X


cd_nnls_batched.launches = 0
