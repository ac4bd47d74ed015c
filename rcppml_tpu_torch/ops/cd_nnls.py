"""Coordinate-descent NNLS against one shared Gram: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::
cd_nnls_pallas_shared`` (body ``_make_cd_kernel(batched=False)``).  The CUDA
source is ``csrc/cd_nnls_shared.cu`` with its device code in
``csrc/cd_nnls.cuh``, which kernel 2 (:mod:`.cd_nnls_batched`) shares: a
group of lanes per column (the smallest power of two >= k, at most 32; fewer
where so many columns keep the card busy that issue, not latency, bounds
the solve), each lane holding the residual and solution of its rows in
registers for the whole solve; the owner lane of a coordinate computes the
step and hands ``actual`` to the group with one shuffle, and every lane
updates its own rows.  G is
staged once per block in shared memory (row stride k | 1) while it fits and
is read from device memory beyond.  :func:`plan_cd` chooses the group, the
rows a lane holds, the block and the shared memory.

What bounds it on the H100 is the dependent chain of the slowest column
(max sweeps x k coordinate steps, each an IEEE division, a few adds and a
shuffle) and the issue rate of all columns' steps.  The order of operations
is the twin's: a coordinate step reduces nothing (the k residual updates are
independent across rows, and the only sum, the sweep's tol, runs over the
coordinates in order), so the kernel equals :func:`cd_nnls_shared_plain` bit
for bit.

:func:`cd_nnls_shared` launches the kernel for a CUDA tensor and runs
:func:`cd_nnls_shared_plain` for a CPU tensor; there is no other branch.
``cd_nnls_shared.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from . import _build

KERNEL = "cd_nnls_shared"
# the H100's shared memory: a block's opt-in limit (227 KB) and a
# multiprocessor's (228 KB), of which the runtime keeps 1 KB per block
SHARED_OPTIN, SM_SHARED, BLOCK_RESERVED = 232448, 233472, 1024
# rows a lane holds in registers (template instances 1, 2, 4, 8); beyond,
# one warp a column with its residual and solution in shared memory
MAX_ROWS = 8
# about 20 warps on each of the H100's 132 multiprocessors: a solve that
# keeps that many busy is bound by the issue of its steps, and then fewer
# lanes a column pay (measured on an H100 at the main path's solves:
# (20, 13,714) took 0.490 / 0.423 / 0.325 ms with 32 / 16 / 8 lanes,
# (20, 2,638) 0.187 / 0.211 ms with 32 / 16)
BUSY_THREADS = 132 * 20 * 32
# a block of the shared-Gram kernel: threads while G is small, and when it is
# large (one block a multiprocessor: more columns share the staged G)
THREADS_SMALL_GRAM, THREADS_LARGE_GRAM, LARGE_GRAM_BYTES = 128, 512, 24 * 1024


class CDPlan(NamedTuple):
    """How a CD solve is launched (``csrc/cd_nnls.cuh``)."""
    lanes: int          # lanes of a column's group: a power of two <= 32
    rows: int           # rows a lane holds: 1, 2, 4 or 8; 0 for the loop
    threads: int        # threads of a block, a multiple of 32 and of lanes
    shared_bytes: int   # dynamic shared memory of a block
    gram_shared: bool   # the Gram is read from shared memory
    blocks: int


def lanes_rows(k: int, n: int) -> tuple[int, int]:
    """A column's lanes and the rows each lane holds in registers.

    Lanes: the smallest power of two >= k, at most 32, which gives the
    shortest chain a step; then halved while the n columns would still
    have :data:`BUSY_THREADS` threads with half the lanes, and the rows stay
    within :data:`MAX_ROWS`: with that many warps the issue of all columns'
    steps bounds the solve, not one column's chain, and half the lanes with
    twice the rows cost fewer issue slots a column.  Rows: the smallest
    power of two covering k, or 0 where more than :data:`MAX_ROWS` are
    needed (the loop variant, 32 lanes)."""
    lanes = 1
    while lanes < min(k, 32):
        lanes *= 2
    if -(-k // lanes) > MAX_ROWS:
        return 32, 0
    while (lanes > 1 and n * (lanes // 2) >= BUSY_THREADS
           and -(-k // (lanes // 2)) <= MAX_ROWS):
        lanes //= 2
    need = -(-k // lanes)
    rows = 1
    while rows < need:
        rows *= 2
    return lanes, rows


def gram_bytes(k: int) -> int:
    """A k x k Gram in shared memory with the odd row stride k | 1."""
    return 4 * k * (k | 1)


def loop_groups(k: int, groups: int) -> int:
    """Columns a block of the loop variant runs: at most ``groups``, and as
    many as 2 k floats each fit a block's shared memory."""
    fit = SHARED_OPTIN // (8 * k)
    if fit < 1:
        raise ValueError(f"CD NNLS: k={k} needs {8 * k} bytes of shared "
                         f"memory a column (limit {SHARED_OPTIN})")
    return min(groups, fit)


def plan_cd(k: int, n: int) -> CDPlan:
    """The launch of the shared-Gram kernel for a (k, n) solve.  G goes to
    shared memory once per block while k (k | 1) floats fit one block's
    opt-in limit (k <= 241); blocks hold 128 threads, or 512 once G passes
    24 KB, so that more columns share one staged copy."""
    if k < 1 or n < 1:
        raise ValueError(f"plan_cd: k={k} and n={n} must be positive")
    lanes, rows = lanes_rows(k, n)
    if rows == 0:
        groups = loop_groups(k, THREADS_LARGE_GRAM // 32)
        return CDPlan(32, 0, 32 * groups, groups * 8 * k, False,
                      -(-n // groups))
    shared = gram_bytes(k) <= SHARED_OPTIN
    threads = THREADS_SMALL_GRAM if gram_bytes(k) <= LARGE_GRAM_BYTES \
        else THREADS_LARGE_GRAM
    groups = threads // lanes
    return CDPlan(lanes, rows, threads, gram_bytes(k) if shared else 0,
                  shared, -(-n // groups))


def _scalars(k: int, L1: float, cd_tol: float):
    """The solve's float32 scalars, each rounded once from the double value
    as ``jnp.asarray(x, float32)`` rounds it in ``_cd_sweeps``."""
    return (np.float32(L1), np.float32(cd_tol), np.float32(1.0 / k),
            np.float32(constants.CD_ABS_TOL))


def cd_nnls_shared_plain(G: torch.Tensor, B_res: torch.Tensor,
                         X0: torch.Tensor, L1: float, cd_tol: float, *,
                         nonneg: bool, maxit: int,
                         upper_bound: float = 0.0,
                         return_sweeps: bool = False):
    """Plain twin of ``rcppml_tpu/ops/solvers.py::_cd_sweeps`` (with
    ``l1_static=True``): the same names, the same order of operations.

    ``B_res`` is the residual ``B - G @ X0``.  Runs on whatever device the
    tensors are on; reads ``any(active)`` on the host once per sweep.  With
    ``return_sweeps`` it returns ``(X, sweeps)``, ``sweeps`` an (n,) int64
    tensor of the sweeps each column ran before it froze: the kernel, being
    bitwise equal, ran the same ones.
    """
    k, n = B_res.shape
    dev, dtype = B_res.device, B_res.dtype
    l1_, tol_, inv_k_, abs_tol_ = _scalars(k, L1, cd_tol)
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    L1_t, cd_tol_t, inv_k, abs_tol = as_t(l1_), as_t(tol_), as_t(inv_k_), \
        as_t(abs_tol_)
    zero = torch.zeros((), dtype=dtype, device=dev)
    ub = as_t(np.float32(upper_bound))
    gdiag = torch.diagonal(G)
    gdiag_ok = gdiag > 0

    # contiguous copies, as the kernel's wrapper makes: the solution's layout
    # would otherwise follow X0's into the next matmuls and their rounding
    X = X0.clone(memory_format=torch.contiguous_format)
    B_res = B_res.clone(memory_format=torch.contiguous_format)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    sweeps = torch.zeros((n,), dtype=torch.int64, device=dev)
    it = 0
    while it < maxit and bool(active.any()):
        sweeps += active
        tol_sum = torch.zeros((n,), dtype=dtype, device=dev)
        for i in range(k):
            g = gdiag[i]
            b_i = B_res[i]
            x_i = X[i]
            diff = torch.where(gdiag_ok[i], b_i / g, zero)
            # a dead coordinate (g <= 0) skips its L1 term too
            diff = diff - torch.where(gdiag_ok[i], L1_t, zero)
            new_val = x_i + diff
            if nonneg:
                new_val = torch.maximum(new_val, zero)
            if upper_bound > 0:
                new_val = torch.minimum(new_val, ub)
            actual = (new_val - x_i) * active          # frozen columns stay
            x_new = x_i + actual
            g_col = G[:, i:i + 1]
            B_res -= g_col * actual[None, :]           # in place: rank-1 update
            tol_sum = tol_sum + torch.abs(actual) / (torch.abs(x_new)
                                                     + abs_tol)
            X[i] = x_new                               # in place: row i only
        # per-SWEEP relative convergence (nnls_batch.hpp:126-129)
        still = tol_sum * inv_k >= cd_tol_t
        active = active & still
        it += 1
    return (X, sweeps) if return_sweeps else X


def _check(G, B_res, X0):
    k, n = B_res.shape
    if G.shape != (k, k) or X0.shape != (k, n):
        raise ValueError(f"cd_nnls_shared: G {tuple(G.shape)}, B_res "
                         f"{tuple(B_res.shape)} and X0 {tuple(X0.shape)} do "
                         "not fit together")
    for name, t in (("G", G), ("B_res", B_res), ("X0", X0)):
        if t.dtype != torch.float32:
            raise TypeError(f"cd_nnls_shared: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != B_res.device:
            raise ValueError(f"cd_nnls_shared: {name} is on {t.device}, "
                             f"B_res on {B_res.device}")


# the C signature both CD kernels' entry points share
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.cd_nnls_shared_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def launch(fn, name: str, gram, B_res, X0, L1, cd_tol, nonneg, maxit,
           upper_bound, plan: CDPlan) -> torch.Tensor:
    """Run one CD kernel's entry point ``fn`` on the current stream of
    B_res's card: X (k, n) from the contiguous Gram(s), residual and warm
    start.  Raises RuntimeError with the CUDA error if the launch fails."""
    k, n = B_res.shape
    gram, B_c, X0_c = gram.contiguous(), B_res.contiguous(), X0.contiguous()
    X = torch.empty((k, n), dtype=torch.float32, device=B_res.device)
    l1_, tol_, inv_k_, abs_tol_ = _scalars(k, L1, cd_tol)
    with torch.cuda.device(B_res.device):
        stream = torch.cuda.current_stream(B_res.device).cuda_stream
        err = fn(gram.data_ptr(), B_c.data_ptr(), X0_c.data_ptr(),
                 X.data_ptr(), k, n, float(l1_), float(tol_), float(inv_k_),
                 float(abs_tol_), int(bool(nonneg)), int(maxit),
                 float(np.float32(upper_bound)), plan.lanes, plan.rows,
                 plan.threads, plan.shared_bytes, int(plan.gram_shared),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(k={k}, n={n}, {plan})")
    return X


def cd_nnls_shared(G: torch.Tensor, B_res: torch.Tensor, X0: torch.Tensor,
                   L1: float, cd_tol: float, *, nonneg: bool, maxit: int,
                   upper_bound: float = 0.0) -> torch.Tensor:
    """Shared-Gram CD NNLS: G (k, k), B_res/X0 (k, n) in residual form.

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`cd_nnls_shared_plain`.
    """
    _check(G, B_res, X0)
    if not B_res.is_cuda:
        return cd_nnls_shared_plain(G, B_res, X0, L1, cd_tol, nonneg=nonneg,
                                    maxit=maxit, upper_bound=upper_bound)
    k, n = B_res.shape
    if n == 0 or maxit <= 0:
        return X0.clone(memory_format=torch.contiguous_format)
    X = launch(_library().cd_nnls_shared_launch, KERNEL, G, B_res, X0, L1,
               cd_tol, nonneg, maxit, upper_bound, plan_cd(k, n))
    cd_nnls_shared.launches += 1
    return X


cd_nnls_shared.launches = 0
