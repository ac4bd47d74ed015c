"""Coordinate-descent NNLS against one shared Gram: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::
cd_nnls_pallas_shared`` (body ``_make_cd_kernel(batched=False)``).  The CUDA
source is ``csrc/cd_nnls_shared.cu``: one thread per column, G staged in
shared memory, the residual and solution in device memory.  What bounds it on
the H100 is the latency of the k-sequential coordinate chain: with one thread
per column, a solve at n = 2,638 fills only about 21 blocks of 128 threads on
132 SMs.  That is where making it fast starts.

:func:`cd_nnls_shared` launches the kernel for a CUDA tensor and runs
:func:`cd_nnls_shared_plain` for a CPU tensor; there is no other branch.
``cd_nnls_shared.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants
from . import _build

KERNEL = "cd_nnls_shared"


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


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.cd_nnls_shared_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    X = X0.clone(memory_format=torch.contiguous_format)  # solved in place
    if n == 0 or maxit <= 0:
        return X
    G_c = G.contiguous()
    B_work = B_res.clone(memory_format=torch.contiguous_format)
    l1_, tol_, inv_k_, abs_tol_ = _scalars(k, L1, cd_tol)
    lib = _library()
    with torch.cuda.device(B_res.device):
        stream = torch.cuda.current_stream(B_res.device).cuda_stream
        err = lib.cd_nnls_shared_launch(
            G_c.data_ptr(), B_work.data_ptr(), X.data_ptr(), k, n,
            float(l1_), float(tol_), float(inv_k_), float(abs_tol_),
            int(bool(nonneg)), int(maxit), float(np.float32(upper_bound)),
            stream)
    if err != 0:
        raise RuntimeError(f"cd_nnls_shared kernel launch failed: CUDA error "
                           f"{err} (k={k}, n={n})")
    cd_nnls_shared.launches += 1
    return X


cd_nnls_shared.launches = 0
