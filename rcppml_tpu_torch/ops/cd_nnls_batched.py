"""Coordinate-descent NNLS with one Gram per column: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::
cd_nnls_pallas_batched`` (body ``_make_cd_kernel(batched=True)``).  The CUDA
source is ``csrc/cd_nnls_batched.cu``: one thread per column, which leaves
its loop when its column freezes.  What bounds it on the H100 is the Gram
traffic, n * k * k floats read again by every sweep: the wrapper transposes
the batch once to (k, k, n) so that a warp reads neighbouring floats (that
copy is part of the kernel's measured time), and the kernel streams it from
L2 or device memory.

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
from .cd_nnls import _scalars

KERNEL = "cd_nnls_batched"


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
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
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
    X = X0.clone(memory_format=torch.contiguous_format)  # solved in place
    if n == 0 or maxit <= 0:
        return X
    # (n, k, k) -> (k, k, n): neighbouring threads, neighbouring addresses
    Gt = Gb.permute(1, 2, 0).contiguous()
    B_work = B_res.clone(memory_format=torch.contiguous_format)
    l1_, tol_, inv_k_, abs_tol_ = _scalars(k, L1, cd_tol)
    lib = _library()
    with torch.cuda.device(B_res.device):
        stream = torch.cuda.current_stream(B_res.device).cuda_stream
        err = lib.cd_nnls_batched_launch(
            Gt.data_ptr(), B_work.data_ptr(), X.data_ptr(), k, n,
            float(l1_), float(tol_), float(inv_k_), float(abs_tol_),
            int(bool(nonneg)), int(maxit), float(np.float32(upper_bound)),
            stream)
    if err != 0:
        raise RuntimeError(f"cd_nnls_batched kernel launch failed: CUDA error "
                           f"{err} (k={k}, n={n})")
    cd_nnls_batched.launches += 1
    return X


cd_nnls_batched.launches = 0
