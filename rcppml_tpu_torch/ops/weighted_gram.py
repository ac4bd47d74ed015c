"""Per-column weighted Gram + RHS from given weights: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_experiments.py::
weighted_gram_pallas``.  The CUDA source is ``csrc/weighted_gram.cu`` (with
``csrc/wgram_tile.cuh``, shared with the fused IRLS kernel): per column j of
a block, ``G_j = F diag(w_j) F^T`` and ``b_j = F (w_j * a_j)``, each entry
summed over m by one thread in a fixed order (no atomics), both triangles of
every Gram written.  The (bc, k, m) intermediate ``F * w_j`` of the plain
version never exists.  What bounds it on the H100 is float32 arithmetic
outside the tensor cores: 2 m bc (k (k + 1) / 2 + k) operations against one
read of w and A.

:func:`weighted_gram` launches the kernel for a CUDA tensor and runs
:func:`weighted_gram_plain` for a CPU tensor; there is no other branch.
``weighted_gram.launches`` counts the kernel's launches.  The port reaches it
from :func:`rcppml_tpu_torch.ops.linalg.weighted_gram_and_rhs` when the
Khatri-Rao operand does not fit its budget (large k times m): the masked MSE
solves and the IRLS solves both go through that function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "weighted_gram"


def weighted_gram_plain(F: torch.Tensor, w: torch.Tensor, A_blk: torch.Tensor):
    """Plain twin: the blocked batched product ``(F * w_j) F^T`` and
    ``F (w * A)``.  F (k, m), w (m, bc), A_blk (m, bc) -> (Gb (bc, k, k),
    b (k, bc)).  Holds a (bc, k, m) intermediate."""
    Fw = F[None, :, :] * w.T[:, None, :]                  # (bc, k, m)
    Gb = Fw @ F.T
    b = F @ (w * A_blk)
    return Gb, b


def _check(F, w, A_blk):
    if F.ndim != 2 or w.ndim != 2 or w.shape[0] != F.shape[1] \
            or A_blk.shape != w.shape:
        raise ValueError(f"weighted_gram: F {tuple(F.shape)}, w "
                         f"{tuple(w.shape)} and A {tuple(A_blk.shape)} do not "
                         "fit together")
    for name, t in (("F", F), ("w", w), ("A", A_blk)):
        if t.dtype != torch.float32:
            raise TypeError(f"weighted_gram: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != F.device:
            raise ValueError(f"weighted_gram: {name} is on {t.device}, "
                             f"F on {F.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.weighted_gram_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: unit column stride, any row stride (a
    block of columns of a wider row-major matrix is read in place)."""
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return t
    return t.contiguous()


def weighted_gram(F: torch.Tensor, w: torch.Tensor, A_blk: torch.Tensor):
    """Per-column weighted Gram + RHS: F (k, m), w (m, bc), A_blk (m, bc) ->
    (Gb (bc, k, k), b (k, bc)), float32, any k, m and bc.

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`weighted_gram_plain`.
    """
    _check(F, w, A_blk)
    if not F.is_cuda:
        return weighted_gram_plain(F, w, A_blk)
    k, m = F.shape
    bc = w.shape[1]
    Gb = torch.empty((bc, k, k), dtype=torch.float32, device=F.device)
    b = torch.empty((k, bc), dtype=torch.float32, device=F.device)
    if bc == 0 or k == 0:
        return Gb, b
    if m == 0:
        return Gb.zero_(), b.zero_()
    F_c, w_r, A_r = F.contiguous(), _rows(w), _rows(A_blk)
    lib = _library()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.weighted_gram_launch(
            F_c.data_ptr(), w_r.data_ptr(), A_r.data_ptr(), Gb.data_ptr(),
            b.data_ptr(), k, m, bc, w_r.stride(0), A_r.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"weighted_gram kernel launch failed: CUDA error "
                           f"{err} (k={k}, m={m}, bc={bc})")
    weighted_gram.launches += 1
    return Gb, b


weighted_gram.launches = 0
