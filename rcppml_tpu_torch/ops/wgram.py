"""Fused IRLS weight + per-column weighted Gram + RHS: the CUDA kernel and
its plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::
weighted_gram_rhs_padded`` (body ``_make_wgram_kernel``, wrappers
``weighted_gram_rhs_pallas`` and ``wgram_pad_operands``).  The CUDA source is
``csrc/wgram_rhs.cu`` on kernel 5's tile ``csrc/tri_gram.cuh``: one triangle
of every Gram on the tensor cores in 3xTF32, the reduction over m split
across blocks by :func:`rcppml_tpu_torch.ops.weighted_gram.
plan_weighted_gram` (``fused=True``) and the splits' partials added in the
order of their index (no atomics); where kernel 5 copies w with each stage,
this kernel forms mu = F^T X (float32, c in order), the weight w(A, mu[,
theta]) and w * A for the stage's rows in a prologue, in shared memory and
registers only.  What bounds it on the H100 is arithmetic: 2 m bc (k (k + 1)
/ 2 + 2k) float32 operations (mu, the distinct entries of a symmetric Gram,
and b) against one read of A.  It takes float32 operands and forms
``F[k1] * F[k2] * w`` itself, so there is neither a Khatri-Rao operand nor
any padding of operands: both were needs of the TPU's tiles.

:func:`weighted_gram_rhs` launches the kernel for a CUDA tensor and runs
:func:`weighted_gram_rhs_plain` (the default IRLS path's own arithmetic) for
a CPU tensor; there is no other branch.  ``weighted_gram_rhs.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import Loss, NMFConfig
from . import _build, linalg, losses
from .rhs_tall import H100_SMS, device_sms
from .weighted_gram import fused_mode, plan_weighted_gram, scratch_floats

KERNEL = "wgram_rhs"
LOSS_KINDS = {"kl": 0, "power": 1, "nb": 2}


def _weight_config(loss_kind: str, power: float) -> NMFConfig:
    """A config whose ``compute_irls_weight`` is the kernel's weight."""
    if loss_kind == "kl":
        return NMFConfig(loss=Loss.KL)
    if loss_kind == "nb":
        return NMFConfig(loss=Loss.NB)
    if loss_kind == "power":
        # Gamma (p = 2) and inverse Gaussian (p = 3) are this weight too
        return NMFConfig(loss=Loss.TWEEDIE, tweedie_power=float(power))
    raise ValueError(f"weighted_gram_rhs: loss_kind {loss_kind!r} is not one "
                     f"of {sorted(LOSS_KINDS)}")


def _check(F, X, A, theta_row, theta_col, loss_kind):
    k, m = F.shape
    bc = X.shape[1]
    if X.shape[0] != k or A.shape != (m, bc):
        raise ValueError(f"weighted_gram_rhs: F {tuple(F.shape)}, X "
                         f"{tuple(X.shape)} and A {tuple(A.shape)} do not "
                         "fit together")
    if theta_row is not None and theta_col is not None:
        raise ValueError("weighted_gram_rhs: give theta_row or theta_col, "
                         "not both")
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"weighted_gram_rhs: loss_kind {loss_kind!r} is not "
                         f"one of {sorted(LOSS_KINDS)}")
    if loss_kind == "nb" and theta_row is None and theta_col is None:
        raise ValueError("weighted_gram_rhs: loss_kind 'nb' needs theta_row "
                         "or theta_col")
    for name, t, shape in (("F", F, None), ("X", X, None), ("A", A, None),
                           ("theta_row", theta_row, (m,)),
                           ("theta_col", theta_col, (bc,))):
        if t is None:
            continue
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"weighted_gram_rhs: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"weighted_gram_rhs: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"weighted_gram_rhs: {name} is on {t.device}, "
                             f"A on {A.device}")


def weighted_gram_rhs_plain(F, X, A, theta_row=None, theta_col=None, *,
                            loss_kind: str, power: float = 0.0,
                            sparse_zeros: bool = False, KR=None):
    """Plain twin: ``losses.compute_irls_weight`` followed by
    ``linalg.weighted_gram_and_rhs``, the default IRLS path's arithmetic.

    F (k, m), X (k, bc), A (m, bc) -> (Gb (bc, k, k), b (k, bc)).  ``KR``: an
    optional precomputed ``linalg.kr_product(F)``, as the default path
    builds once per solve; it changes no value.
    """
    cfg = _weight_config(loss_kind, power)
    mu = F.T @ X                                              # (m, bc)
    theta = losses._expand_theta(theta_row, theta_col, A)
    w = losses.compute_irls_weight(A, mu, cfg, theta)
    if sparse_zeros:
        w = torch.where(A != 0, w, torch.ones_like(w))
    return linalg.weighted_gram_and_rhs(F, w, A, KR=KR)


def plan_wgram(k: int, m: int, bc: int,
               sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """The launch of a (k, m, bc) call: ``(mode, wc, splits, chunk)``, the
    tile's plan (:func:`plan_weighted_gram` with ``fused=True``) and how F
    is read for mu (:func:`fused_mode`: staged with the stage, or from
    device memory where its k rows do not fit)."""
    wc, splits, chunk = plan_weighted_gram(k, m, bc, sms, fused=True)
    return fused_mode(k, wc), wc, splits, chunk


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.wgram_rhs_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def weighted_gram_rhs(F, X, A, theta_row=None, theta_col=None, *,
                      loss_kind: str, power: float = 0.0,
                      sparse_zeros: bool = False):
    """Fused weight + weighted Gram + RHS: F (k, m), X (k, bc), A (m, bc),
    optional theta per row (m,) or per column (bc,) -> (Gb (bc, k, k),
    b (k, bc)), float32.

    ``loss_kind``: ``"kl"``, ``"power"`` (exponent ``power``) or ``"nb"``
    (needs a theta).  Weights are capped at ``losses._W_CAP``.  On a CUDA
    tensor this launches the kernel (:func:`plan_wgram`; it raises if the
    launch fails); on a CPU tensor it runs :func:`weighted_gram_rhs_plain`.
    """
    _check(F, X, A, theta_row, theta_col, loss_kind)
    if not A.is_cuda:
        return weighted_gram_rhs_plain(
            F, X, A, theta_row, theta_col, loss_kind=loss_kind, power=power,
            sparse_zeros=sparse_zeros)
    k, m = F.shape
    bc = X.shape[1]
    Gb = torch.empty((bc, k, k), dtype=torch.float32, device=A.device)
    b = torch.empty((k, bc), dtype=torch.float32, device=A.device)
    if bc == 0 or k == 0:
        return Gb, b
    if m == 0:
        return Gb.zero_(), b.zero_()
    mode, wc, splits, chunk = plan_wgram(k, m, bc, device_sms(A.device))
    n_scratch = scratch_floats(k, bc, splits)
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=A.device) if n_scratch else None
    F_c, X_c, A_c = F.contiguous(), X.contiguous(), A.contiguous()
    theta = theta_row if theta_row is not None else theta_col
    theta_mode = 1 if theta_row is not None else 2 if theta_col is not None \
        else 0
    theta_c = theta.contiguous() if theta is not None else None
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.wgram_rhs_launch(
            F_c.data_ptr(), X_c.data_ptr(), A_c.data_ptr(),
            theta_c.data_ptr() if theta_c is not None else None,
            Gb.data_ptr(), b.data_ptr(), k, m, bc, LOSS_KINDS[loss_kind],
            float(np.float32(power)), int(bool(sparse_zeros)), theta_mode,
            float(np.float32(losses._W_CAP)), mode, wc, splits, chunk,
            scratch.data_ptr() if scratch is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"weighted_gram_rhs kernel launch failed: CUDA "
                           f"error {err} (k={k}, m={m}, bc={bc}, "
                           f"loss_kind={loss_kind!r}, plan "
                           f"{(mode, wc, splits, chunk)})")
    weighted_gram_rhs.launches += 1
    return Gb, b


weighted_gram_rhs.launches = 0
