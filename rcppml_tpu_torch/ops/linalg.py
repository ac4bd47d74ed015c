"""Core linear-algebra primitives of the ALS loop.

The port of ``rcppml_tpu/ops/linalg.py:35-90``:

  * :func:`gram` — ``G = F @ F.T`` plus the reference's ``TINY_NUM``
    diagonal guard (gram.hpp:30-62);
  * :func:`rhs` — ``B = F @ A`` (rhs.hpp);
  * :func:`extract_scaling` — row-norm extraction into d
    (nmf/variant_helpers.hpp:287-305);
  * :func:`gram_trick_loss` and :func:`mse_loss_from_saved` — the O(k^2)
    Frobenius loss (nmf/fit_cpu.hpp:17-20, 1710-1753).

These are plain large products outside any TPU kernel, so they go to
``torch.matmul``.  Float32 products run in full float32 once
:func:`rcppml_tpu_torch.device.set_fp32_precision` has been called, as every
fit does.  The bf16 branch of ``rhs`` waits for ``bf16_data``.
"""

from __future__ import annotations

import torch

from .. import constants
from ..config import Norm


def gram(F: torch.Tensor) -> torch.Tensor:
    """G = F @ F.T with the reference's +1e-15 diagonal guard (gram.hpp:30-62)."""
    G = F @ F.T
    G.diagonal().add_(constants.TINY_NUM)     # in place: G is a fresh tensor
    return G


def rhs(F: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """B = F @ A (k x n), the product that reads A (primitives/cpu/rhs.hpp)."""
    return F @ A


def extract_scaling(X: torch.Tensor, norm: Norm):
    """d = row norms of X (+1e-15), X normalized (variant_helpers.hpp:287-305).

    Returns (X_normalized, d).
    """
    if norm == Norm.NONE:
        return X, torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    if norm == Norm.L1:
        d = X.abs().sum(dim=1)
    else:
        d = (X * X).sum(dim=1).sqrt()
    d = d + constants.TINY_NUM
    return X / d[:, None], d


def gram_trick_loss(trAtA, G: torch.Tensor, B: torch.Tensor, H: torch.Tensor):
    """SSE via the Gram trick: ||A - F.T H||^2 = tr(A'A) - 2 tr(B'H) + tr(G HH')
    where B = F @ A and G = F @ F.T (nmf/fit_cpu.hpp:17-20)."""
    cross = (B * H).sum()
    recon = (G * (H @ H.T)).sum()
    return trAtA - 2.0 * cross + recon


def mse_loss_from_saved(trAtA, W_T, d, B_w, G_w):
    """Per-iteration MSE (SSE) reusing the W-update's matrices
    (fit_cpu.hpp:1710-1753):

      cross = sum_i d_i * <W_T[i, :], B_w[i, :]>      with B_w = H @ A.T
      recon = sum_ij d_i d_j gram(W_T)_ij * G_w_ij    with G_w = gram(H)
      loss  = tr(A'A) - 2*cross + recon
    """
    G_wt = gram(W_T)
    cross = (d[:, None] * W_T * B_w).sum()
    recon = ((d[:, None] * d[None, :]) * G_wt * G_w).sum()
    return trAtA - 2.0 * cross + recon
