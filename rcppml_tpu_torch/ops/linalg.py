"""Core linear-algebra primitives of the ALS loop.

The port of ``rcppml_tpu/ops/linalg.py:35-206``:

  * :func:`gram` — ``G = F @ F.T`` plus the reference's ``TINY_NUM``
    diagonal guard (gram.hpp:30-62);
  * :func:`rhs` — ``B = F @ A`` (rhs.hpp);
  * :func:`extract_scaling` — row-norm extraction into d
    (nmf/variant_helpers.hpp:287-305);
  * :func:`gram_trick_loss` and :func:`mse_loss_from_saved` — the O(k^2)
    Frobenius loss (nmf/fit_cpu.hpp:17-20, 1710-1753);
  * :func:`kr_product` and :func:`weighted_gram_and_rhs` — the per-column
    weighted Gram and RHS of the IRLS and masked solves
    (nnls_batch_irls.hpp:459-516);
  * :func:`gathered_gram_downdate` — the per-column Gram downdate from
    gathered excluded rows (cv_detail.hpp:67-84).

These are plain large products outside any TPU kernel, so they go to
``torch.matmul``; the one exception is the blocked branch of
:func:`weighted_gram_and_rhs`, which is :mod:`.weighted_gram`'s kernel.
Float32 products run in full float32 once
:func:`rcppml_tpu_torch.device.set_fp32_precision` has been called, as every
fit does.  With a bfloat16 A (``bf16_data``) ``rhs`` needs bfloat16 operands
and a float32 sum, which ``torch.matmul`` does not give in one call; it goes
through :mod:`.rhs_tall`, whose kernels read the bfloat16 A once.
"""

from __future__ import annotations

import torch

from .. import constants
from ..config import Norm
from ..parallel.mesh import NO_AXIS
from .rhs_tall import rhs_tall, rhs_tall_t
from .weighted_gram import weighted_gram


def gram(F: torch.Tensor, axis=NO_AXIS) -> torch.Tensor:
    """G = F @ F.T with the reference's +1e-15 diagonal guard (gram.hpp:30-62).
    ``axis``: the mesh axis F's columns are split over; the product is
    summed over it before the guard is added once."""
    G = axis.sum(F @ F.T)
    G.diagonal().add_(constants.TINY_NUM)     # in place: G is a fresh tensor
    return G


def rhs(F: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """B = F @ A (k x n), the product that reads A (primitives/cpu/rhs.hpp).

    When A is stored as bfloat16 (the opt-in ``bf16_data`` path) the small
    operand is rounded to bfloat16 too and the sum is float32, as
    ``rcppml_tpu/ops/linalg.py::rhs`` does.  ``A`` is then either contiguous
    or the transposed view of a contiguous matrix (the W update's ``A.T``),
    which is read as it lies."""
    if A.dtype == torch.bfloat16:
        if not A.is_contiguous() and A.T.is_contiguous():
            return rhs_tall_t(F, A.T)
        return rhs_tall(F, A.contiguous())
    return F @ A


def extract_scaling(X: torch.Tensor, norm: Norm, axis=NO_AXIS):
    """d = row norms of X (+1e-15), X normalized (variant_helpers.hpp:287-305).
    ``axis``: the mesh axis X's columns are split over; the row sums are
    summed over it before the root and the division, so that d is the same
    on every rank.

    Returns (X_normalized, d).
    """
    if norm == Norm.NONE:
        return X, torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    if norm == Norm.L1:
        d = axis.sum(X.abs().sum(dim=1))
    else:
        d = axis.sum((X * X).sum(dim=1)).sqrt()
    d = d + constants.TINY_NUM
    return X / d[:, None], d


def gram_trick_loss(trAtA, G: torch.Tensor, B: torch.Tensor, H: torch.Tensor,
                    axis=NO_AXIS):
    """SSE via the Gram trick: ||A - F.T H||^2 = tr(A'A) - 2 tr(B'H) + tr(G HH')
    where B = F @ A and G = F @ F.T (nmf/fit_cpu.hpp:17-20).  ``axis``: the
    mesh axis B's and H's columns are split over."""
    cross = axis.sum((B * H).sum())
    recon = (G * axis.sum(H @ H.T)).sum()
    return trAtA - 2.0 * cross + recon


def mse_loss_from_saved(trAtA, W_T, d, B_w, G_w, axis=NO_AXIS):
    """Per-iteration MSE (SSE) reusing the W-update's matrices
    (fit_cpu.hpp:1710-1753):

      cross = sum_i d_i * <W_T[i, :], B_w[i, :]>      with B_w = H @ A.T
      recon = sum_ij d_i d_j gram(W_T)_ij * G_w_ij    with G_w = gram(H)
      loss  = tr(A'A) - 2*cross + recon

    ``axis``: the mesh axis W_T's and B_w's columns are split over.
    """
    G_wt = gram(W_T, axis)
    cross = axis.sum((d[:, None] * W_T * B_w).sum())
    recon = ((d[:, None] * d[None, :]) * G_wt * G_w).sum()
    return trAtA - 2.0 * cross + recon


# Khatri-Rao operand budget (floats): beyond k^2 * m of this size the
# blocked per-column product runs instead (k=200, m=1e6 would need 4e10 floats)
KR_BUDGET_FLOATS = 1.5e8


def kr_product(F: torch.Tensor) -> torch.Tensor:
    """Row-wise Khatri-Rao self-product (k^2, m), float32.

    ``KR[k1*k + k2, r] = F[k1, r] * F[k2, r]`` turns the per-column weighted
    Gram batch ``G_j = F diag(w_j) F^T`` into one dense product
    ``KR @ w -> (k^2, n)``.  The JAX package rounds this operand to bfloat16
    on the TPU; the port keeps float32 on every device (there is no bf16
    ``kr_product`` here yet), which is the JAX package's ``precise`` branch.
    """
    k, m = F.shape
    return (F[:, None, :] * F[None, :, :]).reshape(k * k, m)


def weighted_gram_and_rhs(F: torch.Tensor, w: torch.Tensor,
                          A_blk: torch.Tensor,
                          KR: torch.Tensor | None = None):
    """Per-column weighted Gram + RHS: G_j = F diag(w_j) F^T, b_j = F (w_j*a_j).

    F (k, m), w (m, bc), A_blk (m, bc) -> (Gb (bc, k, k), b (k, bc)), all
    float32 with float32 accumulation on every device.

    ``KR``: an optional precomputed :func:`kr_product` of F; a caller that
    solves many column blocks against one F builds it once.  While the KR
    operand fits ``KR_BUDGET_FLOATS`` the Gram batch is one large product
    ``KR @ w``; beyond it :func:`rcppml_tpu_torch.ops.weighted_gram.
    weighted_gram` runs: its kernel on a CUDA tensor, and on a CPU tensor the
    blocked batched product ``(F * w_j) F^T``, which holds a (bc, k, m)
    intermediate that the caller's block size has to allow for.
    """
    k, m = F.shape
    if KR is None and k * k * m <= KR_BUDGET_FLOATS:
        KR = kr_product(F)
    if KR is None:
        return weighted_gram(F, w, A_blk)
    G_flat = KR @ w                                           # (k^2, bc)
    Gb = G_flat.reshape(k, k, -1).permute(2, 0, 1).contiguous()
    b = F @ (w * A_blk)
    return Gb, b


def gathered_gram_downdate(F: torch.Tensor, idx: torch.Tensor,
                           val: torch.Tensor) -> torch.Tensor:
    """Per-column Gram downdate from gathered excluded rows.

    For 0/1 train masks the per-column Gram is ``G_j = G_full - sum over the
    excluded rows r of column j of F[:, r] F[:, r]^T``, the reference's
    per-column rank update (cv_detail.hpp:67-84).  With T = the most excluded
    rows of any column << m this costs k^2 T n operations instead of the
    weighted path's k^2 m n.

    F (k, m), idx (T, bc) integer row indices, val (T, bc) 0/1 validity
    (padding slots carry val 0 and any index).  Returns (bc, k, k), the term
    to subtract from the full Gram; float32 on every device.
    """
    Fg = F[:, idx]                                    # (k, T, bc)
    Fgv = Fg * val[None, :, :]
    return torch.einsum("itc,ltc->cil", Fgv, Fg)
