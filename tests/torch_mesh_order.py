"""A one-device fit with its sums made in a mesh's order.

A sharded fit adds each sum's block partials in rank order
(``rcppml_tpu_torch.parallel.mesh._reduce``).  Float32 addition is not
associative, so its bits part from the one-device fit's, which forms the
same sums in one product; where a fit turns a last-bit difference into a
large one (a ``bf16_data`` factor rounded to another bfloat16 value, an IRLS
column frozen one inner iteration earlier) the two part by more than the
bars a sharded fit is held to.  :func:`mesh_order_fit` is the reference for
such fits: the one-device loop (``models.nmf.fit_mse``,
``models.nmf_irls.fit_irls``; no ``ShardContext``, no collective) with the
primitives that feed the next iteration replaced while it runs, so that each
forms its sum from the ranks' blocks at their shapes and adds them in rank
order, and each solve runs on one rank's columns (a kernel's plan, and with
it its rounding, follows the width).

Used by ``tests/test_torch_parallel.py`` on the CPU and by ``chip_smoke.py``
on the card.  Imports ``rcppml_tpu_torch`` and never JAX.
"""

import numpy as np
import torch

from rcppml_tpu_torch import constants
from rcppml_tpu_torch.config import Norm, NMFConfig
from rcppml_tpu_torch.models import nmf as nmf_mod
from rcppml_tpu_torch.models import nmf_irls
from rcppml_tpu_torch.ops import linalg


def _fold(parts):
    """The parts added in order: ((p0 + p1) + p2) + ..."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _fresh(X):
    """A fresh copy of a block, laid out as a rank holds it: row-major, or
    column-major where the whole is (a LAPACK solve's output on the CPU, or
    the W side's ``A.T``).  The layout of a product's operand selects its
    kernel, and with it the rounding."""
    if X.dim() == 2 and not X.is_contiguous() and X.T.is_contiguous():
        return X.T.clone().T
    if X.dim() == 2 and X.stride(0) == 1 and X.shape[0] > 1:
        return X.T.contiguous().T
    return X.clone(memory_format=torch.contiguous_format)


def _join(blocks):
    """The blocks side by side, column-major where they are."""
    if all(b.stride(0) == 1 and b.shape[0] > 1 and not b.is_contiguous()
           for b in blocks):
        return torch.cat([b.T for b in blocks], dim=0).T
    return torch.cat(blocks, dim=1)


def mesh_order_fit(A: torch.Tensor, cfg: NMFConfig, shape):
    """The one-device fit of ``cfg`` on ``A`` ((m, n), on its device) with
    the sums and solves of a ``shape`` = (rows, cols) mesh: A and the
    starting factors zero-padded as the mesh pads them (the IRLS loss on
    the true (m, n): ``valid_dims``), the Grams,
    right-hand sides, per-column weighted Grams and row norms formed from
    the blocks and added in rank order, each solve on a block's columns.
    Covers the MSE loop and the IRLS loop (no CV or mask); the padded
    dimensions must differ, since a block's cut is told by its width.
    Returns the result cut back to (m, n)."""
    m, n = A.shape
    r, c = shape
    mb, nb = -(-m // r), -(-n // c)
    M, N = mb * r, nb * c
    if M == N:
        raise ValueError("mesh_order_fit tells the cuts apart by width: "
                         f"padded {M} x {N}")

    def cuts(width):
        size = {M: mb, N: nb}[width]
        return [slice(lo, lo + size) for lo in range(0, width, size)]

    orig = (linalg.gram, linalg.rhs, linalg.extract_scaling,
            linalg.weighted_gram_and_rhs, nmf_mod._solve,
            nmf_irls.irls_solve_batch)
    _, rhs0, scaling0, wg0, solve0, irls0 = orig

    def gram(F, axis=None):
        parts = [_fresh(F[:, s]) for s in cuts(F.shape[1])]
        G = _fold([P @ P.T for P in parts])
        G.diagonal().add_(constants.TINY_NUM)
        return G

    def rhs(F, X):
        return torch.cat([_fold([rhs0(_fresh(F[:, a]), _fresh(X[a, b]))
                                 for a in cuts(X.shape[0])])
                          for b in cuts(X.shape[1])], dim=1)

    def extract_scaling(X, norm, axis=None):
        if norm == Norm.NONE:
            return scaling0(X, norm)
        parts = [_fresh(X[:, s]) for s in cuts(X.shape[1])]
        if norm == Norm.L1:
            d = _fold([p.abs().sum(dim=1) for p in parts])
        else:
            d = _fold([(p * p).sum(dim=1) for p in parts]).sqrt()
        d = d + constants.TINY_NUM
        return X / d[:, None], d

    def weighted_gram_and_rhs(F, w, A_blk, KR=None):
        parts = [wg0(_fresh(F[:, s]), _fresh(w[s]), _fresh(A_blk[s]),
                     KR=None if KR is None else _fresh(KR[:, s]))
                 for s in cuts(F.shape[1])]
        return _fold([p[0] for p in parts]), _fold([p[1] for p in parts])

    def solve(cfg_, G, B, X_warm, fc, it):
        return _join([solve0(cfg_, G, _fresh(B[:, s]), _fresh(X_warm[:, s]),
                             fc, it) for s in cuts(B.shape[1])])

    def irls_solve_batch(A_data, F, cfg_, loss, theta_row, theta_col, fc,
                         sparse_zeros, extra_w=None, X_warm=None, G_add=None,
                         target=None, counts=None, **kw):
        def cut(X, s):
            return None if X is None else X[..., s]
        return _join([irls0(
            _fresh(A_data[:, s]), F, cfg_, loss, theta_row,
            cut(theta_col, s), fc, sparse_zeros, extra_w=cut(extra_w, s),
            X_warm=cut(X_warm, s), G_add=G_add, target=cut(target, s),
            counts=counts, **kw) for s in cuts(A_data.shape[1])])

    W_T0, H0, d0 = nmf_mod.init_factors(cfg, m, n)
    W_T0 = np.pad(W_T0, ((0, 0), (0, M - m)))
    H0 = np.pad(H0, ((0, 0), (0, N - n)))
    A_pad = torch.nn.functional.pad(A, (0, N - n, 0, M - m))
    (linalg.gram, linalg.rhs, linalg.extract_scaling,
     linalg.weighted_gram_and_rhs, nmf_mod._solve,
     nmf_irls.irls_solve_batch) = (gram, rhs, extract_scaling,
                                   weighted_gram_and_rhs, solve,
                                   irls_solve_batch)
    try:
        if cfg.requires_irls():
            res = nmf_irls.fit_irls(A_pad, cfg, W_T0, H0, d0, {},
                                    valid_dims=(m, n))
        else:
            state = nmf_mod.init_fit_state(cfg, W_T0, H0, d0,
                                           device=A.device)
            state = nmf_mod.fit_mse(cfg, A_pad, state, {})
            res = nmf_mod.finalize_result(cfg, state)
    finally:
        (linalg.gram, linalg.rhs, linalg.extract_scaling,
         linalg.weighted_gram_and_rhs, nmf_mod._solve,
         nmf_irls.irls_solve_batch) = orig
    res.W, res.H = res.W[:m], res.H[:, :n]
    return res
