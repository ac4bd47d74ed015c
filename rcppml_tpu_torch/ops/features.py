"""Regularizer / feature application on Gram and RHS matrices.

The port of ``rcppml_tpu/ops/features.py:21-139``, itself the shared
application sequence of the reference (``nmf/variant_helpers.hpp:89-146``).
All of these touch only k x k or k x cols matrices.
"""

from __future__ import annotations

import torch

from ..config import FactorConfig


def _eye(G: torch.Tensor) -> torch.Tensor:
    return torch.eye(G.shape[0], dtype=G.dtype, device=G.device)


def apply_l1_l2(G, B, L1: float, L2: float):
    """features/sparsity.hpp:41-48: G.diag += L2; B -= L1."""
    if L2 > 0:
        G = G + L2 * _eye(G)
    if L1 > 0:
        B = B - L1
    return G, B


def apply_l21(G, factor, lam: float):
    """features/L21.hpp:52-66: G(i,i) += lam / ||row_i||_2 (guarded)."""
    if lam <= 0:
        return G
    row_norm = (factor * factor).sum(dim=1).sqrt()
    add = torch.where(row_norm > 1e-10,
                      lam / torch.clamp_min(row_norm, 1e-10),
                      torch.zeros_like(row_norm))
    return G + torch.diag(add.to(G.dtype))


def apply_graph_reg(G, laplacian, factor, lam: float):
    """features/graph_reg.hpp:46-59: G += lam * F @ L @ F.T (L dense)."""
    if lam <= 0 or laplacian is None:
        return G
    return G + lam * ((factor @ laplacian) @ factor.T)


def apply_target(G, B, fc: FactorConfig, target, target_gram):
    """Target regularization (variant_helpers.hpp:107-145).

    Positive lambda — enrichment: ``G.diag += lam; B += lam * T``.
    Negative lambda — PROJ_ADV batch removal: subtract trace-scaled target
    covariance from G, then eigendecompose and clip eigenvalues.
    """
    lam = fc.target_lambda
    if lam == 0 or target is None and target_gram is None:
        return G, B
    if lam > 0:
        return G + lam * _eye(G), B + lam * target
    # PROJ_ADV: target_gram = T @ T.T / n precomputed (nmf/fit.hpp:250-274)
    trace_G = torch.trace(G)
    trace_GT = torch.trace(target_gram)
    scale = torch.where(trace_GT > 1e-10,
                        trace_G / torch.clamp_min(trace_GT, 1e-10),
                        torch.zeros_like(trace_G))
    G = G - abs(lam) * scale * target_gram
    evals, evecs = torch.linalg.eigh(G)
    # clip RELATIVE to G's scale: the reference's constant 1e-8
    # (variant_helpers.hpp:132) is below fp32 resolution of typical Gram
    # magnitudes and lets the rebuilt G go indefinite
    floor = torch.clamp_min(1e-6 * evals.abs().max(), 1e-8)
    evals = torch.maximum(evals, floor)
    return (evecs * evals[None, :]) @ evecs.T, B


def apply_features(G, B, factor, fc: FactorConfig, *, graph=None,
                   target=None, target_gram=None):
    """The full shared sequence (variant_helpers.hpp:89-146)."""
    G, B = apply_l1_l2(G, B, fc.L1, fc.L2)
    if fc.graph_lambda > 0:
        G = apply_graph_reg(G, graph, factor, fc.graph_lambda)
    G = apply_l21(G, factor, fc.L21)
    if fc.target_lambda != 0:
        G, B = apply_target(G, B, fc, target, target_gram)
    return G, B


def apply_upper_bound(X, upper_bound: float):
    """features/bounds.hpp:38-42."""
    if upper_bound <= 0:
        return X
    return torch.clamp_max(X, upper_bound)


def apply_angular_posthoc(factor, lam: float):
    """Post-NNLS angular decorrelation (features/angular.hpp:95-135).

    Gradient step on the sum of pairwise cosines, then clip to nonneg.
    """
    if lam <= 0:
        return factor
    row_norms = (factor * factor).sum(dim=1).sqrt()
    safe = torch.clamp_min(row_norms, 1e-15)
    F_hat = torch.where(row_norms[:, None] > 1e-15, factor / safe[:, None],
                        factor)
    cos_mat = F_hat @ F_hat.T
    cos_mat = cos_mat - torch.diag(torch.diag(cos_mat))
    grad = (cos_mat @ F_hat) * row_norms[:, None]
    return torch.clamp_min(factor - lam * grad, 0.0)
