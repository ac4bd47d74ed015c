"""NNLS solvers over a whole column batch with one shared Gram.

The port of ``rcppml_tpu/ops/solvers.py:32-183``:

  * :func:`cholesky_clip_batch` — unconstrained Cholesky solve, then clip
    (primitives/cpu/cholesky_clip.hpp:129-164).  No TPU kernel stood here:
    it maps to ``torch.linalg.cholesky`` + ``torch.cholesky_solve``.
  * :func:`cd_nnls_batch` / :func:`cd_nnls_batch_traced` — coordinate-descent
    NNLS (primitives/cpu/nnls_batch.hpp:71-225) through
    :func:`rcppml_tpu_torch.ops.cd_nnls.cd_nnls_shared`: the CUDA kernel for
    a CUDA tensor, its plain twin for a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import constants
from .cd_nnls import cd_nnls_shared


def _chol_solve(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve G X = B via Cholesky (G symmetric positive definite, k x k).

    A trace-relative ridge (1e-6 / k * tr(G)) keeps the fp32 factorization
    finite when G is numerically rank-deficient.
    """
    k = G.shape[0]
    ridge = (1e-6 / k) * torch.trace(G)
    L = torch.linalg.cholesky(
        G + ridge * torch.eye(k, dtype=G.dtype, device=G.device))
    return torch.cholesky_solve(B, L)


def cholesky_clip_batch(G: torch.Tensor, B: torch.Tensor, *,
                        nonneg: bool = True,
                        upper_bound: float = 0.0) -> torch.Tensor:
    """Solve G X = B for all columns, then clip (cholesky_clip.hpp:129-164).

    B must already carry L1 (subtracted) and G must carry L2: features are
    applied upstream, as in the reference (features/sparsity.hpp:41-48).
    """
    X = _chol_solve(G, B)
    if nonneg:
        X = torch.clamp_min(X, 0.0)
    if upper_bound > 0:
        X = torch.clamp_max(X, upper_bound)
    return X


def _eff_cd_tol(cd_tol: float, dtype: torch.dtype) -> float:
    """fp32-aware per-sweep exit threshold (constants.CD_TOL_F32_FLOOR)."""
    if cd_tol > 0 and dtype == torch.float32:
        return max(float(cd_tol), constants.CD_TOL_F32_FLOOR)
    return cd_tol


def cd_nnls_batch(G: torch.Tensor, B: torch.Tensor,
                  X: torch.Tensor | None = None, *, L1: float = 0.0,
                  nonneg: bool = True, maxit: int = constants.CD_MAXIT,
                  cd_tol: float = constants.CD_TOL, upper_bound: float = 0.0,
                  warm_start: bool = False) -> torch.Tensor:
    """Batched CD NNLS: solve G x = b per column with x >= 0.

    With ``warm_start`` the incoming B is converted to residual form
    ``B - G @ X``; otherwise the solve starts from X = 0.  ``L1`` is
    subtracted from each coordinate's step (fused_nnls.hpp:117); the standard
    fit applies L1 to B upstream and passes L1=0.
    """
    if X is None or not warm_start:
        X0 = torch.zeros_like(B)
        B_res = B
    else:
        X0 = X
        B_res = B - G @ X
    return cd_nnls_batch_traced(G, B_res, X0, L1, nonneg=nonneg, maxit=maxit,
                                cd_tol=cd_tol, upper_bound=upper_bound)


def cd_nnls_batch_traced(G, B_res, X0, L1, *, nonneg: bool, maxit: int,
                         cd_tol: float, upper_bound: float = 0.0):
    """CD NNLS with ``B_res`` already in residual form relative to ``X0``.

    The name follows the JAX package, where this variant runs inside a
    traced fit loop.  A CUDA tensor goes to the kernel and a CPU tensor to
    the plain twin, inside :func:`cd_nnls_shared`; there is no other branch.
    """
    return cd_nnls_shared(G, B_res, X0, float(L1),
                          _eff_cd_tol(cd_tol, B_res.dtype), nonneg=nonneg,
                          maxit=maxit, upper_bound=upper_bound)
