"""NNLS solvers over a whole column batch, with one shared Gram or with one
Gram per column.

The port of ``rcppml_tpu/ops/solvers.py:32-330``:

  * :func:`cholesky_clip_batch` — unconstrained Cholesky solve, then clip
    (primitives/cpu/cholesky_clip.hpp:129-164).  A CUDA tensor goes through
    :func:`rcppml_tpu_torch.ops.cholesky_clip.cholesky_clip` (one launch for
    factorization, substitutions and clip, no host read); a CPU tensor to
    ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``, or to kernel 6's
    twin where LAPACK finds the Gram not positive definite.
  * :func:`cd_nnls_batch` / :func:`cd_nnls_batch_traced` — coordinate-descent
    NNLS (primitives/cpu/nnls_batch.hpp:71-225) through
    :func:`rcppml_tpu_torch.ops.cd_nnls.cd_nnls_shared`: the CUDA kernel for
    a CUDA tensor, its plain twin for a CPU tensor.
  * :func:`batched_gram_matvec`, :func:`batched_spd_solve`,
    :func:`cholesky_clip_batched_gram`, :func:`cd_nnls_batched_gram` — the
    per-column-Gram variants behind the IRLS weighted solves and the masked
    and cross-validated MSE solves.  The CD variant goes through
    :func:`rcppml_tpu_torch.ops.cd_nnls_batched.cd_nnls_batched`.
"""

from __future__ import annotations

import torch

from .. import constants
from .cd_nnls import cd_nnls_shared
from .cd_nnls_batched import cd_nnls_batched
from .cholesky_clip import cholesky_clip, cholesky_clip_plain


def _ridged(G: torch.Tensor) -> torch.Tensor:
    """G plus a trace-relative ridge (1e-6 / k * tr(G)), which keeps the fp32
    factorization finite when G is numerically rank-deficient."""
    k = G.shape[0]
    ridge = (1e-6 / k) * torch.trace(G)
    return G + ridge * torch.eye(k, dtype=G.dtype, device=G.device)


def _chol_solve(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve G X = B via Cholesky on the CPU, with the ridge of
    :func:`_ridged`.

    Where LAPACK factors the ridged Gram, ``cholesky_solve``.  Where it finds
    it not positive definite (rounding can leave a rank-deficient fp32 Gram a
    pivot at or below zero even with the ridge), the call is solved by kernel
    6's algorithm (:func:`cholesky_clip_plain`, unclipped), which is what the
    card computes for every Gram: it never raises.
    """
    Gr = _ridged(G)
    L, info = torch.linalg.cholesky_ex(Gr)
    if int(info) == 0:
        return torch.cholesky_solve(B, L)
    return cholesky_clip_plain(Gr, B, nonneg=False)


def cholesky_clip_batch(G: torch.Tensor, B: torch.Tensor, *,
                        nonneg: bool = True,
                        upper_bound: float = 0.0) -> torch.Tensor:
    """Solve G X = B for all columns, then clip (cholesky_clip.hpp:129-164).

    B must already carry L1 (subtracted) and G must carry L2: features are
    applied upstream, as in the reference (features/sparsity.hpp:41-48).
    The trace-relative ridge is added here on every device.  A CUDA tensor
    then takes one launch of :func:`cholesky_clip`, which replaces a pivot
    that is not positive where ``torch.linalg.cholesky`` raises; a CPU tensor
    takes :func:`_chol_solve`, which never raises either.
    """
    if B.is_cuda:
        return cholesky_clip(_ridged(G), B, nonneg=nonneg,
                             upper_bound=upper_bound)
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


# ---------------------------------------------------------------------------
# Per-column-Gram variants (IRLS weighted solves, CV Gram downdates)
# ---------------------------------------------------------------------------

def batched_gram_matvec(Gb: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """y_j = G_j @ x_j for Gb (n, k, k), X (k, n) -> (k, n), contiguous."""
    return torch.einsum("jkl,lj->kj", Gb, X).contiguous()


def batched_spd_solve(Gb: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve: Gb (n, k, k), B (k, n) -> X (k, n).

    The JAX package's Cholesky-Crout factorization as written there: k steps,
    every operation over the whole batch, then forward and back substitution.
    The pivots are floored at 1e-30 instead of raising, so a singular column
    gives a finite garbage solution rather than an error, as there.
    """
    n, k, _ = Gb.shape
    G = Gb.permute(1, 2, 0)                            # (k, k, n) view
    L = torch.zeros((k, k, n), dtype=Gb.dtype, device=Gb.device)
    below = torch.arange(k, device=Gb.device)

    for j in range(k):
        row_j = L[j]                                   # (k, n)
        sum_sq = (row_j * row_j).sum(dim=0)            # (n,)
        l_jj = torch.sqrt(torch.clamp_min(G[j, j] - sum_sq, 1e-30))
        # column j below the diagonal: L_ij = (g_ij - <L_i., L_j.>) / l_jj
        dots = (L * row_j[None, :, :]).sum(dim=1)      # (k, n)
        col = (G[:, j] - dots) / l_jj[None, :]
        col = torch.where((below > j)[:, None], col, torch.zeros_like(col))
        col[j] = l_jj
        L[:, j] = col                                  # in place: L is ours

    Y = torch.zeros((k, n), dtype=Gb.dtype, device=Gb.device)
    for i in range(k):                                 # L y = b
        acc = (L[i] * Y).sum(dim=0)
        Y[i] = (B[i] - acc) / torch.clamp_min(L[i, i], 1e-30)
    X = torch.zeros((k, n), dtype=Gb.dtype, device=Gb.device)
    for i in range(k - 1, -1, -1):                     # L^T x = y
        acc = (L[:, i] * X).sum(dim=0)
        X[i] = (Y[i] - acc) / torch.clamp_min(L[i, i], 1e-30)
    return X


def cholesky_clip_batched_gram(Gb, B, *, nonneg: bool = True,
                               upper_bound: float = 0.0):
    """Per-column Cholesky + clip: Gb (n, k, k), B (k, n) -> X (k, n)
    (cholesky_clip_col per column, cholesky_clip.hpp:64-106)."""
    X = batched_spd_solve(Gb, B)
    if nonneg:
        X = torch.clamp_min(X, 0.0)
    if upper_bound > 0:
        X = torch.clamp_max(X, upper_bound)
    return X


def cd_nnls_batched_gram(Gb, B_res, X0, L1, *, nonneg: bool, maxit: int,
                         cd_tol: float, upper_bound: float = 0.0):
    """CD NNLS with a distinct Gram per column.

    Gb (n, k, k), B_res (k, n) the residual relative to X0 (k, n).  The same
    sweep and freeze semantics as the shared-Gram solver.  A CUDA tensor goes
    to the kernel and a CPU tensor to the plain twin, inside
    :func:`cd_nnls_batched`; there is no other branch.
    """
    return cd_nnls_batched(Gb, B_res, X0, float(L1),
                           _eff_cd_tol(cd_tol, B_res.dtype), nonneg=nonneg,
                           maxit=maxit, upper_bound=upper_bound)
