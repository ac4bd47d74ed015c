"""The plain reference of the dense MSE ALS fit with the Cholesky + clip
solver (RcppML's default ``nmf``), in plain torch.  Imports nothing of the
program.

From W0 (m, k) and d = 1, each iteration:

  H update: G = W W^T + 1e-15 I, B = W A; H = max(0, (G + r I)^-1 B), with
  the solver's trace-relative ridge r = 1e-6 tr(G) / k; d = the L1 norms of
  H's rows (+ 1e-15), H's rows divided by them;
  W update: the same on A^T with H; d = the L1 norms of W's rows;
  loss: || A - W^T diag(d) H ||_F^2, summed over blocks of columns.

At the end the factors are ordered by d, largest first.  ``fit`` computes in
A's dtype (float64 for the reference); ``fit_control`` is the same
arithmetic with TF32 products, the control that has to fail the limits.
``w_update`` takes a fit's last W update again from its own final H, so
that its final W and d are held without following its whole trajectory.
"""

import contextlib

import numpy as np
import torch

TINY = 1e-15
RIDGE = 1e-6
LOSS_BLOCK = 4096


@contextlib.contextmanager
def tf32_products(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def solve_clip(F, A):
    """max(0, argmin_X ||A - F^T X||) by Cholesky on the ridged Gram."""
    k = F.shape[0]
    G = F @ F.T
    G = G + TINY * torch.eye(k, dtype=G.dtype, device=G.device)
    G = G + (RIDGE / k) * torch.trace(G) * torch.eye(k, dtype=G.dtype,
                                                     device=G.device)
    L = torch.linalg.cholesky(G)
    return torch.clamp_min(torch.cholesky_solve(F @ A, L), 0.0)


def scaled(X):
    d = X.abs().sum(dim=1) + TINY
    return X / d[:, None], d


def sse(A, W_T, d, H):
    total = torch.zeros((), dtype=torch.float64, device=A.device)
    Wd = (W_T * d[:, None]).T
    for j0 in range(0, A.shape[1], LOSS_BLOCK):
        R = A[:, j0:j0 + LOSS_BLOCK] - Wd @ H[:, j0:j0 + LOSS_BLOCK]
        total += (R.double() ** 2).sum()
    return float(total)


def als(A, W0, traffic):
    maxit = int(traffic["nmf"]["maxit"])
    W_T = W0.T.contiguous()
    hist = []
    for _ in range(maxit):
        H, d = scaled(solve_clip(W_T, A))
        W_T, d = scaled(solve_clip(H, A.T))
        hist.append(sse(A, W_T, d, H))
    order = torch.argsort(-d)
    return {"W": W_T[order].T.double().cpu().numpy(),
            "d": d[order].double().cpu().numpy(),
            "H": H[order].double().cpu().numpy(),
            "loss_history": np.asarray(hist)}


def fit(A, W0, traffic):
    with tf32_products(False):
        return als(A, W0, traffic)


def fit_control(A, W0, traffic):
    with tf32_products(True):
        return als(A, W0, traffic)


def w_update(A, H):
    """A fit's last W update taken again from its own final H (float64,
    (k, n)): W diag(d) = solve_clip(H, A^T)^T, (m, k)."""
    with tf32_products(False):
        return solve_clip(H, A.T).T.cpu().numpy()
