"""Truncated SVD and PCA: Lanczos, IRLBA, randomized, Krylov, deflation.

The port of ``rcppml_tpu/models/svd.py:36-1288`` (``inst/include/FactorNet/
svd/``: gateway.hpp, lanczos.hpp, irlba.hpp, randomized.hpp, krylov.hpp,
deflation.hpp).  The large products are plain ``torch.matmul`` /
``torch.mv`` calls on the fit's device (the JAX package runs them outside
any Pallas kernel too); the small projected problems stay where the JAX
package puts them: the bidiagonal SVDs and the CV rank selection in float64
numpy on the host, the IRLBA projected SVD, the randomized QRs and the KSPR
Cholesky solves as float32 ``torch.linalg`` calls on the device.

Where the JAX package runs a device loop that stops on a device value
(``_rank1_solve``'s ``while_loop``, ``_irlba_fused``'s restarts), this is a
Python loop that reads one scalar on the host per step; every such read is
counted in ``res.misc["host_syncs"]``.  The Golub-Kahan steps read nothing:
their breakdown guard is a ``torch.where``, as it is a ``jnp.where`` there.

Centering (PCA) is applied implicitly through the matvec identities
``(A - c 1^T) v = A v - c (1^T v)``, so the centered matrix is never made
(svd/spmv.hpp centering support).

``streaming_svd`` (and ``svd`` / ``pca`` of a ``.spz`` path) runs all five
methods over a DataLoader without making A whole (svd/streaming.hpp): every
product with A is a sum over column panels uploaded to the device
(``_LoaderOp``), which keeps them there when both copies fit the card with
headroom.  Its loops read their scalars on the host, as the JAX package's
streaming host loops do.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .. import rng as rng_mod
from ..config import FactorConfig, SVDConfig
from ..device import set_fp32_precision
from ..io.upload import dense_cache_fits, upload
from ..ops import features as feat
from ..result import SVDResult
from .nmf import device_matrix, fit_device


# ---------------------------------------------------------------------------
# Centered operator and inputs
# ---------------------------------------------------------------------------

class _Op:
    """y = (A - c 1^T) x and its transpose, without making the centering."""

    def __init__(self, A: torch.Tensor, center=None, scale=None):
        self.A = A
        self.center = center
        self.scale = scale
        self.shape = tuple(A.shape)

    def mv(self, x):                      # (n,) -> (m,)
        y = self.A @ x
        if self.center is not None:
            y = y - self.center * x.sum()
        if self.scale is not None:
            y = y * self.scale
        return y

    def rmv(self, x):                     # (m,) -> (n,)
        if self.scale is not None:
            x = x * self.scale
        y = self.A.T @ x
        if self.center is not None:
            y = y - (self.center * x).sum()
        return y

    def mm(self, X):                      # (n, b) -> (m, b)
        Y = self.A @ X
        if self.center is not None:
            Y = Y - self.center[:, None] * X.sum(dim=0)[None, :]
        if self.scale is not None:
            Y = Y * self.scale[:, None]
        return Y

    def rmm(self, X):                     # (m, b) -> (n, b)
        if self.scale is not None:
            X = X * self.scale[:, None]
        Y = self.A.T @ X
        if self.center is not None:
            ones = torch.ones(self.shape[1], dtype=X.dtype, device=X.device)
            Y = Y - torch.outer(ones, self.center @ X)
        return Y


def _densify(A):
    """numpy / scipy.sparse / tensor input -> host dense f32 or the tensor."""
    if isinstance(A, torch.Tensor):
        return A
    if hasattr(A, "todense"):
        return np.asarray(A.todense(), dtype=np.float32)
    return np.asarray(A, dtype=np.float32)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _host_dense(A) -> np.ndarray:
    """A as a dense float32 host array (the JAX package's ``A_np``)."""
    A = _densify(A)
    if isinstance(A, torch.Tensor):
        return _host(A.to(torch.float32))
    return A


def _on_device(A, device) -> torch.Tensor:
    """A as a float32 tensor on the fit's device (a tensor already there
    stays; a host array is copied once), with float32 products in full
    float32."""
    dev = fit_device(A, device)
    set_fp32_precision()
    return device_matrix(_densify(A), dev)


def _prep(A, cfg: SVDConfig, device):
    Ad = _on_device(A, device)
    center = scale = None
    if cfg.center:
        center = Ad.mean(dim=1)
    if cfg.scale:
        sd = Ad.std(dim=1, correction=0)
        scale = 1.0 / torch.clamp_min(sd, 1e-8)
    return _Op(Ad, center, scale), center, scale


def _seed_vector(n: int, seed: int) -> np.ndarray:
    v = rng_mod.fill_uniform(seed if seed != 0 else 12345, n, 1)[:, 0] - 0.5
    v = v.astype(np.float32)
    return v / np.linalg.norm(v)


def _dev(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array as a float32 tensor on ``like``'s device."""
    return torch.from_numpy(np.array(x, np.float32, order="C")).to(
        like.device)


def _center_scale(center, scale):
    """The result's center and scale (the row sd, not its inverse)."""
    return (None if center is None else _host(center),
            None if scale is None else 1.0 / _host(scale))


# ---------------------------------------------------------------------------
# Golub-Kahan bidiagonalization with full reorthogonalization
# ---------------------------------------------------------------------------

def _gkb_extend(op: _Op, U, V, alphas, betas, start: int, v_next,
                steps: int):
    """Extend a GKB factorization from column ``start`` to ``steps``.

    U (m, steps), V (n, steps) hold computed vectors in their first
    ``start`` columns (zeros elsewhere, so full-basis projections are
    exact); they and ``alphas``, ``betas`` (steps,) are written in place.
    Returns (U, V, alphas, betas, v_last).  Recursion (svd/lanczos.hpp):

        alpha_j u_j = A v_j - beta_{j-1} u_{j-1}   (+ reorth vs U)
        beta_j v_{j+1} = A^T u_j - alpha_j v_j      (+ reorth vs V)

    No host read: the breakdown guard is a ``torch.where``.
    """
    for j in range(start, steps):
        V[:, j] = v_next
        u = op.mv(v_next)
        # full reorthogonalization against all stored U columns
        u = u - U @ (U.T @ u)
        alpha = (u * u).sum().sqrt()
        # breakdown guard: once the residual falls below ~fp32 noise of the
        # leading coefficient, the invariant subspace is exhausted — zero
        # the chain instead of normalizing rounding junk
        amax = torch.maximum(alphas.max(), betas.max())
        floor = 1e-5 * torch.clamp_min(amax, 1e-30)
        ok_a = alpha > floor
        u = torch.where(ok_a, u / torch.clamp_min(alpha, 1e-30),
                        torch.zeros_like(u))
        alphas[j] = torch.where(ok_a, alpha, torch.zeros_like(alpha))
        U[:, j] = u

        w = op.rmv(u)
        w = w - V @ (V.T @ w)
        beta = (w * w).sum().sqrt()
        ok_b = ok_a & (beta > floor)
        v_next = torch.where(ok_b, w / torch.clamp_min(beta, 1e-30),
                             torch.zeros_like(w))
        betas[j] = torch.where(ok_b, beta, torch.zeros_like(beta))
    return U, V, alphas, betas, v_next


def _zeros(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def lanczos_svd(A, cfg: SVDConfig, *, device=None) -> SVDResult:
    """Golub-Kahan Lanczos SVD with full reorthogonalization
    (svd/lanczos.hpp, O(nnz j + (m+n) j^2)).  ``device``: where it runs, as
    for ``nmf`` (a tensor's own device, else the CUDA card)."""
    op, center, scale = _prep(A, cfg, device)
    m, n = op.shape
    k = min(cfg.k, min(m, n))
    steps = min(min(m, n), max(2 * k + 10, 20))

    Ad = op.A
    v0 = _dev(_seed_vector(n, cfg.seed), Ad)
    U, V, alphas, betas, _ = _gkb_extend(
        op, _zeros(m, steps, like=Ad), _zeros(n, steps, like=Ad),
        _zeros(steps, like=Ad), _zeros(steps, like=Ad), 0, v0, steps)

    ab = _host(torch.stack([alphas, betas])).astype(np.float64)
    a, b = ab[0], ab[1]
    B = np.diag(a) + np.diag(b[:-1], 1)       # upper bidiagonal
    P, s, Qt = np.linalg.svd(B)
    Uk = U @ _dev(P[:, :k], Ad)
    Vk = V @ _dev(Qt[:k].T, Ad)
    c, sc = _center_scale(center, scale)
    res = SVDResult(U=_host(Uk), d=s[:k].astype(np.float32), V=_host(Vk),
                    k_selected=k, converged=True, iterations=steps,
                    center=c, scale=sc)
    res.misc["host_syncs"] = 1
    return res


def _irlba_fused(op: _Op, v0, tol: float, *, k: int, work: int,
                 max_restarts: int):
    """Whole IRLBA: every restart — the (work x work) projected SVD, the
    thick-restart basis rotation, the augmented GKB extension and the
    coupling-residual convergence test — on the device; the loop reads the
    convergence flag on the host once per restart.  Returns
    (Uk, d, Vk, restarts, converged, host reads)."""
    m, n = op.shape
    Ad = op.A
    iw = torch.arange(work, device=Ad.device)
    U, V, alphas, betas, v_next = _gkb_extend(
        op, _zeros(m, work, like=Ad), _zeros(n, work, like=Ad),
        _zeros(work, like=Ad), _zeros(work, like=Ad), 0, v0, work)
    B = torch.diag(alphas) + torch.diag(betas[:-1], 1)
    ik = torch.arange(k, device=Ad.device)

    def restart(U, V, betas, v_next, P, s, Qt):
        Pk = P[:, :k]
        U_new = U @ Pk                                            # (m, k)
        V_new = V @ Qt[:k].T                                      # (n, k)
        rho = betas[-1] * P[-1, :k]                               # coupling

        U = _zeros(m, work, like=Ad)
        U[:, :k] = U_new
        V = _zeros(n, work, like=Ad)
        V[:, :k] = V_new

        u = op.mv(v_next) - U_new @ rho
        u = u - U @ (U.T @ u)
        alpha_k = (u * u).sum().sqrt()
        u = u / torch.clamp_min(alpha_k, 1e-30)
        U[:, k] = u
        V[:, k] = v_next

        w = op.rmv(u)
        w = w - V @ (V.T @ w)
        beta_k = (w * w).sum().sqrt()
        v2 = w / torch.clamp_min(beta_k, 1e-30)

        al = _zeros(work, like=Ad)
        al[k] = alpha_k
        be = _zeros(work, like=Ad)
        be[k] = beta_k
        U, V, al, be, v_next = _gkb_extend(op, U, V, al, be, k + 1, v2, work)

        # projected matrix after thick restart:
        #   [ diag(s_k)  rho ; 0  alpha/beta bidiagonal chain ]
        B = _zeros(work, work, like=Ad)
        B[ik, ik] = s[:k]
        B[ik, k] = rho
        B = B + torch.diag(torch.where(iw >= k, al, torch.zeros_like(al)))
        B = B + torch.diag(torch.where(iw[:-1] >= k, be[:-1],
                                       torch.zeros_like(be[:-1])), 1)
        return U, V, B, be, v_next

    it, conv, syncs = 0, False, 0
    while it < max_restarts and not conv:
        # one projected SVD per restart: the convergence test and the
        # thick-restart rotation share the same decomposition
        P, s, Qt = torch.linalg.svd(B)
        res = (betas[-1] * P[-1, :k]).abs()
        conv = bool((res < tol * torch.clamp_min(s[0], 1e-30)).all())
        syncs += 1
        if not conv:
            U, V, B, betas, v_next = restart(U, V, betas, v_next, P, s, Qt)
        it += 1
    P, s, Qt = torch.linalg.svd(B)
    return U @ P[:, :k], s[:k], V @ Qt[:k].T, it, conv, syncs


def irlba_svd(A, cfg: SVDConfig, *, device=None) -> SVDResult:
    """Augmented implicitly-restarted Lanczos bidiagonalization
    (Baglama & Reichel; svd/irlba.hpp, work = k + 7): the port of the JAX
    package's in-memory route, ``_irlba_fused``."""
    op, center, scale = _prep(A, cfg, device)
    m, n = op.shape
    k = min(cfg.k, min(m, n) - 1) if min(m, n) > 1 else 1
    work = min(min(m, n), (cfg.work if cfg.work > 0 else k + 7))
    max_restarts = cfg.max_iter if cfg.max_iter > 0 else 100
    tol = cfg.tol if cfg.tol > 0 else 1e-5

    v0 = _dev(_seed_vector(n, cfg.seed), op.A)
    Uk, d, Vk, it, conv, syncs = _irlba_fused(
        op, v0, float(np.float32(tol)), k=k, work=work,
        max_restarts=max_restarts)
    c, sc = _center_scale(center, scale)
    res = SVDResult(U=_host(Uk), d=_host(d).astype(np.float32), V=_host(Vk),
                    k_selected=k, converged=conv, iterations=it,
                    center=c, scale=sc)
    res.misc["host_syncs"] = syncs
    return res


def randomized_svd(A, cfg: SVDConfig, *, device=None) -> SVDResult:
    """Halko-Martinsson-Tropp randomized SVD with oversampling and power
    iterations (svd/randomized.hpp): products, tall-skinny QRs and one
    small SVD, no host read."""
    op, center, scale = _prep(A, cfg, device)
    m, n = op.shape
    k = min(cfg.k, min(m, n))
    p = min(cfg.oversample, min(m, n) - k)
    q = cfg.power_iters
    b = k + max(p, 0)

    Omega = rng_mod.fill_uniform(cfg.seed if cfg.seed != 0 else 12345,
                                 n, b).astype(np.float32) - 0.5
    Y = op.mm(_dev(Omega, op.A))                        # (m, b)
    Q, _ = torch.linalg.qr(Y)
    for _ in range(q):
        Z = op.rmm(Q)                                   # (n, b)
        Qz, _ = torch.linalg.qr(Z)
        Y = op.mm(Qz)
        Q, _ = torch.linalg.qr(Y)
    Bs = op.rmm(Q).T                                    # (b, n)
    Ub, s, Vt = torch.linalg.svd(Bs, full_matrices=False)
    U = Q @ Ub[:, :k]
    c, sc = _center_scale(center, scale)
    res = SVDResult(U=_host(U), d=_host(s[:k]), V=_host(Vt[:k].T),
                    k_selected=k, converged=True, iterations=q,
                    center=c, scale=sc)
    res.misc["host_syncs"] = 0
    return res


# ---------------------------------------------------------------------------
# Deflation SVD (rank-1 ALS on the deflated residual; svd/deflation.hpp)
# ---------------------------------------------------------------------------

def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def _kspr_half(F_other, B, L1, L2, nonneg, upper_bound, cv_corr=1.0,
               G_add=None):
    """One constrained-LS half-update of the KSPR refinement
    (svd/krylov.hpp:420-600): given B = A V (resp. A^T W) and the fixed
    side F_other, solve the ridge system by a Cholesky factor and two
    triangular solves, apply the elementwise constraint projection, and
    return (X, column norms) with X column-normalized.

    ``cv_corr``: the held-out-aware denominator correction (1 - the holdout
    probability), which scales the Gram and the L1 threshold's norms
    (svd/krylov.hpp:474,521)."""
    k = F_other.shape[1]
    G = cv_corr * (F_other.T @ F_other) + (1e-12 + L2) * torch.eye(
        k, dtype=F_other.dtype, device=F_other.device)
    if G_add is not None:
        # tier-2 Gram-level features from the previous iterate of the
        # side being solved (svd/krylov.hpp:481-497)
        G = G + G_add
    L = torch.linalg.cholesky(G)
    Xt = torch.linalg.solve_triangular(L, B.T, upper=False)
    Xt = torch.linalg.solve_triangular(L.mT, Xt, upper=True)
    X = Xt.T
    norm_sq = cv_corr * (F_other * F_other).sum(dim=0)
    if L1 > 0:
        X = _soft_threshold(X, L1 / (2.0 * norm_sq)[None, :])
    if nonneg:
        X = torch.clamp_min(X, 0.0)
    if upper_bound > 0:
        X = torch.clamp_max(X, upper_bound)
    d = (X * X).sum(dim=0).sqrt()
    return X / torch.clamp_min(d, 1e-30)[None, :], d


def _huber_weights(resid, delta):
    """MAD-scaled Huber IRLS weights (deflation.hpp:96-168).

    scale = median(|r|) / 0.6745 (upper median: nth_element at len/2),
    falling back to 1 when the residuals are ~all zero; then
    w = 1 for |r/scale| <= delta, else delta/|r/scale| in (0, 1]."""
    ar = resid.abs()
    mad = torch.sort(ar).values[ar.shape[0] // 2]
    scale = mad / 0.6745
    scale = torch.where(
        scale < float(np.float32(np.finfo(np.float32).eps * 100)),
        torch.ones_like(scale), scale)
    z = ar / scale
    return torch.where(z <= delta, torch.ones_like(z),
                       delta / torch.clamp_min(z, 1e-30))


def _apply_reg_vec(x, L1, L2, nonneg, upper_bound, norm_sq, L21):
    """Per-vector constraint projection (deflation.hpp:192-239).

    L21 degenerates to adaptive L2 for rank-1; L2 scales the whole vector by
    1/(1 + L2/norm_sq); L1 soft-thresholds at L1/(2 norm_sq)."""
    if L21 > 0:
        xn = (x * x).sum().sqrt()
        L2 = L2 + torch.where(xn > 1e-10, L21 / torch.clamp_min(xn, 1e-10),
                              torch.zeros_like(xn))
    if isinstance(L2, torch.Tensor) or L2 > 0:
        x = x / (1.0 + L2 / norm_sq)
    if L1 > 0:
        x = _soft_threshold(x, L1 / (2.0 * norm_sq))
    if nonneg:
        x = torch.clamp_min(x, 0.0)
    if upper_bound > 0:
        x = torch.clamp_max(x, upper_bound)
    return x


def _rank1_solve(Ad, At, u0, Uk, dk, Vk, tol_k: float, gu, gv,
                 cv_corr: float, *, cfg: SVDConfig, max_iter: int,
                 do_robust: bool):
    """Full rank-1 ALS on the deflated operator (deflation.hpp:678-795).

    The JAX package's ``while_loop``: here a Python loop whose condition
    reads the convergence distance on the host once per iteration.  With
    ``cfg.robust_delta > 0`` it runs the reference's Huber IRLS
    (deflation.hpp:689-766): from iteration 1 on, row weights come from the
    rank-1 residual r_i = (Av)_i - sigma*u_i and column weights from
    r_j = (A'u)_j - sigma*v_j, each MAD-scaled, and the v/u updates use the
    weighted normal equations.  Momentum ``(it-1)/(it+2)`` is off under
    IRLS (deflation.hpp:683-686).  ``gu``/``gv``: the graph Laplacians of
    the two sides, or None.  Returns (u, v, sigma, iterations, host
    reads)."""
    n = Ad.shape[1]

    def defl_t(x):                 # A^T x - V d U^T x
        return At @ x - (Vk * dk[None, :]) @ (Uk.T @ x)

    def defl_f(x):                 # A x - U d V^T x
        return Ad @ x - (Uk * dk[None, :]) @ (Vk.T @ x)

    fmin = float(np.finfo(np.float32).eps)
    u, v, u_prev = u0, _zeros(n, like=Ad), u0
    sigma = torch.zeros((), dtype=torch.float32, device=Ad.device)
    it, syncs = 0, 0
    cd = None
    while it < max_iter and (cd is None or bool(cd >= tol_k)):
        if cd is not None:
            syncs += 1
        beta = (float(np.float32(it - 1) / np.float32(it + 2))
                if it > 1 and not do_robust else 0.0)
        u_hat = u + beta * (u - u_prev)

        if do_robust:
            if it > 0:                 # weights need a sigma estimate
                rw = _huber_weights(defl_f(v) - sigma * u, cfg.robust_delta)
                cw = _huber_weights(defl_t(u) - sigma * v, cfg.robust_delta)
            else:
                rw = torch.ones_like(u)
                cw = torch.ones_like(v)
            wu = u_hat * rw
            w = defl_t(wu)
            u_sq_w = (wu * u_hat).sum() * cv_corr
        else:
            w = defl_t(u_hat)
            u_sq_w = (u_hat * u_hat).sum() * cv_corr
        v_new = w / torch.clamp_min(u_sq_w, 1e-30)
        # regularization always uses the unweighted norm (deflation.hpp:735-741)
        u_sq = (u_hat * u_hat).sum() * cv_corr
        v_new = _apply_reg_vec(v_new, cfg.v.L1, cfg.v.L2, cfg.v.nonneg,
                               cfg.v.upper_bound, u_sq, cfg.v.L21)
        # angular vs prior factors + graph smoothness
        # (deflation.hpp:256-292, applied at :740-741)
        u_sq_safe = torch.clamp_min(u_sq, 1e-30)
        if cfg.v.angular > 0:
            v_new = v_new - (cfg.v.angular / u_sq_safe) * (Vk @ (Vk.T @ v_new))
        if gv is not None:
            v_new = v_new - (cfg.v.graph_lambda / u_sq_safe) * (gv @ v_new)
        sigma_v = (v_new * v_new).sum().sqrt()
        v_new = v_new / torch.clamp_min(sigma_v, 1e-30)

        if do_robust:
            wv = v_new * cw
            w2 = defl_f(wv)
            v_sq_w = (wv * v_new).sum() * cv_corr
        else:
            w2 = defl_f(v_new)
            v_sq_w = (v_new * v_new).sum() * cv_corr
        u_new = w2 / torch.clamp_min(v_sq_w, 1e-30)
        v_sq = (v_new * v_new).sum() * cv_corr
        u_new = _apply_reg_vec(u_new, cfg.u.L1, cfg.u.L2, cfg.u.nonneg,
                               cfg.u.upper_bound, v_sq, cfg.u.L21)
        v_sq_safe = torch.clamp_min(v_sq, 1e-30)
        if cfg.u.angular > 0:   # deflation.hpp:785-787
            u_new = u_new - (cfg.u.angular / v_sq_safe) * (Uk @ (Uk.T @ u_new))
        if gu is not None:
            u_new = u_new - (cfg.u.graph_lambda / v_sq_safe) * (gu @ u_new)
        sigma_new = (u_new * u_new).sum().sqrt()
        u_new = u_new / torch.clamp_min(sigma_new, 1e-30)
        cos_dist = 1.0 - (u_new * u).sum().abs()
        # convergence modes (deflation.hpp:796-814): FACTOR = cosine
        # distance of consecutive u; LOSS = relative sigma change
        # (valid from iteration 1); BOTH = either
        if cfg.convergence == "factor":
            cd = cos_dist
        else:
            d_sigma = (sigma_new - sigma).abs() / torch.clamp_min(sigma, fmin)
            if it == 0:
                d_sigma = torch.full_like(d_sigma, float("inf"))
            cd = (d_sigma if cfg.convergence == "loss"
                  else torch.minimum(cos_dist, d_sigma))
        # a zero factor means the reference breaks out (deflation.hpp:745,783)
        cd = torch.where((sigma_new > 0) & (sigma_v > 0), cd,
                         torch.full_like(cd, -1.0))
        u, v, u_prev, sigma = u_new, v_new, u, sigma_new
        it += 1
    if it < max_iter:
        syncs += 1                 # the read that ended the loop
    return u, v, sigma, it, syncs


def deflation_svd(A, cfg: SVDConfig, *, obs_mask=None, aux=None,
                  device=None) -> SVDResult:
    """Rank-1 ALS deflation SVD with constraints, robust IRLS, and built-in
    speckled-holdout auto-rank (svd/deflation.hpp:430-900).

    Supports SVD / PCA (center) / NNSVD (nonneg u+v) / sparse PCA (L1) /
    semi-NMF SVD (nonneg one side).  With ``cfg.test_fraction > 0`` it stops
    adding factors when the held-out MSE stops improving for
    ``cfg.patience`` factors.

    ``obs_mask`` (bool (m, n)): user-unobserved entries, zeroed in the
    training matrix before the CV holdout (deflation.hpp:450-485);
    ``cfg.mask_zeros`` restricts the CV holdout to nonzero entries of A
    (speckled_cv.hpp:52-53).  The masks and the training matrix are made on
    the host, as in the JAX package; the solves run on ``device``.
    """
    dev = fit_device(A, device)
    A_np = _host_dense(A)
    m, n = A_np.shape
    k_max = min(cfg.k, min(m, n))
    do_cv = cfg.test_fraction > 0
    do_robust = cfg.robust_delta > 0
    patience = cfg.patience

    A_obs = A_np
    if obs_mask is not None:
        obs_mask = np.asarray(obs_mask, dtype=bool)
        if obs_mask.shape != (m, n):
            raise ValueError(f"mask dimensions {obs_mask.shape} must match "
                             f"data {(m, n)}")
        A_obs = A_np * (~obs_mask)

    # CV: zero held-out entries in the training matrix; evaluate on them
    cv_corr = 1.0
    M_test = None
    if do_cv:
        inv_prob = int(1.0 / cfg.test_fraction)
        M_test = rng_mod.holdout_mask(
            cfg.cv_seed if cfg.cv_seed else cfg.seed, m, n, inv_prob)
        if cfg.mask_zeros:
            # only nonzero entries are observed -> eligible for holdout
            M_test &= A_obs != 0
        if obs_mask is not None:
            # user-masked entries are unobserved: never scored
            # (svd/test_entries.hpp skips config-masked entries)
            M_test &= ~obs_mask
        # the holdout hash draws with probability 1/inv_prob — the
        # unbiasing factor must match it, not the raw test_fraction
        cv_corr = 1.0 - 1.0 / inv_prob
    A_train = A_obs * (~M_test) if M_test is not None else A_obs
    if cfg.center:
        center = A_train.mean(axis=1)
        A_train = A_train - center[:, None]
    else:
        center = None
    row_sds = None
    if cfg.scale:
        # correlation PCA: rows standardized by population sd
        # (deflation.hpp:385-394, spmv.hpp compute_row_sds)
        row_sds = np.maximum(A_train.std(axis=1), 1e-8).astype(np.float32)
        A_train = A_train / row_sds[:, None]

    set_fp32_precision()
    Ad = device_matrix(A_train, dev)
    At = Ad.T
    max_iter = cfg.max_iter if cfg.max_iter > 0 else 100

    U_all = np.zeros((m, k_max), np.float32)
    V_all = np.zeros((n, k_max), np.float32)
    d_all = np.zeros((k_max,), np.float32)
    iters_per_factor = []
    test_traj = []
    best_test = np.inf
    best_k = 0
    pat_ctr = 0
    syncs = 0
    if do_cv:
        # exact per-entry residual tracking (test_entries.hpp TestEntries):
        # r_ij starts at the true held-out value (training-centered) and
        # each accepted factor subtracts sigma*u_i*v_j
        te_rows, te_cols = np.nonzero(M_test)
        te_resid = A_np[te_rows, te_cols].astype(np.float64)
        if center is not None:
            te_resid = te_resid - np.asarray(center, np.float64)[te_rows]
        if row_sds is not None:
            te_resid = te_resid / np.asarray(row_sds, np.float64)[te_rows]
    # sequential draws mirror the reference per-factor init stream
    offset = 0
    seed = cfg.seed if cfg.seed != 0 else 42

    def rand_u():
        nonlocal offset
        u = rng_mod.fill_uniform(seed, m, 1, offset=offset)[:, 0]
        offset += m
        return _dev(u, Ad)

    aux = aux or {}
    gu = gv = None
    if aux.get("graph_U") is not None and cfg.u.graph_lambda > 0:
        gu = _dev(aux["graph_U"], Ad)
    if aux.get("graph_V") is not None and cfg.v.graph_lambda > 0:
        gv = _dev(aux["graph_V"], Ad)

    # any elementwise projection (nonneg / soft-threshold / bound clip)
    # would be undone by Gram-Schmidt re-mixing — skip GS for all of them
    constrained = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                   cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                   cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                   cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0)

    for kk in range(k_max):
        Uk = _dev(U_all, Ad)
        Vk = _dev(V_all, Ad)
        dk = _dev(d_all, Ad)

        if kk == 0:
            u = rand_u()
        else:
            # power-step warm start from the previous factor
            # (deflation.hpp:637-660)
            u = Uk[:, kk - 1]
            u = u - Uk @ (Uk.T @ u)
            nu = float((u * u).sum().sqrt())
            syncs += 1
            if nu < 1e-5:
                u = rand_u()
        u = u / torch.clamp_min((u * u).sum().sqrt(), 1e-30)

        tol_k = cfg.tol if cfg.tol > 0 else 1e-5
        if kk > 0 and d_all[0] > 0 and d_all[kk - 1] > 0:
            tol_k = min(tol_k * d_all[0] / d_all[kk - 1], tol_k * 100)

        u, v, _sig, it, reads = _rank1_solve(
            Ad, At, u, Uk, dk, Vk, float(np.float32(tol_k)), gu, gv,
            float(np.float32(cv_corr)), cfg=cfg, max_iter=max_iter,
            do_robust=do_robust)
        syncs += reads

        # two-pass Gram-Schmidt against stored factors (deflation.hpp:824-850)
        if kk > 0 and not constrained:
            for _ in range(2):
                u = u - Uk @ (Uk.T @ u)
                v = v - Vk @ (Vk.T @ v)
            u = u / torch.clamp_min((u * u).sum().sqrt(), 1e-30)
            v = v / torch.clamp_min((v * v).sum().sqrt(), 1e-30)

        # Rayleigh sigma after reorthogonalization (deflation.hpp:852-861)
        w2 = Ad @ v - (Uk * dk[None, :]) @ (Vk.T @ v)
        sigma = abs(float(u @ w2))
        syncs += 1

        U_all[:, kk] = _host(u)
        V_all[:, kk] = _host(v)
        d_all[kk] = sigma
        iters_per_factor.append(it)

        if do_cv:
            te_resid = te_resid - sigma * (U_all[te_rows, kk].astype(np.float64)
                                           * V_all[te_cols, kk])
            test_mse = (float(np.mean(te_resid ** 2)) if te_resid.size
                        else 0.0)
            test_traj.append(test_mse)
            if test_mse < best_test:
                best_test = test_mse
                best_k = kk + 1
                pat_ctr = 0
            else:
                pat_ctr += 1
                if pat_ctr >= patience:
                    break

    k_sel = best_k if (do_cv and best_k > 0) else (kk + 1)
    res = SVDResult(U=U_all[:, :k_sel], d=d_all[:k_sel], V=V_all[:, :k_sel],
                    k_selected=k_sel, converged=True,
                    iterations=int(np.sum(iters_per_factor)),
                    center=center, scale=row_sds,
                    test_loss=best_test if do_cv else float("nan"))
    res.misc["iters_per_factor"] = iters_per_factor
    res.misc["test_loss_trajectory"] = test_traj
    res.misc["host_syncs"] = syncs
    return res


# ---------------------------------------------------------------------------
# Krylov-Seeded Projected Refinement (constrained SVD; svd/krylov.hpp)
# ---------------------------------------------------------------------------

def _cv_rank_select(A_orig, M_test, U, d, V, center, patience,
                    row_sds=None):
    """Exact per-entry held-out test-loss evaluation (svd/test_entries.hpp).

    The residual of every held-out entry (true value, row-centered like the
    training matrix) is updated as factors are added in descending-sigma
    order — ``r_ij -= sigma_k u_k(i) v_k(j)`` — and rank selection follows
    the patience rule on the exact test MSE (krylov.hpp:698-731,
    deflation.hpp:869-895).  Float64 numpy on the host, as in the JAX
    package.  Returns (best_k, best_mse, trajectory)."""
    rows, cols = np.nonzero(M_test)
    resid = A_orig[rows, cols].astype(np.float64)
    if center is not None:
        resid = resid - np.asarray(center, np.float64)[rows]
    if row_sds is not None:
        resid = resid / np.asarray(row_sds, np.float64)[rows]
    best = np.inf
    best_k = 0
    pat = 0
    traj = []
    for rank in range(d.shape[0]):
        resid = resid - float(d[rank]) * U[rows, rank] * V[cols, rank]
        mse = float(np.mean(resid ** 2)) if resid.size else 0.0
        traj.append(mse)
        if mse < best:
            best, best_k, pat = mse, rank + 1, 0
        else:
            pat += 1
            if pat >= patience:
                break
    return best_k, best, traj


def _tier2(X_prev, fc: FactorConfig, graph):
    """L21 / angular / graph at Gram level from the previous iterate of the
    side being solved (krylov.hpp:481-497); X_prev is (dim, k), the helpers
    take (k, dim).  None when no such feature is on."""
    if fc.L21 <= 0 and fc.angular <= 0 and graph is None:
        return None
    k = X_prev.shape[1]
    GA = torch.zeros((k, k), dtype=X_prev.dtype, device=X_prev.device)
    Xt = X_prev.T
    if fc.L21 > 0:
        GA = feat.apply_l21(GA, Xt, fc.L21)
    if fc.angular > 0:
        GA = feat.apply_angular_gram(GA, Xt, fc.angular)
    if graph is not None:
        GA = feat.apply_graph_reg(GA, graph, Xt, fc.graph_lambda)
    return GA


def krylov_svd(A, cfg: SVDConfig, aux=None, *, device=None) -> SVDResult:
    """KSPR constrained SVD: Lanczos seed -> batched projected refinement
    (svd/krylov.hpp:420-600).

    Each pass: Gram of the fixed side -> product with A -> Cholesky solve ->
    elementwise constraint projection (L1 soft-threshold at L1/(2 norm_sq),
    nonneg clip) -> column normalization with scale absorbed into d.  The
    plain Lanczos result when no constraint is on.

    With ``cfg.test_fraction > 0`` the fit is held-out-aware
    (svd/krylov.hpp:397-414,474,521 + test_entries.hpp): the Lanczos seed
    and every refinement pass see only the holdout-zeroed training matrix,
    the Gram/norm denominators carry the ``1 - 1/inv_prob`` correction, and
    rank is selected by the exact per-entry test MSE with patience.  The
    pass loop reads its convergence test on the host once per pass.
    """
    dev = fit_device(A, device)
    has_constraints = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                       cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                       cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                       cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0 or
                       cfg.u.angular > 0 or cfg.v.angular > 0 or
                       bool(aux and (aux.get("graph_U") is not None or
                                     aux.get("graph_V") is not None)))
    do_cv = cfg.test_fraction > 0

    M_test = None
    cv_corr = 1.0
    A_orig = None
    if do_cv:
        A_orig = _host_dense(A)
        inv_prob = int(1.0 / cfg.test_fraction)
        M_test = rng_mod.holdout_mask(
            cfg.cv_seed if cfg.cv_seed else cfg.seed,
            A_orig.shape[0], A_orig.shape[1], inv_prob)
        cv_corr = 1.0 - 1.0 / inv_prob
        A = A_orig * (~M_test)          # phases 1+2 train on zeroed matrix

    seed_res = lanczos_svd(A, cfg, device=dev)
    if not has_constraints and not do_cv:
        return seed_res

    A_np = _host_dense(A)
    k = seed_res.k
    if cfg.center:
        center = A_np.mean(axis=1)
        A_np = A_np - center[:, None]
    else:
        center = None
    row_sds = None
    if cfg.scale:
        row_sds = np.maximum(A_np.std(axis=1), 1e-8).astype(np.float32)
        A_np = A_np / row_sds[:, None]
    Ad = device_matrix(A_np, dev)

    max_passes = cfg.max_iter if cfg.max_iter > 0 else max(
        10, 2 * int(math.ceil(math.log2(max(k, 2)))) + 3)
    tol = cfg.tol if cfg.tol > 0 else 1e-5

    aux = aux or {}
    gu = gv = None
    if aux.get("graph_U") is not None and cfg.u.graph_lambda > 0:
        gu = _dev(aux["graph_U"], Ad)
    if aux.get("graph_V") is not None and cfg.v.graph_lambda > 0:
        gv = _dev(aux["graph_V"], Ad)

    def one_pass(W, V):
        B = Ad @ V                                              # (m, k)
        W, d = _kspr_half(V, B, cfg.u.L1, cfg.u.L2, cfg.u.nonneg,
                          cfg.u.upper_bound, cv_corr,
                          G_add=_tier2(W, cfg.u, gu))
        B = Ad.T @ W                                            # (n, k)
        # d REPLACED by the raw column norm each half-update — W and V stay
        # unit-norm, d tracks the singular value (krylov.hpp:424-427)
        V, d = _kspr_half(W, B, cfg.v.L1, cfg.v.L2, cfg.v.nonneg,
                          cfg.v.upper_bound, cv_corr,
                          G_add=_tier2(V, cfg.v, gv))
        return W, V, d

    W = _dev(np.abs(seed_res.U) if cfg.u.nonneg else seed_res.U, Ad)
    V = _dev(np.abs(seed_res.V) if cfg.v.nonneg else seed_res.V, Ad)
    d = _dev(seed_res.d, Ad)
    passes = 0
    converged = False
    prev_W = None
    prev_var = None
    syncs = seed_res.misc["host_syncs"]
    for passes in range(1, max_passes + 1):
        W, V, d = one_pass(W, V)
        # convergence modes (krylov.hpp:590-622): FACTOR = relative W
        # change; LOSS = relative change of sum(d^2) (variance proxy)
        factor_conv = loss_conv = False
        if cfg.convergence != "loss" and prev_W is not None:
            dW = float(torch.linalg.norm(W - prev_W) /
                       (torch.linalg.norm(prev_W) + 1e-30))
            syncs += 1
            factor_conv = dW < tol
        var_new = None
        if cfg.convergence != "factor":
            var_new = float((d * d).sum())
            syncs += 1
            if prev_var is not None:
                loss_conv = abs(var_new - prev_var) / (prev_var + 1e-30) < tol
        if factor_conv or loss_conv:
            converged = True
            break
        prev_W = W
        prev_var = var_new

    d_np = _host(d)
    order = np.argsort(-d_np, kind="stable")
    U_np = _host(W)[:, order]
    d_np = d_np[order]
    V_np = _host(V)[:, order]

    if do_cv:
        best_k, best_mse, traj = _cv_rank_select(
            A_orig, M_test, U_np, d_np, V_np, center, cfg.patience,
            row_sds=row_sds)
        k_sel = best_k if best_k > 0 else k
        res = SVDResult(U=U_np[:, :k_sel], d=d_np[:k_sel], V=V_np[:, :k_sel],
                        k_selected=k_sel, converged=converged,
                        iterations=passes, center=center, scale=row_sds,
                        test_loss=best_mse)
        res.misc["test_loss_trajectory"] = traj
    else:
        res = SVDResult(U=U_np, d=d_np, V=V_np, k_selected=k,
                        converged=converged, iterations=passes,
                        center=center, scale=row_sds)
    res.misc["host_syncs"] = syncs
    return res


# ---------------------------------------------------------------------------
# Gateway + auto-select (svd/gateway.hpp:141-187, auto_select.hpp:16-99)
# ---------------------------------------------------------------------------

def _auto_select_method(cfg: SVDConfig, k: int) -> str:
    has_constraints = (cfg.u.nonneg or cfg.v.nonneg or cfg.u.L1 > 0 or
                       cfg.v.L1 > 0 or cfg.u.L2 > 0 or cfg.v.L2 > 0 or
                       cfg.u.L21 > 0 or cfg.v.L21 > 0 or
                       cfg.u.upper_bound > 0 or cfg.v.upper_bound > 0 or
                       cfg.u.angular > 0 or cfg.v.angular > 0 or
                       cfg.u.graph_lambda > 0 or cfg.v.graph_lambda > 0)
    if cfg.robust_delta > 0:
        return "deflation"            # only robust-capable method
    if has_constraints:
        return "krylov" if k >= 8 else "deflation"
    if cfg.test_fraction > 0:
        return "deflation"            # CV needs held-out-aware solves (R/svd.R:383)
    # the reference's accelerator policy (auto_select.hpp:60-99):
    # small k -> Lanczos; mid -> randomized; large -> IRLBA
    if k < 32:
        return "lanczos"
    if k < 64:
        return "randomized"
    return "irlba"


def _frobenius_sq(data, center: bool) -> float:
    """||A||_F^2, less n ||rowmean||^2 when centered: the denominator of
    ``variance_explained`` (deflation.hpp:396-417)."""
    n_ = data.shape[1]
    if hasattr(data, "nnz"):
        fro2 = float((data.data.astype(np.float64) ** 2).sum())
        if center:
            mu = np.asarray(data.mean(axis=1), dtype=np.float64).ravel()
            fro2 -= n_ * float((mu ** 2).sum())
    elif isinstance(data, torch.Tensor):    # one small reduction there
        A = data.to(torch.float32)
        fro2 = float((A ** 2).sum())
        if center:
            mu = A.mean(dim=1)
            fro2 -= n_ * float((mu ** 2).sum())
    else:
        arr = np.asarray(data, dtype=np.float64)
        fro2 = float((arr ** 2).sum())
        if center:
            mu = arr.mean(axis=1)
            fro2 -= n_ * float((mu ** 2).sum())
    return fro2


def svd(data, k=10, *, method: str = "auto", center: bool = False,
        scale: bool = False, seed: int = 0, tol: float = 1e-5,
        maxit: int = 0, oversample: int = 10, power_iters: int = 2,
        nonneg=(False, False), L1=(0.0, 0.0), L2=(0.0, 0.0),
        L21=(0.0, 0.0), upper_bound=(0.0, 0.0), angular=(0.0, 0.0),
        graph_U=None, graph_V=None, graph_lambda=(0.0, 0.0), robust=False,
        test_fraction: float = 0.0, cv_seed: int = 0, mask=None,
        convergence: str = "factor", device=None, **kw) -> SVDResult:
    """Truncated SVD gateway (R/svd.R:108, svd/gateway.hpp:141-161).

    ``data``: a numpy array, a scipy sparse matrix (made dense) or a 2-D
    tensor.  ``device``: where it runs; by default a tensor's own device,
    and the CUDA card for a host array (without a card that raises; pass
    ``device="cpu"`` to run on the CPU).

    ``mask`` accepts ``None``, ``"zeros"`` (CV holdout restricted to
    nonzero entries), a matrix of unobserved entries, or
    ``("zeros", matrix)`` for both (R/svd.R:233-268).  Masks are honored
    by the deflation solver only, which is the reference's only consumer
    of them; other methods reject a mask.

    A ``.spz`` path dispatches to :func:`streaming_svd`
    (svd/gateway.hpp:173-187)."""
    from ..config import FactorConfig as FC
    from ..api import _extract_dimnames

    # advanced dot-parameters: the reference REJECTS unknown names
    # (R/parse_dots.R:124-131) — never swallow a typo silently.
    _dot_defaults = {"patience": 3, "k_max": 50, "verbose": False,
                     "threads": 0, "resource": "auto"}
    unknown = set(kw) - set(_dot_defaults)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) passed to svd(): "
            f"{', '.join(sorted(repr(u) for u in unknown))}; valid "
            f"advanced parameters: {sorted(_dot_defaults)} "
            "(R/parse_dots.R:106-131)")
    patience = int(kw.get("patience", _dot_defaults["patience"]))
    k_max = int(kw.get("k_max", _dot_defaults["k_max"]))
    verbose = kw.get("verbose", _dot_defaults["verbose"])
    # threads / resource are accepted for R-surface compatibility; there is
    # no thread pool or backend switch to steer.

    if isinstance(data, str):
        if not data.endswith(".spz"):
            raise ValueError(f"svd() streams .spz paths only; load {data!r} "
                             "with load_data() first")
        return _svd_spz(data, k, method=method, center=center, scale=scale,
                        seed=seed, tol=tol, maxit=maxit,
                        oversample=oversample, power_iters=power_iters,
                        nonneg=nonneg, L1=L1, L2=L2, L21=L21,
                        upper_bound=upper_bound, angular=angular,
                        graph_U=graph_U, graph_V=graph_V, robust=robust,
                        test_fraction=test_fraction, mask=mask,
                        convergence=convergence, verbose=verbose,
                        device=device)
    row_names, col_names, data = _extract_dimnames(data)
    # NaN detection (R/nmf_validation.R): SVD treats masks as
    # unobserved-zero rather than NaN-aware, so fail loudly instead of
    # returning NaN factors.  Tensors skip the scan (assumed clean, as in
    # nmf()).
    if not isinstance(data, torch.Tensor):
        vals = data.data if hasattr(data, "nnz") else np.asarray(data)
        if np.isnan(np.asarray(vals)).any():
            raise ValueError("data contains NaN/NA values; impute "
                             "them before svd()")

    def pair(x):
        return (x, x) if np.isscalar(x) else tuple(x)

    l1u, l1v = pair(L1)
    l2u, l2v = pair(L2)
    l21u, l21v = pair(L21)
    nnu, nnv = (nonneg, nonneg) if isinstance(nonneg, bool) else tuple(nonneg)
    ubu, ubv = pair(upper_bound)
    angu, angv = pair(angular)
    glu, glv = pair(graph_lambda)
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif robust == "mae":
        # MAE = Huber with a vanishing quadratic zone (R/nmf_thin.R:341-353)
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)

    def _dense_graph(L):
        if L is None:
            return None
        return np.asarray(L.todense() if hasattr(L, "todense") else L,
                          dtype=np.float32)
    aux = {"graph_U": _dense_graph(graph_U), "graph_V": _dense_graph(graph_V)}

    if convergence not in ("factor", "loss", "both"):
        raise ValueError(f"convergence={convergence!r}: use 'factor', "
                         "'loss', or 'both' (svd/gateway.hpp:119-122)")
    if scale and not center:
        center = True      # correlation PCA needs centering (R/svd.R:189)

    # mask parsing (R/svd.R:233-268): None | "zeros" | matrix |
    # ("zeros", matrix)
    mask_zeros = False
    obs_mask = None
    if mask is not None:
        if isinstance(mask, str):
            if mask != "zeros":
                raise ValueError(f"mask string must be 'zeros'; got {mask!r}")
            mask_zeros = True
        elif isinstance(mask, (list, tuple)):
            if len(mask) < 2 or mask[0] != "zeros":
                raise ValueError("mask sequence must be ('zeros', matrix)")
            mask_zeros = True
            obs_mask = mask[1]
        else:
            obs_mask = mask
        if obs_mask is not None:
            if isinstance(obs_mask, torch.Tensor):
                obs_mask = _host(obs_mask)
            if hasattr(obs_mask, "todense"):
                obs_mask = np.asarray(obs_mask.todense())
            obs_mask = np.asarray(obs_mask) != 0
            if obs_mask.shape != tuple(data.shape):
                raise ValueError(
                    f"mask dimensions {obs_mask.shape} must match data "
                    f"{tuple(data.shape)}")

    auto_k = isinstance(k, str) and k == "auto"
    cfg = SVDConfig(
        # auto-rank caps the search at k_max (R/svd.R:181 ``k <- k_max``)
        k=(min(k_max, *data.shape) if auto_k else int(k)),
        tol=tol, max_iter=maxit, center=center, scale=scale, seed=seed,
        oversample=oversample, power_iters=power_iters,
        robust_delta=robust_delta, convergence=convergence,
        u=FC(L1=l1u, L2=l2u, L21=l21u, nonneg=bool(nnu), upper_bound=ubu,
             angular=angu, graph_lambda=glu),
        v=FC(L1=l1v, L2=l2v, L21=l21v, nonneg=bool(nnv), upper_bound=ubv,
             angular=angv, graph_lambda=glv),
        test_fraction=(test_fraction if test_fraction > 0 else
                       (0.05 if auto_k else 0.0)),
        cv_seed=cv_seed, mask_zeros=mask_zeros, patience=patience)

    if auto_k:
        method = "deflation"          # built-in auto-rank
    if method == "auto" and (mask_zeros or obs_mask is not None):
        method = "deflation"          # the only mask-honoring solver
    if method == "auto":
        method = _auto_select_method(cfg, cfg.k)
    if (mask_zeros or obs_mask is not None) and method != "deflation":
        raise ValueError(
            f"mask= is supported by method='deflation' only (got "
            f"{method!r}); the reference's other solvers silently ignore "
            "masks (svd/deflation.hpp is the sole obs_mask consumer)")
    methods = {"lanczos": lanczos_svd, "irlba": irlba_svd,
               "randomized": randomized_svd, "krylov": krylov_svd,
               "deflation": deflation_svd}
    if method not in methods:
        raise ValueError(f"unknown SVD method {method!r}; valid: "
                         f"{sorted(methods)} or 'auto'")
    fn = methods[method]

    # CV is supported by the held-out-aware solvers only (R/svd.R:284,313:
    # cv_methods = deflation, krylov).  Auto-rank requires one of them;
    # for a plain test_fraction the reference silently disables CV — here
    # a warning says so.
    if cfg.test_fraction > 0 and method not in ("deflation", "krylov"):
        if auto_k:
            raise ValueError(f"method {method!r} does not support auto-rank; "
                             "use 'deflation', 'krylov', or method='auto'")
        warnings.warn(f"method {method!r} does not support cross-validation; "
                      "test_fraction ignored (use 'deflation' or 'krylov')")
        cfg = cfg.replace(test_fraction=0.0)

    if mask_zeros and obs_mask is None and cfg.test_fraction <= 0 \
            and not auto_k:
        # reference semantics: mask="zeros" only restricts CV-holdout
        # eligibility (R/svd.R:64-65); without CV it changes nothing
        warnings.warn("svd(mask='zeros') without test_fraction>0 or "
                      "k='auto' has no effect: zeros only restrict CV "
                      "holdout eligibility (R/svd.R:64-65); the fit "
                      "itself treats zeros as observed")

    has_tier2 = (angu > 0 or angv > 0 or
                 aux["graph_U"] is not None or aux["graph_V"] is not None)
    has_elementwise = (bool(nnu) or bool(nnv) or l1u > 0 or l1v > 0 or
                       l2u > 0 or l2v > 0 or l21u > 0 or l21v > 0 or
                       ubu > 0 or ubv > 0)
    # everything that needs no device is checked by now
    dev = fit_device(data, device)
    if method == "deflation":
        res = fn(data, cfg, aux=aux, obs_mask=obs_mask, device=dev)
    elif method == "krylov":
        if cfg.robust_delta > 0:
            warnings.warn("method 'krylov' does not support robust= "
                          "(Huber IRLS); use 'deflation' or method='auto'")
        res = fn(data, cfg, aux=aux, device=dev)
    else:
        # never drop a constraint silently
        if has_tier2 or has_elementwise or cfg.robust_delta > 0:
            dropped = []
            if has_elementwise:
                dropped.append("elementwise constraints "
                               "(nonneg/L1/L2/L21/upper_bound)")
            if has_tier2:
                dropped.append("angular/graph regularization")
            if cfg.robust_delta > 0:
                dropped.append("robust=")
            warnings.warn(f"method {method!r} does not support "
                          f"{'; '.join(dropped)} — ignored (use "
                          "'deflation' or 'krylov')")
        res = fn(data, cfg, device=dev)
    res.misc["method"] = method
    # total-variance denominator for variance_explained()
    # (deflation.hpp:396-417): ||A||^2, minus n*||rowmean||^2 when
    # centered; exactly m*n when scaled (standardized rows)
    if cfg.scale:
        res.misc["frobenius_norm_sq"] = float(data.shape[0]) * float(
            data.shape[1])
    else:
        res.misc["frobenius_norm_sq"] = _frobenius_sq(data, cfg.center)
    res.row_names, res.col_names = row_names, col_names
    if verbose:
        print(f"[svd] method={method} k={res.k_selected or cfg.k} "
              f"iterations={res.iterations} converged={res.converged}")
    return res


def pca(data, k=10, *, center: bool = True, scale: bool = False,
        **kw) -> SVDResult:
    """PCA via truncated SVD of the (implicitly) centered matrix
    (R/svd.R:596 pca wrapper)."""
    res = svd(data, k, center=center, scale=scale, **kw)
    d = np.asarray(res.d)
    # a .spz path has no shape: V has one row per column of A
    n = (np.asarray(res.V).shape[0] if isinstance(data, str)
         else data.shape[1])
    res.misc["sdev"] = d / math.sqrt(max(n - 1, 1))
    return res


# ---------------------------------------------------------------------------
# Streaming SVD over a DataLoader (svd/streaming.hpp:77+): the port of
# rcppml_tpu/models/svd.py:1295-1685
# ---------------------------------------------------------------------------

def _svd_spz(path, k, *, method, center, scale, seed, tol, maxit,
             oversample, power_iters, nonneg, L1, L2, L21, upper_bound,
             angular, graph_U, graph_V, robust, test_fraction, mask,
             convergence, verbose, device):
    """The gateway's ``.spz`` branch: the options streaming supports, the
    method picked as the JAX package picks it, then :func:`streaming_svd`."""
    if (any(np.atleast_1d(L21) != 0) or any(np.atleast_1d(angular) != 0)
            or graph_U is not None or graph_V is not None):
        raise ValueError(
            "streaming .spz SVD supports L1/L2/nonneg/upper_bound/"
            "robust only; decode in-memory (st_read) for L21/angular/"
            "graph regularization")
    if scale or test_fraction > 0 or convergence != "factor" \
            or mask is not None or (isinstance(k, str) and k == "auto"):
        raise ValueError(
            "streaming .spz SVD does not support scale=, "
            "test_fraction=, mask=, convergence=, or k='auto'; "
            "decode in-memory (st_read) for those")
    if method == "auto":
        has_con = (any(np.atleast_1d(L1) != 0) or
                   any(np.atleast_1d(L2) != 0) or
                   any(np.atleast_1d(upper_bound) != 0) or
                   any(np.atleast_1d(nonneg)))
        robust_on = robust if isinstance(robust, bool) else robust > 0
        method = ("deflation" if robust_on else
                  "krylov" if has_con else "randomized")
    res = streaming_svd(
        path, int(k) if not isinstance(k, str) else 10,
        method=method, center=center, seed=seed, oversample=oversample,
        power_iters=power_iters, tol=tol, maxit=maxit,
        nonneg=nonneg, L1=L1, L2=L2, upper_bound=upper_bound,
        robust=robust, device=device)
    if verbose:
        from ..utils import logging as logmod
        logmod.log_summary(
            "[svd] streaming method=%s k=%d iterations=%s converged=%s",
            method, res.k_selected or int(k), res.iterations,
            res.converged, verbose=verbose)
    return res


class _LoaderOp:
    """Chunked product operator: panels of A and A^T stream through the
    device and the products accumulate panel by panel, in panel order; A
    never lives on the device whole (svd/streaming_matvec.hpp analog).

    A streaming SVD drives dozens of products, so panels stay on the device
    across calls when both copies fit the card with headroom (or 4 GiB off
    the card; ``panel_cache`` forces either way), with the decode skipped on
    full hits.  A pass that raises or is abandoned midway leaves nothing
    that a later pass would take for complete."""

    def __init__(self, loader, center=None, panel_cache=None, device=None):
        self.loader = loader
        self.shape = loader.shape
        self.center = center
        self.dev = fit_device(loader, device)
        m, n = loader.shape
        self._cache_ok = (dense_cache_fits(m, n, self.dev)
                          if panel_cache is None else bool(panel_cache))
        self._cache: dict = {}
        self._meta: dict = {False: {}, True: {}}
        self._complete = {False: False, True: False}

    def _panels(self, transpose: bool):
        meta = self._meta[transpose]
        if self._cache_ok and self._complete[transpose]:
            for cs in sorted(meta):
                yield cs, meta[cs], self._cache[(transpose, cs)]
            return
        meta.clear()
        for ch in self.loader.iter_chunks(transpose=transpose):
            meta[ch.col_start] = ch.num_cols
            data = upload(np.ascontiguousarray(ch.data, dtype=np.float32),
                          self.dev)
            if self._cache_ok:
                self._cache[(transpose, ch.col_start)] = data
            yield ch.col_start, ch.num_cols, data
        self._complete[transpose] = self._cache_ok

    def _on_dev(self, X) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            return X.to(self.dev, torch.float32)
        return torch.from_numpy(np.array(X, np.float32, order="C")).to(
            self.dev)

    def mm(self, X):                      # (n, b) -> (m, b)
        m, n = self.shape
        X = self._on_dev(X)
        Y = torch.zeros((m, X.shape[1]), dtype=torch.float32, device=self.dev)
        for cs, nc, data in self._panels(False):
            Y = Y + data @ X[cs:cs + nc]
        if self.center is not None:
            Y = Y - torch.outer(self.center, X.sum(dim=0))
        return Y

    def rmm(self, X):                     # (m, b) -> (n, b)
        m, n = self.shape
        X = self._on_dev(X)
        Y = torch.zeros((n, X.shape[1]), dtype=torch.float32, device=self.dev)
        # transpose panels are (n, pc) column blocks of A^T; their columns
        # index the m axis, so each contributes panel @ X[rows-of-A block]
        for cs, nc, data in self._panels(True):
            Y = Y + data @ X[cs:cs + nc]
        if self.center is not None:
            Y = Y - torch.outer(
                torch.ones((n,), dtype=torch.float32, device=self.dev),
                self.center @ X)
        return Y

    def mv(self, x):
        return self.mm(x[:, None])[:, 0]

    def rmv(self, x):
        return self.rmm(x[:, None])[:, 0]

    def row_means(self):
        m, n = self.shape
        s = torch.zeros((m,), dtype=torch.float32, device=self.dev)
        for cs, nc, data in self._panels(False):
            s = s + data.sum(dim=1)
        return s / n


def _stream_gkb(op, U, V, alphas, betas, start, v_next, steps):
    """Host-loop Golub-Kahan extension over any mv/rmv operator (the
    streaming analog of :func:`_gkb_extend`, svd/streaming_matvec.hpp),
    with the same full reorthogonalization and breakdown guards; each step
    reads alpha and beta on the host."""
    amax = float(torch.maximum(alphas.max(), betas.max()))
    for j in range(start, steps):
        V[:, j] = v_next
        u = op.mv(v_next)
        u = u - U @ (U.T @ u)
        alpha = float((u * u).sum().sqrt())
        ok_a = alpha > 1e-5 * max(amax, 1e-30)
        if ok_a:
            u = u / max(alpha, 1e-30)
            amax = max(amax, alpha)
        else:
            u = torch.zeros_like(u)
            alpha = 0.0
        U[:, j] = u
        alphas[j] = alpha

        w = op.rmv(u)
        w = w - V @ (V.T @ w)
        beta = float((w * w).sum().sqrt())
        ok_b = ok_a and beta > 1e-5 * max(amax, 1e-30)
        if ok_b:
            v_next = w / max(beta, 1e-30)
            amax = max(amax, beta)
        else:
            v_next = torch.zeros_like(w)
            beta = 0.0
        betas[j] = beta
    return U, V, alphas, betas, v_next


def _irlba_core(op, gkb_extend, m, n, k, work, max_restarts, tol, seed):
    """Augmented implicitly-restarted Lanczos over a host loop (Baglama &
    Reichel; svd/irlba.hpp): the JAX package's ``_irlba_core``, which its
    streaming IRLBA runs.  The projected (work x work) SVDs are float64 on
    the host.  Returns an SVDResult."""
    dev = op.dev
    v = torch.from_numpy(_seed_vector(n, seed)).to(dev)
    U = torch.zeros((m, work), dtype=torch.float32, device=dev)
    V = torch.zeros((n, work), dtype=torch.float32, device=dev)
    alphas = torch.zeros((work,), dtype=torch.float32, device=dev)
    betas = torch.zeros((work,), dtype=torch.float32, device=dev)
    U, V, alphas, betas, v_next = gkb_extend(U, V, alphas, betas, 0, v)
    a = _host(alphas).astype(np.float64)
    b = _host(betas).astype(np.float64)
    B = np.diag(a) + np.diag(b[:-1], 1)
    beta_last = float(b[-1])

    s = None
    restarts = 0
    converged = False
    for restarts in range(1, max_restarts + 1):
        P, s, Qt = np.linalg.svd(B)
        # convergence: residual coupling of the top-k Ritz values
        res = np.abs(beta_last * P[-1, :k])
        if np.all(res < tol * max(s[0], 1e-30)):
            converged = True
            break

        # thick restart: rotate bases, keep k Ritz vectors + new direction
        U_new = U @ _dev(P[:, :k], U)                               # (m, k)
        V_new = V @ _dev(Qt[:k].T, V)                               # (n, k)
        rho = (beta_last * P[-1, :k]).astype(np.float64)            # coupling

        U = torch.zeros((m, work), dtype=torch.float32, device=dev)
        U[:, :k] = U_new
        V = torch.zeros((n, work), dtype=torch.float32, device=dev)
        V[:, :k] = V_new

        # continue: u_{k+1} = A v_next - sum rho_i u_i ; then standard GKB
        u = op.mv(v_next) - U_new @ _dev(rho, U)
        u = u - U @ (U.T @ u)
        alpha_k = float((u * u).sum().sqrt())
        u = u / max(alpha_k, 1e-30)
        U[:, k] = u
        V[:, k] = v_next

        w = op.rmv(u)
        w = w - V @ (V.T @ w)
        beta_k = float((w * w).sum().sqrt())
        v_next2 = w / max(beta_k, 1e-30)

        alphas = torch.zeros((work,), dtype=torch.float32, device=dev)
        alphas[k] = alpha_k
        betas = torch.zeros((work,), dtype=torch.float32, device=dev)
        betas[k] = beta_k
        U, V, alphas, betas, v_next = gkb_extend(
            U, V, alphas, betas, k + 1, v_next2)

        # projected matrix after thick restart:
        #   [ diag(s_k)  rho  0  ]
        #   [    0      alpha_k betas/alphas chain ]
        a = _host(alphas).astype(np.float64)
        b = _host(betas).astype(np.float64)
        B = np.zeros((work, work))
        B[np.arange(k), np.arange(k)] = s[:k]
        B[np.arange(k), k] = rho
        for j in range(k, work):
            B[j, j] = a[j]
            if j + 1 < work:
                B[j, j + 1] = b[j]
        beta_last = float(b[-1])

    P, s, Qt = np.linalg.svd(B)
    Uk = U @ _dev(P[:, :k], U)
    Vk = V @ _dev(Qt[:k].T, V)
    return SVDResult(U=_host(Uk), d=s[:k].astype(np.float32),
                     V=_host(Vk), k_selected=k, converged=converged,
                     iterations=restarts)


def streaming_svd(loader, k: int = 10, *, method: str = "randomized",
                  center: bool = False, seed: int = 0, oversample: int = 10,
                  power_iters: int = 2, tol: float = 1e-5, maxit: int = 0,
                  work: int = 0, nonneg=(False, False), L1=(0.0, 0.0),
                  L2=(0.0, 0.0), upper_bound=(0.0, 0.0),
                  robust=False, device=None) -> SVDResult:
    """Truncated SVD over a DataLoader / ``.spz`` path / host matrix
    without making A whole on the device (svd/streaming.hpp:77+ streams all
    five algorithms; so does this).

    randomized / lanczos / irlba / krylov / deflation.  krylov takes the
    elementwise constraints (nonneg/L1/L2/upper_bound per side); deflation
    also takes robust Huber IRLS.  Every algorithm touches A only through
    chunked panel products (``_LoaderOp``).  ``device``: where the products
    run, the CUDA card by default (``device="cpu"`` for the CPU)."""
    from ..io.loaders import DataLoader, InMemoryLoader, SpzLoader
    if method in ("randomized", "lanczos", "irlba"):
        has_con = (any(np.atleast_1d(L1) != 0) or
                   any(np.atleast_1d(L2) != 0) or
                   any(np.atleast_1d(upper_bound) != 0) or
                   any(np.atleast_1d(nonneg)))
        if has_con:
            warnings.warn(f"streaming method {method!r} does not apply "
                          "elementwise constraints; use 'krylov' or "
                          "'deflation'")
    if isinstance(loader, (str, bytes)):
        loader = SpzLoader(loader)
    elif not isinstance(loader, DataLoader):
        loader = InMemoryLoader(loader)
    m, n = loader.shape
    k = min(k, min(m, n))
    set_fp32_precision()
    op = _LoaderOp(loader, device=device)
    c = None
    if center:
        c = op.row_means()
        op = _LoaderOp(loader, center=c, device=device)
    c_np = _host(c) if c is not None else None
    dev = op.dev

    def pair(x):
        return (x, x) if np.isscalar(x) or isinstance(x, bool) else tuple(x)

    if method == "randomized":
        b = k + min(oversample, min(m, n) - k)
        Omega = (rng_mod.fill_uniform(seed if seed else 12345, n, b)
                 .astype(np.float32) - 0.5)
        Y = op.mm(Omega)
        Q, _ = torch.linalg.qr(Y)
        for _ in range(power_iters):
            Z = op.rmm(Q)
            Qz, _ = torch.linalg.qr(Z)
            Y = op.mm(Qz)
            Q, _ = torch.linalg.qr(Y)
        Bs = op.rmm(Q).T
        Ub, s, Vt = torch.linalg.svd(Bs, full_matrices=False)
        U = Q @ Ub[:, :k]
        return SVDResult(U=_host(U), d=_host(s[:k]), V=_host(Vt[:k].T),
                         k_selected=k, converged=True,
                         iterations=power_iters, center=c_np)

    if method == "lanczos":
        steps = min(min(m, n), max(2 * k + 10, 20))

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        U, V, alphas, betas, _ = _stream_gkb(
            op, zeros(m, steps), zeros(n, steps), zeros(steps), zeros(steps),
            0, torch.from_numpy(_seed_vector(n, seed)).to(dev), steps)
        B = np.diag(_host(alphas).astype(np.float64)) + \
            np.diag(_host(betas).astype(np.float64)[:-1], 1)
        P, s, Qt = np.linalg.svd(B)
        Uk = U @ _dev(P[:, :k], U)
        Vk = V @ _dev(Qt[:k].T, V)
        return SVDResult(U=_host(Uk), d=s[:k].astype(np.float32),
                         V=_host(Vk), k_selected=k, converged=True,
                         iterations=steps, center=c_np)

    if method == "irlba":
        kk = min(k, min(m, n) - 1) if min(m, n) > 1 else 1
        wrk = min(min(m, n), (work if work > 0 else kk + 7))
        max_restarts = maxit if maxit > 0 else 100

        def gkb(U, V, alphas, betas, start, v_next):
            return _stream_gkb(op, U, V, alphas, betas, start, v_next, wrk)

        res = _irlba_core(op, gkb, m, n, kk, wrk, max_restarts, tol, seed)
        res.center = c_np
        return res

    if method == "krylov":
        l1u, l1v = pair(L1)
        l2u, l2v = pair(L2)
        nnu, nnv = pair(nonneg)
        ubu, ubv = pair(upper_bound)
        seed_res = streaming_svd(loader, k, method="lanczos", center=center,
                                 seed=seed, tol=tol, device=device)
        if not (nnu or nnv or l1u > 0 or l1v > 0 or l2u > 0 or l2v > 0):
            return seed_res
        max_passes = maxit if maxit > 0 else max(
            10, 2 * int(math.ceil(math.log2(max(k, 2)))) + 3)
        W = op._on_dev(np.abs(seed_res.U) if nnu else seed_res.U)
        V = op._on_dev(np.abs(seed_res.V) if nnv else seed_res.V)
        d = op._on_dev(seed_res.d)
        passes = 0
        converged = False
        prev_W = None
        for passes in range(1, max_passes + 1):
            W, d = _kspr_half(V, op.mm(V), float(l1u), float(l2u),
                              bool(nnu), float(ubu))
            V, d = _kspr_half(W, op.rmm(W), float(l1v), float(l2v),
                              bool(nnv), float(ubv))
            if prev_W is not None:
                dW = float(torch.linalg.norm(W - prev_W) /
                           (torch.linalg.norm(prev_W) + 1e-30))
                if dW < tol:
                    converged = True
                    break
            prev_W = W
        order = np.argsort(-_host(d), kind="stable")
        return SVDResult(U=_host(W)[:, order], d=_host(d)[order],
                         V=_host(V)[:, order], k_selected=k,
                         converged=converged, iterations=passes, center=c_np)

    if method == "deflation":
        return _stream_deflation(op, k, seed=seed, tol=tol, maxit=maxit,
                                 nonneg=pair(nonneg), L1=pair(L1),
                                 L2=pair(L2), upper_bound=pair(upper_bound),
                                 robust=robust, center=c_np)

    raise ValueError(f"streaming SVD supports 'randomized', 'lanczos', "
                     f"'irlba', 'krylov', 'deflation'; got {method!r}")


def _stream_deflation(op, k_max, *, seed, tol, maxit, nonneg, L1, L2,
                      upper_bound, robust, center) -> SVDResult:
    """Streaming rank-1 ALS deflation (svd/deflation.hpp over
    streaming_matvec.hpp): every access to A is one chunked product; the
    deflation correction uses the stored small factors.  Elementwise
    constraints and robust Huber IRLS; no speckled CV (the holdout is an
    in-memory concept here)."""
    m, n = op.shape
    dev = op.dev
    k_max = min(k_max, min(m, n))
    max_iter = maxit if maxit > 0 else 100
    tol = tol if tol > 0 else 1e-5
    if isinstance(robust, bool):
        robust_delta = 1.345 if robust else 0.0
    elif robust == "mae":
        # MAE = Huber with a vanishing quadratic zone (R/nmf_thin.R:341-353)
        robust_delta = 1e-4
    else:
        robust_delta = float(robust)
    do_robust = robust_delta > 0

    def huber_w(resid):
        ar = resid.abs()
        mad = torch.sort(ar).values[ar.shape[0] // 2]
        scale = torch.where(mad / 0.6745 < float(np.float32(1.2e-5)),
                            torch.ones_like(mad), mad / 0.6745)
        z = ar / scale
        return torch.where(z <= robust_delta, torch.ones_like(z),
                           robust_delta / torch.clamp_min(z, 1e-30))

    U_all = torch.zeros((m, k_max), dtype=torch.float32, device=dev)
    V_all = torch.zeros((n, k_max), dtype=torch.float32, device=dev)
    d_all = torch.zeros((k_max,), dtype=torch.float32, device=dev)
    iters_total = 0
    offset = 0
    seed_i = seed if seed else 42

    def defl_f(x, kk):      # A x - U d V^T x on the deflated operator
        if not kk:
            return op.mv(x)
        return op.mv(x) - (U_all * d_all[None, :]) @ (V_all.T @ x)

    def defl_t(x, kk):
        if not kk:
            return op.rmv(x)
        return op.rmv(x) - (V_all * d_all[None, :]) @ (U_all.T @ x)

    def unit(x):
        return x / torch.clamp_min((x * x).sum().sqrt(), 1e-30)

    d_np = np.zeros((k_max,), np.float32)
    for kk in range(k_max):
        # a fresh sequential random draw per factor, as the in-memory
        # deflation_svd draws
        u = torch.from_numpy(rng_mod.fill_uniform(
            seed_i, m, 1, offset=offset)[:, 0].astype(np.float32)).to(dev)
        offset += m
        if kk > 0:
            u = u - U_all @ (U_all.T @ u)
        u = unit(u)
        tol_k = tol
        if kk > 0 and d_np[0] > 0 and d_np[kk - 1] > 0:
            tol_k = min(tol * d_np[0] / d_np[kk - 1], tol * 100)

        v = torch.zeros((n,), dtype=torch.float32, device=dev)
        u_prev = u
        sigma = 0.0
        it = 0
        for it in range(max_iter):
            beta = 0.0 if do_robust else (
                (it - 1.0) / (it + 2.0) if it > 1 else 0.0)
            u_hat = u + beta * (u - u_prev)
            u_prev = u
            if do_robust and it > 0:
                rw = huber_w(defl_f(v, kk) - sigma * u)
                cw = huber_w(defl_t(u, kk) - sigma * v)
                wu = u_hat * rw
                w = defl_t(wu, kk)
                u_sq_w = float((wu * u_hat).sum())
            else:
                w = defl_t(u_hat, kk)
                u_sq_w = float((u_hat * u_hat).sum())
            v = w / max(u_sq_w, 1e-30)
            u_sq = float((u_hat * u_hat).sum())
            v = _apply_reg_vec(v, L1[1], L2[1], nonneg[1], upper_bound[1],
                               u_sq, 0.0)
            sv = float((v * v).sum().sqrt())
            if sv <= 0:
                break
            v = v / sv
            if do_robust and it > 0:
                wv = v * cw
                w2 = defl_f(wv, kk)
                v_sq_w = float((wv * v).sum())
            else:
                w2 = defl_f(v, kk)
                v_sq_w = float((v * v).sum())
            u = w2 / max(v_sq_w, 1e-30)
            v_sq = float((v * v).sum())
            u = _apply_reg_vec(u, L1[0], L2[0], nonneg[0], upper_bound[0],
                               v_sq, 0.0)
            sigma = float((u * u).sum().sqrt())
            if sigma <= 0:
                break
            u = u / sigma
            cd = 1.0 - abs(float((u * u_prev).sum()))
            if cd < tol_k:
                it += 1
                break
        iters_total += it

        constrained = (nonneg[0] or nonneg[1] or L1[0] > 0 or L1[1] > 0 or
                       L2[0] > 0 or L2[1] > 0 or
                       upper_bound[0] > 0 or upper_bound[1] > 0)
        if kk > 0 and not constrained:
            for _ in range(2):
                u = u - U_all @ (U_all.T @ u)
                v = v - V_all @ (V_all.T @ v)
            u = unit(u)
            v = unit(v)
        sigma = abs(float(u @ defl_f(v, kk)))
        U_all[:, kk] = u
        V_all[:, kk] = v
        d_all[kk] = sigma
        d_np[kk] = sigma

    return SVDResult(U=_host(U_all), d=d_np, V=_host(V_all),
                     k_selected=k_max, converged=True,
                     iterations=iters_total, center=center)
