"""Distribution math: IRLS weights, NLL/deviance contributions, variance.

The port of ``rcppml_tpu/ops/losses.py``, itself the vectorized form of
``inst/include/FactorNet/math/loss.hpp``.  Every function works elementwise
on (m, n) tensors (mu = predicted mean), in float32 with the reference's
clamps.  ``theta`` may be any tensor that broadcasts against ``A``: a
(m, 1) or (1, n) view is enough, nothing is expanded in memory.
"""

from __future__ import annotations

import torch

from ..config import Loss, NMFConfig

_W_CAP = 1e6


def _expand_theta(theta_row, theta_col, like: torch.Tensor) -> torch.Tensor:
    """Per-row / per-column dispersion as a view that broadcasts to (m, n);
    a 0-d zero when neither is given."""
    if theta_col is not None:
        return theta_col[None, :]
    if theta_row is not None:
        return theta_row[:, None]
    return torch.zeros((), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# IRLS weights (loss.hpp:150-303)
# ---------------------------------------------------------------------------

def irls_weight_kl(mu):
    """w = 1 / max(mu, 1e-4) (loss.hpp:177-179)."""
    return 1.0 / torch.clamp_min(mu, 1e-4)


def irls_weight_gp(y, mu, theta, blend=1.0):
    """Fisher-information GP weight with adaptive KL blend (loss.hpp:198-229)."""
    s = torch.clamp_min(mu, 1e-15)
    eff_blend = blend * torch.clamp_max(s, 1.0)
    w_gp = 1.0 / (s * s)
    denom = torch.clamp_min(s + theta * y, 1e-15)
    w_gp = w_gp + torch.where(y >= 1.0, (y - 1.0) / (denom * denom),
                              torch.zeros_like(s))
    log_w_kl = -torch.log(s)
    log_w_gp = torch.log(torch.clamp_min(w_gp, 1e-30))
    w = torch.exp((1.0 - eff_blend) * log_w_kl + eff_blend * log_w_gp)
    return torch.clamp_max(w, _W_CAP)


def irls_weight_nb(mu, r):
    """w = r / (mu (r + mu)) (loss.hpp:249-256)."""
    mu = torch.clamp_min(mu, 1e-15)
    r = torch.clamp_min(r, 1e-10)
    return torch.clamp_max(r / (mu * (r + mu)), _W_CAP)


def irls_weight_power(mu, p: float):
    """w = 1 / mu^p for V(mu) = mu^p families (loss.hpp:271-277)."""
    mu = torch.clamp_min(mu, 1e-15)
    return torch.clamp_max(mu ** (-p), _W_CAP)


def variance_fn(mu, cfg: NMFConfig, theta):
    """V(mu) per distribution (loss.hpp:560-590)."""
    mu = torch.clamp_min(mu, 1e-10)
    if cfg.loss in (Loss.GP, Loss.KL):
        return mu
    if cfg.loss == Loss.NB:
        r = torch.clamp_min(theta, 1e-10)
        return mu + mu * mu / r
    if cfg.loss == Loss.GAMMA:
        return mu * mu
    if cfg.loss == Loss.INVGAUSS:
        return mu * mu * mu
    if cfg.loss == Loss.TWEEDIE:
        return mu ** cfg.tweedie_power
    return torch.ones_like(mu)          # Gaussian


def compute_irls_weight(A, mu, cfg: NMFConfig, theta):
    """Distribution weight x optional Huber-on-Pearson robust modifier
    (nnls_batch_irls.hpp:96-122).  ``theta`` broadcasts against ``A``.
    """
    loss = cfg.loss
    if loss == Loss.KL:
        w = irls_weight_kl(mu)
    elif loss == Loss.GP:
        w = irls_weight_gp(A, mu, theta, blend=cfg.gp_blend)
    elif loss == Loss.NB:
        w = irls_weight_nb(mu, theta)
    elif loss == Loss.GAMMA:
        w = irls_weight_power(mu, 2.0)
    elif loss == Loss.INVGAUSS:
        w = irls_weight_power(mu, 3.0)
    elif loss == Loss.TWEEDIE:
        w = irls_weight_power(mu, cfg.tweedie_power)
    else:
        w = torch.ones_like(mu)         # MSE (robust-only path)

    if cfg.robust_delta > 0:
        # Pearson residual via sqrt of distribution weight
        sd_inv = torch.sqrt(torch.clamp_min(w, 1e-15))
        pearson = (A - mu) * sd_inv
        abs_p = pearson.abs()
        w_rob = torch.where(abs_p <= cfg.robust_delta,
                            torch.ones_like(abs_p),
                            cfg.robust_delta / (abs_p + 1e-15))
        w = w * w_rob
    return w


# ---------------------------------------------------------------------------
# Loss contributions (loss.hpp:312-500)
# ---------------------------------------------------------------------------

def loss_mse(y, mu):
    d = y - mu
    return d * d


def loss_kl(y, mu, eps=1e-10):
    y = torch.clamp_min(y, eps)
    mu = torch.clamp_min(mu, eps)
    return y * torch.log(y / mu) - y + mu


def loss_gp(y, mu, theta):
    """GP NLL up to log(y!) (loss.hpp:383-398)."""
    s = torch.clamp_min(mu, 1e-10)
    otp = 1.0 + theta
    out = -torch.log(s / otp)
    inner = torch.clamp_min((s + theta * y) / otp, 1e-10)
    out = out - torch.where(y >= 1.0, (y - 1.0) * torch.log(inner),
                            torch.zeros_like(s))
    return out + (s + theta * y) / otp


def loss_nb(y, mu, r):
    """NB NLL up to lgamma(y+1) (loss.hpp:416-426).

    For large r (near-Poisson genes saturate the nb_size_max = 1e6 cap) the
    direct form cancels catastrophically in float32: lgamma(1e6) ~ 1.29e7
    has an ulp of about 1, so lgamma(y+r) - lgamma(r) carries O(1) absolute
    error per entry.  Beyond r = 300 the Stirling form in log1p terms of
    small arguments is used instead:

      NLL = (y+r)*log1p(mu/r) - (r+y-1/2)*log1p(y/r) + y - y*log(mu)

    which tends to the Poisson NLL  mu - y*log(mu)  as r -> inf.
    """
    mu = torch.clamp_min(mu, 1e-10)
    r = torch.clamp_min(r, 1e-10)
    direct = (-torch.lgamma(y + r) + torch.lgamma(r)
              - r * torch.log(r / (r + mu)) - y * torch.log(mu / (r + mu)))
    stable = ((y + r) * torch.log1p(mu / r)
              - (r + y - 0.5) * torch.log1p(y / r) + y - y * torch.log(mu))
    return torch.where(r > 300.0, stable, direct)


def loss_gamma(y, mu):
    y = torch.clamp_min(y, 1e-10)
    mu = torch.clamp_min(mu, 1e-10)
    return 2.0 * (-torch.log(y / mu) + (y - mu) / mu)


def loss_invgauss(y, mu):
    y = torch.clamp_min(y, 1e-10)
    mu = torch.clamp_min(mu, 1e-10)
    d = y - mu
    return d * d / (mu * mu * y)


def loss_tweedie(y, mu, p: float):
    """Tweedie power deviance with p~1 / p~2 special cases (loss.hpp:480-500)."""
    y = torch.clamp_min(y, 1e-10)
    mu = torch.clamp_min(mu, 1e-10)
    if abs(p - 1.0) < 1e-6:
        return 2.0 * (y * torch.log(y / mu) - (y - mu))
    if abs(p - 2.0) < 1e-6:
        return loss_gamma(y, mu)
    omp, tmp = 1.0 - p, 2.0 - p
    return 2.0 * (y ** tmp / (omp * tmp) - y * mu ** omp / omp
                  + mu ** tmp / tmp)


def compute_loss_elements(A, mu, cfg: NMFConfig, theta):
    """Per-element loss (deviance/NLL); Huber-on-Pearson if robust
    (loss.hpp:505-599).  ``theta`` broadcasts against ``A``."""
    if cfg.robust_delta > 0:
        mu_c = torch.clamp_min(mu, 1e-10)
        var = variance_fn(mu_c, cfg, theta)
        sd = torch.sqrt(torch.clamp_min(var, 1e-20))
        pr = (A - mu_c) / sd
        abs_pr = pr.abs()
        delta = cfg.robust_delta
        return torch.where(abs_pr <= delta, 0.5 * pr * pr,
                           delta * abs_pr - 0.5 * delta * delta)
    loss = cfg.loss
    if loss == Loss.MSE:
        return loss_mse(A, mu)
    if loss == Loss.KL:
        return loss_kl(A, mu)
    if loss == Loss.GP:
        return loss_gp(A, mu, theta)
    if loss == Loss.NB:
        return loss_nb(A, mu, theta)
    if loss == Loss.GAMMA:
        return loss_gamma(A, mu)
    if loss == Loss.INVGAUSS:
        return loss_invgauss(A, mu)
    if loss == Loss.TWEEDIE:
        return loss_tweedie(A, mu, cfg.tweedie_power)
    raise ValueError(f"unknown loss {loss}")


def explicit_loss(A, W_Td, H, cfg: NMFConfig, theta_row=None, theta_col=None,
                  nz_only: bool = False):
    """Explicit loss over all (dense) or nonzero (sparse-semantics) entries
    (nmf/explicit_loss.hpp:54-107).  Returns a 0-d tensor."""
    mu = W_Td.T @ H
    theta = _expand_theta(theta_row, theta_col, A)
    contrib = compute_loss_elements(A, mu, cfg, theta)
    if nz_only:
        contrib = torch.where(A != 0, contrib, torch.zeros_like(contrib))
    return contrib.sum()
