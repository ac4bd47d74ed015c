"""Alternating-least-squares NMF: the dense MSE fit loop.

The port of ``rcppml_tpu/models/nmf.py`` (``:43-218, 525-570, 636-687,
718-744``).  Each iteration mirrors fit_cpu.hpp:444-1825:

  H-update (gram(W_T) -> rhs -> features -> solve -> posthoc -> normalize)
  -> W-update (the same on A^T) -> saved-matrix Gram-trick loss ->
  relative-tolerance patience convergence.

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here
it is a Python loop over tensors that stay on the fit's device.  The only
per-iteration read on the host is the convergence test, and a fit with
``tol == 0`` skips it: ``rel < 0`` is never true, so such a fit cannot
converge early and needs no sync until the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import rng as rng_mod
from ..config import NMFConfig, Solver
from ..device import set_fp32_precision
from ..ops import features as feat
from ..ops import linalg, solvers
from ..result import NMFResult


@dataclass
class FitState:
    W_T: torch.Tensor          # (k, m) transposed storage (fit_cpu.hpp:24-26)
    H: torch.Tensor            # (k, n)
    d: torch.Tensor            # (k,)
    it: int                    # completed iterations (counted on the host)
    prev_loss: torch.Tensor    # 0-d
    patience_ctr: torch.Tensor  # 0-d int32
    converged: torch.Tensor    # 0-d bool
    final_tol: torch.Tensor    # 0-d
    loss_hist: torch.Tensor    # (max_iter,), NaN-padded


def unported(what: str, item: str) -> NotImplementedError:
    """The error every branch that is not ported yet raises."""
    return NotImplementedError(
        f"{what} is not ported to rcppml_tpu_torch yet (ROADMAP.md, {item}); "
        "use rcppml_tpu for it")


def check_ported(cfg: NMFConfig) -> None:
    """Raise NotImplementedError for every config branch this slice lacks."""
    if cfg.requires_irls():
        raise unported(f"loss={cfg.loss.value!r} / robust (IRLS)",
                       "Queue 1 item 6")
    if cfg.is_cv() or cfg.has_mask or cfg.mask_zeros:
        raise unported("cross-validation and masked fits", "Queue 1 item 7")
    if cfg.fused_vmem:
        raise unported("fused_vmem", "Queue 2 kernel 3")
    if cfg.bf16_data:
        raise unported("bf16_data", "Queue 1 item 4")
    if cfg.enable_profiling:
        raise unported("profile=True", "Queue 1 item 4")
    if cfg.init_mode in (1, 2):
        raise unported("SVD-seeded init (seed='lanczos'/'irlba')",
                       "Queue 1 item 4, after item 9")


# ---------------------------------------------------------------------------
# Solve dispatch (fit_cpu.hpp:577-637 solver branches)
# ---------------------------------------------------------------------------

def _solve(cfg: NMFConfig, G, B, X_warm, fc, it: int):
    """NNLS solve for one factor side.

    L1/L2 are already in (G, B) from apply_features, so the solvers run with
    zero penalties (fit_cpu.hpp:622-637).  CD warm-starts only after the
    first iteration (reference ``iter > 0``).
    """
    if cfg.solver == Solver.CHOLESKY:
        return solvers.cholesky_clip_batch(G, B, nonneg=fc.nonneg)
    X0 = X_warm * float(it > 0)
    B_res = B - G @ X0
    return solvers.cd_nnls_batch_traced(
        G, B_res, X0, 0.0, nonneg=fc.nonneg,
        maxit=cfg.cd_max_iter, cd_tol=cfg.cd_tol)


def _posthoc(X, fc):
    """Post-NNLS upper bound + angular decorrelation (fit_cpu.hpp:637-645)."""
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    if fc.angular > 0:
        X = feat.apply_angular_posthoc(X, fc.angular)
    return X


def make_updates(cfg: NMFConfig, aux: dict):
    """Build the H-update / W-update / loss functions for one config
    (standard, projective and symmetric variants)."""
    graph_W = aux.get("graph_W")
    graph_H = aux.get("graph_H")
    target_H = aux.get("target_H")
    target_H_gram = aux.get("target_H_gram")
    target_W = aux.get("target_W")
    target_W_gram = aux.get("target_W_gram")
    use_saved_loss = not (cfg.projective or cfg.symmetric)

    def h_update(A, W_T, H, d, it):
        if cfg.projective:
            # H = diag(d) . W_T . A, no solve (variant_helpers.hpp:321-338)
            H_new = linalg.rhs(W_T * d[:, None], A)
            return linalg.extract_scaling(H_new, cfg.norm)
        if cfg.symmetric:
            return H, d  # set after W-update (variant_helpers.hpp:56)
        G = linalg.gram(W_T)
        B = linalg.rhs(W_T, A)
        G, B = feat.apply_features(G, B, H, cfg.H, graph=graph_H,
                                   target=target_H, target_gram=target_H_gram)
        H_new = _posthoc(_solve(cfg, G, B, H, cfg.H, it), cfg.H)
        return linalg.extract_scaling(H_new, cfg.norm)

    def w_update(A, W_T, H, d, it):
        """Returns (W_T, H, d, B_w_saved, G_w_saved)."""
        if cfg.symmetric:
            # A ~ W'.diag(d).W — one update on the W side (fit_cpu.hpp:657-705)
            G = linalg.gram(W_T)
            B = linalg.rhs(W_T, A)
            G, B = feat.apply_features(G, B, W_T, cfg.W, graph=graph_W,
                                       target=target_W,
                                       target_gram=target_W_gram)
            W_new = _posthoc(_solve(cfg, G, B, W_T, cfg.W, it), cfg.W)
            W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)
            return W_new, W_new, d_new, None, None
        G_w = linalg.gram(H)                                   # saved pre-features
        B_w = linalg.rhs(H, A.T)                               # saved pre-features
        G, B = feat.apply_features(G_w, B_w, W_T, cfg.W, graph=graph_W,
                                   target=target_W, target_gram=target_W_gram)
        W_new = _posthoc(_solve(cfg, G, B, W_T, cfg.W, it), cfg.W)
        W_new, d_new = linalg.extract_scaling(W_new, cfg.norm)
        return W_new, H, d_new, B_w, G_w

    def compute_loss(trAtA, A, W_T, H, d, B_w, G_w):
        if use_saved_loss:
            # saved-matrix Gram-trick loss (fit_cpu.hpp:1710-1753)
            return linalg.mse_loss_from_saved(trAtA, W_T, d, B_w, G_w)
        W_Td = W_T * d[:, None]
        return linalg.gram_trick_loss(trAtA, linalg.gram(W_Td),
                                      linalg.rhs(W_Td, A), H)

    return h_update, w_update, compute_loss


def init_fit_state(cfg: NMFConfig, W_T0, H0, d0, *,
                   device) -> FitState:
    """The state before the first iteration, on ``device``."""
    f32 = torch.float32

    def dev(x):
        # contiguous, as every later factor is: the layout of a matmul's
        # operands selects its kernel, and with it the rounding
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    return FitState(
        W_T=dev(W_T0), H=dev(H0), d=dev(d0), it=0,
        prev_loss=torch.tensor(torch.finfo(f32).max, dtype=f32, device=device),
        patience_ctr=torch.zeros((), dtype=torch.int32, device=device),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        final_tol=torch.tensor(float("nan"), dtype=f32, device=device),
        loss_hist=torch.full((cfg.max_iter,), float("nan"), dtype=f32,
                             device=device),
    )


def fit_mse(cfg: NMFConfig, A: torch.Tensor, state: FitState,
            aux: Optional[dict] = None) -> FitState:
    """Run the dense MSE ALS loop from ``state`` to convergence or
    ``cfg.max_iter`` (the port of ``_fit_mse`` / ``_mse_loop``)."""
    h_update, w_update, compute_loss = make_updates(cfg, aux or {})
    trAtA = (A * A).sum()                 # tr(A'A) once (fit_cpu.hpp:224)
    W_T, H, d, it = state.W_T, state.H, state.d, state.it
    prev_loss, patience_ctr = state.prev_loss, state.patience_ctr
    converged, final_tol = state.converged, state.final_tol
    loss_hist = state.loss_hist.clone()
    # with tol == 0, rel < tol never holds: no host read per iteration
    check_each_iteration = cfg.tol > 0
    while it < cfg.max_iter:
        H, d = h_update(A, W_T, H, d, it)
        W_T, H, d, B_w, G_w = w_update(A, W_T, H, d, it)
        loss = compute_loss(trAtA, A, W_T, H, d, B_w, G_w)

        # relative-tolerance + patience convergence (fit_cpu.hpp:1770-1809)
        rel = (prev_loss - loss).abs() / (prev_loss.abs() + 1e-15)
        loss_conv = (rel < cfg.tol) & (it > 0)
        patience_ctr = torch.where(loss_conv, patience_ctr + 1,
                                   torch.zeros_like(patience_ctr))
        converged = patience_ctr >= cfg.patience
        if it > 0:
            final_tol = rel
        loss_hist[it] = loss                  # in place: no sync
        prev_loss = loss
        it += 1
        if check_each_iteration and bool(converged):
            break
    return FitState(W_T, H, d, it, prev_loss, patience_ctr, converged,
                    final_tol, loss_hist)


# ---------------------------------------------------------------------------
# Initialization (nmf/nmf_init.hpp, fit_cpu.hpp:195-218)
# ---------------------------------------------------------------------------

def init_factors(cfg: NMFConfig, m: int, n: int,
                 w_init: Optional[np.ndarray] = None,
                 h_init: Optional[np.ndarray] = None,
                 dtype=np.float32):
    """Build (W_T0 (k,m), H0 (k,n), d0 (k,)) on the host.

    Random init reproduces the reference's sequential SplitMix64 column-major
    fill: W_T first (k*m draws), then H (the next k*n draws)
    (nmf_init.hpp:167-186), bit for bit with ``rcppml_tpu``.  As there, an
    ``h_init`` without a ``w_init`` is ignored.
    """
    k = cfg.rank
    d0 = np.ones((k,), dtype=dtype)
    if w_init is not None:
        W_T = np.ascontiguousarray(np.asarray(w_init, dtype=dtype).T)
        if h_init is not None:
            H = np.asarray(h_init, dtype=dtype)
        else:
            H = rng_mod.fill_uniform(cfg.seed if cfg.seed != 0 else 12345,
                                     k, n, dtype=dtype)
        return W_T, H, d0
    if cfg.init_mode in (1, 2):
        raise unported("SVD-seeded init (seed='lanczos'/'irlba')",
                       "Queue 1 item 4, after item 9")
    W_T = rng_mod.fill_uniform(cfg.seed, k, m, dtype=dtype)
    H = rng_mod.fill_uniform(cfg.seed, k, n, offset=k * m, dtype=dtype)
    return W_T, H, d0


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def nmf_fit(A, cfg: NMFConfig, *, w_init=None, h_init=None,
            aux: Optional[dict] = None, device=None) -> NMFResult:
    """Fit NMF on a dense matrix.

    ``A``: an (m, n) numpy array or tensor, used as float32.  ``device``:
    where the fit runs; by default a tensor's own device, and the CPU for a
    host array.  ``aux``: optional dense auxiliary arrays (``graph_W``,
    ``graph_H``, ``target_H``/``target_W`` and their ``*_gram``).
    """
    cfg.validate()
    check_ported(cfg)
    set_fp32_precision()
    if isinstance(A, torch.Tensor):
        A_dev = A.to(device=device if device is not None else A.device,
                     dtype=torch.float32)
    else:
        # a copy: the fit never writes A, but torch refuses read-only arrays
        A_dev = torch.from_numpy(np.array(A, dtype=np.float32)).to(
            device if device is not None else "cpu")
    if A_dev.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    m, n = A_dev.shape
    if cfg.rank > min(m, n):
        raise ValueError(f"rank {cfg.rank} exceeds min(dim) = {min(m, n)}")

    W_T0, H0, d0 = init_factors(cfg, m, n, w_init=w_init, h_init=h_init)
    state = init_fit_state(cfg, W_T0, H0, d0, device=A_dev.device)
    aux_dev = {key: torch.as_tensor(np.asarray(val, np.float32)
                                    if not isinstance(val, torch.Tensor)
                                    else val).to(A_dev.device, torch.float32)
               for key, val in (aux or {}).items() if val is not None}
    return finalize_result(cfg, fit_mse(cfg, A_dev, state, aux_dev))


def finalize_result(cfg: NMFConfig, state: FitState) -> NMFResult:
    """Copy a FitState to a host NMFResult (fit_cpu.hpp:1827-1854)."""
    def host(t):
        return t.detach().cpu().numpy()

    it = state.it
    res = NMFResult(
        W=host(state.W_T).T,
        d=host(state.d),
        H=host(state.H),
        iterations=it,
        converged=bool(state.converged),
        final_tol=float(state.final_tol),
        train_loss=float(state.prev_loss) if it > 0 else float("nan"),
        loss_history=host(state.loss_hist)[:it]
        if cfg.track_loss_history else None,
    )
    if cfg.sort_model:
        res.sort()
    return res
