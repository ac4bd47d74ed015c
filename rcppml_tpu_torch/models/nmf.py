"""Alternating-least-squares NMF: the entry point and the dense MSE fits.

The port of ``rcppml_tpu/models/nmf.py``: the fit loop (``:43-218``), the
whole-fit Newton-Schulz path (``_fit_fused_vmem``, ``:315-346``), the step
mode with callbacks and the profiled fit (``:365-518``), the initial factors
(``:525-570``), multi-restart (``:600-616``) and the entry point
(``:636-744``).
Each iteration of the loop mirrors fit_cpu.hpp:444-1825:

  H-update (gram(W_T) -> rhs -> features -> solve -> posthoc -> normalize)
  -> W-update (the same on A^T) -> saved-matrix Gram-trick loss ->
  relative-tolerance patience convergence.

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here
it is a Python loop over tensors that stay on the fit's device.  The only
per-iteration read on the host is the convergence test, and a fit with
``tol == 0`` skips it: ``rel < 0`` is never true, so such a fit cannot
converge early and needs no sync until the end.  With ``fused_vmem`` the
whole fit is one call into ``ops/fused_als.py``.

Under a profiler the default fit opens ``rtt.fit.prepare`` (the matrix and
starting state on the device), ``rtt.loop`` with each iteration's
``rtt.fit.h_update``, ``rtt.fit.w_update`` and ``rtt.fit.loss``, and
``rtt.fit.finalize`` (``utils/trace.py``), adding no wait; its
``res.misc["host_syncs"]`` counts every synchronizing call it makes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import rng as rng_mod
from ..config import NMFConfig, Solver
from ..device import set_fp32_precision
from ..ops import features as feat
from ..ops import fused_als as fused_mod
from ..ops import linalg, solvers
from ..parallel.mesh import NO_AXIS
from ..result import NMFResult
from ..utils.trace import Syncs, span


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


def _posthoc(X, fc, axis=NO_AXIS):
    """Post-NNLS upper bound + angular decorrelation (fit_cpu.hpp:637-645)."""
    if fc.upper_bound > 0:
        X = feat.apply_upper_bound(X, fc.upper_bound)
    if fc.angular > 0:
        X = feat.apply_angular_posthoc(X, fc.angular, axis)
    return X


def make_updates(cfg: NMFConfig, aux: dict, ctx=None):
    """Build the H-update / W-update / loss functions for one config
    (standard, projective and symmetric variants).

    ``ctx``: a ``parallel.mesh.ShardContext`` when A, W_T and H are one
    rank's blocks of a sharded fit: the H side's Gram and RHS sum over
    "rows", the W side's over "cols", each factor's row norms over its own
    axis, the loss over both.  Without it every sum is the local one."""
    graph_W = aux.get("graph_W")
    graph_H = aux.get("graph_H")
    target_H = aux.get("target_H")
    target_H_gram = aux.get("target_H_gram")
    target_W = aux.get("target_W")
    target_W_gram = aux.get("target_W_gram")
    use_saved_loss = not (cfg.projective or cfg.symmetric)
    rows = ctx.rows if ctx is not None else NO_AXIS  # W_T's columns
    cols = ctx.cols if ctx is not None else NO_AXIS  # H's columns

    def h_update(A, W_T, H, d, it):
        if cfg.projective:
            # H = diag(d) . W_T . A, no solve (variant_helpers.hpp:321-338)
            H_new = rows.sum(linalg.rhs(W_T * d[:, None], A))
            return linalg.extract_scaling(H_new, cfg.norm, cols)
        if cfg.symmetric:
            return H, d  # set after W-update (variant_helpers.hpp:56)
        G = linalg.gram(W_T, rows)
        B = rows.sum(linalg.rhs(W_T, A))
        G, B = feat.apply_features(G, B, H, cfg.H, graph=graph_H,
                                   target=target_H, target_gram=target_H_gram,
                                   axis=cols)
        H_new = _posthoc(_solve(cfg, G, B, H, cfg.H, it), cfg.H, cols)
        return linalg.extract_scaling(H_new, cfg.norm, cols)

    def w_update(A, W_T, H, d, it):
        """Returns (W_T, H, d, B_w_saved, G_w_saved)."""
        if cfg.symmetric:
            # A ~ W'.diag(d).W — one update on the W side
            # (fit_cpu.hpp:657-705); the solve is over A's columns, so under
            # a mesh the new factor is split over "cols" and its row blocks
            # are gathered from it
            G = linalg.gram(W_T, rows)
            B = rows.sum(linalg.rhs(W_T, A))
            G, B = feat.apply_features(G, B, W_T, cfg.W, graph=graph_W,
                                       target=target_W,
                                       target_gram=target_W_gram, axis=rows)
            W_new = _posthoc(_solve(cfg, G, B, H, cfg.W, it), cfg.W, cols)
            W_new, d_new = linalg.extract_scaling(W_new, cfg.norm, cols)
            W_rows = W_new if ctx is None else ctx.cols_to_rows(W_new)
            return W_rows, W_new, d_new, None, None
        G_w = linalg.gram(H, cols)                     # saved pre-features
        B_w = cols.sum(linalg.rhs(H, A.T))             # saved pre-features
        G, B = feat.apply_features(G_w, B_w, W_T, cfg.W, graph=graph_W,
                                   target=target_W, target_gram=target_W_gram,
                                   axis=rows)
        W_new = _posthoc(_solve(cfg, G, B, W_T, cfg.W, it), cfg.W, rows)
        W_new, d_new = linalg.extract_scaling(W_new, cfg.norm, rows)
        return W_new, H, d_new, B_w, G_w

    def compute_loss(trAtA, A, W_T, H, d, B_w, G_w):
        if use_saved_loss:
            # saved-matrix Gram-trick loss (fit_cpu.hpp:1710-1753)
            loss = linalg.mse_loss_from_saved(trAtA, W_T, d, B_w, G_w, rows)
        else:
            W_Td = W_T * d[:, None]
            loss = linalg.gram_trick_loss(
                trAtA, linalg.gram(W_Td, rows),
                rows.sum(linalg.rhs(W_Td, A)), H, cols)
        # every rank takes rank 0's value: the convergence test reads it
        return loss if ctx is None else ctx.agree(loss)

    return h_update, w_update, compute_loss


def init_fit_state(cfg: NMFConfig, W_T0, H0, d0, *,
                   device, syncs: Optional[Syncs] = None) -> FitState:
    """The state before the first iteration, on ``device``; ``syncs``
    counts its uploads (each factor and each starting scalar)."""
    f32 = torch.float32
    device = torch.device(device)
    syncs = syncs if syncs is not None else Syncs()

    def dev(x):
        # contiguous, as every later factor is: the layout of a matmul's
        # operands selects its kernel, and with it the rounding; a copy,
        # because torch refuses read-only arrays
        return syncs.to(torch.from_numpy(np.array(x, np.float32, order="C")),
                        device)

    return FitState(
        W_T=dev(W_T0), H=dev(H0), d=dev(d0), it=0,
        prev_loss=dev(torch.finfo(f32).max),
        patience_ctr=torch.zeros((), dtype=torch.int32, device=device),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        final_tol=dev(float("nan")),
        loss_hist=torch.full((cfg.max_iter,), float("nan"), dtype=f32,
                             device=device),
    )


def loop_operands(cfg: NMFConfig, A: torch.Tensor, ctx=None):
    """What the loop needs of A: tr(A'A), always from the float32 matrix
    (fit_cpu.hpp:224; under a mesh summed over every block), and the matrix
    its products read, bfloat16 with ``bf16_data`` (half the bytes of the
    dominant operand; the loss bookkeeping stays float32)."""
    trAtA = (A * A).sum()
    if ctx is not None:
        trAtA = ctx.sum_all(trAtA)
    return trAtA, (A.to(torch.bfloat16) if cfg.bf16_data else A)


def fit_mse(cfg: NMFConfig, A: torch.Tensor, state: FitState,
            aux: Optional[dict] = None, seg_end: Optional[int] = None,
            operands=None, ctx=None,
            syncs: Optional[Syncs] = None) -> FitState:
    """Run the dense MSE ALS loop from ``state`` to convergence or
    ``cfg.max_iter`` (the port of ``_fit_mse`` / ``_mse_loop``).  With
    ``seg_end`` the loop stops after that many iterations in all, and a later
    call carries on from the returned state (``_fit_mse_seg``);
    ``operands`` is :func:`loop_operands` of A, for a caller that runs many
    segments.  ``ctx``: the ``parallel.mesh.ShardContext`` of a sharded fit,
    whose A and state are this rank's blocks (:func:`make_updates`).
    ``syncs`` counts the convergence test's reads (one an iteration with
    ``tol > 0``)."""
    syncs = syncs if syncs is not None else Syncs()
    h_update, w_update, compute_loss = make_updates(cfg, aux or {}, ctx)
    trAtA, A = (operands if operands is not None
                else loop_operands(cfg, A, ctx))
    bound = cfg.max_iter if seg_end is None else min(seg_end, cfg.max_iter)
    W_T, H, d, it = state.W_T, state.H, state.d, state.it
    prev_loss, patience_ctr = state.prev_loss, state.patience_ctr
    converged, final_tol = state.converged, state.final_tol
    loss_hist = state.loss_hist.clone()
    # with tol == 0, rel < tol never holds: no host read per iteration
    check_each_iteration = cfg.tol > 0
    with span("rtt.loop"):
        while it < bound and not (check_each_iteration
                                  and bool(syncs.host(converged))):
            with span("rtt.fit.h_update"):
                H, d = h_update(A, W_T, H, d, it)
            with span("rtt.fit.w_update"):
                W_T, H, d, B_w, G_w = w_update(A, W_T, H, d, it)
            with span("rtt.fit.loss"):
                loss = compute_loss(trAtA, A, W_T, H, d, B_w, G_w)

                # relative-tolerance + patience convergence
                # (fit_cpu.hpp:1770-1809)
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
    return FitState(W_T, H, d, it, prev_loss, patience_ctr, converged,
                    final_tol, loss_hist)


# ---------------------------------------------------------------------------
# fused_vmem: the whole fit in one call (opt-in)
# ---------------------------------------------------------------------------

def fit_fused_vmem(cfg: NMFConfig, A: torch.Tensor, W_T0, H0) -> NMFResult:
    """The opt-in ``fused_vmem`` path (``_fit_fused_vmem``): the
    whole fixed-``max_iter`` Newton-Schulz ALS in ``ops/fused_als.py``, the
    kernels on the card and the plain twin on the CPU.  ``cfg.validate()``
    has already held this to the dense nonneg MSE fit with tol=0; L1/L2 are
    supported, tier-2 features are not.  A fit beyond the kernel's gate
    raises ``ValueError`` there; nothing falls back to the default loop."""
    def dev(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(
            A.device)

    W_T, H, d, hist = fused_mod.fused_als(
        A, dev(W_T0), dev(H0), maxit=cfg.max_iter, nonneg=True,
        a_bf16=cfg.bf16_data, l1_w=float(cfg.W.L1), l1_h=float(cfg.H.L1),
        l2_w=float(cfg.W.L2), l2_h=float(cfg.H.L2))
    prev = hist[-2] if cfg.max_iter > 1 else hist[-1]
    final_tol = (prev - hist[-1]).abs() / (prev.abs() + 1e-15)
    state = FitState(
        W_T=W_T, H=H, d=d, it=cfg.max_iter, prev_loss=hist[-1],
        patience_ctr=torch.zeros((), dtype=torch.int32, device=A.device),
        converged=torch.zeros((), dtype=torch.bool, device=A.device),
        final_tol=final_tol, loss_hist=hist)
    return finalize_result(cfg, state)


# ---------------------------------------------------------------------------
# Step mode: a host loop with callbacks and per-section times
# ---------------------------------------------------------------------------

def _wait(device: torch.device) -> None:
    """Let the card finish what was enqueued, so that a host clock times it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_stepwise(A: torch.Tensor, cfg: NMFConfig, W_T0, H0, d0, aux, *,
                 on_iteration=None) -> NMFResult:
    """Host-driven ALS loop with a wait after every section.

    Used when the caller wants per-iteration callbacks
    (``on_iteration(iter, train, test)``, config.hpp:388-392; ``test`` is NaN
    here) and gives the section -> milliseconds map ``res.profile``
    (``h_update``, ``w_update``, ``loss``).  Slower than :func:`fit_mse`: the
    host reads the loss every iteration.
    """
    h_update, w_update, compute_loss = make_updates(cfg, aux or {})
    state = init_fit_state(cfg, W_T0, H0, d0, device=A.device)
    W_T, H, d = state.W_T, state.H, state.d
    trAtA, A = loop_operands(cfg, A)
    prof: dict = {}
    hist = []
    prev_loss = np.inf
    patience = 0
    converged = False
    final_tol = float("nan")

    def timed(name, fn):
        _wait(A.device)
        t0 = time.perf_counter()
        out = fn()
        _wait(A.device)
        prof[name] = prof.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    for it in range(cfg.max_iter):
        H, d = timed("h_update", lambda: h_update(A, W_T, H, d, it))
        W_T, H, d, B_w, G_w = timed(
            "w_update", lambda: w_update(A, W_T, H, d, it))
        loss = float(timed("loss", lambda: compute_loss(
            trAtA, A, W_T, H, d, B_w, G_w)))
        hist.append(loss)
        if on_iteration is not None:
            on_iteration(it + 1, loss, float("nan"))
        if it > 0:
            rel = abs(prev_loss - loss) / (abs(prev_loss) + 1e-15)
            final_tol = rel
            if rel < cfg.tol:
                patience += 1
                if patience >= cfg.patience:
                    converged = True
                    prev_loss = loss
                    break
            else:
                patience = 0
        prev_loss = loss

    res = NMFResult(
        W=W_T.cpu().numpy().T, d=d.cpu().numpy(), H=H.cpu().numpy(),
        iterations=len(hist), converged=converged, final_tol=final_tol,
        train_loss=float(prev_loss),
        loss_history=np.asarray(hist, dtype=np.float32), profile=prof)
    if cfg.sort_model:
        res.sort()
    return res


def fit_profiled(A: torch.Tensor, cfg: NMFConfig, W_T0, H0, d0,
                 aux) -> NMFResult:
    """Profile the production loop (profiling/cpu_timer.hpp:31-50).

    Unlike :func:`fit_stepwise`, this runs the loop the unprofiled fit runs,
    :func:`fit_mse`, in segments (the same trajectory bit for bit) and times
    each segment on the host clock.  The section -> ms map keeps its
    contract: the sections are timed once more at the final state (best of
    3) and scaled by the iteration count, estimates of where the loop's time
    goes, marked as such in the map.  For each iteration's sections as the
    unprofiled fit runs them, with no wait added, trace that fit with
    ``torch.profiler``: its ``rtt.fit.h_update``, ``rtt.fit.w_update`` and
    ``rtt.fit.loss`` spans (``utils/trace.py``).
    """
    state = init_fit_state(cfg, W_T0, H0, d0, device=A.device)
    operands = loop_operands(cfg, A)
    seg = max(1, min(32, cfg.max_iter // 8 or 1))
    seg_times = []          # (iterations in the segment, seconds)
    _wait(A.device)
    t_total0 = time.perf_counter()
    while state.it < cfg.max_iter and not bool(state.converged):
        it0, t0 = state.it, time.perf_counter()
        state = fit_mse(cfg, A, state, aux, seg_end=it0 + seg,
                        operands=operands)
        _wait(A.device)
        if state.it > it0:
            seg_times.append((state.it - it0, time.perf_counter() - t0))
    fused_total_ms = (time.perf_counter() - t_total0) * 1e3
    # steady-state cost per iteration: the best segment
    per_iter_s = min((t / n for n, t in seg_times), default=0.0)

    # the sections once more, on the final state
    h_update, w_update, compute_loss = make_updates(cfg, aux or {})
    trAtA, A_sec = operands
    it = state.it

    def best_of(fn, reps=3):
        best, out = float("inf"), None
        for _ in range(reps):
            _wait(A.device)
            t0 = time.perf_counter()
            out = fn()
            _wait(A.device)
            best = min(best, time.perf_counter() - t0)
        return best, out

    t_h, _ = best_of(lambda: h_update(A_sec, state.W_T, state.H, state.d, it))
    t_w, wout = best_of(lambda: w_update(A_sec, state.W_T, state.H, state.d,
                                         it))
    t_l, _ = best_of(lambda: compute_loss(trAtA, A_sec, state.W_T, state.H,
                                          state.d, wout[3], wout[4]))
    prof = {
        "h_update": t_h * 1e3 * it,
        "w_update": t_w * 1e3 * it,
        "loss": t_l * 1e3 * it,
        "fused_total_ms": fused_total_ms,
        "fused_per_iter_us": per_iter_s * 1e6,
        "iterations": it,
        "mode": "fused-segmented",
        "section_basis": "per-call best-of-3 at final state x iterations "
                         "(the loop's sections overlap on the device; the "
                         "unprofiled fit under torch.profiler gives each "
                         "iteration's rtt.fit.h_update / w_update / loss "
                         "spans)",
    }
    return finalize_result(cfg, state, extra={"profile": prof})


# ---------------------------------------------------------------------------
# Initialization (nmf/nmf_init.hpp, fit_cpu.hpp:195-218)
# ---------------------------------------------------------------------------

def init_factors(cfg: NMFConfig, m: int, n: int, A=None,
                 w_init: Optional[np.ndarray] = None,
                 h_init: Optional[np.ndarray] = None,
                 dtype=np.float32):
    """Build (W_T0 (k,m), H0 (k,n), d0 (k,)) on the host.

    Random init reproduces the reference's sequential SplitMix64 column-major
    fill: W_T first (k*m draws), then H (the next k*n draws)
    (nmf_init.hpp:167-186), bit for bit with ``rcppml_tpu``.  As there, an
    ``h_init`` without a ``w_init`` is ignored.  ``init_mode`` 1 / 2 seed
    from a truncated SVD of ``A`` (Lanczos / IRLBA, on A's device):
    ``W_T[i,:] = |U[:,i]| sqrt(d_i)``, ``H[i,:] = |V[:,i]| sqrt(d_i)``
    (nmf_init.hpp:45-96), the rows past the SVD's rank filled at random.
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
    if cfg.init_mode in (1, 2) and A is not None:
        from . import svd as svd_mod
        from ..config import SVDConfig
        scfg = SVDConfig(k=k, tol=1e-10, center=False, seed=cfg.seed)
        res = (svd_mod.lanczos_svd(A, scfg) if cfg.init_mode == 1
               else svd_mod.irlba_svd(A, scfg))
        kk = min(k, res.k_selected if res.k_selected else k)
        W_T = np.empty((k, m), dtype=dtype)
        H = np.empty((k, n), dtype=dtype)
        sq = np.sqrt(np.maximum(np.asarray(res.d[:kk], dtype=np.float64), 0.0))
        W_T[:kk] = (np.abs(np.asarray(res.U[:, :kk])) * sq[None, :]).T
        H[:kk] = (np.abs(np.asarray(res.V[:, :kk])) * sq[None, :]).T
        if kk < k:
            fill_seed = 54321 if cfg.seed == 0 else cfg.seed + 999
            W_T[kk:] = rng_mod.fill_uniform(fill_seed, k - kk, m, dtype=dtype)
            H[kk:] = rng_mod.fill_uniform(fill_seed, k - kk, n,
                                          offset=(k - kk) * m, dtype=dtype)
        return W_T, H, d0
    W_T = rng_mod.fill_uniform(cfg.seed, k, m, dtype=dtype)
    H = rng_mod.fill_uniform(cfg.seed, k, n, offset=k * m, dtype=dtype)
    return W_T, H, d0


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def fit_device(A, device=None) -> torch.device:
    """Where a fit of ``A`` runs: ``device`` if given, else a tensor's own
    device, else (a host array) the CUDA card.  Without a card that raises:
    a fit never moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if isinstance(A, torch.Tensor):
        return A.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rcppml_tpu_torch fits a host array on the CUDA card, and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to fit "
            "on the CPU")
    return torch.device("cuda")


def device_matrix(A, dev: torch.device,
                  syncs: Optional[Syncs] = None) -> torch.Tensor:
    """``A`` as a float32 tensor on ``dev``; a host array becomes row-major
    (a column-major one, as a densified CSC matrix is, would reach the
    products as a transposed view, with another kernel and other rounding).
    ``syncs`` counts the copy to a card."""
    syncs = syncs if syncs is not None else Syncs()
    if not isinstance(A, torch.Tensor):
        # a copy: the fit never writes A, but torch refuses read-only arrays
        A = torch.from_numpy(np.array(A, dtype=np.float32, order="C"))
    return syncs.to(A, dev)


def _aux_on(aux: Optional[dict], dev: torch.device,
            syncs: Optional[Syncs] = None) -> dict:
    """The auxiliary arrays (``nmf_fit``'s ``aux``) as float32 tensors on
    ``dev``."""
    syncs = syncs if syncs is not None else Syncs()
    return {key: syncs.to(val if isinstance(val, torch.Tensor)
                          else torch.as_tensor(np.asarray(val, np.float32)),
                          dev)
            for key, val in (aux or {}).items() if val is not None}


def nmf_fit(A, cfg: NMFConfig, *, w_init=None, h_init=None,
            aux: Optional[dict] = None, device=None,
            sparse_zeros: bool = False, on_iteration=None) -> NMFResult:
    """Fit NMF on a dense matrix.

    ``A``: an (m, n) numpy array or tensor, used as float32.  ``device``:
    where the fit runs; by default a tensor's own device, and the CUDA card
    for a host array (without a card that raises; ``device="cpu"`` fits on
    the CPU).  ``aux``: optional dense auxiliary arrays (``graph_W``,
    ``graph_H``, ``target_H``/``target_W`` and their ``*_gram``).
    ``sparse_zeros``: the input was sparse; an IRLS fit then gives zeros unit
    weight and sums its loss over the nonzeros (an MSE fit ignores it).
    ``on_iteration(iter, train_loss, nan)``: called after every iteration of
    a dense MSE fit, which then runs in step mode; an IRLS fit accepts it
    and never calls it, as in the JAX package.  ``seed="lanczos"`` /
    ``"irlba"`` (``cfg.init_mode`` 1 / 2) run the seeding SVD on A's
    device.
    """
    cfg.validate()
    if np.ndim(A) != 2:
        raise ValueError("data must be a 2-D matrix")
    m, n = A.shape
    if cfg.rank > min(m, n):
        raise ValueError(f"rank {cfg.rank} exceeds min(dim) = {min(m, n)}")
    # everything that needs no device is checked by now
    dev = fit_device(A, device)
    set_fp32_precision()
    if not (cfg.requires_irls() or cfg.fused_vmem or on_iteration is not None
            or cfg.enable_profiling):
        return _fit_plain(A, cfg, dev, w_init, h_init, aux)
    A_dev = device_matrix(A, dev)

    W_T0, H0, d0 = init_factors(cfg, m, n, A=A_dev, w_init=w_init,
                                h_init=h_init)
    aux_dev = _aux_on(aux, A_dev.device)
    if cfg.requires_irls():
        from .nmf_irls import fit_irls
        return fit_irls(A_dev, cfg, W_T0, H0, d0, aux_dev,
                        sparse_zeros=sparse_zeros)
    if cfg.fused_vmem:
        if on_iteration is not None or cfg.enable_profiling:
            raise ValueError("fused_vmem runs the whole fit in one device "
                             "program — callbacks/profiling need the "
                             "step-mode loop (drop the knob)")
        return fit_fused_vmem(cfg, A_dev, W_T0, H0)
    if on_iteration is not None:
        return fit_stepwise(A_dev, cfg, W_T0, H0, d0, aux_dev,
                            on_iteration=on_iteration)
    return fit_profiled(A_dev, cfg, W_T0, H0, d0, aux_dev)


def _fit_plain(A, cfg: NMFConfig, dev: torch.device, w_init, h_init,
               aux) -> NMFResult:
    """The dense MSE fit as users run it: :func:`fit_mse` with no wait
    inside, between its preparation and its result (the ``rtt.fit.*``
    spans).  ``res.misc["host_syncs"]`` counts the fit's synchronizing
    calls (:class:`utils.trace.Syncs`)."""
    syncs = Syncs()
    with span("rtt.fit.prepare"):
        A_dev = device_matrix(A, dev, syncs)
        W_T0, H0, d0 = init_factors(cfg, *A_dev.shape, A=A_dev,
                                    w_init=w_init, h_init=h_init)
        aux_dev = _aux_on(aux, A_dev.device, syncs)
        state = init_fit_state(cfg, W_T0, H0, d0, device=A_dev.device,
                               syncs=syncs)
        operands = loop_operands(cfg, A_dev)
    state = fit_mse(cfg, A_dev, state, aux_dev, operands=operands,
                    syncs=syncs)
    with span("rtt.fit.finalize"):
        res = finalize_result(cfg, state, syncs=syncs)
    res.misc["host_syncs"] = syncs.n
    return res


def finalize_result(cfg: NMFConfig, state: FitState,
                    extra: Optional[dict] = None, ctx=None,
                    syncs: Optional[Syncs] = None) -> NMFResult:
    """Copy a FitState to a host NMFResult (fit_cpu.hpp:1827-1854).
    ``extra``: further result fields by name (the IRLS fit's ``theta``,
    ``dispersion``, ``pi_row``, ``pi_col``).  ``ctx``: a sharded fit's
    ``ShardContext``; W's row blocks are gathered over "rows" and H's column
    blocks over "cols", so that every rank returns the whole (padded)
    factors.  ``syncs`` counts the reads."""
    host = (syncs if syncs is not None else Syncs()).host

    W_T, H = state.W_T, state.H
    if ctx is not None:
        W_T, H = ctx.gather_rows(W_T), ctx.gather_cols(H)
    it = state.it
    res = NMFResult(
        W=host(W_T).T,
        d=host(state.d),
        H=host(H),
        iterations=it,
        converged=bool(host(state.converged)),
        final_tol=float(host(state.final_tol)),
        train_loss=float(host(state.prev_loss)) if it > 0 else float("nan"),
        loss_history=host(state.loss_hist)[:it]
        if cfg.track_loss_history else None,
    )
    for key, val in (extra or {}).items():
        setattr(res, key, val)
    if cfg.sort_model:
        res.sort()
    return res
