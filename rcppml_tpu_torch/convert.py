"""Carry configs, fit states and results across from ``rcppml_tpu``.

Nothing here imports JAX: a reference config is read by its field names, and
factors travel as numpy arrays.  The tests use these to start both packages
from the same settings and the same factors.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import config as cfg_mod
from . import result as result_mod
from .models.nmf import FitState, init_fit_state
from .models.nmf_cv import CVState
from .models.nmf_irls import IRLSState


def _field_value(port_default, ref_value):
    """Map one reference field value onto the port's type."""
    if isinstance(port_default, enum.Enum):
        return type(port_default)(ref_value.value)
    if isinstance(port_default, cfg_mod.FactorConfig):
        return _copy_fields(cfg_mod.FactorConfig, ref_value)
    return ref_value


def _copy_fields(port_cls, ref):
    default = port_cls()
    return port_cls(**{
        f.name: _field_value(getattr(default, f.name), getattr(ref, f.name))
        for f in dataclasses.fields(port_cls)})


def config_from_reference(cfg) -> cfg_mod.NMFConfig:
    """The port's NMFConfig for any object with the field names of
    ``rcppml_tpu.config.NMFConfig``; enums are mapped by ``.value``."""
    return _copy_fields(cfg_mod.NMFConfig, cfg)


def state_from_numpy(W_T, H, d, *, device, max_iter: int) -> FitState:
    """Numpy factors (W_T (k, m), H (k, n), d (k,)) as the port's FitState
    before its first iteration, on ``device``, with room for ``max_iter``
    losses."""
    k = np.shape(d)[0]
    return init_fit_state(cfg_mod.NMFConfig(rank=k, max_iter=max_iter),
                          W_T, H, d, device=device)


def shard_state_from_numpy(W_T, H, d, ctx, *, device,
                           max_iter: int) -> FitState:
    """Whole numpy factors (W_T (k, m), H (k, n), d (k,)), for example the
    JAX package's sharded initial state gathered to the host, laid onto one
    rank's block: W_T's columns of its row block and H's of its column
    block, zero-padded past the true (m, n), as the port's FitState before
    its first iteration on ``device``.  ``ctx``: the rank's
    ``parallel.mesh.ShardContext``."""
    return state_from_numpy(ctx.row_block(W_T), ctx.col_block(H), d,
                            device=device, max_iter=max_iter)


def irls_state_from_numpy(W_T, H, d, *, disp_row, disp_col, pi_row, pi_col,
                          A_imp, device, max_iter: int,
                          it: int = 0) -> IRLSState:
    """Numpy factors, dispersions (``disp_row`` (m,), ``disp_col`` (n,)), ZI
    dropouts (``pi_row`` (m,), ``pi_col`` (n,)) and the imputed matrix
    ``A_imp`` (m, n) as the port's IRLSState after ``it`` iterations, on
    ``device``, with room for ``max_iter`` losses: a fit of either package
    can be carried on from its middle (``it > 0`` makes the next iteration
    warm-start from H and W_T, as it does inside a fit)."""
    base = state_from_numpy(W_T, H, d, device=device, max_iter=max_iter)

    def dev(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(device)

    return IRLSState(
        W_T=base.W_T, H=base.H, d=base.d, disp_row=dev(disp_row),
        disp_col=dev(disp_col), pi_row=dev(pi_row), pi_col=dev(pi_col),
        A_imp=dev(A_imp), it=int(it), prev_loss=base.prev_loss,
        patience_ctr=base.patience_ctr, converged=base.converged,
        final_tol=base.final_tol, loss_hist=base.loss_hist)


def cv_state_from_numpy(W_T, H, d, *, disp_row, disp_col, pi_row, pi_col,
                        device, max_iter: int, it: int = 0, A_imp=None,
                        prev_conv_loss=None, patience_ctr: int = 0,
                        train_hist=None, test_hist=None, best_test_loss=None,
                        best_iter: int = 0) -> CVState:
    """The numpy fields of the JAX package's ``CVState`` (W_T (k, m),
    H (k, n), d (k,), the dispersion vectors, the ZI dropouts, and, for a
    state from the middle of a fit, the loss histories and counters) as the
    port's loop state after ``it`` iterations, on ``device``, with room for
    ``max_iter`` losses.  With the defaults it is the state before the first
    iteration, so one iteration of both loops can start from the same
    factors.  ``A_imp``: the (m, n) imputed matrix of a ZI fit."""
    f32 = torch.float32
    fmax = float(torch.finfo(f32).max)

    def dev(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(device)

    def scalar(v, dtype=f32):
        return torch.tensor(v, dtype=dtype, device=device)

    def hist(h):
        out = torch.full((max_iter,), float("nan"), dtype=f32, device=device)
        if h is not None:
            h = np.asarray(h, np.float32)[:max_iter]
            out[:len(h)] = torch.from_numpy(np.array(h)).to(device)
        return out

    return CVState(
        W_T=dev(W_T), H=dev(H), d=dev(d), disp_row=dev(disp_row),
        disp_col=dev(disp_col), it=int(it),
        prev_conv_loss=scalar(fmax if prev_conv_loss is None
                              else float(prev_conv_loss)),
        patience_ctr=scalar(int(patience_ctr), torch.int32),
        converged=scalar(False, torch.bool),
        final_tol=scalar(float("nan")),
        train_hist=hist(train_hist), test_hist=hist(test_hist),
        best_test_loss=scalar(fmax if best_test_loss is None
                              else float(best_test_loss)),
        best_iter=scalar(int(best_iter), torch.int32),
        pi_row=dev(pi_row), pi_col=dev(pi_col),
        A_imp=None if A_imp is None else dev(A_imp))


def result_to_numpy(res) -> dict:
    """A result of either package as plain numpy arrays and scalars:
    W, d, H, loss_history, iterations, converged, train_loss, the IRLS
    fit's theta, dispersion, pi_row, pi_col (None where not estimated), and
    the cross-validated fit's test_loss, test_loss_history, best_iter and
    best_test_loss (None where the fit had no holdout)."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return {"W": arr(res.W), "d": arr(res.d), "H": arr(res.H),
            "loss_history": arr(res.loss_history),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "train_loss": float(res.train_loss),
            "test_loss": float(res.test_loss),
            "test_loss_history": arr(res.test_loss_history),
            "best_iter": int(res.best_iter),
            "best_test_loss": res.misc.get("best_test_loss"),
            "theta": arr(res.theta), "dispersion": arr(res.dispersion),
            "pi_row": arr(res.pi_row), "pi_col": arr(res.pi_col)}


def _numpy_fields(port_cls, ref, **override):
    """``port_cls`` with every field of ``ref`` of the same name, arrays as
    numpy arrays, ``misc`` copied."""
    out = {}
    for f in dataclasses.fields(port_cls):
        val = getattr(ref, f.name)
        if hasattr(val, "__array__") and not np.isscalar(val):
            val = np.asarray(val)
        out[f.name] = val
    out["misc"] = dict(getattr(ref, "misc", {}) or {})
    out.update(override)
    return port_cls(**out)


def nmf_result_from_reference(res) -> result_mod.NMFResult:
    """The port's NMFResult for a result of ``rcppml_tpu`` (numpy fields):
    a model fitted by the JAX package can go to the port's ``predict`` /
    ``evaluate``.  A stored ``misc["config"]`` becomes the port's
    NMFConfig."""
    out = _numpy_fields(result_mod.NMFResult, res)
    cfg = out.misc.get("config")
    if cfg is not None and not isinstance(cfg, cfg_mod.NMFConfig):
        out.misc["config"] = config_from_reference(cfg)
    return out


def svd_result_from_reference(res) -> result_mod.SVDResult:
    """The port's SVDResult for a result of ``rcppml_tpu`` (numpy
    fields)."""
    return _numpy_fields(result_mod.SVDResult, res)


def global_config_from_reference(gc):
    """The port's GlobalConfig for a graph config of ``rcppml_tpu`` (any
    object with the field names of its ``GlobalConfig``); ``dots`` copied."""
    from .models.graph import GlobalConfig
    out = _copy_fields(GlobalConfig, gc)
    out.dots = dict(gc.dots)
    return out


def graph_result_from_reference(res):
    """The port's GraphResult for a GraphResult of ``rcppml_tpu``: every
    LayerResult's arrays (``W_blocks`` too) as numpy arrays, so that a net
    fitted by the JAX package can go to the port's ``predict``."""
    from .models import graph

    def layer(lr):
        blocks = lr.W_blocks
        return graph.LayerResult(**{
            **{f.name: getattr(lr, f.name)
               for f in dataclasses.fields(graph.LayerResult)},
            "W": np.asarray(lr.W), "d": np.asarray(lr.d),
            "H": np.asarray(lr.H),
            "W_blocks": None if blocks is None else {
                name: np.asarray(w) for name, w in blocks.items()}})

    return graph.GraphResult(
        layers={name: layer(lr) for name, lr in res.layers.items()},
        total_iterations=int(res.total_iterations),
        total_loss=float(res.total_loss), converged=bool(res.converged),
        logger=res.logger, chain_topology=bool(res.chain_topology))


def graph_states_from_numpy(states, *, device):
    """Per-layer numpy factors ``[(W_T (k, m), H (k, n), d (k,)), ...]`` as
    the port's outer-ALS states on ``device`` (contiguous float32 tensors):
    ``FactorNet._fit_deep_fused(data_map, device, warm_states=...)`` then
    runs the port's outer loop from another package's warm factors."""
    return [tuple(torch.from_numpy(np.array(x, np.float32, order="C")).to(
        device) for x in state) for state in states]
