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
from .models.nmf import FitState, init_fit_state
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


def result_to_numpy(res) -> dict:
    """A result of either package as plain numpy arrays and scalars:
    W, d, H, loss_history, iterations, converged, train_loss, and the IRLS
    fit's theta, dispersion, pi_row, pi_col (None where not estimated)."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return {"W": arr(res.W), "d": arr(res.d), "H": arr(res.H),
            "loss_history": arr(res.loss_history),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "train_loss": float(res.train_loss),
            "theta": arr(res.theta), "dispersion": arr(res.dispersion),
            "pi_row": arr(res.pi_row), "pi_col": arr(res.pi_col)}
