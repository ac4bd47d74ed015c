"""Carry configs, fit states and results across from ``rcppml_tpu``.

Nothing here imports JAX: a reference config is read by its field names, and
factors travel as numpy arrays.  The tests use these to start both packages
from the same settings and the same factors.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from . import config as cfg_mod
from .models.nmf import FitState, init_fit_state


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


def result_to_numpy(res) -> dict:
    """A result of either package as plain numpy arrays and scalars:
    W, d, H, loss_history, iterations, converged, train_loss."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return {"W": arr(res.W), "d": arr(res.d), "H": arr(res.H),
            "loss_history": arr(res.loss_history),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "train_loss": float(res.train_loss)}
