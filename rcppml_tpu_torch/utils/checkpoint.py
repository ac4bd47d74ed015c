"""Checkpoint / resume for factor models.

The port of ``rcppml_tpu/utils/checkpoint.py:24-578``.  The files are the
JAX package's: the same ``.npz`` keys, shapes and types, the config as the
same JSON, ``mesh_shape`` the (rows, cols) of the mesh that wrote the file,
``(0, 0)`` without one.  A file written by either package loads in the
other.

Under a mesh (``fit_checkpointed(mesh=)``) every rank runs the sharded loop
on its block; after each segment the blocks are gathered to rank 0, which
alone writes the whole zero-padded state, and every rank waits for the
write.  On resume rank 0 alone reads the file (a rank on another host need
not see it) and every rank receives its block; whether there is a file, and
whether it loads, is rank 0's decision, shared with every rank.  A file is
resumed only on the mesh shape that wrote it.

The port may add one key the JAX package ignores, ``layout``: the 2-D
arrays its loop held column-major (the CPU route of the Cholesky solve
returns its solution so).  A resume restores that layout, because the
layout of a product's operand selects its kernel, and with it the rounding.

``fit_checkpointed`` runs the port's loops (``models/nmf.py::fit_mse``,
``models/nmf_irls.py::run_irls``) in segments of ``every`` iterations,
writing the whole fit state atomically after each segment, and resumes from
the file when it exists.  Splitting the loop at iteration boundaries changes
no bit of W, d, H, the loss history, or the dispersion and zero-inflation
state.  The IRLS state's counters ``inner_iters`` and ``host_syncs`` are not
in the file, so a resumed fit's ``misc`` counters count from the resume.

``save_stream_state`` / ``load_stream_state`` hold the streaming loop's
state between sweeps (``models/nmf_chunked.py``), with the JAX package's
npz keys, so a stream state written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..config import Dispersion, Loss, NMFConfig, Norm, Solver, ZI
from ..models.svd import _host
from ..result import NMFResult

_ARRAY_FIELDS = ("W", "d", "H", "theta", "dispersion", "pi_row", "pi_col",
                 "loss_history", "test_loss_history")


def _cfg_to_json(cfg: NMFConfig) -> str:
    def enc(v):
        if dataclasses.is_dataclass(v):
            return {k: enc(getattr(v, k)) for k in v.__dataclass_fields__}
        if isinstance(v, (Loss, Dispersion, ZI, Norm)):
            return v.value
        if isinstance(v, Solver):
            return v.name
        return v
    return json.dumps(enc(cfg))


def _layout(state, names) -> dict:
    """``{"layout": ...}`` naming the 2-D tensors of ``state`` held
    column-major, or nothing when there is none."""
    cols = [name for name in names
            if getattr(state, name).dim() == 2
            and not getattr(state, name).is_contiguous()
            and getattr(state, name).T.is_contiguous()]
    return {"layout": np.asarray(json.dumps(cols))} if cols else {}


def _atomic_savez(path: str, **payload) -> None:
    """Write ``payload`` to ``path`` through a temporary file in the same
    directory and a rename, so that a reader never sees half a file.

    Stored, not deflated as the JAX package writes (``np.load`` reads
    both): compressing float32 factors saves little and took about 8 s for
    each write of a 145 MB imputed matrix on the card's host."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    # suffix must be .npz so numpy writes to exactly this name (it appends
    # .npz otherwise, leaving the mkstemp placeholder empty)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_model(result: NMFResult, path: str,
               cfg: Optional[NMFConfig] = None) -> None:
    """Atomically write a model checkpoint (.npz)."""
    payload = {}
    for f in _ARRAY_FIELDS:
        v = getattr(result, f, None)
        if v is not None:
            payload[f] = np.asarray(v)
    payload["_scalars"] = np.asarray(json.dumps({
        "iterations": result.iterations,
        "converged": bool(result.converged),
        "final_tol": float(result.final_tol),
        "train_loss": float(result.train_loss),
        "test_loss": float(result.test_loss),
        "best_iter": int(result.best_iter),
    }))
    if cfg is not None:
        payload["_config"] = np.asarray(_cfg_to_json(cfg))
    _atomic_savez(path, **payload)


def load_model(path: str) -> NMFResult:
    with np.load(path, allow_pickle=False) as z:
        scal = json.loads(str(z["_scalars"]))
        res = NMFResult(
            W=z["W"], d=z["d"], H=z["H"],
            iterations=int(scal["iterations"]),
            converged=bool(scal["converged"]),
            final_tol=float(scal["final_tol"]),
            train_loss=float(scal["train_loss"]),
            test_loss=float(scal["test_loss"]),
            best_iter=int(scal["best_iter"]),
        )
        for f in ("theta", "dispersion", "pi_row", "pi_col", "loss_history",
                  "test_loss_history"):
            if f in z.files:
                setattr(res, f, z[f])
        if "_config" in z.files:
            res.misc["config_json"] = str(z["_config"])
    return res


class CheckpointCallback:
    """on_iteration-compatible periodic checkpointing, for the step-mode
    loop where the host sees every iteration."""

    def __init__(self, path: str, every: int = 10):
        self.path = path
        self.every = every
        self._latest = None

    def update_state(self, result: NMFResult):
        self._latest = result

    def __call__(self, iteration: int, train_loss: float,
                 test_loss: float = float("nan"), model=None):
        model = model or self._latest
        if model is not None and iteration % self.every == 0:
            save_model(model, self.path)


def resume_kwargs(path: str) -> dict:
    """Turn a checkpoint into warm-start kwargs for nmf():
    ``nmf(A, k, **resume_kwargs("ckpt.npz"))``."""
    res = load_model(path)
    return {"w_init": np.asarray(res.W) * np.asarray(res.d)[None, :],
            "h_init": np.asarray(res.H)}


# ---------------------------------------------------------------------------
# Preemption-safe checkpointing of the fit loop (SURVEY §5)
# ---------------------------------------------------------------------------

def _scalars(state) -> np.ndarray:
    """The loop's scalars as the file stores them: float64 [it, prev_loss,
    patience_ctr, converged, final_tol] (float32 values are exact there)."""
    return np.asarray([float(state.it), float(state.prev_loss),
                       float(state.patience_ctr), float(state.converged),
                       float(state.final_tol)], np.float64)


def save_fit_state(state, cfg: NMFConfig, path: str) -> None:
    """Atomically persist a FitState (``models/nmf.py``) + config."""
    _atomic_savez(
        path, W_T=_host(state.W_T), H=_host(state.H), d=_host(state.d),
        loss_hist=_host(state.loss_hist), scalars=_scalars(state),
        mesh_shape=np.asarray((0, 0), np.int64),
        config=np.asarray(_cfg_to_json(cfg)),
        **_layout(state, ("W_T", "H")))


def _check_mesh_shape(z, mesh_shape=None) -> None:
    """Refuse a file written under another mesh shape than ``mesh_shape``
    ((rows, cols), None without a mesh): padding and the order of the
    sums differ between shapes, so the resume would not be bitwise."""
    stored = tuple(np.asarray(z["mesh_shape"]).tolist()) \
        if "mesh_shape" in z.files else (0, 0)
    current = tuple(mesh_shape or (0, 0))
    if stored != current:
        def name(s):
            return "no mesh" if s == (0, 0) else f"mesh {s[0]}x{s[1]}"
        raise ValueError(
            f"checkpoint was written under {name(stored)} but resume "
            f"runs under {name(current)}; resume on the same mesh shape "
            "(padding and reduction order differ otherwise)")


def _validate_and_resize(z, cfg: NMFConfig):
    """Shared checkpoint-load validation (MSE + IRLS formats): the stored
    config must equal ``cfg`` except ``max_iter``, which may grow
    (continue training) or shrink down to the iterations already run — a
    resume can never silently change the optimization problem.  Returns
    (scalars, loss_hist) with the history padded with NaN or truncated to
    the current ``max_iter``."""
    stored = json.loads(str(z["config"]))
    current = json.loads(_cfg_to_json(cfg))
    stored.pop("max_iter")
    current_mi = current.pop("max_iter")
    if stored != current:
        diff = {k for k in current if stored.get(k) != current.get(k)}
        raise ValueError(
            f"checkpoint config mismatch on fields {sorted(diff)}; "
            "resume with the same configuration (only maxit may grow)")
    sc = z["scalars"]
    it = int(sc[0])
    if current_mi < it:
        raise ValueError(f"checkpoint already has {it} iterations but "
                         f"maxit = {current_mi}")
    hist = np.asarray(z["loss_hist"], np.float32)
    if current_mi > hist.shape[0]:
        hist = np.concatenate([
            hist, np.full((current_mi - hist.shape[0],), np.nan,
                          np.float32)])
    elif current_mi < hist.shape[0]:
        # shrinking maxit (still >= it, checked above): entries beyond
        # current_mi are unreached NaNs
        hist = hist[:current_mi]
    return sc, hist


def _loop_scalars(sc, hist, device) -> dict:
    """The FitState / IRLSState scalar fields from a file's scalars."""
    f32 = torch.float32
    return dict(
        it=int(sc[0]),
        prev_loss=torch.tensor(float(sc[1]), dtype=f32, device=device),
        patience_ctr=torch.tensor(int(sc[2]), dtype=torch.int32,
                                  device=device),
        converged=torch.tensor(bool(sc[3] > 0.5), device=device),
        final_tol=torch.tensor(float(sc[4]), dtype=f32, device=device),
        loss_hist=torch.from_numpy(np.ascontiguousarray(hist)).to(device))


def _tensor(z, name, device) -> torch.Tensor:
    """Array ``name`` of the file as float32 on ``device``, column-major
    where the file's ``layout`` names it, else row-major."""
    cols = json.loads(str(z["layout"])) if "layout" in z.files else []
    order = "F" if name in cols else "C"
    # .to() keeps the strides of a dense tensor
    return torch.from_numpy(np.array(z[name], np.float32, order=order)).to(
        device)


def load_fit_state(path: str, cfg: NMFConfig, device="cpu"):
    """Load a FitState checkpoint onto ``device`` (see
    :func:`_validate_and_resize` for the config compatibility contract)."""
    from ..models.nmf import FitState
    with np.load(path, allow_pickle=False) as z:
        _check_mesh_shape(z)
        sc, hist = _validate_and_resize(z, cfg)
        return FitState(W_T=_tensor(z, "W_T", device),
                        H=_tensor(z, "H", device), d=_tensor(z, "d", device),
                        **_loop_scalars(sc, hist, device))


_IRLS_VECS = ("W_T", "H", "d", "disp_row", "disp_col", "pi_row", "pi_col",
              "loss_hist")


def save_irls_state(state, cfg: NMFConfig, path: str) -> None:
    """Atomically persist an IRLSState + config.

    ``A_imp`` (the ZI soft-imputed matrix) is included only for ZI fits —
    it is genuine loop state there (the next iteration's solves read it),
    and the only way to make resume bit-exact.  Non-ZI IRLS carries
    ``A_imp == A`` unchanged, so it is reconstructed from the data on load."""
    arrays = {name: _host(getattr(state, name)) for name in _IRLS_VECS}
    if cfg.has_zi():
        arrays["A_imp"] = _host(state.A_imp)
    _atomic_savez(path, scalars=_scalars(state),
                  mesh_shape=np.asarray((0, 0), np.int64),
                  config=np.asarray(_cfg_to_json(cfg)), **arrays,
                  **_layout(state, ("W_T", "H") + (
                      ("A_imp",) if cfg.has_zi() else ())))


def load_irls_state(path: str, cfg: NMFConfig, A_dev: torch.Tensor):
    """Load an IRLSState checkpoint onto A's device, validating config
    compatibility as :func:`load_fit_state` does."""
    from ..models.nmf_irls import IRLSState
    dev = A_dev.device
    with np.load(path, allow_pickle=False) as z:
        _check_mesh_shape(z)
        sc, hist = _validate_and_resize(z, cfg)
        vecs = {name: _tensor(z, name, dev)
                for name in _IRLS_VECS if name != "loss_hist"}
        A_imp = _tensor(z, "A_imp", dev) if "A_imp" in z.files else A_dev
        return IRLSState(A_imp=A_imp, **vecs,
                         **_loop_scalars(sc, hist, dev))


def fit_checkpointed(A, cfg: NMFConfig, path: str, *, every: int = 10,
                     w_init=None, h_init=None, aux=None,
                     sparse_zeros: bool = False, device=None,
                     mesh=None) -> NMFResult:
    """Preemption-safe fit: run the loop in segments of ``every``
    iterations, atomically checkpointing the whole fit state after each
    segment, and resume from ``path`` if it exists.  Covers the dense MSE
    loop and the IRLS loop (KL / NB / GP / gamma / ..., zero-inflated fits
    included, whose imputed matrix is checkpointed as loop state).

    ``A``: a host array or tensor; ``device`` as for :func:`nmf`.  The
    iteration sequence is the unsegmented fit's, bit for bit; the only
    added cost is one copy of the state to the host and one npz write per
    segment.  ``mesh``: a ``parallel.mesh.Mesh`` every rank of which calls
    this alike; the segments are those of the sharded fit
    (``parallel.mesh.fit_sharded``), ``A`` may also be a ``ShardedMatrix``,
    and the file holds the zero-padded whole state and the mesh's shape.
    """
    from ..device import set_fp32_precision
    from ..models import nmf as nmf_mod

    cfg.validate()
    if every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if cfg.fused_vmem:
        raise ValueError("fused_vmem runs the whole fit in one device "
                         "program — incompatible with segmented "
                         "checkpointing (drop the knob or the "
                         "checkpoint_path)")
    if mesh is not None:
        return _fit_checkpointed_mesh(
            A, cfg, path, mesh, every=every, w_init=w_init, h_init=h_init,
            aux=aux, sparse_zeros=sparse_zeros, device=device)
    m, n = A.shape
    if cfg.rank > min(m, n):
        raise ValueError(f"rank {cfg.rank} exceeds min(dim) = {min(m, n)}")
    dev = nmf_mod.fit_device(A, device)
    set_fp32_precision()
    A_dev = nmf_mod.device_matrix(A, dev)
    aux_dev = {key: nmf_mod.device_matrix(val, dev)
               for key, val in (aux or {}).items() if val is not None}

    def start():
        W_T0, H0, d0 = nmf_mod.init_factors(
            cfg, m, n, A=A_dev if cfg.init_mode in (1, 2) else None,
            w_init=w_init, h_init=h_init)
        return W_T0, H0, d0

    k = cfg.rank
    if cfg.requires_irls():
        from ..models import nmf_irls as irls_mod
        aux_dev = {key: val for key, val in aux_dev.items()
                   if not key.endswith("_gram")}
        if os.path.exists(path):
            state = load_irls_state(path, cfg, A_dev)
        else:
            state = irls_mod._init_irls_state(A_dev, cfg, *start())

        def segment(state, seg_end):
            return irls_mod.run_irls(cfg, A_dev, aux_dev, state,
                                     sparse_zeros, seg_end=seg_end)
        save, finalize = save_irls_state, irls_mod.finalize_irls_result
    else:
        if os.path.exists(path):
            state = load_fit_state(path, cfg, device=dev)
        else:
            state = nmf_mod.init_fit_state(cfg, *start(), device=dev)
        operands = nmf_mod.loop_operands(cfg, A_dev)

        def segment(state, seg_end):
            return nmf_mod.fit_mse(cfg, A_dev, state, aux_dev,
                                   seg_end=seg_end, operands=operands)
        save, finalize = save_fit_state, nmf_mod.finalize_result
    if state.W_T.shape != (k, m) or state.H.shape != (k, n):
        raise ValueError("checkpoint factor shapes do not match the data")

    while state.it < cfg.max_iter and not bool(state.converged):
        state = segment(state, min(state.it + every, cfg.max_iter))
        save(state, cfg, path)
    return finalize(cfg, state)


# ---------------------------------------------------------------------------
# Checkpointed mesh fits (rcppml_tpu/utils/checkpoint.py:209-337, 395-491)
# ---------------------------------------------------------------------------

# the IRLS state's per-row / per-column vectors and how each is split
_IRLS_SPLIT = {"disp_row": "rows", "disp_col": "cols", "pi_row": "rows",
               "pi_col": "cols"}


def _root_read(path: str, cfg: NMFConfig, mesh_shape, k: int, M: int,
               N: int):
    """Rank 0's read of a mesh checkpoint: the file's scalars, history,
    layout and whole padded arrays, validated as :func:`load_fit_state`
    validates a file, and the factors' padded shapes checked."""
    names = ("W_T", "H", "d")
    if cfg.requires_irls():
        names += tuple(_IRLS_SPLIT) + (("A_imp",) if cfg.has_zi() else ())
    with np.load(path, allow_pickle=False) as z:
        _check_mesh_shape(z, mesh_shape)
        sc, hist = _validate_and_resize(z, cfg)
        missing = [name for name in names if name not in z.files]
        if missing:
            raise ValueError(f"checkpoint lacks {missing}")
        arrays = {name: np.asarray(z[name], np.float32) for name in names}
        layout = json.loads(str(z["layout"])) if "layout" in z.files else []
    if arrays["W_T"].shape != (k, M) or arrays["H"].shape != (k, N):
        raise ValueError("checkpoint factor shapes do not match the data")
    return np.asarray(sc), hist, arrays, layout


def _fit_checkpointed_mesh(A, cfg: NMFConfig, path: str, mesh, *,
                           every: int, w_init, h_init, aux,
                           sparse_zeros: bool, device) -> NMFResult:
    """:func:`fit_checkpointed` on a mesh: the segments of the sharded MSE
    loop (``models.nmf.fit_mse(seg_end=, ctx=)``) or IRLS loop
    (``models.nmf_irls.run_irls(seg_end=, ctx=)``, the accounting on the
    block's valid extents), each followed by a gather of the state to rank
    0 and its write.  The file holds the whole zero-padded state: W_T
    (k, M), H (k, N), for IRLS the per-row (M,) and per-column (N,)
    vectors and for ZI the imputed matrix (M, N), with ``mesh_shape``."""
    from ..models import nmf as nmf_mod
    from ..models import nmf_irls as irls_mod
    from ..parallel import mesh as mesh_mod

    if any(val is not None for val in (aux or {}).values()):
        raise ValueError("checkpoint_path with mesh= does not support "
                         "graph/target auxiliaries yet")
    dev, ctx, A_blk, seed_A = mesh_mod.sharded_setup(A, cfg, mesh, device)
    k, M, N = cfg.rank, ctx.M, ctx.N
    mesh_shape = (mesh.shape["rows"], mesh.shape["cols"])
    irls = cfg.requires_irls()
    zi = irls and cfg.has_zi()

    # rank 0 decides whether there is a file and reads it; every rank
    # follows its decision (or raises its error)
    head = None
    if ctx.is_root and os.path.exists(path):
        try:
            sc, hist, arrays, layout = _root_read(path, cfg, mesh_shape,
                                                  k, M, N)
            head = (None, sc, hist, arrays["d"], layout)
        except Exception as e:                    # noqa: BLE001
            head = (e,)
    head = ctx.share(head)
    if head is not None and head[0] is not None:
        raise head[0]

    if head is None:
        W_T0, H0, d0 = nmf_mod.init_factors(cfg, ctx.m, ctx.n, A=seed_A,
                                            w_init=w_init, h_init=h_init)
        W_blk, H_blk = ctx.row_block(W_T0), ctx.col_block(H0)
        state = (irls_mod._init_irls_state(A_blk, cfg, W_blk, H_blk, d0,
                                           ctx) if irls
                 else nmf_mod.init_fit_state(cfg, W_blk, H_blk, d0,
                                             device=dev))
    else:
        _, sc, hist, d, layout = head
        whole = arrays if ctx.is_root else {}

        def part(name, split):
            return ctx.scatter_from_root(whole.get(name), split, dev,
                                         col_major=name in layout)

        common = dict(W_T=part("W_T", "rows"), H=part("H", "cols"),
                      d=torch.from_numpy(np.array(d, np.float32)).to(dev),
                      **_loop_scalars(sc, hist, dev))
        if irls:
            vecs = {name: part(name, split)
                    for name, split in _IRLS_SPLIT.items()}
            state = irls_mod.IRLSState(
                A_imp=part("A_imp", "both") if zi else A_blk, **vecs,
                **common)
        else:
            state = nmf_mod.FitState(**common)

    if irls:
        def segment(state, seg_end):
            return irls_mod.run_irls(cfg, A_blk, {}, state, sparse_zeros,
                                     seg_end=seg_end, ctx=ctx)
        splits = dict(_IRLS_SPLIT, **({"A_imp": "both"} if zi else {}))
        finalize = irls_mod.finalize_irls_result
    else:
        operands = nmf_mod.loop_operands(cfg, A_blk, ctx)

        def segment(state, seg_end):
            return nmf_mod.fit_mse(cfg, A_blk, state, {}, seg_end=seg_end,
                                   operands=operands, ctx=ctx)
        splits = {}
        finalize = nmf_mod.finalize_result

    def save(state):
        gathered = {name: ctx.gather_to_root(getattr(state, name), split)
                    for name, split in (("W_T", "rows"), ("H", "cols"),
                                        *splits.items())}
        if ctx.is_root:
            _atomic_savez(
                path, d=_host(state.d), loss_hist=_host(state.loss_hist),
                scalars=_scalars(state),
                mesh_shape=np.asarray(mesh_shape, np.int64),
                config=np.asarray(_cfg_to_json(cfg)), **gathered,
                **_layout(state, ("W_T", "H") + (("A_imp",) if zi else ())))
        ctx.barrier()

    while state.it < cfg.max_iter and not bool(state.converged):
        state = segment(state, min(state.it + every, cfg.max_iter))
        save(state)
    return mesh_mod.unpad_result(finalize(cfg, state, ctx=ctx), cfg,
                                 ctx.m, ctx.n)


# ---------------------------------------------------------------------------
# Sweep-granular streaming checkpoints (rcppml_tpu/utils/checkpoint.py:
# 508-578): the npz keys are the JAX package's
# ---------------------------------------------------------------------------

def save_stream_state(path: str, cfg: NMFConfig, *, W_T, H, d, it,
                      prev_loss, patience, best_test, best_iter,
                      hist, test_hist, pi_vec=None,
                      converged: bool = False) -> None:
    """Atomically persist the streaming loop's state after a sweep: the
    factors, the convergence counters and the ZI dropout vector, every
    piece of cross-sweep state, so a resume is bit-exact."""
    def host(x):
        return _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    arrays = dict(W_T=host(W_T), H=host(H), d=host(d),
                  hist=np.asarray(hist, np.float64),
                  test_hist=np.asarray(test_hist, np.float64))
    if pi_vec is not None:
        arrays["pi_vec"] = host(pi_vec)
    _atomic_savez(
        path,
        scalars=np.asarray([float(it), float(prev_loss), float(patience),
                            float(best_test), float(best_iter),
                            float(converged)], np.float64),
        config=np.asarray(_cfg_to_json(cfg)),
        **arrays)


def load_stream_state(path: str, cfg: NMFConfig) -> dict:
    """Load a streaming checkpoint as host arrays and scalars; the config
    must match except ``max_iter``, which may grow."""
    with np.load(path, allow_pickle=False) as z:
        stored = json.loads(str(z["config"]))
        current = json.loads(_cfg_to_json(cfg))
        stored.pop("max_iter")
        current_mi = current.pop("max_iter")
        if stored != current:
            diff = {k for k in current if stored.get(k) != current.get(k)}
            raise ValueError(
                f"checkpoint config mismatch on fields {sorted(diff)}; "
                "resume with the same configuration (only maxit may grow)")
        sc = z["scalars"]
        if current_mi < int(sc[0]):
            raise ValueError(
                f"checkpoint already has {int(sc[0])} sweeps but "
                f"maxit = {current_mi}")
        return {
            "W_T": np.asarray(z["W_T"], np.float32),
            "H": np.asarray(z["H"], np.float32),
            "d": np.asarray(z["d"], np.float32),
            "it": int(sc[0]), "prev_loss": float(sc[1]),
            "patience": int(sc[2]), "best_test": float(sc[3]),
            "best_iter": int(sc[4]),
            "converged": bool(sc[5] > 0.5) if len(sc) > 5 else False,
            "hist": list(np.asarray(z["hist"], np.float64)),
            "test_hist": list(np.asarray(z["test_hist"], np.float64)),
            "pi_vec": (np.asarray(z["pi_vec"], np.float32)
                       if "pi_vec" in z.files else None),
        }
