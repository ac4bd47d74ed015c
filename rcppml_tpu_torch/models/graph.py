"""FactorNet graph engine: composable multi-layer factorization DAGs.

The port of ``rcppml_tpu/models/graph.py`` (``inst/include/FactorNet/
graph/`` and ``R/factor_net.R:42-508`` of the reference).  Node types
(graph/node.hpp:47-56): INPUT, NMF_LAYER, SVD_LAYER, SHARED, CONCAT, ADD,
CONDITION.

Execution (graph/fit.hpp):
  * single layer -> delegate to the full ``nmf`` (IRLS, CV, masks);
  * multi-layer -> outer ALS (fit.hpp:265-355): a warmup fit per layer, then
    sweeps of one H-update and one W-update per layer, warm-started from the
    current factors, until the summed per-layer loss converges.  The JAX
    package compiles that outer loop into one ``lax.while_loop``; here it is
    a Python loop over tensors that stay on the fit's device
    (:func:`_outer_als`), as ``models/nmf.py`` runs its own: with
    ``tol == 0`` the host reads nothing until the end, else one scalar a
    sweep, counted in ``_outer_als.host_reads``.  Layers with IRLS losses or
    CV holdouts take the host-driven loop: one ``nmf(maxit=1)`` per layer
    per sweep on the device-resident data, one read of the layers' losses a
    sweep;
  * SHARED multi-modal inputs are row-concatenated before fitting and W is
    split back into per-input row blocks (R/factor_methods.R:152-221);
  * deeper layers factorize t(H) of their upstream layer (fit.hpp:95-175);
    CONCAT row-binds branch t(H)s, ADD sums branch Hs, CONDITION appends
    covariate columns.

Results are host numpy arrays, as in ``NMFResult``.  ``fit``,
``cross_validate_graph`` and ``GraphResult.predict`` run on the CUDA card
unless given ``device="cpu"`` or CPU tensors; without a card they raise.
``fit(net, mesh=)`` runs the outer ALS on a ``parallel.mesh.Mesh``, every
rank calling it alike (:meth:`FactorNet._fit_deep_fused`).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import set_fp32_precision
from ..ops import linalg
from .nmf import device_matrix, fit_device, make_updates

_counter = itertools.count()


def _as_f32(x):
    """A covariate or auxiliary matrix as a host float32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _tensor(x, dev) -> torch.Tensor:
    """A host array or tensor as a contiguous float32 tensor on ``dev``: the
    layout of a matmul's operands selects its kernel, and with it the
    rounding."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(x, np.float32, order="C")).to(dev)


class Node:
    kind = "node"

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{self.kind}_{next(_counter)}"


class Input(Node):
    """A data matrix: numpy, scipy sparse, a 2-D tensor or a ``.spz``
    path."""
    kind = "input"

    def __init__(self, data, name: Optional[str] = None):
        super().__init__(name)
        if isinstance(data, str):
            # .spz path input (R factor_input file routing,
            # test_factor_net.R:406-447): decoded through the codec; the
            # graph engine then runs its dense path
            import os
            if not data.endswith(".spz"):
                raise ValueError(f"factor_input path must be .spz: {data!r}")
            if not os.path.exists(data):
                raise ValueError(f"no such .spz file: {data!r}")
            from ..io.spz import st_read
            from ..utils.memory import guard_dense_input
            sp_mat = st_read(data)
            guard_dense_input(sp_mat.shape[0], sp_mat.shape[1])
            data = np.asarray(sp_mat.todense(), dtype=np.float32)
        self.data = data


class Shared(Node):
    """Shared-H multi-modal input: row-concat of 2+ inputs with the same
    number of columns (samples)."""
    kind = "shared"

    def __init__(self, *inputs: Input, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_shared requires at least 2 inputs")
        self.inputs = list(inputs)


class Concat(Node):
    kind = "concat"

    def __init__(self, *inputs: Node, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_concat requires at least 2 inputs")
        self.inputs = list(inputs)


class Add(Node):
    kind = "add"

    def __init__(self, *inputs: Node, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_add requires at least 2 inputs")
        self.inputs = list(inputs)


class Condition(Node):
    """Append covariate columns Z to the layer input (batch conditioning)."""
    kind = "condition"

    def __init__(self, input: Node, Z, name=None):
        super().__init__(name)
        self.input = input
        self.Z = _as_f32(Z)


class NMFLayer(Node):
    kind = "nmf_layer"

    def __init__(self, input: Node, k: int, *, name=None, W: Optional[dict] = None,
                 H: Optional[dict] = None, loss: str = "mse", **fit_kwargs):
        super().__init__(name)
        self.input = input
        self.k = int(k)
        self.W = W or {}
        self.H = H or {}
        self.loss = loss
        self.fit_kwargs = fit_kwargs


class SVDLayer(Node):
    kind = "svd_layer"

    def __init__(self, input: Node, k: int, *, name=None, **fit_kwargs):
        super().__init__(name)
        self.input = input
        self.k = int(k)
        self.fit_kwargs = fit_kwargs


# R-style constructor aliases (R/factor_net.R:42-508)
factor_input = Input
factor_shared = Shared
factor_concat = Concat
factor_add = Add
factor_condition = Condition
nmf_layer = NMFLayer
svd_layer = SVDLayer


# ---------------------------------------------------------------------------
# Global network config (R/factor_net.R:126-158 factor_config ->
# fn_global_config)
# ---------------------------------------------------------------------------

_LOSSES = ("mse", "gp", "nb", "gamma", "inverse_gaussian", "tweedie")


@dataclass
class GlobalConfig:
    """Network-wide fit settings (``fn_global_config``).

    ``dots`` are forwarded to the underlying ``nmf()`` call at fit time as
    lowest-priority defaults — layer-level kwargs override them
    (R/factor_net.R:103-108)."""
    maxit: int = 100
    tol: float = 1e-4
    loss: str = "mse"
    verbose: bool = False
    seed: Optional[int] = None
    norm: str = "L1"
    solver: str = "auto"
    test_fraction: float = 0.0
    cv_seed: int = 0
    mask_zeros: bool = False
    patience: int = 5
    dots: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}")
        if not (0.0 <= self.test_fraction < 1.0):
            raise ValueError("test_fraction must be in [0, 1)")

    def replace(self, **kw) -> "GlobalConfig":
        return dataclasses.replace(self, **kw)


def factor_config(maxit: int = 100, tol: float = 1e-4, loss: str = "mse",
                  verbose: bool = False, seed: Optional[int] = None,
                  norm: str = "L1", solver: str = "auto",
                  test_fraction: float = 0.0, cv_seed: int = 0,
                  mask_zeros: bool = False, patience: int = 5,
                  **dots) -> GlobalConfig:
    """Global network config (R/factor_net.R:126 ``factor_config()``).

    Extra keyword args land in ``dots`` and are forwarded network-wide to
    every layer's ``nmf()`` call as lowest-priority defaults."""
    return GlobalConfig(maxit=int(maxit), tol=float(tol), loss=loss,
                        verbose=bool(verbose), seed=seed, norm=norm,
                        solver=solver, test_fraction=float(test_fraction),
                        cv_seed=int(cv_seed), mask_zeros=bool(mask_zeros),
                        patience=int(patience), dots=dict(dots))


_SIDE_KEYS = {"L1", "L2", "L21", "angular", "upper_bound", "nonneg",
              "graph", "graph_lambda", "target", "target_lambda"}


def _side_config(**kw) -> dict:
    """Per-side factor config builder (R/factor_net.R ``W()``/``H()``)."""
    bad = set(kw) - _SIDE_KEYS
    if bad:
        raise ValueError(f"unknown factor-config keys {sorted(bad)}; "
                         f"valid: {sorted(_SIDE_KEYS)}")
    return dict(kw)


def W(**kw) -> dict:
    """R-style W-side config: ``nmf_layer(x, k, W=W(L1=0.1))``."""
    return _side_config(**kw)


def H(**kw) -> dict:
    """R-style H-side config: ``nmf_layer(x, k, H=H(L2=0.01))``."""
    return _side_config(**kw)


@dataclass
class LayerResult:
    W: np.ndarray
    d: np.ndarray
    H: np.ndarray
    iterations: int = 0
    loss: float = float("nan")
    test_loss: float = float("nan")
    best_test_loss: float = float("nan")
    converged: bool = False
    W_blocks: Optional[Dict[str, np.ndarray]] = None   # shared inputs: split W


@dataclass
class GraphResult:
    layers: Dict[str, LayerResult] = field(default_factory=dict)
    total_iterations: int = 0
    total_loss: float = float("nan")
    converged: bool = False
    logger: Optional[object] = None      # training_logger passed to fit()
    chain_topology: bool = True          # layer i feeds exactly layer i+1

    def __getitem__(self, name):
        return self.layers[name]

    def predict(self, newdata, device=None):
        """Project new samples through the fitted layers
        (R/factor_methods.R:742-777 predict.factor_net_result).

        Single layer: returns H_new (k, n_new).  Multi-layer: chains —
        each layer's H_new (transposed) feeds the next — and returns
        {layer_name: H_new}.  Multi-modal first layers need the
        modalities row-concatenated in training order.  Branched DAGs
        (Add/Concat/multi-input) have no single forward path for new
        samples, so projecting through them is refused rather than
        silently chaining embeddings through the wrong layers.  Each
        projection is one ``nnls`` on ``device`` (by default a tensor's own
        device, else the CUDA card).
        """
        from .project import nnls
        items = list(self.layers.items())
        if len(items) > 1 and not self.chain_topology:
            raise ValueError(
                "predict() supports linear-chain graphs only (each layer "
                "feeding the next); this net has Add/Concat/branched "
                "inputs — project through the individual layers manually")
        dev = fit_device(newdata, device)

        def _project(lr, X):
            W = np.asarray(lr.W) * np.asarray(lr.d)[None, :]
            return nnls(X, w=W, device=dev)

        if len(items) == 1:
            return _project(items[0][1], newdata)
        current = (newdata if isinstance(newdata, torch.Tensor)
                   else np.asarray(newdata, dtype=np.float32))
        out = {}
        for i, (name, lr) in enumerate(items):
            if i == 0:
                emb = np.asarray(_project(lr, current))   # (k1, n_new)
            else:
                # deeper layers factorize t(H_prev): new samples are new
                # ROWS there, so the projection basis is (d * H).T
                basis = np.asarray(lr.H).T * np.asarray(lr.d)[None, :]
                emb = np.asarray(nnls(current, w=basis, device=dev))
            out[name] = emb
            current = emb
        return out


class FactorNet:
    """Compiled factorization graph (graph/graph.hpp:115)."""

    def __init__(self, inputs: Sequence[Input], output: Node, *,
                 config: Optional[GlobalConfig] = None,
                 maxit: Optional[int] = None, tol: Optional[float] = None,
                 seed: Optional[int] = None, verbose: Optional[bool] = None,
                 device=None):
        self.inputs = list(inputs)
        self.output = output
        cfg = config or GlobalConfig()
        # direct kwargs override the global config (back-compat surface)
        self.config = cfg
        self.maxit = cfg.maxit if maxit is None else int(maxit)
        self.tol = cfg.tol if tol is None else float(tol)
        self.seed = (cfg.seed if seed is None else seed) or 0
        self.verbose = cfg.verbose if verbose is None else bool(verbose)
        self.device = device
        self._layers: List[Node] = []
        self._compiled = False
        self._fused_fn = None
        # per data node: (fingerprint, device tensor)
        self._dev_cache: dict = {}

    # -- topology ----------------------------------------------------------
    def compile(self) -> "FactorNet":
        """Topological collection + validation of layer nodes.

        DFS with an in-progress set so a cycle (only constructible by
        mutating node inputs after the functional builders) raises instead
        of silently fitting layers against stale upstream states."""
        done = set()
        in_progress = set()
        order: List[Node] = []

        def visit(node: Node):
            if id(node) in done:
                return
            if id(node) in in_progress:
                raise ValueError("graph contains a cycle")
            in_progress.add(id(node))
            if isinstance(node, (NMFLayer, SVDLayer)):
                visit(node.input)
                order.append(node)
            elif isinstance(node, Condition):
                visit(node.input)
            elif isinstance(node, (Concat, Add, Shared)):
                for branch in node.inputs:
                    visit(branch)
            elif isinstance(node, Input):
                pass
            else:
                raise TypeError(f"unknown node type {type(node)}")
            in_progress.discard(id(node))
            done.add(id(node))

        visit(self.output)
        if not order:
            raise ValueError("graph contains no factorization layers")
        names = [l.name for l in order]
        if len(set(names)) != len(names):
            raise ValueError("layer names must be unique")
        self._layers = order
        self._compiled = True
        return self

    @property
    def n_layers(self) -> int:
        return len(self._layers)

    # -- data resolution ---------------------------------------------------

    def _resolve_source(self, node: Node):
        """Walk conditions to the data-bearing node; return (source, Z_list)."""
        zs = []
        while isinstance(node, Condition):
            zs.append(node.Z)
            node = node.input
        return node, zs

    def _is_chain(self) -> bool:
        """True iff every layer i > 0 consumes exactly layer i-1's output
        (the only topology GraphResult.predict can forward new samples
        through)."""
        for i, layer in enumerate(self._layers):
            node, zs = self._resolve_source(layer.input)
            if i == 0:
                if not isinstance(node, (Input, Shared)):
                    return False
            else:
                if zs or node is not self._layers[i - 1]:
                    return False
        return True

    def _data_nodes(self):
        """The data-bearing (INPUT / SHARED) sources of the layers, once
        each, in layer order."""
        seen = {}
        for layer in self._layers:
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, (Input, Shared)):
                seen.setdefault(id(node), node)
        return list(seen.values())

    @staticmethod
    def _dense(d):
        """One input's data as a dense float32 matrix: a tensor stays a
        tensor on its device, anything else becomes a host array."""
        if isinstance(d, torch.Tensor):
            if d.ndim != 2:
                raise ValueError("data must be a 2-D matrix")
            return d.detach().to(torch.float32)
        if hasattr(d, "todense"):
            d = np.asarray(d.todense())
        return np.asarray(d, dtype=np.float32)

    def _input_matrix(self, node: Node):
        """Materialize the dense data for an INPUT / SHARED source node.

        Returns (matrix, row_blocks) where row_blocks maps input names to
        row slices for shared multi-modal splits.  The matrix is a host
        array, or a tensor where an input holds one (a SHARED node's host
        parts then join it on that tensor's device)."""
        if isinstance(node, Input):
            return self._dense(node.data), None
        if isinstance(node, Shared):
            mats = []
            blocks = {}
            row = 0
            ncols = None
            for inp in node.inputs:
                d = self._dense(inp.data)
                if ncols is None:
                    ncols = d.shape[1]
                elif d.shape[1] != ncols:
                    raise ValueError("shared inputs must have equal columns")
                blocks[inp.name] = slice(row, row + d.shape[0])
                row += d.shape[0]
                mats.append(d)
            on = [m.device for m in mats if isinstance(m, torch.Tensor)]
            if on:
                return torch.cat([_tensor(m, on[0]) for m in mats]), blocks
            return np.vstack(mats), blocks
        raise TypeError(f"cannot materialize data from {type(node)}")

    def _data_map(self):
        """node id -> (dense matrix, row blocks) of every data node."""
        return {id(node): self._input_matrix(node)
                for node in self._data_nodes()}

    def _on_device(self, nid, mat, dev) -> torch.Tensor:
        """A data node's matrix on ``dev``, uploaded once: re-fitting the
        same net must not upload the matrix again.  Cache entries carry a
        strided-sample fingerprint, so replacing (or mutating) a node's data
        invalidates them instead of silently fitting the old matrix."""
        if isinstance(mat, torch.Tensor):
            return _tensor(mat, dev)
        flat = np.ravel(mat)
        step = max(1, flat.size // 1024)
        fp = (mat.shape, str(mat.dtype), flat[::step].tobytes(), str(dev))
        cached = self._dev_cache.get(nid)
        if cached is not None and cached[0] == fp:
            return cached[1]
        t = device_matrix(mat, dev)
        self._dev_cache[nid] = (fp, t)
        return t

    def _device(self, data_map, device) -> torch.device:
        """Where the fit runs: ``device`` (else the net's), else the device
        of a tensor input, else the CUDA card (raises without one)."""
        if device is None:
            device = self.device
        tensors = [mat for mat, _ in data_map.values()
                   if isinstance(mat, torch.Tensor)]
        return fit_device(tensors[0] if tensors else None, device)

    # -- per-layer kwargs / config ----------------------------------------

    def _layer_kwargs(self, layer: Node):
        """Merged nmf() kwargs for one layer: global dots (lowest priority)
        < global named settings < layer kwargs / W-H side configs
        (graph/graph.hpp:246-286 build_layer_config).

        Returns (kw, arrays) with graph/target matrices split out into the
        ``arrays`` dict keyed graph_W/graph_H/target_W/target_H."""
        gc = self.config
        kw = dict(gc.dots)
        kw.update(layer.fit_kwargs)
        arrays = {}
        if isinstance(layer, SVDLayer):
            # SVD layers run the same outer-ALS machinery without the
            # nonnegativity constraint (graph/fit.hpp handles both layer
            # kinds through the NMF engine)
            kw.setdefault("nonneg", (False, False))
        if isinstance(layer, NMFLayer):
            for side, fc in (("W", layer.W), ("H", layer.H)):
                for key, val in fc.items():
                    if key in ("graph", "target"):
                        arrays[f"{key}_{side}"] = val
                        continue
                    arr = kw.get(key, [0.0, 0.0] if key != "nonneg"
                                 else [True, True])
                    # always copy before writing: kw values may alias the
                    # SHARED lists inside gc.dots / layer.fit_kwargs, and
                    # an in-place write would leak this layer's side
                    # config into every other layer and later fit
                    arr = [arr, arr] if np.isscalar(arr) else list(arr)
                    arr[0 if side == "W" else 1] = val
                    kw[key] = arr
            kw.setdefault("loss", layer.loss if layer.loss != "mse"
                          else gc.loss)
        kw.setdefault("solver", gc.solver)
        kw.setdefault("norm", gc.norm)
        # graph-level CV settings propagate to every layer (graph.hpp:263-267)
        kw.setdefault("test_fraction", gc.test_fraction)
        kw.setdefault("cv_seed", gc.cv_seed)
        kw.setdefault("mask_zeros", gc.mask_zeros)
        kw.setdefault("cv_patience", gc.patience)
        return kw, arrays

    # -- fitting -----------------------------------------------------------

    def _fit_layer(self, layer: Node, data, *, maxit, device, w_init=None,
                   tol=None, seed=None, sort_model=False):
        from ..api import nmf as nmf_api
        kw, arrays = self._layer_kwargs(layer)
        kw["maxit"] = maxit
        if tol is not None:
            kw["tol"] = tol
        kw.setdefault("seed", self.seed if seed is None else seed)
        kw["sort_model"] = sort_model
        return nmf_api(data, layer.k, w_init=w_init, device=device,
                       **arrays, **kw)

    def _effective_input(self, i: int, states, data_map, dev=None, zs=None):
        """graph/fit.hpp:95-185.  ``dev`` None: numpy on the host, the
        states LayerResults; else a contiguous tensor on ``dev`` built with
        ``torch.cat``, the data in ``data_map`` tensors there and the states
        LayerResults or (W_T, H, d) tensor tuples.  ``zs``: the layer's
        covariates already on ``dev`` (else they are uploaded here)."""
        layer = self._layers[i]
        node, z_host = self._resolve_source(layer.input)
        idx_of = {id(l): j for j, l in enumerate(self._layers)}

        def h_of(j):
            s = states[j]
            h = s.H if hasattr(s, "H") else s[1]
            return h if dev is None else _tensor(h, dev)

        def cat(parts):
            return (np.concatenate(parts, axis=1) if dev is None
                    else torch.cat(parts, dim=1))

        if isinstance(node, (Input, Shared)):
            result = data_map[id(node)][0]
        elif isinstance(node, Concat):
            parts = []
            for branch in node.inputs:
                b, _ = self._resolve_source(branch)
                j = idx_of.get(id(b))
                if j is None:
                    raise ValueError("concat branch is not a layer")
                parts.append(h_of(j).T)
            ns = {int(p.shape[0]) for p in parts}
            if len(ns) > 1:
                raise ValueError(
                    f"factor_concat branches have mismatched sample "
                    f"counts {sorted(ns)} (all branch H factors must "
                    f"cover the same columns)")
            result = cat(parts)
        elif isinstance(node, Add):
            total = None
            for branch in node.inputs:
                b, _ = self._resolve_source(branch)
                j = idx_of.get(id(b))
                if j is None:
                    raise ValueError("add branch is not a layer")
                h = h_of(j)
                if total is not None and h.shape != total.shape:
                    raise ValueError(
                        f"factor_add branches have mismatched H shapes "
                        f"{tuple(total.shape)} vs {tuple(h.shape)} (equal "
                        f"rank k and equal sample count required)")
                total = h if total is None else total + h
            result = total.T
        elif isinstance(node, (NMFLayer, SVDLayer)):
            result = h_of(idx_of[id(node)]).T                # n x k_prev
        else:
            raise TypeError(f"bad input node {type(node)}")

        if zs is None:
            zs = z_host if dev is None else [_tensor(Z, dev) for Z in z_host]
        for Z in reversed(zs):
            n = result.shape[0]
            Zo = Z if Z.shape[0] == n else Z.T
            if Zo.shape[0] != n:
                raise ValueError("conditioning Z dimension mismatch")
            result = cat([result, Zo])
        return result if dev is None else result.contiguous()

    # -- fused on-device deep fit -----------------------------------------

    def _deep_cfgs(self):
        """Per-layer (NMFConfig, aux arrays) for the fused path; None if a
        layer needs machinery the fused sweep doesn't cover (IRLS / CV /
        projective / symmetric / robust)."""
        from ..api import build_config
        from ..config import Loss
        out = []
        for layer in self._layers:
            kw, arrays = self._layer_kwargs(layer)
            for drop in ("maxit", "verbose", "seed", "sort_model"):
                kw.pop(drop, None)
            try:
                cfg = build_config(layer.k, maxit=1, sort_model=False,
                                   seed=self.seed,
                                   has_graph_W="graph_W" in arrays,
                                   has_graph_H="graph_H" in arrays,
                                   has_target_W="target_W" in arrays,
                                   has_target_H="target_H" in arrays,
                                   **kw)
            except (TypeError, ValueError):
                return None
            if (cfg.loss != Loss.MSE or cfg.requires_irls() or cfg.is_cv()
                    or cfg.projective or cfg.symmetric):
                return None
            aux = {}
            for key, mat in arrays.items():
                t = _as_f32(mat)
                aux[key] = t
                fc = cfg.W if key.endswith("_W") else cfg.H
                if key.startswith("target") and fc.target_lambda < 0:
                    aux[key + "_gram"] = (t @ t.T) / t.shape[1]
            out.append((cfg, aux))
        return out

    def _warm_states(self, dev_map, dev, zs):
        """Warmup fits per layer (fit.hpp:280-300) on the device-resident
        inputs, in layer order, seeded ``seed_base + i``; the warm factors
        uploaded contiguous (W_T row-major, as every later factor is)."""
        init_maxit = min(10, self.maxit)
        seed_base = self.seed if self.seed else 42
        states: List[tuple] = [None] * self.n_layers      # type: ignore
        self._warm_iterations = []
        for i, layer in enumerate(self._layers):
            inp = self._effective_input(i, states, dev_map, dev, zs=zs[i])
            res = self._fit_layer(layer, inp, maxit=init_maxit,
                                  seed=seed_base + i, device=dev)
            states[i] = (_tensor(res.W.T, dev), _tensor(res.H, dev),
                         _tensor(res.d, dev))
            self._warm_iterations.append(res.iterations)
        return states

    def _layer_zs(self, dev):
        """Each layer's covariates on ``dev``, uploaded once a fit (a copy
        from pageable host memory waits for the device)."""
        return [[_tensor(Z, dev) for Z in self._resolve_source(l.input)[1]]
                for l in self._layers]

    def _fit_deep_fused(self, data_map, dev, logger=None,
                        warm_states=None, mesh=None) -> Optional[GraphResult]:
        """The outer ALS on the device.  Returns None when ineligible (then
        the host-driven loop runs, exactly like the reference).
        ``warm_states``: per layer (W_T, H, d) tensors on ``dev`` to start
        from instead of the warmup fits (``convert.graph_states_from_numpy``
        carries another package's across).

        ``mesh``: a ``parallel.mesh.Mesh`` every rank of which runs this
        alike (the JAX package's ``_fit_deep_fused(mesh=)``).  The warmup
        fits run on the unpadded data, alike on every rank, so that mesh
        and single-device nets start from the same factors bit for bit.
        Each data layer's input (its data with any covariate columns) is
        zero-padded to the mesh and split (rows, cols); its updates are
        ``make_updates(ctx=)``'s, its loss is taken over the true element
        count and its reconstruction's norm from Grams summed over the
        mesh.  A deeper layer's input, an upstream H^T (n x k_prev, small),
        is gathered whole and that layer runs unpadded and alike on every
        rank.  The pads are cut off before packaging."""
        cfgs_auxs = self._deep_cfgs()
        if cfgs_auxs is None:
            if mesh is not None:
                raise ValueError(
                    "mesh= requires the fused graph path; this graph has "
                    "a layer configuration (IRLS loss / CV holdout / "
                    "streaming input) that runs on the host loop")
            return None
        set_fp32_precision()
        dev_map = {nid: (self._on_device(nid, mat, dev), None)
                   for nid, (mat, _) in data_map.items()}
        zs = self._layer_zs(dev)
        if warm_states is None:
            warm_states = self._warm_states(dev_map, dev, zs)
        auxs = [{key: _tensor(v, dev) for key, v in aux.items()}
                for _, aux in cfgs_auxs]
        cfgs = [cfg for cfg, _ in cfgs_auxs]
        shards = None
        if mesh is not None:
            shards, warm_states = self._shard_data_layers(
                mesh, cfgs, dev_map, dev, zs, warm_states)
        # the whole outer ALS as one call, as the JAX package's executable
        self._fused_fn = functools.partial(_outer_als, self, cfgs,
                                           shards=shards)
        out_states, it, loss, conv, hist = self._fused_fn(
            dev_map, zs, auxs, warm_states)
        hist = hist.cpu().numpy()
        loss, conv = float(loss), bool(conv)

        out = GraphResult(total_iterations=it, total_loss=loss,
                          converged=conv, chain_topology=self._is_chain())
        if logger is not None:
            names = [l.name for l in self._layers]
            for t in range(it):
                logger.records.append({
                    "iter": t + 1,
                    "train_loss": float(hist[t, 0]),
                    **{f"{nm}_loss": float(hist[t, 1 + j])
                       for j, nm in enumerate(names)},
                    **{f"{nm}_frobenius":
                       float(hist[t, 1 + len(names) + j])
                       for j, nm in enumerate(names)},
                })
            out.logger = logger
        for i, layer in enumerate(self._layers):
            W_T, Hm, d = out_states[i]
            if shards is not None and shards[i] is not None:
                # the whole factors on every rank; the pads solve to zero
                ctx = shards[i][0]
                W_T = ctx.gather_rows(W_T)[:, :ctx.m]
                Hm = ctx.gather_cols(Hm)[:, :ctx.n]
            W_T, Hm, d = (x.cpu().numpy() for x in (W_T, Hm, d))
            # per-layer loss from the history row of the last completed
            # sweep (hist[:, 1+i]); the total is on the GraphResult
            layer_loss = float(hist[it - 1, 1 + i]) if it > 0 else float("nan")
            s = LayerResult(W=W_T.T, d=d, H=Hm, iterations=it,
                            loss=layer_loss, converged=conv)
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, Shared):
                _, blocks = data_map[id(node)]
                s.W_blocks = {name: s.W[sl] for name, sl in blocks.items()}
            out.layers[layer.name] = s
        return out

    def _shard_data_layers(self, mesh, cfgs, dev_map, dev, zs, states):
        """Per layer, (``ShardContext``, this rank's block of the layer's
        input, the input's true element count) for a data layer (its source
        an INPUT / SHARED node), None for a deeper layer; and the warm
        states with each data layer's W_T and H cut to this rank's blocks,
        zero-padded."""
        from ..parallel.mesh import (ShardContext, check_pad_soundness,
                                     mesh_padding)
        shards, out = [], []
        for i, layer in enumerate(self._layers):
            node, _ = self._resolve_source(layer.input)
            if not isinstance(node, (Input, Shared)):
                shards.append(None)
                out.append(states[i])
                continue
            B = self._effective_input(i, [], dev_map, dev, zs=zs[i])
            a, b = B.shape
            check_pad_soundness(cfgs[i], *mesh_padding(mesh, a, b))
            ctx = ShardContext(mesh, a, b)
            shards.append((ctx, ctx.block(B, dev), a * b))
            W_T, Hm, d = states[i]
            out.append((ctx.row_block(W_T), ctx.col_block(Hm), d))
        return shards, out

    def fit(self, logger=None, mesh=None, device=None) -> GraphResult:
        if not self._compiled:
            self.compile()
        if mesh is not None and self.n_layers == 1:
            raise ValueError("mesh= on a single-layer graph: call "
                             "nmf(..., mesh=) / fit_sharded directly")

        # materialize data-bearing nodes once; then the device (everything
        # that needs none is checked by now)
        data_map = self._data_map()
        if mesh is not None:
            from ..parallel.mesh import rank_device
            dev = rank_device(mesh, device if device is not None
                              else self.device)
        else:
            dev = self._device(data_map, device)

        if self.n_layers == 1:
            layer = self._layers[0]
            node, zs = self._resolve_source(layer.input)
            data, blocks = data_map[id(node)]
            # Condition covariates (zs) are appended by _effective_input —
            # the raw matrix would silently drop them (graph/fit.hpp:95-185
            # applies conditioning on the single-layer path too)
            if zs or not isinstance(node, (Input, Shared)):
                # a tensor input on the fit's device, a host array on the host
                on = dev if isinstance(data, torch.Tensor) else None
                data = self._effective_input(
                    0, [], data_map if on is None
                    else {id(node): (_tensor(data, on), None)}, on)
            res = self._fit_layer(layer, data, maxit=self.maxit, tol=self.tol,
                                  sort_model=True, device=dev)
            lr = LayerResult(W=res.W, d=res.d, H=res.H,
                             iterations=res.iterations, loss=res.train_loss,
                             test_loss=res.test_loss,
                             best_test_loss=res.misc.get(
                                 "best_test_loss", float("nan")),
                             converged=res.converged)
            if blocks:
                lr.W_blocks = {name: res.W[sl] for name, sl in blocks.items()}
            out = GraphResult(layers={layer.name: lr},
                              total_iterations=res.iterations,
                              total_loss=res.train_loss,
                              converged=res.converged)
            if logger is not None:
                logger.attach_history(res)
                out.logger = logger
            return out

        # ---- multi-layer outer ALS ----
        fused = self._fit_deep_fused(data_map, dev, logger=logger, mesh=mesh)
        if fused is not None:
            if self.verbose:
                print(f"  fused outer ALS: {fused.total_iterations} iters, "
                      f"loss = {fused.total_loss:.6g}")
            return fused
        return self._fit_host_loop(data_map, dev, logger)

    def _fit_host_loop(self, data_map, dev, logger) -> GraphResult:
        """The host-driven outer loop (graph/fit.hpp:265-355): IRLS losses,
        CV holdouts.  The data and the per-layer losses stay on ``dev``;
        the host reads the layers' losses and norms once a sweep."""
        set_fp32_precision()
        dev_map = {nid: (self._on_device(nid, mat, dev), None)
                   for nid, (mat, _) in data_map.items()}
        zs = self._layer_zs(dev)
        n_layers = self.n_layers
        states: List[LayerResult] = [None] * n_layers       # type: ignore
        init_maxit = min(10, self.maxit)
        seed_base = self.seed if self.seed else 42

        for i, layer in enumerate(self._layers):
            inp = self._effective_input(i, states, dev_map, dev, zs=zs[i])
            res = self._fit_layer(layer, inp, maxit=init_maxit,
                                  seed=seed_base + i, device=dev)
            states[i] = LayerResult(W=res.W, d=res.d, H=res.H,
                                    test_loss=res.test_loss)

        prev_loss = np.inf
        total_iter = 0
        converged = False
        for _outer in range(self.maxit):
            for i, layer in enumerate(self._layers):
                inp = self._effective_input(i, states, dev_map, dev, zs=zs[i])
                res = self._fit_layer(layer, inp, maxit=1, tol=0.0,
                                      w_init=states[i].W,
                                      seed=seed_base + i, device=dev)
                states[i] = LayerResult(W=res.W, d=res.d, H=res.H,
                                        test_loss=res.test_loss)
            total_iter += 1

            per_layer = []
            for i in range(n_layers):
                inp = self._effective_input(i, states, dev_map, dev, zs=zs[i])
                s = states[i]
                recon = (_tensor(s.W, dev) * _tensor(s.d, dev)[None, :]) \
                    @ _tensor(s.H, dev)
                per_layer += [((inp - recon) ** 2).mean(),
                              torch.linalg.vector_norm(recon)]
            vals = torch.stack(per_layer).tolist()       # one read a sweep
            cur_loss = 0.0
            entry = {}
            for i, layer in enumerate(self._layers):
                lyr, frob = vals[2 * i], vals[2 * i + 1]
                cur_loss += lyr
                entry[f"{layer.name}_loss"] = lyr
                entry[f"{layer.name}_frobenius"] = frob
            if logger is not None:
                logger.records.append(
                    {"iter": total_iter, "train_loss": cur_loss, **entry})
            if self.verbose:
                print(f"  outer iter {total_iter}: loss = {cur_loss:.6g}")
            if np.isfinite(prev_loss):
                rel = abs(prev_loss - cur_loss) / (abs(prev_loss) + 1e-15)
                if rel < self.tol:
                    converged = True
                    prev_loss = cur_loss
                    break
            prev_loss = cur_loss

        out = GraphResult(total_iterations=total_iter,
                          total_loss=float(prev_loss), converged=converged,
                          logger=logger, chain_topology=self._is_chain())
        for i, layer in enumerate(self._layers):
            s = states[i]
            s.iterations = total_iter
            # the JAX package's host loop gives every layer the total loss
            s.loss = float(prev_loss)
            s.converged = converged
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, Shared):
                _, blocks = data_map[id(node)]
                s.W_blocks = {name: s.W[sl] for name, sl in blocks.items()}
            out.layers[layer.name] = s
        return out


def _outer_als(net: FactorNet, cfgs, data_map, zs, auxs, states, *,
               shards=None):
    """The fused outer ALS (the JAX package's ``_build_fused`` loop body):
    per sweep and layer, the effective input, ``h_update`` then ``w_update``
    of ``make_updates`` at iteration ``it + 1`` (CD warm-starts from the
    first sweep on; a deeper layer reads the upstream H of this sweep), the
    layer's loss by the saved-matrix Gram trick over its input's element
    count and its reconstruction's Frobenius norm from the k x k Grams; then
    the relative-tolerance test without patience.  Returns (states, sweeps,
    total loss, converged flag, history); the history (maxit, 1 + 2L) stays
    on the device.  With ``net.tol > 0`` the host reads the convergence flag
    once a sweep (counted in ``_outer_als.host_reads``), with ``tol == 0``
    never: ``rel < 0`` cannot hold.

    ``shards``: under a mesh, per layer (``ShardContext``, this rank's block
    of the input, the input's true element count) for a data layer, whose
    state is then this rank's blocks; None for a layer that runs whole on
    every rank, its input built from the upstream H gathered whole."""
    n_layers = net.n_layers
    tol, maxit = net.tol, net.maxit
    shards = shards or [None] * n_layers
    updates = [make_updates(cfg, aux, sh[0] if sh else None)
               for cfg, aux, sh in zip(cfgs, auxs, shards)]
    dev = states[0][0].device
    f32 = torch.float32
    hist = torch.full((maxit, 1 + 2 * n_layers), float("nan"), dtype=f32,
                      device=dev)
    prev = torch.tensor(float("inf"), dtype=f32, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    states = list(states)
    mesh_ctx = next((sh[0] for sh in shards if sh is not None), None)
    # a data layer's tr(B'B) does not change: summed over the mesh once
    tr_blk = [None if sh is None else sh[0].sum_all((sh[1] * sh[1]).sum())
              for sh in shards]

    def whole(j):
        """Layer j's state with H whole (a deeper layer's input reads it)."""
        if shards[j] is None:
            return states[j]
        ctx = shards[j][0]
        return (None, ctx.gather_cols(states[j][1])[:, :ctx.n], None)

    it = 0
    while it < maxit:
        total = torch.zeros((), dtype=f32, device=dev)
        layer_losses, frobs = [], []
        for i in range(n_layers):
            h_upd, w_upd, _ = updates[i]
            sh = shards[i]
            if sh is None:
                B = net._effective_input(i, _Upstream(whole), data_map, dev,
                                         zs=zs[i])
            else:
                B = sh[1]
            W_T, Hm, d = states[i]
            Hm, d = h_upd(B, W_T, Hm, d, it + 1)
            W_T, Hm, d, B_w, G_w = w_upd(B, W_T, Hm, d, it + 1)
            states[i] = (W_T, Hm, d)
            # per-layer mean-squared loss via the saved-matrix Gram trick
            # (fit.hpp:334-344 computes the dense recon; this avoids the
            # (m, n) intermediate); under a mesh over the true element
            # count, the pads adding nothing to the sum
            Wd = W_T * d[:, None]
            if sh is None:
                sse = linalg.mse_loss_from_saved((B * B).sum(), W_T, d, B_w,
                                                 G_w)
                lyr = sse / B.numel()
                GW, GH = Wd @ Wd.T, Hm @ Hm.T
            else:
                ctx = sh[0]
                sse = linalg.mse_loss_from_saved(tr_blk[i], W_T, d, B_w,
                                                 G_w, ctx.rows)
                lyr = sse / sh[2]
                GW, GH = ctx.sum_rows(Wd @ Wd.T), ctx.sum_cols(Hm @ Hm.T)
            total = total + lyr
            layer_losses.append(lyr)
            # recon Frobenius norm via the k x k Gram trick:
            # ||W diag(d) H||_F^2 = tr(diag(d) W'W diag(d) HH')
            frobs.append(torch.sqrt(torch.clamp((GW * GH).sum(), min=0.0)))
        if mesh_ctx is not None:
            # every rank holds the same sums; the tolerance test still
            # reads rank 0's
            total = mesh_ctx.agree(total)
        rel = (prev - total).abs() / (prev.abs() + 1e-15)
        conv = torch.isfinite(prev) & (rel < tol)
        # training_logger history (R/training_log.R records total loss +
        # per-layer Frobenius norms each outer iteration)
        hist[it, 0] = total
        hist[it, 1:1 + n_layers] = torch.stack(layer_losses)
        hist[it, 1 + n_layers:] = torch.stack(frobs)
        prev = total
        it += 1
        if tol > 0:
            _outer_als.host_reads += 1
            if bool(conv):
                break
    return states, it, prev, conv, hist


_outer_als.host_reads = 0


class _Upstream:
    """The layers' states as :meth:`FactorNet._effective_input` reads them,
    each made (its H gathered, under a mesh) only when a layer reads it."""

    def __init__(self, state_of):
        self._state_of = state_of

    def __getitem__(self, j):
        return self._state_of(j)


def factor_net(inputs, output, *, config: Optional[GlobalConfig] = None,
               maxit: Optional[int] = None, tol: Optional[float] = None,
               seed: Optional[int] = None, verbose: Optional[bool] = None,
               device=None) -> FactorNet:
    """Build (and compile) a FactorNet (R/factor_net.R factor_net()).
    ``device``: where :func:`fit` runs it unless told otherwise."""
    if isinstance(inputs, Input):
        inputs = [inputs]
    return FactorNet(inputs, output, config=config, maxit=maxit, tol=tol,
                     seed=seed, verbose=verbose, device=device).compile()


def fit(net: FactorNet, *, logger=None, mesh=None, device=None) -> GraphResult:
    """Fit a compiled FactorNet.  ``logger`` is a ``training_logger()``
    that records one entry per outer iteration: total loss, per-layer
    loss, and per-layer reconstruction Frobenius norm
    (R/factor_methods.R fit.factor_net logger wiring).  ``device``: where
    the fit runs (by default the net's, else a tensor input's device, else
    the CUDA card: without one it raises).  ``mesh``: a
    ``parallel.mesh.Mesh``, every rank of it calling this alike; the outer
    ALS runs on it and every rank gets the whole result
    (:meth:`FactorNet._fit_deep_fused`).  A single-layer graph and one
    that needs the host loop (IRLS losses, CV holdouts, projective or
    symmetric layers) raise ``ValueError`` there."""
    return net.fit(logger=logger, mesh=mesh, device=device)


# ---------------------------------------------------------------------------
# Cross-validation grid / random search (R/cross_validate_graph.R:86-231)
# ---------------------------------------------------------------------------

@dataclass
class GraphCVResult:
    """``factor_net_cv``: per-fit rows, per-combo summary, winning params."""
    results: List[dict]
    summary: List[dict]
    best_params: dict
    config: GlobalConfig
    params: dict
    strategy: str
    reps: int
    all_fits: Optional[list] = None

    def __repr__(self):
        lines = ["factor_net cross-validation",
                 f"  Strategy: {self.strategy} | Reps: {self.reps} | "
                 f"Combos: {len(self.summary)}",
                 f"  Holdout: {self.config.test_fraction * 100:.1f}%",
                 f"  Best: " + ", ".join(f"{k} = {v}"
                                         for k, v in self.best_params.items())]
        return "\n".join(lines)


def cross_validate_graph(inputs, layer_fn, params: dict, *,
                         config: Optional[GlobalConfig] = None,
                         reps: int = 3, strategy: str = "grid",
                         n_random: int = 20, seed: int = 42,
                         verbose: bool = False,
                         keep_fits: bool = False,
                         device=None) -> GraphCVResult:
    """Hyperparameter grid/random search with speckled-holdout CV
    (R/cross_validate_graph.R:86).

    ``layer_fn(p)`` receives one named parameter combination (a dict) and
    returns the output layer node; each combination is fitted ``reps``
    times with per-rep CV seeds ``seed + ci*reps + ri`` and ranked by mean
    held-out test loss.  A combination whose fit fails is kept as a NaN row
    with a warning.  ``device``: where every fit runs (by default a tensor
    input's device, else the CUDA card; without one it raises before the
    first fit).

    Example::

        inp = factor_input(X)
        cv = cross_validate_graph(
            inp, lambda p: nmf_layer(inp, p["k"], W=W(L1=p["L1"])),
            params={"k": [3, 5, 10], "L1": [0.0, 0.01]},
            config=factor_config(maxit=50, seed=42))
        cv.best_params
    """
    if strategy not in ("grid", "random"):
        raise ValueError("strategy must be 'grid' or 'random'")
    if not callable(layer_fn):
        raise ValueError("'layer_fn' must be a function(p) returning the "
                         "output layer node")
    if not isinstance(params, dict) or not params:
        raise ValueError("'params' must be a non-empty dict of parameter "
                         "value lists")

    cfg = config or factor_config()
    if cfg.test_fraction == 0:
        cfg = cfg.replace(test_fraction=0.1)
    if isinstance(inputs, Input):
        inputs = [inputs]
    # the device before any fit: without a card this raises here, not in
    # every combination's fit (which would turn into NaN rows)
    tensors = [inp.data for inp in inputs
               if isinstance(inp.data, torch.Tensor)]
    dev = fit_device(tensors[0] if tensors else None, device)

    names = list(params)
    grid = [dict(zip(names, combo))
            for combo in itertools.product(*(params[n] for n in names))]
    if strategy == "random" and len(grid) > n_random:
        rs = np.random.RandomState(seed)
        pick = rs.choice(len(grid), size=n_random, replace=False)
        grid = [grid[i] for i in sorted(pick)]

    if verbose:
        print(f"Cross-validating {len(grid)} parameter combinations x "
              f"{reps} reps = {len(grid) * reps} fits")

    results: List[dict] = []
    fits = [] if keep_fits else None
    for ci, p in enumerate(grid):
        if verbose:
            print(f"  [{ci + 1}/{len(grid)}] "
                  + ", ".join(f"{k} = {v}" for k, v in p.items()))
        for ri in range(1, reps + 1):
            rep_cv_seed = int(seed + ci * reps + ri)
            cv_cfg = cfg.replace(cv_seed=rep_cv_seed)
            row = dict(p)
            row.update(combo=ci, rep=ri, test_loss=float("nan"),
                       train_loss=float("nan"), iterations=0,
                       converged=False)
            try:
                output = layer_fn(dict(p))
                net = factor_net(inputs, output, config=cv_cfg, device=dev)
                res = net.fit()
            except Exception as e:                       # noqa: BLE001
                warnings.warn(f"fit failed for combo {ci + 1}, rep {ri}: {e}")
                results.append(row)
                if fits is not None:
                    fits.append(None)
                continue
            first = res.layers[net._layers[0].name]
            row.update(test_loss=float(first.test_loss),
                       train_loss=float(first.loss),
                       iterations=int(first.iterations),
                       converged=bool(first.converged))
            results.append(row)
            if fits is not None:
                fits.append(res)

    summary = []
    for ci, p in enumerate(grid):
        tl = [r["test_loss"] for r in results
              if r["combo"] == ci and np.isfinite(r["test_loss"])]
        trl = [r["train_loss"] for r in results
               if r["combo"] == ci and np.isfinite(r["train_loss"])]
        summary.append(dict(
            p, combo=ci,
            mean_test_loss=float(np.mean(tl)) if tl else float("nan"),
            se_test_loss=(float(np.std(tl, ddof=1) / np.sqrt(len(tl)))
                          if len(tl) > 1 else float("nan")),
            mean_train_loss=float(np.mean(trl)) if trl else float("nan"),
            n_valid=len(tl)))
    summary.sort(key=lambda s: (np.isnan(s["mean_test_loss"]),
                                s["mean_test_loss"]))
    best = summary[0] if summary else {}
    best_params = {k: best[k] for k in names} if best else {}

    if verbose and best:
        print(f"\nBest: " + ", ".join(f"{k} = {v}"
                                      for k, v in best_params.items())
              + f" -> test_loss = {best['mean_test_loss']:.6f}")

    return GraphCVResult(results=results, summary=summary,
                         best_params=best_params, config=cfg, params=params,
                         strategy=strategy, reps=reps, all_fits=fits)
