"""Multi-rank execution: a 2-D (rows, cols) mesh over torch.distributed.

The port of ``rcppml_tpu/parallel/mesh.py``.  There one program runs on a
mesh of devices and GSPMD places every all-reduce from the data shardings.
Here one process runs one rank (SPMD: every rank calls the same fit on its
own block), and the collectives are written out in the updates, through a
:class:`ShardContext`:

  * A is split (rows, cols) over the mesh;
  * W_T (k, m_i) is split over "rows" and the same on every "cols" rank;
  * H (k, n_j) is split over "cols" and the same on every "rows" rank;
  * d is the same on every rank;
  * each dimension is zero-padded to divide the mesh (:func:`pad_to_mesh`);
  * the H side's Gram and right-hand side sum over "rows", the W side's over
    "cols"; the row sums or norms of H sum over "cols", those of W_T over
    "rows"; tr(A'A) and the losses sum over both.

The updates use only all-gather and broadcast (a sum is every rank's part
gathered, then added in rank order: :func:`_reduce`), which gloo runs on
CUDA tensors too: ranks that share one card join with ``backend="gloo"``
(NCCL refuses two ranks on one card).  Every rank returns the whole result
on the host, as the JAX package's single controller does: W's row blocks
are gathered over "rows" and H's column blocks over "cols".
"""

from __future__ import annotations

import concurrent.futures
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Dispersion, NMFConfig

AXES = ("rows", "cols")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A (rows, cols) grid of ranks, one process each.

    ``shape`` (``{"rows": r, "cols": c}``), ``axis_names`` and ``devices``
    (the (r, c) grid of every rank's ``torch.device``) are those of
    ``jax.sharding.Mesh``.  Rank ``i * c + j`` of the default process group
    sits at (i, j); ``coords`` is this process's place, None for a process
    outside the mesh.  ``group(axis)`` is the process group over ``"rows"``
    (the ranks of this rank's column), ``"cols"`` (of its row) or ``"all"``;
    None where that group has one rank."""
    axis_names = AXES

    def __init__(self, devices: np.ndarray, rank: int, groups: dict):
        self.devices = devices
        r, c = devices.shape
        self.shape = {"rows": r, "cols": c}
        self.size = r * c
        self.rank = rank
        self.coords = divmod(rank, c) if rank < self.size else None
        self._groups = groups

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh "
                             f"{self.shape}")
        return self.devices[self.coords]

    @property
    def comm_device(self) -> torch.device:
        """Where this rank's point-to-point buffers live: the host under
        gloo, the rank's card under NCCL."""
        if self.size > 1 and dist.get_backend() == "nccl":
            return self.device
        return torch.device("cpu")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def check_device_health(devices=None, *, timeout: float = 60.0):
    """Verify that every device computes: a tiny computation on each, with a
    timeout, so that a hung device is reported instead of deadlocking the
    job (a dead card is caught when the mesh is made, not in the middle of a
    fit).  ``devices``: default every CUDA card this process sees (without
    one it raises: pass ``devices=["cpu"]`` to probe the host).  Raises
    RuntimeError naming the failing devices; returns the devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("check_device_health: no CUDA device is "
                               "visible; pass devices= to probe others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]

    def probe(dev):
        x = torch.tensor([1.0, 2.0], dtype=torch.float32, device=dev)
        y = (x * 2.0 + 1.0).cpu().numpy()
        if not np.allclose(y, [3.0, 5.0]):
            raise RuntimeError(f"wrong arithmetic result {y}")

    bad = []
    hung = False
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    try:
        futs = {ex.submit(probe, d): d for d in devices}
        for fut, dev in futs.items():
            try:
                fut.result(timeout=timeout)
            except concurrent.futures.TimeoutError:
                hung = True
                bad.append(f"{dev}: no response within {timeout:.0f}s (hung)")
            except Exception as e:                       # noqa: BLE001
                bad.append(f"{dev}: {e!r}")
    finally:
        # a probe stuck on a wedged device would make shutdown(wait=True)
        # block forever, the deadlock this check exists to prevent: leave a
        # hung worker thread behind instead
        ex.shutdown(wait=not hung, cancel_futures=True)
    if bad:
        raise RuntimeError("unhealthy devices at mesh init:\n  "
                           + "\n  ".join(bad))
    return devices


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _every_rank_device(world: int) -> list:
    """Each rank's device, in rank order (this process's from
    :func:`multihost.local_device`, the others' gathered)."""
    from .multihost import local_device
    mine = local_device()
    if world == 1:
        return [mine]
    names = [None] * world
    dist.all_gather_object(names, str(mine))
    return [torch.device(name) for name in names]


def _axis_groups(r: int, c: int, world: int, rank: int) -> dict:
    """The process groups of a (r, c) mesh over ranks 0 .. r*c - 1.  Every
    process of the default group creates every group, in the same order, as
    ``dist.new_group`` requires; an axis of one rank gets None."""
    groups = {"rows": None, "cols": None, "all": None}
    if r * c == 1:
        return groups
    inside = rank < r * c
    if r > 1:
        for j in range(c):
            g = dist.new_group([i * c + j for i in range(r)])
            if inside and rank % c == j:
                groups["rows"] = g
    if c > 1:
        for i in range(r):
            g = dist.new_group([i * c + j for j in range(c)])
            if inside and rank // c == i:
                groups["cols"] = g
    groups["all"] = (dist.group.WORLD if r * c == world
                     else dist.new_group(list(range(r * c))))
    return groups


def default_mesh(devices=None, shape=None, *,
                 health_check: bool = False) -> Mesh:
    """Build a (rows, cols) mesh over the ranks of the default process group.

    ``devices``: optional, each rank's device in rank order (default: every
    rank's own, from :func:`multihost.local_device`; without a process group
    the world is this one process).  ``shape``: optional (n_rows, n_cols);
    by default the most square factorization of the device count, biased to
    "cols" (samples usually outnumber features).  A shape that needs more
    ranks than the world has raises ValueError: a mesh of several devices
    inside one process, as JAX builds on 8 virtual CPU devices, has no
    torch counterpart.  ``health_check=True`` probes this rank's device
    first (:func:`check_device_health`).  Every rank of the world must call
    this, in the same order, with the same arguments."""
    world, rank = _world()
    devs = (_every_rank_device(world) if devices is None
            else [torch.device(d) for d in devices])
    n = len(devs)
    if shape is None:
        r = int(math.sqrt(n))
        while n % r:
            r -= 1
        shape = (r, n // r)
    r, c = (int(s) for s in shape)
    if r < 1 or c < 1:
        raise ValueError(f"mesh shape {(r, c)} must be positive")
    if r * c > world:
        raise ValueError(
            f"mesh shape {(r, c)} needs {r * c} ranks and the world has "
            f"{world}: start one process per rank (torchrun, or "
            "multihost.initialize in each)")
    if r * c > n:
        raise ValueError(f"mesh shape {(r, c)} needs {r * c} devices, "
                         f"{n} given")
    if health_check and rank < r * c:
        check_device_health([devs[rank]])
    grid = np.empty((r, c), dtype=object)
    for i in range(r * c):
        grid[divmod(i, c)] = devs[i]
    return Mesh(grid, rank, _axis_groups(r, c, world, rank))


# ---------------------------------------------------------------------------
# The shard context: a rank's block and the collectives of its updates
# ---------------------------------------------------------------------------

# bytes this process received through the collectives: "gathered" by the
# all-gathers of the updates (every sum and gather), "to_root" by rank 0's
# gathers of checkpointed state (``ShardContext.gather_to_root``)
traffic = {"gathered": 0, "to_root": 0}


def _parts(x: torch.Tensor, group) -> list:
    """Every rank's contiguous ``x`` over ``group``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    traffic["gathered"] += x.numel() * x.element_size() * len(parts)
    return parts


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``: every rank's ``x`` all-gathered, then
    added in the group's rank order.  The order is the mesh's own, not the
    backend's (gloo's ring and NCCL's trees add in other orders, which part
    in the last bit), so a sharded fit's bits do not depend on the backend,
    and a one-device fit that adds its block partials in this order makes
    the same ones.  It moves the group's size times the bytes of an
    all-reduce: the sums here are Grams, right-hand sides, row norms and
    per-column Grams (k^2 floats a column, below the rank's block of A while
    k^2 is below its rows).  An empty ``x`` (the valid part of a block that
    is all pads; every rank of the group has the same shape) is returned as
    it is."""
    if x.numel() == 0:
        return x
    parts = _parts(x.reshape(-1).contiguous(), group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.reshape(x.shape)


class Axis:
    """The collectives over one mesh axis (or over all of it).  With
    ``group`` None (an axis of one rank) each returns its argument."""

    def __init__(self, group=None):
        self.group = group

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.group is None else _reduce(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The blocks of every rank of the axis, in order, joined along
        ``dim``."""
        if self.group is None:
            return x
        return torch.cat(_parts(x.contiguous(), self.group), dim=dim)


NO_AXIS = Axis()


class ShardContext:
    """One rank's block of a sharded fit and the collectives its updates use.

    ``m``, ``n``: the true dimensions of A; ``M``, ``N``: padded to divide the
    mesh; ``m_blk``, ``n_blk``: the block's extents; ``row0``, ``col0``: its
    global offsets; ``vm``, ``vn``: its valid extents (the pads are a suffix
    of each dimension, so the valid part of a block is its top-left corner).
    ``rows`` / ``cols`` / ``all`` are :class:`Axis` objects; ``sum_rows``,
    ``sum_cols``, ``sum_all``, ``gather_rows`` and ``gather_cols`` are their
    methods.  Without a mesh (``mesh=None``: a fit on one device, with
    ``padded=(M, N)`` for a matrix zero-padded beyond the true (m, n)) every
    collective returns its argument untouched."""

    def __init__(self, mesh: Optional[Mesh], m: int, n: int, *,
                 padded: Optional[tuple] = None):
        self.m, self.n = int(m), int(n)
        if mesh is None:
            self.M, self.N = padded if padded is not None else (m, n)
            r = c = 1
            ri = ci = 0
        else:
            pm, pn = mesh_padding(mesh, m, n)
            self.M, self.N = m + pm, n + pn
            r, c = mesh.shape["rows"], mesh.shape["cols"]
            if mesh.coords is None:
                raise ValueError(f"rank {mesh.rank} is outside the mesh "
                                 f"{mesh.shape} and cannot fit on it")
            ri, ci = mesh.coords
        self.mesh = mesh
        self.m_blk, self.n_blk = self.M // r, self.N // c
        self.row0, self.col0 = ri * self.m_blk, ci * self.n_blk
        self.vm = min(max(self.m - self.row0, 0), self.m_blk)
        self.vn = min(max(self.n - self.col0, 0), self.n_blk)
        self.rows, self.cols, self.all = (
            Axis(None if mesh is None else mesh.group(axis))
            for axis in ("rows", "cols", "all"))
        self.distributed = r * c > 1
        self.sum_rows, self.sum_cols = self.rows.sum, self.cols.sum
        self.sum_all = self.all.sum
        self.gather_rows, self.gather_cols = self.rows.gather, \
            self.cols.gather

    @property
    def padded(self) -> bool:
        """Whether this block holds pads."""
        return self.vm != self.m_blk or self.vn != self.n_blk

    def valid(self, X: torch.Tensor) -> torch.Tensor:
        """The valid (vm, vn) corner of a block-shaped tensor."""
        return X[:self.vm, :self.vn] if self.padded else X

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (a broadcast over the mesh), so that
        a value the host reads takes the same branch everywhere."""
        if self.all.group is None:
            return x
        y = x.contiguous()
        dist.broadcast(y.view(-1) if y.dim() == 0 else y, src=0,
                       group=self.all.group)
        return y

    # -- rank 0's host: checkpoint files (utils/checkpoint.py) -----------

    @property
    def is_root(self) -> bool:
        """Whether this rank reads and writes the host files (rank 0)."""
        return not self.distributed or self.mesh.rank == 0

    def share(self, obj):
        """Rank 0's picklable ``obj`` on every rank (a broadcast over the
        mesh): a host decision (does a file exist, did it load) taken once
        and followed alike everywhere."""
        if self.all.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.all.group)
        return box[0]

    def barrier(self) -> None:
        """Wait for every rank of the mesh (after rank 0's write, so that
        no rank goes on before the file is whole)."""
        if self.all.group is not None:
            dist.barrier(group=self.all.group)

    def _split_group(self, split: str):
        """The group whose blocks make up an array split over ``split``
        ("rows", "cols" or "both"), and whether this rank belongs to the
        one that holds rank 0 (the others hold copies)."""
        ri, ci = self.mesh.coords
        if split == "rows":
            return self.rows.group, ci == 0
        if split == "cols":
            return self.cols.group, ri == 0
        return self.all.group, True

    def _block_index(self, q: int, split: str) -> tuple:
        """The block (row block, column block) rank ``q`` holds."""
        ri, ci = divmod(q, self.mesh.shape["cols"])
        return {"rows": (ri, 0), "cols": (0, ci), "both": (ri, ci)}[split]

    def gather_to_root(self, X: torch.Tensor, split: str):
        """The whole padded array of which ``X`` is this rank's block, as a
        host array on rank 0 (None on every other rank).  ``split``:
        "rows" (the last dimension is split over the mesh's rows: W_T
        (k, m_blk), a per-row vector), "cols" (over its columns: H, a
        per-column vector) or "both" (the last two: A's (m_blk, n_blk)
        block).  Only the ranks whose blocks differ send: a factor
        replicated over the other axis moves once, not once a copy, and
        nothing is all-gathered (a ZI imputed matrix is the size of A)."""
        if not self.distributed:
            return X.detach().cpu().numpy()
        group, holds = self._split_group(split)
        if not holds:
            return None
        if group is None:
            return X.detach().cpu().numpy() if self.is_root else None
        x = X.detach().to(self.mesh.comm_device).contiguous()
        parts = ([torch.empty_like(x)
                  for _ in range(dist.get_world_size(group))]
                 if self.is_root else None)
        dist.gather(x, gather_list=parts, dst=0, group=group)
        if not self.is_root:
            return None
        traffic["to_root"] += x.numel() * x.element_size() * len(parts)
        parts = [p.cpu().numpy() for p in parts]
        if split != "both":
            return np.concatenate(parts, axis=-1)
        c = self.mesh.shape["cols"]
        return np.concatenate([np.concatenate(parts[i:i + c], axis=-1)
                               for i in range(0, len(parts), c)], axis=-2)

    def scatter_from_root(self, X, split: str, device, *,
                          col_major: bool = False) -> torch.Tensor:
        """This rank's block of the whole padded host array ``X`` that rank
        0 holds (ignored on the other ranks), float32 on ``device``;
        ``split`` as for :func:`gather_to_root`.  ``col_major``: the block
        is laid out column-major, as the loop held it (a product's operand
        layout selects its kernel, and with it the rounding)."""
        def cut(whole, q):
            bi, bj = self._block_index(q, split)
            out = whole
            if split in ("rows", "both"):
                w = out.shape[-1] if split == "rows" else out.shape[-2]
                blk = w // self.mesh.shape["rows"]
                out = (out[..., bi * blk:(bi + 1) * blk] if split == "rows"
                       else out[..., bi * blk:(bi + 1) * blk, :])
            if split in ("cols", "both"):
                blk = out.shape[-1] // self.mesh.shape["cols"]
                out = out[..., bj * blk:(bj + 1) * blk]
            return out

        if not self.distributed:
            part = np.asarray(X, np.float32)
        else:
            shape = self.share(
                tuple(cut(np.asarray(X), 0).shape) if self.is_root else None)
            comm = self.mesh.comm_device
            recv = torch.empty(shape, dtype=torch.float32, device=comm)
            parts = None
            if self.is_root:
                whole = np.asarray(X, np.float32)
                parts = [torch.from_numpy(np.ascontiguousarray(
                    cut(whole, q))).to(comm)
                    for q in range(self.mesh.size)]
            dist.scatter(recv, scatter_list=parts, src=0,
                         group=self.all.group)
            part = recv.cpu().numpy()
        # .to() keeps the strides of a dense tensor
        return torch.from_numpy(np.array(
            part, np.float32, order="F" if col_major else "C")).to(device)

    def block(self, A, device) -> torch.Tensor:
        """This rank's (m_blk, n_blk) block of the whole (m, n) matrix ``A``
        (host array or tensor), zero-padded, float32, on ``device``.  Only
        the block is copied."""
        r0, c0, vm, vn = self.row0, self.col0, self.vm, self.vn
        if isinstance(A, torch.Tensor):
            part = A[r0:r0 + vm, c0:c0 + vn].to(device=device,
                                                dtype=torch.float32)
        else:
            part = torch.from_numpy(np.array(
                np.asarray(A)[r0:r0 + vm, c0:c0 + vn], dtype=np.float32,
                order="C")).to(device)
        if (vm, vn) == (self.m_blk, self.n_blk):
            return part.contiguous()
        out = torch.zeros((self.m_blk, self.n_blk), dtype=torch.float32,
                          device=device)
        out[:vm, :vn] = part
        return out

    def row_block(self, X):
        """This rank's columns of a (k, m) factor (host array or tensor),
        zero-padded."""
        return _pad_slice(X, self.row0, self.m_blk, self.m)

    def col_block(self, X):
        """This rank's columns of a (k, n) factor (host array or tensor),
        zero-padded."""
        return _pad_slice(X, self.col0, self.n_blk, self.n)

    def cols_to_rows(self, X: torch.Tensor) -> torch.Tensor:
        """A (k, n_blk) block of a factor over the columns of a square A as
        this rank's (k, m_blk) block over its rows (the symmetric variant's
        W is its H)."""
        if not self.distributed and self.M == self.N:
            return X
        full = self.gather_cols(X)[:, :self.n]
        out = torch.zeros((X.shape[0], self.m_blk), dtype=X.dtype,
                          device=X.device)
        out[:, :self.vm] = full[:, self.row0:self.row0 + self.vm]
        return out


class PanelBlocks:
    """This rank's block of each column panel of a stream
    (``models/nmf_chunked.py``), from its :class:`ShardContext`.

    A forward panel holds columns of A, a transposed panel columns of A^T.
    On a mesh each panel is zero-padded and cut (rows, cols): a forward
    panel's rows (A's rows) over the mesh's rows and its columns over the
    mesh's columns, a transposed panel's rows (A's columns) over the mesh's
    columns and its columns over its rows.  Without a mesh every cut
    returns its argument itself, the same view: a product's operand layout
    selects its kernel, and with it the rounding."""

    def __init__(self, ctx: ShardContext):
        self.ctx = ctx
        mesh = ctx.mesh
        self.sharded = mesh is not None
        self.size = mesh.size if self.sharded else 1
        self._shape = ((mesh.shape["rows"], mesh.shape["cols"])
                       if self.sharded else (1, 1))
        self._coords = mesh.coords if self.sharded else (0, 0)

    def axis(self, transposed: bool) -> Axis:
        """The axis a panel's right-hand sides and Grams sum over: the
        ranks holding the panel's other rows."""
        return self.ctx.cols if transposed else self.ctx.rows

    def rows_geom(self, transposed: bool):
        """(first row, block rows, valid rows) of this rank's block of a
        panel."""
        c = self.ctx
        return (c.col0, c.n_blk, c.vn) if transposed else (c.row0, c.m_blk,
                                                            c.vm)

    def cols_geom(self, nc: int, transposed: bool):
        """(first column, block columns, valid columns) of this rank's
        block of a panel of ``nc`` columns, zero-padded to divide the axis
        it is split over ("cols" forward, "rows" transposed)."""
        (r, c), (ri, ci) = self._shape, self._coords
        parts, idx = (r, ri) if transposed else (c, ci)
        pb = -(-nc // parts)
        c0 = idx * pb
        return c0, pb, min(max(nc - c0, 0), pb)

    def block_of(self, data, nc: int, transposed: bool, dtype=np.float32):
        """This rank's zero-padded block of a whole host panel."""
        if not self.sharded:
            return data
        r0, rb, vr = self.rows_geom(transposed)
        c0, pb, vc = self.cols_geom(nc, transposed)
        out = np.zeros((rb, pb), dtype)
        out[:vr, :vc] = data[r0:r0 + vr, c0:c0 + vc]
        return out

    def rows_of(self, v, transposed: bool, fill: float = 0.0):
        """A (k, rows) factor table (zero-padded) or a vector over the
        panel's rows (padded with ``fill``), cut to this rank's block."""
        if not self.sharded:
            return v
        if v.dim() == 2:
            return (self.ctx.col_block(v) if transposed
                    else self.ctx.row_block(v))
        r0, rb, vr = self.rows_geom(transposed)
        return _pad_vec(v[r0:r0 + vr], rb, fill)

    def cols_of(self, v, cs: int, nc: int, transposed: bool,
                fill: float = 0.0):
        """Columns ``cs .. cs + nc`` of a vector (or of a (k, n) table)
        along the panel's columns, this rank's part, zero-padded."""
        if not self.sharded:
            return v[..., cs:cs + nc]
        c0, pb, vc = self.cols_geom(nc, transposed)
        part = v[..., cs + c0:cs + c0 + vc]
        if v.dim() == 2:
            out = v.new_zeros((v.shape[0], pb))
            out[:, :vc] = part
            return out
        return _pad_vec(part, pb, fill)

    def offsets(self, cs: int, nc: int, transposed: bool):
        """The global offsets of this rank's block of a panel: its first
        row within the panel and its first column within A's panel."""
        return (self.rows_geom(transposed)[0],
                cs + self.cols_geom(nc, transposed)[0])

    def valid(self, nc: int, transposed: bool = False):
        """The valid (rows, cols) extent of this rank's block of a panel;
        None without a mesh."""
        if not self.sharded:
            return None
        return self.rows_geom(transposed)[2], self.cols_geom(nc,
                                                             transposed)[2]

    def whole(self, X, nc: int, transposed: bool):
        """A solved block of a panel's columns as the panel's whole
        (k, nc) slice, on every rank."""
        if not self.sharded:
            return X
        return (self.ctx.rows if transposed else self.ctx.cols).gather(
            X, dim=1)[:, :nc]


def _pad_vec(v, size: int, fill: float):
    if v.shape[0] == size:
        return v.contiguous()
    return torch.cat([v, v.new_full((size - v.shape[0],), fill)])


def _pad_slice(X, lo: int, width: int, true: int):
    """Columns ``lo .. lo + width`` of ``X`` (true width ``true``), the part
    past ``true`` zero: a float32 host array, or a tensor on X's device."""
    if isinstance(X, torch.Tensor):
        out = X.new_zeros(X.shape[:-1] + (width,))
    else:
        X = np.asarray(X)
        out = np.zeros(X.shape[:-1] + (width,), dtype=np.float32)
    hi = min(lo + width, true)
    if hi > lo:
        out[..., :hi - lo] = X[..., lo:hi]
    return out


# ---------------------------------------------------------------------------
# Padding, placement and the sharded fit
# ---------------------------------------------------------------------------

def mesh_padding(mesh: Mesh, m: int, n: int):
    """Zero-padding needed to make (m, n) divisible by the mesh shape."""
    mr, mc = mesh.shape["rows"], mesh.shape["cols"]
    return (-m) % mr, (-n) % mc


def check_pad_soundness(cfg: NMFConfig, pm: int, pn: int) -> None:
    """Reject the one configuration where mesh zero-padding is unsound.

    Pads solve to exact zeros except when ``nonneg=False`` combines with
    ``L1 > 0``: the unconstrained solve of b = -L1 is off zero, so padded
    rows/columns would leak nonzero factor mass into Grams and losses (see
    :func:`pad_to_mesh`)."""
    if not (pm or pn):
        return
    bad = [side for side, fc in (("W", cfg.W), ("H", cfg.H))
           if not fc.nonneg and fc.L1 > 0]
    if bad:
        raise ValueError(
            f"semi-NMF (nonneg=False) with L1 > 0 on {'/'.join(bad)} is "
            f"unsound with mesh zero-padding (pads would solve off zero); "
            f"pad the data to mesh-divisible dimensions yourself or drop "
            f"L1 on the unconstrained factor")


def pad_to_mesh(mesh: Mesh, A, W_T, H):
    """Zero-pad host A / W_T / H so that every dimension divides the mesh.

    Exact for ALS-NMF: an all-zero row or column has RHS b = 0, so its factor
    solves to exactly 0 (nonneg clip, or b = 0 with L1 = 0) and adds nothing
    to Grams, losses or the normalization.  The one combination where pads
    could go nonzero is L1 > 0 with nonneg=False (:func:`check_pad_soundness`).
    """
    pm, pn = mesh_padding(mesh, A.shape[0], A.shape[1])
    if pm:
        A = np.pad(A, ((0, pm), (0, 0)))
        W_T = np.pad(W_T, ((0, 0), (0, pm)))
    if pn:
        A = np.pad(A, ((0, 0), (0, pn)))
        H = np.pad(H, ((0, 0), (0, pn)))
    return A, W_T, H


def shard_arrays(mesh: Mesh, A, W_T, H, d, *, device=None):
    """This rank's part of the factor model in the canonical layout, on its
    device: A's (rows, cols) block, W_T's row block, H's column block and d,
    zero-padded to mesh-divisible shapes (:func:`pad_to_mesh`)."""
    dev = torch.device(device) if device is not None else mesh.device
    ctx = ShardContext(mesh, A.shape[0], A.shape[1])

    def put(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(dev)

    return (ctx.block(A, dev), put(ctx.row_block(W_T)),
            put(ctx.col_block(H)), put(d))


@dataclass
class ShardedMatrix:
    """A matrix no rank holds whole: this rank's (rows, cols) ``block`` (on
    its device) of a global matrix of ``shape``, laid out over ``mesh``
    (:func:`rcppml_tpu_torch.parallel.multihost.shard_host_data`)."""
    block: torch.Tensor
    shape: tuple
    mesh: Mesh
    ndim = 2


def rank_device(mesh: Mesh, device=None) -> torch.device:
    """The device this rank fits on: the mesh's; ``device=``, when given,
    must be it."""
    dev = mesh.device
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={device!r} disagrees with this rank's "
                             f"device {dev} on the mesh")
    return dev


def shard_aux(ctx: ShardContext, aux: Optional[dict], device,
              symmetric: bool = False) -> dict:
    """The auxiliary arrays of a fit laid onto the mesh: graph Laplacians
    zero-padded to (N, N) / (M, M) (zero cross-terms: the pads add nothing)
    and the same on every rank; enrichment targets padded with zero columns
    and cut to this rank's block; the precomputed ``*_gram`` as they are."""
    out = {}
    for key, val in (aux or {}).items():
        if val is None:
            continue
        t = (val if isinstance(val, torch.Tensor)
             else torch.as_tensor(np.asarray(val, np.float32)))
        t = t.to(device=device, dtype=torch.float32)
        if key in ("graph_H", "graph_W"):
            size = ctx.N if key == "graph_H" else ctx.M
            pad = size - t.shape[0]
            if pad:
                t = torch.nn.functional.pad(t, (0, pad, 0, pad))
        elif key == "target_H" or (key == "target_W" and symmetric):
            t = torch.from_numpy(ctx.col_block(t.cpu().numpy())).to(device)
        elif key == "target_W":
            t = torch.from_numpy(ctx.row_block(t.cpu().numpy())).to(device)
        out[key] = t
    return out


def sharded_setup(A, cfg: NMFConfig, mesh: Mesh, device=None):
    """What every sharded fit starts from: the checks of
    :func:`fit_sharded`, then this rank's device, its ``ShardContext``, its
    zero-padded block of A on the device, and (for an SVD start) the whole
    A on the device, else None.  ``A``: the whole matrix (host array or
    tensor) or a :class:`ShardedMatrix`."""
    from ..device import set_fp32_precision
    from ..models import nmf as nmf_mod

    if cfg.fused_vmem:
        raise ValueError("fused_vmem is a single-device whole-fit path, "
                         "incompatible with a sharded mesh fit")
    cfg.validate()
    dev = rank_device(mesh, device)
    sharded = isinstance(A, ShardedMatrix)
    device_in = sharded or isinstance(A, torch.Tensor)
    if not device_in:
        A = np.asarray(A, dtype=np.float32)
    if len(A.shape) != 2:
        raise ValueError("data must be a 2-D matrix")
    m, n = (int(s) for s in A.shape)
    if cfg.rank > min(m, n):
        raise ValueError(f"rank {cfg.rank} exceeds min(dim) = {min(m, n)}")
    pm, pn = mesh_padding(mesh, m, n)
    check_pad_soundness(cfg, pm, pn)
    if device_in and (pm or pn):
        raise ValueError(
            f"device-resident input of shape {(m, n)} does not divide "
            f"the mesh {dict(mesh.shape)}; pad it before sharding "
            "(host inputs are padded automatically)")
    set_fp32_precision()
    seed_A = (nmf_mod.device_matrix(A, dev)
              if cfg.init_mode in (1, 2) and not sharded else None)
    ctx = ShardContext(mesh, m, n)
    A_blk = A.block.to(dev, torch.float32) if sharded else ctx.block(A, dev)
    return dev, ctx, A_blk, seed_A


def fit_sharded(A, cfg: NMFConfig, mesh: Optional[Mesh] = None, *,
                w_init=None, h_init=None, aux: Optional[dict] = None,
                sparse_zeros: bool = False, device=None):
    """Sharded NMF fit: every rank of ``mesh`` calls this with the same
    arguments and gets the whole result on the host.

    ``A``: the whole (m, n) matrix (host array or tensor; each rank takes its
    own block, zero-padded to divide the mesh) or a :class:`ShardedMatrix`
    (each rank holds only its block; its shape must divide the mesh).  The
    initial factors are made on the host for the whole (m, n), the JAX
    package's SplitMix64 start, then padded and cut.  MSE fits run
    ``models.nmf.fit_mse``, IRLS fits ``models.nmf_irls.fit_irls`` with the
    accounting restricted to the true (m, n).  ``aux``: graph Laplacians and
    targets (the JAX package's sharded fit passes none).  ``device=``, when
    given, must be this rank's device on the mesh."""
    from ..models import nmf as nmf_mod
    from ..models.nmf_irls import fit_irls

    mesh = mesh or default_mesh()
    dev, ctx, A_blk, seed_A = sharded_setup(A, cfg, mesh, device)
    W_T0, H0, d0 = nmf_mod.init_factors(cfg, ctx.m, ctx.n, A=seed_A,
                                        w_init=w_init, h_init=h_init)
    W_blk, H_blk = ctx.row_block(W_T0), ctx.col_block(H0)
    aux_blk = shard_aux(ctx, aux, dev, symmetric=cfg.symmetric)
    if cfg.requires_irls():
        res = fit_irls(A_blk, cfg, W_blk, H_blk, d0, aux_blk,
                       sparse_zeros=sparse_zeros, ctx=ctx)
    else:
        state = nmf_mod.init_fit_state(cfg, W_blk, H_blk, d0, device=dev)
        state = nmf_mod.fit_mse(cfg, A_blk, state, aux_blk, ctx=ctx)
        res = nmf_mod.finalize_result(cfg, state, ctx=ctx)
    return unpad_result(res, cfg, ctx.m, ctx.n)


def unpad_result(res, cfg: NMFConfig, m: int, n: int):
    """Slice the mesh zero-padding back off a fitted result (pads solve to
    exact zeros)."""
    if res.W.shape[0] != m:
        res.W = res.W[:m]
    if res.H.shape[1] != n:
        res.H = res.H[:, :n]
    per_col = cfg.dispersion == Dispersion.PER_COL
    for attr in ("theta", "dispersion"):
        v = getattr(res, attr, None)
        if v is not None and np.ndim(v) == 1:
            setattr(res, attr, v[:n] if per_col else v[:m])
    if getattr(res, "pi_row", None) is not None:
        res.pi_row = res.pi_row[:m]
    if getattr(res, "pi_col", None) is not None:
        res.pi_col = res.pi_col[:n]
    return res
