"""Multi-process execution setup: one process per rank over torch.distributed.

The port of ``rcppml_tpu/parallel/multihost.py``.  Each process runs one rank
of the mesh on one device; ``torch.distributed`` joins them.  The same script
runs on every rank:

    from rcppml_tpu_torch.parallel import mesh, multihost
    multihost.initialize()                 # torchrun's environment
    m = mesh.default_mesh()                # every rank of the world
    model = rtt.nmf(A, k, mesh=m)          # every rank: the whole result

Started by ``torchrun --nproc-per-node N script.py`` the group is read from
the environment; elsewhere pass ``init_method`` (or ``coordinator_address``),
``num_processes`` and this process's ``process_id``.  NCCL, the default on
CUDA, needs one card per rank; ranks that share a card pass
``backend="gloo"``.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the device this process's rank runs on, set by initialize(); the process
# group it belongs to is torch.distributed's own process-wide state
_RANK_DEVICE: dict = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve_device(device, rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local % torch.cuda.device_count())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize: no CUDA device is visible; pass "
            "device=\"cpu\" to run this rank on the host")
    return torch.device("cuda", local % torch.cuda.device_count())


def local_device() -> torch.device:
    """This process's rank's device: the one :func:`initialize` chose, else
    the current CUDA card (without one it raises: a rank never moves to
    the host unless asked)."""
    if "device" in _RANK_DEVICE:
        return _RANK_DEVICE["device"]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible for this rank; call "
            "multihost.initialize(device=\"cpu\") or pass devices= to "
            "default_mesh")
    return torch.device("cuda", torch.cuda.current_device())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               init_method: Optional[str] = None,
               backend: Optional[str] = None, device=None) -> dict:
    """Join the process group (idempotent: a process already in one keeps
    it).

    The group comes from ``init_method`` (any ``torch.distributed`` URL:
    ``tcp://host:port``, ``file:///path``) or ``coordinator_address``
    (``"host:port"``), with ``num_processes`` and this ``process_id``; else
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``);
    else, in a plain single process, it is a group of this one rank.
    ``device``: this rank's device (default the CUDA card
    ``LOCAL_RANK % device_count``; without a card it raises, pass
    ``device="cpu"``).  ``backend``: ``"nccl"`` by default for a CUDA
    device, ``"gloo"`` for the host; ranks sharing one card ask for
    ``"gloo"``.  A failed join raises.

    Returns the JAX package's summary keys: ``process_index``,
    ``process_count``, ``local_devices`` (1: one device a rank) and
    ``global_devices``, with ``backend`` and ``device``."""
    if not dist.is_initialized():
        if init_method is None and coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        if init_method is not None:
            if num_processes is None or process_id is None:
                raise ValueError("initialize: init_method / "
                                 "coordinator_address need num_processes "
                                 "and process_id")
            world, rank = int(num_processes), int(process_id)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            world, rank = (int(os.environ["WORLD_SIZE"]),
                           int(os.environ["RANK"]))
        elif num_processes not in (None, 1):
            raise ValueError(f"initialize: {num_processes} processes need "
                             "coordinator_address or init_method")
        else:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
            world, rank = 1, 0
        dev = _resolve_device(device, rank)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        _RANK_DEVICE["device"] = dev
    elif device is not None:
        _RANK_DEVICE["device"] = _resolve_device(device, dist.get_rank())
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
        "backend": dist.get_backend(),
        "device": str(local_device()),
    }


def _extents(shape, mesh) -> np.ndarray:
    """Every mesh rank's local (rows, cols), in rank order."""
    mine = torch.tensor([int(shape[0]), int(shape[1])], dtype=torch.int64,
                        device=mesh.comm_device)
    group = mesh.group("all")
    if group is None:
        return mine.cpu().numpy()[None]
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=group)
    return torch.stack(parts).cpu().numpy()


def shard_host_data(A_local, mesh, *, axis: str = "cols"):
    """Lay host-local slices of a matrix onto the mesh without any rank
    holding it whole.

    Every rank passes ITS slice of A along ``axis`` (rank p of the mesh the
    p-th slice, all of the other dimension); the result is a
    :class:`~rcppml_tpu_torch.parallel.mesh.ShardedMatrix` holding only this
    rank's (rows, cols) block, on its device, with the global shape.  The
    slices are redistributed with point-to-point sends: each rank sends
    each other rank the part of its slice that falls in that rank's block.
    The global shape must divide the mesh (as ``jax.make_array_from_
    process_local_data`` requires)."""
    from .mesh import ShardedMatrix, mesh_padding
    if axis not in ("rows", "cols"):
        raise ValueError(f"axis must be 'rows' or 'cols', got {axis!r}")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is outside the mesh "
                         f"{mesh.shape}")
    A_local = np.ascontiguousarray(np.asarray(A_local, dtype=np.float32))
    if A_local.ndim != 2:
        raise ValueError("shard_host_data takes a 2-D slice")
    along = 1 if axis == "cols" else 0
    ext = _extents(A_local.shape, mesh)
    if len(set(ext[:, 1 - along].tolist())) != 1:
        raise ValueError(f"the slices disagree in their other dimension: "
                         f"{ext.tolist()}")
    offs = np.concatenate([[0], np.cumsum(ext[:, along])])
    m, n = ((int(ext[0, 0]), int(offs[-1])) if along
            else (int(offs[-1]), int(ext[0, 1])))
    pm, pn = mesh_padding(mesh, m, n)
    if pm or pn:
        raise ValueError(f"matrix of shape {(m, n)} does not divide the "
                         f"mesh {dict(mesh.shape)}; pad it first")
    r, c = mesh.shape["rows"], mesh.shape["cols"]
    mb, nb = m // r, n // c

    def piece(src: int, dst: int):
        """The global (r0, r1, c0, c1) of src's slice inside dst's block."""
        qi, qj = divmod(dst, c)
        r0, r1, c0, c1 = qi * mb, (qi + 1) * mb, qj * nb, (qj + 1) * nb
        lo, hi = int(offs[src]), int(offs[src + 1])
        if along:
            c0, c1 = max(c0, lo), min(c1, hi)
        else:
            r0, r1 = max(r0, lo), min(r1, hi)
        return (r0, r1, c0, c1) if r1 > r0 and c1 > c0 else None

    me, lo = mesh.rank, int(offs[mesh.rank])
    ri, cj = mesh.coords
    comm = mesh.comm_device
    block = torch.zeros((mb, nb), dtype=torch.float32, device=comm)

    def local_part(p):
        r0, r1, c0, c1 = p
        if along:
            return A_local[r0:r1, c0 - lo:c1 - lo]
        return A_local[r0 - lo:r1 - lo, c0:c1]

    def place(p, values):
        r0, r1, c0, c1 = p
        block[r0 - ri * mb:r1 - ri * mb, c0 - cj * nb:c1 - cj * nb] = values

    ops, received = [], []
    for q in range(mesh.size):
        if q == me:
            continue
        p = piece(me, q)
        if p is not None:
            ops.append(dist.P2POp(dist.isend, torch.from_numpy(
                np.ascontiguousarray(local_part(p))).to(comm), q))
        p = piece(q, me)
        if p is not None:
            buf = torch.empty((p[1] - p[0], p[3] - p[2]), dtype=torch.float32,
                              device=comm)
            ops.append(dist.P2POp(dist.irecv, buf, q))
            received.append((p, buf))
    own = piece(me, me)
    if own is not None:
        place(own, torch.from_numpy(np.ascontiguousarray(local_part(own))))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for p, buf in received:
        place(p, buf)
    return ShardedMatrix(block.to(mesh.device), (m, n), mesh)
