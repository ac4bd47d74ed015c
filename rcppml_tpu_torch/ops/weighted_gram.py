"""Per-column weighted Gram + RHS from given weights: the CUDA kernel and its
plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_experiments.py::
weighted_gram_pallas``.  The CUDA source is ``csrc/weighted_gram.cu`` with
its tile in ``csrc/tri_gram.cuh``: per column j of a block, ``G_j = F
diag(w_j) F^T`` and ``b_j = F (w_j * a_j)``.  It computes one triangle of
every Gram (k1 <= k2) and writes each entry to both places, on the tensor
cores in 3xTF32 (each operand split into a TF32 high part and remainder,
three products, float32 accuracy); the A operand is F's rows scaled by w_j in
registers, so the (bc, k, m) intermediate ``F * w_j`` of the plain version
never exists.  Where the triangle's tiles alone would leave the card idle the
reduction over m is split across blocks, and a second kernel adds the
splits' partials in the order of their index (:func:`plan_weighted_gram`):
no atomics, the same bits every run.  What bounds it on the H100 is
arithmetic: 2 m bc (k (k + 1) / 2 + k) float32 operations, three TF32
products each on the tensor cores.

:func:`weighted_gram` launches the kernel for a CUDA tensor and runs
:func:`weighted_gram_plain` for a CPU tensor; there is no other branch.
``weighted_gram.launches`` counts the kernel's launches (one a call).  The
port reaches it from :func:`rcppml_tpu_torch.ops.linalg.weighted_gram_and_rhs`
when the Khatri-Rao operand does not fit its budget (large k times m): the
masked MSE solves and the IRLS solves both go through that function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .rhs_tall import H100_SMS, device_sms

KERNEL = "weighted_gram"
# the tile of csrc/tri_gram.cuh: warps a block, rows of m a stage, J tiles of
# a triangle unit; floats of a staged row, rows of F a unit stages, stages in
# the ring
TILE_WARPS, TILE_DEPTH, TILE_GROUP = 8, 32, 4
TILE_LD, UNIT_SLOT, TILE_STAGES = 36, 112, 3
# a block's and a multiprocessor's shared memory on sm_90, and what the
# runtime keeps of it for each block
SHARED_OPTIN, SM_SHARED, BLOCK_RESERVED = 232448, 233472, 1024
# the tile's ways of getting w (tri_gram::Mode): copied (kernel 5), formed
# from F's rows staged with the stage, or read from device memory (kernel 4)
GIVEN_W, FUSED_STAGED, FUSED_GLOBAL = 0, 1, 2
# kernel 4's mu, float32 multiply-adds outside the tensor cores, in the plan
PLAN_FMA_FLOPS = 3e13
# the split plan weighs the last wave's idle slots against the partials'
# traffic and the second launch; these rates only have to stand in the right
# proportion (3xTF32 products at about 60% of the tensor cores' 495 TFLOP/s,
# the partials at about 75% of 3.35 TB/s, a launch of a few microseconds)
PLAN_FLOPS, PLAN_BYTES, PLAN_LAUNCH_S = 3e14, 2.5e12, 3e-6
MAX_SPLITS, MIN_SPLIT_ROWS = 16, 512


def triangle_units(k: int) -> int:
    """Triangle units of a k x k Gram (``triangle_units`` of the source):
    per m16 row tile I, the groups of up to four n8 column tiles from 2 I."""
    col_tiles = -(-k // 8)
    return sum(-(-(col_tiles - 2 * i) // TILE_GROUP)
               for i in range(-(-k // 16)))


def shared_bytes(wc: int, k: int, mode: int = GIVEN_W) -> int:
    """Dynamic shared memory of a block (``tri_gram::shared_bytes``): three
    stages of the units' rows of F and of w and A for 2 wc columns; kernel 4
    adds a ring of F's k rows for mu (``FUSED_STAGED``, where k > 16: up to
    16 the unit's rows at k1 are all of F) and X's 2 wc columns once (both
    fused modes)."""
    stage = (TILE_WARPS // wc) * UNIT_SLOT * TILE_LD \
        + 2 * TILE_DEPTH * (2 * wc + 4)
    if mode == FUSED_STAGED and k > 16:
        stage += k * TILE_LD
    return 4 * (TILE_STAGES * stage + (0 if mode == GIVEN_W else 2 * wc * k))


def fused_mode(k: int, wc: int) -> int:
    """How kernel 4 reads F for mu at this k and block width: staged with
    the stage while that fits a block's shared memory, else from device
    memory; raises where even X's columns do not fit."""
    if shared_bytes(wc, k, FUSED_STAGED) <= SHARED_OPTIN:
        return FUSED_STAGED
    if shared_bytes(wc, k, FUSED_GLOBAL) <= SHARED_OPTIN:
        return FUSED_GLOBAL
    raise ValueError(f"weighted_gram_rhs: k={k} needs "
                     f"{shared_bytes(wc, k, FUSED_GLOBAL)} bytes of shared "
                     f"memory a block (limit {SHARED_OPTIN})")


def plan_weighted_gram(k: int, m: int, bc: int, sms: int = H100_SMS, *,
                       fused: bool = False) -> tuple[int, int, int]:
    """How the kernel cuts its work: ``(wc, splits, chunk)``.

    A block is eight warps, each one triangle unit by one pair of columns:
    ``wc`` pairs of columns (the smallest power of two that holds them all,
    from 2 to 8) by ``8 / wc`` units.  The reduction over m runs in
    ``splits`` ranges of ``chunk`` rows (a multiple of 32), one per
    ``blockIdx.z``; ``splits`` minimises the estimated time: the products
    over the blocks' waves (two blocks a multiprocessor, one for ``wc = 2``,
    whose shared memory is 138 KB), plus the partials written and read again
    and the second launch when there is more than one split.  Each split
    keeps at least ``MIN_SPLIT_ROWS`` rows.  A function of the shapes and the
    card alone, so a call repeats bit for bit.

    ``fused``: the plan of kernel 4 (``ops/wgram.py``) on the same tile.
    Its blocks also form mu, 2 k multiply-adds an entry of a stage, once
    for every block of units; ``wc`` grows until F's k rows fit in every
    stage (:func:`fused_mode`), and a multiprocessor holds two blocks where
    their shared memory allows."""
    pairs = -(-bc // 2)
    wc = min(8, max(2, 1 << (pairs - 1).bit_length()))
    if fused:
        while wc < 8 and fused_mode(k, wc) != FUSED_STAGED:
            wc *= 2
    unit_blocks = -(-triangle_units(k) // (TILE_WARPS // wc))
    base = unit_blocks * -(-pairs // wc)
    work_s = 6.0 * m * bc * (k * (k + 1) // 2 + k) / PLAN_FLOPS
    if fused:
        block_bytes = shared_bytes(wc, k, fused_mode(k, wc)) + BLOCK_RESERVED
        slots = sms * (2 if 2 * block_bytes <= SM_SHARED else 1)
        work_s += 2.0 * m * bc * k * unit_blocks / PLAN_FMA_FLOPS
    else:
        slots = sms * (2 if wc > 2 else 1)
    partial_bytes = 4.0 * bc * (k * k + k)

    def cost(splits):
        blocks = base * splits
        waves = -(-blocks // slots)
        t = work_s * waves * slots / blocks
        if splits > 1:
            t += (splits + 1) * partial_bytes / PLAN_BYTES + PLAN_LAUNCH_S
        return t

    top = max(1, min(MAX_SPLITS, m // MIN_SPLIT_ROWS))
    splits = min(range(1, top + 1), key=lambda s: (cost(s), s))
    chunk = -(-(-(-m // splits)) // TILE_DEPTH) * TILE_DEPTH
    return wc, -(-m // chunk), chunk


def scratch_floats(k: int, bc: int, splits: int) -> int:
    """Floats of the partials' scratch: none for one split, else every
    split's (bc, k, k) Gram batch and (k, bc) right-hand side."""
    return 0 if splits == 1 else splits * bc * (k * k + k)


def weighted_gram_plain(F: torch.Tensor, w: torch.Tensor, A_blk: torch.Tensor):
    """Plain twin: the blocked batched product ``(F * w_j) F^T`` and
    ``F (w * A)``.  F (k, m), w (m, bc), A_blk (m, bc) -> (Gb (bc, k, k),
    b (k, bc)).  Holds a (bc, k, m) intermediate."""
    Fw = F[None, :, :] * w.T[:, None, :]                  # (bc, k, m)
    Gb = Fw @ F.T
    b = F @ (w * A_blk)
    return Gb, b


def _check(F, w, A_blk):
    if F.ndim != 2 or w.ndim != 2 or w.shape[0] != F.shape[1] \
            or A_blk.shape != w.shape:
        raise ValueError(f"weighted_gram: F {tuple(F.shape)}, w "
                         f"{tuple(w.shape)} and A {tuple(A_blk.shape)} do not "
                         "fit together")
    for name, t in (("F", F), ("w", w), ("A", A_blk)):
        if t.dtype != torch.float32:
            raise TypeError(f"weighted_gram: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != F.device:
            raise ValueError(f"weighted_gram: {name} is on {t.device}, "
                             f"F on {F.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.weighted_gram_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: unit column stride, any row stride (a
    block of columns of a wider row-major matrix is read in place)."""
    if t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return t
    return t.contiguous()


def weighted_gram(F: torch.Tensor, w: torch.Tensor, A_blk: torch.Tensor):
    """Per-column weighted Gram + RHS: F (k, m), w (m, bc), A_blk (m, bc) ->
    (Gb (bc, k, k), b (k, bc)), float32, any k, m and bc.

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`weighted_gram_plain`.
    """
    _check(F, w, A_blk)
    if not F.is_cuda:
        return weighted_gram_plain(F, w, A_blk)
    k, m = F.shape
    bc = w.shape[1]
    Gb = torch.empty((bc, k, k), dtype=torch.float32, device=F.device)
    b = torch.empty((k, bc), dtype=torch.float32, device=F.device)
    if bc == 0 or k == 0:
        return Gb, b
    if m == 0:
        return Gb.zero_(), b.zero_()
    F_c, w_r, A_r = F.contiguous(), _rows(w), _rows(A_blk)
    wc, splits, chunk = plan_weighted_gram(k, m, bc, device_sms(F.device))
    n_scratch = scratch_floats(k, bc, splits)
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=F.device) if n_scratch else None
    lib = _library()
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.weighted_gram_launch(
            F_c.data_ptr(), w_r.data_ptr(), A_r.data_ptr(), Gb.data_ptr(),
            b.data_ptr(), k, m, bc, w_r.stride(0), A_r.stride(0), wc, splits,
            chunk, scratch.data_ptr() if scratch is not None else None,
            stream)
    if err != 0:
        raise RuntimeError(f"weighted_gram kernel launch failed: CUDA error "
                           f"{err} (k={k}, m={m}, bc={bc})")
    weighted_gram.launches += 1
    return Gb, b


weighted_gram.launches = 0
