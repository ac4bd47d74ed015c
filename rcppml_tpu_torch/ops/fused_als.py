"""Whole-fit Newton-Schulz ALS for dense MSE NMF: the CUDA kernel sequence
and its plain PyTorch twin.

Replaces the TPU kernel ``rcppml_tpu/ops/pallas_kernels.py::fused_als_vmem``
(body ``_make_fused_als_vmem_kernel``, gate ``fused_vmem_bytes`` /
``fused_vmem_fits``).  The CUDA source is ``csrc/fused_als.cu``: one C call
enqueues a fixed sequence of that file's own kernels for all ``maxit``
iterations on the current stream (4 launches to seed the two inverses, 13 per
iteration) and returns; the host reads nothing and decides nothing in between.
The two products that read A are the tall product of ``csrc/rhs_tall.cuh``
(:mod:`.rhs_tall`: tensor cores, a ring of ``cp.async`` stages; the kernel
that normalises a factor also writes it prepared as the next product's small
operand, and the starting W is prepared here before the call).  The Grams
are ``csrc/cluster_gram.cuh``'s (a slab of the factor a block, a partial a
cluster of eight blocks, :func:`plan_gram`), Ginv B is ``rhs_tall.cuh``'s
float32 FMA tile, a factor row's normalisation runs in a cluster of eight
blocks, and the k x k Newton-Schulz work runs where :func:`refine_plan`
puts it: one block on float32 multiply-adds up to k = 128
(``csrc/kxk_block.cuh``), a cluster of blocks sharing G, X and T through
distributed shared memory up to k = 256, a device-memory scratch beyond,
both on the tensor cores in 3xTF32 (``csrc/kxk_refine.cuh``).  Every sum
across blocks is a set of partials added in a fixed order, so two runs agree
bit for bit.

The TPU kernel pins A in VMEM and its gate counts VMEM bytes.  An H100 keeps
A in device memory (it stays in the 50 MB L2 when it is small enough), so the
gate here counts what this kernel needs: device memory for A, the factors and
the workspaces (and the k x k scratch past k = 256), so no k is refused; the
CPU twin takes any k too, as ``_ns_als_xla`` does.  :func:`fused_vmem_bytes`
and :func:`fused_vmem_fits` keep the TPU gate's names.  What bounds the fit
on the card is two reads of A per iteration once A exceeds L2, the 2 k m n
operations of each product below that, and the serial k x k section, which
grows with k^3 (at k = 150, in a cluster, most of the fit).

:func:`fused_als` launches the kernels for a CUDA tensor and runs
:func:`fused_als_plain` for a CPU tensor; there is no other branch.
``fused_als.launches`` counts the kernels enqueued
(:func:`phase_count` per call) and ``fused_als.calls`` the calls.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .rhs_tall import (H100_SMS, device_sms, pieces_floats, plan_splits,
                       plan_tall, prepare_small, small_floats)

KERNEL = "fused_als"
RIDGE_REL = 1e-6
# one block's dynamic shared memory on sm_90 (227 KB)
SHARED_LIMIT = 232448
# device memory the fit may take: three quarters of the card's, which leaves
# room for the caller's own copy of A and the allocator's slack; where there is
# no card to ask (the CPU twin) the same share of an 80 GiB card
DEVICE_SHARE = 0.75
DEVICE_LIMIT = 60 * 2**30
# Gram partials are summed by one block: keep them few.  The cluster Gram
# (csrc/cluster_gram.cuh): columns of F a block, blocks a cluster, threads a
# block
GRAM_MAX_SPLITS = 32
GRAM_CHUNK, GRAM_CLUSTER, GRAM_THREADS = 128, 8, 256
# the k x k section: one block on float32 multiply-adds up to KXK_BLOCK_K
# (csrc/kxk_block.cuh); beyond, csrc/kxk_refine.cuh: the cluster sizes it
# tries, warps a block at most, output tiles a warp may hold for the
# in-place product, floats of the small reductions beside the column sums
KXK_BLOCK_K = 128
KXK_RANKS, KXK_WARPS, KXK_HELD, KXK_REDUCTIONS = (2, 4), 16, 8, 64


def phase_count(maxit: int) -> int:
    """Kernels one :func:`fused_als` call enqueues on the card."""
    return 4 + 13 * maxit


def refine_plan(k: int) -> tuple[int, int, int, int]:
    """Where the k x k section runs: ``(ranks, rows, threads,
    scratch_floats)``.

    Up to ``KXK_BLOCK_K`` (128) one block on float32 multiply-adds with G,
    X and T in its shared memory (``csrc/kxk_block.cuh``; ``rows`` 0), a
    warp an (8 ri) x 16 tile of a product (ri rows a thread: 1 up to k = 32,
    2 up to 64, else 4), at least four warps.  Beyond, ``csrc/kxk_refine.cuh``
    on the tensor cores, with G, X and T in rows of ``ld`` = k rounded up to
    8, plus 4, floats: a cluster of 2 or 4 blocks each holding ``rows`` of
    them (a multiple of 16) in shared memory, the first that fits
    ``SHARED_LIMIT`` with the column sums and small reductions beside them
    and at most eight of a product's 16 x 8 output tiles a warp; past k =
    256 one block of 512 threads on four matrices of k rounded up to 16 rows
    in a device-memory scratch of ``scratch_floats``.  A cluster's block has
    32 threads a tile of its share of a product, from 256 to 512."""
    if k <= KXK_BLOCK_K:
        ri = 1 if k <= 32 else 2 if k <= 64 else 4
        return 1, 0, 32 * max(4, -(-k // (8 * ri)) * -(-k // 16)), 0
    kp = -(-k // 8) * 8
    ld, k16 = kp + 4, -(-k // 16) * 16
    for ranks in KXK_RANKS:
        rows = -(-(-(-k16 // ranks)) // 16) * 16
        tiles = rows // 16 * (kp // 8)
        need = (3 * rows * ld + kp + KXK_REDUCTIONS) * 4
        if need <= SHARED_LIMIT and tiles <= KXK_HELD * KXK_WARPS:
            return ranks, rows, 32 * min(KXK_WARPS, max(8, tiles)), 0
    return 1, k16, 32 * KXK_WARPS, 4 * k16 * ld


def plan_gram(R: int, k: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """How a Gram F F^T of kernel 3 (F (k, R)) is cut: ``(partials, chunk,
    cluster)``.

    With ``cluster`` 1 it is ``csrc/cluster_gram.cuh``'s kernel: blocks of
    ``chunk`` columns of F (128 up to k = 64, else 64, evened out), in
    clusters of eight, each cluster one partial Gram, at most
    ``GRAM_MAX_SPLITS`` of them; with 0 (where a block's slab and partial
    sums pass its shared memory, k above about 270) it is the FMA tile of
    ``csrc/rhs_tall.cuh`` over :func:`.rhs_tall.plan_splits`, a partial a
    split.  A function of the shapes and the card alone."""
    chunk = GRAM_CHUNK if k <= 64 else GRAM_CHUNK // 2
    clusters = min(GRAM_MAX_SPLITS, -(-R // (GRAM_CLUSTER * chunk)))
    chunk = -(-R // (GRAM_CLUSTER * clusters))
    nb = -(-k // 4) * (-(-k // 4) + 1) // 2
    shares = 1 if nb >= GRAM_THREADS else GRAM_THREADS // nb
    floats = -(-k // 4) * 4 * (chunk | 1) + shares * nb * 16
    if floats * 4 <= SHARED_LIMIT:
        return clusters, chunk, 1
    return (*plan_splits(R, k, k, sms, GRAM_MAX_SPLITS), 0)


def kxk_scratch_floats(k: int) -> int:
    """Device-memory scratch of the k x k section, in floats: none while a
    block or a cluster holds it in shared memory (:func:`refine_plan`), else
    G, X, T and the out-of-place product's target."""
    return refine_plan(k)[3]


def _workspace(m: int, n: int, k: int, shifted_w: bool, a_bf16: bool,
               sms: int):
    """The products' plans and the workspace's layout: ``(plan, offsets,
    total)`` with ``plan`` the (blocks, 0) of W A and H A^T, the (splits,
    chunk) of W W^T and H H^T (:func:`plan_gram`), the k x k section's
    (ranks, rows, threads) of :func:`refine_plan` and whether each Gram is
    the cluster kernel's,
    ``offsets`` the start of each buffer in floats (the order of ``enum
    Buffer`` in the source) and ``total`` the floats in all.  W and H
    prepared as the products' small operands come first, so that their
    16-byte rows start on 16 bytes."""
    plan = [(plan_tall(m, n, k, a_bf16, sms), 0),
            (plan_tall(n, m, k, a_bf16, sms), 0),
            plan_gram(m, k, sms)[:2], plan_gram(n, k, sms)[:2],
            refine_plan(k)[:3],
            (plan_gram(m, k, sms)[2], plan_gram(n, k, sms)[2])]
    sizes = [small_floats(k, m, a_bf16), small_floats(k, n, a_bf16),
             pieces_floats(k, plan[0][0]), pieces_floats(k, plan[1][0]),
             plan[2][0] * k * k,
             plan[3][0] * k * k, k * n, k * n, k * m,
             k * m if shifted_w else 0, k * m, k * k, k]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return plan, offsets, int(sum(sizes))


def fused_vmem_bytes(m: int, n: int, k: int, a_bf16: bool, maxit: int,
                     sms: int = H100_SMS) -> int:
    """Device memory the whole-fit kernel takes, in bytes: the copy of A it
    reads (bfloat16 or float32), both factors twice (the start and the
    result), d, the loss history, the two warm-start inverses, the k x k
    section's scratch (:func:`kxk_scratch_floats`) and the workspace of
    partial sums and right-hand sides."""
    a_bytes = m * n * (2 if a_bf16 else 4)
    factors = (2 * (k * m + k * n) + k + maxit + 2 * k * k
               + kxk_scratch_floats(k)) * 4
    return a_bytes + factors + _workspace(m, n, k, True, a_bf16, sms)[2] * 4


def _card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def device_limit(device=None) -> int:
    """Device memory a fit on ``device`` may take, in bytes: a share of that
    card's own memory, and :data:`DEVICE_LIMIT` for the CPU or no device."""
    if not _card(device):
        return DEVICE_LIMIT
    total = torch.cuda.get_device_properties(device).total_memory
    return int(DEVICE_SHARE * total)


def fused_vmem_fits(m: int, n: int, k: int, a_bf16: bool, maxit: int,
                    device=None) -> bool:
    sms = device_sms(torch.device(device)) if _card(device) else H100_SMS
    return (fused_vmem_bytes(m, n, k, a_bf16, maxit, sms)
            <= device_limit(device))


def check_gate(m: int, n: int, k: int, a_bf16: bool, maxit: int,
               device=None) -> None:
    """Raise ValueError, naming the limit, for a fit beyond the gate (of the
    card ``device``, or of the reference card for the CPU): device memory,
    whatever k is."""
    sms = device_sms(torch.device(device)) if _card(device) else H100_SMS
    need, limit = fused_vmem_bytes(m, n, k, a_bf16, maxit, sms), \
        device_limit(device)
    if need > limit:
        raise ValueError(
            f"fused_vmem: {m}x{n} k={k} needs ~{need >> 20} MB of device "
            f"memory (limit {limit >> 20} MB); drop the knob (or set "
            "bf16_data=True to halve the A bytes)")


def _norms(M):
    return M.abs().sum(dim=0).max() * M.abs().sum(dim=1).max()


def _ridged(G, extra=0.0):
    """G + ((1e-6 / k) tr(G) + extra) I."""
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    return G + ((RIDGE_REL / k) * torch.trace(G) + extra) * eye


def ns_refine_plain(G, X, ns_steps: int = 7):
    """``ns_steps`` Newton-Schulz steps towards G^-1 from X, rescaled first
    so that the iteration contracts."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    X = X * (1.0 / torch.sqrt(_norms(G @ X)))
    for _ in range(ns_steps):
        X = X @ (2.0 * eye - G @ X)
    return X


def seed_inverse_plain(F, l2: float = 0.0, ns_steps: int = 7):
    """The warm-start inverse a fit begins with: the refined inverse of the
    ridged Gram of the starting factor F (k, J)."""
    G0 = _ridged(F @ F.T, l2)
    return ns_refine_plain(G0, G0.T / _norms(G0), ns_steps)


def _small(X, a_bf16: bool):
    # the small operand as a bfloat16 product sees it
    return X.to(torch.bfloat16).to(torch.float32) if a_bf16 else X


def widened(A, a_bf16: bool):
    """A as the products read it: rounded to bfloat16 and widened once
    (products of bfloat16 values are exact in float32)."""
    return A.to(torch.bfloat16).to(torch.float32) if a_bf16 else A


def h_update_plain(A_mm, W, gh, *, nonneg: bool = True, a_bf16: bool = False,
                   ns_steps: int = 7, l1_h: float = 0.0, l2_h: float = 0.0):
    """The H half of one iteration from W (k, m) and the warm-start inverse
    ``gh``.  Returns (H with unit row sums, the refined inverse)."""
    gh = ns_refine_plain(_ridged(W @ W.T, l2_h), gh, ns_steps)
    B = _small(W, a_bf16) @ A_mm
    Hn = gh @ (B - l1_h if l1_h else B)
    if nonneg:
        Hn = torch.clamp(Hn, min=0.0)
    hs = torch.clamp(Hn.sum(dim=1, keepdim=True), min=1e-15)
    return Hn / hs, gh


def w_update_plain(A_mm, Hn, gw, trata, *, nonneg: bool = True,
                   a_bf16: bool = False, ns_steps: int = 7,
                   l1_w: float = 0.0, l2_w: float = 0.0):
    """The W half of one iteration from H (k, n) and the warm-start inverse
    ``gw``, and the loss of the pair.  Returns (W_T with unit row sums,
    d (k,), the refined inverse, the loss)."""
    k = Hn.shape[0]
    Gw = _ridged(Hn @ Hn.T)                   # the loss uses the L2-free Gw
    eye = torch.eye(k, dtype=Hn.dtype, device=Hn.device)
    gw = ns_refine_plain(Gw + l2_w * eye if l2_w else Gw, gw, ns_steps)
    Bw = _small(Hn, a_bf16) @ A_mm.T
    Wn = gw @ (Bw - l1_w if l1_w else Bw)
    if nonneg:
        Wn = torch.clamp(Wn, min=0.0)
    # clamped before every use: an all-clipped row gives d = 1e-15
    ws = torch.clamp(Wn.sum(dim=1, keepdim=True), min=1e-15)
    Wn = Wn / ws
    cross = (ws * Wn * Bw).sum()
    loss = trata - 2.0 * cross + ((ws * ws.T) * (Wn @ Wn.T) * Gw).sum()
    return Wn, ws[:, 0], gw, loss


def fused_als_plain(A: torch.Tensor, W_T0: torch.Tensor, H0: torch.Tensor, *,
                    maxit: int, nonneg: bool = True, a_bf16: bool = False,
                    ns_steps: int = 7, l1_w: float = 0.0, l1_h: float = 0.0,
                    l2_w: float = 0.0, l2_h: float = 0.0):
    """Plain twin of ``rcppml_tpu/models/nmf.py::_ns_als_xla``: the same
    Newton-Schulz ALS as a Python loop of matmuls in the same order
    (:func:`h_update_plain`, :func:`w_update_plain`).  Runs on whatever
    device the tensors are on.  Returns (W_T, H, d, hist)."""
    k = W_T0.shape[0]
    f32 = torch.float32
    common = dict(nonneg=nonneg, a_bf16=a_bf16, ns_steps=ns_steps)
    trata = (A * A).sum()
    A_mm = widened(A, a_bf16)
    # ridge before seeding, as in the kernel
    gh = seed_inverse_plain(W_T0, l2_h, ns_steps)
    gw = seed_inverse_plain(H0, l2_w, ns_steps)

    W, H = W_T0, H0
    d = torch.ones((k,), dtype=f32, device=A.device)
    hist = torch.full((maxit,), float("nan"), dtype=f32, device=A.device)
    for it in range(maxit):
        H, gh = h_update_plain(A_mm, W, gh, l1_h=l1_h, l2_h=l2_h, **common)
        W, d, gw, hist[it] = w_update_plain(A_mm, H, gw, trata, l1_w=l1_w,
                                            l2_w=l2_w, **common)
    return W, H, d, hist


def _check(A, W_T0, H0, maxit):
    if A.ndim != 2 or W_T0.ndim != 2 or H0.ndim != 2:
        raise ValueError("fused_als: A, W_T0 and H0 must be matrices")
    m, n = A.shape
    k = W_T0.shape[0]
    if W_T0.shape != (k, m) or H0.shape != (k, n) or k == 0:
        raise ValueError(f"fused_als: A {tuple(A.shape)}, W_T0 "
                         f"{tuple(W_T0.shape)} and H0 {tuple(H0.shape)} do "
                         "not fit together")
    if maxit <= 0:
        raise ValueError(f"fused_als: maxit must be positive, got {maxit}")
    for name, t in (("A", A), ("W_T0", W_T0), ("H0", H0)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_als: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != A.device:
            raise ValueError(f"fused_als: {name} is on {t.device}, A on "
                             f"{A.device}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.fused_als_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 6 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def fused_als(A: torch.Tensor, W_T0: torch.Tensor, H0: torch.Tensor, *,
              maxit: int, nonneg: bool = True, a_bf16: bool = False,
              ns_steps: int = 7, l1_w: float = 0.0, l1_h: float = 0.0,
              l2_w: float = 0.0, l2_h: float = 0.0):
    """Run a whole dense MSE ALS fit (fixed iteration count, L1 norm).

    A (m, n), W_T0 (k, m), H0 (k, n), all float32; with ``a_bf16`` the
    products read a bfloat16 copy of A (tr(A'A) is taken in float32 first).
    Returns (W_T (k, m), H (k, n), d (k,), loss_hist (maxit,)).

    Beyond the gate (:func:`check_gate`) it raises ``ValueError`` on either
    device.  On a CUDA tensor this enqueues the kernels (and raises
    ``RuntimeError`` if a launch fails) without waiting for them; on a CPU
    tensor it runs :func:`fused_als_plain`.
    """
    _check(A, W_T0, H0, maxit)
    m, n = A.shape
    k = W_T0.shape[0]
    check_gate(m, n, k, a_bf16, maxit, A.device)
    kw = dict(maxit=int(maxit), nonneg=bool(nonneg), a_bf16=bool(a_bf16),
              ns_steps=int(ns_steps), l1_w=float(l1_w), l1_h=float(l1_h),
              l2_w=float(l2_w), l2_h=float(l2_h))
    if not A.is_cuda:
        return fused_als_plain(A, W_T0, H0, **kw)
    dev, f32 = A.device, torch.float32
    trata = (A * A).sum().reshape(1)
    A_k = A.to(torch.bfloat16) if a_bf16 else A
    A_k = A_k.contiguous()
    W = W_T0.clone(memory_format=torch.contiguous_format)   # updated in place
    H = H0.clone(memory_format=torch.contiguous_format)
    d = torch.empty((k,), dtype=f32, device=dev)
    hist = torch.empty((maxit,), dtype=f32, device=dev)
    ginv = torch.empty((2, k, k), dtype=f32, device=dev)
    plan, offsets, total = _workspace(m, n, k, l1_w != 0.0, a_bf16,
                                      device_sms(dev))
    work = torch.empty((total,), dtype=f32, device=dev)
    # the k x k section's matrices, where they do not fit shared memory
    n_kxk = kxk_scratch_floats(k)
    kxk = torch.empty((n_kxk,), dtype=f32, device=dev) if n_kxk else None
    # the starting W prepared as the first product's small operand
    prepare_small(W_T0, a_bf16, work[:offsets[1]])
    c_offsets = (ctypes.c_longlong * len(offsets))(*offsets.tolist())
    c_plan = (ctypes.c_int * 13)(*[v for part in plan for v in part])
    launched = ctypes.c_int(0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_als_launch(
            A_k.data_ptr(), int(a_bf16), W.data_ptr(), H.data_ptr(),
            d.data_ptr(), hist.data_ptr(), ginv[0].data_ptr(),
            ginv[1].data_ptr(), work.data_ptr(),
            kxk.data_ptr() if kxk is not None else None,
            ctypes.addressof(c_offsets), ctypes.addressof(c_plan),
            trata.data_ptr(), k, m, n,
            kw["maxit"], int(kw["nonneg"]), kw["ns_steps"],
            float(np.float32(l1_w)), float(np.float32(l1_h)),
            float(np.float32(l2_w)), float(np.float32(l2_h)),
            float(np.float32(RIDGE_REL / k)), ctypes.addressof(launched),
            stream)
    fused_als.launches += launched.value
    if err != 0:
        raise RuntimeError(
            f"fused_als kernel launch failed: CUDA error {err} after "
            f"{launched.value} launches (m={m}, n={n}, k={k}, maxit={maxit})")
    fused_als.calls += 1
    return W, H, d, hist


fused_als.launches = 0
fused_als.calls = 0
