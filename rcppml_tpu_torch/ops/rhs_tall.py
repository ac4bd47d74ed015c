"""B = F A and B = H A^T with A read once: the CUDA kernels and their plain
PyTorch twins.

Replace the TPU kernels ``rcppml_tpu/ops/pallas_experiments.py::
rhs_tall_pallas`` (B = F A, F (k, m), A (m, n)) and ``rhs_tall_t_pallas``
(B = H A^T, H (k, n), A (m, n), no transpose made).  The CUDA source is
``csrc/rhs_tall.cu`` with its device code in ``csrc/rhs_tall.cuh``, which the
whole-fit kernel (``csrc/fused_als.cu``) includes for the same two products.
A block owns an output tile of all k rows (up to 128) by 64 columns, so every
element of A is read from device memory once per call (once per 128 rows of
k beyond that); where the output has too few tiles to fill the card the
reduction is split across blocks, each split writes its own partial, and the
partials are added in the order of their index: no float atomics, the same
bits every run.  What bounds them on the H100 is one read of A; the kernels
are plain FMA tiles through shared memory and sit nearer the float32 rate.

A is float32 or bfloat16.  With a bfloat16 A the small operand is rounded to
bfloat16 first and the sum is float32, as ``rcppml_tpu/ops/linalg.py::rhs``
does on the matrix unit.

:func:`rhs_tall` and :func:`rhs_tall_t` launch the kernel for a CUDA tensor
and run :func:`rhs_tall_plain` / :func:`rhs_tall_t_plain` for a CPU tensor;
there is no other branch.  ``rhs_tall.launches`` and ``rhs_tall_t.launches``
count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNEL = "rhs_tall"
# the tile of csrc/rhs_tall.cuh: output columns per block, output rows per
# pass, and the reduction depth a split's length is a multiple of
TILE_COLS, TILE_ROWS, TILE_DEPTH = 64, 128, 32
H100_SMS = 132


def plan_splits(R: int, J: int, k: int, sms: int = H100_SMS,
                max_splits: int = 1024) -> tuple[int, int]:
    """How a product with reduction length R and a (k, J) output is cut:
    ``(splits, chunk)``, ``chunk`` a multiple of 32 and ``splits * chunk >=
    R``.  Enough splits for about four blocks per multiprocessor, each at
    least 128 long.  A function of the shapes and the card alone, so a call
    repeats bit for bit."""
    tiles = -(-J // TILE_COLS) * -(-k // TILE_ROWS)
    want = -(-4 * sms // tiles)
    splits = max(1, min(want, R // 128, max_splits))
    per_split = -(-R // splits)
    chunk = -(-per_split // TILE_DEPTH) * TILE_DEPTH
    return -(-R // chunk), chunk


@functools.cache
def device_sms(device: torch.device) -> int:
    """Multiprocessors of a CUDA device (asked once: the query is slow
    beside a product of tens of microseconds)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _round_small(X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The small operand as the product sees it: rounded to bfloat16 (and
    back) when A is bfloat16."""
    if A.dtype == torch.bfloat16:
        return X.to(torch.bfloat16).to(torch.float32)
    return X


def rhs_tall_plain(F: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """F (k, m) @ A (m, n) in float32; also the library call the kernel is
    timed beside.  A bfloat16 A is widened: the products are exact."""
    return _round_small(F, A) @ A.to(torch.float32)


def rhs_tall_t_plain(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """H (k, n) @ A (m, n)^T in float32."""
    return _round_small(H, A) @ A.to(torch.float32).T


def _check(name, X, A, transposed):
    m, n = A.shape
    k, r = X.shape
    if r != (n if transposed else m):
        raise ValueError(f"{name}: X {tuple(X.shape)} and A {tuple(A.shape)} "
                         "do not fit together")
    if X.dtype != torch.float32:
        raise TypeError(f"{name}: the small operand must be float32, got "
                        f"{X.dtype}")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: A must be float32 or bfloat16, got "
                        f"{A.dtype}")
    if X.device != A.device:
        raise ValueError(f"{name}: X is on {X.device}, A on {A.device}")
    if min(k, m, n) == 0:
        raise ValueError(f"{name}: empty operand, X {tuple(X.shape)}, A "
                         f"{tuple(A.shape)}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its entry point's C signature."""
    lib = _build.load(KERNEL)
    fn = lib.rhs_tall_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(name, X, A, transposed):
    if not A.is_contiguous():
        # a copy of A would cost more than the product
        raise ValueError(f"{name}: A must be contiguous (row-major)")
    m, n = A.shape
    k = X.shape[0]
    J, R = (m, n) if transposed else (n, m)
    X = X.contiguous()
    splits, chunk = plan_splits(R, J, k, device_sms(A.device))
    out = torch.empty((k, J), dtype=torch.float32, device=A.device)
    work = (torch.empty((splits, k, J), dtype=torch.float32, device=A.device)
            if splits > 1 else None)
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.rhs_tall_launch(
            X.data_ptr(), A.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None, k, m, n,
            int(A.dtype == torch.bfloat16), int(transposed), splits, chunk,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(k={k}, m={m}, n={n}, splits={splits})")
    return out


def rhs_tall(F: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """B (k, n) = F (k, m) A (m, n), float32, A read once.

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`rhs_tall_plain`.
    """
    _check("rhs_tall", F, A, False)
    if not A.is_cuda:
        return rhs_tall_plain(F, A)
    out = _launch("rhs_tall", F, A, False)
    rhs_tall.launches += 1
    return out


def rhs_tall_t(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """B (k, m) = H (k, n) A (m, n)^T, float32, A read once and never
    transposed in memory.

    On a CUDA tensor this launches the kernel (and raises if the launch
    fails); on a CPU tensor it runs :func:`rhs_tall_t_plain`.
    """
    _check("rhs_tall_t", H, A, True)
    if not A.is_cuda:
        return rhs_tall_t_plain(H, A)
    out = _launch("rhs_tall_t", H, A, True)
    rhs_tall_t.launches += 1
    return out


rhs_tall.launches = 0
rhs_tall_t.launches = 0
