"""B = F A and B = H A^T with A read once: the CUDA kernels and their plain
PyTorch twins.

Replace the TPU kernels ``rcppml_tpu/ops/pallas_experiments.py::
rhs_tall_pallas`` (B = F A, F (k, m), A (m, n)) and ``rhs_tall_t_pallas``
(B = H A^T, H (k, n), A (m, n), no transpose made).  The CUDA source is
``csrc/rhs_tall.cu`` with its device code, the tall product, in
``csrc/rhs_tall.cuh``, which the whole-fit kernel (``csrc/fused_als.cu``)
includes for the same two products.

What bounds them on the H100 is one read of A.  A block's tile is 128
columns of the output (rows of A when transposed) by all k rows of a pass
(128 rows a pass), computed on the tensor cores with ``mma.sync``: a
bfloat16 A with the small operand rounded to bfloat16, a float32 A in 3xTF32
(each operand split into a TF32 high part and a TF32 remainder, three
products), which keeps float32 accuracy.  The small operand is prepared once
per call (:func:`prepare_small` is the same preparation in PyTorch).  Two
producer warps keep a ring of 16-byte ``cp.async`` stages in flight, each
covering 256 bytes of every row of A whatever the row's alignment (the main
path's row strides, 10,552 and 5,276 bytes at the pbmc3k shape, rule out
TMA), so A is read as it lies; eight consumer warps multiply.  The (tile,
stage) units are cut into runs of equal length, the same number on every
multiprocessor (:func:`plan_tall`, :func:`tall_runs`), each run writes a
piece per tile it touches, and the pieces of a tile are added in the order
of their blocks: no float atomics, the same bits every run.  The copies bound
it: the ring moves A at about 2.4 TB/s, where one PyTorch reduction over A
reaches 2.65 and the card's peak is 3.35 (``tools/torch_rhs_variants.py``
takes it apart).

A is float32 or bfloat16.  With a bfloat16 A the small operand is rounded to
bfloat16 (to nearest even) first and the sum is float32, as
``rcppml_tpu/ops/linalg.py::rhs`` does on the matrix unit.

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
# the small product of csrc/rhs_tall.cuh (kernel 3's Grams): output columns
# per block, output rows per pass, and the reduction depth a split's length
# is a multiple of
TILE_COLS, TILE_ROWS, TILE_DEPTH = 64, 128, 32
# the tall product: output columns (rows of A when transposed) of a tile,
# and the reduction depth of one stage (256 bytes of each row of A)
TALL_COLS = 128
TALL_DEPTH = {torch.float32: 64, torch.bfloat16: 128}
# blocks of the tall product a multiprocessor holds up to TALL_TWO_BLOCKS_K
# rows (registers; one beyond), and the stages a run needs to keep two
# blocks' rings full
TALL_BLOCKS_PER_SM, TALL_TWO_BLOCKS_K, TALL_MIN_RUN = 2, 32, 8
H100_SMS = 132


def plan_splits(R: int, J: int, k: int, sms: int = H100_SMS,
                max_splits: int = 1024) -> tuple[int, int]:
    """How a small product (kernel 3's Grams) with reduction length R and a
    (k, J) output is cut: ``(splits, chunk)``, ``chunk`` a multiple of 32
    and ``splits * chunk >= R``.  Enough splits for about four blocks per
    multiprocessor, each at least 128 long.  A function of the shapes and
    the card alone, so a call repeats bit for bit."""
    tiles = -(-J // TILE_COLS) * -(-k // TILE_ROWS)
    want = -(-4 * sms // tiles)
    splits = max(1, min(want, R // 128, max_splits))
    per_split = -(-R // splits)
    chunk = -(-per_split // TILE_DEPTH) * TILE_DEPTH
    return -(-R // chunk), chunk


def plan_tall(R: int, J: int, k: int, a_bf16: bool,
              sms: int = H100_SMS) -> int:
    """How many blocks a tall product (kernels 7, 8 and kernel 3's products
    with A) with reduction length R and a (k, J) output runs in.  Its units
    of work, ceil(J / 128) column tiles of ceil(R / depth) stages each
    (depth 64 float32 or 128 bfloat16 values), are cut into that many runs
    of nearly equal length (stream-K).  Every multiprocessor gets the same
    number of blocks: two where it holds two (k up to 32) and the runs stay
    at least ``TALL_MIN_RUN`` stages long, else one.  Where a whole number of blocks per tile comes
    within a tenth of that, the runs follow the tiles (each run one piece,
    and neighbouring tiles read the same rows of A at the same time);
    otherwise they cross them.  Never fewer blocks than tiles (so that a run
    touches at most two tiles) nor more than units.  A function of the
    shapes and the card alone, so a call repeats bit for bit."""
    depth = TALL_DEPTH[torch.bfloat16 if a_bf16 else torch.float32]
    tiles = -(-J // TALL_COLS)
    units = tiles * -(-R // depth)
    two = k <= TALL_TWO_BLOCKS_K and \
        units >= TALL_BLOCKS_PER_SM * sms * TALL_MIN_RUN
    per_sm = TALL_BLOCKS_PER_SM if two else 1
    target = per_sm * sms
    aligned = tiles * max(1, target // tiles)
    blocks = aligned if 10 * aligned >= 9 * target else target
    return max(tiles, min(blocks, units))


def tall_runs(R: int, J: int, a_bf16: bool, blocks: int):
    """The runs of a tall product as ``launch_tall`` cuts them: for each
    block the list of (tile, first stage, stages) pieces it computes."""
    depth = TALL_DEPTH[torch.bfloat16 if a_bf16 else torch.float32]
    spt = -(-R // depth)
    units = -(-J // TALL_COLS) * spt
    runs = []
    for b in range(blocks):
        u, end = b * units // blocks, (b + 1) * units // blocks
        pieces = []
        while u < end:
            tile, first = divmod(u, spt)
            n = min(spt - first, end - u)
            pieces.append((tile, first, n))
            u += n
        runs.append(pieces)
    return runs


def pieces_floats(k: int, blocks: int) -> int:
    """Size in float32 words of a tall product's pieces: two (k, 128)
    matrices a block."""
    return 2 * blocks * k * TALL_COLS


def small_ld(R: int, a_bf16: bool) -> int:
    """Row stride, in elements, of a small operand of R columns prepared for
    the tall product (``small_ld`` of the source): whole stages of 256
    bytes, so that a stage's copy of a row never leaves it."""
    depth = TALL_DEPTH[torch.bfloat16 if a_bf16 else torch.float32]
    return -(-R // depth) * depth


def small_floats(k: int, R: int, a_bf16: bool) -> int:
    """Size in float32 words of a (k, R) small operand prepared for the tall
    product: k rows of bfloat16 values, or two planes of k rows of TF32
    parts."""
    ld = small_ld(R, a_bf16)
    return k * ld // 2 if a_bf16 else 2 * k * ld


def prepare_small(X: torch.Tensor, a_bf16: bool,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """X (k, R) float32 as the tall product reads it (``store_small`` of the
    source), bit for bit: rounded to bfloat16 (to nearest even), or split
    into TF32 high parts and, a plane further on, TF32 low parts (10
    fraction bits, to nearest, ties away from zero).  Written into ``out``
    (``small_floats`` float32 words) or a new buffer, which is returned; the
    columns from R to the row stride are zero."""
    k, R = X.shape
    ld = small_ld(R, a_bf16)
    if out is None:
        out = torch.empty((small_floats(k, R, a_bf16),), dtype=torch.float32,
                          device=X.device)
    if a_bf16:
        rows = out.view(torch.bfloat16).view(k, ld)
        rows[:, :R] = X.to(torch.bfloat16)
        rows[:, R:] = 0
        return out
    planes = out.view(torch.int32).view(2, k, ld)
    planes[:, :, R:] = 0

    def tf32(v):
        return (v.view(torch.int32) + 0x1000) & -0x2000

    hi = tf32(X)
    planes[0, :, :R] = hi
    planes[1, :, :R] = tf32(X - hi.view(torch.float32))
    return out


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
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
    bf16 = A.dtype == torch.bfloat16
    blocks = plan_tall(R, J, k, bf16, device_sms(A.device))
    out = torch.empty((k, J), dtype=torch.float32, device=A.device)
    work = torch.empty((pieces_floats(k, blocks),), dtype=torch.float32,
                       device=A.device)
    # X prepared for the product by the first kernel of the call
    small = torch.empty((small_floats(k, R, bf16),), dtype=torch.float32,
                        device=A.device)
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.rhs_tall_launch(
            X.data_ptr(), A.data_ptr(), out.data_ptr(), work.data_ptr(),
            small.data_ptr(), k, m, n, int(bf16), int(transposed), blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(k={k}, m={m}, n={n}, blocks={blocks})")
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
