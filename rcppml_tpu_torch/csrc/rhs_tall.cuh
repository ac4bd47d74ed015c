// Products that read their large operand once, for sm_90a:
//   forward      C (k, J) = X (k, R) . Y (R, J)        (B = F . A)
//   transposed   C (k, J) = X (k, R) . Y (J, R)^T      (B = H . A^T, no
//                                                       transpose is made)
// Y is row-major with row stride ldy, X row-major with row stride ldx.
//
// 1. The tall product (launch_tall) is the device code of rhs_tall.cu
//    (kernels 7 and 8) and of the two products with A inside fused_als.cu
//    (kernel 3).  It replaces the TPU kernels rcppml_tpu/ops/
//    pallas_experiments.py::rhs_tall_pallas / rhs_tall_t_pallas and the
//    rhs_fwd / rhs_trp bodies of rcppml_tpu/ops/pallas_kernels.py::
//    _make_fused_als_vmem_kernel.
//
//    Bound on the H100: one read of A (bytes): 145 MB in float32 at the
//    pbmc3k shape, 43 us at 3.35 TB/s, against 2 k m n = 1.4 GFLOP.  The
//    design keeps bytes in flight and spends little else:
//    * Tensor cores, output transposed.  A block owns 128 columns of the
//      output (columns of A forward, rows of A transposed): the M side of
//      mma.sync, 16 per consumer warp, 8 consumer warps.  All k rows of a
//      pass are the N side, rounded up to 8 (k = 20 computes 24 rows);
//      k > 128 takes ceil(k / 128) passes (blockIdx.z), each reading A once.
//      mma.sync and not wgmma: the forward tile of A is MN-major, which
//      wgmma takes only for 16-bit types, and its rows sit at 4-byte offsets
//      that wgmma's shared-memory layouts do not allow; the tensor work is
//      1.5 us of a 43 us product.
//    * bfloat16 A: m16n8k16, the products exact, each stage's sum added to
//      the float32 accumulator with compensation (Kahan), so the result is
//      within about one rounding of the exact sum whatever the split.
//    * float32 A: 3xTF32 on m16n8k8: x = hi + lo with hi = tf32(x);
//      a_lo x_hi + a_hi x_lo + a_hi x_hi, each product off by about 2^-21 of
//      itself; no single-pass TF32.  TF32 rounding is done with integer
//      operations: cvt to TF32 runs on the conversion unit at a quarter of
//      the integer rate and bound the first version of this product.
//    * The small operand X is prepared once per call (store_small): rounded
//      to bfloat16 as rcppml_tpu/ops/linalg.py::rhs does, or split into its
//      TF32 high and low parts, in rows padded with zeros to whole stages
//      (256 bytes) that start on 16 bytes.  Kernels 7 and 8 launch
//      prepare_small_kernel first; in kernel 3 the row normalisation that
//      writes a factor also writes it prepared.
//    * Bytes in flight: two producer warps fill a ring of 2 to 4 stages in
//      shared memory with cp.async, each stage 256 bytes of every A row's
//      reduction (64 float32 or 128 bfloat16 values) and the same slice of
//      X; mbarriers hand a stage to the 8 consumer warps when its copies
//      have landed and back when they are done, so copies and products
//      overlap and no warp waits on a block-wide barrier.
//    * No TMA: a tensor map needs a row stride that is a multiple of 16
//      bytes, and pbmc3k's A has 10,552 (float32) and 5,276 (bfloat16).
//      Instead every copy is a 16-byte cp.async of the aligned chunks that
//      cover a row's bytes, which land at the row's address modulo 16 (its
//      lead); a consumer lane reads each row at its lead, which for the
//      rows one lane reads is the same at every stage (one or two numbers a
//      lane).  Ragged ends are zero-filled by cp.async's source size.  A
//      bfloat16 A at odd element offsets (odd n) is copied two bytes at a
//      time through registers instead.  A is read as it lies: no copy, no
//      padding.  (Copies as narrow as a row's alignment, 8 bytes for
//      pbmc3k's float32 A and 4 for its bfloat16 A, were tried first: the
//      copy rate followed the number of cp.async instructions, not bytes.
//      One bulk copy per row, 144 to 528 bytes, was slower than the ring.)
//    * Stream-K: the (column tile, stage) units of a pass, tile after tile,
//      are cut into runs of nearly equal length, one a block, the same
//      number of blocks on every multiprocessor: two up to k = 32 (the
//      launch bounds cap the registers so that two fit, without spills),
//      else one, and one where two would leave runs too short to fill the
//      ring (rcppml_tpu_torch/ops/rhs_tall.py::plan_tall, a function of the
//      shapes and the SM count).  Where a whole number of blocks per tile
//      comes within a tenth of that, the runs follow the tiles.  A run
//      touches at most two tiles and writes a partial piece for each;
//      reduce_pieces_kernel adds a tile's pieces in the order of their
//      blocks, a warp per row of a tile, 16-byte vectors.  No float atomics:
//      the same bits every run.
//    * What bounds it: the copies.  On an H100 SXM at the pbmc3k shape the
//      ring alone (products removed) reads A at 2.25 to 2.5 TB/s, where one
//      PyTorch reduction over A reads it at 2.65 (float32) and 2.3
//      (bfloat16) TB/s; the products alone (copies removed) take 40 to 60%
//      of that time, and the two together 9 to 12% longer than the copies
//      alone.  Four producer warps, one block a multiprocessor, and a float32 X
//      split by the consumers instead of prepared were measured and were
//      not faster (tools/torch_rhs_variants.py).
//
// 2. The small product (launch_small): a float32 FMA tile through shared
//    memory, for kernel 3's k x k-sized products (the Grams F F^T and
//    Ginv . B), which are exact float32 like the twin's.  A block owns an
//    output tile of up to 128 rows by 64 columns; k > 128 takes
//    ceil(k / 128) passes.  The reduction may be split across blockIdx.y;
//    each split writes its own partial, which kernel 3 adds in the order of
//    their index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace rhs_tall {

// ---------------------------------------------------------------------------
// 1. The tall product
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;                   // consumers: the tensor-core work
constexpr int kThreads = 32 * kWarps;
constexpr int kProducers = 64;              // two warps: the copies
constexpr int kBlockThreads = kThreads + kProducers;
constexpr int kTileCols = 16 * kWarps;      // the M side of a block
constexpr int kPassRows = 128;              // output rows per pass over A
// of each row's reduction: 256 bytes read a row's DRAM page in fewer, longer
// pieces than 128 (the copies alone: 2.41 against 2.30 TB/s, float32 F A)
constexpr int kStageBytes = 256;
// a K-major shared row (transposed tile of A, tile of X): room for the 16
// bytes before a row's first byte, which also puts the eight rows of a
// fragment read in different banks
constexpr int kKStride = kStageBytes + 16;
// shared memory of a block while two share a multiprocessor (227 KB / 2),
// and of a block alone (less room for the ring's barriers)
constexpr int kTwoBlocks = 113 * 1024;
constexpr int kOneBlock = 227 * 1024 - 128;
constexpr int kSmallAlign = 16;             // bytes: rows of a prepared X

template <typename T>
struct Kind;
template <>
struct Kind<float> {
  static constexpr int kDepth = 64;         // reduction per stage
  static constexpr int kXTiles = 2;         // X's TF32 high and low parts
  // forward tile row: 136 words, = 8 (mod 32)
  static constexpr int kFwdStride = 4 * kTileCols + 32;
};
template <>
struct Kind<__nv_bfloat16> {
  static constexpr int kDepth = 128;
  static constexpr int kXTiles = 1;
  // forward tile row: 272 bytes, = 16 (mod 128)
  static constexpr int kFwdStride = 2 * kTileCols + 16;
};

template <typename T, bool kTrans, int NT>
struct Tile {
  static constexpr int kDepth = Kind<T>::kDepth;
  static constexpr int kRows = 8 * NT;      // rows of X per stage
  static constexpr int kA =
      kTrans ? kTileCols * kKStride : kDepth * Kind<T>::kFwdStride;
  static constexpr int kX = kRows * kKStride;
  static constexpr int kStage = kA + Kind<T>::kXTiles * kX;
  // blocks a multiprocessor holds: two up to 32 rows a pass, the registers
  // capped to fit (no spills), else one (rcppml_tpu_torch/ops/rhs_tall.py::
  // plan_tall follows this)
  static constexpr int kBlocksPerSm = NT <= 4 ? 2 : 1;
  // as many stages as fit that many blocks' shared memory, at most four
  // (two at k <= 32, three or two beyond)
  static constexpr int kFit =
      (kBlocksPerSm == 2 ? kTwoBlocks : kOneBlock) / (kStage + 16);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr int kShared = kStages * kStage + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes, `bytes` (0..16) of them read and the rest zero
__device__ __forceinline__ void copy_async16(uint32_t dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The mbarriers of the ring: `full` completes when a stage's copies have
// landed, `empty` when the consumers are done with its slot
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// arrive on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The copies of one tile of a stage, by the producer thread p of
// kProducers.  Row r of the tile is kRowBytes bytes at src + r ld (bytes);
// the 16-byte chunks that cover them are copied whole to dst + r stride, so
// the row's first byte lands at its source address modulo 16, the row's
// lead.  Bytes at or past valid_bytes of a row, and rows at or past
// valid_rows, are zero; the lead bytes before a row hold whatever lies there
// in memory, and nothing reads them.
template <int kRowBytes>
__device__ __forceinline__ void copy_rows(uint32_t dst, int stride,
                                          const char* src, size_t ld,
                                          int rows, int valid_rows,
                                          int valid_bytes, int p) {
  constexpr int kChunks = kRowBytes / 16 + 1;
  const char* aligned = src - (reinterpret_cast<uintptr_t>(src) & 15);
  for (int e = p; e < rows * kChunks; e += kProducers) {
    const int r = e / kChunks, c = e - r * kChunks;
    const char* row = src + r * ld;
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    const int end = r < valid_rows ? lead + valid_bytes : 0;
    const int bytes = min(max(end - 16 * c, 0), 16);
    copy_async16(dst + r * stride + 16 * c,
                 bytes > 0 ? row - lead + 16 * c : aligned, bytes);
  }
}

// The same for rows whose first bytes are 16-byte aligned (a prepared X):
// no lead, kRowBytes / 16 chunks a row
template <int kRowBytes>
__device__ __forceinline__ void copy_aligned_rows(uint32_t dst, int stride,
                                                  const char* src, size_t ld,
                                                  int rows, int valid_rows,
                                                  int valid_bytes, int p) {
  constexpr int kChunks = kRowBytes / 16;
  for (int e = p; e < rows * kChunks; e += kProducers) {
    const int r = e / kChunks, c = e - r * kChunks;
    const int bytes =
        r < valid_rows ? min(max(valid_bytes - 16 * c, 0), 16) : 0;
    copy_async16(dst + r * stride + 16 * c,
                 bytes > 0 ? src + r * ld + 16 * c : src, bytes);
  }
}

// The same for a bfloat16 operand at odd element offsets, whose rows cannot
// all be copied in 4-byte pieces: two bytes at a time through registers, a
// row's first byte at the start of its shared row (lead 0).
template <int kRowBytes>
__device__ __forceinline__ void copy_rows_narrow(uint32_t dst, int stride,
                                                 const char* src, size_t ld,
                                                 int rows, int valid_rows,
                                                 int valid_bytes, int p) {
  constexpr int kHalves = kRowBytes / 2;
  for (int e = p; e < rows * kHalves; e += kProducers) {
    const int r = e / kHalves, off = 2 * (e - r * kHalves);
    const unsigned short v =
        r < valid_rows && off < valid_bytes
            ? __ldg(reinterpret_cast<const unsigned short*>(src + r * ld +
                                                            off))
            : static_cast<unsigned short>(0);
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst + r * stride + off),
                 "h"(v)
                 : "memory");
  }
}

__device__ __forceinline__ int lead_of(const char* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// d += A (16 x 16) . B (16 x 8) in bfloat16, float32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as the tall product's small operand, element `at` of a prepared X:
// with a bfloat16 A rounded to bfloat16 (to nearest even); with a float32 A
// its TF32 high part, and `plane` elements further on its low part
__device__ __forceinline__ void store_small(float x, void* P, size_t at,
                                            size_t plane, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(P)[at] = __float2bfloat16_rn(x);
  } else {
    const uint32_t hi = tf32::round(x);
    uint32_t* w = static_cast<uint32_t*>(P);
    w[at] = hi;
    w[at + plane] = tf32::round(x - __uint_as_float(hi));
  }
}

// One stage of a bfloat16 tile: warp w adds output columns 16 w + [0, 16)
// of the stage's product to acc, with err the compensation of acc's sum.
// The stage's product is summed in the tensor cores (its terms are exact),
// then added once.  Fragments are read a word (the transposed tile, X) or
// two halves (the forward tile) at a time, each at its row's lead: lead_a0
// for the rows a lane reads (the even rows of the forward tile), lead_a1 for
// the odd rows of the forward tile.
template <bool kTrans, int NT>
__device__ __forceinline__ void stage_bf16(const unsigned char* slot,
                                           float (&acc)[NT][4],
                                           float (&err)[NT][4], int lane,
                                           int warp, int lead_a0,
                                           int lead_a1) {
  using P = Tile<__nv_bfloat16, kTrans, NT>;
  constexpr int kK = kKStride / 4;                          // words
  constexpr int kF = Kind<__nv_bfloat16>::kFwdStride / 2;   // halves
  const int g = lane / 4, t = lane % 4;
  const int m = 16 * warp + g;
  const uint32_t* Xw = reinterpret_cast<const uint32_t*>(slot + P::kA);
  float part[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[nt][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < P::kDepth / 16; ++ks) {
    uint32_t a[4];
    if (kTrans) {
      const uint32_t* Aw = reinterpret_cast<const uint32_t*>(slot + lead_a0);
      const int c = 8 * ks + t;
      a[0] = Aw[m * kK + c];
      a[1] = Aw[(m + 8) * kK + c];
      a[2] = Aw[m * kK + c + 4];
      a[3] = Aw[(m + 8) * kK + c + 4];
    } else {
      const unsigned short* Ae =
          reinterpret_cast<const unsigned short*>(slot + lead_a0);
      const unsigned short* Ao =
          reinterpret_cast<const unsigned short*>(slot + lead_a1);
      const int r = 16 * ks + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + 8 * (q / 2), mm = m + 8 * (q % 2);
        a[q] = static_cast<uint32_t>(Ae[rr * kF + mm]) |
               (static_cast<uint32_t>(Ao[(rr + 1) * kF + mm]) << 16);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* xr = Xw + (8 * nt + g) * kK + 8 * ks + t;
      mma_bf16(part[nt], a, xr[0], xr[4]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float y = part[nt][q] - err[nt][q];
      const float s = acc[nt][q] + y;
      err[nt][q] = (s - acc[nt][q]) - y;
      acc[nt][q] = s;
    }
}

// The same for a float32 tile in 3xTF32.  X comes split (its TF32 high and
// low tiles); A is split here: hi = tf32(a), lo = a - hi, of which the
// tensor cores read the top 19 bits.  The stage's a_hi x_hi products are
// summed in the tensor cores and then added to acc; the small terms a_lo x_hi
// + a_hi x_lo, about 2^-11 of them, run in `small` over the whole reduction.
template <bool kTrans, int NT>
__device__ __forceinline__ void stage_f32(const unsigned char* slot,
                                          float (&acc)[NT][4],
                                          float (&small)[NT][4], int lane,
                                          int warp, int lead_a) {
  using P = Tile<float, kTrans, NT>;
  constexpr int kK = kKStride / 4;
  constexpr int kF = Kind<float>::kFwdStride / 4;
  const float* As = reinterpret_cast<const float*>(slot + lead_a);
  const uint32_t* Xh = reinterpret_cast<const uint32_t*>(slot + P::kA);
  const uint32_t* Xl = reinterpret_cast<const uint32_t*>(slot + P::kA + P::kX);
  const int g = lane / 4, t = lane % 4;
  const int m = 16 * warp + g;
  float big[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) big[nt][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < P::kDepth / 8; ++ks) {
    const int r = 8 * ks + t;
    float a[4];
    if (kTrans) {
      a[0] = As[m * kK + r];
      a[1] = As[(m + 8) * kK + r];
      a[2] = As[m * kK + r + 4];
      a[3] = As[(m + 8) * kK + r + 4];
    } else {
      a[0] = As[r * kF + m];
      a[1] = As[r * kF + m + 8];
      a[2] = As[(r + 4) * kF + m];
      a[3] = As[(r + 4) * kF + m + 8];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ah[q] = tf32::round(a[q]);
      al[q] = __float_as_uint(a[q] - __uint_as_float(ah[q]));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (8 * nt + g) * kK + r;
      const uint32_t bh0 = Xh[off], bh1 = Xh[off + 4];
      const uint32_t bl0 = Xl[off], bl1 = Xl[off + 4];
      tf32::mma(big[nt], ah, bh0, bh1);
      tf32::mma(small[nt], al, bh0, bh1);
      tf32::mma(small[nt], ah, bl0, bl1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] += big[nt][q];
}

// Stream-K.  The units of work of a pass are its (column tile, stage)
// pairs, tile after tile: ceil(J / 128) tiles of ceil(R / depth) stages.
// They are cut into `blocks` contiguous runs of nearly equal length; block b
// takes the run [run_begin(b), run_begin(b + 1)).  With at least as many
// blocks as tiles a run covers at most two tiles, and each block writes one
// partial piece (k x 128) per tile it touches.
__host__ __device__ inline long long run_begin(long long b, long long units,
                                               int blocks) {
  return b * units / blocks;
}

// the block whose run holds unit u
__host__ __device__ inline int block_of(long long u, long long units,
                                        int blocks) {
  return static_cast<int>(((u + 1) * blocks + units - 1) / units - 1);
}

// grid (blocks, 1, passes), kBlockThreads threads, Tile::kShared bytes of
// dynamic shared memory.  Block (b, 0, z) computes rows [z pass_rows,
// (z + 1) pass_rows) of its run's products into its pieces: piece q of
// block b is a (k, 128) matrix at partial + (2 b + q) k 128, q = 0 for the
// run's first tile.  Y holds T; X is prepared (rows 16 bytes apart, ldx
// elements of T; a float32 X as two planes of k ldx words).  y_narrow: Y is
// bfloat16 with rows at odd element offsets.  Warps 0-7 multiply, warps
// 8-9 fill the ring.
template <typename T, bool kTrans, int NT>
__global__ void __launch_bounds__(kBlockThreads,
                                  Tile<T, kTrans, NT>::kBlocksPerSm)
    tall_kernel(const T* __restrict__ X, int ldx, const T* __restrict__ Y,
                int ldy, int y_narrow, float* __restrict__ partial, int k,
                int J, int R, int pass_rows) {
  using P = Tile<T, kTrans, NT>;
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kFwdBytes = kTileCols * kE;
  constexpr int S = P::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int spt = (R + P::kDepth - 1) / P::kDepth;   // stages a tile
  const long long units =
      static_cast<long long>((J + kTileCols - 1) / kTileCols) * spt;
  const long long u0 = run_begin(blockIdx.x, units, gridDim.x);
  const long long u1 = run_begin(blockIdx.x + 1, units, gridDim.x);
  const int p0 = blockIdx.z * pass_rows;
  const int p_end = min(k, p0 + pass_rows);
  const char* Yb = reinterpret_cast<const char*>(Y);
  const char* Xb = reinterpret_cast<const char*>(X);
  const size_t ldy_bytes = static_cast<size_t>(ldy) * kE;
  const size_t ldx_bytes = static_cast<size_t>(ldx) * kE;
  const uint32_t base = shared_addr(smem);
  const uint32_t full = base + S * P::kStage;     // S mbarriers, then S more
  const uint32_t empty = full + 8 * S;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(full + 8 * i, kProducers);
      bar_init(empty + 8 * i, kWarps);
    }
  }
  __syncthreads();

  if (warp >= kWarps) {
    // the producers: the run's st-th stage goes to slot st % S once the
    // consumers have released the slot's previous stage
    const int p = tid - kThreads;
    int st = 0;
    for (long long u = u0; u < u1; ++u, ++st) {
      const int slot = st % S;
      if (st >= S) bar_wait(empty + 8 * slot, (st / S - 1) & 1);
      const uint32_t dst = base + slot * P::kStage;
      const int j0 = static_cast<int>(u / spt) * kTileCols;
      const int r0 = static_cast<int>(u % spt) * P::kDepth;
      const int depth_bytes = min(R - r0, P::kDepth) * kE;
      if (kTrans) {
        // 128 rows of Y, the stage's 256 bytes of each
        const char* src = Yb + j0 * ldy_bytes + r0 * kE;
        if (y_narrow) {
          copy_rows_narrow<kStageBytes>(dst, kKStride, src, ldy_bytes,
                                        kTileCols, J - j0, depth_bytes, p);
        } else {
          copy_rows<kStageBytes>(dst, kKStride, src, ldy_bytes, kTileCols,
                                 J - j0, depth_bytes, p);
        }
      } else {
        // the stage's rows of Y, 128 columns of each
        const char* src = Yb + r0 * ldy_bytes + j0 * kE;
        const int col_bytes = min(J - j0, kTileCols) * kE;
        if (y_narrow) {
          copy_rows_narrow<kFwdBytes>(dst, Kind<T>::kFwdStride, src,
                                      ldy_bytes, P::kDepth, R - r0,
                                      col_bytes, p);
        } else {
          copy_rows<kFwdBytes>(dst, Kind<T>::kFwdStride, src, ldy_bytes,
                               P::kDepth, R - r0, col_bytes, p);
        }
      }
      // the pass's rows of X (of each plane), the stage's 256 bytes of each
#pragma unroll
      for (int q = 0; q < Kind<T>::kXTiles; ++q) {
        copy_aligned_rows<kStageBytes>(
            dst + P::kA + q * P::kX, kKStride,
            Xb + q * k * ldx_bytes + p0 * ldx_bytes + r0 * kE, ldx_bytes,
            P::kRows, p_end - p0, depth_bytes, p);
      }
      if (y_narrow) __threadfence_block();   // the stores through registers
      bar_arrive_copies(full + 8 * slot);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // The consumers.  The leads of the rows a lane reads are the same at every
  // stage of every tile: a tile starts 128 rows further down (transposed), a
  // stage 256 bytes further along a row (transposed) or 64 / 128 rows
  // further down (forward), and the rows a lane reads differ by multiples
  // of 8 (16 bytes in any even row stride) or, forward, of 4 float32 rows;
  // forward bfloat16 rows differ by one for the halves of a word, hence two
  // leads
  const int g = lane / 4, t = lane % 4;
  int lead_a0, lead_a1;
  if (kTrans) {
    lead_a0 = lead_a1 = lead_of(Yb + (16 * warp + g) * ldy_bytes);
  } else if (kE == 4) {
    lead_a0 = lead_a1 = lead_of(Yb + t * ldy_bytes);
  } else {
    lead_a0 = lead_of(Yb + 2 * t * ldy_bytes);
    lead_a1 = lead_of(Yb + (2 * t + 1) * ldy_bytes);
  }
  if (y_narrow) lead_a0 = lead_a1 = 0;

  // the running sums; for bfloat16 `err` compensates acc's sum, for float32
  // it sums the small terms of 3xTF32
  float acc[NT][4], err[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = err[nt][q] = 0.f;

  const long long first_tile = u0 / spt;
  int st = 0;
  for (long long u = u0; u < u1; ++u, ++st) {
    const int slot = st % S;
    bar_wait(full + 8 * slot, (st / S) & 1);
    const unsigned char* tile = smem + slot * P::kStage;
    if constexpr (kE == 2) {
      stage_bf16<kTrans, NT>(tile, acc, err, lane, warp, lead_a0, lead_a1);
    } else {
      stage_f32<kTrans, NT>(tile, acc, err, lane, warp, lead_a0);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * slot);
    if (u + 1 < u1 && (u + 1) % spt != 0) continue;

    // the end of the run or of a tile: the accumulator of (output column
    // 16 warp + g (+ 8), output row i (+ 1)) goes to the tile's piece
    // (acc[nt][0] is (j, i), [1] (j, i + 1), [2] (j + 8, i), [3] (j + 8,
    // i + 1))
    float* o = partial + (2 * static_cast<size_t>(blockIdx.x) +
                          (u / spt != first_tile ? 1 : 0)) *
                             k * kTileCols;
    const int j = 16 * warp + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int i = p0 + 8 * nt + 2 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ii = i + q % 2;
        const float v = kE == 4 ? acc[nt][q] + err[nt][q] : acc[nt][q];
        if (ii < p_end) o[static_cast<size_t>(ii) * kTileCols + j + 8 * (q / 2)] = v;
        acc[nt][q] = err[nt][q] = 0.f;
      }
    }
  }
}

template <typename T, bool kTrans, int NT>
inline cudaError_t launch_tall_tile(const T* X, int ldx, const T* Y, int ldy,
                                    float* partial, int k, int J, int R,
                                    int blocks, int passes, int pass_rows,
                                    cudaStream_t stream) {
  using P = Tile<T, kTrans, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      tall_kernel<T, kTrans, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kShared);
  if (err != cudaSuccess) return err;
  // rows of Y that 4-byte aligned copies cannot reach whole: bfloat16 at odd
  // element offsets
  const int y_narrow =
      ((reinterpret_cast<uintptr_t>(Y) | sizeof(T) * static_cast<size_t>(ldy)) &
       3u) != 0;
  tall_kernel<T, kTrans, NT>
      <<<dim3(blocks, 1, passes), kBlockThreads, P::kShared, stream>>>(
          X, ldx, Y, ldy, y_narrow, partial, k, J, R, pass_rows);
  return cudaGetLastError();
}

template <typename T, bool kTrans>
inline cudaError_t launch_tall_typed(const T* X, int ldx, const T* Y, int ldy,
                                     float* partial, int k, int J, int R,
                                     int blocks, cudaStream_t stream) {
  const int passes = (k + kPassRows - 1) / kPassRows;
  const int pass_rows = (k + passes - 1) / passes;
  const int nt = (pass_rows + 7) / 8;
#define TALL(NT)                                                            \
  return launch_tall_tile<T, kTrans, NT>(X, ldx, Y, ldy, partial, k, J, R, \
                                         blocks, passes, pass_rows, stream)
  if (nt <= 1) TALL(1);
  if (nt <= 2) TALL(2);
  if (nt <= 3) TALL(3);
  if (nt <= 4) TALL(4);
  if (nt <= 6) TALL(6);
  if (nt <= 8) TALL(8);
  if (nt <= 12) TALL(12);
  TALL(16);
#undef TALL
}

inline int tall_depth(bool bf16) {
  return bf16 ? Kind<__nv_bfloat16>::kDepth : Kind<float>::kDepth;
}

// the row stride, in elements, of a prepared X of R columns: whole stages
// (256 bytes)
inline int small_ld(int R, bool bf16) {
  const int per = tall_depth(bf16);
  return (R + per - 1) / per * per;
}

// Enqueue one tall product C = X . Y (or X . Y^T with trans) in `blocks`
// runs: its pieces go to `partial` (2 blocks k 128 floats), and
// launch_tall_reduce adds them.  Y holds bfloat16 with bf16, else float32;
// X is prepared for it (launch_prepare; row stride ldx = small_ld(R,
// bf16)).  `blocks` is at least the number of column tiles and at most the
// number of (tile, stage) units (rcppml_tpu_torch/ops/rhs_tall.py::
// plan_tall).
inline cudaError_t launch_tall(const void* X, int ldx, const void* Y, int ldy,
                               bool bf16, bool trans, float* partial, int k,
                               int J, int R, int blocks,
                               cudaStream_t stream) {
  const long long tiles = (J + kTileCols - 1) / kTileCols;
  const long long units = tiles * ((R + tall_depth(bf16) - 1) / tall_depth(bf16));
  if (k <= 0 || J <= 0 || R <= 0 || blocks < tiles || blocks > units ||
      blocks > 2147483647 || ldx < R || ldx % small_ld(1, bf16) != 0 ||
      reinterpret_cast<uintptr_t>(X) % kSmallAlign != 0) {
    return cudaErrorInvalidValue;
  }
  if (bf16) {
    const __nv_bfloat16* Xh = static_cast<const __nv_bfloat16*>(X);
    const __nv_bfloat16* Yh = static_cast<const __nv_bfloat16*>(Y);
    return trans ? launch_tall_typed<__nv_bfloat16, true>(
                       Xh, ldx, Yh, ldy, partial, k, J, R, blocks, stream)
                 : launch_tall_typed<__nv_bfloat16, false>(
                       Xh, ldx, Yh, ldy, partial, k, J, R, blocks, stream);
  }
  const float* Xf = static_cast<const float*>(X);
  const float* Yf = static_cast<const float*>(Y);
  return trans ? launch_tall_typed<float, true>(Xf, ldx, Yf, ldy, partial, k,
                                                J, R, blocks, stream)
               : launch_tall_typed<float, false>(Xf, ldx, Yf, ldy, partial, k,
                                                 J, R, blocks, stream);
}

// raw (k, J) = the sum of the pieces that cover each column tile, in the
// order of their blocks; shifted = raw - shift (raw itself when shift == 0).
// Either output may be null.  grid (column tiles, ceil(k / 8)), 256 threads:
// warp w of block (t, y) sums row 8 y + w of tile t, four columns a lane,
// read as one 16-byte vector from each piece.
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(32 * kReduceRows)
    reduce_pieces_kernel(const float* __restrict__ partial, int blocks, int k,
                         int J, int spt, float shift, float* __restrict__ raw,
                         float* __restrict__ shifted) {
  const int i = blockIdx.y * kReduceRows + threadIdx.x / 32;
  if (i >= k) return;
  const long long tile = blockIdx.x;
  const long long units = static_cast<long long>(gridDim.x) * spt;
  const int first = block_of(tile * spt, units, blocks);
  const int last = block_of((tile + 1) * spt - 1, units, blocks);
  // only the first block's run can begin in an earlier tile (its second
  // piece); every later block's run begins in this one (its first piece)
  const int q = run_begin(first, units, blocks) / spt != tile ? 1 : 0;
  const int c = 4 * (threadIdx.x % 32);
  const float4* p = reinterpret_cast<const float4*>(
      partial + static_cast<size_t>(i) * kTileCols + c);
  const size_t piece = static_cast<size_t>(k) * kTileCols / 4;   // float4s
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float4 v = p[(2 * static_cast<size_t>(first) + q) * piece];
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
#pragma unroll 4
  for (int b = first + 1; b <= last; ++b) {
    const float4 w = p[2 * static_cast<size_t>(b) * piece];
    acc[0] += w.x;
    acc[1] += w.y;
    acc[2] += w.z;
    acc[3] += w.w;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long j = tile * kTileCols + c + e;
    if (j >= J) break;
    const size_t at = static_cast<size_t>(i) * J + static_cast<size_t>(j);
    if (raw != nullptr) raw[at] = acc[e];
    if (shifted != nullptr) {
      shifted[at] = shift != 0.f ? acc[e] - shift : acc[e];
    }
  }
}

// partial: 16-byte aligned (its pieces are read as vectors)
inline cudaError_t launch_tall_reduce(const float* partial, int blocks, int k,
                                      int J, int R, bool bf16, float shift,
                                      float* raw, float* shifted,
                                      cudaStream_t stream) {
  const long long tiles = (J + kTileCols - 1) / kTileCols;
  const long long row_blocks = (k + kReduceRows - 1) / kReduceRows;
  if (k <= 0 || J <= 0 || tiles > 2147483647 || row_blocks > 65535 ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  reduce_pieces_kernel<<<dim3(static_cast<unsigned>(tiles),
                              static_cast<unsigned>(row_blocks)),
                         32 * kReduceRows, 0, stream>>>(
      partial, blocks, k, J, (R + tall_depth(bf16) - 1) / tall_depth(bf16),
      shift, raw, shifted);
  return cudaGetLastError();
}

// P = X (k, R) prepared for the tall product (store_small): row stride ldp,
// a float32 X's low parts k ldp words after its high parts, the columns
// from R to ldp zero.
__global__ void prepare_small_kernel(const float* __restrict__ X, int ldx,
                                     void* __restrict__ P, int ldp, int k,
                                     int R, int bf16) {
  const size_t count = static_cast<size_t>(k) * ldp;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    const size_t i = e / ldp, r = e % ldp;
    store_small(r < static_cast<size_t>(R) ? X[i * ldx + r] : 0.f, P, e,
                count, bf16 != 0);
  }
}

inline cudaError_t launch_prepare(const float* X, int ldx, void* P, int ldp,
                                  int k, int R, bool bf16,
                                  cudaStream_t stream) {
  const int threads = 256;
  size_t blocks = (static_cast<size_t>(k) * ldp + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  prepare_small_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      X, ldx, P, ldp, k, R, bf16 ? 1 : 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. The small product (float32, FMA)
// ---------------------------------------------------------------------------

constexpr int kTX = 16;             // threads along the output columns
constexpr int kTY = 16;             // threads along the output rows
constexpr int kSmallThreads = kTX * kTY;
constexpr int kCPT = 4;             // output columns per thread
constexpr int kBJ = kTX * kCPT;     // output columns per block
constexpr int kRT = 32;             // reduction depth of one shared tile
constexpr int kMaxRows = kTY * 8;   // output rows per pass

// One block's tile: rows i0 + [0, 16 KPT) of X against columns j0 + [0, 64)
// of the output, summed over the reduction range [r_begin, r_end).  Thread
// (tx, ty) owns rows ty + 16 a and columns tx + 16 b.
template <int KPT, bool kTrans>
__device__ __forceinline__ void small_tile(
    const float* __restrict__ X, int ldx, const float* __restrict__ Y,
    int ldy, float* __restrict__ out, int ldo, int i0, int k, int j0, int J,
    int r_begin, int r_end) {
  __shared__ float Xs[kTY * KPT][kRT + 1];
  __shared__ float Ys[kRT][kBJ + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  float acc[KPT][kCPT];
#pragma unroll
  for (int a = 0; a < KPT; ++a)
#pragma unroll
    for (int b = 0; b < kCPT; ++b) acc[a][b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRT) {
    for (int e = tid; e < kTY * KPT * kRT; e += kSmallThreads) {
      const int i = e / kRT, r = e % kRT;
      const int gi = i0 + i, gr = r0 + r;
      Xs[i][r] = gi < k && gr < r_end ? X[static_cast<size_t>(gi) * ldx + gr]
                                      : 0.f;
    }
    for (int e = tid; e < kRT * kBJ; e += kSmallThreads) {
      // neighbouring threads read neighbouring addresses of Y either way
      const int r = kTrans ? e % kRT : e / kBJ;
      const int j = kTrans ? e / kRT : e % kBJ;
      const int gr = r0 + r, gj = j0 + j;
      float v = 0.f;
      if (gr < r_end && gj < J) {
        v = kTrans ? Y[static_cast<size_t>(gj) * ldy + gr]
                   : Y[static_cast<size_t>(gr) * ldy + gj];
      }
      Ys[r][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      float x[KPT], y[kCPT];
#pragma unroll
      for (int a = 0; a < KPT; ++a) x[a] = Xs[ty + kTY * a][r];
#pragma unroll
      for (int b = 0; b < kCPT; ++b) y[b] = Ys[r][tx + kTX * b];
#pragma unroll
      for (int a = 0; a < KPT; ++a)
#pragma unroll
        for (int b = 0; b < kCPT; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < KPT; ++a) {
    const int gi = i0 + ty + kTY * a;
#pragma unroll
    for (int b = 0; b < kCPT; ++b) {
      const int gj = j0 + tx + kTX * b;
      if (gi < k && gj < J) out[static_cast<size_t>(gi) * ldo + gj] = acc[a][b];
    }
  }
}

// grid (column tiles, splits, row passes); split s sums the reduction range
// [s chunk, (s + 1) chunk) and writes partial s, a (k, J) matrix at
// out + s k J.
template <int KPT, bool kTrans>
__global__ void __launch_bounds__(kSmallThreads)
    small_kernel(const float* __restrict__ X, int ldx,
                 const float* __restrict__ Y, int ldy, float* __restrict__ out,
                 int k, int J, int R, int chunk) {
  const int s = blockIdx.y;
  const int r_begin = s * chunk;
  const int r_end = min(R, r_begin + chunk);
  small_tile<KPT, kTrans>(X, ldx, Y, ldy, out + static_cast<size_t>(s) * k * J,
                          J, blockIdx.z * kTY * KPT, k, blockIdx.x * kBJ, J,
                          r_begin, r_end);
}

template <bool kTrans>
inline cudaError_t launch_small_rows(const float* X, int ldx, const float* Y,
                                     int ldy, float* out, int k, int J, int R,
                                     int splits, int chunk,
                                     cudaStream_t stream) {
  const int rows = k < kMaxRows ? k : kMaxRows;
  const int kpt =
      rows <= kTY ? 1 : rows <= 2 * kTY ? 2 : rows <= 4 * kTY ? 4 : 8;
  const dim3 grid((J + kBJ - 1) / kBJ, splits,
                  (k + kTY * kpt - 1) / (kTY * kpt));
  switch (kpt) {
    case 1:
      small_kernel<1, kTrans><<<grid, kSmallThreads, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    case 2:
      small_kernel<2, kTrans><<<grid, kSmallThreads, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    case 4:
      small_kernel<4, kTrans><<<grid, kSmallThreads, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    default:
      small_kernel<8, kTrans><<<grid, kSmallThreads, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
  }
  return cudaGetLastError();
}

// Enqueue one small product: partial s of C = X . Y (or X . Y^T) goes to
// out + s k J.  The caller chooses the split (splits * chunk >= R, chunk a
// multiple of kRT) and reduces the partials.
inline cudaError_t launch_small(const float* X, int ldx, const float* Y,
                                int ldy, bool trans, float* out, int k, int J,
                                int R, int splits, int chunk,
                                cudaStream_t stream) {
  if (k <= 0 || J <= 0 || R <= 0 || splits <= 0 || splits > 65535 ||
      chunk <= 0 || chunk % kRT != 0 ||
      static_cast<long long>(splits) * chunk < R) {
    return cudaErrorInvalidValue;
  }
  return trans ? launch_small_rows<true>(X, ldx, Y, ldy, out, k, J, R, splits,
                                         chunk, stream)
               : launch_small_rows<false>(X, ldx, Y, ldy, out, k, J, R, splits,
                                          chunk, stream);
}

}  // namespace rhs_tall
