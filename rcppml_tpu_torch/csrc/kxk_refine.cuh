// The k x k section of fused_als.cu (kernel 3): the Gram's ridge, the seed
// or warm start of its inverse, the rescale and the Newton-Schulz steps, for
// sm_90a.
//
//   G = sum of the Gram partials + ridge I (+ l2 I);  X = warm start, or
//   G^T / (|G|_1 |G|_inf);  X *= 1 / sqrt(|G X|_1 |G X|_inf);
//   ns_steps times: T = 2 I - G X;  X = X T.
//
// The products are on the tensor cores in 3xTF32 (mma.sync m16n8k8, each
// operand split into a TF32 high part and its remainder, three products,
// tf32.cuh); a tile sums the products of four k8 steps in the tensor cores
// before adding them to a float32 accumulator.  The matrices are held in
// rows of ld = k rounded up to 8, plus 4, floats (the A fragments' reads hit
// 32 banks), zero beyond k, so a tile needs no bounds inside its loop.
//
// Where the matrices live (refine_plan in rcppml_tpu_torch/ops/fused_als.py,
// a function of k alone; up to k = 128 kxk_block.cuh runs instead):
//  * a thread-block cluster of 2 or 4 blocks (k <= 256): block r of the
//    cluster holds rows [r R, (r + 1) R) of G, X and T in its shared memory
//    and computes those rows of every product, reading the B operand's rows
//    from the other blocks through distributed shared memory; a cluster
//    barrier ends every product;
//  * beyond, one block of 512 threads with four k x k matrices in a
//    device-memory scratch.
// X = X T runs in place: a warp keeps its (at most eight) output tiles in
// registers until every warp of the block has read its rows of X (in shared
// memory), or, in device memory, goes to the fourth matrix.  A tile is
// 16 x 8 (one mma), so that many warps share a product, and a warp computes
// two tiles at once, so that the latency of one tile's chain of loads and
// products hides behind the other's.
//
// Sums across blocks (column sums of |M|, the trace) are partials of each
// block's rows added in the order of the blocks; every other sum runs in a
// fixed order too.  No atomics: the same bits every run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "tf32.cuh"

namespace kxk {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kMaxRanks = 4;
constexpr int kHeld = 8;          // output tiles a warp holds for X = X T
constexpr int kRed = 64;          // floats of the small reductions

struct Shape {
  int k, kp, ld, R, C, rank;
  int rows;        // of this block's R rows, those below k
};

// the B operand of a product: its R rows a block, as the blocks of the
// cluster (or the one block) hold them: generic pointers (device memory) and
// shared::cluster addresses (shared memory)
struct Ranks {
  const float* at[kMaxRanks];
  uint32_t sa[kMaxRanks];   // shared::cluster, but this block's shared::cta
  int own;                  // this block's rank
};

// Loads through the state space the compiler cannot see behind a pointer
// chosen at run time: a generic load of shared memory, and one through a
// pointer into another block's shared memory, cost several times a
// ld.shared.  kSmem: the matrices are in shared memory.
template <bool kSmem>
__device__ __forceinline__ float load_local(const float* p) {
  if constexpr (kSmem) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
    return v;
  } else {
    return *p;
  }
}

template <bool kSmem>
__device__ __forceinline__ float load_rank(const Ranks& B, int r, int off) {
  if constexpr (kSmem) {
    float v;
    if (r != B.own) {
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(B.sa[r] + 4u * off));
    } else {
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(B.sa[r] + 4u * off));
    }
    return v;
  } else {
    return B.at[r][off];
  }
}

__device__ __forceinline__ uint32_t shared_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of p (in this block's shared memory) in the
// shared memory of block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return a;
}

// sum of P[z stride + at] over z < splits in the order of z, the loads of
// up to 16 partials issued before their sum
__device__ __forceinline__ float sum_partials(const float* __restrict__ P,
                                              size_t stride, size_t at,
                                              int splits) {
  constexpr int kBatch = 16;
  float acc = 0.f;
  for (int z0 = 0; z0 < splits; z0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      v[q] = z0 + q < splits ? P[(z0 + q) * stride + at] : 0.f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (z0 + q < splits) acc += v[q];
  }
  return acc;
}

__device__ __forceinline__ void sync_all(const Shape& s) {
  if (s.C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Out tiles (16 rows from row0[u] of the local A, 8 columns from col0[u])
// of A . B into acc[u] (mma's C layout: lane (g, t) holds rows g and g + 8,
// columns 2 t and 2 t + 1), kUnits tiles at once so that their chains of
// products overlap.  The reduction runs rank by rank (a k8 step never spans
// two ranks: R is a multiple of 16), two k8 steps at a time: their operands
// are loaded first, together (a load from shared memory, or from another
// block's, is not ready for about a hundred cycles), then their products
// are summed in the tensor cores, the three products of a step into three
// sums; every fourth step the sums go to acc.
template <bool kSmem, int kUnits>
__device__ __forceinline__ void product_tiles(const float* A, const Ranks& B,
                                              const Shape& s,
                                              const int (&row0)[kUnits],
                                              const int (&col0)[kUnits],
                                              float (&acc)[kUnits][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float part[kUnits][3][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[u][q] = 0.f;
      part[u][0][q] = part[u][1][q] = part[u][2][q] = 0.f;
    }
  const int ld8 = 8 * s.ld, ld4 = 4 * s.ld;
  int step = 0;
  for (int r = 0; r < s.C; ++r) {
    const int l0 = r * s.R, l1 = min(s.kp, l0 + s.R);
    for (int lc = l0; lc < l1; lc += 16) {
      const int n = min(2, (l1 - lc) / 8);
      float av[2][kUnits][4], bx[2][kUnits][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= n) break;
        const int l = lc + 8 * i;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const float* a = A + (row0[u] + g) * s.ld + t + l;
          const int b = (l - l0 + t) * s.ld + col0[u] + g;
          av[i][u][0] = load_local<kSmem>(a);
          av[i][u][1] = load_local<kSmem>(a + ld8);
          av[i][u][2] = load_local<kSmem>(a + 4);
          av[i][u][3] = load_local<kSmem>(a + ld8 + 4);
          bx[i][u][0] = load_rank<kSmem>(B, r, b);
          bx[i][u][1] = load_rank<kSmem>(B, r, b + ld4);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= n) break;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ah[q] = tf32::round(av[i][u][q]);
            al[q] = __float_as_uint(av[i][u][q] - __uint_as_float(ah[q]));
          }
          const uint32_t bh0 = tf32::round(bx[i][u][0]);
          const uint32_t bh1 = tf32::round(bx[i][u][1]);
          const uint32_t bl0 = tf32::low(bx[i][u][0], bh0);
          const uint32_t bl1 = tf32::low(bx[i][u][1], bh1);
          tf32::mma(part[u][0], al, bh0, bh1);
          tf32::mma(part[u][1], ah, bl0, bl1);
          tf32::mma(part[u][2], ah, bh0, bh1);
        }
        if (++step % 4 == 0) {
#pragma unroll
          for (int u = 0; u < kUnits; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[u][q] += (part[u][0][q] + part[u][1][q]) + part[u][2][q];
              part[u][0][q] = part[u][1][q] = part[u][2][q] = 0.f;
            }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[u][q] += (part[u][0][q] + part[u][1][q]) + part[u][2][q];
}

// the tile's entries below k into Out (local rows), or 2 I - them
__device__ __forceinline__ void store_tile(float* Out, const Shape& s,
                                           int row0, int col0,
                                           const float (&acc)[4],
                                           bool two_i_minus) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int lr = row0 + g + 8 * (q / 2);
    const int gi = s.rank * s.R + lr;
    const int col = col0 + 2 * t + q % 2;
    if (gi >= s.k || col >= s.k) continue;
    float v = acc[q];
    if (two_i_minus) v = (gi == col ? 2.f : 0.f) - v;
    Out[lr * s.ld + col] = v;
  }
}

// Out = A . B (or 2 I - A . B) for this block's rows, 16 x 8 tiles, two a
// warp at a time; Out may be A itself with kInPlace (a warp holds at most
// kHeld tiles, refine_plan sees to it).  Ends with a barrier of the block
// (cluster).
template <bool kSmem, bool kInPlace>
__device__ void product(const float* A, const Ranks& B, float* Out,
                        const Shape& s, bool two_i_minus) {
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int cols = s.kp / 8;
  const int units = (s.rows + 15) / 16 * cols;
  // tiles u and u + warps (the second one past the end repeats the first)
  auto pair = [&](int u, float (&acc)[2][4]) {
    const int v = u + warps < units ? u + warps : u;
    const int row0[2] = {16 * (u / cols), 16 * (v / cols)};
    const int col0[2] = {8 * (u % cols), 8 * (v % cols)};
    product_tiles<kSmem, 2>(A, B, s, row0, col0, acc);
  };
  auto store = [&](int u, const float (&acc)[4]) {
    store_tile(Out, s, 16 * (u / cols), 8 * (u % cols), acc, two_i_minus);
  };
  if constexpr (kInPlace) {
    float held[kHeld / 2][2][4];
#pragma unroll
    for (int h = 0; h < kHeld / 2; ++h)
      if (warp + 2 * h * warps < units) pair(warp + 2 * h * warps, held[h]);
    __syncthreads();   // every warp has read its rows of A
#pragma unroll
    for (int h = 0; h < kHeld / 2; ++h) {
      const int u = warp + 2 * h * warps;
      if (u < units) store(u, held[h][0]);
      if (u + warps < units) store(u + warps, held[h][1]);
    }
  } else {
    for (int u = warp; u < units; u += 2 * warps) {
      float acc[2][4];
      pair(u, acc);
      store(u, acc[0]);
      if (u + warps < units) store(u + warps, acc[1]);
    }
  }
  sync_all(s);
}

// the largest of v over the block (every thread gets it); red holds 32
// floats
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < warps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// |M|_1 |M|_inf of the k x k matrix whose rows the blocks hold (M local):
// the largest column sum times the largest row sum of |M|.  colsum holds kp
// floats, red kRed; every thread gets the result.
template <bool kSmem>
__device__ float norm_product(const float* M, const Shape& s, float* colsum,
                              float* red) {
  for (int j = threadIdx.x; j < s.k; j += blockDim.x) {
    float c = 0.f;
#pragma unroll 8
    for (int i = 0; i < s.rows; ++i)
      c += fabsf(load_local<kSmem>(M + i * s.ld + j));
    colsum[j] = c;
  }
  float rmax = 0.f;
  for (int i = threadIdx.x; i < s.rows; i += blockDim.x) {
    float r = 0.f;
#pragma unroll 8
    for (int j = 0; j < s.k; ++j)
      r += fabsf(load_local<kSmem>(M + i * s.ld + j));
    rmax = fmaxf(rmax, r);
  }
  rmax = block_max(rmax, red);
  if (threadIdx.x == 0) red[32] = rmax;
  sync_all(s);
  float n1 = 0.f;
  for (int j = threadIdx.x; j < s.k; j += blockDim.x) {
    float c = 0.f;
    for (int r = 0; r < s.C; ++r)
      c += s.C > 1 ? *cg::this_cluster().map_shared_rank(colsum + j, r)
                   : colsum[j];
    n1 = fmaxf(n1, c);
  }
  n1 = block_max(n1, red);
  float ninf = 0.f;
  for (int r = 0; r < s.C; ++r)
    ninf = fmaxf(ninf, s.C > 1 ? *cg::this_cluster().map_shared_rank(
                                     red + 32, r)
                               : red[32]);
  sync_all(s);   // no block overwrites colsum or red while another reads
  return n1 * ninf;
}

// One block, or one cluster of C blocks (blockDim.x threads each).  G = sum
// of the Gram partials P (splits, k, k; read at (min, max), so a partial may
// hold one triangle) in index order; the ridge (ridge_scale tr(G)) and l2 go
// on the diagonal; the inverse is refined from the warm start in `ginv` (or,
// with seed != 0, from G^T / (|G|_1 |G|_inf)) and written back to `ginv`.
// With g_free != null the ridge goes on first, that Gram (free of l2) is
// written to g_free for the loss, and l2 is added after.  Rows per block R
// (a multiple of 16), row stride ld; scratch: null (the matrices in shared
// memory) or four R x ld matrices in device memory (C = 1).
template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
    refine_kernel(const float* __restrict__ P, int splits, int k, int R,
                  float ridge_scale, float l2, int seed,
                  float* __restrict__ ginv, float* __restrict__ g_free,
                  int ns_steps, float* scratch) {
  extern __shared__ __align__(16) float shared[];
  cg::cluster_group cluster = cg::this_cluster();
  Shape s;
  s.k = k;
  s.kp = (k + 7) / 8 * 8;
  s.ld = s.kp + 4;
  s.R = R;
  s.C = static_cast<int>(cluster.num_blocks());
  s.rank = static_cast<int>(cluster.block_rank());
  s.rows = max(0, min(R, k - s.rank * R));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int mat = R * s.ld;
  float* G = scratch != nullptr ? scratch : shared;
  float* X = G + mat;
  float* T = X + mat;
  float* U = scratch != nullptr ? T + mat : nullptr;
  float* colsum = scratch != nullptr ? shared : T + mat;
  float* red = colsum + s.kp;
  const int row0 = s.rank * R;
  const size_t kk = static_cast<size_t>(k) * k;

  Ranks rG, rX, rT;
  for (int r = 0; r < s.C; ++r) {
    rG.at[r] = s.C > 1 ? cluster.map_shared_rank(G, r) : G;
    rX.at[r] = s.C > 1 ? cluster.map_shared_rank(X, r) : X;
    rT.at[r] = s.C > 1 ? cluster.map_shared_rank(T, r) : T;
    if constexpr (kSmem) {
      // a read of this block's own rows goes through ld.shared: through the
      // cluster's window it is several times slower
      rX.sa[r] = r != s.rank ? cluster_addr(X, r) : shared_addr(X);
      rT.sa[r] = r != s.rank ? cluster_addr(T, r) : shared_addr(T);
    }
  }
  rX.own = rT.own = s.rank;

  // G from the partials, every matrix zero beyond k
  for (int e = tid; e < (U != nullptr ? 4 : 3) * mat; e += nthreads)
    G[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < s.rows * k; e += nthreads) {
    const int i = row0 + e / k, j = e % k;
    G[(e / k) * s.ld + j] = sum_partials(
        P, kk, static_cast<size_t>(min(i, j)) * k + max(i, j), splits);
  }
  __syncthreads();
  if (tid == 0) {
    float tr = 0.f;
    for (int i = 0; i < s.rows; ++i) tr += G[i * s.ld + row0 + i];
    red[33] = tr;
  }
  sync_all(s);
  float trace = 0.f;
  for (int r = 0; r < s.C; ++r)
    trace += s.C > 1 ? *cluster.map_shared_rank(red + 33, r) : red[33];
  const float ridge = ridge_scale * trace;
  for (int i = tid; i < s.rows; i += nthreads)
    G[i * s.ld + row0 + i] += g_free != nullptr ? ridge : ridge + l2;
  __syncthreads();
  if (g_free != nullptr) {
    for (int e = tid; e < s.rows * k; e += nthreads)
      g_free[static_cast<size_t>(row0) * k + e] = G[(e / k) * s.ld + e % k];
    __syncthreads();
    if (l2 != 0.f)
      for (int i = tid; i < s.rows; i += nthreads) G[i * s.ld + row0 + i] += l2;
  }
  sync_all(s);   // G is final everywhere (the seed reads its columns)

  if (seed) {
    const float nn = norm_product<kSmem>(G, s, colsum, red);
    for (int e = tid; e < s.rows * k; e += nthreads) {
      const int i = row0 + e / k, j = e % k;
      X[(e / k) * s.ld + j] = rG.at[j / R][(j % R) * s.ld + i] / nn;
    }
  } else {
    for (int e = tid; e < s.rows * k; e += nthreads)
      X[(e / k) * s.ld + e % k] = ginv[static_cast<size_t>(row0) * k + e];
  }
  sync_all(s);

  // rescale so that the iteration contracts whatever the warm start
  product<kSmem, false>(G, rX, T, s, false);            // T = G X
  const float alpha = 1.f / sqrtf(norm_product<kSmem>(T, s, colsum, red));
  for (int e = tid; e < s.rows * k; e += nthreads)
    X[(e / k) * s.ld + e % k] *= alpha;
  sync_all(s);
  for (int step = 0; step < ns_steps; ++step) {
    product<kSmem, false>(G, rX, T, s, true);           // T = 2 I - G X
    if (U == nullptr) {
      product<kSmem, true>(X, rT, X, s, false);         // X = X T
    } else {
      product<kSmem, false>(X, rT, U, s, false);        // U = X T
      float* swap = X;
      X = U;
      U = swap;
      rX.at[0] = X;
    }
  }
  for (int e = tid; e < s.rows * k; e += nthreads)
    ginv[static_cast<size_t>(row0) * k + e] = X[(e / k) * s.ld + e % k];
}

// floats of shared memory a block takes: G, X and T (none with a scratch),
// the column sums and the small reductions
inline size_t shared_floats(int k, int R, bool in_scratch) {
  const int kp = (k + 7) / 8 * 8;
  return (in_scratch ? 0 : static_cast<size_t>(3) * R * (kp + 4)) + kp + kRed;
}

// Enqueue one refine: `ranks` blocks in a cluster (1, 2 or 4) of `threads`
// threads, R rows each; scratch as refine_kernel takes it.
inline cudaError_t launch(const float* P, int splits, int k, int ranks, int R,
                          int threads, float ridge_scale, float l2, int seed,
                          float* ginv, float* g_free, int ns_steps,
                          float* scratch, cudaStream_t stream) {
  // a cluster with its matrices in shared memory, or one block with them in
  // the device-memory scratch (one block in shared memory is kxk_block.cuh)
  if (ranks < 1 || ranks > kMaxRanks || (ranks > 1) == (scratch != nullptr) ||
      R % 16 != 0 || static_cast<long long>(R) * ranks < k || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * shared_floats(k, R, scratch != nullptr);
  auto kernel =
      scratch != nullptr ? refine_kernel<false> : refine_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return launch::clustered(kernel, dim3(ranks), dim3(threads), smem, stream,
                           ranks, P, splits, k, R, ridge_scale, l2, seed,
                           ginv, g_free, ns_steps, scratch);
}

}  // namespace kxk
