// The k x k section of fused_als.cu (kernel 3) for k <= 128, in one block,
// for sm_90a: the same section as kxk_refine.cuh (the Gram's ridge, the seed
// or warm start of its inverse, the rescale and the Newton-Schulz steps), on
// float32 multiply-adds with G, X and T in shared memory.
//
// Products of k^3 this small are bound by each warp's chain of loads and
// dependent instructions, not by arithmetic: the first design (a lane a
// column, a warp two rows) read a word of shared memory for every
// multiply-add instruction, 56 us a refine at k = 50 (45 us here).  Here a
// thread owns a kRI x 4 block of the output (rows r0 + g + 8 i, columns
// c0 + 4 c + j: a warp 8 kRI rows by 16 columns), and a step of the
// reduction reads kRI words of A and one 16-byte vector of B for 4 kRI
// multiply-adds; each entry is still summed over the reduction in order.
// kRI is 1 up to k = 32 (more warps share a small product), 2 up to 64,
// else 4.
// kxk_refine.cuh's tensor-core products measured slower at these k (35 and
// 75 us a refine at k = 20 and 50, tools/torch_fused_variants.py, NVIDIA
// H100), so it serves the cluster and device-memory routes (k > 128) only.

#pragma once

#include <cuda_runtime.h>

#include "kxk_refine.cuh"   // kxk::sum_partials

namespace kxk_block {

constexpr int kMaxThreads = 1024;
constexpr int kRowsPadded = 32;   // rows are allocated in multiples of this
constexpr int kTileCols = 16;     // columns of a warp's output tile

// row stride: at least k, 4 mod 8 (rows on 16 bytes; eight rows apart by a
// multiple of 4 words that is odd in units of 4, so a column of them meets
// eight different groups of banks)
__host__ __device__ inline int row_stride(int k) { return (k + 3) / 8 * 8 + 4; }
__host__ __device__ inline int rows_padded(int k) {
  return (k + kRowsPadded - 1) / kRowsPadded * kRowsPadded;
}
// rows of A a thread owns, and the warps' tiles of a product
__host__ __device__ inline int rows_a_thread(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : 4;
}
__host__ __device__ inline int tiles(int k) {
  const int tile_rows = 8 * rows_a_thread(k);
  return (k + tile_rows - 1) / tile_rows * ((k + kTileCols - 1) / kTileCols);
}

// Out = A . B (or 2 I - A . B) for k x k matrices in shared memory (rows
// past k and columns past k zero), one 8 kRI x 16 tile a warp.  Every warp
// holds its tile until all have read A and B, so Out may be A itself.
template <int kRI>
__device__ __forceinline__ void kxk_product(const float* A, const float* B,
                                            float* Out, int k, int ld,
                                            bool two_i_minus) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane % 8, c = lane / 8;
  const int col_tiles = (k + kTileCols - 1) / kTileCols;
  const bool owns = warp < tiles(k);
  const int r0 = (warp / col_tiles) * 8 * kRI + g;
  const int c0 = (warp % col_tiles) * kTileCols + 4 * c;
  float acc[kRI][4];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (owns) {
    const float* a = A + r0 * ld;
    const float* b = B + c0;
#pragma unroll 4
    for (int l = 0; l < k; ++l) {
      const float4 y = *reinterpret_cast<const float4*>(b + l * ld);
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float x = a[8 * i * ld + l];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x, yv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();   // every warp has read A and B
  if (owns) {
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int row = r0 + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + j;
        if (row < k && col < k) {
          float v = acc[i][j];
          if (two_i_minus) v = (row == col ? 2.f : 0.f) - v;
          Out[row * ld + col] = v;
        }
      }
    }
  }
  __syncthreads();
}

// |M|_1 |M|_inf of a k x k matrix in shared memory: the largest column sum
// times the largest row sum of |M|, a warp a column or row at a time (its
// lanes' shares summed in a fixed tree).  `red` holds 2 x 32 floats.  Every
// thread gets the result.
__device__ inline float norm_product(const float* M, int k, int ld,
                                     float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float n1 = 0.f, ninf = 0.f;
  for (int t = warp; t < 2 * k; t += warps) {
    float s = 0.f;
    if (t < k) {
      for (int i = lane; i < k; i += 32) s += fabsf(M[i * ld + t]);
    } else {
      for (int j = lane; j < k; j += 32) s += fabsf(M[(t - k) * ld + j]);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t < k) {
      n1 = fmaxf(n1, s);
    } else {
      ninf = fmaxf(ninf, s);
    }
  }
  if (lane == 0) {
    red[2 * warp] = n1;
    red[2 * warp + 1] = ninf;
  }
  __syncthreads();
  n1 = ninf = 0.f;
  for (int w = 0; w < warps; ++w) {
    n1 = fmaxf(n1, red[2 * w]);
    ninf = fmaxf(ninf, red[2 * w + 1]);
  }
  __syncthreads();
  return n1 * ninf;
}

// One block.  G = sum of the Gram partials P (splits, k, k) in index order;
// the ridge (ridge_scale tr(G)) and l2 go on the diagonal; the inverse is
// refined from the warm start in `ginv` (or, with seed != 0, from
// G^T / (|G|_1 |G|_inf)) and written back to `ginv`.  With g_free != null the
// ridge goes on first, that Gram (free of l2) is written to g_free for the
// loss, and l2 is added after.  G, X, T and the reductions live in shared
// memory.
template <int kRI>
__global__ void __launch_bounds__(kMaxThreads)
    kxk_refine_kernel(const float* __restrict__ P, int splits, int k,
                      float ridge_scale, float l2, int seed,
                      float* __restrict__ ginv, float* __restrict__ g_free,
                      int ns_steps) {
  extern __shared__ __align__(16) float shared[];
  const int ld = row_stride(k);
  const int mat = rows_padded(k) * ld;
  float* G = shared;
  float* X = G + mat;
  float* T = X + mat;
  float* red = T + mat;   // 2 x 32 floats of reductions
  const int tid = threadIdx.x;
  const int kk = k * k;

  for (int e = tid; e < 3 * mat; e += blockDim.x) G[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < kk; e += blockDim.x)
    G[(e / k) * ld + e % k] = kxk::sum_partials(P, kk, e, splits);
  __syncthreads();
  if (tid < 32) {
    float t = 0.f;
    for (int i = tid; i < k; i += 32) t += G[i * ld + i];
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (tid == 0) red[0] = t;
  }
  __syncthreads();
  const float ridge = ridge_scale * red[0];
  __syncthreads();
  if (tid < k) G[tid * ld + tid] += g_free != nullptr ? ridge : ridge + l2;
  __syncthreads();
  if (g_free != nullptr) {
    for (int e = tid; e < kk; e += blockDim.x)
      g_free[e] = G[(e / k) * ld + e % k];
    if (l2 != 0.f) {
      __syncthreads();
      if (tid < k) G[tid * ld + tid] += l2;
    }
    __syncthreads();
  }

  if (seed) {
    const float nn = norm_product(G, k, ld, red);
    for (int e = tid; e < kk; e += blockDim.x)
      X[(e / k) * ld + e % k] = G[(e % k) * ld + e / k] / nn;
  } else {
    for (int e = tid; e < kk; e += blockDim.x)
      X[(e / k) * ld + e % k] = ginv[e];
  }
  __syncthreads();

  // rescale so that the iteration contracts whatever the warm start
  kxk_product<kRI>(G, X, T, k, ld, false);
  const float alpha = 1.f / sqrtf(norm_product(T, k, ld, red));
  for (int e = tid; e < kk; e += blockDim.x) X[(e / k) * ld + e % k] *= alpha;
  __syncthreads();
  for (int step = 0; step < ns_steps; ++step) {
    kxk_product<kRI>(G, X, T, k, ld, true);    // T = 2 I - G X
    kxk_product<kRI>(X, T, X, k, ld, false);   // X = X T, in place
  }
  for (int e = tid; e < kk; e += blockDim.x) ginv[e] = X[(e / k) * ld + e % k];
}

inline size_t shared_bytes(int k) {
  return (static_cast<size_t>(3) * rows_padded(k) * row_stride(k) + 64) *
         sizeof(float);
}

template <int kRI>
cudaError_t launch_rows(const float* P, int splits, int k, float ridge_scale,
                        float l2, int seed, float* ginv, float* g_free,
                        int ns_steps, cudaStream_t stream) {
  const int warps = tiles(k) < 4 ? 4 : tiles(k);
  const size_t shared = shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      kxk_refine_kernel<kRI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  kxk_refine_kernel<kRI><<<1, 32 * warps, shared, stream>>>(
      P, splits, k, ridge_scale, l2, seed, ginv, g_free, ns_steps);
  return cudaGetLastError();
}

// One refine, k <= 128: a warp an 8 kRI x 16 tile of a product, at least
// four warps.
inline cudaError_t launch(const float* P, int splits, int k, float ridge_scale,
                          float l2, int seed, float* ginv, float* g_free,
                          int ns_steps, cudaStream_t stream) {
  if (k <= 0 || k > 128) return cudaErrorInvalidValue;
  switch (rows_a_thread(k)) {
    case 1:
      return launch_rows<1>(P, splits, k, ridge_scale, l2, seed, ginv,
                            g_free, ns_steps, stream);
    case 2:
      return launch_rows<2>(P, splits, k, ridge_scale, l2, seed, ginv,
                            g_free, ns_steps, stream);
    default:
      return launch_rows<4>(P, splits, k, ridge_scale, l2, seed, ginv,
                            g_free, ns_steps, stream);
  }
}

}  // namespace kxk_block
