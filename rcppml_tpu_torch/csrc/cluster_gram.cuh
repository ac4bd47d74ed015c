// The Grams of fused_als.cu (kernel 3), W W^T and H H^T, for sm_90a:
//
//   out[c] = sum over the rows r of cluster c's share of F[:, r] F[:, r]^T
//
// for F (k, R) row-major, as a few partial Grams that the k x k section and
// the loss add in the order of their index.  A Gram of kernel 3 reads a
// factor of 0.2 to 2 MB and computes little, so what bounds it is latency:
// the first design (rhs_tall.cuh's FMA tile over 32 splits) took 22 us at
// the pbmc3k shape, one load of a 32-row tile after another.  Here each of
// many blocks loads its slab of F (k rows by at most 128 columns) into shared
// memory at once and sums its k (k + 1) / 2 distinct entries in 4 x 4 blocks
// (a thread's block of the Gram over a share of the slab's columns, the
// shares added in a fixed order); the eight blocks of a thread-block cluster
// then add their partials through distributed shared memory, in the order of
// their rank, and write one Gram (both triangles, equal by construction) a
// cluster.  Float32 multiply-adds, as the plain twin's product; no atomics,
// the same bits every run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cluster_gram {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCluster = 8;

__host__ __device__ inline int blocks_of(int k) {
  const int nb = (k + 3) / 4;
  return nb * (nb + 1) / 2;
}

// floats of shared memory: the slab (rows rounded up to 4, odd row stride)
// and the 4 x 4 blocks of every share
__host__ __device__ inline int shared_floats(int k, int chunk) {
  const int nb = blocks_of(k);
  const int shares = nb >= kThreads ? 1 : kThreads / nb;
  return (k + 3) / 4 * 4 * (chunk | 1) + shares * nb * 16;
}

// grid (kCluster * clusters), clusters of kCluster blocks, kThreads threads,
// shared_floats(k, chunk) floats of dynamic shared memory.  Block b sums
// columns [b chunk, min(R, (b + 1) chunk)) of F; cluster c writes out + c k k.
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ F, int k, int R, int chunk,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float shared[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * chunk;
  const int len = max(0, min(R, r0 + chunk) - r0);
  const int ld = chunk | 1;
  const int kp = (k + 3) / 4 * 4;
  const int nb = (k + 3) / 4;
  const int blocks = blocks_of(k);
  const int shares = blocks >= kThreads ? 1 : kThreads / blocks;

  // the slab, zero in the rows past k
  const size_t sR = static_cast<size_t>(R);
#pragma unroll 4
  for (int e = tid; e < kp * len; e += kThreads) {
    const int i = e / len, r = e % len;
    shared[i * ld + r] = i < k ? F[i * sR + r0 + r] : 0.f;
  }
  __syncthreads();

  // thread -> (share q, first 4 x 4 block); the blocks of the upper
  // triangle, row by row: block b is (bi, bj) with bi <= bj.  Share q's
  // block b goes to part + (q blocks + b) 16.
  float* part = shared + kp * ld;
  const int q = tid / blocks;
  const int per = (len + shares - 1) / shares;
  const int c0 = min(len, q * per), c1 = min(len, c0 + per);
  const int step = shares == 1 ? kThreads : blocks;
  for (int b = q < shares ? tid % blocks : blocks; b < blocks; b += step) {
    int bi = 0, rest = b;
    while (rest >= nb - bi) rest -= nb - bi++;
    const float* fi = shared + 4 * bi * ld;
    const float* fj = shared + 4 * (bi + rest) * ld;
    float s[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = 0.f;
    for (int r = c0; r < c1; ++r) {
      float a[4], c[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = fi[x * ld + r];
        c[x] = fj[x * ld + r];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          s[4 * x + y] = fmaf(a[x], c[y], s[4 * x + y]);
    }
#pragma unroll
    for (int x = 0; x < 16; ++x) part[(q * blocks + b) * 16 + x] = s[x];
  }
  __syncthreads();
  // the block's sum of its shares, in share order, into share 0's place
  for (int e = tid; e < blocks * 16; e += kThreads) {
    float v = part[e];
    for (int s = 1; s < shares; ++s) v += part[s * blocks * 16 + e];
    part[e] = v;
  }
  cluster.sync();
  // the cluster's sum, in rank order; rank p writes every kCluster-th entry
  const int rank = static_cast<int>(cluster.block_rank());
  float* o = out + static_cast<size_t>(blockIdx.x / kCluster) * k * k;
  for (int e = rank * kThreads + tid; e < blocks * 16;
       e += kCluster * kThreads) {
    float v = 0.f;
    for (int p = 0; p < kCluster; ++p)
      v += *cluster.map_shared_rank(part + e, p);
    const int b = e / 16, x = (e % 16) / 4, y = e % 4;
    int bi = 0, rest = b;
    while (rest >= nb - bi) rest -= nb - bi++;
    const int i = 4 * bi + x, j = 4 * (bi + rest) + y;
    if (i < k && j < k) {
      o[static_cast<size_t>(i) * k + j] = v;
      o[static_cast<size_t>(j) * k + i] = v;
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

inline cudaError_t launch(const float* F, int k, int R, int clusters,
                          int chunk, float* out, cudaStream_t stream) {
  if (k <= 0 || R <= 0 || clusters <= 0 || chunk <= 0 ||
      static_cast<long long>(clusters) * kCluster * chunk < R)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * shared_floats(k, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return launch::clustered(gram_kernel, dim3(clusters * kCluster),
                           dim3(kThreads), smem, stream, kCluster, F, k, R,
                           chunk, out);
}

}  // namespace cluster_gram
