// The per-column weighted Gram accumulation of wgram_rhs.cu (the fused IRLS
// weight + Gram + RHS, kernel 4), for sm_90a.
//
//   Gb[j, k1, k2] = sum_r F[k1, r] * F[k2, r] * w[r, j]
//   b[k1, j]      = sum_r F[k1, r] * wa[r, j]
//
// A block owns 32 columns j and 8 rows k1 of every column's Gram and loops
// over m in tiles of 32 rows, so every output is summed by one thread in one
// fixed order: no atomics, the same inputs give the same bits.  The caller
// stages, per m-tile, the F tile (transposed, zero padded to kp columns) with
// load_f_tile and its own (kTileM, kTileJ) tiles of w and wa in shared
// memory, then calls accumulate_tile; store_tile writes the results.
//
// A thread (tx, ty, tz) owns column tx, the 8 Gram columns k2 = 8 * ty ..
// 8 * ty + 7 (plus 64 * blockIdx.z: only k > 64 needs a second slab of Gram
// columns) and the 4 Gram rows k1 = 8 * blockIdx.y + 4 * tz .. + 3: 32
// accumulators in registers, fed by four shared-memory loads per m-row (w,
// one float4 of F at k1, two float4 of F at k2).  The threads that own
// k2 = 0 also carry b.

#pragma once

#include <cuda_runtime.h>

namespace wgram_tile {

constexpr int kTileJ = 32;   // columns per block (one warp wide)
constexpr int kTileM = 32;   // rows of A per step of the m loop
constexpr int kRowsPerBlock = 8;
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 8;
// 32 * 8 * 2 = 512 threads at most: at 94 to 100 registers a thread, 1024
// threads would pass the 65,536 registers of an SM and the launch be refused
constexpr int kMaxThreadsY = 8;
constexpr int kMaxThreads =
    kTileJ * kMaxThreadsY * (kRowsPerBlock / kRowsPerThread);

// k rounded up to whole groups of Gram columns
inline int padded_k(int k) {
  return (k + kColsPerThread - 1) / kColsPerThread * kColsPerThread;
}

// row stride of the F tile in shared memory: kp + 4 keeps float4 alignment
__host__ __device__ inline int f_stride(int kp) { return kp + 4; }

inline dim3 block_shape(int kp) {
  const int chunks = kp / kColsPerThread;
  return dim3(kTileJ, chunks < kMaxThreadsY ? chunks : kMaxThreadsY,
              kRowsPerBlock / kRowsPerThread);
}

inline dim3 grid_shape(int k, int bc, int kp) {
  const int chunks = kp / kColsPerThread;
  return dim3((bc + kTileJ - 1) / kTileJ,
              (k + kRowsPerBlock - 1) / kRowsPerBlock,
              (chunks + kMaxThreadsY - 1) / kMaxThreadsY);
}

// What a thread owns, from its indices.
struct Owner {
  int tx, tid, nthreads, j0, k1_0, k2_0;
  bool owns_b;
};

__device__ __forceinline__ Owner owner() {
  Owner o;
  o.tx = threadIdx.x;
  o.nthreads = blockDim.x * blockDim.y * blockDim.z;
  o.tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  o.j0 = blockIdx.x * kTileJ;
  o.k1_0 = blockIdx.y * kRowsPerBlock + threadIdx.z * kRowsPerThread;
  o.k2_0 = (blockIdx.z * kMaxThreadsY + threadIdx.y) * kColsPerThread;
  o.owns_b = o.k2_0 == 0;
  return o;
}

struct Acc {
  float g[kRowsPerThread][kColsPerThread];
  float b[kRowsPerThread];
};

__device__ __forceinline__ void clear(Acc& acc) {
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    acc.b[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc.g[a][c] = 0.f;
  }
}

// F tile: Fs[r][c] = F[c, r0 + r], zero beyond k and beyond m; consecutive
// threads read consecutive r
__device__ __forceinline__ void load_f_tile(const float* __restrict__ F,
                                            float* Fs, int k, int kp, int m,
                                            int r0, const Owner& o) {
  const int fs = f_stride(kp);
  const size_t sm = static_cast<size_t>(m);
  for (int idx = o.tid; idx < kp * kTileM; idx += o.nthreads) {
    const int c = idx / kTileM, r = idx % kTileM;
    Fs[r * fs + c] = (c < k && r0 + r < m) ? F[c * sm + r0 + r] : 0.f;
  }
}

// Add one staged m-tile into the thread's Gram entries (and b).
__device__ __forceinline__ void accumulate_tile(const float* Fs,
                                                const float* Ws,
                                                const float* WAs, int k,
                                                int kp, const Owner& o,
                                                Acc& acc) {
  if (o.k1_0 >= k || o.k2_0 >= k) return;
  const int fs = f_stride(kp);
#pragma unroll 4
  for (int r = 0; r < kTileM; ++r) {
    const float w = Ws[r * kTileJ + o.tx];
    const float4 f1 = *reinterpret_cast<const float4*>(Fs + r * fs + o.k1_0);
    const float4 fa = *reinterpret_cast<const float4*>(Fs + r * fs + o.k2_0);
    const float4 fb =
        *reinterpret_cast<const float4*>(Fs + r * fs + o.k2_0 + 4);
    const float f1v[kRowsPerThread] = {f1.x, f1.y, f1.z, f1.w};
    const float f2v[kColsPerThread] = {fa.x, fa.y, fa.z, fa.w,
                                       fb.x, fb.y, fb.z, fb.w};
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) {
      const float fw = f1v[a] * w;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        acc.g[a][c] = fmaf(fw, f2v[c], acc.g[a][c]);
    }
    if (o.owns_b) {
      const float wa = WAs[r * kTileJ + o.tx];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
        acc.b[a] = fmaf(f1v[a], wa, acc.b[a]);
    }
  }
}

// Gb (bc, k, k) and b (k, bc), row-major: both triangles of every Gram.
__device__ __forceinline__ void store_tile(float* __restrict__ Gb,
                                           float* __restrict__ b, int k,
                                           int bc, const Owner& o,
                                           const Acc& acc) {
  const int j = o.j0 + o.tx;
  if (j >= bc) return;
  const size_t sk = static_cast<size_t>(k);
  const size_t sbc = static_cast<size_t>(bc);
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int k1 = o.k1_0 + a;
    if (k1 >= k) continue;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int k2 = o.k2_0 + c;
      if (k2 < k) Gb[(j * sk + k1) * sk + k2] = acc.g[a][c];
    }
    if (o.owns_b) b[k1 * sbc + j] = acc.b[a];
  }
}

}  // namespace wgram_tile
