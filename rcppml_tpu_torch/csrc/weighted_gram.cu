// Per-column weighted Gram + RHS from given weights, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_experiments.py::weighted_gram_pallas.
// For F (k, m), w (m, bc) and A (m, bc), all float32:
//
//   Gb[j, k1, k2] = sum_r w[r, j] * F[k1, r] * F[k2, r]
//   b[k1, j]      = sum_r F[k1, r] * w[r, j] * A[r, j]
//
// which is the blocked branch of linalg.weighted_gram_and_rhs (the plain twin,
// rcppml_tpu_torch/ops/weighted_gram.py::weighted_gram_plain) without its
// (bc, k, m) intermediate F * w_j: that intermediate, k times the size of the
// data block, is what the TPU kernel exists to avoid, and here it never
// leaves shared memory and registers.
//
// What does not carry over: the TPU kernel's padding of m and bc to its tiles
// and its transposed (n, m) feed of w and A, both rules of the TPU's layouts.
// This kernel reads w and A as they lie, (m, bc) row-major with any row stride
// (a block of columns of a wider matrix is read in place), and masks its own
// ragged edges.
//
// Design.  The TPU grid's sequential m dimension becomes a loop over m-tiles
// inside the block (wgram_tile.cuh, shared with wgram_rhs.cu): every output is
// summed by one thread in one fixed order, so there are no atomics and the
// same inputs give the same bits.  w and A are row-major in j, so a warp
// stages a row of 32 columns with one coalesced load; a (32 rows x 32 columns)
// tile of w and of w * A sits in shared memory beside the transposed F tile.
// Only the blocks that carry b (blockIdx.z == 0) read A.
//
// Bound on the H100: float32 multiply-adds outside the tensor cores,
// 2 * m * bc * (k (k + 1) / 2 + k) operations (the distinct entries of a
// symmetric Gram, and b) against one read of w and A and one write of Gb.
// This kernel computes both triangles, 2 * m * bc * (k^2 + k).

#include <cuda_runtime.h>

#include "wgram_tile.cuh"

using namespace wgram_tile;

namespace {

// Shared memory, in floats: Fs[kTileM][fs] (F tile, transposed, zero padded
// to kp columns), Ws[kTileM][kTileJ], WAs[kTileM][kTileJ].
__global__ void __launch_bounds__(kMaxThreads)
weighted_gram_kernel(const float* __restrict__ F, const float* __restrict__ w,
                     const float* __restrict__ A, float* __restrict__ Gb,
                     float* __restrict__ b, int k, int m, int bc, int kp,
                     long long w_ld, long long a_ld) {
  extern __shared__ __align__(16) float smem[];
  float* Fs = smem;
  float* Ws = Fs + kTileM * f_stride(kp);
  float* WAs = Ws + kTileM * kTileJ;

  const Owner o = owner();
  const bool carries_b = blockIdx.z == 0;

  Acc acc;
  clear(acc);

  for (int r0 = 0; r0 < m; r0 += kTileM) {
    __syncthreads();  // the previous step's readers are done
    load_f_tile(F, Fs, k, kp, m, r0, o);
    // w and w * a for the (kTileM, kTileJ) tile, zero beyond m and bc
    for (int idx = o.tid; idx < kTileM * kTileJ; idx += o.nthreads) {
      const int r = idx / kTileJ, jj = idx % kTileJ;
      const long long row = r0 + r;
      const int j = o.j0 + jj;
      float wv = 0.f, wa = 0.f;
      if (row < m && j < bc) {
        wv = w[row * w_ld + j];
        if (carries_b) wa = wv * A[row * a_ld + j];
      }
      Ws[idx] = wv;
      WAs[idx] = wa;
    }
    __syncthreads();
    accumulate_tile(Fs, Ws, WAs, k, kp, o, acc);
  }
  store_tile(Gb, b, k, bc, o, acc);
}

}  // namespace

// F (k, m) contiguous; w and A (m, bc) with unit column stride and row
// strides w_ld and a_ld (in floats) -> Gb (bc, k, k), b (k, bc), contiguous;
// all float32 on the current device.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int weighted_gram_launch(const float* F, const float* w,
                                    const float* A, float* Gb, float* b, int k,
                                    int m, int bc, long long w_ld,
                                    long long a_ld, void* stream) {
  if (k <= 0 || m <= 0 || bc <= 0 || w_ld < bc || a_ld < bc)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = padded_k(k);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kTileM) * f_stride(kp) +
                       2u * kTileM * kTileJ);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_optin))
    return static_cast<int>(cudaErrorInvalidValue);   // k beyond about 1,700
  err = cudaFuncSetAttribute(weighted_gram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  weighted_gram_kernel<<<grid_shape(k, bc, kp), block_shape(kp), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      F, w, A, Gb, b, k, m, bc, kp, w_ld, a_ld);
  return static_cast<int>(cudaGetLastError());
}
