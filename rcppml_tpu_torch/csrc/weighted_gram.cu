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
// leaves registers.
//
// What does not carry over: the TPU kernel's padding of m and bc to its tiles
// and its transposed (n, m) feed of w and A, both rules of the TPU's layouts.
// This kernel reads w and A as they lie, (m, bc) row-major with any row stride
// (a block of columns of a wider matrix is read in place), and masks its own
// ragged edges.
//
// Design (tri_gram.cuh): one triangle of every Gram (k1 <= k2), each entry
// written to both places, on the tensor cores in 3xTF32 (mma.sync m16n8k8),
// F's rows staged once a stage in shared memory and reused for every column
// of the block; the reduction over m split across blocks where the card would
// otherwise be idle, the splits' partials added in index order by a second
// kernel.  The TPU grid's sequential m dimension is the loop over stages
// inside a block.
//
// Bound on the H100: float32 operations, 2 m bc (k (k + 1) / 2 + k) of them
// (the distinct entries of a symmetric Gram, and b), against one read of w
// and A and one write of Gb; on the tensor cores in 3xTF32 three TF32
// products stand for each, so their floor is 3 x 2 m bc (k (k + 1) / 2 + k)
// operations at the TF32 rate.

#include <cuda_runtime.h>

#include "tri_gram.cuh"

namespace {

template <int kWc>
cudaError_t launch_tile(const float* F, const float* w, const float* A,
                        float* G, float* b, int k, int m, int bc,
                        long long w_ld, long long a_ld, int splits, int chunk,
                        cudaStream_t stream) {
  using namespace tri_gram;
  constexpr int kWt = kWarps / kWc;
  const size_t smem = shared_bytes(kWc, kGivenW, k);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<kWc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int pairs = (bc + 1) / 2;
  const dim3 grid((triangle_units(k) + kWt - 1) / kWt,
                  (pairs + kWc - 1) / kWc, splits);
  tile_kernel<kWc><<<grid, kThreads, smem, stream>>>(
      F, w, A, G, b, k, m, bc, w_ld, a_ld, chunk, Fused{});
  return cudaGetLastError();
}

}  // namespace

// F (k, m) contiguous; w and A (m, bc) with unit column stride and row
// strides w_ld and a_ld (in floats) -> Gb (bc, k, k), b (k, bc), contiguous;
// all float32 on the current device.  The plan (rcppml_tpu_torch/ops/
// weighted_gram.py::plan_weighted_gram): wc column pairs a block (2, 4 or
// 8), the reduction over m in `splits` ranges of `chunk` rows (a multiple of
// 32).  With splits > 1, `scratch` holds splits (bc k k + k bc) floats for
// the partials.  Returns the cudaError_t of the first launch that failed (0
// on success).
extern "C" int weighted_gram_launch(const float* F, const float* w,
                                    const float* A, float* Gb, float* b, int k,
                                    int m, int bc, long long w_ld,
                                    long long a_ld, int wc, int splits,
                                    int chunk, float* scratch, void* stream) {
  if (k <= 0 || m <= 0 || bc <= 0 || w_ld < bc || a_ld < bc || splits <= 0 ||
      splits > 65535 || chunk <= 0 || chunk % tri_gram::kDepth != 0 ||
      static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_g = static_cast<size_t>(bc) * k * k;
  float* G = splits > 1 ? scratch : Gb;
  float* bp = splits > 1 ? scratch + splits * n_g : b;
  cudaError_t err;
  switch (wc) {
    case 2:
      err = launch_tile<2>(F, w, A, G, bp, k, m, bc, w_ld, a_ld, splits, chunk,
                           s);
      break;
    case 4:
      err = launch_tile<4>(F, w, A, G, bp, k, m, bc, w_ld, a_ld, splits, chunk,
                           s);
      break;
    case 8:
      err = launch_tile<8>(F, w, A, G, bp, k, m, bc, w_ld, a_ld, splits, chunk,
                           s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = n_g + static_cast<size_t>(k) * bc;
  const size_t blocks = (total + 255) / 256;
  tri_gram::reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                            256, 0, s>>>(scratch, bp, Gb, b, k, bc, splits);
  return static_cast<int>(cudaGetLastError());
}
