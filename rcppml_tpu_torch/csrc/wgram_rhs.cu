// Fused IRLS weight + per-column weighted Gram + RHS, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::weighted_gram_rhs_padded
// (body _make_wgram_kernel, wrappers weighted_gram_rhs_pallas and
// wgram_pad_operands).  For F (k, m), X (k, bc), A (m, bc) and an optional
// theta per row (m,) or per column (bc,), all float32 row-major:
//
//   mu[r, j] = sum_c F[c, r] * X[c, j]
//   w[r, j]  = kl:    1 / max(mu, 1e-4)
//              power: min(max(mu, 1e-15)^(-p), w_cap)
//              nb:    min(t / (mc * (t + mc)), w_cap),  t = max(theta, 1e-10),
//                                                       mc = max(mu, 1e-15)
//              and 1 where A[r, j] == 0 when sparse_zeros is set
//   Gb[j, k1, k2] = sum_r F[k1, r] * F[k2, r] * w[r, j]
//   b[k1, j]      = sum_r F[k1, r] * w[r, j] * A[r, j]
//
// which is compute_irls_weight followed by weighted_gram_and_rhs of the plain
// twin (rcppml_tpu_torch/ops/wgram.py::weighted_gram_rhs_plain).  mu, w and
// w * A exist only in shared memory and registers: they never reach device
// memory, which is the point of the TPU kernel.
//
// What does not carry over: the TPU kernel's bf16 operands, its Khatri-Rao
// operand KR (k^2, m) and the padding of every operand to (8, 128) tiles.
//
// Design: kernel 5's tile (tri_gram.cuh, shared with weighted_gram.cu) with
// the weight formed in a prologue of every stage instead of copied: one
// triangle of every Gram on the tensor cores in 3xTF32, F's rows staged once
// a stage and reused for every column of the block, the reduction over m
// split across blocks where the card would otherwise be idle
// (rcppml_tpu_torch/ops/weighted_gram.py::plan_weighted_gram), the splits'
// partials added in the order of their index.  No atomics: the same inputs
// give the same bits.  mu is summed in float32 over c in order, from F's k
// rows staged with the stage (tri_gram::kFusedStaged) or, for a k whose rows
// do not fit shared memory, read from device memory (kFusedGlobal).
//
// Bound on the H100: float32 operations, 2 m bc (k (k + 1) / 2 + 2k) of them
// (mu, the distinct entries of a symmetric Gram, b) against one read of A;
// the Gram's and b's products run on the tensor cores as three TF32
// products each.

#include <cuda_runtime.h>

#include "tri_gram.cuh"

namespace {

using namespace tri_gram;

template <int kWc, int kMode, int kJ>
cudaError_t launch_tile(const float* F, const float* A, float* G, float* b,
                        int k, int m, int bc, int splits, int chunk,
                        const Fused& fz, cudaStream_t stream) {
  constexpr int kWt = kWarps / kWc;
  const size_t smem = shared_bytes(kWc, kMode, k);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<kWc, kMode, kJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int pairs = (bc + 1) / 2;
  const dim3 grid((triangle_units(k) + kWt - 1) / kWt,
                  (pairs + kWc - 1) / kWc, splits);
  tile_kernel<kWc, kMode, kJ><<<grid, kThreads, smem, stream>>>(
      F, nullptr, A, G, b, k, m, bc, 0, bc, chunk, fz);
  return cudaGetLastError();
}

// up to k = 16 a unit holds two J tiles (kJ = 2), beyond up to four
template <int kWc, int kMode>
cudaError_t launch_k(const float* F, const float* A, float* G, float* b,
                     int k, int m, int bc, int splits, int chunk,
                     const Fused& fz, cudaStream_t s) {
  if (k <= kRowsI)
    return launch_tile<kWc, kMode, 2>(F, A, G, b, k, m, bc, splits, chunk,
                                      fz, s);
  return launch_tile<kWc, kMode, kGroup>(F, A, G, b, k, m, bc, splits, chunk,
                                         fz, s);
}

template <int kMode>
cudaError_t launch_mode(int wc, const float* F, const float* A, float* G,
                        float* b, int k, int m, int bc, int splits, int chunk,
                        const Fused& fz, cudaStream_t s) {
  switch (wc) {
    case 2:
      return launch_k<2, kMode>(F, A, G, b, k, m, bc, splits, chunk, fz, s);
    case 4:
      return launch_k<4, kMode>(F, A, G, b, k, m, bc, splits, chunk, fz, s);
    case 8:
      return launch_k<8, kMode>(F, A, G, b, k, m, bc, splits, chunk, fz, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// F (k, m), X (k, bc), A (m, bc), theta (m,) | (bc,) | null -> Gb (bc, k, k),
// b (k, bc); all float32, contiguous, on the current device.  loss_kind: 0 kl,
// 1 power (exponent `power`), 2 nb.  theta_mode: 0 none, 1 per row of A,
// 2 per column of A.  The plan (rcppml_tpu_torch/ops/wgram.py::plan_wgram):
// mode 1 (F's rows staged) or 2 (read from device memory), wc column pairs a
// block (2, 4 or 8), the reduction over m in `splits` ranges of `chunk` rows
// (a multiple of 32); with splits > 1, `scratch` holds splits (bc k k + k bc)
// floats for the partials.  Returns the cudaError_t of the first launch that
// failed (0 on success).
extern "C" int wgram_rhs_launch(const float* F, const float* X, const float* A,
                                const float* theta, float* Gb, float* b, int k,
                                int m, int bc, int loss_kind, float power,
                                int sparse_zeros, int theta_mode, float w_cap,
                                int mode, int wc, int splits, int chunk,
                                float* scratch, void* stream) {
  if (k <= 0 || m <= 0 || bc <= 0 || splits <= 0 || splits > 65535 ||
      chunk <= 0 || chunk % kDepth != 0 ||
      static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (loss_kind < kKl || loss_kind > kNb)
    return static_cast<int>(cudaErrorInvalidValue);
  if (theta_mode < kThetaNone || theta_mode > kThetaCol ||
      (theta_mode != kThetaNone && theta == nullptr) ||
      (loss_kind == kNb && theta_mode == kThetaNone))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Fused fz{X, theta, loss_kind, sparse_zeros, theta_mode, power, w_cap};
  const size_t n_g = static_cast<size_t>(bc) * k * k;
  float* G = splits > 1 ? scratch : Gb;
  float* bp = splits > 1 ? scratch + splits * n_g : b;
  cudaError_t err;
  if (mode == kFusedStaged) {
    err = launch_mode<kFusedStaged>(wc, F, A, G, bp, k, m, bc, splits, chunk,
                                    fz, s);
  } else if (mode == kFusedGlobal) {
    err = launch_mode<kFusedGlobal>(wc, F, A, G, bp, k, m, bc, splits, chunk,
                                    fz, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = n_g + static_cast<size_t>(k) * bc;
  const size_t blocks = (total + 255) / 256;
  reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                  0, s>>>(scratch, bp, Gb, b, k, bc, splits);
  return static_cast<int>(cudaGetLastError());
}
