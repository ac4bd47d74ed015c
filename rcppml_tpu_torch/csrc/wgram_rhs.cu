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
// w * A exist only as shared-memory tiles: they never reach device memory,
// which is the point of the TPU kernel.
//
// What does not carry over: the TPU kernel's bf16 operands, its Khatri-Rao
// operand KR (k^2, m) and the padding of every operand to (8, 128) tiles.
// This kernel takes float32, forms F[k1, r] * F[k2, r] itself and masks its
// own ragged edges.
//
// Design.  The TPU grid's sequential m dimension becomes a loop over m-tiles
// inside the block, so every output is summed by one thread in one fixed
// order: no atomics, the same inputs give the same bits.  The tiling, the
// accumulation and the store are wgram_tile.cuh's, shared with
// weighted_gram.cu: a block owns 32 columns and 8 rows k1 of every column's
// Gram; grid = (ceil(bc / 32), ceil(k / 8), ceil(k / 64)).  Each block
// recomputes mu and w for its column tile (k / 8 times the weight arithmetic
// over the grid, against k^2 / 8 multiply-adds per element for the Gram rows
// it owns).
//
// Bound on the H100: float32 multiply-adds outside the tensor cores.  The
// function needs 2 * m * bc * (k (k + 1) / 2 + 2k) operations (mu, the
// distinct entries of a symmetric Gram, b) against one read of A; this kernel
// does 2 * m * bc * (k^2 + 2k) and more, since it computes both triangles and
// recomputes mu in every row block.

#include <cuda_runtime.h>

#include "wgram_tile.cuh"

using namespace wgram_tile;

namespace {

enum LossKind { kKl = 0, kPower = 1, kNb = 2 };
enum ThetaMode { kThetaNone = 0, kThetaRow = 1, kThetaCol = 2 };

__device__ __forceinline__ float irls_weight(float mu, int loss_kind, float p,
                                             float theta, float w_cap) {
  if (loss_kind == kKl) return 1.f / fmaxf(mu, 1e-4f);
  const float mc = fmaxf(mu, 1e-15f);
  if (loss_kind == kPower) {
    float w;
    if (p == 2.f) {
      w = 1.f / (mc * mc);
    } else if (p == 3.f) {
      w = 1.f / (mc * mc * mc);
    } else {
      w = powf(mc, -p);
    }
    return fminf(w, w_cap);
  }
  const float t = fmaxf(theta, 1e-10f);
  return fminf(t / (mc * (t + mc)), w_cap);
}

// Shared memory, in floats: Fs[kTileM][fs] (F tile, transposed, zero padded
// to kp columns; fs = kp + 4 keeps float4 alignment), Xs[kp][kTileJ],
// Ws[kTileM][kTileJ], WAs[kTileM][kTileJ].
__global__ void __launch_bounds__(kMaxThreads)
wgram_rhs_kernel(const float* __restrict__ F, const float* __restrict__ X,
                 const float* __restrict__ A, const float* __restrict__ theta,
                 float* __restrict__ Gb, float* __restrict__ b, int k, int m,
                 int bc, int kp, int loss_kind, float power, int sparse_zeros,
                 int theta_mode, float w_cap) {
  extern __shared__ __align__(16) float smem[];
  const int fs = f_stride(kp);
  float* Fs = smem;
  float* Xs = Fs + kTileM * fs;
  float* Ws = Xs + kp * kTileJ;
  float* WAs = Ws + kTileM * kTileJ;

  const Owner o = owner();
  const size_t sbc = static_cast<size_t>(bc);

  // X tile, zero beyond k and beyond bc
  for (int idx = o.tid; idx < kp * kTileJ; idx += o.nthreads) {
    const int c = idx / kTileJ, jj = idx % kTileJ;
    const int j = o.j0 + jj;
    Xs[idx] = (c < k && j < bc) ? X[c * sbc + j] : 0.f;
  }

  Acc acc;
  clear(acc);

  for (int r0 = 0; r0 < m; r0 += kTileM) {
    __syncthreads();  // the previous step's readers are done (and Xs is set)
    load_f_tile(F, Fs, k, kp, m, r0, o);
    __syncthreads();
    // mu, w and w * a for the (kTileM, kTileJ) tile
    for (int idx = o.tid; idx < kTileM * kTileJ; idx += o.nthreads) {
      const int r = idx / kTileJ, jj = idx % kTileJ;
      const int row = r0 + r, j = o.j0 + jj;
      float w = 0.f, wa = 0.f;
      if (row < m && j < bc) {
        float mu = 0.f;
        const float4* f4 = reinterpret_cast<const float4*>(Fs + r * fs);
        for (int c4 = 0; c4 < kp / 4; ++c4) {
          const float4 f = f4[c4];
          const float* x = Xs + (4 * c4) * kTileJ + jj;
          mu = fmaf(f.x, x[0], mu);
          mu = fmaf(f.y, x[kTileJ], mu);
          mu = fmaf(f.z, x[2 * kTileJ], mu);
          mu = fmaf(f.w, x[3 * kTileJ], mu);
        }
        const float a = A[row * sbc + j];
        float th = 0.f;
        if (theta_mode == kThetaRow) th = theta[row];
        if (theta_mode == kThetaCol) th = theta[j];
        w = irls_weight(mu, loss_kind, power, th, w_cap);
        if (sparse_zeros && a == 0.f) w = 1.f;
        wa = w * a;
      }
      Ws[idx] = w;
      WAs[idx] = wa;
    }
    __syncthreads();
    accumulate_tile(Fs, Ws, WAs, k, kp, o, acc);
  }
  store_tile(Gb, b, k, bc, o, acc);
}

}  // namespace

// F (k, m), X (k, bc), A (m, bc), theta (m,) | (bc,) | null -> Gb (bc, k, k),
// b (k, bc); all float32, contiguous, on the current device.  loss_kind: 0 kl,
// 1 power (exponent `power`), 2 nb.  theta_mode: 0 none, 1 per row of A,
// 2 per column of A.  Returns the cudaError_t of the launch (0 on success).
extern "C" int wgram_rhs_launch(const float* F, const float* X, const float* A,
                                const float* theta, float* Gb, float* b, int k,
                                int m, int bc, int loss_kind, float power,
                                int sparse_zeros, int theta_mode, float w_cap,
                                void* stream) {
  if (k <= 0 || m <= 0 || bc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (loss_kind < kKl || loss_kind > kNb) return static_cast<int>(cudaErrorInvalidValue);
  if (loss_kind == kNb && (theta_mode == kThetaNone || theta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = padded_k(k);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kTileM) * f_stride(kp) +
                       static_cast<size_t>(kp) * kTileJ + 2u * kTileM * kTileJ);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_optin))
    return static_cast<int>(cudaErrorInvalidValue);   // k beyond about 880
  err = cudaFuncSetAttribute(wgram_rhs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  wgram_rhs_kernel<<<grid_shape(k, bc, kp), block_shape(kp), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      F, X, A, theta, Gb, b, k, m, bc, kp, loss_kind, power, sparse_zeros,
      theta_mode, w_cap);
  return static_cast<int>(cudaGetLastError());
}
