// Coordinate-descent NNLS against one shared Gram matrix, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::cd_nnls_pallas_shared
// (body _make_cd_kernel(batched=False)).  It computes the same solve as the
// plain sweep rcppml_tpu_torch/ops/cd_nnls.py::cd_nnls_shared_plain, which
// mirrors rcppml_tpu/ops/solvers.py::_cd_sweeps:
//
//   for each sweep (at most maxit, while the column is active):
//     for i = 0..k-1:
//       diff   = g_ii > 0 ? b_i / g_ii - L1 : 0     (dead coordinate skipped,
//                                                   its L1 term included)
//       new    = clamp(x_i + diff)                  (nonneg, upper_bound)
//       actual = new - x_i;  x_i += actual
//       b_r   -= G[r, i] * actual   for every r     (rank-1 residual update)
//       tol   += |actual| / (|x_i| + CD_ABS_TOL)
//     the column freezes once tol * (1/k) < cd_tol.
//
// Design: one thread per column.  Columns are independent, so a thread
// leaves its own sweep loop when its column freezes; in the plain sweep a
// frozen column keeps being visited with actual = (new - x) * 0 = 0, which
// leaves X unchanged, so the results agree.  G is staged in dynamic shared
// memory when it fits (every thread reads the same G[r, i], a broadcast) and
// is read through the read-only cache otherwise, so any k is taken.  The
// (k, n) residual and solution stay in device memory, row-major with element
// (i, j) at i * n + j: neighbouring threads touch neighbouring addresses.
//
// Bound on the H100: latency of the k-sequential chain.  Each coordinate
// step depends on the previous one, and with one thread per column a solve
// at n = 2,638 fills only about 21 blocks of 128 threads on 132 SMs.  Each
// sweep also moves k * k residual elements per column through L1/L2.
//
// Rounding: every operation is written with an explicit _rn intrinsic, so
// nvcc cannot contract a - b * c into an FMA and division is IEEE-exact.
// That reproduces PyTorch's eager plain sweep (one rounding per operation)
// bit for bit on the card.

#include <cuda_runtime.h>

namespace {

template <bool kGramInShared>
__global__ void cd_nnls_shared_kernel(const float* __restrict__ G,
                                      float* __restrict__ B,
                                      float* __restrict__ X,
                                      int k, int n, float l1, float cd_tol,
                                      float inv_k, float abs_tol, int nonneg,
                                      int maxit, float upper_bound) {
  extern __shared__ float g_shared[];
  const float* g = G;
  if (kGramInShared) {
    for (int t = threadIdx.x; t < k * k; t += blockDim.x) g_shared[t] = G[t];
    __syncthreads();
    g = g_shared;
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t sn = static_cast<size_t>(n);

  for (int it = 0; it < maxit; ++it) {
    float tol_sum = 0.f;
    for (int i = 0; i < k; ++i) {
      const float gii = kGramInShared ? g[i * k + i] : __ldg(g + i * k + i);
      const float x = X[i * sn + j];
      float diff = 0.f;
      if (gii > 0.f) diff = __fsub_rn(__fdiv_rn(B[i * sn + j], gii), l1);
      float nv = __fadd_rn(x, diff);
      if (nonneg) nv = fmaxf(nv, 0.f);
      if (upper_bound > 0.f) nv = fminf(nv, upper_bound);
      const float actual = __fsub_rn(nv, x);
      const float xn = __fadd_rn(x, actual);
      X[i * sn + j] = xn;
      for (int r = 0; r < k; ++r) {
        const float gri = kGramInShared ? g[r * k + i] : __ldg(g + r * k + i);
        B[r * sn + j] = __fsub_rn(B[r * sn + j], __fmul_rn(gri, actual));
      }
      tol_sum = __fadd_rn(
          tol_sum, __fdiv_rn(fabsf(actual), __fadd_rn(fabsf(xn), abs_tol)));
    }
    if (!(__fmul_rn(tol_sum, inv_k) >= cd_tol)) break;
  }
}

constexpr int kThreads = 128;

}  // namespace

// Solves in place: B holds the residual B - G X0 on entry and is scratch on
// return; X holds X0 on entry and the solution on return.  G is (k, k)
// row-major, B and X are (k, n) row-major, all float32 on the current device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cd_nnls_shared_launch(const float* G, float* B, float* X,
                                     int k, int n, float l1, float cd_tol,
                                     float inv_k, float abs_tol, int nonneg,
                                     int maxit, float upper_bound,
                                     void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = static_cast<size_t>(k) * k * sizeof(float);
  const dim3 block(kThreads);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= static_cast<size_t>(smem_optin)) {
    err = cudaFuncSetAttribute(cd_nnls_shared_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cd_nnls_shared_kernel<true><<<grid, block, smem, s>>>(
        G, B, X, k, n, l1, cd_tol, inv_k, abs_tol, nonneg, maxit, upper_bound);
  } else {
    cd_nnls_shared_kernel<false><<<grid, block, 0, s>>>(
        G, B, X, k, n, l1, cd_tol, inv_k, abs_tol, nonneg, maxit, upper_bound);
  }
  return static_cast<int>(cudaGetLastError());
}
