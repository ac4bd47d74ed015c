// Coordinate-descent NNLS against one shared Gram matrix, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::cd_nnls_pallas_shared
// (body _make_cd_kernel(batched=False)).  It computes the same solve as the
// plain sweep rcppml_tpu_torch/ops/cd_nnls.py::cd_nnls_shared_plain, which
// mirrors rcppml_tpu/ops/solvers.py::_cd_sweeps; the solve and the design
// are set out in cd_nnls.cuh, which kernel 2 shares.
//
// Design: a group of lanes per column, the column's residual and solution in
// registers (cd_nnls.cuh).  G is staged once per block in dynamic shared
// memory with the odd row stride k | 1 while k (k | 1) floats fit (k <= 241
// on the H100): the lanes of a group read column i of G on distinct banks,
// and the groups of a warp read the same words (a broadcast).  Beyond that G
// is read from device memory through L1 and L2, so any k is taken.  How many
// lanes a group has, how many rows a lane holds and how many groups a block
// runs come from the wrapper's plan (rcppml_tpu_torch/ops/cd_nnls.py::
// plan_cd).  B is read and not written; X0 is read and X written once.
//
// Bound on the H100: the dependent chain of the slowest column, max sweeps
// x k coordinate steps, and the issue rate of all columns' steps; its byte
// bound (G, B, X0 and X once) is microseconds.

#include "cd_nnls.cuh"

namespace {

using cd_nnls::Launch;

template <int kG, int kR, bool kGramShared>
__global__ void __launch_bounds__(512)
    cd_nnls_shared_kernel(const Launch L) {
  extern __shared__ float shared[];
  const int k = L.k;
  const int ld = kGramShared ? (k | 1) : k;
  const float* gram = L.gram;
  if (kGramShared) {
    for (int e = threadIdx.x; e < k * k; e += blockDim.x)
      shared[(e / k) * ld + e % k] = L.gram[e];
    __syncthreads();
    gram = shared;
  }
  const int lane = threadIdx.x % kG;
  const int j = blockIdx.x * (blockDim.x / kG) + threadIdx.x / kG;
  if (j >= L.n) return;   // the whole group: its lanes share j
  float b[kR], x[kR];
  cd_nnls::load_column<kG, kR>(L.B, L.X0, k, L.n, j, lane, b, x);
  cd_nnls::solve_regs<kG, kR>(gram, ld, k, lane,
                              cd_nnls::group_mask<kG>(threadIdx.x), b, x, L.p);
  cd_nnls::store_column<kG, kR>(L.X, k, L.n, j, lane, x);
}

// More than 8 rows a lane: one warp a column, b and x in shared memory (2 k
// floats a column), G from device memory.
__global__ void __launch_bounds__(512)
    cd_nnls_shared_loop_kernel(const Launch L) {
  extern __shared__ float shared[];
  const int k = L.k;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (j >= L.n) return;
  float* b = shared + (threadIdx.x / 32) * 2 * k;
  float* x = b + k;
  for (int r = lane; r < k; r += 32) {
    b[r] = L.B[static_cast<size_t>(r) * L.n + j];
    x[r] = L.X0[static_cast<size_t>(r) * L.n + j];
  }
  cd_nnls::solve_loop(L.gram, k, k, lane, b, x, L.p);
  for (int r = lane; r < k; r += 32)
    L.X[static_cast<size_t>(r) * L.n + j] = x[r];
}

struct Kernels {
  template <int kG, int kR, bool kGramShared>
  static cudaError_t go(const Launch& L) {
    if constexpr (kR == 0) {
      const int groups = L.threads / 32;
      return cd_nnls::launch_with_shared(cd_nnls_shared_loop_kernel, L,
                                         (L.n + groups - 1) / groups);
    } else {
      const int groups = L.threads / kG;
      return cd_nnls::launch_with_shared(
          cd_nnls_shared_kernel<kG, kR, kGramShared>, L,
          (L.n + groups - 1) / groups);
    }
  }
};

}  // namespace

// X = the solve from X0: G (k, k) row-major; B (the residual B - G X0), X0
// and X (k, n) row-major; all float32 on the current device, X distinct from
// the others.  `lanes`, `rows`, `threads`, `shared_bytes` and `gram_shared`
// are the plan (ops/cd_nnls.py::plan_cd).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int cd_nnls_shared_launch(const float* G, const float* B,
                                     const float* X0, float* X, int k, int n,
                                     float l1, float cd_tol, float inv_k,
                                     float abs_tol, int nonneg, int maxit,
                                     float upper_bound, int lanes, int rows,
                                     int threads, int shared_bytes,
                                     int gram_shared, void* stream) {
  if (k <= 0 || n <= 0 || threads <= 0 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{G, B, X0, X, k, n,
                 cd_nnls::Params{l1, cd_tol, inv_k, abs_tol, upper_bound,
                                 nonneg, maxit},
                 threads, shared_bytes, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      cd_nnls::dispatch<Kernels>(L, lanes, rows, gram_shared != 0));
}
