// Coordinate-descent NNLS with one Gram matrix per column, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::cd_nnls_pallas_batched
// (body _make_cd_kernel(batched=True)).  It computes the same solve as the
// plain sweep rcppml_tpu_torch/ops/cd_nnls_batched.py::cd_nnls_batched_plain,
// which mirrors the lax loop of rcppml_tpu/ops/solvers.py::cd_nnls_batched_gram;
// the solve and the design are set out in cd_nnls.cuh, which kernel 1
// shares.  Column j's rank-1 update reads COLUMN i of its own Gram,
// Gb[j, r, i] (the Grams are symmetric only in exact arithmetic).
//
// Design: a group of lanes per column, the column's residual and solution in
// registers (cd_nnls.cuh).  The Grams are read from the (n, k, k) batch as it
// lies, with no transposed copy: on the main route each group copies its
// column's k x k Gram, contiguous, once per solve into shared memory (the
// group's lanes read neighbouring words) with the odd row stride k | 1, and
// the sweeps read it there.  A Gram of more than about 28 KB (k > 83) would
// leave fewer than eight columns resident on a multiprocessor, so there the
// group reads its column's Gram from device memory at each step instead
// (through L1 and L2; a column's Gram is read again every sweep).  The plan
// (rcppml_tpu_torch/ops/cd_nnls_batched.py::plan_cd) picks the route, the
// lanes of a group, the rows of a lane and the groups of a block.  Offsets
// into the batch are size_t: n k k passes 2^31 at n = 13,714, k = 400.
//
// Bound on the H100: the dependent chain of the slowest column, max sweeps
// x k coordinate steps, and the issue rate of all columns' steps; the bytes,
// one read of n k^2 4 bytes of Grams (and B, X0, X once), come second at the
// main path's shapes (38.7 MB at k = 50, n = 3,867: 12 us at 3.35 TB/s).

#include "cd_nnls.cuh"

namespace {

using cd_nnls::Launch;

template <int kG, int kR, bool kGramShared>
__global__ void __launch_bounds__(512)
    cd_nnls_batched_kernel(const Launch L) {
  extern __shared__ float shared[];
  const int k = L.k;
  const int lane = threadIdx.x % kG;
  const int group = threadIdx.x / kG;
  const int j = blockIdx.x * (blockDim.x / kG) + group;
  if (j >= L.n) return;   // the whole group: its lanes share j
  const unsigned mask = cd_nnls::group_mask<kG>(threadIdx.x);
  const float* gram = L.gram + static_cast<size_t>(j) * k * k;
  int ld = k;
  if (kGramShared) {
    // the column's Gram, row by row: the group reads neighbouring words
    ld = k | 1;
    float* own = shared + static_cast<size_t>(group) * k * ld;
    for (int r = 0; r < k; ++r)
      for (int c = lane; c < k; c += kG) own[r * ld + c] = gram[r * k + c];
    __syncwarp(mask);
    gram = own;
  }
  float b[kR], x[kR];
  cd_nnls::load_column<kG, kR>(L.B, L.X0, k, L.n, j, lane, b, x);
  cd_nnls::solve_regs<kG, kR>(gram, ld, k, lane, mask, b, x, L.p);
  cd_nnls::store_column<kG, kR>(L.X, k, L.n, j, lane, x);
}

// More than 8 rows a lane: one warp a column, b and x in shared memory (2 k
// floats a column), the Gram from device memory.
__global__ void __launch_bounds__(512)
    cd_nnls_batched_loop_kernel(const Launch L) {
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
  cd_nnls::solve_loop(L.gram + static_cast<size_t>(j) * k * k, k, k, lane, b,
                      x, L.p);
  for (int r = lane; r < k; r += 32)
    L.X[static_cast<size_t>(r) * L.n + j] = x[r];
}

struct Kernels {
  template <int kG, int kR, bool kGramShared>
  static cudaError_t go(const Launch& L) {
    if constexpr (kR == 0) {
      const int groups = L.threads / 32;
      return cd_nnls::launch_with_shared(cd_nnls_batched_loop_kernel, L,
                                         (L.n + groups - 1) / groups);
    } else {
      const int groups = L.threads / kG;
      return cd_nnls::launch_with_shared(
          cd_nnls_batched_kernel<kG, kR, kGramShared>, L,
          (L.n + groups - 1) / groups);
    }
  }
};

}  // namespace

// X = the solve from X0: Gb (n, k, k) row-major, Gram j at Gb + j k k; B
// (the residual b_j - G_j x0_j), X0 and X (k, n) row-major; all float32 on
// the current device, X distinct from the others.  `lanes`, `rows`,
// `threads`, `shared_bytes` and `gram_shared` are the plan
// (ops/cd_nnls_batched.py::plan_cd).  Returns the cudaError_t of the launch.
extern "C" int cd_nnls_batched_launch(const float* Gb, const float* B,
                                      const float* X0, float* X, int k, int n,
                                      float l1, float cd_tol, float inv_k,
                                      float abs_tol, int nonneg, int maxit,
                                      float upper_bound, int lanes, int rows,
                                      int threads, int shared_bytes,
                                      int gram_shared, void* stream) {
  if (k <= 0 || n <= 0 || threads <= 0 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{Gb, B, X0, X, k, n,
                 cd_nnls::Params{l1, cd_tol, inv_k, abs_tol, upper_bound,
                                 nonneg, maxit},
                 threads, shared_bytes, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      cd_nnls::dispatch<Kernels>(L, lanes, rows, gram_shared != 0));
}
