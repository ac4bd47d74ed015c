// Coordinate-descent NNLS with one Gram matrix per column, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::cd_nnls_pallas_batched
// (body _make_cd_kernel(batched=True)).  It computes the same solve as the
// plain sweep rcppml_tpu_torch/ops/cd_nnls_batched.py::cd_nnls_batched_plain,
// which mirrors the lax loop of rcppml_tpu/ops/solvers.py::cd_nnls_batched_gram:
//
//   for each column j, for each sweep (at most maxit, while j is active):
//     for i = 0..k-1:
//       g      = Gb[j, i, i]
//       diff   = g > 0 ? b_i / g - L1 : 0           (dead coordinate skipped,
//                                                   its L1 term included)
//       new    = clamp(x_i + diff)                  (nonneg, upper_bound)
//       actual = new - x_i;  x_i += actual
//       b_r   -= Gb[j, r, i] * actual   for every r (COLUMN i of the Gram:
//                                                   Gb is symmetric only in
//                                                   exact arithmetic)
//       tol   += |actual| / (|x_i| + CD_ABS_TOL)
//     column j freezes once tol * (1/k) < cd_tol.
//
// Design: one thread per column, which leaves its sweep loop when its column
// freezes (the TPU tile runs every lane to its slowest one).  The Grams are
// the traffic: every sweep reads all k*k floats of its column, n*k*k*4 bytes
// per sweep in all, far beyond shared memory.  The kernel therefore takes the
// Grams transposed to (k, k, n), element (r, i, j) at (r * k + i) * n + j,
// so the 32 threads of a warp read 32 neighbouring floats for each (r, i);
// the wrapper makes that transpose once per solve (a torch copy, counted in
// the kernel's time).  The residual and the solution are (k, n) row-major in
// device memory, coalesced the same way.  Offsets are size_t: n * k * k
// passes 2^31 at n = 13,714, k = 400.
//
// Bound on the H100: device-memory / L2 bandwidth for the Grams (each sweep
// streams them again; 14 MB at n = 13,714, k = 16 stays in the 50 MB L2) and
// the latency of the k-sequential chain when n fills few blocks.
//
// Rounding: every operation is an explicit _rn intrinsic, so nvcc cannot
// contract b - g * a into an FMA and division is IEEE-exact: bit for bit the
// eager PyTorch twin (one rounding per operation).

#include <cuda_runtime.h>

namespace {

__global__ void cd_nnls_batched_kernel(const float* __restrict__ Gt,
                                       float* __restrict__ B,
                                       float* __restrict__ X,
                                       int k, int n, float l1, float cd_tol,
                                       float inv_k, float abs_tol, int nonneg,
                                       int maxit, float upper_bound) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t sn = static_cast<size_t>(n);
  const size_t sk = static_cast<size_t>(k);
  const float* g = Gt + j;      // g[(r * k + i) * n] == Gb[j, r, i]
  float* b = B + j;             // b[i * n] == B[i, j]
  float* x = X + j;

  for (int it = 0; it < maxit; ++it) {
    float tol_sum = 0.f;
    for (int i = 0; i < k; ++i) {
      const float gii = __ldg(g + (i * sk + i) * sn);
      const float xi = x[i * sn];
      float diff = 0.f;
      if (gii > 0.f) diff = __fsub_rn(__fdiv_rn(b[i * sn], gii), l1);
      float nv = __fadd_rn(xi, diff);
      if (nonneg) nv = fmaxf(nv, 0.f);
      if (upper_bound > 0.f) nv = fminf(nv, upper_bound);
      const float actual = __fsub_rn(nv, xi);
      const float xn = __fadd_rn(xi, actual);
      x[i * sn] = xn;
      for (int r = 0; r < k; ++r) {
        const float gri = __ldg(g + (r * sk + i) * sn);
        b[r * sn] = __fsub_rn(b[r * sn], __fmul_rn(gri, actual));
      }
      tol_sum = __fadd_rn(
          tol_sum, __fdiv_rn(fabsf(actual), __fadd_rn(fabsf(xn), abs_tol)));
    }
    if (!(__fmul_rn(tol_sum, inv_k) >= cd_tol)) break;
  }
}

// One warp per block: a solve at n = 2,638 then spreads over 83 of the 132
// SMs, where blocks of 128 threads would use 21.
constexpr int kThreads = 32;

}  // namespace

// Solves in place: B holds the residual b_j - G_j x0_j on entry and is
// scratch on return; X holds X0 on entry and the solution on return.  Gt is
// the Gram batch transposed to (k, k, n); B and X are (k, n) row-major; all
// float32 on the current device.  Returns the cudaError_t of the launch.
extern "C" int cd_nnls_batched_launch(const float* Gt, float* B, float* X,
                                      int k, int n, float l1, float cd_tol,
                                      float inv_k, float abs_tol, int nonneg,
                                      int maxit, float upper_bound,
                                      void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cd_nnls_batched_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      Gt, B, X, k, n, l1, cd_tol, inv_k, abs_tol, nonneg, maxit, upper_bound);
  return static_cast<int>(cudaGetLastError());
}
