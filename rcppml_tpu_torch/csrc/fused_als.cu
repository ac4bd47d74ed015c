// Whole-fit Newton-Schulz ALS for dense MSE NMF, for sm_90a.
//
// Replaces the TPU kernel rcppml_tpu/ops/pallas_kernels.py::fused_als_vmem
// (body _make_fused_als_vmem_kernel).  It runs the same fixed-maxit ALS as
// the plain version rcppml_tpu_torch/ops/fused_als.py::fused_als_plain, which
// mirrors rcppml_tpu/models/nmf.py::_ns_als_xla:
//
//   per iteration:
//     G    = W W^T + ((1e-6 / k) tr(W W^T) + l2_h) I
//     Ginv = ns_refine(G, ginv_h)                  (warm start, kept)
//     H    = rownorm(max(Ginv (W A - l1_h), 0))    (rows divided by
//                                                   max(row sum, 1e-15))
//     Gw   = H H^T + (1e-6 / k) tr(H H^T) I        (the loss uses this one)
//     Gwinv= ns_refine(Gw + l2_w I, ginv_w)
//     Bw   = H A^T
//     Wu   = max(Gwinv (Bw - l1_w), 0);  ws = max(row sums of Wu, 1e-15)
//     W    = Wu / ws;  d = ws
//     loss = tr(A^T A) - 2 sum(ws W Bw) + sum((d d^T) (W W^T) Gw)
//   ns_refine(G, X): X *= 1 / sqrt(|G X|_1 |G X|_inf), then ns_steps times
//     X = X (2 I - G X).  The first inverses start from G^T / (|G|_1 |G|_inf).
//
// Design.  The TPU kernel is one program with A pinned in 100 MB of VMEM.  An
// H100 has no such store: A stays in device memory (or in the 50 MB L2 when
// it fits) and is read twice per iteration.  One C call enqueues a fixed
// sequence of this file's own kernels for all maxit iterations on the
// caller's stream: 4 launches to seed the inverses and 13 per iteration.  The
// host reads nothing and decides nothing until the call returns; the stream's
// order is the only synchronisation between phases, so no phase reads what
// another block of the same phase writes.  The products that read A are the
// tall product of rhs_tall.cuh (kernels 7 and 8: tensor cores, a cp.async
// ring fed by producer warps); the row normalisation that writes a factor also
// writes it prepared as the next product's small operand (rounded to
// bfloat16, or split into TF32 parts for a float32 A).
// The Grams and Ginv . B are rhs_tall.cuh's float32 FMA tile.  The k x k
// work (ridge, seed, rescale, Newton-Schulz) runs in one block with G, X and
// a scratch matrix in shared memory (k <= 138), or beyond that in a
// device-memory scratch the wrapper allocates; the warm starts live in
// device memory between iterations.  A factor row's sum, its
// division and its share of the loss's cross term belong to one block, and
// every sum across blocks (Gram, row sums, cross, recon) is a set of partials
// added in the order of their index: no atomics, the same bits every run.
//
// Bound on the H100: two reads of A per iteration when A does not fit in L2
// (bytes); the 2 k m n operations of each product when it does.  The single
// block of k x k work, 15 products of k^3 for each refine, is a serial
// section that grows with k^3.

#include "rhs_tall.cuh"

namespace {

constexpr int kKxkThreads = 1024;
constexpr int kKxkColsMax = 5;   // 32-column groups per lane and pass
constexpr int kRowThreads = 256;


// Sum over the block in a fixed order (tree over shared memory); every
// thread gets the result.  `scratch` holds blockDim.x floats.
__device__ float block_sum(float v, float* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) scratch[threadIdx.x] += scratch[threadIdx.x + o];
    __syncthreads();
  }
  const float total = scratch[0];
  __syncthreads();
  return total;
}

// Out = A . B for k x k matrices with row stride ld (in shared memory, or in
// the device-memory scratch), or Out = 2 I - A . B.  A warp owns kRows rows
// at a time, a lane the kCols columns c0 + lane + 32 c of a pass over the
// columns from c0 (one pass while k <= 32 kCols).  Rows and columns beyond k
// are computed on a clamped index and never written, so the inner loop has
// no branch.  Out may be A itself while one pass covers k: a warp reads only
// its own rows of A and writes them after its last read.
template <int kCols, int kRows>
__device__ __forceinline__ void kxk_product(const float* A, const float* B,
                                            float* Out, int k, int ld,
                                            bool two_i_minus) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  for (int c0 = 0; c0 < k; c0 += 32 * kCols) {
    int col[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) col[c] = min(c0 + lane + 32 * c, k - 1);
    for (int ib = kRows * warp; ib < k; ib += kRows * warps) {
      const float* row[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) row[q] = A + min(ib + q, k - 1) * ld;
      float acc[kRows][kCols];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[q][c] = 0.f;
#pragma unroll 4
      for (int l = 0; l < k; ++l) {
        float a[kRows], b[kCols];
#pragma unroll
        for (int q = 0; q < kRows; ++q) a[q] = row[q][l];
#pragma unroll
        for (int c = 0; c < kCols; ++c) b[c] = B[l * ld + col[c]];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[q][c] = fmaf(a[q], b[c], acc[q][c]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = ib + q;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = c0 + lane + 32 * c;
          if (i < k && j < k) {
            float v = acc[q][c];
            if (two_i_minus) v = (i == j ? 2.f : 0.f) - v;
            Out[i * ld + j] = v;
          }
        }
      }
    }
  }
  __syncthreads();
}

// |M|_1 |M|_inf of a k x k matrix in shared memory: the largest column sum
// times the largest row sum of |M|.  `sums` holds 2 k floats.  Every thread
// gets the result.
__device__ float norm_product(const float* M, int k, int ld, float* sums) {
  for (int t = threadIdx.x; t < 2 * k; t += blockDim.x) {
    float s = 0.f;
    if (t < k) {
      for (int i = 0; i < k; ++i) s += fabsf(M[i * ld + t]);
    } else {
      for (int j = 0; j < k; ++j) s += fabsf(M[(t - k) * ld + j]);
    }
    sums[t] = s;
  }
  __syncthreads();
  float n1 = 0.f, ninf = 0.f;
  for (int t = 0; t < k; ++t) {
    n1 = fmaxf(n1, sums[t]);
    ninf = fmaxf(ninf, sums[k + t]);
  }
  __syncthreads();
  return n1 * ninf;
}

// One block.  G = sum of the Gram partials P (splits, k, k) in index order;
// the ridge (ridge_scale tr(G)) and l2 go on the diagonal; the inverse is
// refined from the warm start in `ginv` (or, with seed != 0, from
// G^T / (|G|_1 |G|_inf)) and written back to `ginv`.  With g_free != null the
// ridge goes on first, that Gram (free of l2) is written to g_free for the
// loss, and l2 is added after.  G, X and T live in shared memory, or, with
// scratch != null (k x k matrices too large for it), in `scratch` with a
// fourth matrix U that takes X T out of place; the 2k sums stay in shared
// memory.  Each entry sees the same operations in the same order either way.
template <int kCols>
__global__ void __launch_bounds__(kKxkThreads)
    kxk_refine_kernel(const float* __restrict__ P, int splits, int k,
                      float ridge_scale, float l2, int seed,
                      float* __restrict__ ginv, float* __restrict__ g_free,
                      int ns_steps, float* scratch) {
  extern __shared__ float shared[];
  const int ld = k | 1;   // odd: a walk down a column meets every bank
  float* G = scratch != nullptr ? scratch : shared;
  float* X = G + k * ld;
  float* T = X + k * ld;
  float* U = scratch != nullptr ? T + k * ld : nullptr;
  float* sums = scratch != nullptr ? shared : T + k * ld;
  const int tid = threadIdx.x;
  const int kk = k * k;
  // rows of a k x k product that a warp computes at a time: 2 keep all 32
  // warps busy up to k = 64, 4 halve the shared-memory loads per FMA beyond
  constexpr int kRows = kCols <= 2 ? 2 : 4;

  for (int e = tid; e < kk; e += blockDim.x) {
    float acc = P[e];
    for (int s = 1; s < splits; ++s) acc += P[static_cast<size_t>(s) * kk + e];
    G[(e / k) * ld + e % k] = acc;
  }
  __syncthreads();
  float trace = 0.f;
  for (int i = 0; i < k; ++i) trace += G[i * ld + i];
  const float ridge = ridge_scale * trace;
  __syncthreads();
  if (tid < k) G[tid * ld + tid] += g_free != nullptr ? ridge : ridge + l2;
  __syncthreads();
  if (g_free != nullptr) {
    for (int e = tid; e < kk; e += blockDim.x)
      g_free[e] = G[(e / k) * ld + e % k];
    if (l2 != 0.f) {
      __syncthreads();
      if (tid < k) G[tid * ld + tid] += l2;
    }
    __syncthreads();
  }

  if (seed) {
    const float nn = norm_product(G, k, ld, sums);
    for (int e = tid; e < kk; e += blockDim.x)
      X[(e / k) * ld + e % k] = G[(e % k) * ld + e / k] / nn;
  } else {
    for (int e = tid; e < kk; e += blockDim.x)
      X[(e / k) * ld + e % k] = ginv[e];
  }
  __syncthreads();

  // rescale so that the iteration contracts whatever the warm start
  kxk_product<kCols, kRows>(G, X, T, k, ld, false);
  const float alpha = 1.f / sqrtf(norm_product(T, k, ld, sums));
  for (int e = tid; e < kk; e += blockDim.x) X[(e / k) * ld + e % k] *= alpha;
  __syncthreads();
  for (int step = 0; step < ns_steps; ++step) {
    kxk_product<kCols, kRows>(G, X, T, k, ld, true);    // T = 2 I - G X
    if (U == nullptr) {
      kxk_product<kCols, kRows>(X, T, X, k, ld, false);  // X = X T, in place
    } else {
      kxk_product<kCols, kRows>(X, T, U, k, ld, false);  // U = X T
      float* swap = X;
      X = U;
      U = swap;
    }
  }
  for (int e = tid; e < kk; e += blockDim.x) ginv[e] = X[(e / k) * ld + e % k];
}

// One block per factor row i.  out[i] = max(U[i], 0) / max(sum, 1e-15) with
// the sum over the clipped row (no clip unless nonneg).  With d != null the
// clamped sum goes to d[i]; with saved != null, cross_row[i] = sum over the
// row of (scale out) saved, the row's share of the loss's cross term.  Row i
// of out also goes, prepared as the tall product's small operand, to row i
// of `small` (row stride lds, the columns from len to lds zero, planes of
// gridDim.x rows: rhs_tall::store_small).
__global__ void __launch_bounds__(kRowThreads)
    row_normalize_kernel(const float* __restrict__ U, float* __restrict__ out,
                         int len, int nonneg, float* __restrict__ d,
                         const float* __restrict__ saved,
                         float* __restrict__ cross_row, void* __restrict__ small,
                         int lds, int bf16) {
  __shared__ float scratch[kRowThreads];
  const size_t base = static_cast<size_t>(blockIdx.x) * len;
  float s = 0.f;
  for (int r = threadIdx.x; r < len; r += blockDim.x) {
    float v = U[base + r];
    if (nonneg) v = fmaxf(v, 0.f);
    s += v;
  }
  const float scale = fmaxf(block_sum(s, scratch), 1e-15f);
  float c = 0.f;
  for (int r = threadIdx.x; r < len; r += blockDim.x) {
    float v = U[base + r];
    if (nonneg) v = fmaxf(v, 0.f);
    const float w = v / scale;
    out[base + r] = w;
    rhs_tall::store_small(w, small, static_cast<size_t>(blockIdx.x) * lds + r,
                          static_cast<size_t>(gridDim.x) * lds, bf16 != 0);
    if (saved != nullptr) c += (scale * w) * saved[base + r];
  }
  for (int r = len + threadIdx.x; r < lds; r += blockDim.x) {
    rhs_tall::store_small(0.f, small, static_cast<size_t>(blockIdx.x) * lds + r,
                          static_cast<size_t>(gridDim.x) * lds, bf16 != 0);
  }
  if (saved != nullptr) {
    c = block_sum(c, scratch);
    if (threadIdx.x == 0) cross_row[blockIdx.x] = c;
  }
  if (d != nullptr && threadIdx.x == 0) d[blockIdx.x] = scale;
}

// One block.  hist[it] = tr(A^T A) - 2 cross + recon with cross the sum of
// cross_row and recon = sum_ij (d_i d_j) (W W^T)_ij Gw_ij, W W^T the sum of
// the Gram partials P in index order.
__global__ void __launch_bounds__(kRowThreads)
    loss_kernel(const float* __restrict__ P, int splits, int k,
                const float* __restrict__ g_free, const float* __restrict__ d,
                const float* __restrict__ cross_row,
                const float* __restrict__ trata, float* __restrict__ hist,
                int it) {
  __shared__ float scratch[kRowThreads];
  const int kk = k * k;
  float local = 0.f;
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    float gram = P[e];
    for (int s = 1; s < splits; ++s) gram += P[static_cast<size_t>(s) * kk + e];
    local += (d[e / k] * d[e % k]) * gram * g_free[e];
  }
  const float recon = block_sum(local, scratch);
  if (threadIdx.x == 0) {
    float cross = 0.f;
    for (int i = 0; i < k; ++i) cross += cross_row[i];
    hist[it] = trata[0] - 2.f * cross + recon;
  }
}

size_t kxk_shared_bytes(int k) {
  return (static_cast<size_t>(3) * k * (k | 1) + 2 * k) * sizeof(float);
}

// `scratch` is null where kxk_shared_bytes(k) fits one block's shared
// memory, else 4 k (k | 1) floats of device memory.
template <int kCols>
cudaError_t launch_refine(const float* P, int splits, int k, float ridge_scale,
                          float l2, int seed, float* ginv, float* g_free,
                          int ns_steps, float* scratch, cudaStream_t stream) {
  const size_t shared = scratch != nullptr ? 2 * k * sizeof(float)
                                           : kxk_shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      kxk_refine_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  kxk_refine_kernel<kCols><<<1, kKxkThreads, shared, stream>>>(
      P, splits, k, ridge_scale, l2, seed, ginv, g_free, ns_steps, scratch);
  return cudaGetLastError();
}

// The refine with as many 32-column groups as k needs (passes of
// kKxkColsMax groups beyond).
cudaError_t enqueue_refine(const float* P, int splits, int k, float ridge_scale,
                           float l2, int seed, float* ginv, float* g_free,
                           int ns_steps, float* scratch, cudaStream_t stream) {
  switch ((k + 31) / 32) {
    case 1:
      return launch_refine<1>(P, splits, k, ridge_scale, l2, seed, ginv,
                              g_free, ns_steps, scratch, stream);
    case 2:
      return launch_refine<2>(P, splits, k, ridge_scale, l2, seed, ginv,
                              g_free, ns_steps, scratch, stream);
    case 3:
      return launch_refine<3>(P, splits, k, ridge_scale, l2, seed, ginv,
                              g_free, ns_steps, scratch, stream);
    case 4:
      return launch_refine<4>(P, splits, k, ridge_scale, l2, seed, ginv,
                              g_free, ns_steps, scratch, stream);
    default:
      return launch_refine<kKxkColsMax>(P, splits, k, ridge_scale, l2, seed,
                                        ginv, g_free, ns_steps, scratch,
                                        stream);
  }
}

}  // namespace

// Buffers of the workspace, as offsets (in floats) into `work`.
enum Buffer {
  kSmallW = 0,    // W prepared as the small operand (rhs_tall::store_small)
  kSmallH,        // H prepared the same way
  kPartB,         // (2 blocks_fwd, k, 128) pieces of W A
  kPartBw,        // (2 blocks_trp, k, 128) pieces of H A^T
  kPartGramW,     // (splits_gw, k, k) partials of W W^T
  kPartGramH,     // (splits_gh, k, k) partials of H H^T
  kRhsH,          // (k, n) W A - l1_h
  kSolvedH,       // (k, n) Ginv (W A - l1_h)
  kRhsW,          // (k, m) H A^T, kept for the loss
  kRhsWShifted,   // (k, m) H A^T - l1_w (unused when l1_w == 0)
  kSolvedW,       // (k, m)
  kGramFree,      // (k, k) H H^T + ridge I
  kCrossRow,      // (k,)
  kBufferCount
};

// Runs the whole fit.  On entry W (k, m) and H (k, n) hold the starting
// factors; on return they hold the fitted ones, d (k,) the scaling and hist
// (maxit,) the loss of every iteration.  A (m, n) holds float32, or bfloat16
// with a_bf16 != 0.  ginv_h and ginv_w are (k, k) scratch for the warm
// starts.  kxk_scratch is null while the k x k section fits one block's
// shared memory, else 4 k (k | 1) floats.  `offsets` (kBufferCount entries)
// places the buffers above in `work`; kSmallW holds W prepared on entry.  `plan` holds the blocks of
// W A and of H A^T (rhs_tall::launch_tall; each followed by a 0) and the
// (splits, chunk) of W W^T and H H^T, in that order.  trata points to tr(A^T A) on the device.  *launched gets the
// number of kernels enqueued.  Returns the cudaError_t of the first launch
// that failed (0 on success).  Nothing is read back and nothing waits.
extern "C" int fused_als_launch(
    const void* A, int a_bf16, float* W, float* H, float* d, float* hist,
    float* ginv_h, float* ginv_w, float* work, float* kxk_scratch,
    const long long* offsets,
    const int* plan, const float* trata, int k, int m, int n, int maxit,
    int nonneg, int ns_steps, float l1_w, float l1_h, float l2_w, float l2_h,
    float ridge_scale, int* launched, void* stream) {
  *launched = 0;
  if (k <= 0 || m <= 0 || n <= 0 || maxit <= 0 || ns_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;

  float* buf[kBufferCount];
  for (int b = 0; b < kBufferCount; ++b) buf[b] = work + offsets[b];
  const int b_fwd = plan[0], b_trp = plan[2];
  const int s_gw = plan[4], c_gw = plan[5], s_gh = plan[6], c_gh = plan[7];
  const int k_chunk = (k + rhs_tall::kRT - 1) / rhs_tall::kRT * rhs_tall::kRT;
  const bool bf16 = a_bf16 != 0;
  const float* rhs_w = l1_w != 0.f ? buf[kRhsWShifted] : buf[kRhsW];
  // the small operands of the products with A: the factors prepared
  const int ldw = rhs_tall::small_ld(m, bf16);
  const int ldh = rhs_tall::small_ld(n, bf16);
  void* w_small = buf[kSmallW];
  void* h_small = buf[kSmallH];

#define ENQUEUED(call)                                  \
  do {                                                  \
    err = (call);                                       \
    if (err != cudaSuccess) return static_cast<int>(err); \
    ++*launched;                                        \
  } while (0)
#define GRAM(F, len, splits, chunk, out)                                    \
  ENQUEUED(rhs_tall::launch_small(F, len, F, len, true, out, k, k, len, \
                                  splits, chunk, s))
#define REFINE(part, splits, l2, seed, ginv, g_free)                        \
  ENQUEUED(enqueue_refine(part, splits, k, ridge_scale, l2, seed, ginv,     \
                          g_free, ns_steps, kxk_scratch, s))

  // the first inverses, from the starting factors
  GRAM(W, m, s_gw, c_gw, buf[kPartGramW]);
  REFINE(buf[kPartGramW], s_gw, l2_h, 1, ginv_h, nullptr);
  GRAM(H, n, s_gh, c_gh, buf[kPartGramH]);
  REFINE(buf[kPartGramH], s_gh, l2_w, 1, ginv_w, nullptr);

  for (int it = 0; it < maxit; ++it) {
    // H update; W W^T's partials are those of the seed or of the last loss
    REFINE(buf[kPartGramW], s_gw, l2_h, 0, ginv_h, nullptr);
    ENQUEUED(rhs_tall::launch_tall(w_small, ldw, A, n, bf16, false,
                                   buf[kPartB], k, n, m, b_fwd, s));
    ENQUEUED(rhs_tall::launch_tall_reduce(buf[kPartB], b_fwd, k, n, m, bf16,
                                          l1_h, nullptr, buf[kRhsH], s));
    ENQUEUED(rhs_tall::launch_small(ginv_h, k, buf[kRhsH], n, false,
                                    buf[kSolvedH], k, n, k, 1, k_chunk, s));
    row_normalize_kernel<<<k, kRowThreads, 0, s>>>(buf[kSolvedH], H, n, nonneg,
                                                   nullptr, nullptr, nullptr,
                                                   h_small, ldh, a_bf16);
    ENQUEUED(cudaGetLastError());

    // W update
    GRAM(H, n, s_gh, c_gh, buf[kPartGramH]);
    REFINE(buf[kPartGramH], s_gh, l2_w, 0, ginv_w, buf[kGramFree]);
    ENQUEUED(rhs_tall::launch_tall(h_small, ldh, A, n, bf16, true,
                                   buf[kPartBw], k, m, n, b_trp, s));
    ENQUEUED(rhs_tall::launch_tall_reduce(
        buf[kPartBw], b_trp, k, m, n, bf16, l1_w, buf[kRhsW],
        l1_w != 0.f ? buf[kRhsWShifted] : nullptr, s));
    ENQUEUED(rhs_tall::launch_small(ginv_w, k, rhs_w, m, false,
                                    buf[kSolvedW], k, m, k, 1, k_chunk, s));
    row_normalize_kernel<<<k, kRowThreads, 0, s>>>(
        buf[kSolvedW], W, m, nonneg, d, buf[kRhsW], buf[kCrossRow], w_small,
        ldw, a_bf16);
    ENQUEUED(cudaGetLastError());

    // saved-matrix Gram-trick loss
    GRAM(W, m, s_gw, c_gw, buf[kPartGramW]);
    loss_kernel<<<1, kRowThreads, 0, s>>>(buf[kPartGramW], s_gw, k,
                                          buf[kGramFree], d, buf[kCrossRow],
                                          trata, hist, it);
    ENQUEUED(cudaGetLastError());
  }
#undef REFINE
#undef GRAM
#undef ENQUEUED
  return static_cast<int>(cudaSuccess);
}
