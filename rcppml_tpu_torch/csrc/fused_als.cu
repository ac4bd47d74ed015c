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
// The Grams are cluster_gram.cuh's (a slab of the factor a block, the
// partials of a cluster of eight blocks added through distributed shared
// memory), Ginv . B is rhs_tall.cuh's float32 FMA tile.  The k x k work
// (ridge, seed, rescale, Newton-Schulz) runs in one block on float32
// multiply-adds with G, X and T in shared memory up to k = 128
// (kxk_block.cuh), beyond that on the tensor cores in a cluster of blocks
// that share the matrices through distributed shared memory, or past k = 256
// in a device-memory scratch the wrapper allocates (kxk_refine.cuh); the warm
// starts live in device memory between iterations.  A factor row's
// normalisation runs in a cluster of eight blocks, each a share of the row,
// that add their sums through distributed shared memory, and every sum across
// blocks (Gram, row sums, cross, recon) is a set of partials added in the
// order of their index: no atomics, the same bits every run.
//
// Bound on the H100: two reads of A per iteration when A does not fit in L2
// (bytes); the 2 k m n operations of each product when it does.  The single
// block of k x k work, 15 products of k^3 for each refine, is a serial
// section that grows with k^3.

#include "cluster_gram.cuh"
#include "launch.cuh"
#include "kxk_block.cuh"
#include "kxk_refine.cuh"
#include "rhs_tall.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kLossThreads = 1024;


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

// A cluster of kRowBlocks blocks per factor row i (blockIdx.y), block c
// holding columns [c seg, (c + 1) seg) of it: out[i] = max(U[i], 0) /
// max(sum, 1e-15) with the sum over the clipped row (no clip unless nonneg),
// each block's share summed over its threads in a fixed tree and the shares
// added through distributed shared memory in the order of the blocks.  With
// d != null the clamped sum goes to d[i]; with saved != null, cross_row[i] =
// sum over the row of (scale out) saved, the row's share of the loss's cross
// term.  Row i of out also goes, prepared as the tall product's small
// operand, to row i of `small` (row stride lds, the columns from len to lds
// zero, planes of gridDim.y rows: rhs_tall::store_small).
constexpr int kRowBlocks = 8;

__global__ void __launch_bounds__(kRowThreads)
    row_normalize_kernel(const float* __restrict__ U, float* __restrict__ out,
                         int len, int nonneg, float* __restrict__ d,
                         const float* __restrict__ saved,
                         float* __restrict__ cross_row, void* __restrict__ small,
                         int lds, int bf16) {
  __shared__ float scratch[kRowThreads];
  __shared__ float share[2];   // the block's sum and cross term
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.y;
  const int seg = (len + kRowBlocks - 1) / kRowBlocks;
  const int r0 = c * seg, r1 = min(len, r0 + seg);
  const size_t base = static_cast<size_t>(row) * len;
  const size_t at = static_cast<size_t>(row) * lds;
  const size_t plane = static_cast<size_t>(gridDim.y) * lds;
  float s = 0.f;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    float v = U[base + r];
    if (nonneg) v = fmaxf(v, 0.f);
    s += v;
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) share[0] = s;
  cluster.sync();
  float total = 0.f;
  for (int b = 0; b < kRowBlocks; ++b)
    total += *cluster.map_shared_rank(&share[0], b);
  const float scale = fmaxf(total, 1e-15f);
  float x = 0.f;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    float v = U[base + r];
    if (nonneg) v = fmaxf(v, 0.f);
    const float w = v / scale;
    out[base + r] = w;
    rhs_tall::store_small(w, small, at + r, plane, bf16 != 0);
    if (saved != nullptr) x += (scale * w) * saved[base + r];
  }
  if (c == kRowBlocks - 1) {
    for (int r = len + threadIdx.x; r < lds; r += blockDim.x)
      rhs_tall::store_small(0.f, small, at + r, plane, bf16 != 0);
  }
  if (saved != nullptr) {
    x = block_sum(x, scratch);
    if (threadIdx.x == 0) share[1] = x;
  }
  cluster.sync();
  if (c == 0 && threadIdx.x == 0) {
    if (saved != nullptr) {
      float cross = 0.f;
      for (int b = 0; b < kRowBlocks; ++b)
        cross += *cluster.map_shared_rank(&share[1], b);
      cross_row[row] = cross;
    }
    if (d != nullptr) d[row] = scale;
  }
  cluster.sync();   // no block leaves while block 0 reads its share
}

cudaError_t launch_row_normalize(const float* U, float* out, int len,
                                 int nonneg, float* d, const float* saved,
                                 float* cross_row, void* small, int lds,
                                 int bf16, int rows, cudaStream_t stream) {
  return launch::clustered(row_normalize_kernel, dim3(kRowBlocks, rows),
                           dim3(kRowThreads), 0, stream, kRowBlocks, U, out,
                           len, nonneg, d, saved, cross_row, small, lds, bf16);
}

// One block.  hist[it] = tr(A^T A) - 2 cross + recon with cross the sum of
// cross_row and recon = sum_ij (d_i d_j) (W W^T)_ij Gw_ij, W W^T the sum of
// the Gram partials P in index order.
__global__ void __launch_bounds__(kLossThreads)
    loss_kernel(const float* __restrict__ P, int splits, int k,
                const float* __restrict__ g_free, const float* __restrict__ d,
                const float* __restrict__ cross_row,
                const float* __restrict__ trata, float* __restrict__ hist,
                int it) {
  __shared__ float scratch[kLossThreads];
  const int kk = k * k;
  float local = 0.f;
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const float gram = kxk::sum_partials(P, kk, e, splits);
    local += (d[e / k] * d[e % k]) * gram * g_free[e];
  }
  const float recon = block_sum(local, scratch);
  if (threadIdx.x == 0) {
    float cross = 0.f;
    for (int i = 0; i < k; ++i) cross += cross_row[i];
    hist[it] = trata[0] - 2.f * cross + recon;
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
// starts.  kxk_scratch is null while a block or a cluster holds the k x k
// section in shared memory, else four matrices (kxk_refine.cuh).  `offsets`
// (kBufferCount entries) places the buffers above in `work`; kSmallW holds W
// prepared on entry.  `plan` (rcppml_tpu_torch/ops/fused_als.py::_workspace)
// holds the blocks of W A and of H A^T (rhs_tall::launch_tall; each followed
// by a 0), the (partials, chunk) of W W^T and of H H^T, the k x k section's
// (ranks, rows, threads) and for W W^T and for H H^T 1 where the Gram is
// cluster_gram.cuh's (a partial a cluster), 0 where it is rhs_tall.cuh's FMA
// tile (a partial a split).  trata points to tr(A^T A) on the device.  *launched gets the
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
  const int kxk_ranks = plan[8], kxk_rows = plan[9], kxk_threads = plan[10];
  const bool cluster_gw = plan[11] != 0, cluster_gh = plan[12] != 0;
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
#define GRAM(F, len, splits, chunk, out, cluster)                           \
  ENQUEUED(cluster                                                          \
               ? cluster_gram::launch(F, k, len, splits, chunk, out, s)     \
               : rhs_tall::launch_small(F, len, F, len, true, out, k, k,    \
                                        len, splits, chunk, s))
#define REFINE(part, splits, l2, seed, ginv, g_free)                        \
  ENQUEUED(kxk_rows == 0                                                    \
               ? kxk_block::launch(part, splits, k, ridge_scale, l2, seed,  \
                                   ginv, g_free, ns_steps, s)               \
               : kxk::launch(part, splits, k, kxk_ranks, kxk_rows,          \
                             kxk_threads, ridge_scale, l2, seed, ginv,      \
                             g_free, ns_steps, kxk_scratch, s))

  // the first inverses, from the starting factors
  GRAM(W, m, s_gw, c_gw, buf[kPartGramW], cluster_gw);
  REFINE(buf[kPartGramW], s_gw, l2_h, 1, ginv_h, nullptr);
  GRAM(H, n, s_gh, c_gh, buf[kPartGramH], cluster_gh);
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
    ENQUEUED(launch_row_normalize(buf[kSolvedH], H, n, nonneg, nullptr,
                                  nullptr, nullptr, h_small, ldh, a_bf16, k,
                                  s));

    // W update
    GRAM(H, n, s_gh, c_gh, buf[kPartGramH], cluster_gh);
    REFINE(buf[kPartGramH], s_gh, l2_w, 0, ginv_w, buf[kGramFree]);
    ENQUEUED(rhs_tall::launch_tall(h_small, ldh, A, n, bf16, true,
                                   buf[kPartBw], k, m, n, b_trp, s));
    ENQUEUED(rhs_tall::launch_tall_reduce(
        buf[kPartBw], b_trp, k, m, n, bf16, l1_w, buf[kRhsW],
        l1_w != 0.f ? buf[kRhsWShifted] : nullptr, s));
    ENQUEUED(rhs_tall::launch_small(ginv_w, k, rhs_w, m, false,
                                    buf[kSolvedW], k, m, k, 1, k_chunk, s));
    ENQUEUED(launch_row_normalize(buf[kSolvedW], W, m, nonneg, d, buf[kRhsW],
                                  buf[kCrossRow], w_small, ldw, a_bf16, k,
                                  s));

    // saved-matrix Gram-trick loss
    GRAM(W, m, s_gw, c_gw, buf[kPartGramW], cluster_gw);
    loss_kernel<<<1, kLossThreads, 0, s>>>(buf[kPartGramW], s_gw, k,
                                           buf[kGramFree], d, buf[kCrossRow],
                                           trata, hist, it);
    ENQUEUED(cudaGetLastError());
  }
#undef REFINE
#undef GRAM
#undef ENQUEUED
  return static_cast<int>(cudaSuccess);
}
