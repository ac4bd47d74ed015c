// Tall-skinny products that read the large operand once, for sm_90a:
//   forward      C (k, J) = X (k, R) . Y (R, J)        (B = F . A)
//   transposed   C (k, J) = X (k, R) . Y (J, R)^T      (B = H . A^T, no
//                                                       transpose is made)
// The device code of rhs_tall.cu (kernels 7 and 8) and of the products inside
// fused_als.cu (kernel 3).
//
// Replaces the TPU kernels rcppml_tpu/ops/pallas_experiments.py::
// rhs_tall_pallas / rhs_tall_t_pallas and the rhs_fwd / rhs_trp bodies of
// rcppml_tpu/ops/pallas_kernels.py::_make_fused_als_vmem_kernel.  The TPU
// kernels walk the m axis as a sequential grid and keep the (k, n) output
// resident; here a block owns an output tile of up to 128 rows (all of k, so
// that Y is read from device memory once) by 64 columns, and where the output
// has too few column tiles to fill the card the reduction is split across
// blockIdx.y.  Each split writes its own partial sum; reduce_partials_kernel
// adds the partials in the order of their index.  No float atomics anywhere:
// the same bits every run.
//
// Y is float32 or bfloat16.  With a bfloat16 Y the small operand X is rounded
// to bfloat16 as it is loaded, as rcppml_tpu/ops/linalg.py::rhs does; the
// products of two bfloat16 values are exact in float32, so FMAs on the
// converted values with a float32 sum are a faithful counterpart of a
// bfloat16 matrix unit with float32 accumulation.
//
// Bound on the H100: one read of Y (bytes) at the main path's shapes; these
// are plain FMA tiles through shared memory (no tensor cores, no TMA), about
// one shared-memory load per two FMAs, so they sit nearer the float32 rate
// than the memory rate.
//
// k > 128 takes ceil(k / 128) passes over Y (blockIdx.z), each reading it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rhs_tall {

constexpr int kTX = 16;             // threads along the output columns
constexpr int kTY = 16;             // threads along the output rows
constexpr int kThreads = kTX * kTY;
constexpr int kCPT = 4;             // output columns per thread
constexpr int kBJ = kTX * kCPT;     // output columns per block
constexpr int kRT = 32;             // reduction depth of one shared tile
constexpr int kMaxRows = kTY * 8;   // output rows per pass

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One block's tile: rows i0 + [0, 16 KPT) of X against columns j0 + [0, 64)
// of the output, summed over the reduction range [r_begin, r_end).  Thread
// (tx, ty) owns rows ty + 16 a and columns tx + 16 b.  X is (k, R) with row
// stride ldx.  Y is (R, J) with row stride ldy, or with kTrans (J, R).
template <int KPT, typename YT, bool kTrans, bool kRoundX>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ X, int ldx, const YT* __restrict__ Y, int ldy,
    float* __restrict__ out, int ldo, int i0, int k, int j0, int J,
    int r_begin, int r_end) {
  __shared__ float Xs[kTY * KPT][kRT + 1];
  __shared__ float Ys[kRT][kBJ + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  float acc[KPT][kCPT];
#pragma unroll
  for (int a = 0; a < KPT; ++a)
#pragma unroll
    for (int b = 0; b < kCPT; ++b) acc[a][b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRT) {
    for (int e = tid; e < kTY * KPT * kRT; e += kThreads) {
      const int i = e / kRT, r = e % kRT;
      const int gi = i0 + i, gr = r0 + r;
      float v = 0.f;
      if (gi < k && gr < r_end) {
        v = X[static_cast<size_t>(gi) * ldx + gr];
        if (kRoundX) v = __bfloat162float(__float2bfloat16_rn(v));
      }
      Xs[i][r] = v;
    }
    for (int e = tid; e < kRT * kBJ; e += kThreads) {
      // neighbouring threads read neighbouring addresses of Y either way
      const int r = kTrans ? e % kRT : e / kBJ;
      const int j = kTrans ? e / kRT : e % kBJ;
      const int gr = r0 + r, gj = j0 + j;
      float v = 0.f;
      if (gr < r_end && gj < J) {
        v = to_float(kTrans ? Y[static_cast<size_t>(gj) * ldy + gr]
                            : Y[static_cast<size_t>(gr) * ldy + gj]);
      }
      Ys[r][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      float x[KPT], y[kCPT];
#pragma unroll
      for (int a = 0; a < KPT; ++a) x[a] = Xs[ty + kTY * a][r];
#pragma unroll
      for (int b = 0; b < kCPT; ++b) y[b] = Ys[r][tx + kTX * b];
#pragma unroll
      for (int a = 0; a < KPT; ++a)
#pragma unroll
        for (int b = 0; b < kCPT; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < KPT; ++a) {
    const int gi = i0 + ty + kTY * a;
#pragma unroll
    for (int b = 0; b < kCPT; ++b) {
      const int gj = j0 + tx + kTX * b;
      if (gi < k && gj < J) out[static_cast<size_t>(gi) * ldo + gj] = acc[a][b];
    }
  }
}

// grid (column tiles, splits, row passes); split s sums the reduction range
// [s chunk, (s + 1) chunk) and writes partial s, a (k, J) matrix at
// out + s k J.
template <int KPT, typename YT, bool kTrans, bool kRoundX>
__global__ void __launch_bounds__(kThreads)
    product_kernel(const float* __restrict__ X, int ldx,
                   const YT* __restrict__ Y, int ldy, float* __restrict__ out,
                   int k, int J, int R, int chunk) {
  const int s = blockIdx.y;
  const int r_begin = s * chunk;
  const int r_end = min(R, r_begin + chunk);
  tile_product<KPT, YT, kTrans, kRoundX>(
      X, ldx, Y, ldy, out + static_cast<size_t>(s) * k * J, J,
      blockIdx.z * kTY * KPT, k, blockIdx.x * kBJ, J, r_begin, r_end);
}

// raw[e] = P[0][e] + P[1][e] + ... in that order; shifted[e] = raw[e] - shift
// (raw[e] itself when shift == 0).  Either output may be null.
__global__ void reduce_partials_kernel(const float* __restrict__ P, int splits,
                                       size_t count, float shift,
                                       float* __restrict__ raw,
                                       float* __restrict__ shifted) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    float acc = P[e];
    for (int s = 1; s < splits; ++s) acc += P[s * count + e];
    if (raw != nullptr) raw[e] = acc;
    if (shifted != nullptr) shifted[e] = shift != 0.f ? acc - shift : acc;
  }
}

template <typename YT, bool kTrans, bool kRoundX>
inline cudaError_t launch_rows(const float* X, int ldx, const YT* Y, int ldy,
                               float* out, int k, int J, int R, int splits,
                               int chunk, cudaStream_t stream) {
  const int rows = k < kMaxRows ? k : kMaxRows;
  const int kpt =
      rows <= kTY ? 1 : rows <= 2 * kTY ? 2 : rows <= 4 * kTY ? 4 : 8;
  const dim3 grid((J + kBJ - 1) / kBJ, splits,
                  (k + kTY * kpt - 1) / (kTY * kpt));
  const dim3 block(kThreads);
  switch (kpt) {
    case 1:
      product_kernel<1, YT, kTrans, kRoundX><<<grid, block, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    case 2:
      product_kernel<2, YT, kTrans, kRoundX><<<grid, block, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    case 4:
      product_kernel<4, YT, kTrans, kRoundX><<<grid, block, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
    default:
      product_kernel<8, YT, kTrans, kRoundX><<<grid, block, 0, stream>>>(
          X, ldx, Y, ldy, out, k, J, R, chunk);
      break;
  }
  return cudaGetLastError();
}

// Enqueue one product: partial s of C = X . Y (or X . Y^T) goes to
// out + s k J.  The caller chooses the split (splits * chunk >= R, chunk a
// multiple of kRT) and reduces the partials.  y_bf16: Y holds bfloat16 and X
// is rounded to it.
inline cudaError_t launch_product(const float* X, int ldx, const void* Y,
                                  int ldy, bool y_bf16, bool trans, float* out,
                                  int k, int J, int R, int splits, int chunk,
                                  cudaStream_t stream) {
  if (k <= 0 || J <= 0 || R <= 0 || splits <= 0 || splits > 65535 ||
      chunk <= 0 || chunk % kRT != 0 ||
      static_cast<long long>(splits) * chunk < R) {
    return cudaErrorInvalidValue;
  }
  if (y_bf16) {
    const __nv_bfloat16* Yb = static_cast<const __nv_bfloat16*>(Y);
    return trans ? launch_rows<__nv_bfloat16, true, true>(
                       X, ldx, Yb, ldy, out, k, J, R, splits, chunk, stream)
                 : launch_rows<__nv_bfloat16, false, true>(
                       X, ldx, Yb, ldy, out, k, J, R, splits, chunk, stream);
  }
  const float* Yf = static_cast<const float*>(Y);
  return trans ? launch_rows<float, true, false>(X, ldx, Yf, ldy, out, k, J, R,
                                                 splits, chunk, stream)
               : launch_rows<float, false, false>(X, ldx, Yf, ldy, out, k, J,
                                                  R, splits, chunk, stream);
}

inline cudaError_t launch_reduce(const float* P, int splits, size_t count,
                                 float shift, float* raw, float* shifted,
                                 cudaStream_t stream) {
  const int threads = 256;
  size_t blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  reduce_partials_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      P, splits, count, shift, raw, shifted);
  return cudaGetLastError();
}

}  // namespace rhs_tall
