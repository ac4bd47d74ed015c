// One transposed column panel of a stream, built on the card from the dense
// forward panels it already holds, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's streaming engine decodes both of
// a .spz file's streams (A's columns and A's transpose) and uploads each.  A
// stream whose dense panel cache holds every forward panel
// (rcppml_tpu_torch/io/panels.py) already has all of A on the card, so each
// transposed panel is a copy out of it, in another layout, and the second
// decode, its uploads and its densify launches are not needed.
//
// Input: the forward panels F_0 .. F_{P-1}, each dense float32 (m, w_p)
// row-major, F_p holding A's columns [s_p, s_p + w_p) with s_0 = 0 and
// s_{p+1} = s_p + w_p, s_P = n; given as one int64 device table, the P
// panels' addresses then the P + 1 column starts.  Output: out (n, ncols)
// float32 row-major, the transposed panel whose columns are A's rows
// [row0, row0 + ncols):
//
//   out[r, c] = F_p[row0 + c, r - s_p]   for the p with s_p <= r < s_{p+1}.
//
// Every element is written once with the bits it was read with, so the
// result is the plain twin's (ops/transpose_panels.py::
// transpose_panels_plain) bit for bit.
//
// Design: a block moves a tile of 32 output rows (forward columns) by 32
// output columns (forward rows) through shared memory, stored [c][r] with a
// row stride of 33 floats.  Loads run along a forward panel's row and
// stores along an output row, both coalesced.  With kVec = 4 (every forward
// width and ncols a multiple of 4, every address 16-byte aligned: the
// wrapper decides) each thread moves one float4 each way: eight threads
// cover a 128-byte row segment, the warp four rows; the shared stores
// [c][4q + i] and the shared loads [4q + j][r] meet 32 distinct banks
// (33 = 1 mod 32).  Four consecutive forward columns then lie in one panel,
// since every s_p is a multiple of 4.  With kVec = 1 a warp moves a row of
// 32 floats a step.  Each thread finds its panel once, by a binary search
// of the starts.
//
// Bound on the H100: bytes, the panel read once from the forward panels and
// written once: 2 x 80 MB for a 40,000 x 512 panel, about 49 us at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

// the panel p with starts[p] <= r < starts[p + 1]
__device__ __forceinline__ int panel_of(const long long* __restrict__ starts,
                                        int npanels, long long r) {
  int lo = 0, hi = npanels - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= r)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const long long* __restrict__ table, int npanels, int n,
                 int row0, int ncols, float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];   // [c][r]
  const long long* starts = table + npanels;
  const int r0 = blockIdx.x * kTile;   // output rows: forward columns
  const int c0 = blockIdx.y * kTile;   // output columns: forward rows - row0
  const int t = threadIdx.x;
  if (kVec == 4) {
    const int q = t & 7;
    const int row = t >> 3;
    const int r = r0 + 4 * q;
    const int c = c0 + row;
    if (r < n && c < ncols) {
      const int p = panel_of(starts, npanels, r);
      const long long s = starts[p];
      const long long w = starts[p + 1] - s;
      const float* F = reinterpret_cast<const float*>(table[p]);
      const float4 v = *reinterpret_cast<const float4*>(
          F + static_cast<size_t>(row0 + c) * w + (r - s));
      tile[row][4 * q] = v.x;
      tile[row][4 * q + 1] = v.y;
      tile[row][4 * q + 2] = v.z;
      tile[row][4 * q + 3] = v.w;
    }
    __syncthreads();
    const int r2 = r0 + row;
    const int c2 = c0 + 4 * q;
    if (r2 < n && c2 < ncols) {
      const float4 v = make_float4(tile[4 * q][row], tile[4 * q + 1][row],
                                   tile[4 * q + 2][row], tile[4 * q + 3][row]);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(r2) * ncols + c2) =
          v;
    }
  } else {
    const int x = t & 31;
    const int y = t >> 5;
    const int r = r0 + x;
    if (r < n) {
      const int p = panel_of(starts, npanels, r);
      const long long s = starts[p];
      const long long w = starts[p + 1] - s;
      const float* F = reinterpret_cast<const float*>(table[p]) + (r - s);
      for (int row = y; row < kTile; row += kThreads / 32) {
        const int c = c0 + row;
        if (c < ncols) tile[row][x] = F[static_cast<size_t>(row0 + c) * w];
      }
    }
    __syncthreads();
    const int c = c0 + x;
    if (c < ncols) {
      for (int row = y; row < kTile; row += kThreads / 32) {
        const int r2 = r0 + row;
        if (r2 < n) out[static_cast<size_t>(r2) * ncols + c] = tile[x][row];
      }
    }
  }
}

}  // namespace

// table: int64, npanels forward panel addresses then npanels + 1 column
// starts (starts[npanels] = n); out float32 (n, ncols); vec 4 or 1 (from
// rcppml_tpu_torch/ops/transpose_panels.py::panel_table).  Returns the
// launch's CUDA error (0: launched).
extern "C" int transpose_panels_launch(const long long* table, int npanels,
                                       int n, int row0, int ncols, int vec,
                                       float* out, void* stream) {
  if (npanels <= 0 || n <= 0 || ncols <= 0 || row0 < 0 ||
      (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTile - 1) / kTile, (ncols + kTile - 1) / kTile);
  if (vec == 4)
    transpose_kernel<4><<<grid, kThreads, 0, s>>>(table, npanels, n, row0,
                                                  ncols, out);
  else
    transpose_kernel<1><<<grid, kThreads, 0, s>>>(table, npanels, n, row0,
                                                  ncols, out);
  return static_cast<int>(cudaGetLastError());
}
