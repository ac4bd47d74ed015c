// A sparse column panel's compact triples -> the dense float32 panel, for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package's streaming engine leaves this
// scatter to XLA (rcppml_tpu/models/nmf_chunked.py::_coo_densify).  It exists
// for device memory.  The plain PyTorch densify
// (rcppml_tpu_torch/ops/coo_densify.py::coo_densify_plain) holds int64 column
// ids, an int64 flat index with its intermediates and a float32 copy of the
// values beside the panel, 60 to 85 MiB for a 40,000 x 512 panel of 3.4M
// entries, and a stream that keeps its dense panels on the card densifies
// its last panel when that cache is full.  This kernel reads the triples as
// they come off the wire and writes the panel, and allocates nothing.
//
// Input, one panel of nrows x ncols in canonical CSC order (each (row,
// column) at most once): rows (uint16, the wire's int16 view, or int32) and
// vals (uint8, uint16 or float32), each nnz long, and per-column counts
// (int32, ncols).  Output: out (nrows, ncols) float32 row-major, every
// element written once: the entry's value converted to float (exact for
// uint8 and uint16, the same bits for float32), 0.0f elsewhere.  That is
// the twin's panel bit for bit.
//
// Design: a block owns a tile of kCols columns by tile_rows rows in shared
// memory (column-major, row stride ld, ld = 4 mod 32).  Its threads first
// sum counts[0, c0) for the entry offset of its first column; then zero the
// tile; then warp w walks column c0 + w's entries 32 at a time and writes
// those whose row falls in the tile (consecutive lanes on a column's
// consecutive entries: the rows and values are read coalesced, the tile
// writes land on distinct banks as the rows spread); then the tile leaves
// with consecutive threads on a row's consecutive columns, 32-byte runs
// whose neighbours are the neighbouring column group's blocks (blockIdx.x),
// so L2 sees whole lines.  The rows of a column need not be sorted: every
// row tile of a column group reads all of the group's entries, so the
// triples are read ceil(nrows / tile_rows) times, from L2 (a panel's
// triples are a few MB).
//
// Bound on the H100: bytes, one write of the panel and one read of the
// triples: 80 MB + 10 MB for a 40,000 x 512 panel of 3.4M entries with uint16
// rows and uint8 values, about 27 us at 3.35 TB/s.  The tile's zeroing and
// write-out are the panel's bytes; the repeated reads of the triples come
// from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                      // columns of a block's tile
constexpr int kThreads = 32 * kCols;          // a warp a column
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float value_of(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float value_of(uint16_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float value_of(float v) { return v; }

template <typename RowT, typename ValT>
__global__ void __launch_bounds__(kThreads)
densify_kernel(const RowT* __restrict__ rows,
               const int32_t* __restrict__ counts,
               const ValT* __restrict__ vals, int nrows, int ncols,
               int tile_rows, int ld, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  __shared__ long long warp_sums[kCols];
  __shared__ long long starts[kCols + 1];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * tile_rows;
  const int nr = min(tile_rows, nrows - r0);
  const int nc = min(kCols, ncols - c0);

  // the entry offset of column c0: counts[0, c0) summed by the block
  long long part = 0;
  for (int c = t; c < c0; c += kThreads) part += counts[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(kFull, part, off);
  if (lane == 0) warp_sums[warp] = part;
  // the tile zeroed meanwhile (ld * kCols is a multiple of 4)
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = t; i < ld * kCols / 4; i += kThreads) smem4[i] = zero;
  __syncthreads();
  if (t == 0) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kCols; ++w) s += warp_sums[w];
    starts[0] = s;
    for (int j = 0; j < kCols; ++j)
      starts[j + 1] = starts[j] + (j < nc ? counts[c0 + j] : 0);
  }
  __syncthreads();

  // warp w: column c0 + w's entries whose row lies in [r0, r0 + nr)
  if (warp < nc) {
    float* col = tile + static_cast<size_t>(warp) * ld;
    const long long end = starts[warp + 1];
    for (long long e = starts[warp] + lane; e < end; e += 32) {
      const unsigned i = static_cast<unsigned>(static_cast<int>(rows[e]) - r0);
      if (i < static_cast<unsigned>(nr)) col[i] = value_of(vals[e]);
    }
  }
  __syncthreads();

  // out: consecutive threads on a row's consecutive columns
  for (int idx = t; idx < nr * kCols; idx += kThreads) {
    const int i = idx / kCols;
    const int j = idx % kCols;
    if (j < nc)
      out[static_cast<size_t>(r0 + i) * ncols + c0 + j] =
          tile[static_cast<size_t>(j) * ld + i];
  }
}

template <typename RowT, typename ValT>
cudaError_t launch(const void* rows, const int32_t* counts, const void* vals,
                   int nrows, int ncols, int tile_rows, int ld, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(ld) * kCols;
  cudaError_t err = cudaFuncSetAttribute(
      densify_kernel<RowT, ValT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((ncols + kCols - 1) / kCols,
                  (nrows + tile_rows - 1) / tile_rows);
  densify_kernel<RowT, ValT><<<grid, kThreads, smem, stream>>>(
      static_cast<const RowT*>(rows), counts, static_cast<const ValT*>(vals),
      nrows, ncols, tile_rows, ld, out);
  return cudaGetLastError();
}

template <typename RowT>
cudaError_t launch_rows(const void* rows, const int32_t* counts,
                        const void* vals, int val_kind, int nrows, int ncols,
                        int tile_rows, int ld, float* out,
                        cudaStream_t stream) {
  switch (val_kind) {
    case 0:
      return launch<RowT, uint8_t>(rows, counts, vals, nrows, ncols,
                                   tile_rows, ld, out, stream);
    case 1:
      return launch<RowT, uint16_t>(rows, counts, vals, nrows, ncols,
                                    tile_rows, ld, out, stream);
    case 2:
      return launch<RowT, float>(rows, counts, vals, nrows, ncols, tile_rows,
                                 ld, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: uint16 (row_bytes 2) or int32 (4); vals: uint8 (val_kind 0), uint16
// (1) or float32 (2); counts int32 (ncols); out float32 (nrows, ncols).
// tile_rows and ld from rcppml_tpu_torch/ops/coo_densify.py::plan_coo_densify.
// Returns the launch's CUDA error (0: launched).
extern "C" int coo_densify_launch(const void* rows, int row_bytes,
                                  const int32_t* counts, const void* vals,
                                  int val_kind, int nrows, int ncols,
                                  int tile_rows, int ld, float* out,
                                  void* stream) {
  if (nrows <= 0 || ncols <= 0 || tile_rows <= 0 || ld < tile_rows ||
      ld % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_bytes == 2)
    err = launch_rows<uint16_t>(rows, counts, vals, val_kind, nrows, ncols,
                                tile_rows, ld, out, s);
  else if (row_bytes == 4)
    err = launch_rows<int32_t>(rows, counts, vals, val_kind, nrows, ncols,
                               tile_rows, ld, out, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
