// The one-triangle per-column weighted Gram tile of weighted_gram.cu
// (kernel 5) and wgram_rhs.cu (kernel 4), for sm_90a, on the tensor cores in
// 3xTF32.
//
//   Gb[j, k1, k2] = sum_r (F[k1, r] w[r, j]) F[k2, r]      (k1 <= k2 only)
//   b[k1, j]      = sum_r F[k1, r] (w[r, j] A[r, j])
//
// Two ways of getting w, one template parameter (kMode) apart.  Kernel 5
// (kMode 0) copies w from device memory with the stage.  Kernel 4 (kMode 1
// and 2) forms it in a prologue of every stage, for the stage's 32 rows and
// the block's columns, and never writes it out (fused_weights below):
//
//   mu[r, j] = sum_c F[c, r] X[c, j]       X's columns staged once a block;
//                                          F's k rows staged with the stage
//                                          in a ring of their own (kMode 1;
//                                          up to k = 16 the unit's rows at
//                                          k1 are all of F) or, where they
//                                          do not fit, read from device
//                                          memory (kMode 2)
//   w[r, j]  = irls_weight(mu, A[r, j], theta), 1 where A == 0 with
//              sparse_zeros, 0 past m and past bc
//
// and w * A is formed in registers where b's product reads it, as for
// kernel 5.  Kernel 4 also copies less: the zero rows of F past k only on
// the ring's first pass (nothing else writes them), and the diagonal
// unit's rows at k2 below 16 not at all (they are its rows at k1).  kMode 0
// compiles to kernel 5's code alone.
//
// Design (a) of the two that fit, per column: the A operand of m16n8k8 is
// F's rows k1 scaled in registers by w_j, the B operand F's rows k2, the
// reduction m.  Design (b), a Khatri-Rao operand F[k1, r] F[k2, r] generated
// in shared memory against w, reads w as a dense B tile but needs two loads
// of F per element of its A operand and B fragments for every column tile;
// (a) reads each fragment of F once for two columns and each scaled
// fragment once for four B tiles, about one shared-memory word a lane per
// product against 1.6 for (b), and a shared-memory word costs as much issue
// time as a product here.
//
// Units of work.  The Gram rows are cut into m16 tiles I (16 rows k1), the
// columns into n8 tiles J (8 rows k2).  Row tile I holds k1 >= 16 I, so it
// needs the J tiles with 8 J + 7 >= 16 I, that is J >= 2 I, in groups of up
// to four from J = 2 I: a triangle unit is (I, group).  At k = 128, 20 units of 4 or 2
// tiles compute 9,216 entries for the 8,256 that one triangle holds.  A warp
// owns one triangle unit and one pair of columns for the whole reduction:
// 2 x 4 accumulators of 16 x 8 in registers.  The warps of a unit's first
// group also carry b for their 16 rows and two columns (one more m16n8k8
// product with two of its eight columns used).
//
// A block is eight warps, kWt triangle units by kWc column pairs (kWc = 8
// wherever there are eight pairs of columns, at least 2), and loops over its
// split's share of m in stages of 32 rows: a ring of three stages in shared
// memory filled with 4-byte cp.async (F's rows and w's and A's columns lie at
// any 4-byte offset), each stage holding for every unit of the block its 16
// rows of F at k1 and 32 at k2, and for every column of the block 32 rows of
// w and of A.  3xTF32: x = hi + lo with hi = tf32(x) (tf32.cuh, shared with
// rhs_tall.cuh).  Once a stage has landed the block splits its rows at k2
// into TF32 high and low planes in place, so that the B fragments are read
// split (ldmatrix, one instruction for both parts of a fragment) and each is
// split once for the eight warps that read it; the A operand, F at k1 times
// w_j, is formed and split in registers.  The products a_lo b_hi + a_hi b_lo
// + a_hi b_hi of two stages are summed in the tensor cores and then added to
// a float32 accumulator in registers, so no tensor-core sum runs over more
// than 24 products (12 for kernel 4, which adds them every stage).  What bounds it, measured on an H100 at k = 128 and 68
// columns (tools/torch_wg5_variants.py): neither the tensor cores (a floor
// of 0.095 ms) nor the copies; the products (about 0.29 ms) and the rest of
// a stage (0.37) add up, each warp waiting on its own chain of loads and
// dependent instructions.
//
// Splits.  Where the units alone leave the card idle (at k = 128 and 68
// columns, 100 blocks for 132 multiprocessors), the reduction over m is cut
// into `splits` ranges (blockIdx.z); each writes its partial triangle, and
// reduce_kernel adds the partials in the order of their index and writes
// both triangles and b.  With one split the tile writes both itself.  Every
// entry is summed by one thread in one fixed order: no atomics, the same
// bits every run, and the two triangles equal by construction.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace tri_gram {

enum Mode { kGivenW = 0, kFusedStaged = 1, kFusedGlobal = 2 };
enum LossKind { kKl = 0, kPower = 1, kNb = 2 };
enum ThetaMode { kThetaNone = 0, kThetaRow = 1, kThetaCol = 2 };

// What kernel 4's prologue reads: X (k, bc) contiguous, theta per row (m,)
// or per column (bc,) or none, and the loss.
struct Fused {
  const float* X;
  const float* theta;
  int loss_kind, sparse_zeros, theta_mode;
  float power, w_cap;
};

// The IRLS weight of one entry (losses.compute_irls_weight):
//   kl:    1 / max(mu, 1e-4)
//   power: min(max(mu, 1e-15)^(-p), w_cap)
//   nb:    min(t / (mc (t + mc)), w_cap),  t = max(theta, 1e-10),
//                                          mc = max(mu, 1e-15)
__device__ __forceinline__ float irls_weight(float mu, const Fused& fz,
                                             float theta) {
  if (fz.loss_kind == kKl) return 1.f / fmaxf(mu, 1e-4f);
  const float mc = fmaxf(mu, 1e-15f);
  if (fz.loss_kind == kPower) {
    float w;
    if (fz.power == 2.f) {
      w = 1.f / (mc * mc);
    } else if (fz.power == 3.f) {
      w = 1.f / (mc * mc * mc);
    } else {
      w = powf(mc, -fz.power);
    }
    return fminf(w, fz.w_cap);
  }
  const float t = fmaxf(theta, 1e-10f);
  return fminf(t / (mc * (t + mc)), fz.w_cap);
}

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 32;           // rows of m a stage
constexpr int kLd = kDepth + 4;      // a staged row: fragment reads hit 32 banks
constexpr int kStages = 3;
constexpr int kGroup = 4;            // J tiles of a triangle unit
constexpr int kRowsI = 16;
constexpr int kRowsJ = 8 * kGroup;
constexpr int kUnitRows = kRowsI + kRowsJ;   // rows of F a unit stages

__host__ __device__ inline int row_tiles(int k) { return (k + 15) / 16; }
__host__ __device__ inline int col_tiles(int k) { return (k + 7) / 8; }

// groups of row tile I
__host__ __device__ inline int groups_of(int k, int I) {
  return (col_tiles(k) - 2 * I + kGroup - 1) / kGroup;
}

// triangle units of a k x k Gram
__host__ __device__ inline int triangle_units(int k) {
  int units = 0;
  for (int I = 0; I < row_tiles(k); ++I) units += groups_of(k, I);
  return units;
}

// rows of a unit's share of a stage: F at k1 and at k2 as copied (48, each
// at its lead), F at k2's TF32 high (32) and low (32) parts, aligned
constexpr int kUnitSlot = kRowsI + 3 * kRowsJ;
constexpr int kHi = kRowsI + kRowsJ;         // first row of the high parts
constexpr int kChunksF = kLd / 4;            // 16-byte copies a row of F
// row stride of the staged w and A: 2 kWc columns and room for the lead
__host__ __device__ constexpr int w_ld_staged(int wc) { return 2 * wc + 4; }

// floats of shared memory a stage takes: kWt units' rows of F, and w and A
// for 2 kWc columns
__host__ __device__ inline int stage_floats(int wc) {
  return (kWarps / wc) * kUnitSlot * kLd + 2 * kDepth * w_ld_staged(wc);
}

// rows of F kernel 4 stages for mu beside each stage (kMode 1): all k,
// except where a unit's 16 rows at k1 already are all of F
__host__ __device__ inline int mu_rows(int mode, int k) {
  return mode == kFusedStaged && k > kRowsI ? k : 0;
}

// bytes of dynamic shared memory of a block: kStages stages, then kernel 4's
// ring of F's rows for mu (kMode 1) and X's columns once (kMode 1, 2)
__host__ __device__ inline size_t shared_bytes(int wc, int mode, int k) {
  const size_t mu = static_cast<size_t>(mu_rows(mode, k)) * kLd;
  const size_t x = mode == kGivenW ? 0 : static_cast<size_t>(k) * 2 * wc;
  return sizeof(float) * (kStages * (stage_floats(wc) + mu) + x);
}

// cp.async of the 16 bytes at src, `bytes` (0..16) of them read, the rest
// zero
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The 16-byte copies that cover `floats` floats from p (4-byte aligned): chunk
// c of the row goes to dst + 16 c, so p's first float lands at its lead,
// (p mod 16) / 4 floats in; the chunks past the valid floats are zero.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const float* p,
                                           int floats, int c) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const char* aligned = reinterpret_cast<const char*>(at & ~uintptr_t{15});
  const int bytes = min(max(static_cast<int>(at & 15) + 4 * floats - 16 * c,
                            0), 16);
  copy16(dst + 16 * c, bytes > 0 ? aligned + 16 * c : aligned, bytes);
}

// four 8 x 4 float matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8 and receives element (i / 4, i % 4) of each
__device__ __forceinline__ void ldmatrix4(uint32_t (&v)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(addr));
}

// (I, first J tile, J tiles) of triangle unit u (u < triangle_units(k))
__device__ __forceinline__ void unit_tiles(int k, int u, int& I, int& J0,
                                           int& nJ) {
  I = 0;
  int g = groups_of(k, 0);
  while (u >= g) {
    u -= g;
    g = groups_of(k, ++I);
  }
  J0 = 2 * I + kGroup * u;
  nJ = min(kGroup, col_tiles(k) - J0);
}

// Kernel 4's prologue of one stage: w for the stage's rows [r0, r0 +
// valid) and the block's columns [col0, col0 + cols), into Ws (row stride
// kLdW, no lead).  Thread tid < kDepth kWc / 2 owns rows 2 (tid / kWc) and
// the next, columns 2 (tid % kWc) and the next: four sums a thread, two
// loads of F and one of X for four multiply-adds; mu sums c = 0..k-1 in
// order.  Fm: the stage's rows of F (row stride kLd, row f at its lead,
// kMode 1: F's own ring, or for k <= 16 the unit's rows at k1) or F itself
// at row r0 (kMode 2); Xs[c][2 kWc]: X's columns; As: the staged A (row
// stride kLdW, row r at its lead).  Row c's lead is (f_lead0 + c m) mod 4,
// so it repeats every four rows: the loop takes F's rows four at a time at
// four fixed offsets.
template <int kWc, int kMode>
__device__ __forceinline__ void fused_weights(
    const float* Fm, const float* Xs, const float* As, float* Ws,
    const Fused& fz, int k, int m, int bc, int r0, int valid, int col0,
    int f_lead0, uintptr_t a_word, long long a_ld, int tid) {
  constexpr int kLdW = w_ld_staged(kWc);
  if (tid >= kDepth / 2 * kWc) return;
  const int r = 2 * (tid / kWc), cp = tid % kWc;
  float mu[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const float2* x2 = reinterpret_cast<const float2*>(Xs) + cp;
  if (r < valid) {
    if constexpr (kMode == kFusedStaged) {
      int off[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        off[i] = i * kLd + ((f_lead0 + i * (m & 3)) & 3) + r;
      const int k4 = k / 4 * 4;
      for (int c = 0; c < k4; c += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* f = Fm + c * kLd + off[i];
          const float2 x = x2[(c + i) * kWc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mu[h][0] = fmaf(f[h], x.x, mu[h][0]);
            mu[h][1] = fmaf(f[h], x.y, mu[h][1]);
          }
        }
      }
      for (int c = k4; c < k; ++c) {
        const float* f = Fm + c * kLd + ((f_lead0 + c * (m & 3)) & 3) + r;
        const float2 x = x2[c * kWc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mu[h][0] = fmaf(f[h], x.x, mu[h][0]);
          mu[h][1] = fmaf(f[h], x.y, mu[h][1]);
        }
      }
    } else {
      const bool second = r + 1 < valid;
#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        const float* f = Fm + static_cast<size_t>(c) * m + r;
        const float f0 = __ldg(f), f1 = second ? __ldg(f + 1) : 0.f;
        const float2 x = x2[c * kWc];
        mu[0][0] = fmaf(f0, x.x, mu[0][0]);
        mu[0][1] = fmaf(f0, x.y, mu[0][1]);
        mu[1][0] = fmaf(f1, x.x, mu[1][0]);
        mu[1][1] = fmaf(f1, x.y, mu[1][1]);
      }
    }
  }
  const int j = col0 + 2 * cp;
  float thc[2] = {0.f, 0.f};
  if (fz.theta_mode == kThetaCol) {
    if (j < bc) thc[0] = fz.theta[j];
    if (j + 1 < bc) thc[1] = fz.theta[j + 1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + h;
    const bool row_ok = rr < valid;
    const float thr =
        fz.theta_mode == kThetaRow && row_ok ? fz.theta[r0 + rr] : 0.f;
    const int lead_a = static_cast<int>((a_word + rr * a_ld) & 3);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = As[rr * kLdW + lead_a + 2 * cp + e];
      float w = irls_weight(mu[h][e], fz,
                            fz.theta_mode == kThetaCol ? thc[e] : thr);
      if (fz.sparse_zeros && a == 0.f) w = 1.f;
      Ws[rr * kLdW + 2 * cp + e] = row_ok && j + e < bc ? w : 0.f;
    }
  }
}

// grid (ceil(units / kWt), ceil(column pairs / kWc), splits), kThreads
// threads, shared_bytes(kWc, kMode, k) bytes of dynamic shared memory.
// Split z sums rows [z chunk, min(m, (z + 1) chunk)).  With splits == 1 the
// Gram goes to G (bc, k, k), both triangles, and b to b (k, bc); else the
// entries k1 <= k2 go to G + z bc k k and b to b + z k bc, for reduce_kernel.
// kMode 0 reads w (row stride w_ld) and ignores fz; kMode 1 and 2 read
// neither w nor w_ld.  kJ: the J tiles a unit may hold, kGroup, or 2 where
// k <= 16 (one unit of two tiles), which halves the accumulators.
template <int kWc, int kMode = kGivenW, int kJ = kGroup>
__global__ void __launch_bounds__(kThreads, 2)
    tile_kernel(const float* __restrict__ F, const float* __restrict__ w,
                const float* __restrict__ A, float* __restrict__ G,
                float* __restrict__ b, int k, int m, int bc, long long w_ld,
                long long a_ld, int chunk, Fused fz) {
  constexpr int kWt = kWarps / kWc;
  constexpr int kCols = 2 * kWc;
  constexpr int kLdW = w_ld_staged(kWc);
  constexpr int kChunksW = kCols / 4 + 1;
  constexpr int kFRows = kWt * kUnitSlot;
  constexpr int kStage = kFRows * kLd + 2 * kDepth * kLdW;
  constexpr bool kFusedW = kMode != kGivenW;
  extern __shared__ __align__(16) float smem[];
  __shared__ int unit_row[kWt][2];   // first row of F at k1 and at k2

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int units = triangle_units(k);
  const int u0 = blockIdx.x * kWt;
  const int col0 = blockIdx.y * kCols;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(m, r_begin + chunk);
  const size_t sm = static_cast<size_t>(m);
  const int cols = min(kCols, bc - col0);

  if (tid < kWt) {
    int I = 0, J0 = 0, nJ = 0;
    if (u0 + tid < units) unit_tiles(k, u0 + tid, I, J0, nJ);
    unit_row[tid][0] = u0 + tid < units ? 16 * I : k;
    unit_row[tid][1] = u0 + tid < units ? 8 * J0 : k;
  }
  __syncthreads();

  // kernel 4: the ring of F's rows for mu after the stages, then X's
  // columns of the block, once, zero past bc (the first stage's barrier
  // orders these stores before every read)
  const int fm_rows = mu_rows(kMode, k);
  float* Fms = smem + kStages * kStage;
  float* Xs = Fms + kStages * fm_rows * kLd;
  if constexpr (kFusedW) {
    for (int e = tid; e < k * kCols; e += kThreads) {
      const int c = e / kCols, j = col0 + e % kCols;
      Xs[e] = j < bc ? fz.X[static_cast<size_t>(c) * bc + j] : 0.f;
    }
  }

  // this warp's unit and columns
  const int wu = warp / kWc;
  const int cpair = warp % kWc;
  int I = 0, J0 = 0, nJ = 0;
  const bool active = u0 + wu < units && col0 + 2 * cpair < bc;
  if (active) unit_tiles(k, u0 + wu, I, J0, nJ);
  const bool carries_b = active && J0 == 2 * I;

  // where a row's first float lands in its staged row (r0 is a multiple of
  // 32, so a row's lead is the same at every stage): row f of F, row r of w
  // or A
  const uintptr_t f_word = reinterpret_cast<uintptr_t>(F) / 4;
  auto f_lead = [&](int f) {
    return static_cast<int>((f_word + static_cast<size_t>(f) * sm) & 3);
  };
  const int lead_i0 = f_lead(16 * I + g), lead_i1 = f_lead(16 * I + g + 8);
  const uintptr_t w_word = reinterpret_cast<uintptr_t>(w + col0) / 4;
  const uintptr_t a_word = reinterpret_cast<uintptr_t>(A + col0) / 4;
  // kernel 4 forms w in place, at no lead
  const int lead_w0 = kFusedW ? 0 : static_cast<int>((w_word + t * w_ld) & 3);
  const int lead_w1 =
      kFusedW ? 0 : static_cast<int>((w_word + (t + 4) * w_ld) & 3);
  const int lead_a0 = static_cast<int>((a_word + t * a_ld) & 3);
  const int lead_a1 = static_cast<int>((a_word + (t + 4) * a_ld) & 3);

  // one stage of rows [r0, r0 + kDepth) into slot `slot`: the 16-byte
  // chunks of the rows of F at k1 and k2 of every unit, then of w's and A's
  // rows
  auto issue = [&](int r0, int slot) {
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem + slot * kStage));
    const int valid = min(kDepth, r_end - r0);
    // kernel 4 copies the zero rows past k on the ring's first pass only
    // (nothing else writes them), and takes the diagonal unit's rows at k2
    // below 16 from its rows at k1, the same rows of F
    const bool first_pass = r0 < r_begin + kStages * kDepth;
    for (int e = tid; e < kWt * kHi * kChunksF; e += kThreads) {
      const int row = e / kChunksF, c = e % kChunksF;
      const int u = row / kHi, q = row % kHi;
      const int f = q < kRowsI ? unit_row[u][0] + q
                               : unit_row[u][1] + q - kRowsI;
      if (kFusedW && ((f >= k && !first_pass) ||
                      (q >= kRowsI && q < 2 * kRowsI &&
                       unit_row[u][1] == unit_row[u][0])))
        continue;
      copy_chunk(base + 4 * (u * kUnitSlot + q) * kLd,
                 f < k ? F + f * sm + r0 : F, f < k ? valid : 0, c);
    }
    const uint32_t w_base = base + 4 * kFRows * kLd;
    // kernel 4 copies A's rows only, and every row of F for mu
    constexpr int kFirstRow = kFusedW ? kDepth : 0;
    for (int e = tid; e < (2 * kDepth - kFirstRow) * kChunksW;
         e += kThreads) {
      const int row = kFirstRow + e / kChunksW, c = e % kChunksW;
      const int r = row % kDepth;
      const bool is_a = row >= kDepth;
      const long long at = (r0 + r) * (is_a ? a_ld : w_ld) + col0;
      copy_chunk(w_base + 4 * row * kLdW, (is_a ? A : w) + at,
                 r < valid ? cols : 0, c);
    }
    if constexpr (kMode == kFusedStaged) {
      const uint32_t f_base = static_cast<uint32_t>(
          __cvta_generic_to_shared(Fms + slot * fm_rows * kLd));
      for (int e = tid; e < fm_rows * kChunksF; e += kThreads) {
        const int f = e / kChunksF, c = e % kChunksF;
        copy_chunk(f_base + 4 * f * kLd, F + f * sm + r0, valid, c);
      }
    }
  };

  static_assert(kJ >= 1 && kJ <= kGroup, "J tiles a unit");
  float acc[2][kJ][4], part[2][kJ][4], acc_b[4], part_b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc_b[q] = part_b[q] = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int jt = 0; jt < kJ; ++jt) acc[c][jt][q] = part[c][jt][q] = 0.f;
  }

  // ldmatrix addresses of F at k2, relative to a slot: lane i reads row
  // i % 8 at column 4 ((i / 8) % 2) of a k8 step of the high (i < 16) or low
  // plane
  const int q8 = lane / 8, r8 = lane % 8;
  const uint32_t b_off = 4 * ((wu * kUnitSlot + kHi + kRowsJ * (q8 / 2) + r8) *
                              kLd + 4 * (q8 % 2));

  const int n_stages = r_end > r_begin ? (r_end - r_begin + kDepth - 1) / kDepth
                                       : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue(r_begin + s * kDepth, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int st = 0; st < n_stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();   // the stage has landed, and the slot refilled below
                       // was read by every warp at st - 1
    const int next = st + kStages - 1;
    if (next < n_stages) issue(r_begin + next * kDepth, next % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // F at k2, as copied, into its TF32 high and low parts, aligned
    float* slot = smem + (st % kStages) * kStage;
#pragma unroll
    for (int i = 0; i < kWt * kRowsJ / kWarps; ++i) {
      const int row = warp + kWarps * i;
      const int u = row / kRowsJ, jr = row % kRowsJ;
      float* unit = slot + u * kUnitSlot * kLd;
      // kernel 4: the diagonal unit's rows at k2 below 16 are its rows at k1
      const int src = kFusedW && jr < kRowsI &&
                              unit_row[u][1] == unit_row[u][0]
                          ? jr : kRowsI + jr;
      const float x = unit[src * kLd + f_lead(unit_row[u][1] + jr) + lane];
      const uint32_t hi = tf32::round(x);
      unit[(kHi + jr) * kLd + lane] = __uint_as_float(hi);
      unit[(kHi + kRowsJ + jr) * kLd + lane] =
          __uint_as_float(tf32::low(x, hi));
    }
    if constexpr (kFusedW) {
      const int r0 = r_begin + st * kDepth;
      const float* fm = kMode == kFusedGlobal ? F + r0
                        : fm_rows > 0 ? Fms + (st % kStages) * fm_rows * kLd
                                      : slot;
      fused_weights<kWc, kMode>(
          fm, Xs, slot + kFRows * kLd + kDepth * kLdW, slot + kFRows * kLd,
          fz, k, m, bc, r0, min(kDepth, r_end - r0), col0, f_lead(0), a_word,
          a_ld, tid);
    }
    __syncthreads();
    if (!active) continue;

    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(slot));
    const float* Fi = slot + wu * kUnitSlot * kLd;
    const float* Ws = slot + kFRows * kLd + 2 * cpair;
    const float* As = Ws + kDepth * kLdW;
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      const int r = 8 * ks + t;
      const float f[4] = {Fi[g * kLd + lead_i0 + r],
                          Fi[(g + 8) * kLd + lead_i1 + r],
                          Fi[g * kLd + lead_i0 + r + 4],
                          Fi[(g + 8) * kLd + lead_i1 + r + 4]};
      float wv[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        wv[c][0] = Ws[r * kLdW + lead_w0 + c];
        wv[c][1] = Ws[(r + 4) * kLdW + lead_w1 + c];
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = f[q] * wv[c][q / 2];
          ah[c][q] = tf32::round(a);
          al[c][q] = __float_as_uint(a - __uint_as_float(ah[c][q]));
        }
#pragma unroll
      for (int jt = 0; jt < kJ; ++jt) {
        if (jt >= nJ) break;
        uint32_t x[4];   // b0 and b1, high then low
        ldmatrix4(x, base + b_off + 4 * 8 * jt * kLd + 32 * ks);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tf32::mma(part[c][jt], al[c], x[0], x[1]);
          tf32::mma(part[c][jt], ah[c], x[2], x[3]);
          tf32::mma(part[c][jt], ah[c], x[0], x[1]);
        }
      }
      if (carries_b) {
        // A operand F's rows k1; B operand w * A, columns 0 and 1 of eight
        uint32_t fh[4], fl[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fh[q] = tf32::round(f[q]);
          fl[q] = __float_as_uint(f[q] - __uint_as_float(fh[q]));
        }
        float x0 = 0.f, x1 = 0.f;
        if (g < 2) {
          x0 = (g == 0 ? wv[0][0] : wv[1][0]) * As[r * kLdW + lead_a0 + g];
          x1 = (g == 0 ? wv[0][1] : wv[1][1]) *
               As[(r + 4) * kLdW + lead_a1 + g];
        }
        const uint32_t bh0 = tf32::round(x0), bh1 = tf32::round(x1);
        const uint32_t bl0 = tf32::low(x0, bh0);
        const uint32_t bl1 = tf32::low(x1, bh1);
        tf32::mma(part_b, fl, bh0, bh1);
        tf32::mma(part_b, fh, bl0, bl1);
        tf32::mma(part_b, fh, bh0, bh1);
      }
    }
    // every second stage, and at the last, the tensor-core sums into the
    // float32 accumulators; kernel 4 every stage: its IRLS fits feed each
    // Gram to the next weight, and the halved tensor-core sums (12 products
    // a stage) halve how far the KL fit's loss history strays from the
    // default path's (1.0e-3 -> 5.4e-4 at pbmc3k k=16, and faster:
    // tools/torch_k46_variants.py flush2 against base)
    if (!kFusedW && st % 2 == 0 && st + 1 < n_stages) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc_b[q] += part_b[q];
      part_b[q] = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int jt = 0; jt < kJ; ++jt) {
          acc[c][jt][q] += part[c][jt][q];
          part[c][jt][q] = 0.f;
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!active) return;
  // part[c][jt][q] is entry (k1, k2) = (16 I + g + 8 (q / 2),
  // 8 (J0 + jt) + 2 t + q % 2) of column 2 cpair + c
  const size_t kk = static_cast<size_t>(k) * k;
  const bool direct = gridDim.z == 1;
  float* Gz = G + (direct ? 0 : blockIdx.z * static_cast<size_t>(bc) * kk);
  float* bz = b + (direct ? 0 : blockIdx.z * static_cast<size_t>(k) * bc);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = col0 + 2 * cpair + c;
    if (j >= bc) continue;
    float* Gj = Gz + j * kk;
#pragma unroll
    for (int jt = 0; jt < kJ; ++jt) {
      if (jt >= nJ) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k1 = 16 * I + g + 8 * (q / 2);
        const int k2 = 8 * (J0 + jt) + 2 * t + q % 2;
        if (k1 > k2 || k2 >= k) continue;
        Gj[static_cast<size_t>(k1) * k + k2] = acc[c][jt][q];
        if (direct) Gj[static_cast<size_t>(k2) * k + k1] = acc[c][jt][q];
      }
    }
  }
  if (carries_b && t == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k1 = 16 * I + g + 8 * (q / 2);
      const int j = col0 + 2 * cpair + q % 2;
      if (k1 < k && j < bc) bz[static_cast<size_t>(k1) * bc + j] = acc_b[q];
    }
  }
}

// Gb (bc, k, k) and b (k, bc) from the splits' partials (P (splits, bc, k,
// k), triangle k1 <= k2; Pb (splits, k, bc)), each the sum of its partials
// in the order of their index; both triangles from the same sum.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ P, const float* __restrict__ Pb,
                  float* __restrict__ Gb, float* __restrict__ b, int k,
                  int bc, int splits) {
  const size_t kk = static_cast<size_t>(k) * k;
  const size_t n_g = static_cast<size_t>(bc) * kk;
  const size_t n_b = static_cast<size_t>(k) * bc;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_g + n_b; e += stride) {
    if (e < n_g) {
      const size_t j = e / kk, rem = e % kk;
      const int k1 = static_cast<int>(rem / k), k2 = static_cast<int>(rem % k);
      const size_t at = j * kk + static_cast<size_t>(min(k1, k2)) * k +
                        max(k1, k2);
      float s = P[at];
      for (int z = 1; z < splits; ++z) s += P[z * n_g + at];
      Gb[e] = s;
    } else {
      const size_t at = e - n_g;
      float s = Pb[at];
      for (int z = 1; z < splits; ++z) s += Pb[z * n_b + at];
      b[at] = s;
    }
  }
}

}  // namespace tri_gram
