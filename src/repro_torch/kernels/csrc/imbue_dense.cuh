// imbue_dense.cuh: the body of the two dense-plane analog kernels,
// imbue_infer_packed.cu (packed literal words) and imbue_infer.cu (one
// byte a literal).  They differ only in how a block stages its literals.
//
// What they compute, per replica r, batch row b and clause c, over the
// clause's 32-cell CSA columns k (literals 32k .. 32k + 31):
//   i_col   = sum over the column's cells j = 0..31, in that order, of
//             lit ? leak[r, c, l] : v_read * g[r, c, l]     (l = 32k + j)
//             (cells past L add 0)
//   partial = i_col < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m].  The conductance g and the
// leak current are read as given, in the state's own [R, C, L] layout:
// the caller builds them (with the read's C2C draw) in the reference's op
// order.  Each column is summed exactly as imbue_infer_planes.cu sums it
// (one float32 accumulator per row, cells in order, v_read * g as
// __fmul_rn), so on the same plane-packed state read without C2C the
// three analog kernels give the same integers.
//
// Bound at imbue-tm-mnist (C = 2000, L = 1568, M = 10) and R = 4: the two
// float32 planes are 2 x 4 x 2000 x 1568 x 4 B = 100.4 MB, 30 us at
// 3.35 TB/s, whatever B is.  The work is 4 * R * B * C * L fp32
// operations (select, add, bit test and compare amortised): at B = 128
// 6.4 GFLOP, 96 us at 67 TFLOP/s, so bound by operations; at B = 8
// 0.4 GFLOP, 6 us, so bound by bytes.
//
// Design (the structure of imbue_infer_planes.cu):
// * One block per (32 batch rows, 64 clauses, replica); R is the grid's z
//   axis, so a whole stack is one launch.  Batch tiles are the fastest
//   grid axis, so blocks that share a clause tile's planes run together
//   and re-read them from L2.
// * One thread per clause.  For each column the block stages the clause
//   tile's [64, 32] cells of g and leak in shared memory from coalesced
//   loads (a warp reads one clause row's 128 contiguous bytes), padded to
//   33 floats a row so that a thread reading its own row hits 32 banks.
//   Each thread then holds its column's 32 (v_read * g, leak) pairs in
//   registers and reuses them for all 32 rows of its batch tile.
// * The tile's 64 loads a thread are issued together, and the next
//   column's are issued into registers before this column's sums, so
//   their latency hides behind the arithmetic (at small B a block is two
//   warps and load latency is what costs).
// * Literal words of the tile are staged in shared memory per 32-word
//   chunk and read as warp-wide broadcasts.  The byte kernel builds each
//   word from two 16-byte loads of its 32 bytes (bit 0 of each byte is
//   the literal), byte by byte only when L is not a multiple of 16.
// * The per-row AND is a 32-bit mask in a register; four rows are summed
//   at once for instruction-level parallelism.
// * Votes: a warp reduction per (row, class), added to the int32 output
//   with atomicAdd, exact in any order.
// * FP32 on the CUDA cores, never tensor cores or TF32: the thresholded
//   currents must be IEEE float32.  Build without --use_fast_math.
// * Later work: more warps per SM at small B (columns of one clause split
//   over threads, their partials ANDed), early exit for clauses already
//   dead, and rebuilding g and leak in the kernel instead of reading two
//   planes (which is what the planes kernel does).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace imbk {

constexpr int WORD = 32;       // cells per CSA column == literals per word
constexpr int CT = 64;         // clauses per block, one per thread
constexpr int BT = 32;         // batch rows per block, one bit of the mask
constexpr int KCH = 32;        // literal words staged in shared memory
constexpr int ILP = 4;         // rows summed together in the inner loop
constexpr int WARPS = CT / WORD;
constexpr int GS = WORD + 1;   // padded shared-memory row (floats)

// Four 0/1 bytes (bit 0 of each) -> four bits, byte q to bit q.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  v &= 0x01010101u;
  v |= v >> 7;
  v |= v >> 14;
  return v & 0xfu;
}

// The literal word of row `row`, column `col` of a [rows, L] byte matrix:
// bit j = bit 0 of byte 32 * col + j, bytes past L read as 0.  VEC: L is
// a multiple of 16 and the matrix 16-byte aligned, so two 16-byte loads.
template <bool VEC>
__device__ __forceinline__ uint32_t byte_word(const uint8_t* __restrict__ m,
                                              int row, int col, int L) {
  const uint8_t* p = m + static_cast<size_t>(row) * L + col * WORD;
  const int n = min(WORD, L - col * WORD);
  uint32_t w = 0u;
  if (VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w = nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
        nibble(a.w) << 12;
    if (n > 16) {
      const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
      w |= (nibble(b.x) | nibble(b.y) << 4 | nibble(b.z) << 8 |
            nibble(b.w) << 12) << 16;
    }
  } else {
    for (int j = 0; j < n; ++j) w |= static_cast<uint32_t>(p[j] & 1u) << j;
  }
  return w;
}

// This thread's share of column k's [64, 32] tile: row warp + WARPS * s,
// cell lane, for s = 0..31 (a warp reads one clause row per step).
__device__ __forceinline__ void load_column(
    const float* __restrict__ g, const float* __restrict__ leak,
    size_t plane, int c0, int k, int C, int L, float (&pg)[WORD],
    float (&pl)[WORD]) {
  const int lane = threadIdx.x & (WORD - 1);
  const int warp = threadIdx.x / WORD;
  const int l = k * WORD + lane;
#pragma unroll
  for (int s = 0; s < WORD; ++s) {
    const int cc = c0 + warp + WARPS * s;
    const bool ok = cc < C && l < L;
    const size_t off = plane + static_cast<size_t>(cc) * L + l;
    pg[s] = ok ? g[off] : 0.0f;
    pl[s] = ok ? leak[off] : 0.0f;
  }
}

// PACKED: lits is [B, Lw] int32 words (bit j of word k = literal 32k + j).
// Otherwise lits is [B, L] uint8, one 0/1 byte a literal; VEC as in
// byte_word.
template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(CT) imbue_dense_kernel(
    const void* __restrict__ lits_v,
    const float* __restrict__ g,        // [R, C, L] on-path conductance (S)
    const float* __restrict__ leak,     // [R, C, L] leak current (A)
    const int32_t* __restrict__ pol,    // [C, M] signed one-hot x nonempty
    int32_t* __restrict__ out,          // [R, B, M], zeroed by the caller
    int B, int L, int C, int M, float i_ref, float v_read) {
  __shared__ uint32_t lit_s[BT][KCH];
  __shared__ float g_s[CT][GS];
  __shared__ float lk_s[CT][GS];

  const int Lw = (L + WORD - 1) / WORD;
  const int b0 = blockIdx.x * BT;
  const int c0 = blockIdx.y * CT;
  const int c = c0 + threadIdx.x;
  const int r = blockIdx.z;
  const int nb = min(BT, B - b0);
  const bool c_ok = c < C;
  const int lane = threadIdx.x & (WORD - 1);
  const int warp = threadIdx.x / WORD;
  const size_t plane = static_cast<size_t>(r) * C * L;

  uint32_t alive = 0xffffffffu;   // bit i: clause still fires for row b0+i
  float pg[WORD], pl[WORD];       // the next column's cells, in flight
  load_column(g, leak, plane, c0, 0, C, L, pg, pl);

  for (int k0 = 0; k0 < Lw; k0 += KCH) {
    const int kn = min(KCH, Lw - k0);
    __syncthreads();                      // the last chunk has been read
#pragma unroll 8
    for (int i = threadIdx.x; i < BT * KCH; i += CT) {
      const int bi = i / KCH, ki = i % KCH;
      uint32_t w = 0u;
      if (bi < nb && ki < kn) {
        if (PACKED) {
          w = static_cast<uint32_t>(static_cast<const int32_t*>(
              lits_v)[static_cast<size_t>(b0 + bi) * Lw + k0 + ki]);
        } else {
          w = byte_word<VEC>(static_cast<const uint8_t*>(lits_v), b0 + bi,
                             k0 + ki, L);
        }
      }
      lit_s[bi][ki] = w;
    }

    for (int ki = 0; ki < kn; ++ki) {
      const int k = k0 + ki;
      __syncthreads();                    // literals staged, last column read
#pragma unroll
      for (int s = 0; s < WORD; ++s) {
        g_s[warp + WARPS * s][lane] = pg[s];
        lk_s[warp + WARPS * s][lane] = pl[s];
      }
      __syncthreads();
      if (k + 1 < Lw) load_column(g, leak, plane, c0, k + 1, C, L, pg, pl);

      float on[WORD], lk[WORD];
#pragma unroll
      for (int j = 0; j < WORD; ++j) {
        on[j] = __fmul_rn(v_read, g_s[threadIdx.x][j]);
        lk[j] = lk_s[threadIdx.x][j];
      }
      for (int b = 0; b < nb; b += ILP) {
        uint32_t w[ILP];
        float acc[ILP];
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          w[q] = lit_s[b + q][ki];
          acc[q] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < WORD; ++j) {
#pragma unroll
          for (int q = 0; q < ILP; ++q) {
            acc[q] += ((w[q] >> j) & 1u) ? lk[j] : on[j];
          }
        }
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (!(acc[q] < i_ref)) alive &= ~(1u << (b + q));
        }
      }
    }
  }

  // Rows past the batch edge and clauses past C never vote.
  if (nb < BT) alive &= (1u << nb) - 1u;
  if (!c_ok) alive = 0u;

  const int c_row = c_ok ? c : 0;
  for (int m = 0; m < M; ++m) {
    const int p = c_ok ? pol[static_cast<size_t>(c_row) * M + m] : 0;
    if (!__any_sync(0xffffffffu, p != 0)) continue;       // warp-uniform
    for (int b = 0; b < nb; ++b) {
      const int v = ((alive >> b) & 1u) ? p : 0;
      const int sum = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && sum != 0) {
        atomicAdd(&out[(static_cast<size_t>(r) * B + b0 + b) * M + m], sum);
      }
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
template <bool PACKED>
int launch(const void* lits, const void* g, const void* leak,
           const void* pol, void* out, int R, int B, int L, int C, int M,
           float i_ref, float v_read, void* stream) {
  const dim3 grid((B + BT - 1) / BT, (C + CT - 1) / CT, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(g);
  const auto* lp = static_cast<const float*>(leak);
  const auto* pp = static_cast<const int32_t*>(pol);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = !PACKED && L % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lits) % 16 == 0;
  if (vec) {
    imbue_dense_kernel<PACKED, true><<<grid, CT, 0, st>>>(
        lits, gp, lp, pp, o, B, L, C, M, i_ref, v_read);
  } else {
    imbue_dense_kernel<PACKED, false><<<grid, CT, 0, st>>>(
        lits, gp, lp, pp, o, B, L, C, M, i_ref, v_read);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace imbk
