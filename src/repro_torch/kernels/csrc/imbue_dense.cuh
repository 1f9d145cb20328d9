// imbue_dense.cuh: the body of imbue_infer_packed.cu, analog class sums
// from packed literal words and dense float32 g / leak planes.  (The
// byte-literal kernel, imbue_infer.cu, moved to imbue_core.cuh with
// imbue_infer_planes.cu; this body stays as it was until it moves too.)
//
// What it computes, per replica r, batch row b and clause c, over the
// clause's 32-cell CSA columns k (literals 32k .. 32k + 31):
//   i_col   = sum over the column's cells j = 0..31, in that order, of
//             lit ? leak[r, c, l] : v_read * g[r, c, l]     (l = 32k + j)
//             (cells past L add 0)
//   partial = i_col < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m], summed exactly as
// imbue_core.cuh sums it, so the three analog kernels give the same
// integers on the same cells.
//
// Bound on an H100 SXM at imbue-tm-mnist (C = 2000, L = 1568, M = 10),
// R = 4: the two float32 planes are 100.4 MB, 0.030 ms at 3.35 TB/s;
// 4 * R * B * C * L fp32 operations are 0.096 ms at B = 128 (67 TFLOP/s).
//
// Design:
// * One block per (32 batch rows, 64 clauses, replica), one thread per
//   clause; R is the grid's z axis, so a whole stack is one launch.
// * For each column the block stages the clause tile's [64, 32] cells of
//   g and leak in shared memory from coalesced loads, padded to 33 floats
//   a row; each thread then holds its column's 32 (v_read * g, leak)
//   pairs in registers for all 32 rows of its batch tile.  The next
//   column's loads are issued into registers before this column's sums.
// * Literal words are staged in shared memory per 32-word chunk and read
//   as warp-wide broadcasts; four rows are summed at once; the AND is a
//   32-bit mask in a register.
// * Votes: a warp reduction per (row, class), added with atomicAdd.
// * FP32 on the CUDA cores, never tensor cores or TF32.

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

// litw is [B, Lw] int32 words (bit j of word k = literal 32k + j).
__global__ void __launch_bounds__(CT) imbue_dense_kernel(
    const int32_t* __restrict__ litw,
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
        w = static_cast<uint32_t>(
            litw[static_cast<size_t>(b0 + bi) * Lw + k0 + ki]);
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
inline int launch(const void* litw, const void* g, const void* leak,
                  const void* pol, void* out, int R, int B, int L, int C,
                  int M, float i_ref, float v_read, void* stream) {
  const dim3 grid((B + BT - 1) / BT, (C + CT - 1) / CT, R);
  imbue_dense_kernel<<<grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const float*>(g),
      static_cast<const float*>(leak), static_cast<const int32_t*>(pol),
      static_cast<int32_t*>(out), B, L, C, M, i_ref, v_read);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace imbk
