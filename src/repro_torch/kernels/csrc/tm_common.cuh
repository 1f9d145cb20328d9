// tm_common.cuh: the CUDA-core tiling shared by tm_infer_packed.cu
// (digital / coalesced class sums from packed words) and clause_eval.cu
// (training-time clause bits from 0/1 bytes, whose tile kernel stops
// after the violation count and writes fired[b, c] with store_fired), and
// fold4 / fold32, the byte-to-bit fold of the two byte kernels,
// clause_eval.cu and tm_infer.cu.  (clause_eval_packed.cu, tm_infer_planes.cu and tm_infer.cu
// count on the b1 tensor cores instead: tm_b1.cuh.)
//
// A tile kernel computes, for a block tile of BT batch rows x CT clauses,
// the violation count viol[b, c] of every (row, clause) pair, then
//   fired[b, c] = (viol == 0)      rows >= B and clauses >= C never fire
//   out[b, m]  += sum_c fired[b, c] * comb[c, m]
// where comb is the int32 [C, M] combine matrix: the signed one-hot
// polarity matrix (digital) or the clause weights (coalesced), with the
// rows of empty clauses zeroed by the caller.  Blocks run in parallel in
// no order, so each adds its partial sums to the int32 output with
// atomicAdd: integer addition is exact in any order, and the caller
// zeroes the output.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tmk {

constexpr int WORD = 32;            // literals per packed word
constexpr int BT = 32;              // batch rows per block
constexpr int CT = 64;              // clauses per block
constexpr int TB = 4;               // rows per thread
constexpr int TC = 4;               // clauses per thread
constexpr int NTX = CT / TC;        // 16 threads along the clauses
constexpr int NTY = BT / TB;        // 8 threads along the rows
constexpr int THREADS = NTX * NTY;  // 128
constexpr int FW = CT / WORD;       // fired-mask words per row

// Thread (ty, tx) owns rows ty + NTY * i and clauses tx + NTX * j.  A warp
// is two values of ty by sixteen of tx, so its shared-memory reads touch
// sixteen neighbouring clause columns (no bank conflict) and two rows
// (broadcast).
struct Tile {
  int b0, c0, ty, tx;
  __device__ Tile()
      : b0(blockIdx.x * BT), c0(blockIdx.y * CT),
        ty(threadIdx.x / NTX), tx(threadIdx.x % NTX) {}
};

// viol[i][j] += popc(~lit & inc) over the kn words of one K chunk.
// lit: the tile's literal words, row r at lit[r * lit_stride + k];
// inc: the chunk's include words, clause column cl at inc[cl * inc_stride
// + k].  Literal pad bits past L are 0, so ~lit is 1 there, but the
// include pad bits are 0: the AND kills them.
__device__ __forceinline__ void count_words(const uint32_t* lit,
                                            int lit_stride,
                                            const uint32_t* inc,
                                            int inc_stride, int kn,
                                            const Tile& t,
                                            int (&viol)[TB][TC]) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    uint32_t l[TB], n[TC];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      l[i] = ~lit[(t.ty + NTY * i) * lit_stride + k];
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      n[j] = inc[(t.tx + NTX * j) * inc_stride + k];
    }
#pragma unroll
    for (int i = 0; i < TB; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) viol[i][j] += __popc(l[i] & n[j]);
    }
  }
}

__device__ __forceinline__ void clear_fired(uint32_t (*fired)[FW]) {
  for (int i = threadIdx.x; i < BT * FW; i += THREADS) {
    fired[i / FW][i % FW] = 0u;
  }
}

// Marks (row, clause) pairs whose count is zero in the tile's bit mask.
__device__ __forceinline__ void mark_fired(const int (&viol)[TB][TC],
                                           const Tile& t, int B, int C,
                                           uint32_t (*fired)[FW]) {
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int bl = t.ty + NTY * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int cl = t.tx + NTX * j;
      if (viol[i][j] == 0 && t.b0 + bl < B && t.c0 + cl < C) {
        atomicOr(&fired[bl][cl / WORD], 1u << (cl % WORD));
      }
    }
  }
}

// After a __syncthreads: one thread per (row, class) pair sums comb over
// the row's fired clauses (a few per row: walk the set bits) and adds the
// sum to the output.
__device__ __forceinline__ void combine(uint32_t (*fired)[FW],
                                        const int32_t* __restrict__ comb,
                                        int32_t* __restrict__ out,
                                        const Tile& t, int B, int M) {
  const int nb = min(BT, B - t.b0);
  for (int p = threadIdx.x; p < nb * M; p += THREADS) {
    const int bl = p / M;
    const int m = p - bl * M;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < FW; ++w) {
      uint32_t bits = fired[bl][w];
      while (bits != 0u) {
        const int cl = w * WORD + __ffs(bits) - 1;
        bits &= bits - 1u;
        sum += comb[static_cast<size_t>(t.c0 + cl) * M + m];
      }
    }
    if (sum != 0) {
      atomicAdd(&out[static_cast<size_t>(t.b0 + bl) * M + m], sum);
    }
  }
}

// Training semantics: out[b, c] = (viol[b, c] == 0) as one byte, for the
// pairs inside [B, C] (an empty clause has no violation, so it fires).
// A warp's stores for one j cover sixteen neighbouring clause bytes of
// two rows.
__device__ __forceinline__ void store_fired(const int (&viol)[TB][TC],
                                            const Tile& t, int B, int C,
                                            uint8_t* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    const int b = t.b0 + t.ty + NTY * i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = t.c0 + t.tx + NTX * j;
      if (b < B && c < C) {
        out[static_cast<size_t>(b) * C + c] = viol[i][j] == 0 ? 1 : 0;
      }
    }
  }
}

// Four 0/1 bytes of v (bit 0 of each) -> four neighbouring bits: the
// multiply places byte i's bit 0 at bit 28 + i, and no partial product
// carries into bits 28-31.
__device__ __forceinline__ uint32_t fold4(uint32_t v) {
  return ((v & 0x01010101u) * 0x10204080u) >> 28;
}

// 32 0/1 bytes (a: bytes 0-15, b: bytes 16-31) -> one word, bit j = byte j.
__device__ __forceinline__ uint32_t fold32(const uint4& a, const uint4& b) {
  return fold4(a.x) | fold4(a.y) << 4 | fold4(a.z) << 8 | fold4(a.w) << 12 |
         fold4(b.x) << 16 | fold4(b.y) << 20 | fold4(b.z) << 24 |
         fold4(b.w) << 28;
}

inline dim3 grid_for(int B, int C) {
  return dim3((B + BT - 1) / BT, (C + CT - 1) / CT);
}

}  // namespace tmk
