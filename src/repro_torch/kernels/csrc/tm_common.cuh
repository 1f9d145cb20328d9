// tm_common.cuh: the CUDA-core tiling of clause_eval.cu's tile kernel
// (training-time clause bits from 0/1 bytes, at batches above its
// warp-per-clause route) and fold4 / fold32, the byte-to-bit fold of the
// two byte kernels, clause_eval.cu and tm_infer.cu.  (The word kernels
// clause_eval_packed.cu, tm_infer_planes.cu and tm_infer_packed.cu, and
// tm_infer.cu once its bytes are folded, count on the b1 tensor cores
// instead: tm_b1.cuh.)
//
// The tile kernel computes, for a block tile of BT batch rows x CT
// clauses, the violation count viol[b, c] of every (row, clause) pair
// (count_words over the words staged in shared memory), then writes
//   fired[b, c] = (viol == 0)      one byte, for rows < B and clauses < C
// with store_fired (an empty clause has no violation, so it fires).

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
