// tm_infer: digital / coalesced TM class sums from dense 0/1 literal and
// include bytes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_kernel
//   (launched by tm_infer_call).
//
// What it computes (see tm_common.cuh): for batch row b and clause c,
//   viol[b, c] = sum over literals l of (1 - lits[b, l]) * include[c, l]
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// with lits [B, L] and include [C, L] as uint8 0/1 in the layouts the
// state holds (nothing is transposed per dispatch) and comb [C, M] int32.
// The violation product is the TPU kernel's own MXU product, here a
// shared-memory tiled product on the CUDA cores in float32 FFMA: each
// term is 0 or 1 and a count is at most L < 2^24, so every partial sum
// is an exact integer.  It never runs in TF32.
//
// Bound, at the coalesced serving width (C = 1000, L = 1568, M = 10) and
// B = 128: the operands are 1.8 MB, 0.54 us at 3.35 TB/s.  The violation
// product, 2*B*C*L = 0.40 G operations on 0/1 bytes, takes 0.20 us at the
// H100's dense int8 tensor-core rate (1979 TOP/s), and the combine's
// 2*B*C*M = 2.6 M int32 operations 0.04 us at 67 T/s.  So it is bound by
// bytes, at 0.54 us.  (Design note: this kernel runs the product as fp32
// FFMA on the CUDA cores, where the same 0.40 G operations alone take 6 us
// at 67 TFLOP/s; an int8 MMA version is later work.)
//
// Design, simple and right first:
// * One block of 128 threads per (32 batch rows, 64 clauses) tile; each
//   thread accumulates a 4 x 4 register tile, 16 FFMA per 8 shared-memory
//   loads.
// * K runs inside the block in steps of KL = 64 literals.  Each thread
//   loads its share of a step's bytes as 4-byte words (byte by byte when
//   L is not a multiple of 4) into registers, and the loads of step k + 1
//   are issued before the FFMAs of step k, so their latency hides behind
//   the arithmetic: with one 4-warp block per SM at these grid sizes,
//   load latency, not the FFMA rate, is what costs.
// * Each step converts its bytes to floats while storing them to shared
//   memory as [literal][row] and [literal][clause], so the inner loop
//   reads a broadcast row value and sixteen neighbouring clause columns.
//   Bytes past L and clauses past C read as 0, so they add nothing.
// * No sequential grid: each tile adds its sums to the output with
//   atomicAdd (exact for integers).
// * Later work: more warps per SM (smaller thread tiles or split K), a
//   deeper pipeline; the packed kernels do the same work in 32x fewer
//   bytes.

#include "tm_common.cuh"

namespace {

constexpr int KL = 64;                                // literals per K step
constexpr int KQ = KL / 4;                            // 4-byte words per row
constexpr int LIT_Q = tmk::BT * KQ / tmk::THREADS;    // literal words/thread
constexpr int INC_Q = tmk::CT * KQ / tmk::THREADS;    // include words/thread

// Bytes [k, k + 4) of row `row` of a [rows, L] byte matrix as one
// little-endian word; bytes past L and rows past `rows` read as 0.  WORDS:
// L is a multiple of 4 and the matrix 4-byte aligned, so one load.
template <bool WORDS>
__device__ __forceinline__ uint32_t load_quad(const uint8_t* __restrict__ m,
                                              int row, int rows, int k,
                                              int L) {
  if (row >= rows || k >= L) return 0u;
  const uint8_t* p = m + static_cast<size_t>(row) * L + k;
  if (WORDS) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
  for (int j = 0; j < 4 && k + j < L; ++j) {
    v |= static_cast<uint32_t>(p[j]) << (8 * j);
  }
  return v;
}

// Issues this thread's loads of the K step at k0 (word q of the tile is
// row q / KQ, bytes 4 * (q % KQ) .. + 3).
template <bool WORDS>
__device__ __forceinline__ void load_step(const uint8_t* __restrict__ lits,
                                          const uint8_t* __restrict__ inc,
                                          const tmk::Tile& t, int k0, int B,
                                          int C, int L,
                                          uint32_t (&lq)[LIT_Q],
                                          uint32_t (&iq)[INC_Q]) {
#pragma unroll
  for (int s = 0; s < LIT_Q; ++s) {
    const int q = threadIdx.x + tmk::THREADS * s;
    lq[s] = load_quad<WORDS>(lits, t.b0 + q / KQ, B, k0 + 4 * (q % KQ), L);
  }
#pragma unroll
  for (int s = 0; s < INC_Q; ++s) {
    const int q = threadIdx.x + tmk::THREADS * s;
    iq[s] = load_quad<WORDS>(inc, t.c0 + q / KQ, C, k0 + 4 * (q % KQ), L);
  }
}

template <bool WORDS>
__global__ void __launch_bounds__(tmk::THREADS) tm_infer_kernel(
    const uint8_t* __restrict__ lits,   // [B, L] 0/1 literals
    const uint8_t* __restrict__ inc,    // [C, L] 0/1 include actions
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int L, int C, int M) {
  __shared__ float lit0_s[KL][tmk::BT + 1];   // 1 - lit, [literal][row]
  __shared__ float inc_s[KL][tmk::CT + 1];    // [literal][clause]
  __shared__ uint32_t fired_s[tmk::BT][tmk::FW];
  const tmk::Tile t;
  tmk::clear_fired(fired_s);

  uint32_t lq[LIT_Q], iq[INC_Q];
  load_step<WORDS>(lits, inc, t, 0, B, C, L, lq, iq);
  float viol[tmk::TB][tmk::TC] = {};
  for (int k0 = 0; k0 < L; k0 += KL) {
    __syncthreads();                 // the last step has been consumed
#pragma unroll
    for (int s = 0; s < LIT_Q; ++s) {
      const int q = threadIdx.x + tmk::THREADS * s;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lit0_s[4 * (q % KQ) + j][q / KQ] =
            1.0f - static_cast<float>((lq[s] >> (8 * j)) & 0xffu);
      }
    }
#pragma unroll
    for (int s = 0; s < INC_Q; ++s) {
      const int q = threadIdx.x + tmk::THREADS * s;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        inc_s[4 * (q % KQ) + j][q / KQ] =
            static_cast<float>((iq[s] >> (8 * j)) & 0xffu);
      }
    }
    __syncthreads();
    if (k0 + KL < L) {               // in flight during the FFMAs below
      load_step<WORDS>(lits, inc, t, k0 + KL, B, C, L, lq, iq);
    }
#pragma unroll 8
    for (int kk = 0; kk < KL; ++kk) {
      float a[tmk::TB], n[tmk::TC];
#pragma unroll
      for (int i = 0; i < tmk::TB; ++i) a[i] = lit0_s[kk][t.ty + tmk::NTY * i];
#pragma unroll
      for (int j = 0; j < tmk::TC; ++j) n[j] = inc_s[kk][t.tx + tmk::NTX * j];
#pragma unroll
      for (int i = 0; i < tmk::TB; ++i) {
#pragma unroll
        for (int j = 0; j < tmk::TC; ++j) {
          viol[i][j] = __fmaf_rn(a[i], n[j], viol[i][j]);
        }
      }
    }
  }

  tmk::mark_fired(viol, t, B, C, fired_s);
  __syncthreads();
  tmk::combine(fired_s, comb, out, t, B, M);
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tm_infer_launch(const void* lits, const void* inc,
                               const void* comb, void* out, int B, int L,
                               int C, int M, void* stream) {
  const auto* l = static_cast<const uint8_t*>(lits);
  const auto* i = static_cast<const uint8_t*>(inc);
  const auto* cb = static_cast<const int32_t*>(comb);
  auto* o = static_cast<int32_t*>(out);
  const bool words = L % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(i) % 4 == 0;
  const dim3 grid = tmk::grid_for(B, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words) {
    tm_infer_kernel<true><<<grid, tmk::THREADS, 0, st>>>(l, i, cb, o, B, L,
                                                         C, M);
  } else {
    tm_infer_kernel<false><<<grid, tmk::THREADS, 0, st>>>(l, i, cb, o, B, L,
                                                          C, M);
  }
  return static_cast<int>(cudaGetLastError());
}
