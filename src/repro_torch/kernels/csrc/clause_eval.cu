// clause_eval: training-time clause bits from dense 0/1 literal and
// include bytes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: clause_eval_kernel
//   (launched by clause_eval_call).
//
// What it computes: for batch row b and clause c,
//   viol[b, c]  = sum over literals l of (1 - lits[b, l]) * include[c, l]
//   fired[b, c] = (viol[b, c] == 0)            as one uint8 byte
// with lits [B, L] and include [C, L] as 0/1 bytes in the layouts the
// state holds (the include plane is `state > N` as bool bytes; nothing
// is transposed per call).  Training semantics: an empty clause fires.
// The TPU kernel runs the violation count as a float32 MXU product; here
// it is an integer count, exact for the same reason the product is (each
// term is 0 or 1, a count is at most L).
//
// Bound, at imbue-tm-mnist (C = 2000, L = 1568): at B = 256 the operands
// and the clause bits are 4.1 MB, 1.2 us at 3.35 TB/s, while the
// 2*B*C*L = 1.6 G operations on 0/1 bytes take 0.8 us at the H100's dense
// int8 tensor-core rate (1979 TOP/s): bound by bytes.  On its main path,
// the sequential training step, B = 1: 3.1 MB of include bytes, 0.9 us,
// below the cost of a launch.
//
// Two kernels, chosen by B:
//
// B <= B_SMALL (the sequential step), clause_eval_small: one warp per
// clause, 8 clauses a block (250 blocks at C = 2000 for 132 SMs).  Each
// block first issues its warps' include loads, then folds its B literal
// rows into inverted bit words in shared memory once (49 words a row at
// L = 1568; rows up to B_SMALL past B are 0).  Each lane holds up to 2
// include words of its clause (four 16-byte loads, all in flight before
// the count), folds them to bits, ANDs them with each row's words and
// counts with POPC; the warp sums each row's count (__reduce_add_sync)
// and lane b writes row b's byte.  The include plane, read once, is the
// whole of the traffic: the bytes bound is 0.94 us at B = 1, below a
// launch's own latency.
//
// B > B_SMALL, clause_eval_kernel, the CUDA-core tiling of
// tm_common.cuh: one block of 128 threads per 32 rows x 64 clauses, a
// 4 x 4 register tile a thread.  K runs inside the block in steps of KW
// words (256 literals).  Each thread reads 32 bytes of a row with two
// 16-byte loads and folds them into one 32-bit word in registers, then
// stores the word in shared memory; the count is then an AND + popcount
// of words (count_words): 32 literals a POPC instead of 32 products.
// store_fired writes the tile's bits; rows >= B and clauses >= C are not
// written.
//
// Both: a 32-bit word's bit j is byte j (a multiply moves four 0/1 bytes
// into four neighbouring bits, fold4), read with 16-byte loads, or byte
// by byte at a ragged edge, when L is not a multiple of 16 or when an
// operand is not 16-byte aligned.  Bytes past L and clauses past C read
// as 0: a 0 include bit kills the inverted 0 literal, so padding adds
// nothing.

#include "tm_common.cuh"

namespace {

constexpr int B_SMALL = 8;           // batches the warp-per-clause kernel takes
constexpr int SMALL_WARPS = 8;       // clauses (warps) a block
constexpr int SMALL_U = 2;           // include words a lane holds at once
constexpr int SMALL_SMEM = 48 * 1024;
static_assert(B_SMALL <= 32, "lane b writes row b");

constexpr int KW = 8;                                  // words per K step
constexpr int INC_STRIDE = KW + 1;
constexpr int LIT_W = tmk::BT * KW / tmk::THREADS;     // literal words/thread
constexpr int INC_W = tmk::CT * KW / tmk::THREADS;     // include words/thread

// Bit j of the result is bit 0 of byte k + j of row `row` of a [rows, L]
// byte matrix; bytes past L and rows past `rows` read as 0.  VEC: L is a
// multiple of 16 and the matrix 16-byte aligned, so a full word is two
// 16-byte loads.
template <bool VEC>
__device__ __forceinline__ uint32_t load_bits(const uint8_t* __restrict__ m,
                                              int row, int rows, int k,
                                              int L) {
  if (row >= rows || k >= L) return 0u;
  const uint8_t* p = m + static_cast<size_t>(row) * L + k;
  if (VEC && k + tmk::WORD <= L) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    return tmk::fold32(a, b);
  }
  const int n = min(tmk::WORD, L - k);
  uint32_t w = 0u;
  for (int j = 0; j < n; ++j) w |= static_cast<uint32_t>(p[j] & 1u) << j;
  return w;
}

template <bool VEC>
__global__ void __launch_bounds__(tmk::THREADS) clause_eval_kernel(
    const uint8_t* __restrict__ lits,   // [B, L] 0/1 literals
    const uint8_t* __restrict__ inc,    // [C, L] 0/1 include actions
    uint8_t* __restrict__ out,          // [B, C] clause bits
    int B, int L, int C) {
  __shared__ uint32_t lit_s[tmk::BT][KW];
  __shared__ uint32_t inc_s[tmk::CT][INC_STRIDE];
  const tmk::Tile t;

  int viol[tmk::TB][tmk::TC] = {};
  for (int k0 = 0; k0 < L; k0 += KW * tmk::WORD) {
    const int kn = min(KW, (L - k0 + tmk::WORD - 1) / tmk::WORD);
    uint32_t lw[LIT_W], iw[INC_W];
#pragma unroll
    for (int s = 0; s < LIT_W; ++s) {   // word q: row q / KW, word q % KW
      const int q = threadIdx.x + tmk::THREADS * s;
      lw[s] = load_bits<VEC>(lits, t.b0 + q / KW, B,
                             k0 + tmk::WORD * (q % KW), L);
    }
#pragma unroll
    for (int s = 0; s < INC_W; ++s) {
      const int q = threadIdx.x + tmk::THREADS * s;
      iw[s] = load_bits<VEC>(inc, t.c0 + q / KW, C,
                             k0 + tmk::WORD * (q % KW), L);
    }
    __syncthreads();                 // the last step has been counted
#pragma unroll
    for (int s = 0; s < LIT_W; ++s) {
      const int q = threadIdx.x + tmk::THREADS * s;
      lit_s[q / KW][q % KW] = lw[s];
    }
#pragma unroll
    for (int s = 0; s < INC_W; ++s) {
      const int q = threadIdx.x + tmk::THREADS * s;
      inc_s[q / KW][q % KW] = iw[s];
    }
    __syncthreads();
    tmk::count_words(&lit_s[0][0], KW, &inc_s[0][0], INC_STRIDE, kn, t, viol);
  }
  tmk::store_fired(viol, t, B, C, out);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * SMALL_WARPS) clause_eval_small(
    const uint8_t* __restrict__ lits,   // [B, L] 0/1 literals
    const uint8_t* __restrict__ inc,    // [C, L] 0/1 include actions
    uint8_t* __restrict__ out,          // [B, C] clause bits
    int B, int L, int C) {
  extern __shared__ uint32_t nlit[];    // [B_SMALL, lw] inverted words
  const int lw = (L + tmk::WORD - 1) / tmk::WORD;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * SMALL_WARPS + threadIdx.x / 32;
  // Word w of this lane's include row (0 past L or C).
  uint32_t iw[SMALL_U];
  auto load = [&](int w0) {
#pragma unroll
    for (int u = 0; u < SMALL_U; ++u) {
      iw[u] = load_bits<VEC>(inc, c, C, tmk::WORD * (w0 + lane + 32 * u),
                             L);
    }
  };
  load(0);
  for (int q = threadIdx.x; q < B_SMALL * lw; q += blockDim.x) {
    const int r = q / lw;
    nlit[q] = r < B ? ~load_bits<VEC>(lits, r, B, tmk::WORD * (q % lw), L)
                    : 0u;
  }
  __syncthreads();
  int viol[B_SMALL] = {};
  for (int w0 = 0;;) {
#pragma unroll
    for (int u = 0; u < SMALL_U; ++u) {
      const int w = w0 + lane + 32 * u;
      if (w < lw) {
#pragma unroll
        for (int r = 0; r < B_SMALL; ++r) {
          viol[r] += __popc(nlit[r * lw + w] & iw[u]);
        }
      }
    }
    w0 += 32 * SMALL_U;
    if (w0 >= lw) break;
    load(w0);
  }
  int mine = 0;
#pragma unroll
  for (int r = 0; r < B_SMALL; ++r) {
    const int v = __reduce_add_sync(0xffffffffu, viol[r]);
    if (lane == r) mine = v;
  }
  if (lane < B && c < C) {
    out[static_cast<size_t>(lane) * C + c] = mine == 0 ? 1 : 0;
  }
}

// Whether a [B, L] launch takes clause_eval_small, and its shared memory.
bool small_route(int B, int L, int* smem) {
  *smem = B_SMALL * ((L + tmk::WORD - 1) / tmk::WORD) *
          static_cast<int>(sizeof(uint32_t));
  return B <= B_SMALL && *smem <= SMALL_SMEM;
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int clause_eval_launch(const void* lits, const void* inc,
                                  void* out, int B, int L, int C,
                                  void* stream) {
  const auto* l = static_cast<const uint8_t*>(lits);
  const auto* i = static_cast<const uint8_t*>(inc);
  auto* o = static_cast<uint8_t*>(out);
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(i) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem = 0;
  if (small_route(B, L, &smem)) {
    const int grid = (C + SMALL_WARPS - 1) / SMALL_WARPS;
    if (vec) {
      clause_eval_small<true><<<grid, 32 * SMALL_WARPS, smem, st>>>(
          l, i, o, B, L, C);
    } else {
      clause_eval_small<false><<<grid, 32 * SMALL_WARPS, smem, st>>>(
          l, i, o, B, L, C);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = tmk::grid_for(B, C);
  if (vec) {
    clause_eval_kernel<true><<<grid, tmk::THREADS, 0, st>>>(l, i, o, B, L, C);
  } else {
    clause_eval_kernel<false><<<grid, tmk::THREADS, 0, st>>>(l, i, o, B, L,
                                                             C);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 if a launch of B rows of L literals takes the warp-per-clause kernel,
// 0 if it takes the tile kernel.
extern "C" int clause_eval_small_route(int B, int L) {
  int smem = 0;
  return small_route(B, L, &smem) ? 1 : 0;
}
