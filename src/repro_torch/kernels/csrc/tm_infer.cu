// tm_infer: digital / coalesced TM class sums from dense 0/1 literal and
// include bytes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_kernel
//   (launched by tm_infer_call).
//
// What it computes: for batch row b and clause c,
//   viol[b, c] = sum over literals l of (1 - lits[b, l]) * include[c, l]
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// with lits [B, L] and include [C, L] as uint8 0/1 in the layouts the
// state holds (nothing is transposed per dispatch) and comb [C, M] int32
// (rows of empty clauses zeroed by the caller).  The TPU kernel runs the
// violation count as a float32 MXU product; here it is an integer count,
// exact for the same reason the product is (each term is 0 or 1).
//
// Bound, at the coalesced serving width (C = 1000, L = 1568, M = 10) and
// B = 128: the operands are 1.8 MB, 0.54 us at 3.35 TB/s; the violation
// product, 2*B*C*L = 0.40 G operations on 0/1 bytes, takes 0.20 us at the
// H100's dense int8 tensor-core rate (1979 TOP/s).  Bound by bytes.
//
// Design: the word kernels' block (tm_b1.cuh) with a byte source.
// * Staging folds bytes into bit words: a word's 32 bytes are two 16-byte
//   loads, and bit j of the word is bit 0 of byte j (fold4: a multiply
//   moves four 0/1 bytes into four neighbouring bits).  A fold cannot go
//   through cp.async, so each thread issues the loads of FOLD = 2 words
//   (four 16-byte loads) before it folds them and stores the words to
//   shared memory: 2048 words in flight a 1024-thread block, two rounds
//   for a tile of 48 or 64 rows x 49 words, three for 96.  The block
//   meets at the one barrier that the combine slice's cp.async copies
//   also land at.  A word at a ragged edge (L not a multiple of 32), or
//   every word when L is not a multiple of 16 or an operand is not
//   16-byte aligned (a bool include plane is read as its bytes, without
//   a copy), is read byte by byte.  Bytes past L and rows past B or C
//   read as 0.
// * The b1 product on the staged words (literals inverted at use; pad
//   bits are 0 on both sides, so the pad never counts), the K-split
//   meeting as flags, and tmb::combine_rows, as tm_infer_planes.cu.
// * choose counts bytes, not words: a row is 1568 bytes, 32x its word
//   row, and every row tile re-reads its clauses' bytes.  Each layout
//   (wm x wn warp tiles of 16 x 32, 32 warps a block so that every
//   thread's loads are few and all in flight) is scored by the bytes an
//   SM reads, ceil(blocks / SMs) x (bt + ct) x L, then the bytes of the
//   whole grid, then the fewest blocks.  At L = 1568, M = 10 on 132 SMs
//   (blocks, tile rows x clauses):
//     C = 1000: B = 8   32, 16 x 32;  B = 64  128, 16 x 32;
//               B = 128 128, 32 x 32
//     C = 2000: B = 8   63, 16 x 32;  B = 64  126, 32 x 32;
//               B = 128 126, 64 x 32
//   (two to four row tiles at B = 128, clause tiles of 32 to fill the
//   card).

#include "tm_b1.cuh"
#include "tm_common.cuh"

namespace {

using tmb::Geo;
using tmb::WORD;

// Words a thread loads before it folds: 2 keeps a 1024-thread block
// within its 64 registers a thread (4 spilled there, and 512-thread
// blocks loading 4 measured slower).
constexpr int FOLD = 2;

// 0/1 bytes, folded into words while staged.  VEC: L is a multiple of 16
// and both byte matrices are 16-byte aligned, so a whole word is two
// 16-byte loads.
template <bool VEC>
struct ByteSource {
  const uint8_t* __restrict__ lits;     // [B, L] 0/1 literals
  const uint8_t* __restrict__ inc;      // [C, L] 0/1 include actions
  int B, C, L;

  __device__ void stage(uint32_t* dst, int lwp, int b0, int c0, int bt,
                        int ct, int k0, int kn, int kp) const {
    const int n = (bt + ct) * kp;
    const int nt = blockDim.x;
    for (int q0 = threadIdx.x; q0 < n; q0 += FOLD * nt) {
      uint4 lo[FOLD], hi[FOLD];
      uint32_t w[FOLD];
      bool vec[FOLD];
#pragma unroll
      for (int f = 0; f < FOLD; ++f) {     // word q: tile row q / kp
        const int q = q0 + f * nt, r = q / kp, k = q % kp;
        const uint8_t* p = nullptr;
        int nb = 0;                        // bytes of the word inside L
        if (q < n && k < kn) {
          const bool lit = r < bt;
          const int row = lit ? b0 + r : c0 + r - bt;
          if (row < (lit ? B : C)) {
            const int at = WORD * (k0 + k);
            p = (lit ? lits : inc) + static_cast<size_t>(row) * L + at;
            nb = min(WORD, L - at);
          }
        }
        vec[f] = VEC && nb == WORD;
        w[f] = 0u;
        if (vec[f]) {
          lo[f] = reinterpret_cast<const uint4*>(p)[0];
          hi[f] = reinterpret_cast<const uint4*>(p)[1];
        } else {
          for (int j = 0; j < nb; ++j) {
            w[f] |= static_cast<uint32_t>(p[j] & 1u) << j;
          }
        }
      }
#pragma unroll
      for (int f = 0; f < FOLD; ++f) {
        const int q = q0 + f * nt;
        if (q >= n) break;
        if (vec[f]) w[f] = tmk::fold32(lo[f], hi[f]);
        dst[(q / kp) * lwp + q % kp] = w[f];
      }
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(tmb::WARPS_MAX * WORD) tm_infer_kernel(
    const uint8_t* __restrict__ lits,   // [B, L] 0/1 literals
    const uint8_t* __restrict__ inc,    // [C, L] 0/1 include actions
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int L, int C, int M, Geo geo) {
  tmb::infer_block(ByteSource<VEC>{lits, inc, B, C, L}, comb, out, B,
                   tmb::cdiv_d(L, WORD), C, M, geo);
}

// Of the wm x wn layouts (ks = the K-splits that make WARPS_MAX warps),
// the one whose SMs read the fewest bytes, then the fewest bytes in all,
// then the fewest blocks.
Geo choose(int B, int C, int L, int M) {
  const long sms = tmb::sm_count();
  Geo best{};
  long best_sm = -1, best_all = 0, best_blocks = 0;
  for (int wm = 1; wm <= std::min(4, std::max(1, tmb::cdiv(B, 16)));
       wm *= 2) {
    for (int wn = 1;
         wn <= std::min(tmb::WN_MAX, std::max(1, tmb::cdiv(C, 32)));
         wn *= 2) {
      const long blocks =
          std::max(1L, static_cast<long>(tmb::cdiv(B, 16 * wm)) *
                           tmb::cdiv(C, 32 * wn));
      const long bytes = static_cast<long>(16 * wm + 32 * wn) * L;
      const long per_sm = tmb::cdiv(blocks, sms) * bytes;
      const long all = blocks * bytes;
      if (best_sm < 0 || per_sm < best_sm ||
          (per_sm == best_sm &&
           (all < best_all || (all == best_all && blocks < best_blocks)))) {
        best = Geo{wm, wn, tmb::WARPS_MAX / (wm * wn)};
        best.cm = tmb::comb_words(wn, M);
        best_sm = per_sm;
        best_all = all;
        best_blocks = blocks;
      }
    }
  }
  return tmb::finish(best, B, C, tmb::cdiv(L, WORD));
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
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(i) % 16 == 0;
  const Geo g = choose(B, C, L, M);
  const int threads = g.wm * g.wn * g.ks * WORD;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    tm_infer_kernel<true><<<g.grid, threads, tmb::smem_bytes(g), st>>>(
        l, i, cb, o, B, L, C, M, g);
  } else {
    tm_infer_kernel<false><<<g.grid, threads, tmb::smem_bytes(g), st>>>(
        l, i, cb, o, B, L, C, M, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at (B, C, L, M), the fields of tmb::geometry_info
// (words staged a chunk: L / 32 rounded up to 8 words).  Returns the CUDA
// error.
extern "C" int tm_infer_geometry(int B, int C, int L, int M, int* info) {
  return tmb::geometry_info(choose(B, C, L, M), tm_infer_kernel<true>,
                            info);
}
