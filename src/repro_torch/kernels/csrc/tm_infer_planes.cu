// tm_infer_planes: digital / coalesced TM class sums from packed literal
// words and the resident include bitplane, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_planes_kernel
//   (launched by tm_infer_planes_call).
//
// What it computes: for batch row b and clause c,
//   viol[b, c] = sum over words w of popc(~litw[b, w] & incw[c, w])
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// reading the state's plane_index in its own [C, Lw] int32 layout (the
// TPU path transposes it to [Lw, C] on every dispatch; this one does
// not) and comb [C, M] int32, the polarity matrix or the coalesced
// weights with the rows of empty clauses zeroed by the caller.
//
// Bound, at the coalesced serving width (C = 1000, Lw = 49, M = 10) and
// B = 128: B*C*Lw = 6.3 M word steps.  Only viol == 0 is kept, so a word
// step needs one LOP3 (an OR of ~lit & inc), 0.37 us at the CUDA cores'
// 32-bit logic rate (64 per clock per SM, 132 SMs, 1.98 GHz); the
// operands are 0.24 MB, 0.07 us at 3.35 TB/s.  This kernel counts on the
// b1 tensor cores, whose Hopper rate NVIDIA does not publish.  At these
// sizes the time is a chain of launch, one load round trip, a barrier,
// the combine and its atomics.
//
// Design: clause_eval_packed's block on the core of tm_b1.cuh, with the
// class-sum epilogue instead of the clause-bit store.
// * One load round trip: the block's literal and include words and its
//   [ct, M] slice of comb, all with 4-byte cp.async (a 196-byte row is
//   not 16-byte aligned), then one barrier.
// * The b1 product (mma.sync m16n8k256 .and.popc), the K-split meeting
//   as flags, then tmb::combine_rows: a ballot a row and 32 clauses, one
//   lane a class, one int32 atomicAdd a non-zero (row, class) sum.
// * tmb::choose, clause_eval_packed's layout rule (of the layouts whose
//   grid holds 16 warps an SM, the one that stages the fewest words; if
//   none does, the most warps), the blocks also staging their combine
//   slices.  A rule of its own (blocks of 16 warps at most, the fewest
//   staged words within 7/8 of the most warps) won two of the six timing
//   rows of benchmarks/analog_kernel_ab.py and lost three, each by under
//   4 % (PERF.md), so the kernels share one.  At Lw = 49, M = 10 on 132
//   SMs (grid, tile rows x clauses, K-split, launched warps an SM):
//     C = 1000: B = 8   1 x 32,  16 x 32, 7  (1.7)
//               B = 64  4 x 32,  16 x 32, 7  (6.8)
//               B = 128 8 x 32,  16 x 32, 7  (13.6)
//     C = 2000: B = 8   1 x 32,  16 x 64, 7  (3.4)
//               B = 64  4 x 32,  16 x 64, 7  (13.6)
//               B = 128 2 x 63,  64 x 32, 5  (19.1)
//   The combine adds at most grid.y x B x M atomics (41 k at C = 1000,
//   B = 128).
// * Integer arithmetic only: any split or order gives the same sums.

#include "tm_b1.cuh"

namespace {

using tmb::Geo;
using tmb::WORD;

__global__ void __launch_bounds__(tmb::WARPS_MAX * WORD) planes_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words (plane_index)
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int Lw, int C, int M, Geo geo) {
  tmb::infer_block(tmb::WordSource{litw, incw, B, C, Lw}, comb, out, B, Lw,
                   C, M, geo);
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tm_infer_planes_launch(const void* litw, const void* incw,
                                      const void* comb, void* out, int B,
                                      int Lw, int C, int M, void* stream) {
  const Geo g = tmb::choose(B, C, Lw, M);
  planes_kernel<<<g.grid, g.wm * g.wn * g.ks * WORD, tmb::smem_bytes(g),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<const int32_t*>(comb), static_cast<int32_t*>(out), B, Lw,
      C, M, g);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at (B, C, Lw, M), the fields of
// tmb::geometry_info.  Returns the CUDA error.
extern "C" int tm_infer_planes_geometry(int B, int C, int Lw, int M,
                                        int* info) {
  return tmb::geometry_info(tmb::choose(B, C, Lw, M), planes_kernel,
                            info);
}
