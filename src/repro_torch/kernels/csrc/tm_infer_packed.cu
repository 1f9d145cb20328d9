// tm_infer_packed: digital / coalesced TM class sums from packed
// literal and include words, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_packed_kernel
//   (+ _packed_viol_block; launched by tm_infer_packed_call).
//
// What it computes: for batch row b and clause c,
//   viol[b, c] = sum over words w of popc(~litw[b, w] & incw[c, w])
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// with litw [B, Lw] and incw [C, Lw] int32 bit patterns (the state's own
// packed include plane, in its [C, Lw] layout: nothing is transposed per
// dispatch) and comb [C, M] int32, the rows of empty clauses zeroed by the
// caller.  The TPU kernel moves K along its grid; tm_infer_planes_kernel
// computes the same function from the same operands, and so does this
// kernel's counterpart tm_infer_planes.cu.
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
// Design: tm_infer_planes.cu's body on the core of tm_b1.cuh: the block
// stages its literal and include words through tmb::WordSource and its
// [ct, M] slice of comb in one cp.async round trip (K in chunks only for
// rows too long for 48 KB), counts with the b1 product (mma.sync
// m16n8k256 .and.popc), meets its K-split as flags, and adds its class
// sums with tmb::combine_rows (one int32 atomicAdd a non-zero (row,
// class) sum) into an output the wrapper zeroes.  The layout is
// tmb::choose's, the same as tm_infer_planes' (its geometry table is in
// tm_infer_planes.cu).  A thread-block-cluster epilogue that wrote every
// sum once, without the zero fill or the atomics, was slower on four of
// the six timing rows of benchmarks/analog_kernel_ab.py in a same-card
// A/B (PERF.md, section 6): a cluster has at most 16 CTAs, so at
// C = 1000 and 2000 each CTA stages twice the clauses of this kernel's
// blocks.
// Integer arithmetic only: any split or order gives the same sums.

#include "tm_b1.cuh"

namespace {

using tmb::Geo;
using tmb::WORD;

__global__ void __launch_bounds__(tmb::WARPS_MAX * WORD) packed_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int Lw, int C, int M, Geo geo) {
  tmb::infer_block(tmb::WordSource{litw, incw, B, C, Lw}, comb, out, B, Lw,
                   C, M, geo);
}

}  // namespace

// Launch on `stream` with the tile override (wm x wn warp tiles, each 1,
// 2 or 4; both 0 for tmb::choose's layout).  Returns cudaGetLastError()
// after the launch (0 on success), or tmb::TILE_INVALID, launching
// nothing, for a tile outside its set.
extern "C" int tm_infer_packed_launch(const void* litw, const void* incw,
                                      const void* comb, void* out, int B,
                                      int Lw, int C, int M, int wm, int wn,
                                      void* stream) {
  Geo g;
  if (!tmb::geometry(B, C, Lw, M, wm, wn, g)) return tmb::TILE_INVALID;
  packed_kernel<<<g.grid, g.wm * g.wn * g.ks * WORD, tmb::smem_bytes(g),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<const int32_t*>(comb), static_cast<int32_t*>(out), B, Lw,
      C, M, g);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at (B, C, Lw, M) with the tile override (wm, wn;
// both 0 for tmb::choose's), the fields of tmb::geometry_info.  Returns
// the CUDA error, or tmb::TILE_INVALID as the launch does.
extern "C" int tm_infer_packed_geometry(int B, int C, int Lw, int M, int wm,
                                        int wn, int* info) {
  Geo g;
  if (!tmb::geometry(B, C, Lw, M, wm, wn, g)) return tmb::TILE_INVALID;
  return tmb::geometry_info(g, packed_kernel, info);
}
