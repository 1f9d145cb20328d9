// tm_infer_packed: digital / coalesced TM class sums from packed
// literal and include words, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_packed_kernel
//   (+ _packed_viol_block; launched by tm_infer_packed_call).
//
// What it computes (see tm_common.cuh): for batch row b and clause c,
//   viol[b, c] = sum over words w of popc(~litw[b, w] & incw[c, w])
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// with litw [B, Lw] and incw [C, Lw] int32 bit patterns (the state's own
// packed include plane, in its [C, Lw] layout: nothing is transposed per
// dispatch) and comb [C, M] int32.
//
// Bound, at the coalesced serving width (C = 1000, Lw = 49, M = 10) and
// B = 128: B*C*Lw = 6.3 M word steps of LOP3 + POPC + IADD.  POPC runs
// at 16 per clock per SM on compute capability 9.0 (the throughput table
// of NVIDIA's CUDA C++ documentation), so about 1.5 us at 132 SMs and
// 1.98 GHz; the operands are 0.27 MB, 0.08 us at 3.35 TB/s.  So it is
// bound by operations, and at these sizes a launch costs more than
// either.
//
// Design, simple and right first:
// * One block of 128 threads per (32 batch rows, 64 clauses) tile; each
//   thread counts a 4 x 4 register tile, so every word it loads from
//   shared memory feeds four POPCs (8 loads per 16 POPCs keeps shared
//   memory below the POPC rate).
// * K runs inside the block in chunks of KW words, each loaded into
//   shared memory synchronously (load -> __syncthreads -> count), the
//   counterpart of the TPU kernel's grid-blocked K axis.  The include
//   chunk is stored [clause][KW + 1]: the pad word keeps the sixteen
//   clause columns a warp reads in sixteen banks.
// * No sequential grid: each tile adds its sums to the output with
//   atomicAdd (exact for integers) instead of the TPU kernel's carry of
//   one [bt, M] block across the clause axis.
// * Integer arithmetic only: no float, no tensor cores.
// * Later work: a tile shaped to small B (at B = 8 three quarters of each
//   block's rows are padding), several K chunks in flight.

#include "tm_common.cuh"

namespace {

constexpr int KW = 16;          // words per K chunk
constexpr int INC_STRIDE = KW + 1;

__global__ void __launch_bounds__(tmk::THREADS) tm_infer_packed_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int Lw, int C, int M) {
  __shared__ uint32_t lit_s[tmk::BT][KW];
  __shared__ uint32_t inc_s[tmk::CT][INC_STRIDE];
  __shared__ uint32_t fired_s[tmk::BT][tmk::FW];
  const tmk::Tile t;
  tmk::clear_fired(fired_s);

  int viol[tmk::TB][tmk::TC] = {};
  for (int k0 = 0; k0 < Lw; k0 += KW) {
    const int kn = min(KW, Lw - k0);
    __syncthreads();                 // the last chunk has been counted
    for (int i = threadIdx.x; i < tmk::BT * KW; i += tmk::THREADS) {
      const int bl = i / KW, kk = i % KW;
      const size_t at = static_cast<size_t>(t.b0 + bl) * Lw + k0 + kk;
      lit_s[bl][kk] = (t.b0 + bl < B && kk < kn)
                          ? static_cast<uint32_t>(litw[at]) : 0u;
    }
    for (int i = threadIdx.x; i < tmk::CT * KW; i += tmk::THREADS) {
      const int cl = i / KW, kk = i % KW;
      const size_t at = static_cast<size_t>(t.c0 + cl) * Lw + k0 + kk;
      inc_s[cl][kk] = (t.c0 + cl < C && kk < kn)
                          ? static_cast<uint32_t>(incw[at]) : 0u;
    }
    __syncthreads();
    tmk::count_words(&lit_s[0][0], KW, &inc_s[0][0], INC_STRIDE, kn, t, viol);
  }

  tmk::mark_fired(viol, t, B, C, fired_s);
  __syncthreads();
  tmk::combine(fired_s, comb, out, t, B, M);
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tm_infer_packed_launch(const void* litw, const void* incw,
                                      const void* comb, void* out, int B,
                                      int Lw, int C, int M, void* stream) {
  tm_infer_packed_kernel<<<tmk::grid_for(B, C), tmk::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<const int32_t*>(comb), static_cast<int32_t*>(out), B, Lw,
      C, M);
  return static_cast<int>(cudaGetLastError());
}
