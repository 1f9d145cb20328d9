// clause_eval_packed: training-time clause bits from packed literal and
// include words, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: clause_eval_packed_kernel
//   (+ _packed_viol_block; launched by clause_eval_packed_call).
//
// What it computes: for batch row b and clause c,
//   viol[b, c]  = sum over words w of popc(~litw[b, w] & incw[c, w])
//   fired[b, c] = (viol[b, c] == 0)            as one uint8 byte
// with litw [B, Lw] and incw [C, Lw] int32 bit patterns (the include
// plane packed in its [C, Lw] layout: nothing is transposed per call).
// Training semantics: an empty clause has no violation, so it fires
// (the inference kernels zero such a clause's combine row instead).
//
// Bound, on the batch training step at imbue-tm-mnist (C = 2000, Lw = 49)
// and B = 256: B*C*Lw = 25.1 M word steps of LOP3 + POPC + IADD.  POPC
// runs at 16 per clock per SM on compute capability 9.0 (the throughput
// table of NVIDIA's CUDA C++ documentation), 4.18e12/s at 132 SMs and
// 1.98 GHz, so about 6 us; the bytes (0.44 MB of words in, 0.51 MB of
// clause bits out) take 0.3 us at 3.35 TB/s.  So it is bound by
// operations.
//
// Design, simple and right first: the tiling of tm_infer_packed.cu (one
// block of 128 threads per 32 rows x 64 clauses, a 4 x 4 register tile a
// thread, K in synchronous shared-memory chunks of KW words, the include
// chunk padded to KW + 1 words a clause so a warp's sixteen clause
// columns sit in sixteen banks), then store_fired writes the tile's bits
// instead of the combine.  Rows >= B and clauses >= C are not written.
// Integer arithmetic only.

#include "tm_common.cuh"

namespace {

constexpr int KW = 16;          // words per K chunk
constexpr int INC_STRIDE = KW + 1;

__global__ void __launch_bounds__(tmk::THREADS) clause_eval_packed_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words
    uint8_t* __restrict__ out,          // [B, C] clause bits
    int B, int Lw, int C) {
  __shared__ uint32_t lit_s[tmk::BT][KW];
  __shared__ uint32_t inc_s[tmk::CT][INC_STRIDE];
  const tmk::Tile t;

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
  tmk::store_fired(viol, t, B, C, out);
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int clause_eval_packed_launch(const void* litw, const void* incw,
                                         void* out, int B, int Lw, int C,
                                         void* stream) {
  clause_eval_packed_kernel<<<tmk::grid_for(B, C), tmk::THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<uint8_t*>(out), B, Lw, C);
  return static_cast<int>(cudaGetLastError());
}
