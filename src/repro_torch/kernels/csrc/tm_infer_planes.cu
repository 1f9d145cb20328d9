// tm_infer_planes: digital / coalesced TM class sums with the resident
// include bitplane streamed through a two-stage cp.async ring, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/clause_eval.py :: tm_infer_planes_kernel
//   (launched by tm_infer_planes_call).
//
// What it computes: the same integer function as tm_infer_packed.cu (see
// tm_common.cuh),
//   viol[b, c] = sum over words w of popc(~litw[b, w] & incw[c, w])
//   out[b, m] += (viol[b, c] == 0) * comb[c, m]
// reading the state's plane_index in its own [C, Lw] int32 layout (the
// TPU path transposes it to [Lw, C] on every dispatch; this one does
// not).
//
// Bound, at the coalesced serving width (C = 1000, Lw = 49, M = 10) and
// B = 128: 6.3 M word steps of LOP3 + POPC + IADD, about 1.5 us at the
// POPC rate (16 per clock per SM on compute capability 9.0, 132 SMs,
// 1.98 GHz); 0.27 MB of operands, 0.08 us at 3.35 TB/s.  Bound by
// operations; at these sizes a launch costs more than either.
//
// Design, simple and right first:
// * One block of 128 threads per (32 batch rows, 64 clauses) tile, a
//   4 x 4 register tile of counts per thread (tm_common.cuh).
// * The block's literal words [32, Lw] are loaded once into dynamic
//   shared memory and stay resident, as the TPU kernel keeps its
//   [bt, Lw] literal block in VMEM.
// * The clause tile's include words stream in chunks of KW words through
//   a two-stage ring in shared memory filled by cp.async (4-byte copies:
//   a [C, Lw] row is not 16-byte aligned for odd Lw; out-of-range words
//   are zero-filled by a source size of 0).  Chunk k + 1's copy is in
//   flight while chunk k is counted: the counterpart of the TPU kernel's
//   2-slot make_async_copy.  The chunk is stored [clause][KW + 1] so that
//   a warp's sixteen clause columns sit in sixteen banks.
// * No sequential grid: each tile adds its sums to the output with
//   atomicAdd (exact for integers).
// * Integer arithmetic only.
// * Later work: a tile shaped to small B, TMA bulk copies of the chunk.

#include "tm_common.cuh"

namespace {

constexpr int KW = 16;          // include words per ring stage
constexpr int INC_STRIDE = KW + 1;

// Issues the copies of the include words [k0, k0 + KW) of the block's
// clause tile into one ring slot, as one group.  Consecutive threads copy
// consecutive words of a clause row.
__device__ __forceinline__ void stage(const int32_t* __restrict__ incw,
                                      uint32_t (*slot)[INC_STRIDE],
                                      const tmk::Tile& t, int k0, int Lw,
                                      int C) {
  for (int i = threadIdx.x; i < tmk::CT * KW; i += tmk::THREADS) {
    const int cl = i / KW, kk = i % KW;
    const int c = t.c0 + cl, k = k0 + kk;
    const bool valid = c < C && k < Lw;
    tmk::cp_async4(&slot[cl][kk],
                   valid ? incw + static_cast<size_t>(c) * Lw + k : incw,
                   valid);
  }
  tmk::cp_async_commit();
}

__global__ void __launch_bounds__(tmk::THREADS) tm_infer_planes_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words (plane_index)
    const int32_t* __restrict__ comb,   // [C, M] combine matrix
    int32_t* __restrict__ out,          // [B, M], zeroed by the caller
    int B, int Lw, int C, int M) {
  extern __shared__ uint32_t lit_s[];   // [BT, Lw], resident
  __shared__ uint32_t inc_s[2][tmk::CT][INC_STRIDE];
  __shared__ uint32_t fired_s[tmk::BT][tmk::FW];
  const tmk::Tile t;
  const int nk = (Lw + KW - 1) / KW;

  stage(incw, inc_s[0], t, 0, Lw, C);
  for (int i = threadIdx.x; i < tmk::BT * Lw; i += tmk::THREADS) {
    const int b = t.b0 + i / Lw;
    lit_s[i] = b < B ? static_cast<uint32_t>(
                           litw[static_cast<size_t>(t.b0) * Lw + i])
                     : 0u;
  }
  tmk::clear_fired(fired_s);

  int viol[tmk::TB][tmk::TC] = {};
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {               // its slot was freed by the last barrier
      stage(incw, inc_s[(kc + 1) & 1], t, (kc + 1) * KW, Lw, C);
    } else {
      tmk::cp_async_commit();        // empty group: keeps "wait 1" exact
    }
    tmk::cp_async_wait_one();        // this thread's copies of chunk kc
    __syncthreads();                 // ... and every other thread's
    const int k0 = kc * KW;
    tmk::count_words(lit_s + k0, Lw, &inc_s[kc & 1][0][0], INC_STRIDE,
                    min(KW, Lw - k0), t, viol);
    __syncthreads();                 // slot kc & 1 may be refilled
  }

  tmk::mark_fired(viol, t, B, C, fired_s);
  __syncthreads();
  tmk::combine(fired_s, comb, out, t, B, M);
}

}  // namespace

// Launch on `stream`.  The literal tile takes 32 * Lw * 4 bytes of dynamic
// shared memory; above 48 KB the kernel is opted in to more (up to the
// card's 227 KB per block, less the ring).  Returns the CUDA error of the
// attribute call or of the launch (0 on success).
extern "C" int tm_infer_planes_launch(const void* litw, const void* incw,
                                      const void* comb, void* out, int B,
                                      int Lw, int C, int M, void* stream) {
  const size_t smem = static_cast<size_t>(tmk::BT) * Lw * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tm_infer_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tm_infer_planes_kernel<<<tmk::grid_for(B, C), tmk::THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<const int32_t*>(comb), static_cast<int32_t*>(out), B, Lw,
      C, M);
  return static_cast<int>(cudaGetLastError());
}
