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
// Rows >= B and clauses >= C are not written.  Integer arithmetic only:
// any split or order of the words gives the same bits.
//
// Bound, on the batch training step at imbue-tm-mnist (C = 2000, Lw = 49)
// and B = 256: B*C*Lw = 25.1 M word steps.  Only viol == 0 is kept, so a
// word step needs one LOP3 (acc | ~l & n, an OR of the violating bits);
// 32-bit logic runs at 64 per clock per SM on compute capability 9.0
// (the throughput table of NVIDIA's CUDA C++ documentation), 1.67e13/s
// at 132 SMs and 1.98 GHz: 1.5 us.  That is the floor on the CUDA cores;
// this kernel counts on the b1 tensor cores instead, whose Hopper rate
// NVIDIA does not publish, so its own floor may lie lower, down to the
// bytes (0.44 MB of words in, 0.51 MB of clause bits out: 0.3 us at 3.35
// TB/s).  Both are below what any launch costs here: the time is a chain
// of launch, one load round trip, a barrier and a store, plus the
// staging traffic from L2.
//
// One block structure, on the single-bit tensor-core core of tm_b1.cuh
// (shared with tm_infer_planes.cu and tm_infer.cu):
// * Staging: one load round trip of the block's literal and include
//   words with 4-byte cp.async (a 196-byte row is not 16-byte aligned),
//   consecutive threads on consecutive words, rows padded to a stride
//   whose lanes fall in distinct banks.  No K-chunk loop at the repo's
//   widths; only rows too long for 48 KB of shared memory go in chunks.
// * The product: mma.sync m16n8k256 b1 with .and.popc (BMMA), A = ~litw,
//   B = incw; a warp takes 16 rows x 32 clauses and every ks-th 8-word
//   step, a block wm x wn such warp tiles (up to 32 warps: 64 x 64 tiles
//   stage a third fewer words than 64 x 32 ones).  The K-split's partial
//   counts meet as flags in the block's [bt, ct] byte tile.
// * Coalesced stores (this file's epilogue): after a barrier a thread
//   writes 4 neighbouring clause bytes of one row (1 - flag), so a warp's
//   stores cover whole 32-byte sectors of [B, C].
// * tmb::choose takes, of the (wm, wn, ks) whose grid holds 16 warps an
//   SM, the one that stages the fewest words (every block stages its rows
//   and clauses once), then the fewest warps; where none does (B <= 64 at
//   Lw = 49: 7 steps of 8 words, one 16-row tile at B < 16), the most
//   warps.

#include "tm_b1.cuh"

namespace {

using tmb::Geo;
using tmb::HIT_PAD;
using tmb::WARPS_MAX;
using tmb::WORD;

__global__ void __launch_bounds__(WARPS_MAX * WORD) eval_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include words
    uint8_t* __restrict__ out,          // [B, C] clause bits
    int B, int Lw, int C, bool vec, Geo geo) {
  extern __shared__ uint32_t smem[];
  const int hs = geo.ct + HIT_PAD;
  uint32_t* lit_s = smem;                               // [bt, lwp]
  uint32_t* inc_s = lit_s + geo.bt * geo.lwp;           // [ct, lwp]
  uint32_t* hit_w = inc_s + geo.ct * geo.lwp;           // [bt, hs] bytes
  uint8_t* hit = reinterpret_cast<uint8_t*>(hit_w);
  const int b0 = blockIdx.x * geo.bt;
  const int c0 = blockIdx.y * geo.ct;
  for (int i = threadIdx.x; i < geo.bt * hs / 4; i += blockDim.x) {
    hit_w[i] = 0u;
  }
  tmb::MmaTile tile(geo);
  for (int k0 = 0; k0 < Lw; k0 += geo.kc) {
    const int kn = min(geo.kc, Lw - k0);
    const int kp = (kn + tmb::MMA_K - 1) / tmb::MMA_K * tmb::MMA_K;
    if (k0 > 0) __syncthreads();        // the last chunk has been read
    tmb::stage(lit_s, geo.lwp, litw, B, Lw, b0, geo.bt, k0, kn, kp);
    tmb::stage(inc_s, geo.lwp, incw, C, Lw, c0, geo.ct, k0, kn, kp);
    tmb::cp_async_commit();
    tmb::cp_async_wait_all();
    __syncthreads();                    // every thread's copies have landed
    tile.count(lit_s, inc_s, geo.lwp, kp);
  }
  tile.mark(hit, hs);
  __syncthreads();
  // 4 clause bytes of one row a thread: fired = 1 - flag.
  const int q4 = geo.ct / 4;
  for (int i = threadIdx.x; i < geo.bt * q4; i += blockDim.x) {
    const int r = i / q4, c = c0 + 4 * (i % q4), b = b0 + r;
    if (b >= B || c >= C) continue;
    const uint32_t v = hit_w[(r * hs) / 4 + i % q4] ^ 0x01010101u;
    uint8_t* o = out + static_cast<size_t>(b) * C + c;
    if (vec && c + 4 <= C) {
      *reinterpret_cast<uint32_t*>(o) = v;
    } else {
      for (int e = 0; e < 4 && c + e < C; ++e) o[e] = (v >> (8 * e)) & 1u;
    }
  }
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int clause_eval_packed_launch(const void* litw, const void* incw,
                                         void* out, int B, int Lw, int C,
                                         void* stream) {
  const Geo g = tmb::choose(B, C, Lw);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  eval_kernel<<<g.grid, g.wm * g.wn * g.ks * WORD, tmb::smem_bytes(g),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litw), static_cast<const int32_t*>(incw),
      static_cast<uint8_t*>(out), B, Lw, C, vec, g);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry at (B, C, Lw): `info` = {grid.x, grid.y, threads,
// shared bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), K-split, row tile,
// clause tile, words staged a chunk}.  Returns the CUDA error.
extern "C" int clause_eval_packed_geometry(int B, int C, int Lw, int* info) {
  return tmb::geometry_info(tmb::choose(B, C, Lw), eval_kernel, info);
}
