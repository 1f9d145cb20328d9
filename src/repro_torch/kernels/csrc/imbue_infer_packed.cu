// imbue_infer_packed: analog IMBUE class sums from packed literal words
// and dense float32 conductance / leak planes, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/imbue_infer.py :: imbue_infer_packed_kernel
//   (launched by imbue_infer_packed_call).
//
// What it computes, per replica r, batch row b and clause c, over the
// clause's 32-cell CSA columns k (literals 32k .. 32k + 31, one packed
// word each):
//   i_col   = sum over the column's cells j = 0..31, in that order, of
//             lit ? leak[r, c, l] : v_read * g[r, c, l]     (l = 32k + j)
//             (cells past L add 0)
//   partial = i_col < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m].  g and leak are read as
// given, in the state's own [R, C, L] layout.  The same function as
// imbue_infer.cu, whose literals arrive as one byte each.
//
// The TPU kernel streams [bt, kt/32] literal words and unpacks them to
// drive voltages per K tile in VMEM before two narrow dots per column.
//
// Bound on an H100 SXM at imbue-tm-mnist (C = 2000, L = 1568, M = 10),
// R = 4: the two float32 planes are 100.4 MB, 0.030 ms at 3.35 TB/s,
// whatever B is; 4 * R * B * C * L fp32 operations are 0.096 ms at
// B = 128 (67 TFLOP/s), so bound by operations there and by bytes at
// B = 8.  The inner loop's issue floor at B = 128 is 0.144 ms
// (imbue_core.cuh).
//
// Design: imbue_core.cuh's, with this source: per warp and column the
// g and leak cells of the block's 32 clauses are staged with cp.async
// (coalesced, 16-byte chunks when L % 4 == 0) and each lane forms its
// clause's 32 pairs in registers once for all of the block's rows
// (imbue::DenseCells, shared with imbue_infer.cu); the block's literal
// words of the column are staged with cp.async as they are (4-byte
// copies: a word needs no alignment), as imbue_infer_planes.cu stages
// its own.

#include "imbue_core.cuh"

namespace {

using imbue::WORD;

// VEC: L % 4 == 0 and g / leak 16-byte aligned: 16-byte cell copies.
template <bool VEC>
struct PackedSource {
  static constexpr int kPlanes = imbue::DenseCells<VEC>::kPlanes;
  static constexpr bool kClauseWords = false;

  imbue::DenseCells<VEC> planes;
  const int32_t* litw;   // [B, Lw] literal words
  int B, Lw;

  __device__ void stage(float* cells, uint32_t*, uint32_t* words, int r,
                        int c0, int b0, int rows, int k) const {
    planes.stage(cells, r, c0, k);
    imbue::stage_words(words, litw, B, Lw, b0, rows, k);
  }

  __device__ void column(const float* cells, const uint32_t*, int,
                         float (&on)[WORD], float (&lk)[WORD]) const {
    planes.column(cells, on, lk);
  }
};

template <bool VEC>
int run(const void* litw, const void* g, const void* leak, const void* pol,
        void* out, void* rows_run, int B, int L, int C, int M,
        float i_ref, float v_read, const imbue::Geometry& geo,
        cudaStream_t st) {
  const int Lw = (L + WORD - 1) / WORD;
  const PackedSource<VEC> src{{static_cast<const float*>(g),
                               static_cast<const float*>(leak), v_read, C,
                               L},
                              static_cast<const int32_t*>(litw), B, Lw};
  return imbue::launch(src, static_cast<const int32_t*>(pol),
                       static_cast<int32_t*>(out),
                       static_cast<unsigned long long*>(rows_run), B, C, M,
                       Lw, i_ref, geo, st);
}

// ks == ng == 0: imbue::choose's geometry; else the tile override.
int packed_launch(const void* litw, const void* g, const void* leak,
                  const void* pol, void* out, int R, int B, int L, int C,
                  int M, float i_ref, float v_read, int ks, int ng,
                  void* rows_run, void* stream) {
  imbue::Geometry geo;
  if (!imbue::geometry(R, B, C, (L + WORD - 1) / WORD, ks, ng, geo)) {
    return imbue::TILE_INVALID;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (L % 4 == 0 && aligned(g) && aligned(leak)) {
    return run<true>(litw, g, leak, pol, out, rows_run, B, L, C, M,
                     i_ref, v_read, geo, st);
  }
  return run<false>(litw, g, leak, pol, out, rows_run, B, L, C, M, i_ref,
                    v_read, geo, st);
}

}  // namespace

// litw [B, ceil(L/32)] int32, g / leak [R, C, L] float32, pol [C, M] int32,
// out [R, B, M] int32 zeroed by the caller; the tile override ks column
// splits, ng row groups (both 0 for imbue::choose's geometry).  Returns
// cudaGetLastError() after the launch (0 on success), or
// imbue::TILE_INVALID, launching nothing, for a tile outside its set,
// ks > ceil(L / 32), or shared memory over the card's opt-in limit.
extern "C" int imbue_infer_packed_launch(
    const void* litw, const void* g, const void* leak, const void* pol,
    void* out, int R, int B, int L, int C, int M, float i_ref, float v_read,
    int ks, int ng, void* stream) {
  return packed_launch(litw, g, leak, pol, out, R, B, L, C, M, i_ref, v_read,
                       ks, ng, nullptr, stream);
}

// The launch at imbue::choose's geometry, adding to `*rows_run` (one
// uint64 on the card) the (warp, row, column) steps its warps summed, of
// R * ceil(C / 32) * B * ceil(L / 32).  For measurement only.
extern "C" int imbue_infer_packed_launch_counted(
    const void* litw, const void* g, const void* leak, const void* pol,
    void* out, int R, int B, int L, int C, int M, float i_ref, float v_read,
    void* rows_run, void* stream) {
  return packed_launch(litw, g, leak, pol, out, R, B, L, C, M, i_ref, v_read,
                       0, 0, rows_run, stream);
}

// The launch geometry at (R, B, C, L) with the tile override (ks, ng;
// both 0 for imbue::choose's): `info` as imbue::describe fills it.
// Returns the CUDA error, or imbue::TILE_INVALID as the launch does.
extern "C" int imbue_infer_packed_geometry(int R, int B, int C, int L,
                                           int ks, int ng, int* info) {
  imbue::Geometry geo;
  if (!imbue::geometry(R, B, C, (L + WORD - 1) / WORD, ks, ng, geo)) {
    return imbue::TILE_INVALID;
  }
  return imbue::describe<PackedSource<true>>(geo, info);
}
