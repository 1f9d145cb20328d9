// imbue_infer: analog IMBUE class sums from dense 0/1 literal bytes and
// dense float32 conductance / leak planes, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/imbue_infer.py :: imbue_infer_kernel
//   (launched by imbue_infer_call).
//
// What it computes, per replica r, batch row b and clause c, over the
// clause's 32-cell CSA columns k (literals 32k .. 32k + 31):
//   i_col   = sum over the column's cells j = 0..31, in that order, of
//             lit ? leak[r, c, l] : v_read * g[r, c, l]     (l = 32k + j)
//             (cells past L add 0)
//   partial = i_col < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m].  g and leak are read as
// given, in the state's own [R, C, L] layout: the caller builds them
// (with the read's C2C draw) in the reference's op order.
//
// The TPU kernel takes the drive voltages (1 - lit) * v_read and the
// literals as two float32 [B, L] planes.  Here the literals arrive as the
// dense batcher's queue holds them, one byte each ([B, L] uint8), and a
// block folds each row's 32 bytes of a column into one word (byte_word in
// imbue_core.cuh: two 16-byte loads when L is a multiple of 16).
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
// (coalesced, 16-byte chunks when L % 16 == 0) and each lane forms its
// clause's 32 pairs (on = v_read * g as __fmul_rn, leak as read) in
// registers once for all of the block's rows (imbue::DenseCells, shared
// with imbue_infer_packed.cu); the literal words are built from the
// bytes into shared memory.

#include "imbue_core.cuh"

namespace {

using imbue::WORD;

// VEC: L % 16 == 0 and every operand 16-byte aligned: 16-byte copies of
// the cells and two 16-byte loads a literal word.
template <bool VEC>
struct DenseSource {
  static constexpr int kPlanes = imbue::DenseCells<VEC>::kPlanes;
  static constexpr bool kClauseWords = false;

  imbue::DenseCells<VEC> planes;
  const uint8_t* lits;   // [B, L] 0/1 bytes
  int B, L, Lw;

  __device__ void stage(float* cells, uint32_t*, uint32_t* words, int r,
                        int c0, int b0, int rows, int k) const {
    planes.stage(cells, r, c0, k);
    for (int i = threadIdx.x & (WORD - 1); i < rows; i += WORD) {
      const int b = b0 + i;
      words[i] = b < B && k < Lw ? imbue::byte_word<VEC>(lits, b, k, L) : 0u;
    }
  }

  __device__ void column(const float* cells, const uint32_t*, int,
                         float (&on)[WORD], float (&lk)[WORD]) const {
    planes.column(cells, on, lk);
  }
};

template <bool VEC>
int run(const void* lits, const void* g, const void* leak, const void* pol,
        void* out, void* rows_run, int B, int L, int C, int M,
        float i_ref, float v_read, const imbue::Geometry& geo,
        cudaStream_t st) {
  const int Lw = (L + WORD - 1) / WORD;
  const DenseSource<VEC> src{{static_cast<const float*>(g),
                              static_cast<const float*>(leak), v_read, C, L},
                             static_cast<const uint8_t*>(lits), B, L, Lw};
  return imbue::launch(src, static_cast<const int32_t*>(pol),
                       static_cast<int32_t*>(out),
                       static_cast<unsigned long long*>(rows_run), B, C, M,
                       Lw, i_ref, geo, st);
}

// ks == ng == 0: imbue::choose's geometry; else the tile override.
int dense_launch(const void* lits, const void* g, const void* leak,
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
  if (L % 16 == 0 && aligned(lits) && aligned(g) && aligned(leak)) {
    return run<true>(lits, g, leak, pol, out, rows_run, B, L, C, M,
                     i_ref, v_read, geo, st);
  }
  return run<false>(lits, g, leak, pol, out, rows_run, B, L, C, M, i_ref,
                    v_read, geo, st);
}

}  // namespace

// lits [B, L] uint8, g / leak [R, C, L] float32, pol [C, M] int32,
// out [R, B, M] int32 zeroed by the caller; the tile override ks column
// splits, ng row groups (both 0 for imbue::choose's geometry).  Returns
// cudaGetLastError() after the launch (0 on success), or
// imbue::TILE_INVALID, launching nothing, for a tile outside its set,
// ks > ceil(L / 32), or shared memory over the card's opt-in limit.
extern "C" int imbue_infer_launch(
    const void* lits, const void* g, const void* leak, const void* pol,
    void* out, int R, int B, int L, int C, int M, float i_ref, float v_read,
    int ks, int ng, void* stream) {
  return dense_launch(lits, g, leak, pol, out, R, B, L, C, M, i_ref, v_read,
                      ks, ng, nullptr, stream);
}

// The launch at imbue::choose's geometry, adding to `*rows_run` (one
// uint64 on the card) the (warp, row, column) steps its warps summed, of
// R * ceil(C / 32) * B * ceil(L / 32).  For measurement only.
extern "C" int imbue_infer_launch_counted(const void* lits, const void* g,
                                          const void* leak, const void* pol,
                                          void* out, int R, int B, int L,
                                          int C, int M, float i_ref,
                                          float v_read, void* rows_run,
                                          void* stream) {
  return dense_launch(lits, g, leak, pol, out, R, B, L, C, M, i_ref, v_read,
                      0, 0, rows_run, stream);
}

// The launch geometry at (R, B, C, L) with the tile override (ks, ng;
// both 0 for imbue::choose's): `info` as imbue::describe fills it.
// Returns the CUDA error, or imbue::TILE_INVALID as the launch does.
extern "C" int imbue_infer_geometry(int R, int B, int C, int L, int ks,
                                    int ng, int* info) {
  imbue::Geometry geo;
  if (!imbue::geometry(R, B, C, (L + WORD - 1) / WORD, ks, ng, geo)) {
    return imbue::TILE_INVALID;
  }
  return imbue::describe<DenseSource<true>>(geo, info);
}
