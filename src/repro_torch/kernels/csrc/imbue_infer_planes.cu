// imbue_infer_planes: analog IMBUE class sums from a plane-packed replica
// stack, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/imbue_infer.py :: imbue_infer_planes_kernel
//   (launched by imbue_infer_planes_call).
//
// What it computes, per replica r, batch row b and clause c, over the
// clause's 32-literal CSA columns k (one packed word each):
//   bit   = include bit of (c, literal)            (index bitplane)
//   r_nom = bit ? r_lrs : r_hrs,   r = r_nom + dev  (no dev when nominal)
//   g     = 1 / (series * r),      leak = leak_nom * (r_nom / r)
//   both zero for literal >= l_valid (word padding)
//   i_col = sum over the column's 32 cells of
//           lit ? leak : v_read * g
//   partial = i_col < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m].
//
// Bound on an H100 SXM at imbue-tm-mnist (C = 2000, L = 1568, M = 10),
// R = 4, B = 128: the [4, 2000, 1568] float32 deviation plane is 50.2 MB
// (0.015 ms at 3.35 TB/s); 4 * R * B * C * L = 6.4 GFLOP of fp32 work is
// 0.096 ms at 67 TFLOP/s, so it is bound by operations.  Its inner loop
// issues at least three instructions a (row, cell): 0.144 ms, the issue
// floor (imbue_core.cuh).
//
// Design: the tiling, the inner loop, the early exit and the votes are
// imbue_core.cuh's.  This file's source stages, per warp and column, the
// deviation cells of the block's 32 clauses (cp.async, coalesced) and
// their include words, and rebuilds the column's 32 pairs in registers
// once for all of the block's rows (64 at R = 4, B = 128, where the grid
// needs 64-row blocks to hold 16 warps an SM; 128 where it is full
// enough without).  A nominal stack (no deviation plane) stages only the
// words: its pairs are two constants selected by the include bit.
// r, g and leak are built with __fadd_rn / __fmul_rn / __fdiv_rn in the
// reference's op order, so no FMA contraction or approximate division
// changes them and nominal and off-nominal cells reconstruct bit for bit.

#include "imbue_core.cuh"

namespace {

using imbue::ROW;
using imbue::WORD;

struct Scalars {
  float i_ref;       // v_ref / r_divider
  float v_read;      // literal '0' drive voltage
  float r_lrs;       // nominal include resistance
  float r_hrs;       // nominal exclude resistance
  float leak_inc;    // nominal leak at literal '1', include cell
  float leak_exc;    // nominal leak at literal '1', exclude cell
  float series;      // 1T1R read-path series factor
  int l_valid;       // real literal count; later bits are word padding
};

// HAS_DEV: a deviation plane [R, C, l_valid]; VEC: its rows take 16-byte
// copies (l_valid % 4 == 0, 16-byte aligned).
template <bool HAS_DEV, bool VEC>
struct PlaneSource {
  static constexpr int kPlanes = HAS_DEV ? 1 : 0;
  static constexpr bool kClauseWords = true;

  const int32_t* litw;   // [B, Lw] literal words
  const int32_t* incw;   // [C, Lw] include-index words
  const float* dev;      // [R, C, l_valid] r - r_nom, or null
  Scalars s;
  int B, C, Lw;

  __device__ void stage(float* cells, uint32_t* cwords, uint32_t* lits,
                        int r, int c0, int b0, int rows, int k) const {
    const int lane = threadIdx.x & (WORD - 1);
    if (HAS_DEV) {
      imbue::stage_cells<VEC>(
          cells, dev + static_cast<size_t>(r) * C * s.l_valid, s.l_valid, C,
          c0, k);
    }
    const int c = c0 + lane;
    const bool ok = c < C && k < Lw;
    imbue::cp_async4(cwords + lane,
                     ok ? incw + static_cast<size_t>(c) * Lw + k : incw,
                     ok ? 4 : 0);
    imbue::stage_words(lits, litw, B, Lw, b0, rows, k);
  }

  __device__ void column(const float* cells, const uint32_t* cwords, int k,
                         float (&on)[WORD], float (&lk)[WORD]) const {
    const int lane = threadIdx.x & (WORD - 1);
    const uint32_t inc = cwords[lane];
    float d[WORD];
    if (HAS_DEV) imbue::read_row(cells + lane * ROW, d);
    // Nominal cells: r == r_nom, so leak == leak_nom * 1 exactly.
    const float g_lrs = __fdiv_rn(1.0f, __fmul_rn(s.series, s.r_lrs));
    const float g_hrs = __fdiv_rn(1.0f, __fmul_rn(s.series, s.r_hrs));
#pragma unroll
    for (int j = 0; j < WORD; ++j) {
      const bool valid = k * WORD + j < s.l_valid;
      const bool bit = (inc >> j) & 1u;
      const float leak_nom = bit ? s.leak_inc : s.leak_exc;
      float g, leak;
      if (HAS_DEV) {
        const float r_nom = bit ? s.r_lrs : s.r_hrs;
        const float rr = __fadd_rn(r_nom, d[j]);
        g = __fdiv_rn(1.0f, __fmul_rn(s.series, rr));
        leak = __fmul_rn(leak_nom, __fdiv_rn(r_nom, rr));
      } else {
        g = bit ? g_lrs : g_hrs;
        leak = leak_nom;
      }
      on[j] = valid ? __fmul_rn(s.v_read, g) : 0.0f;
      lk[j] = valid ? leak : 0.0f;
    }
  }
};

template <bool HAS_DEV, bool VEC>
int run(const int32_t* litw, const int32_t* incw, const float* dev,
        const int32_t* pol, int32_t* out, unsigned long long* rows_run,
        int R, int B, int Lw, int C, int M, const Scalars& s,
        cudaStream_t st) {
  const PlaneSource<HAS_DEV, VEC> src{litw, incw, dev, s, B, C, Lw};
  return imbue::launch(src, pol, out, rows_run, B, C, M, Lw, s.i_ref,
                       imbue::choose(R, B, C, Lw), st);
}

int planes_launch(const void* litw, const void* incw, const void* dev,
                  const void* pol, void* out, int R, int B, int Lw, int C,
                  int M, int l_valid, float i_ref, float v_read, float r_lrs,
                  float r_hrs, float leak_inc, float leak_exc, float series,
                  void* rows_run, void* stream) {
  const Scalars s{i_ref, v_read, r_lrs, r_hrs, leak_inc, leak_exc, series,
                  l_valid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const int32_t*>(litw);
  const auto* iw = static_cast<const int32_t*>(incw);
  const auto* dv = static_cast<const float*>(dev);
  const auto* pl = static_cast<const int32_t*>(pol);
  auto* o = static_cast<int32_t*>(out);
  auto* rr = static_cast<unsigned long long*>(rows_run);
  if (dv == nullptr) {
    return run<false, false>(lw, iw, dv, pl, o, rr, R, B, Lw, C, M, s, st);
  }
  if (l_valid % 4 == 0 && reinterpret_cast<uintptr_t>(dv) % 16 == 0) {
    return run<true, true>(lw, iw, dv, pl, o, rr, R, B, Lw, C, M, s, st);
  }
  return run<true, false>(lw, iw, dv, pl, o, rr, R, B, Lw, C, M, s, st);
}

}  // namespace

// Launch on `stream`; `dev` may be null (nominal stack, R must be 1).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imbue_infer_planes_launch(
    const void* litw, const void* incw, const void* dev, const void* pol,
    void* out, int R, int B, int Lw, int C, int M, int l_valid, float i_ref,
    float v_read, float r_lrs, float r_hrs, float leak_inc, float leak_exc,
    float series, void* stream) {
  return planes_launch(litw, incw, dev, pol, out, R, B, Lw, C, M, l_valid,
                       i_ref, v_read, r_lrs, r_hrs, leak_inc, leak_exc,
                       series, nullptr, stream);
}

// The same launch, adding to `*rows_run` (one uint64 on the card) the
// (warp, row, column) steps its warps summed: the early exit skipped the
// rest of R * ceil(C / 32) * B * Lw.  For measurement only.
extern "C" int imbue_infer_planes_launch_counted(
    const void* litw, const void* incw, const void* dev, const void* pol,
    void* out, int R, int B, int Lw, int C, int M, int l_valid, float i_ref,
    float v_read, float r_lrs, float r_hrs, float leak_inc, float leak_exc,
    float series, void* rows_run, void* stream) {
  return planes_launch(litw, incw, dev, pol, out, R, B, Lw, C, M, l_valid,
                       i_ref, v_read, r_lrs, r_hrs, leak_inc, leak_exc,
                       series, rows_run, stream);
}

// The launch geometry at (R, B, C, Lw) with or without a deviation plane:
// `info` as imbue::describe fills it.  Returns the CUDA error.
extern "C" int imbue_infer_planes_geometry(int R, int B, int C, int Lw,
                                           int has_dev, int* info) {
  const imbue::Geometry geo = imbue::choose(R, B, C, Lw);
  return has_dev ? imbue::describe<PlaneSource<true, true>>(geo, info)
                 : imbue::describe<PlaneSource<false, false>>(geo, info);
}
