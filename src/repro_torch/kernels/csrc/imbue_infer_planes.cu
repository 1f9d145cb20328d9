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
// Bound at imbue-tm-mnist (C = 2000, L = 1568, M = 10), R = 4, B = 128:
// it must read the [4, 2000, 1568] float32 deviation plane (50.2 MB,
// about 15 us at 3.35 TB/s) and do at least 4*R*B*C*L = 6.4 GFLOP of fp32
// work (a select and an add per cell for the column current, the bit
// test and the compare amortised; about 96 us at 67 TFLOP/s on an SXM
// card's CUDA cores).  So it is bound by operations, not bytes.
//
// Design, simple and right first:
// * One block per (batch tile of 32 rows, clause tile of 64 clauses,
//   replica): R is a grid axis, so a whole stack is one launch.  Batch
//   tiles are the fastest grid axis, so the blocks that share a clause
//   tile's deviation rows run together and re-read them from L2.
// * One thread per clause.  For each column it rebuilds the 32 cells'
//   (v_read * g, leak) pairs in registers, once, and reuses them for all
//   32 rows of its batch tile: the divisions are paid once per column
//   and tile, the inner loop is a select and an add per cell.  The
//   literal words of the tile are staged in shared memory and read as
//   warp-wide broadcasts.
// * The per-row AND is a 32-bit mask in a register; four rows are summed
//   at once for instruction-level parallelism.
// * The clause tile's votes are summed with a warp reduction and added
//   to the int32 output with atomicAdd: exact in any order, unlike the
//   TPU kernel's carry across sequential grid steps.
// * FP32 on the CUDA cores, never tensor cores or TF32: the thresholded
//   currents must be IEEE float32.  r, g and leak are built with
//   __fadd_rn/__fmul_rn/__fdiv_rn in the reference's op order, so no
//   FMA contraction or approximate division changes them and nominal
//   and off-nominal cells reconstruct bit for bit.  Build without
//   --use_fast_math.
// * Later work: a Philox C2C draw inside the kernel (the wrapper draws
//   C2C beforehand), wgmma/TMA, and early exit for clauses already dead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WORD = 32;   // literals per packed word == cells per column
constexpr int CT = 64;     // clauses per block, one per thread
constexpr int BT = 32;     // batch rows per block, one bit of the AND mask
constexpr int KCH = 32;    // literal words staged in shared memory at once
constexpr int ILP = 4;     // rows summed together in the inner loop

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

template <bool HAS_DEV>
__global__ void __launch_bounds__(CT) imbue_infer_planes_kernel(
    const int32_t* __restrict__ litw,   // [B, Lw] literal words
    const int32_t* __restrict__ incw,   // [C, Lw] include-index words
    const float* __restrict__ dev,      // [R, C, l_valid] r - r_nom
    const int32_t* __restrict__ pol,    // [C, M] signed one-hot x nonempty
    int32_t* __restrict__ out,          // [R, B, M], zeroed by the caller
    int B, int Lw, int C, int M, Scalars s) {
  __shared__ uint32_t lit_s[BT][KCH];

  const int b0 = blockIdx.x * BT;
  const int c = blockIdx.y * CT + threadIdx.x;
  const int r = blockIdx.z;
  const int nb = min(BT, B - b0);
  const bool c_ok = c < C;
  const int c_row = c_ok ? c : 0;
  const int32_t* inc_row = incw + static_cast<size_t>(c_row) * Lw;
  const float* dev_row =
      HAS_DEV ? dev + (static_cast<size_t>(r) * C + c_row) * s.l_valid
              : nullptr;

  // Nominal cells: r == r_nom, so leak == leak_nom * 1 exactly.
  const float g_lrs = __fdiv_rn(1.0f, __fmul_rn(s.series, s.r_lrs));
  const float g_hrs = __fdiv_rn(1.0f, __fmul_rn(s.series, s.r_hrs));

  uint32_t alive = 0xffffffffu;   // bit i: clause still fires for row b0+i

  for (int k0 = 0; k0 < Lw; k0 += KCH) {
    const int kn = min(KCH, Lw - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * KCH; i += CT) {
      const int bi = i / KCH, ki = i % KCH;
      lit_s[bi][ki] =
          (bi < nb && ki < kn)
              ? static_cast<uint32_t>(
                    litw[static_cast<size_t>(b0 + bi) * Lw + k0 + ki])
              : 0u;
    }
    __syncthreads();

    for (int ki = 0; ki < kn; ++ki) {
      const int k = k0 + ki;
      const uint32_t inc = c_ok ? static_cast<uint32_t>(inc_row[k]) : 0u;
      float on[WORD], lk[WORD];
#pragma unroll
      for (int j = 0; j < WORD; ++j) {
        const int lit = k * WORD + j;
        const bool valid = lit < s.l_valid;
        const bool bit = (inc >> j) & 1u;
        const float leak_nom = bit ? s.leak_inc : s.leak_exc;
        float g, leak;
        if (HAS_DEV) {
          const float r_nom = bit ? s.r_lrs : s.r_hrs;
          const float d = (c_ok && valid) ? dev_row[lit] : 0.0f;
          const float rr = __fadd_rn(r_nom, d);
          g = __fdiv_rn(1.0f, __fmul_rn(s.series, rr));
          leak = __fmul_rn(leak_nom, __fdiv_rn(r_nom, rr));
        } else {
          g = bit ? g_lrs : g_hrs;
          leak = leak_nom;
        }
        on[j] = valid ? __fmul_rn(s.v_read, g) : 0.0f;
        lk[j] = valid ? leak : 0.0f;
      }
      for (int b = 0; b < nb; b += ILP) {
        uint32_t w[ILP];
        float acc[ILP];
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          w[q] = lit_s[b + q][ki];
          acc[q] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < WORD; ++j) {
#pragma unroll
          for (int q = 0; q < ILP; ++q) {
            acc[q] += ((w[q] >> j) & 1u) ? lk[j] : on[j];
          }
        }
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (!(acc[q] < s.i_ref)) alive &= ~(1u << (b + q));
        }
      }
    }
  }

  // Rows past the batch edge and clauses past C never vote.
  if (nb < BT) alive &= (1u << nb) - 1u;
  if (!c_ok) alive = 0u;

  const int lane = threadIdx.x & (WORD - 1);
  for (int m = 0; m < M; ++m) {
    const int p = c_ok ? pol[static_cast<size_t>(c_row) * M + m] : 0;
    if (!__any_sync(0xffffffffu, p != 0)) continue;       // warp-uniform
    for (int b = 0; b < nb; ++b) {
      const int v = ((alive >> b) & 1u) ? p : 0;
      const int sum = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && sum != 0) {
        atomicAdd(&out[(static_cast<size_t>(r) * B + b0 + b) * M + m], sum);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; `dev` may be null (nominal stack, R must be 1).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imbue_infer_planes_launch(
    const void* litw, const void* incw, const void* dev, const void* pol,
    void* out, int R, int B, int Lw, int C, int M, int l_valid, float i_ref,
    float v_read, float r_lrs, float r_hrs, float leak_inc, float leak_exc,
    float series, void* stream) {
  const Scalars s{i_ref, v_read, r_lrs, r_hrs, leak_inc, leak_exc, series,
                  l_valid};
  const dim3 grid((B + BT - 1) / BT, (C + CT - 1) / CT, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const int32_t*>(litw);
  const auto* iw = static_cast<const int32_t*>(incw);
  const auto* dv = static_cast<const float*>(dev);
  const auto* pl = static_cast<const int32_t*>(pol);
  auto* o = static_cast<int32_t*>(out);
  if (dv != nullptr) {
    imbue_infer_planes_kernel<true><<<grid, CT, 0, st>>>(lw, iw, dv, pl, o,
                                                         B, Lw, C, M, s);
  } else {
    imbue_infer_planes_kernel<false><<<grid, CT, 0, st>>>(lw, iw, dv, pl, o,
                                                          B, Lw, C, M, s);
  }
  return static_cast<int>(cudaGetLastError());
}
