// imbue_core.cuh: the column-current core of the three analog kernels,
// imbue_infer_planes.cu (cells rebuilt from a plane-packed stack),
// imbue_infer_packed.cu (cells read from dense g / leak planes, packed
// literal words) and imbue_infer.cu (the same planes, one byte a
// literal).  Each supplies a source that stages a column and builds its
// 32 (v_read * g, leak) pairs; the tiling, the inner loop, the AND, the
// early exit and the votes are here, and so is DenseCells, the g / leak
// half that the two dense sources share.
//
// What it computes, per replica r, batch row b and clause c, over the
// clause's 32-cell CSA columns k (cells 32k .. 32k + 31):
//   acc     = 0; for j = 0..31 in order: acc += lit ? leak : on
//             (on = __fmul_rn(v_read, g); cells past the real literals
//             add 0: on = leak = 0 there)
//   partial = acc < i_ref;   clause = AND over the clause's columns
// and then out[r, b, m] += clause * pol[c, m].  One float32 accumulator
// per (replica, row, clause, column), in the reference's order, so the
// three analog kernels give the same integers on the same cells.
//
// Bound on an H100 SXM (132 SMs) at imbue-tm-mnist (C = 2000, L = 1568,
// Lw = 49 columns), R = 4, B = 128: 4 fp32 operations a (r, b, c, cell),
// 6.4 GFLOP, 0.096 ms at 67 TFLOP/s; the planes' bytes (50 / 100 MB)
// take 0.015 / 0.030 ms.  The inner loop issues at least three
// instructions a (row, cell) (bit test, and two predicated adds of which
// one runs; the IEEE order rules out tensor cores, TF32 and
// reassociation): 4.8e9 thread instructions, 0.144 ms at 132 SMs x 4
// schedulers x 32 lanes x 1.98 GHz, the issue floor.  A select instead
// of the two adds is also three instructions, but two of them (bit test,
// FSEL) go to the half-rate ALU pipe: a 0.192 ms floor.
//
// Design:
// * A block is 32 clauses (one a lane) x KS warps; warp s sums columns
//   s, s + KS, ... (a K-split) for all of the block's rows, NG groups of
//   32 (a 32-bit AND mask each).  The grid is (batch tiles, clause tiles,
//   R): a whole stack is one launch, and blocks that share a clause tile
//   run together and share its cells in L2.  `choose` takes NG as large
//   as the batch needs (every row of a block shares the pairs a warp
//   builds) unless the grid would then hold fewer than 16 warps an SM;
//   then it halves NG and spreads the rows over more blocks.
// * Each warp stages its own column with cp.async, coalesced (lanes
//   along cells, 16-byte chunks where the rows allow), into rows padded
//   to 36 floats (a lane reading its clause's row as float4 hits distinct
//   banks), builds its 32 pairs in registers and issues the next
//   column's copies before it sums this one.  The warps share no barrier
//   until the votes: a K-split that ends unevenly (49 columns on 8 warps)
//   or rows that die early leave no warp waiting on another.
// * Inner loop: four rows at once, unrolled over the 32 cells; the
//   literal word is a shared-memory broadcast.
// * Early exit, exact (an AND that reached 0 stays 0): clauses that
//   never vote (past C or an all-zero polarity row) and rows past B
//   start dead; each warp ANDs its masks into shared memory after every
//   column and reads the others' before the next, sums only the rows
//   alive in some lane (a warp-uniform list), and stops when the block's
//   rows are all dead.
// * Votes: a warp reduction per (row, class), added to the int32 output
//   with atomicAdd, exact in any order.
// * FP32 on the CUDA cores, never tensor cores or TF32: the thresholded
//   currents must be IEEE float32.  Build without --use_fast_math.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace imbue {

constexpr int WORD = 32;         // cells per CSA column == literals a word
constexpr int CT = 32;           // clauses per block, one per lane
constexpr int KS_MAX = 8;        // column splits per block, one per warp
constexpr int ILP = 4;           // rows summed together in the inner loop
constexpr int ROW = WORD + 4;    // padded staged cell row (floats)
constexpr int WARPS_PER_SM = 16; // the grid's warps an SM that NG keeps

// acc += (w & bit) ? lk : on, as two predicated adds: one ALU operation
// (the bit test) a cell, where a select would take a second one on the
// half-rate ALU pipe.  Exactly one of the adds runs, so the sum is the
// same IEEE float32 as the select's.
__device__ __forceinline__ void add_cell(float& acc, uint32_t w, uint32_t bit,
                                         float lk, float on) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\t"
      "setp.ne.u32 p, t, 0;\n\t"
      "@p add.rn.f32 %0, %0, %3;\n\t"
      "@!p add.rn.f32 %0, %0, %4;\n\t}"
      : "+f"(acc)
      : "r"(w), "r"(bit), "f"(lk), "f"(on));
}

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------- staging

// The calling warp stages column k of one [C, L] float plane: staged row
// cc holds the 32 cells of clause c0 + cc (cells past L, columns past the
// plane and clauses past C read 0).  VEC: L % 4 == 0 and the plane
// 16-byte aligned, so 16-byte chunks, eight lanes a clause row.
template <bool VEC>
__device__ __forceinline__ void stage_cells(float* dst, const float* plane,
                                            int L, int C, int c0, int k) {
  const int lane = threadIdx.x & (WORD - 1);
  if (VEC) {
    for (int i = lane; i < WORD * 8; i += WORD) {
      const int cc = i >> 3, j = (i & 7) * 4;
      const int c = c0 + cc, l = k * WORD + j;
      const bool ok = c < C && l < L;   // L % 4 == 0: all of a chunk or none
      cp_async16(dst + cc * ROW + j,
                 ok ? plane + static_cast<size_t>(c) * L + l : plane,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = lane; i < WORD * WORD; i += WORD) {
      const int cc = i >> 5, j = i & (WORD - 1);
      const int c = c0 + cc, l = k * WORD + j;
      const bool ok = c < C && l < L;
      cp_async4(dst + cc * ROW + j,
                ok ? plane + static_cast<size_t>(c) * L + l : plane,
                ok ? 4 : 0);
    }
  }
}

// The calling warp stages dst[i] = word (row0 + i, k) of a [rows, Lw]
// int32 word matrix for i < n, 0 past `rows` or Lw.
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const int32_t* words, int rows,
                                            int Lw, int row0, int n, int k) {
  for (int i = threadIdx.x & (WORD - 1); i < n; i += WORD) {
    const int row = row0 + i;
    const bool ok = row < rows && k < Lw;
    cp_async4(dst + i,
              ok ? words + static_cast<size_t>(row) * Lw + k : words,
              ok ? 4 : 0);
  }
}

// A staged row's 32 floats as registers.
__device__ __forceinline__ void read_row(const float* row, float (&v)[WORD]) {
#pragma unroll
  for (int i = 0; i < WORD / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(row)[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

// The cell half of the two dense-plane sources: column k of the [R, C, L]
// g and leak planes, as given (the caller builds them in the reference's
// op order), staged as two planes, the g plane's rows first; the pairs
// are on = v_read * g as __fmul_rn and leak as read.  VEC: L % 4 == 0
// and both planes 16-byte aligned (stage_cells' 16-byte copies).
template <bool VEC>
struct DenseCells {
  static constexpr int kPlanes = 2;

  const float* g;        // [R, C, L] on-path conductance (S)
  const float* leak;     // [R, C, L] leak current (A)
  float v_read;
  int C, L;

  __device__ void stage(float* cells, int r, int c0, int k) const {
    const size_t plane = static_cast<size_t>(r) * C * L;
    stage_cells<VEC>(cells, g + plane, L, C, c0, k);
    stage_cells<VEC>(cells + WORD * ROW, leak + plane, L, C, c0, k);
  }

  __device__ void column(const float* cells, float (&on)[WORD],
                         float (&lk)[WORD]) const {
    const int lane = threadIdx.x & (WORD - 1);
    float gv[WORD];
    read_row(cells + lane * ROW, gv);
    read_row(cells + (WORD + lane) * ROW, lk);
#pragma unroll
    for (int j = 0; j < WORD; ++j) on[j] = __fmul_rn(v_read, gv[j]);
  }
};

// ------------------------------------------------------------- kernel

// A warp's staged column, in 32-bit words: the source's cell planes
// [kPlanes][32][ROW], its clause words [32], and two buffers of literal
// words [rows].
template <class Src>
__host__ __device__ constexpr size_t tile_words(int rows) {
  return static_cast<size_t>(Src::kPlanes) * WORD * ROW +
         (Src::kClauseWords ? WORD : 0) + 2 * rows;
}

// Shared memory of one block, in 32-bit words: each warp's tile and the
// block's AND masks [NG][32].
template <class Src>
__host__ __device__ constexpr size_t smem_words(int ks, int ng) {
  return ks * tile_words<Src>(ng * WORD) + ng * WORD;
}

// The rows of group g in `live` (alive in some lane): sum the column for
// them and return the rows whose column current reaches i_ref.  lw[row]
// is the block row's literal word of the column.
__device__ __forceinline__ uint32_t sum_rows(uint32_t live,
                                             const uint32_t* lw, int g,
                                             const float (&on)[WORD],
                                             const float (&lk)[WORD],
                                             float i_ref) {
  uint32_t fail = 0u;
  while (live != 0u) {
    int row[ILP];
    uint32_t w[ILP];
    float acc[ILP];
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      row[q] = __ffs(live) - 1;   // -1 once the list is used up
      live &= live - 1u;
      w[q] = lw[g * WORD + max(row[q], 0)];
      acc[q] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < WORD; ++j) {
#pragma unroll
      for (int q = 0; q < ILP; ++q) {
        add_cell(acc[q], w[q], 1u << j, lk[j], on[j]);
      }
    }
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      if (row[q] >= 0 && !(acc[q] < i_ref)) fail |= 1u << row[q];
    }
  }
  return fail;
}

// Sum one column for every row group; alive[] and alive_s lose the rows
// it kills, `run` counts the (row, column) steps summed.
template <int NG>
__device__ __forceinline__ void sum_column(uint32_t (&alive)[NG],
                                           uint32_t* alive_s,
                                           const uint32_t* lw,
                                           const float (&on)[WORD],
                                           const float (&lk)[WORD],
                                           float i_ref,
                                           unsigned long long& run) {
  const int lane = threadIdx.x & (WORD - 1);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const uint32_t live = __reduce_or_sync(0xffffffffu, alive[g]);
    run += __popc(live);
    alive[g] &= ~sum_rows(live, lw, g, on, lk, i_ref);
    atomicAnd(&alive_s[g * WORD + lane], alive[g]);
  }
}

// The votes of a block whose AND masks are final in alive_s.
__device__ __forceinline__ void vote(const uint32_t* alive_s,
                                     const int32_t* __restrict__ pol,
                                     int32_t* __restrict__ out, int r,
                                     int B, int C, int M, int b0, int c,
                                     int rb, int ks) {
  const int lane = threadIdx.x & (WORD - 1);
  const int s = threadIdx.x / WORD;
  for (int m = 0; m < M; ++m) {
    const int p = c < C ? pol[static_cast<size_t>(c) * M + m] : 0;
    if (!__any_sync(0xffffffffu, p != 0)) continue;       // warp-uniform
    for (int i = s; i < rb && b0 + i < B; i += ks) {
      const uint32_t a = alive_s[(i / WORD) * WORD + lane];
      const int v = ((a >> (i & (WORD - 1))) & 1u) ? p : 0;
      const int sum = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && sum != 0) {
        atomicAdd(&out[(static_cast<size_t>(r) * B + b0 + i) * M + m], sum);
      }
    }
  }
}

// Clauses past C or with an all-zero polarity row (empty clauses) never
// vote, and rows past B do not exist: they start dead.
template <int NG>
__device__ __forceinline__ void init_alive(uint32_t (&alive)[NG],
                                           uint32_t* alive_s,
                                           const int32_t* __restrict__ pol,
                                           int B, int C, int M, int b0,
                                           int c) {
  bool votes = false;
  if (c < C) {
    for (int m = 0; m < M; ++m) {
      votes |= pol[static_cast<size_t>(c) * M + m] != 0;
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int n = B - b0 - g * WORD;
    alive[g] = !votes ? 0u : n >= WORD ? ~0u : n > 0 ? (1u << n) - 1u : 0u;
    if (threadIdx.x < WORD) alive_s[g * WORD + threadIdx.x] = alive[g];
  }
}

// `Src` provides:
//   kPlanes, kClauseWords      what it stages (see tile_words);
//   stage(cells, cwords, lits, r, c0, b0, rows, k)
//                              the calling warp issues the copies of
//                              column k of clauses c0.. and rows b0..;
//   column(cells, cwords, k, on, lk)
//                              the calling lane's 32 pairs of column k.
template <class Src, int NG>
__global__ void __launch_bounds__(KS_MAX * WORD, 2) core_kernel(
    Src src, const int32_t* __restrict__ pol,  // [C, M] signed one-hot
    int32_t* __restrict__ out,                 // [R, B, M], zeroed
    unsigned long long* __restrict__ rows_run, // or null: rows summed
    int B, int C, int M, int Lw, int ks, float i_ref) {
  extern __shared__ float4 smem4[];
  constexpr int RB = NG * WORD;
  const int lane = threadIdx.x & (WORD - 1);
  const int s = threadIdx.x / WORD;
  const int b0 = blockIdx.x * RB;
  const int c0 = blockIdx.y * CT;
  const int r = blockIdx.z;
  const int c = c0 + lane;
  uint32_t* base = reinterpret_cast<uint32_t*>(smem4);
  unsigned long long run = 0;
  uint32_t alive[NG];
  // Warp s stages and sums columns s, s + ks, ...; the warps share only
  // the AND masks, without barriers.
  const size_t tile = tile_words<Src>(RB);
  float* cells = reinterpret_cast<float*>(base + s * tile);
  uint32_t* cwords = reinterpret_cast<uint32_t*>(cells) +
                     static_cast<size_t>(Src::kPlanes) * WORD * ROW;
  uint32_t* lits = cwords + (Src::kClauseWords ? WORD : 0);
  uint32_t* alive_s = base + ks * tile;
  init_alive<NG>(alive, alive_s, pol, B, C, M, b0, c);
  __syncthreads();
  if (s < Lw) src.stage(cells, cwords, lits, r, c0, b0, RB, s);
  cp_async_commit();
  int i = 0;
  for (int k = s; k < Lw; k += ks, ++i) {
    cp_async_wait_all();
    __syncwarp();
    float on[WORD], lk[WORD];
    src.column(cells, cwords, k, on, lk);
    uint32_t any = 0;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      alive[g] &= *reinterpret_cast<volatile uint32_t*>(
          &alive_s[g * WORD + lane]);
      any |= alive[g];
    }
    __syncwarp();                     // cells consumed
    if (!__any_sync(0xffffffffu, any != 0)) break;   // the block is dead
    if (k + ks < Lw) {
      src.stage(cells, cwords, lits + ((i + 1) & 1) * RB, r, c0, b0, RB,
                k + ks);
    }
    cp_async_commit();
    sum_column<NG>(alive, alive_s, lits + (i & 1) * RB, on, lk, i_ref, run);
  }
  cp_async_wait_all();
  __syncthreads();                    // every warp's AND is in alive_s
  if (rows_run != nullptr && lane == 0 && run != 0) atomicAdd(rows_run, run);
  vote(alive_s, pol, out, r, B, C, M, b0, c, RB, ks);
}

// ------------------------------------------------------------- host side

struct Geometry {
  int ks;        // column splits (warps) a block
  int ng;        // 32-row groups a block
  int cols;      // ceil(Lw / ks): the most columns a warp sums
  dim3 grid;     // (batch tiles, clause tiles, R)
};

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

inline Geometry choose(int R, int B, int C, int Lw) {
  const int ks = Lw < KS_MAX ? Lw : KS_MAX;
  const int groups = (B + WORD - 1) / WORD;
  const long ctiles = (C + CT - 1) / CT;
  const long want = static_cast<long>(WARPS_PER_SM) * sm_count();
  int ng = groups >= 3 ? 4 : groups;
  auto tiles = [&](int n) { return (B + n * WORD - 1) / (n * WORD); };
  while (ng > 1 && tiles(ng) * ctiles * R * ks < want) ng /= 2;
  return Geometry{ks, ng, (Lw + ks - 1) / ks,
                  dim3(tiles(ng), static_cast<unsigned>(ctiles), R)};
}

// The kernel instance for `ng` row groups (1, 2 or 4), with its dynamic
// shared memory for a launch at `geo` allowed; `err` is the CUDA error.
template <class Src>
auto* kernel_for(const Geometry& geo, size_t smem, cudaError_t& err) {
  auto* kern = geo.ng == 1   ? core_kernel<Src, 1>
               : geo.ng == 2 ? core_kernel<Src, 2>
                             : core_kernel<Src, 4>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return kern;
}

// Launch on `st` with geometry `geo`; returns cudaGetLastError() after the
// launch (0 on success).
template <class Src>
int launch(const Src& src, const int32_t* pol, int32_t* out,
           unsigned long long* rows_run, int B, int C, int M, int Lw,
           float i_ref, const Geometry& geo, cudaStream_t st) {
  const size_t smem = smem_words<Src>(geo.ks, geo.ng) * 4;
  cudaError_t err;
  auto* kern = kernel_for<Src>(geo, smem, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<geo.grid, geo.ks * WORD, smem, st>>>(src, pol, out, rows_run, B, C,
                                              M, Lw, geo.ks, i_ref);
  return static_cast<int>(cudaGetLastError());
}

// `info` = {grid.x, grid.y, grid.z, threads, shared bytes, resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), ks, ng, cols}
// of a launch at `geo`.  Returns the CUDA error (0 on success).
template <class Src>
int describe(const Geometry& geo, int* info) {
  const size_t smem = smem_words<Src>(geo.ks, geo.ng) * 4;
  cudaError_t err;
  auto* kern = kernel_for<Src>(geo, smem, err);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, geo.ks * WORD, smem);
  }
  const int v[9] = {static_cast<int>(geo.grid.x),
                    static_cast<int>(geo.grid.y),
                    static_cast<int>(geo.grid.z), geo.ks * WORD,
                    static_cast<int>(smem), blocks, geo.ks, geo.ng,
                    geo.cols};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return static_cast<int>(err);
}

// ------------------------------------------------- literal bytes -> words

// Four 0/1 bytes (bit 0 of each) -> four bits, byte q to bit q.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  v &= 0x01010101u;
  v |= v >> 7;
  v |= v >> 14;
  return v & 0xfu;
}

// The literal word of row `row`, column `col` of a [rows, L] byte matrix:
// bit j = bit 0 of byte 32 * col + j, bytes past L read as 0.  VEC: L is
// a multiple of 16 and the matrix 16-byte aligned, so two 16-byte loads.
template <bool VEC>
__device__ __forceinline__ uint32_t byte_word(const uint8_t* __restrict__ m,
                                              int row, int col, int L) {
  const uint8_t* p = m + static_cast<size_t>(row) * L + col * WORD;
  const int n = min(WORD, L - col * WORD);
  uint32_t w = 0u;
  if (VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w = nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
        nibble(a.w) << 12;
    if (n > 16) {
      const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
      w |= (nibble(b.x) | nibble(b.y) << 4 | nibble(b.z) << 8 |
            nibble(b.w) << 12) << 16;
    }
  } else {
    for (int j = 0; j < n; ++j) w |= static_cast<uint32_t>(p[j] & 1u) << j;
  }
  return w;
}

}  // namespace imbue
