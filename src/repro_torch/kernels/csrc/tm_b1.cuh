// tm_b1.cuh: the single-bit tensor-core core of the four word-counting
// TM kernels: clause_eval_packed.cu (clause bits, training semantics),
// tm_infer_planes.cu and tm_infer_packed.cu (class sums from packed
// words, both staged through WordSource) and tm_infer.cu (class sums from
// 0/1 bytes, folded into words while staged).
//
// Each counts, for a block tile of bt batch rows x ct clauses,
//   viol[b, c] = sum over words w of popc(~litw[b, w] & incw[c, w])
// and keeps only whether it is 0.  Here: the launch geometry (Geo,
// choose of clause_eval_packed, tm_infer_planes and tm_infer_packed,
// finish, smem_bytes; tm_infer, which stages bytes, chooses its own), the
// staging of word rows and of the combine slice with 4-byte cp.async
// (stage, WordSource, stage_comb), the product (mma_b1, MmaTile), and the
// inference kernels' block body (infer_block: staging from the kernel's
// source, product, flags, then the class sums of combine_rows);
// clause_eval_packed.cu keeps its own byte-store epilogue.
//
// * Staging: one load round trip.  A block copies all of its rows'
//   literal words and its clauses' include words into shared memory,
//   rows padded to a stride whose lanes fall in distinct banks
//   (lwp = 4 * odd words), and meets at one barrier.  Only rows too long
//   for 48 KB of shared memory go in K chunks (kc words a chunk).
// * The product: mma.sync m16n8k256 b1 with .and.popc (BMMA in the
//   SASS), which counts popc(a & b) over 256-bit slices exactly,
//   A = ~litw, B = incw.  Include words past Lw are staged as 0, so the
//   pad never counts.  A warp takes 16 rows x 32 clauses and every ks-th
//   8-word step; a block wm x wn such warp tiles and ks K-splits.
// * A caller may fix (wm, wn) (tile overrides, the tuning table's
//   measured tiles; choose's fix_wm / fix_wn): each in {1, 2, 4}, ks then
//   by choose's rule, so wm * wn * ks <= WARPS_MAX and ks <= ceil(Lw / 8)
//   hold; a tile outside the set is refused (TILE_INVALID), never clamped.
// * The warps of a block meet as flags: a lane with a non-zero count
//   writes 1 into the block's [bt, ct] byte tile in shared memory (zeroed
//   before the staging barrier; every writer writes the same value).
//   A clause fires for a row where its flag is still 0.
// * Class sums (combine_rows), after a barrier: warp w takes rows w,
//   w + warps, ... of the tile; a ballot over the row's flags gives the
//   fired mask of each 32 clauses (clauses >= C never fire, rows >= B are
//   skipped), then lane m walks the set bits (the same walk on every
//   lane), sums comb[c, m] from the block's [ct, M] slice of the combine
//   matrix (staged with the words where ct x M x 4 bytes fit COMB_MAX,
//   else read from device memory) and adds a non-zero sum to out[b, m]
//   with one int32
//   atomicAdd: exact in any order; the caller zeroes out and the rows of
//   empty clauses of comb (an empty clause has no violation, so it
//   fires).
//
// Integer arithmetic only: any split or order of the words gives the same
// bits and sums.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace tmb {

constexpr int WORD = 32;                // bits a word, lanes a warp
constexpr int WARPS_MAX = 32;           // warps a block
constexpr int WARPS_PER_SM = 16;        // the grid's warps an SM choose keeps
constexpr int SMEM_MAX = 48 * 1024;     // staged bytes a block
constexpr int HIT_PAD = 4;              // flag row = ct + 4 bytes
constexpr int COMB_MAX = 16 * 1024;     // staged combine bytes a block

// A warp's tile: 16 rows x MMA_NT * 8 clauses, 8-word K steps; a block
// at most WN_MAX warp tiles along the clauses.
constexpr int MMA_NT = 4;
constexpr int MMA_K = 8;
constexpr int WN_MAX = 4;

// A launch's geometry.
struct Geo {
  int wm, wn;      // warp tiles a block along rows, clauses
  int ks;          // K-splits: warps a block = wm * wn * ks
  int bt, ct;      // block tile: wm * 16 x wn * 32
  int kc;          // words staged a chunk (Lw rounded up to 8, if it fits)
  int lwp;         // staged row stride, words: 4 * odd >= kc
  int cm;          // combine words staged a clause: M, or 0 (read from
                   // device memory, or no combine)
  dim3 grid;       // (row tiles, clause tiles)
};

__device__ __forceinline__ int cdiv_d(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------- cp.async

// A 4-byte copy from device to shared memory; `valid` false zero-fills
// the word (a source size of 0; gmem must still be a device address).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------- staging

// Copies rows [row0, row0 + n) x words [k0, k0 + kn) of a [rows, Lw]
// word matrix to dst[r * lwp + k] for k < kp: zero past `rows`, past Lw
// and for k >= kn.  Consecutive threads copy consecutive words.
__device__ __forceinline__ void stage(uint32_t* dst, int lwp,
                                      const int32_t* __restrict__ src,
                                      int rows, int Lw, int row0, int n,
                                      int k0, int kn, int kp) {
  const int nt = blockDim.x;
  const int dr = nt / kp, dk = nt % kp;
  int r = threadIdx.x / kp, k = threadIdx.x % kp;
  while (r < n) {
    const int row = row0 + r;
    const bool ok = row < rows && k < kn;
    cp_async4(dst + r * lwp + k,
              ok ? src + static_cast<size_t>(row) * Lw + k0 + k : src, ok);
    r += dr;
    k += dk;
    if (k >= kp) {
      k -= kp;
      ++r;
    }
  }
}

// Packed words, staged with cp.async: the source of the two packed-word
// inference kernels (tm_infer_planes.cu, tm_infer_packed.cu).
struct WordSource {
  const int32_t* __restrict__ litw;     // [B, Lw] literal words
  const int32_t* __restrict__ incw;     // [C, Lw] include words
  int B, C, Lw;

  __device__ void stage(uint32_t* dst, int lwp, int b0, int c0, int bt,
                        int ct, int k0, int kn, int kp) const {
    tmb::stage(dst, lwp, litw, B, Lw, b0, bt, k0, kn, kp);
    tmb::stage(dst + bt * lwp, lwp, incw, C, Lw, c0, ct, k0, kn, kp);
  }
};

// Copies the combine rows [c0, c0 + ct) of the [C, M] int32 matrix (one
// contiguous run of ct * M words) to dst, zero past C.
__device__ __forceinline__ void stage_comb(int32_t* dst,
                                           const int32_t* __restrict__ comb,
                                           int C, int M, int c0, int ct) {
  const long base = static_cast<long>(c0) * M;
  const long end = static_cast<long>(C) * M;
  for (int i = threadIdx.x; i < ct * M; i += blockDim.x) {
    const bool ok = base + i < end;
    cp_async4(dst + i, ok ? comb + base + i : comb, ok);
  }
}

// ------------------------------------------------------------- product

// d += popc(a & b) over one 256-bit slice: a 16 x 256 row-major bit
// tile, b 256 x 8 column-major, d 16 x 8 int32.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's 16 x (MMA_NT * 8) counts over its 8-word steps: warp w takes
// the warp tile (w / wn % wm, w % wn) of the block and the K-split
// w / (wm * wn).  Fragments (lane = 4 * g + t): a0 / a2 row g, words t /
// 4 + t of the step; a1 / a3 row g + 8; b0 / b1 clause g, words t / 4 +
// t; d0, d1 row g, clauses 2t, 2t + 1; d2, d3 row g + 8.
struct MmaTile {
  int d[MMA_NT][4];
  int g, t, s, ks, r0, c0;

  __device__ explicit MmaTile(const Geo& geo) : ks(geo.ks) {
    const int lane = threadIdx.x & (WORD - 1);
    const int w = threadIdx.x / WORD;
    g = lane >> 2;
    t = lane & 3;
    s = w / (geo.wm * geo.wn);
    r0 = 16 * (w / geo.wn % geo.wm);
    c0 = MMA_NT * 8 * (w % geo.wn);
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0;
    }
  }

  __device__ void count(const uint32_t* lit, const uint32_t* inc, int lwp,
                        int kn) {
    lit += r0 * lwp;
    inc += c0 * lwp;
    for (int kb = s * MMA_K; kb < kn; kb += ks * MMA_K) {
      const int k = kb + t;
      const uint32_t a[4] = {~lit[g * lwp + k], ~lit[(g + 8) * lwp + k],
                             ~lit[g * lwp + k + 4],
                             ~lit[(g + 8) * lwp + k + 4]};
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n) {
        const uint32_t* row = inc + (n * 8 + g) * lwp + k;
        const uint32_t b[2] = {row[0], row[4]};
        mma_b1(d[n], a, b);
      }
    }
  }

  __device__ void mark(uint8_t* hit, int hs) const {
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d[n][e] != 0) {
          hit[(r0 + g + 8 * (e >> 1)) * hs + c0 + n * 8 + 2 * t + (e & 1)] =
              1;
        }
      }
    }
  }
};

// ------------------------------------------------------------- class sums

// out[b, m] += sum over the fired clauses c of the block's tile of
// cb[(c - c0) * M + m], for its rows b < B (after the barrier that
// follows MmaTile::mark).  cb is the block's combine slice, staged or in
// device memory.
__device__ __forceinline__ void combine_rows(const uint8_t* hit, int hs,
                                             const Geo& geo,
                                             const int32_t* cb,
                                             int32_t* __restrict__ out,
                                             int b0, int c0, int B, int C,
                                             int M) {
  const int lane = threadIdx.x & (WORD - 1);
  const int warps = blockDim.x / WORD;
  for (int r = threadIdx.x / WORD; r < geo.bt && b0 + r < B; r += warps) {
    uint32_t fired[WN_MAX];
#pragma unroll
    for (int w = 0; w < WN_MAX; ++w) {
      const int cl = w * WORD + lane;
      fired[w] = __ballot_sync(0xffffffffu, cl < geo.ct && c0 + cl < C &&
                                                hit[r * hs + cl] == 0);
    }
    for (int m = lane; m - lane < M; m += WORD) {
      int sum = 0;
      if (m < M) {
#pragma unroll
        for (int w = 0; w < WN_MAX; ++w) {
          for (uint32_t bits = fired[w]; bits != 0u; bits &= bits - 1u) {
            sum += cb[(w * WORD + __ffs(bits) - 1) * M + m];
          }
        }
      }
      if (sum != 0) atomicAdd(&out[static_cast<size_t>(b0 + r) * M + m], sum);
    }
  }
}

// The body of an inference kernel (tm_infer_planes.cu, tm_infer_packed.cu,
// tm_infer.cu).
// src.stage(dst, lwp, b0, c0, bt, ct, k0, kn, kp) stages words
// [k0, k0 + kn) of the block's literal rows at dst[r * lwp + k], r < bt,
// and of its include rows below them (r = bt + clause), 0 up to kp; its
// cp.async copies, if any, land with the combine slice's at the same
// barrier.
template <typename Source>
__device__ __forceinline__ void infer_block(const Source& src,
                                            const int32_t* __restrict__ comb,
                                            int32_t* __restrict__ out, int B,
                                            int Lw, int C, int M,
                                            const Geo& geo) {
  extern __shared__ uint32_t smem[];
  const int hs = geo.ct + HIT_PAD;
  uint32_t* lit_s = smem;                                // [bt, lwp]
  uint32_t* inc_s = lit_s + geo.bt * geo.lwp;            // [ct, lwp]
  int32_t* comb_s = reinterpret_cast<int32_t*>(inc_s + geo.ct * geo.lwp);
  uint32_t* hit_w = reinterpret_cast<uint32_t*>(comb_s + geo.ct * geo.cm);
  uint8_t* hit = reinterpret_cast<uint8_t*>(hit_w);      // [bt, hs]
  const int b0 = blockIdx.x * geo.bt;
  const int c0 = blockIdx.y * geo.ct;
  for (int i = threadIdx.x; i < geo.bt * hs / 4; i += blockDim.x) {
    hit_w[i] = 0u;
  }
  if (geo.cm) stage_comb(comb_s, comb, C, M, c0, geo.ct);
  MmaTile tile(geo);
  // At least one pass, so that the combine slice lands when Lw = 0.
  for (int k0 = 0; k0 < Lw || k0 == 0; k0 += geo.kc) {
    const int kn = max(0, min(geo.kc, Lw - k0));
    const int kp = max(1, cdiv_d(kn, MMA_K)) * MMA_K;
    if (k0 > 0) __syncthreads();        // the last chunk has been read
    src.stage(lit_s, geo.lwp, b0, c0, geo.bt, geo.ct, k0, kn, kp);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();                    // every thread's words have landed
    tile.count(lit_s, inc_s, geo.lwp, kp);
  }
  tile.mark(hit, hs);
  __syncthreads();
  combine_rows(hit, hs, geo,
               geo.cm ? comb_s : comb + static_cast<size_t>(c0) * M, out, b0,
               c0, B, C, M);
}

// ------------------------------------------------------------- host side

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

inline int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

inline size_t smem_bytes(const Geo& g) {
  return static_cast<size_t>(g.bt + g.ct) * g.lwp * 4 +
         static_cast<size_t>(g.ct) * g.cm * 4 +
         static_cast<size_t>(g.bt) * (g.ct + HIT_PAD);
}

// The combine words a clause that a block of wn warp tiles along the
// clauses stages: M where its ct x M slice fits COMB_MAX, else 0.
inline int comb_words(int wn, int M) {
  return static_cast<long>(MMA_NT) * 8 * wn * M * 4 <= COMB_MAX ? M : 0;
}

// Fills the block tile, the staged chunk and the padded stride of `g`
// (warp tiles, ks and cm already set) for rows of Lw words.
inline Geo finish(Geo g, int B, int C, int Lw) {
  g.bt = 16 * g.wm;
  g.ct = MMA_NT * 8 * g.wn;
  g.grid = dim3(cdiv(B, g.bt), cdiv(C, g.ct));
  g.kc = std::max(1, cdiv(Lw, MMA_K)) * MMA_K;
  for (;;) {
    // Rows padded to 4 * odd words, so a fragment load's 8 rows x 4 words
    // fall in distinct banks.
    g.lwp = 4 * (cdiv(g.kc, 4) | 1);
    if (smem_bytes(g) <= SMEM_MAX || g.kc <= MMA_K) break;
    g.kc -= MMA_K;
  }
  return g;
}

// What a launch or geometry export returns for a tile override outside
// its set: nothing is launched.  Not a CUDA error code.
constexpr int TILE_INVALID = -1;

// A tile override (wm, wn) is in its set: each 1, 2 or 4.
inline bool tile_ok(int wm, int wn) {
  return (wm == 1 || wm == 2 || wm == 4) && (wn == 1 || wn == 2 || wn == 4);
}

// wm x wn warp tiles of 16 x 32 and ks K-splits (at most one 8-word step
// each).  Of the layouts whose grid holds 16 warps an SM, the one that
// stages the fewest words (each block stages its rows and clauses once),
// then the fewest warps; if none does, the most warps.  M > 0: the blocks
// also stage their slices of an [C, M] combine matrix where they fit
// (comb_words).  A tile override (fix_wm, fix_wn, both non-zero and
// tile_ok) fixes the warp tiles, even past B or C, and takes ks by the
// same rule; 0, 0 searches them.
inline Geo choose(int B, int C, int Lw, int M = 0, int fix_wm = 0,
                  int fix_wn = 0) {
  const long want = static_cast<long>(WARPS_PER_SM) * sm_count();
  const int steps = std::max(1, cdiv(Lw, MMA_K));
  const bool fixed = fix_wm != 0;
  Geo best{};
  long best_warps = -1, best_words = 0;
  // Warp tiles past B or C in every block would only add idle warps.
  const int wm_hi = fixed ? fix_wm : std::min(4, std::max(1, cdiv(B, 16)));
  const int wn_hi =
      fixed ? fix_wn : std::min(WN_MAX, std::max(1, cdiv(C, 32)));
  for (int wm = fixed ? fix_wm : 1; wm <= wm_hi; wm *= 2) {
    for (int wn = fixed ? fix_wn : 1; wn <= wn_hi; wn *= 2) {
      const long tiles = std::max(
          1L, static_cast<long>(cdiv(B, 16 * wm)) * cdiv(C, 32 * wn));
      const long words = tiles * (16 * wm + 32 * wn);
      for (int ks = 1; ks <= std::min(steps, WARPS_MAX / (wm * wn)); ++ks) {
        const long warps = tiles * wm * wn * ks;
        const bool reach = warps >= want, best_reach = best_warps >= want;
        const bool better =
            best_warps < 0 ||
            (reach ? !best_reach || words < best_words ||
                         (words == best_words && warps < best_warps)
                   : !best_reach && warps > best_warps);
        if (better) {
          best = Geo{wm, wn, ks};
          best.cm = comb_words(wn, M);
          best_warps = warps;
          best_words = words;
        }
      }
    }
  }
  return finish(best, B, C, Lw);
}

// The geometry of a launch from a kernel's choose(fix_wm, fix_wn): its
// own search when wm == wn == 0, else the tile override's.  Returns false,
// choosing nothing, for an override outside its set.
template <typename Choose>
inline bool geometry_with(Choose choose_fixed, int wm, int wn, Geo& g) {
  if ((wm != 0 || wn != 0) && !tile_ok(wm, wn)) return false;
  g = choose_fixed(wm, wn);
  return true;
}

// geometry_with over this file's choose (tm_infer_planes, tm_infer_packed).
inline bool geometry(int B, int C, int Lw, int M, int wm, int wn, Geo& g) {
  return geometry_with(
      [&](int fix_wm, int fix_wn) {
        return choose(B, C, Lw, M, fix_wm, fix_wn);
      },
      wm, wn, g);
}

// The `info` fields of the <name>_geometry exports: {grid.x, grid.y,
// threads, shared bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), K-split, row tile,
// clause tile, words staged a chunk}.  Returns the CUDA error.
template <typename Kernel>
inline int geometry_info(const Geo& g, Kernel kernel, int* info) {
  int blocks = 0;
  const int threads = g.wm * g.wn * g.ks * WORD;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, threads, smem_bytes(g));
  const int v[9] = {static_cast<int>(g.grid.x), static_cast<int>(g.grid.y),
                    threads, static_cast<int>(smem_bytes(g)), blocks,
                    g.ks, g.bt, g.ct, g.kc};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return static_cast<int>(err);
}

}  // namespace tmb
