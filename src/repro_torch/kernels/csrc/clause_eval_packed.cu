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
// One block structure:
// * Staging: one load round trip.  A block copies all of its rows'
//   literal words and its clauses' include words (rows padded to a
//   stride whose lanes fall in distinct banks) with 4-byte cp.async (a
//   196-byte row is not 16-byte aligned), consecutive threads on
//   consecutive words (a tile's rows are contiguous in device memory),
//   and meets at one barrier.  No K-chunk loop at the repo's widths;
//   only rows too long for 48 KB of shared memory go in chunks.
// * The product: the single-bit tensor-core product, mma.sync m16n8k256
//   b1 with .and.popc (BMMA in the SASS), which counts popc(a & b) over
//   256-bit slices exactly, A = ~litw, B = incw (include words past Lw
//   are staged as 0, so the pad never counts).  A warp takes 16 rows x 32
//   clauses and every ks-th 8-word step; a block wm x wn such warp tiles
//   (up to 32 warps: 64 x 64 tiles stage a third fewer words than 64 x 32
//   ones).
// * The warps of a block split K; each warp's partial counts meet the
//   others' as flags: a lane with a non-zero count writes 1 into the
//   block's [BT, CT] byte tile in shared memory (zeroed before the
//   staging barrier; every writer writes the same value).
// * Coalesced stores: after a barrier a thread writes 4 neighbouring
//   clause bytes of one row (1 - flag), so a warp's stores cover whole
//   32-byte sectors of [B, C].
// * choose takes, of the (wm, wn, ks) whose grid holds 16 warps an SM,
//   the one that stages the fewest words (every block stages its rows and
//   clauses once), then the fewest warps; where none does (B <= 64 at
//   Lw = 49: 7 steps of 8 words, one 16-row tile at B < 16), the most
//   warps.

#include <algorithm>

#include "tm_common.cuh"

namespace {

using tmk::WORD;

constexpr int WARPS_MAX = 32;           // warps a block
constexpr int WARPS_PER_SM = 16;        // the grid's warps an SM choose keeps
constexpr int SMEM_MAX = 48 * 1024;     // staged bytes a block
constexpr int HIT_PAD = 4;              // flag row = CT + 4 bytes

// A warp's tile: 16 rows x MMA_NT * 8 clauses, 8-word K steps.
constexpr int MMA_NT = 4;
constexpr int MMA_K = 8;

// A launch's geometry.
struct Geo {
  int wm, wn;      // warp tiles a block along rows, clauses
  int ks;          // K-splits: warps a block = wm * wn * ks
  int bt, ct;      // block tile: wm * 16 x wn * 32
  int kc;          // words staged a chunk (Lw rounded up to 8, if it fits)
  int lwp;         // staged row stride, words: 4 * odd >= kc
  dim3 grid;       // (row tiles, clause tiles)
};

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
    tmk::cp_async4(dst + r * lwp + k,
                   ok ? src + static_cast<size_t>(row) * Lw + k0 + k : src,
                   ok);
    r += dr;
    k += dk;
    if (k >= kp) {
      k -= kp;
      ++r;
    }
  }
}

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
  MmaTile tile(geo);
  for (int k0 = 0; k0 < Lw; k0 += geo.kc) {
    const int kn = min(geo.kc, Lw - k0);
    const int kp = (kn + MMA_K - 1) / MMA_K * MMA_K;
    if (k0 > 0) __syncthreads();        // the last chunk has been read
    stage(lit_s, geo.lwp, litw, B, Lw, b0, geo.bt, k0, kn, kp);
    stage(inc_s, geo.lwp, incw, C, Lw, c0, geo.ct, k0, kn, kp);
    tmk::cp_async_commit();
    tmk::cp_async_wait_all();
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
         static_cast<size_t>(g.bt) * (g.ct + HIT_PAD);
}

// Fills the block tile, the staged chunk and the padded stride of `g`
// (warp tiles and ks already set) for rows of Lw words.
inline Geo finish(Geo g, int B, int C, int Lw) {
  g.bt = 16 * g.wm;
  g.ct = MMA_NT * 8 * g.wn;
  g.grid = dim3(cdiv(B, g.bt), cdiv(C, g.ct));
  g.kc = cdiv(Lw, MMA_K) * MMA_K;
  for (;;) {
    // Rows padded to 4 * odd words, so a fragment load's 8 rows x 4 words
    // fall in distinct banks.
    g.lwp = 4 * (cdiv(g.kc, 4) | 1);
    if (smem_bytes(g) <= SMEM_MAX || g.kc <= MMA_K) break;
    g.kc -= MMA_K;
  }
  return g;
}

// wm x wn warp tiles of 16 x 32 and ks K-splits (at most one 8-word step
// each).  Of the layouts whose grid holds 16 warps an SM, the one that
// stages the fewest words (each block stages its rows and clauses once),
// then the fewest warps; if none does, the most warps.
Geo choose(int B, int C, int Lw) {
  const long want = static_cast<long>(WARPS_PER_SM) * sm_count();
  const int steps = std::max(1, cdiv(Lw, MMA_K));
  Geo best{};
  long best_warps = -1, best_words = 0;
  // Warp tiles past B or C in every block would only add idle warps.
  for (int wm = 1; wm <= std::min(4, std::max(1, cdiv(B, 16))); wm *= 2) {
    for (int wn = 1; wn <= std::min(4, std::max(1, cdiv(C, 32))); wn *= 2) {
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
          best_warps = warps;
          best_words = words;
        }
      }
    }
  }
  return finish(best, B, C, Lw);
}

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int clause_eval_packed_launch(const void* litw, const void* incw,
                                         void* out, int B, int Lw, int C,
                                         void* stream) {
  const Geo g = choose(B, C, Lw);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  eval_kernel<<<g.grid, g.wm * g.wn * g.ks * WORD, smem_bytes(g),
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
  const Geo g = choose(B, C, Lw);
  int blocks = 0;
  const int threads = g.wm * g.wn * g.ks * WORD;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, eval_kernel, threads, smem_bytes(g));
  const int v[9] = {static_cast<int>(g.grid.x), static_cast<int>(g.grid.y),
                    threads, static_cast<int>(smem_bytes(g)), blocks,
                    g.ks, g.bt, g.ct, g.kc};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return static_cast<int>(err);
}
