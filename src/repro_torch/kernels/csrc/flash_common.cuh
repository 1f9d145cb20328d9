// flash_common.cuh: the tiling and the device functions shared by the
// flash-attention kernels (flash_fwd.cu, flash_bwd_dkv.cu,
// flash_bwd_dq.cu), ports of src/repro/kernels/flash_attention.py.
//
// Layout: q, k, v, dO, o, dq, dk, dv are [B, S, H, D] (heads already
// expanded), read and written in place: row s of head (b, h) starts at
// ((b * S + s) * H + h) * D.  lse and D = rowsum(dO * o) are float32.
// Inputs are float32 or bfloat16; every product and sum runs in float32
// (bf16 x bf16 products are exact in float32, as the TPU kernel's
// preferred_element_type=float32 keeps them): FFMA on CUDA cores in the
// float32 instances, wgmma on the tensor cores in the bf16 ones (TcTiles
// below, hopper.cuh).
//
// The mask of one (query q, key k) pair is the reference's _block_mask
// (flash_attention.py:47-60): k < S, and q >= k if causal (top-left
// aligned, equal lengths), and q - k < window if window > 0.  A tile of
// keys (or queries) that holds no visible pair for the block's tile is
// never visited: the key range of a query tile is k_begin..k_end, the
// query range of a key tile q_begin..q_end (the reference's `run` test).
//
// Scores: x = (q . k) * scale, s = cap * tanh(x / cap) if cap > 0 else x
// (_scores, :63-70), with IEEE tanhf / logf (no fast math: the
// approximate tanh's ~2^-11 error is past the float32 tolerance).  exp is
// IEEE expf in the float32 kernels and exp2f of a base-2 exponent in the
// bf16 backward (p_ds, whose masked exponent is -inf against a finite
// lse).  In the float32 forward a masked score is the finite NEG_INF =
// -1e30 of the reference (:44): its online softmax relies on
// exp(-1e30 - m) == 0 and exp(0) == 1 where an infinite one would give
// exp(-inf + inf) = NaN.
//
// The bf16 forward (flash_fwd_tc) differs on both counts.  It takes exp
// as one ex2.approx.ftz (relative error ~2^-22, and results below 2^-126
// flushed to 0: both far under its tolerances, since p is rounded to
// bf16 for P . V and lse is held to 2e-5 relative).  It masks with -inf:
// while a row has seen no visible key its max m is -inf, and it then
// subtracts a base of 0 instead of m, so exp2(-inf) = 0 gives p = 0 and
// the rescale factor 0, never -inf + inf.  Every valid row sees its own
// key, so its final m is finite and its lse is exact.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int THREADS = 256;       // a 16 x 16 grid of threads
constexpr float NEG_INF = -1e30f;

// Query rows (BQ) and key rows (BK) of a tile.  Every tile is staged in
// shared memory as float32 rows padded to D + 4 floats; at D = 256 the
// tiles are 32 rows so that four 32 x 256 tiles (133 KB) fit.
template <int D>
struct Tiles {
  static constexpr int BQ = D >= 256 ? 32 : 64;
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int DS = D + 4;        // row stride of a [rows, D] tile
  static constexpr int PS = BK + 16;      // row stride of a [BQ, BK] tile
  static constexpr int TQ = BQ / 16;      // query rows a thread owns
  static constexpr int TK = BK / 16;      // key rows (columns) a thread owns
  static constexpr int TD = D / 16;       // head-dim columns a thread owns
};

// The tiles of the bf16 backward kernels on the tensor cores (the forward
// takes its swizzle from here too): a block is
// two consumer warpgroups and one producer warpgroup, whose first warp
// works and which hands most of its registers to the consumers
// (PRODUCER_REGS, CONSUMER_REGS: 2 x 128 x 232 + 128 x 40 <= 65536).  The
// producer keeps the block's resident rows (k and v for dK / dV, q and
// dO for dQ; ROWS of them) and streams the other side's tiles (STREAM
// rows) through a ring of STAGES by TMA, as deep as shared memory
// allows.  Each consumer warpgroup owns 64 resident rows and
// all D columns of their output; at D = 256, where one warpgroup cannot
// hold a 64 x 256 float32 output twice over, both own the same 64 rows
// and split the columns (DN each): each computes the scores of half the
// streamed rows and the two trade their A fragments.
template <int D>
struct TcTiles {
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle = chunk row bytes
  static constexpr int CW = SW / 2;               // columns of a chunk
  static constexpr int NCH = D / CW;              // chunks of a row
  static constexpr bool SPLIT = D >= 256;
  static constexpr int DN = SPLIT ? D / 2 : D;    // output columns a WG owns
  static constexpr int ROWS = SPLIT ? 64 : 128;
  static constexpr int STREAM = 64;
  static constexpr int STAGES = D <= 64 ? 4 : D <= 128 ? 3 : 2;
  // Whether the dK / dV kernel can hold one tile's fragments while the
  // next tile's scores arrive (registers: D <= 64).
  static constexpr bool PINGPONG = DN <= 64;
};

// Thread (ty, tx) of a [rows, cols] score tile owns rows ty + 16 i and
// columns tx + 16 j.  A warp is two values of ty by sixteen of tx: its
// float4 reads of sixteen neighbouring key rows (stride D + 4 floats,
// D / 4 a multiple of 8) fall in distinct banks, its reads of two query
// rows are broadcasts.  Of a [rows, D] accumulator, thread (ty, tx) owns
// rows ty + 16 i and the head-dim columns dcol(tx, j): four neighbouring
// columns in each 64-wide group (two at D = 32).
template <int D>
__device__ __forceinline__ int dcol(int tx, int j) {
  if constexpr (D / 16 >= 4) {
    return tx * 4 + 64 * (j / 4) + j % 4;
  } else {
    return tx * (D / 16) + j;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and back: the forward casts P to v's dtype before P . V
// (flash_attention.py:97-99).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Rows r0 .. r0 + ROWS - 1 of one head of a [B, S, H, D] tensor (`src`
// points at row 0 of the head, rows `row_stride` elements apart) into a
// [ROWS, D + 4] float32 tile; rows >= limit read as 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          size_t row_stride, int r0,
                                          int limit) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += THREADS) {
    const int r = e / C4;
    const int c = (e % C4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < limit) load4(src + static_cast<size_t>(r0 + r) * row_stride
                                  + c, v);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The head-dim columns dcol(tx, j) of one tile row.
template <int D>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int tx, float (&out)[D / 16]) {
  if constexpr (D / 16 >= 4) {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(row + tx * 4 + 64 * g);
      out[4 * g] = x.x;
      out[4 * g + 1] = x.y;
      out[4 * g + 2] = x.z;
      out[4 * g + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[j] = row[tx * (D / 16) + j];
  }
}

// acc[i][j] += a[ty + 16 i] . b[tx + 16 j] over the D columns of two
// [rows, D + 4] tiles.
template <int D, int TR, int TC>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         int ty, int tx,
                                         float (&acc)[TR][TC]) {
  constexpr int DS = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[TR], bv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * DS + d);
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * DS + d);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Max and sum over the sixteen threads of one tile row (one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The key-side mask of _block_mask; the backward kernels add q < S.
__device__ __forceinline__ bool visible(int q, int k, int S, int causal,
                                        int window) {
  return k < S && (!causal || q >= k) && (window == 0 || q - k < window);
}

// Whether every pair of queries q_lo .. q_hi and keys k_lo .. k_hi is
// visible (then a tile needs no mask).
__device__ __forceinline__ bool all_visible(int q_lo, int q_hi, int k_lo,
                                            int k_hi, int S, int causal,
                                            int window) {
  return q_hi < S && k_hi < S && (!causal || q_lo >= k_hi) &&
         (window == 0 || q_hi - k_lo < window);
}

// The first key a query tile starting at q0 can see, and one past the
// last (before rounding down to a tile boundary).
__device__ __forceinline__ int k_begin(int q0, int window) {
  return window ? max(0, q0 - window + 1) : 0;
}
__device__ __forceinline__ int k_end(int q0, int bq, int S, int causal) {
  return causal ? min(S, q0 + bq) : S;
}

// The first query that can see a key tile starting at k0, and one past
// the last.
__device__ __forceinline__ int q_begin(int k0, int causal) {
  return causal ? k0 : 0;
}
__device__ __forceinline__ int q_end(int k0, int bk, int S, int window) {
  return window ? min(S, k0 + bk - 1 + window) : S;
}

// s from the pre-cap scaled score x.
__device__ __forceinline__ float capped(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// ds of one pair (flash_attention.py:205-208): p (dp - D), times the
// softcap's derivative 1 - tanh(x / cap)^2 at the pre-cap x, times scale.
__device__ __forceinline__ float dscore(float p, float dp, float dd, float x,
                                        float cap, float scale) {
  float ds = p * (dp - dd);
  if (cap > 0.f) {
    const float t = tanhf(x / cap);
    ds = ds * (1.f - t * t);
  }
  return ds * scale;
}

constexpr float LOG2E = 1.4426950408889634f;

// p and ds / scale of one pair from its raw score s = q . k, branch-free
// (the tensor-core kernels keep a tile in registers, where a branch per
// element would serialise the exp chains), with the exponent in base 2:
// p = 2^(x log2e - lse2), lse2 = lse log2e, x = s scale (one FFMA without
// a softcap; with one, the cap's tanh once).  A masked pair's exponent is
// -inf, so p = +0 as exp(-1e30 - lse) gives.  The kernel multiplies the
// summed dK or dQ by scale once, at the end.  Against capped / dscore:
// float32 rounding differences of a few ulp, far below bf16's.
__device__ __forceinline__ void p_ds(float s, bool on, float lse2, float dp,
                                     float dd, float cap, float scale,
                                     float& p, float& ds) {
  float arg, dcap = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(s * scale / cap);
    arg = cap * t * LOG2E - lse2;
    dcap = 1.f - t * t;
  } else {
    arg = fmaf(s, scale * LOG2E, -lse2);
  }
  p = exp2f(on ? arg : -INFINITY);
  ds = p * (dp - dd) * dcap;
}

// f(T{}, std::integral_constant<int, D>{}) for the runtime dtype flag
// (0 float32, 1 bfloat16) and head dim; cudaErrorInvalidValue for any
// other head dim.
template <typename F>
int dispatch(int d, int bf16, F&& f) {
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  if (bf16) {
    switch (d) {
      case 32: return f(__nv_bfloat16{}, I32{});
      case 64: return f(__nv_bfloat16{}, I64{});
      case 128: return f(__nv_bfloat16{}, I128{});
      case 256: return f(__nv_bfloat16{}, I256{});
    }
  } else {
    switch (d) {
      case 32: return f(float{}, I32{});
      case 64: return f(float{}, I64{});
      case 128: return f(float{}, I128{});
      case 256: return f(float{}, I256{});
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
