// flash_fwd: online-softmax attention forward, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py :: _flash_kernel
//   (launched by _flash_fwd_raw).
//
// What it computes, for each head (b, h) and query row q < S:
//   s[q, k] = capped(q . k * scale)     masked to -1e30 (flash_common.cuh)
//   o[q]    = sum_k softmax(s[q])[k] v[k]          in q's dtype
//   lse[q]  = m + log(max(l, 1e-30))               float32, [B * H, S]
// (the reference's lse is [B * H, Sp], S padded to max(bq, bk); its
// padded rows are never read, so the port keeps the valid rows only).
// by the reference's online softmax over key tiles: m the running max,
// l the running sum of exp(s - m), acc the running sum of P . V with both
// rescaled by exp(m_old - m_new) at each tile, o = acc / max(l, 1e-30).
// As in the reference, P is rounded to v's dtype before P . V while l
// sums the float32 P.
//
// Bound, at the main row (qwen2-0.5b, [4, 4096, 14, 64] bf16, causal):
// 4.70e8 visible pairs; 2 products of 2 * D FLOPs a pair = 1.2e11 FLOP,
// 0.12 ms at the dense bf16 tensor rate (989 TFLOP/s); one exp a pair,
// 0.11 ms at the SFU rate (16 per clock per SM); 118 MB of q, k, v, o and
// lse, 0.035 ms at 3.35 TB/s.  Bound by operations.
//
// Design, simple and right first (CUDA cores, no tensor cores):
// * One block of 256 threads per (query tile of BQ rows, head); the query
//   tile stays in shared memory as float32, each key / value tile of BK
//   rows is staged beside it, converted from bf16 on the way in.
// * Only key tiles inside the tile's causal / window range are visited
//   (k_begin .. k_end): at the main row 1.5 % of visited pairs are masked.
// * Each thread owns a TQ x TK patch of the score tile (4 x 4 at D <= 128)
//   and TQ rows x D / 16 columns of the output accumulator; row max and
//   row sum go through half-warp shuffles; P goes through shared memory
//   to the P . V product.
// * FP32 FFMA puts its floor at 1.8 ms on the main row (1.2e11 FLOP at
//   67 TFLOP/s), 15x the tensor-core bound: wgmma on bf16 tiles with a
//   TMA ring is the redesign's lever.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int H, int S, float scale, float cap, int causal, int window) {
  using TL = Tiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, DS = TL::DS, PS = TL::PS;
  constexpr int TQ = TL::TQ, TK = TL::TK, TD = TL::TD;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ, DS]
  float* ks = qs + BQ * DS;                       // [BK, DS]
  float* vs = ks + BK * DS;                       // [BK, DS]
  float* ps = vs + BK * DS;                       // [BQ, PS]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;

  load_tile<T, D, BQ>(qs, q + base, rs, q0, S);

  float m[TQ], l[TQ], acc[TQ][TD];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int kb = k_begin(q0, window) / BK * BK;
  const int ke = k_end(q0, BQ, S, causal);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();              // the last tile is consumed; qs is loaded
    load_tile<T, D, BK>(ks, k + base, rs, k0, S);
    load_tile<T, D, BK>(vs, v + base, rs, k0, S);
    __syncthreads();

    float sc[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TK; ++j) sc[i][j] = 0.f;
    }
    tile_dot<D, TQ, TK>(qs, ks, ty, tx, sc);

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float s = capped(sc[i][j] * scale, cap);
        sc[i][j] = visible(qi, k0 + tx + 16 * j, S, causal, window) ? s
                                                                    : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[TD];
      load_cols<D>(vs + kk * DS, tx, vv);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float p = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float lm = fmaxf(l[i], 1e-30f);
    if (qi < S) {
      T* row = o + base + static_cast<size_t>(qi) * rs;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        store1(row + dcol<D>(tx, j), acc[i][j] / lm);
      }
      if (tx == 0) lse[static_cast<size_t>(bh) * S + qi] = m[i] + logf(lm);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int S, float scale, float cap, int causal,
           int window, cudaStream_t st) {
  using TL = Tiles<D>;
  const int smem = ((TL::BQ + 2 * TL::BK) * TL::DS + TL::BQ * TL::PS) *
                   static_cast<int>(sizeof(float));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TL::BQ - 1) / TL::BQ, B * H);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), H, S, scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  q, k, v, o: [B, S, H, D] of float32 (bf16 == 0)
// or bfloat16 (bf16 == 1); lse: [B * H, S] float32.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim other than 32, 64, 128 or 256.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int S,
                                int D, int bf16, float scale,
                                float cap, int causal, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return flash::dispatch(D, bf16, [&](auto tag, auto dim) {
    using T = decltype(tag);
    return launch<T, decltype(dim)::value>(q, k, v, o, lse, B, H, S, scale,
                                           cap, causal, window, st);
  });
}
