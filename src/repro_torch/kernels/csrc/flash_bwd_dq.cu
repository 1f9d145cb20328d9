// flash_bwd_dq: the flash backward's dQ, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py :: _flash_dq_kernel
//   (launched by _flash_bwd_raw).
//
// What it computes, for each head (b, h) and query row q < S, with p, dp
// and ds as in flash_bwd_dkv.cu:
//   dQ[q] = sum_k ds[q, k] k[k]
// over the visible keys, in float32, written in q's dtype.  Each block
// owns its query tile's rows of dQ (no atomics, the same result in any
// block order).
//
// Bound, at the main row (qwen2-0.5b, [4, 4096, 14, 64] bf16, causal):
// 3 products of 2 * D FLOPs over 4.70e8 visible pairs = 1.8e11 FLOP,
// 0.18 ms at the dense bf16 tensor rate; one exp a pair at the SFU rate,
// 0.11 ms; q, k, v, dO, lse, D read once and dQ written once, 148 MB,
// 0.04 ms.  Bound by operations.
//
// Design, simple and right first (CUDA cores, no tensor cores): one block
// of 256 threads per (query tile of BQ rows, head) keeps q, dO, lse and D
// in shared memory and walks the key tiles in the tile's causal / window
// range, staging k and v; each thread computes a TQ x TK patch of the
// scores and of dP in one pass over D, dS goes through shared memory, and
// the thread accumulates TQ rows x D / 16 columns of dQ in registers.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq, int H, int S, float scale, float cap, int causal,
    int window) {
  using TL = Tiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, DS = TL::DS, PS = TL::PS;
  constexpr int TQ = TL::TQ, TK = TL::TK, TD = TL::TD;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ, DS]
  float* dos = qs + BQ * DS;                      // [BQ, DS]
  float* ks = dos + BQ * DS;                      // [BK, DS]
  float* vs = ks + BK * DS;                       // [BK, DS]
  float* dss = vs + BK * DS;                      // [BQ, PS]
  float* lse_s = dss + BQ * PS;                   // [BQ]
  float* dd_s = lse_s + BQ;                       // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;

  load_tile<T, D, BQ>(qs, q + base, rs, q0, S);
  load_tile<T, D, BQ>(dos, dout + base, rs, q0, S);
  for (int e = threadIdx.x; e < BQ; e += THREADS) {
    const bool in = q0 + e < S;
    lse_s[e] = in ? lse[static_cast<size_t>(bh) * S + q0 + e] : 0.f;
    dd_s[e] = in ? dd[static_cast<size_t>(bh) * S + q0 + e] : 0.f;
  }

  float adq[TQ][TD];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int j = 0; j < TD; ++j) adq[i][j] = 0.f;
  }

  const int kb = k_begin(q0, window) / BK * BK;
  const int ke = k_end(q0, BQ, S, causal);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();              // the last tile is consumed; qs, dos loaded
    load_tile<T, D, BK>(ks, k + base, rs, k0, S);
    load_tile<T, D, BK>(vs, v + base, rs, k0, S);
    __syncthreads();

    float sc[TQ][TK], dp[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        sc[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    tile_dot<D, TQ, TK>(qs, ks, ty, tx, sc);
    tile_dot<D, TQ, TK>(dos, vs, ty, tx, dp);

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float x = sc[i][j] * scale;
        const bool on = qi < S && visible(qi, k0 + tx + 16 * j, S, causal,
                                          window);
        const float p = on ? expf(capped(x, cap) - lse_s[r]) : 0.f;
        dss[r * PS + tx + 16 * j] = dscore(p, dp[i][j], dd_s[r], x, cap,
                                           scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[TD];
      load_cols<D>(ks + kk * DS, tx, kv);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float ds = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < TD; ++j) adq[i][j] = fmaf(ds, kv[j], adq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* row = dq + base + static_cast<size_t>(qi) * rs;
#pragma unroll
    for (int j = 0; j < TD; ++j) store1(row + dcol<D>(tx, j), adq[i][j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dd, void* dq, int B, int H, int S,
           float scale, float cap, int causal, int window, cudaStream_t st) {
  using TL = Tiles<D>;
  const int smem = ((2 * TL::BQ + 2 * TL::BK) * TL::DS + TL::BQ * TL::PS +
                    2 * TL::BQ) * static_cast<int>(sizeof(float));
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TL::BQ - 1) / TL::BQ, B * H);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dq), H, S, scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  q, k, v, dout, dq: [B, S, H, D] of float32
// (bf16 == 0) or bfloat16 (bf16 == 1); lse, dd: [B * H, S] float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim other than 32, 64, 128 or 256.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dd, void* dq,
                                   int B, int H, int S, int D, int bf16,
                                   float scale, float cap, int causal,
                                   int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return flash::dispatch(D, bf16, [&](auto tag, auto dim) {
    using T = decltype(tag);
    return launch<T, decltype(dim)::value>(q, k, v, dout, lse, dd, dq, B, H,
                                           S, scale, cap, causal, window, st);
  });
}
