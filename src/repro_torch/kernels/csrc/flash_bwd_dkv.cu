// flash_bwd_dkv: the flash backward's dK and dV, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention.py :: _flash_dkv_kernel
//   (launched by _flash_bwd_raw).
//
// What it computes, for each head (b, h) and key row k < S, from q, k, v,
// dO ([B, S, H, D]), lse and D = rowsum(dO * o) ([B * H, S] float32):
//   p[q, k]  = exp(capped(x) - lse[q])   x = q . k * scale; 0 if masked
//   dp[q, k] = dO[q] . v[k]
//   ds[q, k] = p (dp - D[q]) (1 - tanh(x / cap)^2 if cap) * scale
//   dV[k]    = sum_q p[q, k] dO[q]        dK[k] = sum_q ds[q, k] q[q]
// over the visible queries q < S, in float32 (P and dO stay float32, as
// in the reference, :197-211), written in k's and v's dtype.  Each block
// owns its key tile's rows of dK and dV: no block writes another's
// output, so there are no atomics and the result does not depend on the
// order in which blocks run.  dQ is the other kernel (flash_bwd_dq.cu).
//
// Bound, at the main row (qwen2-0.5b, [4, 4096, 14, 64] bf16, causal):
// 4 products of 2 * D FLOPs over 4.70e8 visible pairs = 2.4e11 FLOP,
// 0.24 ms at the dense bf16 tensor rate; one exp a pair at the SFU rate,
// 0.11 ms; q, k, v, dO, lse, D read once and dK, dV written once, 177 MB,
// 0.05 ms.  Bound by operations.
//
// Design, simple and right first (CUDA cores, no tensor cores):
// * One block of 256 threads per (key tile of BK rows, head): the key and
//   value tiles stay in shared memory, and the block walks the query tiles
//   that can see them (q_begin .. q_end), staging q and dO (float32), lse
//   and D.
// * Each thread computes a TQ x TK patch of the scores and of dP in one
//   pass over D, writes P and dS to shared memory, then accumulates
//   BK / 16 key rows x D / 16 columns of dK and of dV in registers.
// * Query rows >= S read as 0 and are masked, so padding adds nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dk, T* __restrict__ dv, int H, int S, float scale,
    float cap, int causal, int window) {
  using TL = Tiles<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, DS = TL::DS, PS = TL::PS;
  constexpr int TQ = TL::TQ, TK = TL::TK, TD = TL::TD;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK, DS]
  float* vs = ks + BK * DS;                       // [BK, DS]
  float* qs = vs + BK * DS;                       // [BQ, DS]
  float* dos = qs + BQ * DS;                      // [BQ, DS]
  float* ps = dos + BQ * DS;                      // [BQ, PS]
  float* dss = ps + BQ * PS;                      // [BQ, PS]
  float* lse_s = dss + BQ * PS;                   // [BQ]
  float* dd_s = lse_s + BQ;                       // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * S;
  const float* dd_h = dd + static_cast<size_t>(bh) * S;

  load_tile<T, D, BK>(ks, k + base, rs, k0, S);
  load_tile<T, D, BK>(vs, v + base, rs, k0, S);

  float adk[TK][TD], adv[TK][TD];
#pragma unroll
  for (int a = 0; a < TK; ++a) {
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      adk[a][j] = 0.f;
      adv[a][j] = 0.f;
    }
  }

  const int qb = q_begin(k0, causal) / BQ * BQ;
  const int qe = q_end(k0, BK, S, window);
  for (int q0 = qb; q0 < qe; q0 += BQ) {
    __syncthreads();              // the last tile is consumed; ks, vs loaded
    load_tile<T, D, BQ>(qs, q + base, rs, q0, S);
    load_tile<T, D, BQ>(dos, dout + base, rs, q0, S);
    for (int e = threadIdx.x; e < BQ; e += THREADS) {
      const bool in = q0 + e < S;
      lse_s[e] = in ? lse_h[q0 + e] : 0.f;
      dd_s[e] = in ? dd_h[q0 + e] : 0.f;
    }
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
        ps[r * PS + tx + 16 * j] = p;
        dss[r * PS + tx + 16 * j] = dscore(p, dp[i][j], dd_s[r], x, cap,
                                           scale);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float dov[TD], qv[TD];
      load_cols<D>(dos + qq * DS, tx, dov);
      load_cols<D>(qs + qq * DS, tx, qv);
#pragma unroll
      for (int a = 0; a < TK; ++a) {
        const float p = ps[qq * PS + ty + 16 * a];
        const float ds = dss[qq * PS + ty + 16 * a];
#pragma unroll
        for (int j = 0; j < TD; ++j) {
          adv[a][j] = fmaf(p, dov[j], adv[a][j]);
          adk[a][j] = fmaf(ds, qv[j], adk[a][j]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TK; ++a) {
    const int kr = k0 + ty + 16 * a;
    if (kr >= S) continue;
    const size_t off = base + static_cast<size_t>(kr) * rs;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      store1(dk + off + dcol<D>(tx, j), adk[a][j]);
      store1(dv + off + dcol<D>(tx, j), adv[a][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* dd, void* dk, void* dv, int B, int H,
           int S, float scale, float cap, int causal, int window,
           cudaStream_t st) {
  using TL = Tiles<D>;
  const int smem = ((2 * TL::BK + 2 * TL::BQ) * TL::DS +
                    2 * TL::BQ * TL::PS + 2 * TL::BQ) *
                   static_cast<int>(sizeof(float));
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TL::BK - 1) / TL::BK, B * H);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, scale, cap, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  q, k, v, dout, dk, dv: [B, S, H, D] of float32
// (bf16 == 0) or bfloat16 (bf16 == 1); lse, dd: [B * H, S] float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim other than 32, 64, 128 or 256.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dd,
                                    void* dk, void* dv, int B, int H, int S,
                                    int D, int bf16, float scale, float cap,
                                    int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return flash::dispatch(D, bf16, [&](auto tag, auto dim) {
    using T = decltype(tag);
    return launch<T, decltype(dim)::value>(q, k, v, dout, lse, dd, dk, dv, B,
                                           H, S, scale, cap, causal, window,
                                           st);
  });
}
