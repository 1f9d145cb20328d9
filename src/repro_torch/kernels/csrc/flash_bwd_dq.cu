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
// The bf16 instance's hi / lo split below does 4 products instead of
// 3: 0.243 ms of tensor work.
//
// Two instances by dtype, chosen by the C entry's bf16 flag:
//
// bfloat16, on the tensor cores (flash_bwd_dq_tc): one block of two
// consumer warpgroups and a producer warpgroup per (query tile, head)
// (TcTiles: 128 query rows, 64 at D = 256).  The producer loads the
// query and dO tiles once by TMA (128-byte swizzle, zero rows past S) and
// streams the key and value tiles of the tile's range (k_begin .. k_end,
// 64 rows) through a ring of 2-4 stages behind mbarriers.  Each warpgroup
// computes S = Q K^T and dP = dO V^T by wgmma from shared memory, then
// the mask (where needed), P and dS in float32 registers (lse and D of
// its two rows a thread read once), splits dS into bf16 hi + lo A
// fragments and accumulates dQ += dS_hi K + dS_lo K by wgmma with
// register A and K read MN-major.  dS is branch-free (p_ds).  At D = 256
// each warpgroup computes the scores of half the keys and the two trade
// their dS fragments through shared memory.  (Taking turns as dK / dV
// does measured slower here.)
//
// float32, on CUDA cores (flash_bwd_dq_kernel): one block of 256 threads
// per (query tile of BQ rows, head) keeps q, dO, lse and D in shared
// memory and walks the key tiles in the tile's causal / window range,
// staging k and v; each thread computes a TQ x TK patch of the scores and
// of dP in one pass over D, dS goes through shared memory, and the thread
// accumulates TQ rows x D / 16 columns of dQ in registers.

#include "flash_common.cuh"
#include "hopper.cuh"

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

template <int D>
__global__ void __launch_bounds__(TcTiles<D>::THREADS, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int H, int S,
                    float scale, float cap, int causal, int window) {
  using TL = TcTiles<D>;
  using namespace hopper;
  constexpr int BQ = TL::ROWS, BK = TL::STREAM, SW = TL::SW, CW = TL::CW;
  constexpr int DN = TL::DN, ST = TL::STAGES;
  constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);         // NCH chunks of [BQ, CW]
  uint8_t* dos = qs + Q_BYTES;
  uint8_t* ks = dos + Q_BYTES;               // [ST] x NCH chunks of [BK, CW]
  uint8_t* vs = ks + ST * KV_BYTES;
  // D = 256: the hi / lo fragments of dS, traded between the
  // warpgroups, [2 arrays][BK / 16 k-steps][128 threads].
  uint4* xbuf = reinterpret_cast<uint4*>(vs + ST * KV_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      xbuf + (TL::SPLIT ? 2 * (BK / 16) * 128 : 0));
  uint64_t* full = q_full + 1;               // [ST]
  uint64_t* empty = full + ST;               // [ST]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int kb = k_begin(q0, window) / BK * BK;
  const int n_tiles = (k_end(q0, BQ, S, causal) - kb + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);             // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup; one thread loads q and dO once, then k and v of
    // each key tile.
    regs_dec<TL::PRODUCER_REGS>();
    if (threadIdx.x != 256) return;
    mbar_arrive_tx(q_full, 2 * Q_BYTES);
    for (int c = 0; c < TL::NCH; ++c) {
      tma_load_4d(qs + c * BQ * SW, &tq, q_full, c * CW, h, q0, b);
      tma_load_4d(dos + c * BQ * SW, &tdo, q_full, c * CW, h, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST, k0 = kb + i * BK;
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
      mbar_arrive_tx(&full[s], 2 * KV_BYTES);
      for (int c = 0; c < TL::NCH; ++c) {
        tma_load_4d(ks + s * KV_BYTES + c * BK * SW, &tk, &full[s], c * CW,
                    h, k0, b);
        tma_load_4d(vs + s * KV_BYTES + c * BK * SW, &tv, &full[s], c * CW,
                    h, k0, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows qr0 .. qr0 + 63 and dQ
    // columns col_off .. col_off + DN - 1.
    regs_inc<TL::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int row_off = TL::SPLIT ? 0 : 64 * wg;
    const int col_off = TL::SPLIT ? DN * wg : 0;
    const int qr0 = q0 + row_off;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;   // accumulator row (+8)
    const int c0 = 2 * (t % 4);                    // accumulator column (+1)
    float lse_r[2], dd_r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qr0 + r0 + 8 * j;
      const size_t at = static_cast<size_t>(bh) * S + qi;
      lse_r[j] = qi < S ? lse[at] * LOG2E : 0.f;
      dd_r[j] = qi < S ? dd[at] : 0.f;
    }
    float adq[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) adq[i] = 0.f;
    // The score columns (keys) this warpgroup computes: all BK, or at
    // D = 256 its half, k_off .. k_off + SN - 1, whose fragments the two
    // warpgroups then trade through shared memory (xbuf).
    constexpr int SN = TL::SPLIT ? BK / 2 : BK;
    const int k_off = TL::SPLIT ? SN * wg : 0;
    float sc[SN / 2], dp[SN / 2];
    uint32_t dh[BK / 16][4], dl[BK / 16][4];

    // S = Q K^T and dP = dO V^T of the key tile in slot s (its SN columns
    // from k_off), over D, 16 columns a step.
    auto scores = [&](int s) {
      const uint8_t* kt = ks + s * KV_BYTES + k_off * SW;
      const uint8_t* vt = vs + s * KV_BYTES + k_off * SW;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ch = kk * 16 / CW, off = (kk * 16 % CW) * 2;
        const int a_off = ch * BQ * SW + row_off * SW + off;
        const int b_off = ch * BK * SW + off;
        Mma<SN>::ss(sc, desc(qs + a_off, 16, 8 * SW, SW),
                    desc(kt + b_off, 16, 8 * SW, SW), kk);
        Mma<SN>::ss(dp, desc(dos + a_off, 16, 8 * SW, SW),
                    desc(vt + b_off, 16, 8 * SW, SW), kk);
      }
    };
    // dS (rows: queries, columns: keys) of the tile at k0 as hi / lo A
    // fragments; the mask only where the tile has a pair that is not
    // visible.
    auto fragments = [&](int k0) {
      const int ks0 = k0 + k_off;
      auto pass = [&](auto masked) {
#pragma unroll
        for (int e = 0; e < SN / 2; ++e) {
          const int j = (e % 4) / 2;
          const int qi = qr0 + r0 + 8 * j;
          const int kc = ks0 + 8 * (e / 4) + c0 + e % 2;
          const bool on = !decltype(masked)::value ||
                          (qi < S && visible(qi, kc, S, causal, window));
          float p;
          p_ds(sc[e], on, lse_r[j], dp[e], dd_r[j], cap, scale, p, dp[e]);
        }
      };
      if (all_visible(qr0, qr0 + 63, ks0, ks0 + SN - 1, S, causal,
                      window)) {
        pass(std::false_type{});
      } else {
        pass(std::true_type{});
      }
      if constexpr (TL::SPLIT) {
        // Each warpgroup has the fragments of its k-steps (2 wg, 2 wg + 1);
        // thread t of the other holds the same rows and columns of the
        // others, so the halves go through xbuf[array][k-step][t].
        uint32_t h[2][SN / 16][4];
        split_frags(dp, h[0], h[1]);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int k = 0; k < SN / 16; ++k) {
            xbuf[(a * (BK / 16) + SN / 16 * wg + k) * 128 + t] =
                make_uint4(h[a][k][0], h[a][k][1], h[a][k][2], h[a][k][3]);
          }
        }
        bar_sync(3, 256);
        auto take = [&](uint32_t(&f)[BK / 16][4], int a) {
#pragma unroll
          for (int k = 0; k < BK / 16; ++k) {
            const uint4 x = xbuf[(a * (BK / 16) + k) * 128 + t];
            f[k][0] = x.x;
            f[k][1] = x.y;
            f[k][2] = x.z;
            f[k][3] = x.w;
          }
        };
        take(dh, 0);
        take(dl, 1);
        bar_sync(4, 256);                    // xbuf is free again
      } else {
        split_frags(dp, dh, dl);
      }
    };
    // dQ += dS K over the tile in slot s, 16 keys a step, K read MN-major
    // from column col_off.
    auto accumulate = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = desc(ks + s * KV_BYTES + col_off / CW * BK * SW +
                                     kk * 16 * SW,
                                 BK * SW, 8 * SW, SW);
        Mma<DN>::rs(adq, dh[kk], bk);
        Mma<DN>::rs(adq, dl[kk], bk);
      }
    };
    auto settle = [&] {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(adq);
    };

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      mbar_wait(&full[s], (i / ST) & 1);
      wgmma_fence();
      scores(s);
      settle();
      fragments(kb + i * BK);
      wgmma_fence();
      accumulate(s);
      settle();
      mbar_arrive(&empty[s]);
    }

    const size_t rs = static_cast<size_t>(H) * D;
    const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
#pragma unroll
    for (int e = 0; e < DN / 2; e += 2) {
      const int qi = qr0 + r0 + 8 * ((e % 4) / 2);
      if (qi >= S) continue;
      const size_t off = base + static_cast<size_t>(qi) * rs + col_off +
                         8 * (e / 4) + c0;
      *reinterpret_cast<__nv_bfloat162*>(dq + off) =
          __floats2bfloat162_rn(adq[e] * scale, adq[e + 1] * scale);
    }
  }
}

// Dynamic shared memory of the tensor-core instance: the 1024-byte
// alignment slack, the tiles, the ring, the traded fragments at D = 256
// and the barriers.
template <int D>
constexpr int tc_smem() {
  using TL = TcTiles<D>;
  return 1024 + 2 * TL::ROWS * D * 2 + TL::STAGES * 2 * TL::STREAM * D * 2 +
         (TL::SPLIT ? 2 * (TL::STREAM / 16) * 128 * 16 : 0) +
         (1 + 2 * TL::STAGES) * 8;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, void* dq, int B, int H, int S,
              float scale, float cap, int causal, int window,
              cudaStream_t st) {
  using TL = TcTiles<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (hopper::bshd_map(&mq, q, B, S, H, D, TL::ROWS, TL::CW, TL::SW) ||
      hopper::bshd_map(&mk, k, B, S, H, D, TL::STREAM, TL::CW, TL::SW) ||
      hopper::bshd_map(&mv, v, B, S, H, D, TL::STREAM, TL::CW, TL::SW) ||
      hopper::bshd_map(&mdo, dout, B, S, H, D, TL::ROWS, TL::CW, TL::SW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = tc_smem<D>();
  auto kern = flash_bwd_dq_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TL::ROWS - 1) / TL::ROWS, B * H);
  kern<<<grid, TL::THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<__nv_bfloat16*>(dq), H, S,
      scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
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
    constexpr int kD = decltype(dim)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return launch_tc<kD>(q, k, v, dout, lse, dd, dq, B, H, S, scale, cap,
                           causal, window, st);
    } else {
      return launch<T, kD>(q, k, v, dout, lse, dd, dq, B, H, S, scale, cap,
                           causal, window, st);
    }
  });
}

// The dynamic shared memory, in bytes, of the bfloat16 instance at head
// dim d (0 for a head dim it does not take).
extern "C" int flash_bwd_dq_tc_smem(int d) {
  switch (d) {
    case 32: return tc_smem<32>();
    case 64: return tc_smem<64>();
    case 128: return tc_smem<128>();
    case 256: return tc_smem<256>();
  }
  return 0;
}
