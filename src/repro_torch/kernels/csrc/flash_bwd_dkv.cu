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
// 0.05 ms.  Bound by operations.  The bf16 instance's hi / lo split
// below does 6 products instead of 4: 0.365 ms of tensor work.
//
// Two instances by dtype, chosen by the C entry's bf16 flag:
//
// bfloat16, on the tensor cores (flash_bwd_dkv_tc): one block of two
// consumer warpgroups and a producer warpgroup per (key tile, head)
// (TcTiles: 128 key rows, 64 at D = 256).  The producer loads the key
// and value tiles once by TMA (128-byte swizzle, zero rows past S) and
// streams the visible query tiles (q_begin .. q_end, 64 rows) with their
// dO, lse and D through a ring of 2-4 stages behind mbarriers.  Each
// warpgroup computes S^T = K Q^T and dP^T = V dO^T by wgmma from shared
// memory (key rows as M), then the mask (skipped where the whole tile is
// visible), P^T and dS^T in float32 registers in the accumulator layout,
// splits each into bf16 hi + lo A fragments and accumulates dV += P^T_hi
// dO + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q by wgmma with register A
// and dO / Q read MN-major.  The split keeps P and dS at float32 accuracy
// (one rounding to bf16 would miss the bf16 check's 1e-3 of max|plain|)
// for 1.5x the four products' tensor work.  P and dS are branch-free
// (p_ds); at D <= 64, where the registers hold one tile's fragments
// beside the next tile's scores, the two warpgroups take turns starting
// their products (named barriers), so that one's products run while the
// other computes P and dS.  At D = 256 each computes the scores of half
// the queries and the two trade their P and dS fragments through shared
// memory.
//
// float32, on CUDA cores (flash_bwd_dkv_kernel): one block of 256
// threads per (key tile of BK rows, head) keeps the key and value tiles
// in shared memory and walks the query tiles that can see them, staging q
// and dO (float32), lse and D; each thread computes a TQ x TK patch of
// the scores and of dP in one pass over D, writes P and dS to shared
// memory, then accumulates BK / 16 key rows x D / 16 columns of dK and of
// dV in registers.
//
// Query rows >= S read as 0 and are masked, so padding adds nothing.

#include "flash_common.cuh"
#include "hopper.cuh"

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

template <int D>
__global__ void __launch_bounds__(TcTiles<D>::THREADS, 1)
    flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int S,
                     float scale, float cap, int causal, int window) {
  using TL = TcTiles<D>;
  using namespace hopper;
  constexpr int BK = TL::ROWS, BQ = TL::STREAM, SW = TL::SW, CW = TL::CW;
  constexpr int DN = TL::DN, ST = TL::STAGES;
  constexpr int KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);         // NCH chunks of [BK, CW]
  uint8_t* vs = ks + KV_BYTES;
  uint8_t* qs = vs + KV_BYTES;               // [ST] x NCH chunks of [BQ, CW]
  uint8_t* dos = qs + ST * Q_BYTES;
  // [ST, BQ] each: lse log2e and D of the slot's query rows.
  float* lse_s = reinterpret_cast<float*>(dos + ST * Q_BYTES);
  float* dd_s = lse_s + ST * BQ;
  // D = 256: the hi / lo fragments of P^T and dS^T, traded between the
  // warpgroups, [4 arrays][BQ / 16 k-steps][128 threads].
  uint4* xbuf = reinterpret_cast<uint4*>(dd_s + ST * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      xbuf + (TL::SPLIT ? 4 * (BQ / 16) * 128 : 0));
  uint64_t* full = kv_full + 1;              // [ST]
  uint64_t* empty = full + ST;               // [ST]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int qb = q_begin(k0, causal) / BQ * BQ;
  const int n_tiles = (q_end(k0, BK, S, window) - qb + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);               // the producer warp's lanes
      mbar_init(&empty[s], 256);             // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup; its first warp loads k and v once, then q, dO,
    // lse and D of each query tile.
    regs_dec<TL::PRODUCER_REGS>();
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * KV_BYTES);
      for (int c = 0; c < TL::NCH; ++c) {
        tma_load_4d(ks + c * BK * SW, &tk, kv_full, c * CW, h, k0, b);
        tma_load_4d(vs + c * BK * SW, &tv, kv_full, c * CW, h, k0, b);
      }
    }
    const float* lse_h = lse + static_cast<size_t>(bh) * S;
    const float* dd_h = dd + static_cast<size_t>(bh) * S;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST, q0 = qb + i * BQ;
      float l[BQ / 32], g[BQ / 32];        // read before the slot is free
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int qi = q0 + lane + 32 * j;
        l[j] = qi < S ? lse_h[qi] * LOG2E : 0.f;
        g[j] = qi < S ? dd_h[qi] : 0.f;
      }
      if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        lse_s[s * BQ + lane + 32 * j] = l[j];
        dd_s[s * BQ + lane + 32 * j] = g[j];
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * Q_BYTES);
        for (int c = 0; c < TL::NCH; ++c) {
          tma_load_4d(qs + s * Q_BYTES + c * BQ * SW, &tq, &full[s], c * CW,
                      h, q0, b);
          tma_load_4d(dos + s * Q_BYTES + c * BQ * SW, &tdo, &full[s],
                      c * CW, h, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumers: warpgroup wg owns key rows kr0 .. kr0 + 63 and output
    // columns col_off .. col_off + DN - 1.
    regs_inc<TL::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int row_off = TL::SPLIT ? 0 : 64 * wg;
    const int col_off = TL::SPLIT ? DN * wg : 0;
    const int kr0 = k0 + row_off;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;   // accumulator row (+8)
    const int c0 = 2 * (t % 4);                    // accumulator column (+1)
    float adk[DN / 2], adv[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      adk[i] = 0.f;
      adv[i] = 0.f;
    }
    // The score columns (queries) this warpgroup computes: all BQ, or at
    // D = 256 its half, q_off .. q_off + SN - 1, whose fragments the two
    // warpgroups then trade through shared memory (xbuf).
    constexpr int SN = TL::SPLIT ? BQ / 2 : BQ;
    const int q_off = TL::SPLIT ? SN * wg : 0;
    float sc[SN / 2], dp[SN / 2];
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];

    // S^T = K Q^T and dP^T = V dO^T of the query tile in slot s (its SN
    // columns from q_off), over D, 16 columns a step.
    auto scores = [&](int s) {
      const uint8_t* qt = qs + s * Q_BYTES + q_off * SW;
      const uint8_t* dot = dos + s * Q_BYTES + q_off * SW;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ch = kk * 16 / CW, off = (kk * 16 % CW) * 2;
        const int a_off = ch * BK * SW + row_off * SW + off;
        const int b_off = ch * BQ * SW + off;
        Mma<SN>::ss(sc, desc(ks + a_off, 16, 8 * SW, SW),
                    desc(qt + b_off, 16, 8 * SW, SW), kk);
        Mma<SN>::ss(dp, desc(vs + a_off, 16, 8 * SW, SW),
                    desc(dot + b_off, 16, 8 * SW, SW), kk);
      }
    };
    // P^T and dS^T (rows: keys, columns: queries) of the tile at q0 in
    // slot s, as hi / lo A fragments; the mask only where the tile has a
    // pair that is not visible.
    auto fragments = [&](int s, int q0) {
      const float* lse_t = lse_s + s * BQ + q_off;
      const float* dd_t = dd_s + s * BQ + q_off;
      const int qs0 = q0 + q_off;
      auto pass = [&](auto masked) {
#pragma unroll
        for (int e = 0; e < SN / 2; ++e) {
          const int kr = kr0 + r0 + 8 * ((e % 4) / 2);
          const int qc = 8 * (e / 4) + c0 + e % 2;
          const bool on = !decltype(masked)::value ||
                          (qs0 + qc < S &&
                           visible(qs0 + qc, kr, S, causal, window));
          p_ds(sc[e], on, lse_t[qc], dp[e], dd_t[qc], cap, scale, sc[e],
               dp[e]);
        }
      };
      if (all_visible(qs0, qs0 + SN - 1, kr0, kr0 + 63, S, causal,
                      window)) {
        pass(std::false_type{});
      } else {
        pass(std::true_type{});
      }
      if constexpr (TL::SPLIT) {
        // Each warpgroup has the fragments of its k-steps (2 wg, 2 wg + 1);
        // thread t of the other holds the same rows and columns of the
        // others, so the halves go through xbuf[array][k-step][t].
        uint32_t h[4][SN / 16][4];
        split_frags(sc, h[0], h[1]);
        split_frags(dp, h[2], h[3]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int k = 0; k < SN / 16; ++k) {
            xbuf[(a * (BQ / 16) + SN / 16 * wg + k) * 128 + t] =
                make_uint4(h[a][k][0], h[a][k][1], h[a][k][2], h[a][k][3]);
          }
        }
        bar_sync(3, 256);
        auto take = [&](uint32_t(&f)[BQ / 16][4], int a) {
#pragma unroll
          for (int k = 0; k < BQ / 16; ++k) {
            const uint4 x = xbuf[(a * (BQ / 16) + k) * 128 + t];
            f[k][0] = x.x;
            f[k][1] = x.y;
            f[k][2] = x.z;
            f[k][3] = x.w;
          }
        };
        take(ph, 0);
        take(pl, 1);
        take(dh, 2);
        take(dl, 3);
        bar_sync(4, 256);                    // xbuf is free again
      } else {
        split_frags(sc, ph, pl);
        split_frags(dp, dh, dl);
      }
    };
    // dV += P^T dO, dK += dS^T Q over the tile in slot s, 16 queries a
    // step, with dO and Q read MN-major from column col_off.
    auto accumulate = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const int b_off = s * Q_BYTES + col_off / CW * BQ * SW + kk * 16 * SW;
        const uint64_t bdo = desc(dos + b_off, BQ * SW, 8 * SW, SW);
        const uint64_t bq = desc(qs + b_off, BQ * SW, 8 * SW, SW);
        Mma<DN>::rs(adv, ph[kk], bdo);
        Mma<DN>::rs(adv, pl[kk], bdo);
        Mma<DN>::rs(adk, dh[kk], bq);
        Mma<DN>::rs(adk, dl[kk], bq);
      }
    };
    auto settle = [&] {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(adk);
      fence_regs(adv);
    };

    mbar_wait(kv_full, 0);
    if constexpr (TL::PINGPONG) {
      // Each step starts the last tile's dV / dK products and this tile's
      // scores in one turn; the two warpgroups take turns (named barriers
      // 1 + wg), so one's products run while the other computes P and dS.
      if (wg == 1) bar_arrive(1, 256);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(&full[s], (i / ST) & 1);
        bar_sync(1 + wg, 256);
        wgmma_fence();
        if (i > 0) accumulate((i - 1) % ST);
        scores(s);
        bar_arrive(2 - wg, 256);
        settle();
        if (i > 0) mbar_arrive(&empty[(i - 1) % ST]);
        fragments(s, qb + i * BQ);
      }
      bar_sync(1 + wg, 256);
      wgmma_fence();
      accumulate((n_tiles - 1) % ST);
      if (wg == 0) bar_arrive(2, 256);
      settle();
      mbar_arrive(&empty[(n_tiles - 1) % ST]);
    } else {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(&full[s], (i / ST) & 1);
        wgmma_fence();
        scores(s);
        settle();
        fragments(s, qb + i * BQ);
        wgmma_fence();
        accumulate(s);
        settle();
        mbar_arrive(&empty[s]);
      }
    }

    const size_t rs = static_cast<size_t>(H) * D;
    const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
#pragma unroll
    for (int e = 0; e < DN / 2; e += 2) {
      const int kr = kr0 + r0 + 8 * ((e % 4) / 2);
      if (kr >= S) continue;
      const size_t off = base + static_cast<size_t>(kr) * rs + col_off +
                         8 * (e / 4) + c0;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(adk[e] * scale, adk[e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(adv[e], adv[e + 1]);
    }
  }
}

// Dynamic shared memory of the tensor-core instance: the 1024-byte
// alignment slack, the tiles, the ring (with lse and D), the traded
// fragments at D = 256 and the barriers.
template <int D>
constexpr int tc_smem() {
  using TL = TcTiles<D>;
  return 1024 + 2 * TL::ROWS * D * 2 +
         TL::STAGES * (2 * TL::STREAM * D * 2 + 2 * TL::STREAM * 4) +
         (TL::SPLIT ? 4 * (TL::STREAM / 16) * 128 * 16 : 0) +
         (1 + 2 * TL::STAGES) * 8;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, void* dk, void* dv, int B,
              int H, int S, float scale, float cap, int causal, int window,
              cudaStream_t st) {
  using TL = TcTiles<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (hopper::bshd_map(&mq, q, B, S, H, D, TL::STREAM, TL::CW, TL::SW) ||
      hopper::bshd_map(&mk, k, B, S, H, D, TL::ROWS, TL::CW, TL::SW) ||
      hopper::bshd_map(&mv, v, B, S, H, D, TL::ROWS, TL::CW, TL::SW) ||
      hopper::bshd_map(&mdo, dout, B, S, H, D, TL::STREAM, TL::CW, TL::SW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = tc_smem<D>();
  auto kern = flash_bwd_dkv_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TL::ROWS - 1) / TL::ROWS, B * H);
  kern<<<grid, TL::THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
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
    constexpr int kD = decltype(dim)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return launch_tc<kD>(q, k, v, dout, lse, dd, dk, dv, B, H, S, scale,
                           cap, causal, window, st);
    } else {
      return launch<T, kD>(q, k, v, dout, lse, dd, dk, dv, B, H, S, scale,
                           cap, causal, window, st);
    }
  });
}

// The dynamic shared memory, in bytes, of the bfloat16 instance at head
// dim d (0 for a head dim it does not take).
extern "C" int flash_bwd_dkv_tc_smem(int d) {
  switch (d) {
    case 32: return tc_smem<32>();
    case 64: return tc_smem<64>();
    case 128: return tc_smem<128>();
    case 256: return tc_smem<256>();
  }
  return 0;
}
