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
// lse, 0.035 ms at 3.35 TB/s.  Bound by operations, with the exps as
// many cycles as the products: the design hides one behind the other.
//
// Two instances by dtype, chosen by the C entry's bf16 flag (no bf16
// call reaches the FFMA code):
//
// bfloat16, on the tensor cores (flash_fwd_tc): one block of three
// consumer warpgroups (two at D >= 128, where three would spill) and a
// producer warpgroup per (query tile of 64 rows a consumer, head), the
// longest causal tiles launched first so that the grid's tail is short.  The producer loads the query tile once by TMA (128-byte
// swizzle, 64-byte at D = 32, zero rows past S) and streams the key and
// value tiles of the tile's range (k_begin .. k_end; 128 rows at
// D <= 128, 64 at D = 256) through a ring of 2-4 stages behind
// mbarriers.  Each consumer warpgroup owns 64 query rows and all D
// columns of o:
// * S = Q K^T by wgmma, Q and K both K-major from shared memory;
// * the softmax in registers, each thread holding two rows of the
//   accumulator layout (hopper.cuh): the row max over a quad of threads,
//   exp2 with scale * log2e folded into one FFMA and one MUFU.EX2 (with
//   a softcap, the cap's tanhf once and log2e folded into the cap), the
//   mask only on tiles that cross the diagonal, the window edge or S,
//   branch-free (a masked score is -inf; a row with no visible key yet
//   keeps p = 0 and is reset exactly as the reference's exp(-1e30 - m)
//   does);
// * l sums the float32 P; P is rounded to bf16 only as the A operand of
//   P . V, so no hi / lo split is needed (unlike the backward);
// * acc is rescaled by exp2(m_old - m_new) at every tile, as the
//   reference does, then O += P V by wgmma with P as register A (the
//   score accumulator converted in place) and V read MN-major; at
//   D = 256, two N = 128 products on the two column halves;
// * o = acc / max(l, 1e-30) in bf16 and lse written from registers, rows
//   >= S not written.
// Tile i + 1's scores and tile i's P . V are issued together; the
// softmax waits for the scores alone (wgmma_wait<1>) and runs while
// P . V is in flight.  Letting two warpgroups take turns on named
// barriers instead, or as well, measured no faster, and 64-row key tiles
// at D <= 128 or two warpgroups at D = 64 slower (PERF.md).  At the main
// row the products and the exps each need about 0.12 ms; the kernel
// takes 2.7x that.
//
// float32, on CUDA cores (flash_fwd_kernel; TF32 would miss float32's
// 2e-5 bound): one block of 256 threads per (query tile of BQ rows,
// head); the query tile stays in shared memory as float32, each key /
// value tile of BK rows is staged beside it.  Only key tiles inside the
// tile's causal / window range are visited (k_begin .. k_end).  Each
// thread owns a TQ x TK patch of the score tile (4 x 4 at D <= 128) and
// TQ rows x D / 16 columns of the output accumulator; row max and row
// sum go through half-warp shuffles; P goes through shared memory to the
// P . V product.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr float LN2 = 0.6931471805599453f;

// The tiles of the bf16 forward: 64 query rows a consumer warpgroup,
// three warpgroups at D <= 64 and two above (whose accumulators need more
// registers than three can have), key / value tiles of BK rows, a ring
// as deep as shared memory allows (D = 256: 64 KB of q and 64 KB a
// stage).
template <int D>
struct FwdTiles {
  using TC = TcTiles<D>;
  static constexpr int WGS = D <= 64 ? 3 : 2;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 128;
  // The producer warpgroup's registers go to the consumers:
  // CONSUMERS * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536.
  static constexpr int PRODUCER_REGS = WGS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = WGS == 2 ? 232 : 160;
  static constexpr int BQ = 64 * WGS;
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int SW = TC::SW, CW = TC::CW, NCH = TC::NCH;
  static constexpr int NB = D < 128 ? D : 128;   // columns of one P V product
  static constexpr int NH = D / NB;              // products a k-step
  // A block's shared memory less the alignment slack and the barriers.
  static constexpr int SMEM_MAX = 232448 - 1024 - 128;
  static constexpr int STAGES_FIT =
      (SMEM_MAX - BQ * D * 2) / (2 * BK * D * 2);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int S, float scale, float cap, int causal,
                 int window) {
  using TL = FwdTiles<D>;
  using namespace hopper;
  constexpr int BQ = TL::BQ, BK = TL::BK, SW = TL::SW, CW = TL::CW;
  constexpr int NB = TL::NB, NH = TL::NH, ST = TL::STAGES;
  constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);         // NCH chunks of [BQ, CW]
  uint8_t* ks = qs + Q_BYTES;                // [ST] x NCH chunks of [BK, CW]
  uint8_t* vs = ks + ST * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * KV_BYTES);
  uint64_t* full = q_full + 1;               // [ST]
  uint64_t* empty = full + ST;               // [ST]

  // Query tiles in reverse: under a causal mask the last ones see the
  // most keys, so they go out first.
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kb = k_begin(q0, window) / BK * BK;
  const int n_tiles = (k_end(q0, BQ, S, causal) - kb + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TL::CONSUMERS);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= TL::CONSUMERS) {
    // Producer warpgroup; one thread loads q once, then k and v of each
    // key tile.
    regs_dec<TL::PRODUCER_REGS>();
    if (threadIdx.x != TL::CONSUMERS) return;
    mbar_arrive_tx(q_full, Q_BYTES);
    for (int c = 0; c < TL::NCH; ++c) {
      tma_load_4d(qs + c * BQ * SW, &tq, q_full, c * CW, h, q0, b);
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
    return;
  }

  // Consumers: warpgroup wg owns query rows qr0 .. qr0 + 63.
  regs_inc<TL::CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int qr0 = q0 + 64 * wg;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;   // accumulator row (+8)
  const int c0 = 2 * (t % 4);                    // accumulator column (+1)
  // Exponents in base 2: exp(s' - max s') = 2^((y - max y) mult), with
  // y the raw score and mult = scale log2e without a softcap, y = cap
  // log2e tanh(x / cap) and mult = 1 with one.
  const float mult = cap > 0.f ? 1.f : scale * LOG2E;
  const float x_cap = cap > 0.f ? scale / cap : 0.f;
  const float y_cap = cap * LOG2E;
  const float to_nat = cap > 0.f ? LN2 : scale;  // y units -> natural
  float m[2] = {-INFINITY, -INFINITY};  // running max of y, rows r0, r0 + 8
  float l[2] = {0.f, 0.f};              // this thread's share of l
  float acc[NH][NB / 2];
#pragma unroll
  for (int n = 0; n < NH; ++n) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[n][i] = 0.f;
  }
  float sc[BK / 2];
  uint32_t pf[BK / 16][4];

  // S = Q K^T of the key tile in slot s, over D, 16 columns a step.
  auto scores = [&](int s) {
    const uint8_t* kt = ks + s * KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ch = kk * 16 / CW, off = (kk * 16 % CW) * 2;
      Mma<BK>::ss(sc, desc(qs + ch * BQ * SW + 64 * wg * SW + off, 16,
                           8 * SW, SW),
                  desc(kt + ch * BK * SW + off, 16, 8 * SW, SW), kk);
    }
  };
  // O += P V over the tile in slot s, 16 keys a step, V read MN-major.
  auto accumulate = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        Mma<NB>::rs(acc[n], pf[kk],
                    desc(vs + s * KV_BYTES + n * NB / CW * BK * SW +
                             kk * 16 * SW,
                         BK * SW, 8 * SW, SW));
      }
    }
  };
  // The online softmax of the tile at k0: the new row max, p (in place
  // in sc) and l; returns each row's rescale factor in corr.
  auto softmax = [&](int k0, float (&corr)[2]) {
    float mx[2] = {m[0], m[1]};
    auto pass = [&](auto masked, auto capped) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int j = (e % 4) / 2;
        float y = sc[e];
        if constexpr (decltype(capped)::value) {
          y = y_cap * tanhf(y * x_cap);
        }
        if constexpr (decltype(masked)::value) {
          const int qi = qr0 + r0 + 8 * j;
          const int kc = k0 + 8 * (e / 4) + c0 + e % 2;
          y = visible(qi, kc, S, causal, window) ? y : -INFINITY;
        }
        sc[e] = y;
        mx[j] = fmaxf(mx[j], y);
      }
    };
    auto with_mask = [&](auto capped) {
      if (all_visible(qr0, qr0 + 63, k0, k0 + BK - 1, S, causal, window)) {
        pass(std::false_type{}, capped);
      } else {
        pass(std::true_type{}, capped);
      }
    };
    if (cap > 0.f) {
      with_mask(std::true_type{});
    } else {
      with_mask(std::false_type{});
    }
    float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      // A row with no visible key so far keeps m = -inf and p = 0.
      base[j] = mx[j] == -INFINITY ? 0.f : mx[j] * mult;
      corr[j] = exp2_ftz(m[j] * mult - base[j]);
      m[j] = mx[j];
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int j = (e % 4) / 2;
      sc[e] = exp2_ftz(fmaf(sc[e], mult, -base[j]));
      sum[j] += sc[e];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * corr[j] + sum[j];
  };
  // acc rescaled to the new max, then P as bf16 A fragments.
  auto rescale_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[n][i] *= corr[(i % 4) / 2];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pf[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      }
    }
  };

  float corr[2];

  // Tile 0: its scores alone.  The steady state issues tile i's scores
  // and tile i - 1's P . V in one group each, so that the softmax can
  // wait for the scores alone; the last P . V goes alone at the end.
  // (Straight wgmma groups: a group that is issued on one path only makes
  // ptxas serialise every wgmma.)
  mbar_wait(q_full, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(kb, corr);
  rescale_pack(corr);
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % ST, sp = (i - 1) % ST;
    mbar_wait(&full[s], (i / ST) & 1);
    wgmma_fence();
    scores(s);
    wgmma_commit();
    accumulate(sp);
    wgmma_commit();
    wgmma_wait<1>();                         // the scores; P . V runs on
    fence_regs(sc);
    softmax(kb + i * BK, corr);
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NH; ++n) fence_regs(acc[n]);
    fence_regs(pf);                          // read until P . V is done
    mbar_arrive(&empty[sp]);
    rescale_pack(corr);
  }
  wgmma_fence();
  accumulate((n_tiles - 1) % ST);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NH; ++n) fence_regs(acc[n]);
  mbar_arrive(&empty[(n_tiles - 1) % ST]);

  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    const float lm = fmaxf(l[j], 1e-30f);
    const int qi = qr0 + r0 + 8 * j;
    if (qi >= S) continue;
    __nv_bfloat16* row = o + base + static_cast<size_t>(qi) * rs;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int e = 2 * j; e < NB / 2; e += 4) {
        *reinterpret_cast<__nv_bfloat162*>(row + n * NB + 8 * (e / 4) + c0) =
            __floats2bfloat162_rn(acc[n][e] / lm, acc[n][e + 1] / lm);
      }
    }
    if (t % 4 == 0) {
      lse[static_cast<size_t>(bh) * S + qi] =
          m[j] * to_nat + logf(lm);
    }
  }
}

// Dynamic shared memory of the bf16 instance: the 1024-byte alignment
// slack, the query tile, the ring and the barriers.
template <int D>
constexpr int tc_smem() {
  using TL = FwdTiles<D>;
  return 1024 + TL::BQ * D * 2 + TL::STAGES * 2 * TL::BK * D * 2 +
         (1 + 2 * TL::STAGES) * 8;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int H, int S, float scale, float cap,
              int causal, int window, cudaStream_t st) {
  using TL = FwdTiles<D>;
  CUtensorMap mq, mk, mv;
  if (hopper::bshd_map(&mq, q, B, S, H, D, TL::BQ, TL::CW, TL::SW) ||
      hopper::bshd_map(&mk, k, B, S, H, D, TL::BK, TL::CW, TL::SW) ||
      hopper::bshd_map(&mv, v, B, S, H, D, TL::BK, TL::CW, TL::SW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = tc_smem<D>();
  auto kern = flash_fwd_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + TL::BQ - 1) / TL::BQ);
  kern<<<grid, TL::THREADS, smem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      H, S, scale, cap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

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
    constexpr int kD = decltype(dim)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return launch_tc<kD>(q, k, v, o, lse, B, H, S, scale, cap, causal,
                           window, st);
    } else {
      return launch<T, kD>(q, k, v, o, lse, B, H, S, scale, cap, causal,
                           window, st);
    }
  });
}

// The dynamic shared memory, in bytes, of the bfloat16 instance at head
// dim d (0 for a head dim it does not take).
extern "C" int flash_fwd_tc_smem(int d) {
  switch (d) {
    case 32: return tc_smem<32>();
    case 64: return tc_smem<64>();
    case 128: return tc_smem<128>();
    case 256: return tc_smem<256>();
  }
  return 0;
}
