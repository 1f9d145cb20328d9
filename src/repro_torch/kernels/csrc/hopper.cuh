// hopper.cuh: the Hopper (sm_90a) primitives of the port's tensor-core
// kernels, in inline PTX: mbarriers, TMA tile loads, wgmma and its
// shared-memory matrix descriptors, and the host-side tensor maps.
// Written by hand (no CUTLASS / CuTe headers) so that a source that
// includes it builds in seconds.
//
// Tiles live in shared memory as TMA leaves them with a 128-byte swizzle
// (64-byte for rows of 32 bf16): a [rows, D] bf16 tile is D / CW chunks of
// [rows, CW] (CW = swizzle bytes / 2 columns), each chunk `rows * SW`
// bytes, row r at r * SW, the 16-byte groups of a row permuted by the row
// index.  Every chunk starts on a 1024-byte boundary, so the swizzle
// pattern wgmma reads (from the address bits) is the one TMA wrote.
//
// One such chunk is read by wgmma in either order:
// * K-major (D the reduction axis; S = K Q^T and the like): 8-row groups
//   SW * 8 bytes apart (SBO), a k-step of 16 columns 32 bytes further on
//   within the swizzled row (the hardware swizzles the final address);
// * MN-major (rows the reduction axis; dV = P^T dO and the like, B only):
//   a k-step of 16 rows 16 * SW bytes further on, 8-row groups SW * 8
//   apart (SBO), CW-column chunks `rows * SW` apart (LBO).
//
// wgmma.m64nNk16 accumulator layout (per warpgroup of 128 threads): thread
// t holds N / 2 floats; element i sits at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i % 4) / 2), column 8 (i / 4) + 2 (t % 4) + i % 2.  A register A
// fragment for k-step s (columns 16 s .. 16 s + 15 of that layout) is the
// bf16 pairs of elements 8 s + {0, 1}, {2, 3}, {4, 5}, {6, 7}: the
// accumulator of one product converts in place into the A operand of the
// next.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

// ------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Named barriers (ids 1-15; 0 is __syncthreads): arrive does not wait,
// sync waits until `count` threads have arrived or synced on `id`.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ TMA

// The box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory; completion counts `box bytes` on `bar`.  Coordinates
// past the tensor's extent read as zeros (and still count).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Hand registers between warpgroups: the producer gives its share up
// (dec), the consumers take it (inc).  Every thread of the warpgroup
// executes it; the two roles must never run common code afterwards.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The same for register A fragments: keeps them (and their registers)
// alive until after the wait of the wgmma that reads them.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[k][j]) :: "memory");
  }
}

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo, int sw_bytes) {
  const uint64_t layout = sw_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// 2^x in one MUFU.EX2, results below 2^-126 flushed to zero (exp2f also
// keeps subnormal results, at three more instructions each).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as the bf16x2 register of an A fragment (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of one m64nN accumulator x (R = N / 2 floats a thread),
// split in two so that hi + lo carries x to about 2^-16 of its value:
// hi = bf16(x), lo = bf16(x - hi).  Fragment s is k-step s (columns
// 16 s .. 16 s + 15).
template <int R>
__device__ __forceinline__ void split_frags(const float (&x)[R],
                                            uint32_t (&hi)[R / 8][4],
                                            uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int s = 0; s < R / 8; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * s + 2 * j], b = x[8 * s + 2 * j + 1];
      const float ha = __bfloat162float(__float2bfloat16_rn(a));
      const float hb = __bfloat162float(__float2bfloat16_rn(b));
      hi[s][j] = pack_bf16(ha, hb);
      lo[s][j] = pack_bf16(a - ha, b - hb);
    }
  }
}

// The start of a dynamic shared-memory area rounded up to 1024 bytes (the
// 128-byte swizzle's period); the launch asks for 1024 bytes more.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, for the N the flash
// kernels' tiles need:
// * ss (N = 32, 64, 128: score tiles; 128 for the forward's 128-key
//   tiles): A and B from shared memory, both K-major; `accumulate` 0
//   starts from zero;
// * rs (N = 32, 64, 128: output columns; the forward runs D = 256 as two
//   N = 128 halves): A from registers, B from shared memory MN-major;
//   accumulates.
template <int N>
struct Mma;

#define F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
struct Mma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : F8(0), F8(8)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24),
          F8(32), F8(40), F8(48), F8(56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F8(0), F8(8), F8(16), F8(24),
          F8(32), F8(40), F8(48), F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef F8

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda at link time).
inline CUresult encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                             cuuint32_t rank, void* base,
                             const cuuint64_t* dims,
                             const cuuint64_t* strides,
                             const cuuint32_t* box,
                             const cuuint32_t* elem_strides,
                             CUtensorMapSwizzle swizzle) {
  using Fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                          void*, const cuuint64_t*, const cuuint64_t*,
                          const cuuint32_t*, const cuuint32_t*,
                          CUtensorMapInterleave, CUtensorMapSwizzle,
                          CUtensorMapL2promotion,
                          CUtensorMapFloatOOBfill);
  static Fn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (p == nullptr || found != cudaDriverEntryPointSuccess) {
      return CUDA_ERROR_NOT_FOUND;
    }
    fn = reinterpret_cast<Fn>(p);
  }
  return fn(map, type, rank, base, dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A map over one [B, S, H, D] bf16 tensor, viewed as the 4-D (D, H, S, B)
// with D innermost, whose box is `cols` columns of `rows` rows of one
// head: coordinates (column, head, row, batch).  `sw_bytes` (128 or 64)
// is the swizzle, equal to cols * 2.
inline CUresult bshd_map(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D, int rows, int cols, int sw_bytes) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row,
                                 row * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, one,
                      sw_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace hopper
