// imbue_infer: analog IMBUE class sums from dense 0/1 literal bytes and
// dense float32 conductance / leak planes, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/imbue_infer.py :: imbue_infer_kernel
//   (launched by imbue_infer_call).
//
// The TPU kernel takes the drive voltages (1 - lit) * v_read and the
// literals as two float32 [B, L] planes.  Here the literals arrive as the
// dense batcher's queue holds them, one byte each ([B, L] uint8, as
// tm_infer.cu reads them), and a block folds each row's 32 bytes of a
// column into one word: two 16-byte loads whose bytes `nibble` shifts
// down to bits, or byte by byte when L is not a multiple of 16
// (byte_word in imbue_dense.cuh).  What it computes, its bound and its
// design are in imbue_dense.cuh, shared with imbue_infer_packed.cu.

#include "imbue_dense.cuh"

// lits [B, L] uint8, g / leak [R, C, L] float32, pol [C, M] int32,
// out [R, B, M] int32 zeroed by the caller.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int imbue_infer_launch(const void* lits, const void* g,
                                  const void* leak, const void* pol,
                                  void* out, int R, int B, int L, int C,
                                  int M, float i_ref, float v_read,
                                  void* stream) {
  return imbk::launch<false>(lits, g, leak, pol, out, R, B, L, C, M, i_ref,
                             v_read, stream);
}
