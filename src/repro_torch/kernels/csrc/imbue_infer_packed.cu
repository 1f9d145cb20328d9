// imbue_infer_packed: analog IMBUE class sums from packed literal words
// and dense float32 conductance / leak planes, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/imbue_infer.py :: imbue_infer_packed_kernel
//   (launched by imbue_infer_packed_call).
//
// The TPU kernel streams [bt, kt/32] literal words and unpacks them to
// drive voltages per K tile in VMEM before two narrow dots per column.
// Here a block stages its rows' words in shared memory and tests one bit
// per cell.  What it computes, its bound and its design are in
// imbue_dense.cuh.

#include "imbue_dense.cuh"

// litw [B, ceil(L/32)] int32, g / leak [R, C, L] float32, pol [C, M]
// int32, out [R, B, M] int32 zeroed by the caller.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int imbue_infer_packed_launch(const void* litw, const void* g,
                                         const void* leak, const void* pol,
                                         void* out, int R, int B, int L,
                                         int C, int M, float i_ref,
                                         float v_read, void* stream) {
  return imbk::launch(litw, g, leak, pol, out, R, B, L, C, M, i_ref,
                      v_read, stream);
}
