// The sequence-parallel kernel's instances at head width 32 (the JAX kernel
// tests' fuzz width: C = 128, 4 heads), called through the C entry points in
// masked_attention_seq.cu.  A translation unit of their own, so that nvcc
// builds them beside the other widths'.

#include "masked_attention_seq.cuh"

extern "C" {

int vitcam_masked_attention_seq_w32(const void* q, const void* kv, const void* bg_q,
                                    const void* bg_k, void* out, void* row0, void* hm, int batch,
                                    int nq, int np, int n_real, int heads, float scale,
                                    float mask_value, int dtype, int with_hm, int clamp,
                                    int flags, int design, void* stream) {
  return seq_entry<32>(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np, n_real, heads, scale,
                       mask_value, dtype, with_hm, clamp, flags, design, stream);
}

int vitcam_masked_attention_seq_occupancy_w32(int np, int with_hm, int dtype, int design,
                                              int* info) {
  return seq_occupancy_entry<32>(np, with_hm, dtype, design, info);
}

}  // extern "C"
