// The attention backward's instances at head width 40 (the JAX kernel tests'
// fuzz width: C = 120, 3 heads), called through the C entry points in
// masked_attention_bwd.cu.  A translation unit of their own, so that nvcc
// builds them beside the other widths'.

#include "masked_attention_bwd.cuh"

extern "C" {

int vitcam_masked_attention_bwd_w40(const void* qkv, const void* bg, const void* d_out,
                                    void* d_qkv, void* stats, int batch, int n, int heads,
                                    float scale, float mask_value, int dtype, int clamp,
                                    int design, void* stream) {
  return bwd_entry<40>(qkv, bg, d_out, d_qkv, stats, batch, n, heads, scale, mask_value, dtype,
                       clamp, design, stream);
}

int vitcam_masked_attention_bwd_occupancy_w40(int n, int dtype, int design, int part,
                                              int* info) {
  return bwd_occupancy_entry<40>(n, dtype, design, part, info);
}

}  // extern "C"
