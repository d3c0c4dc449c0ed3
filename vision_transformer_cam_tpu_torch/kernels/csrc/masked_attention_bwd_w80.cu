// The attention backward's instances at head width 80 (ViT-H/14: C = 1280,
// 16 heads), called through the C entry points in masked_attention_bwd.cu.
// A translation unit of their own, so that nvcc builds them beside the
// width-64 ones.

#include "masked_attention_bwd.cuh"

extern "C" {

int vitcam_masked_attention_bwd_w80(const void* qkv, const void* bg, const void* d_out,
                                    void* d_qkv, void* stats, int batch, int n, int heads,
                                    float scale, float mask_value, int dtype, int clamp,
                                    int design, void* stream) {
  return bwd_entry<80>(qkv, bg, d_out, d_qkv, stats, batch, n, heads, scale, mask_value, dtype,
                       clamp, design, stream);
}

int vitcam_masked_attention_bwd_occupancy_w80(int n, int dtype, int design, int part,
                                              int* info) {
  return bwd_occupancy_entry<80>(n, dtype, design, part, info);
}

}  // extern "C"
