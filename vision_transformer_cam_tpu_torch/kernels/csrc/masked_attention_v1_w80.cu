// The split-tensor kernel's instances at head width 80 (ViT-H/14: C = 1280,
// 16 heads), called through the C entry points in masked_attention_v1.cu.  A
// translation unit of their own, so that nvcc builds them beside the other
// widths'.

#include "masked_attention_v1.cuh"

extern "C" {

int vitcam_masked_attention_v1_w80(const void* q, const void* k, const void* v, const void* bg,
                                   void* out, void* cls, void* hm, int batch, int n, int heads,
                                   float scale, float mask_value, int dtype, int with_hm,
                                   int design, void* stream) {
  return v1_entry<80>(q, k, v, bg, out, cls, hm, batch, n, heads, scale, mask_value, dtype,
                      with_hm, design, stream);
}

int vitcam_masked_attention_v1_occupancy_w80(int n, int with_hm, int dtype, int design, int* info) {
  return v1_occupancy_entry<80>(n, with_hm, dtype, design, info);
}

}  // extern "C"
