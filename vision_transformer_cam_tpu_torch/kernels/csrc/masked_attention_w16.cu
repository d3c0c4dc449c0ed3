// Kernel 1's instances at head width 16 (the JAX quickstart's tiny ViT: C = 64,
// 4 heads), called through the C entry points in masked_attention.cu.  A
// translation unit of their own, so that nvcc builds them beside the other
// widths'.

#include "masked_attention.cuh"

extern "C" {

int vitcam_masked_attention_fused_w16(const void* qkv, const void* bg, const void* joint,
                                      void* out, void* cls, void* hm, void* newj,
                                      const void* scales, int scales_kind, int batch, int n,
                                      int heads, float scale, float mask_value, int dtype,
                                      int mode, int clamp, int flags, int q_block, int design,
                                      void* stream) {
  return fused_entry<16>(qkv, bg, joint, out, cls, hm, newj, scales, scales_kind, batch, n,
                         heads, scale, mask_value, dtype, mode, clamp, flags, q_block, design,
                         stream);
}

int vitcam_masked_attention_occupancy_w16(int n, int mode, int dtype, int design, int* info) {
  return occupancy_entry<16>(n, mode, dtype, design, info);
}

}  // extern "C"
