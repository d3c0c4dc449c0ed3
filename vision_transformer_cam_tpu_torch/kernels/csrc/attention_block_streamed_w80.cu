// The attention block kernel's streamed design at head width 80 (ViT-H/14:
// C = 1280, 16 heads), called through the C entry points in
// attention_block_streamed.cu.  A translation unit of its own, so that nvcc
// builds it beside the width-64 one.

#include "attention_block_streamed.cuh"

extern "C" {

int vitcam_attention_block_streamed_w80(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream) {
  return st_entry<80>(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint, kv, out, cls, newj, batch,
                      n, heads, scale, mask_value, dtype, clamp, q_block, stream);
}

int vitcam_attention_block_streamed_occupancy_w80(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info) {
  return st_occupancy<80>(n, heads, rollout != 0, clamp, dtype, q_block, info);
}

}  // extern "C"
