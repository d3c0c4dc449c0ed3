// The attention block kernel's streamed design at head width 32 (the JAX kernel
// tests' fuzz width: C = 128, 4 heads), called through the C entry points in
// attention_block_streamed.cu.  A translation unit of its own, so that nvcc
// builds it beside the other widths'.

#include "attention_block_streamed.cuh"

extern "C" {

int vitcam_attention_block_streamed_w32(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream) {
  return st_entry<32>(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint, kv, out, cls, newj, batch,
                      n, heads, scale, mask_value, dtype, clamp, q_block, stream);
}

int vitcam_attention_block_streamed_occupancy_w32(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info) {
  return st_occupancy<32>(n, heads, rollout != 0, clamp, dtype, q_block, info);
}

}  // extern "C"
