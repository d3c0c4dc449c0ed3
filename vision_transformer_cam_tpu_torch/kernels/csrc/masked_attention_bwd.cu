// The attention backward (the port of vision_transformer_cam_tpu/kernels/
// attention.py: _attn_bwd_kernel): its C entry points, and its instances at
// head width 64.  The kernels and their design notes are in
// masked_attention_bwd.cuh; the instances at head width 80 (ViT-H/14) are
// built from masked_attention_bwd_w80.cu, in parallel with this file.

#include "masked_attention_bwd.cuh"

extern "C" {

int vitcam_masked_attention_bwd_w80(const void* qkv, const void* bg, const void* d_out,
                                    void* d_qkv, void* stats, int batch, int n, int heads,
                                    float scale, float mask_value, int dtype, int clamp,
                                    int design, void* stream);
int vitcam_masked_attention_bwd_occupancy_w80(int n, int dtype, int design, int part,
                                              int* info);

// dtype: 0 = float32, 1 = bfloat16 (qkv, d_out and d_qkv); bg is float32.
// design: 0 = one block per (image, head), 1 = two FMA kernels, 2 = the two
// tensor-core kernels (bf16 only; qkv and d_out 16-byte aligned).  stats: a
// [B, H, N, 3] float32 scratch for designs 1 and 2, null for 0.  head_dim:
// 64 or 80, the compiled widths.  Returns a cudaError_t; 0 means every
// kernel was launched.
int vitcam_masked_attention_bwd(const void* qkv, const void* bg, const void* d_out,
                                void* d_qkv, void* stats, int batch, int n, int heads,
                                int head_dim, float scale, float mask_value, int dtype,
                                int clamp, int design, void* stream) {
  switch (head_dim) {
    case 64:
      return bwd_entry<64>(qkv, bg, d_out, d_qkv, stats, batch, n, heads, scale, mask_value,
                           dtype, clamp, design, stream);
    case 80:
      return vitcam_masked_attention_bwd_w80(qkv, bg, d_out, d_qkv, stats, batch, n, heads,
                                             scale, mask_value, dtype, clamp, design, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// shared memory of a block of the design at (N, head_dim): the larger of its
// two kernels'; 0 for another width
size_t vitcam_masked_attention_bwd_smem_bytes(int n, int design, int head_dim) {
  switch (head_dim) {
    case 64:
      return bwd_smem_entry<64>(n, design);
    case 80:
      return bwd_smem_entry<80>(n, design);
    default:
      return 0;
  }
}

// The occupancy of one kernel of a design (bwd_occupancy_entry in
// masked_attention_bwd.cuh): info[4] = blocks an SM, registers, local bytes
// a thread, shared bytes a block.  Returns a cudaError_t.
int vitcam_masked_attention_bwd_occupancy(int n, int dtype, int design, int head_dim, int part,
                                          int* info) {
  switch (head_dim) {
    case 64:
      return bwd_occupancy_entry<64>(n, dtype, design, part, info);
    case 80:
      return vitcam_masked_attention_bwd_occupancy_w80(n, dtype, design, part, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
