// Kernel 1, the fused masked attention with the CAM statistics (the port of
// vision_transformer_cam_tpu/kernels/attention.py: _attn_kernel_fused): its
// C entry points, and its instances at head width 64.  The kernels and their
// design notes are in masked_attention.cuh; the instances at head widths 16,
// 32, 40 and 80 are built from masked_attention_w16.cu, ..._w32.cu,
// ..._w40.cu and ..._w80.cu, in parallel with this file.

#include "masked_attention.cuh"

extern "C" {

int vitcam_masked_attention_fused_w16(const void* qkv, const void* bg, const void* joint,
                                      void* out, void* cls, void* hm, void* newj,
                                      const void* scales, int scales_kind, int batch, int n,
                                      int heads, float scale, float mask_value, int dtype,
                                      int mode, int clamp, int flags, int q_block, int design,
                                      void* stream);
int vitcam_masked_attention_occupancy_w16(int n, int mode, int dtype, int design, int* info);
int vitcam_masked_attention_fused_w32(const void* qkv, const void* bg, const void* joint,
                                      void* out, void* cls, void* hm, void* newj,
                                      const void* scales, int scales_kind, int batch, int n,
                                      int heads, float scale, float mask_value, int dtype,
                                      int mode, int clamp, int flags, int q_block, int design,
                                      void* stream);
int vitcam_masked_attention_occupancy_w32(int n, int mode, int dtype, int design, int* info);
int vitcam_masked_attention_fused_w40(const void* qkv, const void* bg, const void* joint,
                                      void* out, void* cls, void* hm, void* newj,
                                      const void* scales, int scales_kind, int batch, int n,
                                      int heads, float scale, float mask_value, int dtype,
                                      int mode, int clamp, int flags, int q_block, int design,
                                      void* stream);
int vitcam_masked_attention_occupancy_w40(int n, int mode, int dtype, int design, int* info);
int vitcam_masked_attention_fused_w80(const void* qkv, const void* bg, const void* joint,
                                      void* out, void* cls, void* hm, void* newj,
                                      const void* scales, int scales_kind, int batch, int n,
                                      int heads, float scale, float mask_value, int dtype,
                                      int mode, int clamp, int flags, int q_block, int design,
                                      void* stream);
int vitcam_masked_attention_occupancy_w80(int n, int mode, int dtype, int design, int* info);

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (qkv; out too unless int8).
// mode: 0 = plain, 1 = head mean (hm), 2 = rollout (joint -> newj, f32).
// scales: device float vector of scales_kind 0 = none, 1 = [inv_out],
// 2 = [sq, sk, sv, inv_out], 3 = [sq_*, sk_*, sv_*, inv_out] (3H + 1).
// flags: 1 = int8 out (int8_out; implied by int8 qkv), 2 = cls bf16 (else
// f32), 4 = hm bf16 (else f32).
// q_block: query rows per block, 16 or 32, or 0 for auto (the FMA design:
// the larger one that fits; the tensor-core design: 16).
// design: 0 = the FMA design (every dtype), 1 = the tensor-core design
// (bfloat16 and int8 qkv, 16-byte aligned).
// head_dim: 16, 32, 40, 64 or 80, the compiled widths.
// Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_masked_attention_fused(const void* qkv, const void* bg, const void* joint,
                                  void* out, void* cls, void* hm, void* newj,
                                  const void* scales, int scales_kind, int batch, int n,
                                  int heads, int head_dim, float scale, float mask_value,
                                  int dtype, int mode, int clamp, int flags, int q_block,
                                  int design, void* stream) {
  switch (head_dim) {
    case 64:
      return fused_entry<64>(qkv, bg, joint, out, cls, hm, newj, scales, scales_kind, batch, n,
                             heads, scale, mask_value, dtype, mode, clamp, flags, q_block,
                             design, stream);
    case 16:
      return vitcam_masked_attention_fused_w16(qkv, bg, joint, out, cls, hm, newj, scales,
                                               scales_kind, batch, n, heads, scale, mask_value,
                                               dtype, mode, clamp, flags, q_block, design,
                                               stream);
    case 32:
      return vitcam_masked_attention_fused_w32(qkv, bg, joint, out, cls, hm, newj, scales,
                                               scales_kind, batch, n, heads, scale, mask_value,
                                               dtype, mode, clamp, flags, q_block, design,
                                               stream);
    case 40:
      return vitcam_masked_attention_fused_w40(qkv, bg, joint, out, cls, hm, newj, scales,
                                               scales_kind, batch, n, heads, scale, mask_value,
                                               dtype, mode, clamp, flags, q_block, design,
                                               stream);
    case 80:
      return vitcam_masked_attention_fused_w80(qkv, bg, joint, out, cls, hm, newj, scales,
                                               scales_kind, batch, n, heads, scale, mask_value,
                                               dtype, mode, clamp, flags, q_block, design,
                                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the FMA design's bytes at head width head_dim: its tiles set the q_block
// contract of both designs
size_t vitcam_masked_attention_smem_bytes(int n, int mode, int q_block, int head_dim) {
  const int qb = pick_qb(n, mode, q_block, head_dim);
  return smem_bytes(n, mode, qb ? qb : 16, head_dim);
}

// The occupancy of the instance a launch at N takes (occupancy_of in
// masked_attention.cuh): info[4] = blocks an SM, registers, local bytes a
// thread, shared bytes a block.  Returns a cudaError_t.
int vitcam_masked_attention_occupancy(int n, int mode, int dtype, int design, int head_dim,
                                      int* info) {
  switch (head_dim) {
    case 64:
      return occupancy_entry<64>(n, mode, dtype, design, info);
    case 16:
      return vitcam_masked_attention_occupancy_w16(n, mode, dtype, design, info);
    case 32:
      return vitcam_masked_attention_occupancy_w32(n, mode, dtype, design, info);
    case 40:
      return vitcam_masked_attention_occupancy_w40(n, mode, dtype, design, info);
    case 80:
      return vitcam_masked_attention_occupancy_w80(n, mode, dtype, design, info);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* vitcam_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
