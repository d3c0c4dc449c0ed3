// The split-tensor attention kernel (the "v1" kernel, the port of
// vision_transformer_cam_tpu/kernels/attention.py: _attn_kernel): its C entry
// points, and its instances at head width 64.  The kernels and their design
// notes are in masked_attention_v1.cuh; the instances at head widths 16, 32,
// 40 and 80 are built from masked_attention_v1_w16.cu, ..._w32.cu, ..._w40.cu
// and ..._w80.cu, in parallel with this file.

#include "masked_attention_v1.cuh"

extern "C" {

int vitcam_masked_attention_v1_w16(const void* q, const void* k, const void* v, const void* bg,
                                   void* out, void* cls, void* hm, int batch, int n, int heads,
                                   float scale, float mask_value, int dtype, int with_hm,
                                   int design, void* stream);
int vitcam_masked_attention_v1_occupancy_w16(int n, int with_hm, int dtype, int design, int* info);
int vitcam_masked_attention_v1_w32(const void* q, const void* k, const void* v, const void* bg,
                                   void* out, void* cls, void* hm, int batch, int n, int heads,
                                   float scale, float mask_value, int dtype, int with_hm,
                                   int design, void* stream);
int vitcam_masked_attention_v1_occupancy_w32(int n, int with_hm, int dtype, int design, int* info);
int vitcam_masked_attention_v1_w40(const void* q, const void* k, const void* v, const void* bg,
                                   void* out, void* cls, void* hm, int batch, int n, int heads,
                                   float scale, float mask_value, int dtype, int with_hm,
                                   int design, void* stream);
int vitcam_masked_attention_v1_occupancy_w40(int n, int with_hm, int dtype, int design, int* info);
int vitcam_masked_attention_v1_w80(const void* q, const void* k, const void* v, const void* bg,
                                   void* out, void* cls, void* hm, int batch, int n, int heads,
                                   float scale, float mask_value, int dtype, int with_hm,
                                   int design, void* stream);
int vitcam_masked_attention_v1_occupancy_w80(int n, int with_hm, int dtype, int design, int* info);

// q, k, v [batch, heads, n, head_dim] of dtype 0 = float32 or 1 = bfloat16;
// bg [batch, n] float32; out like q, cls [batch, n] and hm (with_hm) [batch,
// n, n] in q's type.  head_dim: 16, 32, 40, 64 or 80, the compiled widths.
// design: 0 = the FMA design (either dtype), 1 = the tensor-core design
// (bfloat16, q, k and v 16-byte aligned).  Returns a cudaError_t; 0 means the
// kernel was launched.
int vitcam_masked_attention_v1(const void* q, const void* k, const void* v, const void* bg,
                               void* out, void* cls, void* hm, int batch, int n, int heads,
                               int head_dim, float scale, float mask_value, int dtype,
                               int with_hm, int design, void* stream) {
  switch (head_dim) {
    case 64:
      return v1_entry<64>(q, k, v, bg, out, cls, hm, batch, n, heads, scale, mask_value, dtype,
                          with_hm, design, stream);
    case 16:
      return vitcam_masked_attention_v1_w16(q, k, v, bg, out, cls, hm, batch, n, heads, scale,
                                            mask_value, dtype, with_hm, design, stream);
    case 32:
      return vitcam_masked_attention_v1_w32(q, k, v, bg, out, cls, hm, batch, n, heads, scale,
                                            mask_value, dtype, with_hm, design, stream);
    case 40:
      return vitcam_masked_attention_v1_w40(q, k, v, bg, out, cls, hm, batch, n, heads, scale,
                                            mask_value, dtype, with_hm, design, stream);
    case 80:
      return vitcam_masked_attention_v1_w80(q, k, v, bg, out, cls, hm, batch, n, heads, scale,
                                            mask_value, dtype, with_hm, design, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The shared memory a block of the design takes at (N, with_hm, head_dim):
// the FMA design at the query tile it picks (16 where none fits), the
// tensor-core design at its 16 rows; 0 for a width that is not compiled.
size_t vitcam_masked_attention_v1_smem_bytes(int n, int with_hm, int design, int head_dim) {
  if (head_dim != 16 && head_dim != 32 && head_dim != 40 && head_dim != 64 && head_dim != 80)
    return 0;
  if (design == 1) return tc_smem_bytes(n, with_hm, head_dim);
  const int qb = pick_qb(n, with_hm, head_dim);
  return smem_bytes(n, with_hm, qb ? qb : 16, head_dim);
}

// The occupancy of the instance a launch at N takes (v1_occupancy_entry in
// masked_attention_v1.cuh): info[4] = blocks an SM, registers, local bytes a
// thread, shared bytes a block.  Returns a cudaError_t.
int vitcam_masked_attention_v1_occupancy(int n, int with_hm, int dtype, int design, int head_dim,
                                         int* info) {
  switch (head_dim) {
    case 64:
      return v1_occupancy_entry<64>(n, with_hm, dtype, design, info);
    case 16:
      return vitcam_masked_attention_v1_occupancy_w16(n, with_hm, dtype, design, info);
    case 32:
      return vitcam_masked_attention_v1_occupancy_w32(n, with_hm, dtype, design, info);
    case 40:
      return vitcam_masked_attention_v1_occupancy_w40(n, with_hm, dtype, design, info);
    case 80:
      return vitcam_masked_attention_v1_occupancy_w80(n, with_hm, dtype, design, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
