// The sequence-parallel attention kernel (the port of
// vision_transformer_cam_tpu/kernels/attention.py: _attn_kernel_seq): its C
// entry points, and its instances at head width 64.  The kernels and their
// design notes are in masked_attention_seq.cuh; the instances at head widths
// 16, 32, 40 and 80 are built from masked_attention_seq_w16.cu, ..._w32.cu,
// ..._w40.cu and ..._w80.cu, in parallel with this file.

#include "masked_attention_seq.cuh"

extern "C" {

int vitcam_masked_attention_seq_w16(const void* q, const void* kv, const void* bg_q,
                                    const void* bg_k, void* out, void* row0, void* hm, int batch,
                                    int nq, int np, int n_real, int heads, float scale,
                                    float mask_value, int dtype, int with_hm, int clamp,
                                    int flags, int design, void* stream);
int vitcam_masked_attention_seq_occupancy_w16(int np, int with_hm, int dtype, int design,
                                              int* info);
int vitcam_masked_attention_seq_w32(const void* q, const void* kv, const void* bg_q,
                                    const void* bg_k, void* out, void* row0, void* hm, int batch,
                                    int nq, int np, int n_real, int heads, float scale,
                                    float mask_value, int dtype, int with_hm, int clamp,
                                    int flags, int design, void* stream);
int vitcam_masked_attention_seq_occupancy_w32(int np, int with_hm, int dtype, int design,
                                              int* info);
int vitcam_masked_attention_seq_w40(const void* q, const void* kv, const void* bg_q,
                                    const void* bg_k, void* out, void* row0, void* hm, int batch,
                                    int nq, int np, int n_real, int heads, float scale,
                                    float mask_value, int dtype, int with_hm, int clamp,
                                    int flags, int design, void* stream);
int vitcam_masked_attention_seq_occupancy_w40(int np, int with_hm, int dtype, int design,
                                              int* info);
int vitcam_masked_attention_seq_w80(const void* q, const void* kv, const void* bg_q,
                                    const void* bg_k, void* out, void* row0, void* hm, int batch,
                                    int nq, int np, int n_real, int heads, float scale,
                                    float mask_value, int dtype, int with_hm, int clamp,
                                    int flags, int design, void* stream);
int vitcam_masked_attention_seq_occupancy_w80(int np, int with_hm, int dtype, int design,
                                              int* info);

// q [batch, nq, heads*head_dim], kv [batch, np, 2*heads*head_dim] of dtype
// 0 = float32 or 1 = bfloat16; bg_q [batch, nq] and bg_k [batch, np]
// float32; out and row0 in q's type; hm (with_hm) [batch, nq, np], bf16 with
// flag 1 else float32.  design: 0 = the FMA design (float32 and bf16), 1 =
// the tensor-core design (bf16 only; q and kv 16-byte aligned).  head_dim:
// 16, 32, 40, 64 or 80, the compiled widths.  Returns a cudaError_t; 0 means
// the kernel was launched.
int vitcam_masked_attention_seq(const void* q, const void* kv, const void* bg_q,
                                const void* bg_k, void* out, void* row0, void* hm, int batch,
                                int nq, int np, int n_real, int heads, int head_dim,
                                float scale, float mask_value, int dtype, int with_hm,
                                int clamp, int flags, int design, void* stream) {
  switch (head_dim) {
    case 64:
      return seq_entry<64>(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np, n_real, heads,
                           scale, mask_value, dtype, with_hm, clamp, flags, design, stream);
    case 16:
      return vitcam_masked_attention_seq_w16(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np,
                                             n_real, heads, scale, mask_value, dtype, with_hm,
                                             clamp, flags, design, stream);
    case 32:
      return vitcam_masked_attention_seq_w32(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np,
                                             n_real, heads, scale, mask_value, dtype, with_hm,
                                             clamp, flags, design, stream);
    case 40:
      return vitcam_masked_attention_seq_w40(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np,
                                             n_real, heads, scale, mask_value, dtype, with_hm,
                                             clamp, flags, design, stream);
    case 80:
      return vitcam_masked_attention_seq_w80(q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np,
                                             n_real, heads, scale, mask_value, dtype, with_hm,
                                             clamp, flags, design, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The shared memory a block of the design takes at (Np, with_hm, head_dim):
// the FMA design at the query tile it picks (16 where none fits), the
// tensor-core design at its 16 rows; 0 for a width that is not compiled.
size_t vitcam_masked_attention_seq_smem_bytes(int np, int with_hm, int design, int head_dim) {
  if (head_dim != 16 && head_dim != 32 && head_dim != 40 && head_dim != 64 && head_dim != 80)
    return 0;
  if (design == 1) return tc_smem_bytes(np, with_hm, head_dim);
  const int qb = pick_qb(np, with_hm, head_dim);
  return smem_bytes(np, with_hm, qb ? qb : 16, head_dim);
}

// The occupancy of the instance a launch at Np takes (seq_occupancy_entry in
// masked_attention_seq.cuh): info[4] = blocks an SM, registers, local bytes
// a thread, shared bytes a block.  Returns a cudaError_t.
int vitcam_masked_attention_seq_occupancy(int np, int with_hm, int dtype, int design,
                                          int head_dim, int* info) {
  switch (head_dim) {
    case 64:
      return seq_occupancy_entry<64>(np, with_hm, dtype, design, info);
    case 16:
      return vitcam_masked_attention_seq_occupancy_w16(np, with_hm, dtype, design, info);
    case 32:
      return vitcam_masked_attention_seq_occupancy_w32(np, with_hm, dtype, design, info);
    case 40:
      return vitcam_masked_attention_seq_occupancy_w40(np, with_hm, dtype, design, info);
    case 80:
      return vitcam_masked_attention_seq_occupancy_w80(np, with_hm, dtype, design, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
