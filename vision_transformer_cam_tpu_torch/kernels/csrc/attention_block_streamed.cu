// The attention block kernel's streamed design (attention_block_streamed.cuh,
// where its design notes are): the C entry points, the first launch (K and V
// of every head into the scratch) and the instances at head width 64.  The
// instances at 80 (ViT-H/14), 16, 32 and 40 are built from
// attention_block_streamed_w80.cu, _w16.cu, _w32.cu and _w40.cu, in parallel
// with this file.

#include "attention_block_streamed.cuh"

namespace {

// the first launch: grid (ceil(B N / 32), ceil(2C / 384)) blocks of kGT
// threads, each staging its tiles in stage_bytes<T, 4>() bytes
template <typename T>
cudaError_t kv_launch(const void* xn, const void* wqkv, const void* bqkv, void* kv, int rows,
                      int n, int heads, int dh, cudaStream_t stream) {
  constexpr int kSmem = stage_bytes<T, 4>();
  cudaError_t err = cudaFuncSetAttribute(block_kv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kGM - 1) / kGM, (2 * heads * dh + Tile<4>::kBN - 1) / Tile<4>::kBN);
  block_kv_kernel<T><<<grid, kGT, kSmem, stream>>>(
      static_cast<const T*>(xn), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv),
      static_cast<T*>(kv), rows, n, heads, dh);
  return cudaGetLastError();
}

bool compiled_width(int dh) { return dh == 16 || dh == 32 || dh == 40 || dh == 64 || dh == 80; }

}  // namespace

extern "C" {

int vitcam_attention_block_streamed_w16(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream);
int vitcam_attention_block_streamed_occupancy_w16(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info);
int vitcam_attention_block_streamed_w32(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream);
int vitcam_attention_block_streamed_occupancy_w32(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info);
int vitcam_attention_block_streamed_w40(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream);
int vitcam_attention_block_streamed_occupancy_w40(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info);
int vitcam_attention_block_streamed_w80(const void* xn, const void* tok, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* bg, const void* joint, const void* kv,
                                        void* out, void* cls, void* newj, int batch, int n,
                                        int heads, float scale, float mask_value, int dtype,
                                        int clamp, int q_block, void* stream);
int vitcam_attention_block_streamed_occupancy_w80(int n, int heads, int rollout, int clamp,
                                                  int dtype, int q_block, int* info);

// Shared memory a block of the second launch takes (the instance of dtype 0 =
// float32 or 1 = bfloat16, q_block 16 or 32 query rows, with the rollout or
// without), in bytes.
size_t vitcam_attention_block_streamed_smem_bytes(int n, int heads, int head_dim, int rollout,
                                                  int dtype, int q_block) {
  return st_smem_bytes(n, heads * head_dim, head_dim, rollout != 0, dtype, q_block);
}

// xn, tok, out [B, N, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C] and
// cls [B, N] of dtype 0 = float32 or 1 = bfloat16; bg [B, N] float32; joint
// and newj [B, N, N] float32, both null without the rollout; kv, the
// scratch [B, 2, H, N, head_dim] of xn's type.  head_dim 16, 32, 40, 64 or
// 80, the compiled widths; q_block
// 16 or 32 (query rows a block of the second launch; the launch fails where
// its shared memory does not fit).  Returns a cudaError_t; 0 means both
// kernels were launched.
int vitcam_attention_block_streamed(const void* xn, const void* tok, const void* wqkv,
                                    const void* bqkv, const void* wproj, const void* bproj,
                                    const void* bg, const void* joint, void* kv, void* out,
                                    void* cls, void* newj, int batch, int n, int heads,
                                    int head_dim, float scale, float mask_value, int dtype,
                                    int clamp, int q_block, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || heads < 1 || !compiled_width(head_dim) ||
      (q_block != 16 && q_block != 32) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((joint == nullptr) != (newj == nullptr)) return cudaErrorInvalidValue;
  if (size_t(batch) * n > size_t(1) << 30) return cudaErrorInvalidValue;
  const int c = heads * head_dim;
  if (st_smem_bytes(n, c, head_dim, joint != nullptr, dtype, q_block) > kStMaxSmem)
    return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
                        ? kv_launch<__nv_bfloat16>(xn, wqkv, bqkv, kv, batch * n, n, heads,
                                                   head_dim, s)
                        : kv_launch<float>(xn, wqkv, bqkv, kv, batch * n, n, heads, head_dim, s);
  if (err != cudaSuccess) return err;
  switch (head_dim) {
    case 16:
      return vitcam_attention_block_streamed_w16(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint,
                                                 kv, out, cls, newj, batch, n, heads, scale,
                                                 mask_value, dtype, clamp, q_block, stream);
    case 32:
      return vitcam_attention_block_streamed_w32(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint,
                                                 kv, out, cls, newj, batch, n, heads, scale,
                                                 mask_value, dtype, clamp, q_block, stream);
    case 40:
      return vitcam_attention_block_streamed_w40(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint,
                                                 kv, out, cls, newj, batch, n, heads, scale,
                                                 mask_value, dtype, clamp, q_block, stream);
    case 80:
      return vitcam_attention_block_streamed_w80(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint,
                                                 kv, out, cls, newj, batch, n, heads, scale,
                                                 mask_value, dtype, clamp, q_block, stream);
    case 64:
      return st_entry<64>(xn, tok, wqkv, bqkv, wproj, bproj, bg, joint, kv, out, cls, newj,
                          batch, n, heads, scale, mask_value, dtype, clamp, q_block, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The occupancy of the second launch's instance at N: info[4] = {blocks an
// SM at once, registers per thread, local memory per thread (bytes),
// shared memory per block}.  Returns a cudaError_t.
int vitcam_attention_block_streamed_occupancy(int n, int heads, int head_dim, int rollout,
                                              int clamp, int dtype, int q_block, int* info) {
  if (n < 1 || heads < 1 || (q_block != 16 && q_block != 32) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return vitcam_attention_block_streamed_occupancy_w16(n, heads, rollout, clamp, dtype,
                                                           q_block, info);
    case 32:
      return vitcam_attention_block_streamed_occupancy_w32(n, heads, rollout, clamp, dtype,
                                                           q_block, info);
    case 40:
      return vitcam_attention_block_streamed_occupancy_w40(n, heads, rollout, clamp, dtype,
                                                           q_block, info);
    case 80:
      return vitcam_attention_block_streamed_occupancy_w80(n, heads, rollout, clamp, dtype,
                                                           q_block, info);
    case 64:
      return st_occupancy<64>(n, heads, rollout != 0, clamp, dtype, q_block, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
