// Masked multi-head attention on split q, k, v tensors with the CAM
// statistics (the "v1" kernel), for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_kernel (entry point masked_attention).  Per image and head, with q, k
// and v [B, H, N, 64] (each head's rows contiguous) and bg [B, N]:
//
//   S   = Q K^T * scale + mask_value * min(bg_i + bg_j, 1)   (pair mask)
//   P   = softmax(S), by row-max subtraction (no clamp)
//   O   = P V                                   -> out [B, H, N, 64]
//   cls = mean_h P[0, :]                        -> cls [B, N]
//   hm  = mean_h P           (with the head mean) -> hm [B, N, N]
//
// all three outputs in q's element type.  The pair mask is the reference's
// symmetric form and reaches every query row, background rows included; an
// image whose tokens are all background has every logit shifted by
// mask_value, which the row-max subtraction removes again.  The TPU kernel
// pads N to a multiple of 128 and kills the padded keys; here nothing is
// padded and the ragged edge is bounds-checked.
//
// What bounds it on this card.  At B=64, H=12, N=197 in bf16 it reads q, k, v
// and writes out once (77.5 MB; 82.5 MB with the bf16 head mean), 0.023 ms at
// 3.35 TB/s, and its two products are 7.6 GFLOP.  This design runs them as
// float32 FMAs on the CUDA cores out of shared memory, so it is bound by the
// FMA pipes and shared-memory bandwidth, far above the bytes bound.
//
// Design: that of masked_attention.cu on the split layout.  A block owns QB
// query rows of one image and loops over the heads, so the cls row and the
// head mean are summed in a fixed order without atomics; a whole float32 key
// row of S ([QB, N]) stays in shared memory, so the softmax is exact in one
// pass.  QB is 32 where the tiles fit the 227 KB a block may use and 16 past
// that (N <= 1536 with the head mean).  Each head's K and V are one contiguous
// [N, 64] slab, staged in 64-key chunks.
//
// Numerics follow the TPU kernel: S, the softmax and the means are float32;
// the normalised P is rounded to v's element type before P V.  The scale and
// the mask term are rounded one by one (__fmul_rn / __fadd_rn), so no FMA
// contraction moves them away from the plain version.

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may ask for

size_t smem_bytes(int n, int with_hm, int qb) {
  const size_t ns = padded(n);
  size_t floats = size_t(qb) * kDH + size_t(kKC) * kKVStride + qb * ns;
  if (with_hm) floats += qb * ns;
  floats += ns + n + qb;
  return floats * sizeof(float);
}

// query rows per block: 32 where the tiles fit, else 16, else 0 (too long)
int pick_qb(int n, int with_hm) {
  if (smem_bytes(n, with_hm, 32) <= kMaxSmem) return 32;
  if (smem_bytes(n, with_hm, 16) <= kMaxSmem) return 16;
  return 0;
}

template <typename T, int QB, bool HM>
__global__ void __launch_bounds__(kThreads)
masked_attention_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bg,
                           T* __restrict__ out, T* __restrict__ cls, T* __restrict__ hm_out,
                           int n, int heads, float scale, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* q_s = smem;                                  // [QB][kDH]
  float* kv_s = q_s + QB * kDH;                       // [kKC][kKVStride]
  float* s_s = kv_s + kKC * kKVStride;                // [QB][ns]
  float* hm_s = s_s + QB * ns;                        // [QB][ns], with HM only
  float* cls_s = hm_s + (HM ? QB * ns : 0);           // [ns]
  float* bgk_s = cls_s + ns;                          // [n] bg of the keys
  float* bgq_s = bgk_s + n;                           // [QB] bg of the query rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;

  for (int j = tid; j < n; j += kThreads) bgk_s[j] = bg_b[j];
  for (int r = tid; r < QB; r += kThreads) bgq_s[r] = (q0 + r < n) ? bg_b[q0 + r] : 0.f;
  for (int j = tid; j < ns; j += kThreads) cls_s[j] = 0.f;
  if (HM)
    for (int i = tid; i < QB * ns; i += kThreads) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const size_t head = (size_t(b) * heads + h) * n * kDH;   // this head's [N, 64] slab
    const T* q_h = q + head;
    const T* k_h = k + head;
    const T* v_h = v + head;
    for (int i = tid; i < QB * kDH; i += kThreads) {
      const int r = i / kDH;
      q_s[i] = (q0 + r < n) ? to_f(q_h[size_t(q0) * kDH + i]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, QB/4 query rows.
    {
      constexpr int kRows = QB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads>(kv_s, k_h, k0, n, kDH, 0);
        __syncthreads();
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kKVStride);
#pragma unroll 4
        for (int d4 = 0; d4 < kDH / 4; ++d4) {
          const float4 kvv = k4[d4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qv =
                reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * kDH)[d4];
            acc[i] += qv.x * kvv.x + qv.y * kvv.y + qv.z * kvv.z + qv.w * kvv.w;
          }
        }
        const int key = k0 + kj;
        if (key < n) {
          const float bgk = bgk_s[key];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            const float pair = __fmul_rn(fminf(__fadd_rn(bgq_s[r], bgk), 1.f), mask_value);
            s_s[r * ns + key] = __fadd_rn(__fmul_rn(acc[i], scale), pair);
          }
        }
      }
      __syncthreads();
    }

    // Softmax, one warp per row.  Accumulates the normalised P into the head
    // mean and the cls row; leaves in s_s the rounded P that P.V consumes.
    for (int r = warp; r < QB; r += kThreads / 32) {
      float* row = s_s + r * ns;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const bool hm_row = HM && q0 + r < n;
      const bool cls_row = has_cls && r == 0;
      for (int j = lane; j < ns; j += 32) {
        if (j >= n) {
          row[j] = 0.f;
          continue;
        }
        const float p = row[j] / sum;
        if (hm_row) hm_s[r * ns + j] += p;
        if (cls_row) cls_s[j] += p;
        row[j] = round_to<T>(p);
      }
    }

    // O = P V, one V chunk at a time.  Thread: one column d, QB/4 rows.
    {
      constexpr int kRows = QB * kDH / kThreads, kStep = kThreads / kDH;
      const int d = tid % kDH, rg = tid / kDH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads>(kv_s, v_h, k0, n, kDH, 0);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
          const float v0 = kv_s[(j + 0) * kKVStride + d];
          const float v1 = kv_s[(j + 1) * kKVStride + d];
          const float v2 = kv_s[(j + 2) * kKVStride + d];
          const float v3 = kv_s[(j + 3) * kKVStride + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 p = *reinterpret_cast<const float4*>(
                s_s + (rg + i * kStep) * ns + k0 + j);
            acc[i] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        if (q0 + r < n) out[head + size_t(q0 + r) * kDH + d] = from_f<T>(acc[i]);
      }
    }
    __syncthreads();   // s_s and kv_s are reused by the next head
  }

  if (has_cls)
    for (int j = tid; j < n; j += kThreads)
      cls[size_t(b) * n + j] = from_f<T>(cls_s[j] / heads);
  if constexpr (HM) {
    for (int i = tid; i < QB * n; i += kThreads) {
      const int r = i / n, j = i % n;
      if (q0 + r >= n) break;
      hm_out[(size_t(b) * n + q0 + r) * n + j] = from_f<T>(hm_s[r * ns + j] / heads);
    }
  }
}

struct Args {
  const void *q, *k, *v, *bg;
  void *out, *cls, *hm;
  int batch, n, heads;
  float scale, mask_value;
};

template <typename T, int QB, bool HM>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_v1_kernel<T, QB, HM>;
  const size_t smem = smem_bytes(a.n, HM, QB);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + QB - 1) / QB, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.bg), static_cast<T*>(a.out), static_cast<T*>(a.cls),
      static_cast<T*>(a.hm), a.n, a.heads, a.scale, a.mask_value);
  return cudaGetLastError();
}

template <typename T, int QB>
cudaError_t launch_hm(int with_hm, const Args& a, cudaStream_t stream) {
  return with_hm ? launch<T, QB, true>(a, stream) : launch<T, QB, false>(a, stream);
}

template <typename T>
cudaError_t launch_qb(int with_hm, const Args& a, cudaStream_t stream) {
  switch (pick_qb(a.n, with_hm)) {
    case 32:
      return launch_hm<T, 32>(with_hm, a, stream);
    case 16:
      return launch_hm<T, 16>(with_hm, a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

extern "C" {

// q, k, v [batch, heads, n, 64] of dtype 0 = float32 or 1 = bfloat16; bg
// [batch, n] float32; out like q, cls [batch, n] and hm (with_hm) [batch, n, n]
// in q's type.  Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_masked_attention_v1(const void* q, const void* k, const void* v, const void* bg,
                               void* out, void* cls, void* hm, int batch, int n, int heads,
                               int head_dim, float scale, float mask_value, int dtype,
                               int with_hm, void* stream) {
  if (head_dim != kDH || batch < 1 || batch > 65535 || n < 1 || heads < 1 ||
      (with_hm != 0) != (hm != nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, bg, out, cls, hm, batch, n, heads, scale, mask_value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_qb<float>(with_hm, a, s);
    case 1:
      return launch_qb<__nv_bfloat16>(with_hm, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t vitcam_masked_attention_v1_smem_bytes(int n, int with_hm) {
  const int qb = pick_qb(n, with_hm);
  return smem_bytes(n, with_hm, qb ? qb : 16);
}

}  // extern "C"
