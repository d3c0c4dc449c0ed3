// Sequence-parallel masked multi-head attention with the CAM statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_kernel_seq.  A rank of a sequence group holds NQ query rows of a token
// axis padded to Np = sp * NQ, and the K | V rows of all ranks, gathered.  Per
// image and head, with q [B, NQ, C] and kv [B, Np, 2C] (K in the first C
// columns, V in the last; heads contiguous inside each):
//
//   S    = Q K^T * scale + (1 - bg_q) * (mask_value * bg_k) + kill
//          kill = -1e9 on key columns >= n_real (the padding), else 0
//   S    = min(S, 80)  (serving clamp)   or   S - rowmax(S)
//   E    = exp(S);  den = max(rowsum(E), 1e-30);  P = E / den
//   O    = P V  -> out[b, rows, h*64:(h+1)*64]
//   row0 = mean_h P[local row 0, :]                          -> row0 [B, Np]
//   hm   = mean_h P                   (with the head mean)   -> hm [B, NQ, Np]
//
// row0 is the cls row only on the rank that holds global row 0; the caller
// takes it from there.  Padded query rows (global row >= n_real on the last
// rank) carry zeros and bg 0: they attend to the real keys like any row, give
// finite values and are sliced off by the caller.
//
// Design: that of masked_attention.cu with the query and the key / value
// tensors addressed apart (row strides C and 2C).  A block owns QB query rows
// of one image across all heads and keeps a whole float32 key row of S in
// shared memory, so the softmax is exact in one pass (row0 and hm need the
// normalised P).  QB is 32 where the [QB, Np] tiles fit the 227 KB a block may
// use, and 16 past that: with the head mean the S tile and the hm tile are
// both [QB, Np] float32, which at QB = 32 holds Np <= 780 and at QB = 16 holds
// Np <= 1536, enough for N = 1025 padded to 1032.  K and V are staged per head
// in 64-key chunks; both products are float32 FMAs on the CUDA cores.
//
// Numerics follow the TPU kernel: S, the softmax and the means are float32;
// with the head mean P is normalised and then rounded to V's element type for
// P V; without it the unnormalised exponentials are rounded and O is divided
// by den afterwards.  S's scale, mask and kill terms are rounded one by one
// (__fmul_rn / __fadd_rn), so no FMA contraction moves them away from the
// plain version.

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may ask for
constexpr int kHmBf16 = 1;            // flag: hm is bf16, else float32

__device__ __forceinline__ void store_f(void* p, size_t i, float v, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

size_t smem_bytes(int np, int with_hm, int qb) {
  const size_t ns = padded(np);
  size_t floats = size_t(qb) * kDH + size_t(kKC) * kKVStride + qb * ns;
  if (with_hm) floats += qb * ns;
  floats += ns + np + 2 * qb;
  return floats * sizeof(float);
}

// query rows per block: 32 where the tiles fit, else 16, else 0 (too long)
int pick_qb(int np, int with_hm) {
  if (smem_bytes(np, with_hm, 32) <= kMaxSmem) return 32;
  if (smem_bytes(np, with_hm, 16) <= kMaxSmem) return 16;
  return 0;
}

// One block per SM is the target the compiler is given: with the head mean the
// two [QB, Np] tiles leave room for one block of 8 warps anyway, and with that
// hint ptxas spends 123 registers a thread on the two product loops where it
// would otherwise stop at 64 (6.28 -> 4.49 ms at B=16, N=577, bf16, on an
// NVIDIA H100 80GB HBM3 at 700 W).
template <typename T, int QB, bool HM, bool CLAMP>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_seq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                            const float* __restrict__ bg_q, const float* __restrict__ bg_k,
                            T* __restrict__ out, T* __restrict__ row0,
                            void* __restrict__ hm_out, int nq, int np, int n_real, int heads,
                            float scale, float mask_value, int flags) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(np);
  float* q_s = smem;                                  // [QB][kDH]
  float* kv_s = q_s + QB * kDH;                       // [kKC][kKVStride]
  float* s_s = kv_s + kKC * kKVStride;                // [QB][ns]
  float* hm_s = s_s + QB * ns;                        // [QB][ns], with HM only
  float* row0_s = hm_s + (HM ? QB * ns : 0);          // [ns]
  float* km_s = row0_s + ns;                          // [np] key mask
  float* fg_s = km_s + np;                            // [QB] 1 - bg_q
  float* den_s = fg_s + QB;                           // [QB] softmax sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const int c = heads * kDH, c2 = 2 * c;
  const T* q_b = q + size_t(b) * nq * c;
  const T* kv_b = kv + size_t(b) * np * c2;
  const bool has_row0 = q0 == 0;
  const bool hm_bf16 = flags & kHmBf16;

  for (int k = tid; k < np; k += kThreads) km_s[k] = bg_k[size_t(b) * np + k] * mask_value;
  for (int r = tid; r < QB; r += kThreads)
    fg_s[r] = (q0 + r < nq) ? 1.f - bg_q[size_t(b) * nq + q0 + r] : 0.f;
  for (int k = tid; k < ns; k += kThreads) row0_s[k] = 0.f;
  if (HM)
    for (int i = tid; i < QB * ns; i += kThreads) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    for (int i = tid; i < QB * kDH; i += kThreads) {
      const int r = i / kDH, d = i % kDH;
      q_s[i] = (q0 + r < nq) ? to_f(q_b[size_t(q0 + r) * c + h * kDH + d]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, QB/4 query rows.
    {
      constexpr int kRows = QB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < np; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads>(kv_s, kv_b, k0, np, c2, h * kDH);
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
        const int k = k0 + kj;
        if (k < np) {
          const float km = km_s[k];
          const float kill = k < n_real ? 0.f : -1e9f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            float s = __fadd_rn(
                __fadd_rn(__fmul_rn(acc[i], scale), __fmul_rn(fg_s[r], km)), kill);
            if (CLAMP) s = fminf(s, 80.f);
            s_s[r * ns + k] = s;
          }
        }
      }
      __syncthreads();
    }

    // Softmax, one warp per row.  Accumulates the normalised P into the head
    // mean and row 0; leaves in s_s what P.V consumes.
    for (int r = warp; r < QB; r += kThreads / 32) {
      float* row = s_s + r * ns;
      float m = 0.f;   // the clamp replaces the row-max subtraction
      if (!CLAMP) {
        m = -INFINITY;
        for (int k = lane; k < np; k += 32) m = fmaxf(m, row[k]);
        m = warp_max(m);
      }
      float sum = 0.f;
      for (int k = lane; k < np; k += 32) {
        const float e = expf(row[k] - m);
        row[k] = e;
        sum += e;
      }
      sum = fmaxf(warp_sum(sum), 1e-30f);
      const bool hm_row = HM && q0 + r < nq;
      const bool is_row0 = has_row0 && r == 0;
      for (int k = lane; k < ns; k += 32) {
        if (k >= np) {
          row[k] = 0.f;
          continue;
        }
        const float e = row[k], p = e / sum;
        if (hm_row) hm_s[r * ns + k] += p;
        if (is_row0) row0_s[k] += p;
        row[k] = round_to<T>(HM ? p : e);
      }
      if (lane == 0) den_s[r] = sum;
    }

    // O = P V, one V chunk at a time.  Thread: one column d, QB/4 rows.
    {
      constexpr int kRows = QB * kDH / kThreads, kStep = kThreads / kDH;
      const int d = tid % kDH, rg = tid / kDH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < np; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads>(kv_s, kv_b, k0, np, c2, c + h * kDH);
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
        if (q0 + r < nq) {
          const float o = HM ? acc[i] : acc[i] / den_s[r];
          out[(size_t(b) * nq + q0 + r) * c + h * kDH + d] = from_f<T>(o);
        }
      }
    }
    __syncthreads();   // s_s, den_s and kv_s are reused by the next head
  }

  if (has_row0)
    for (int k = tid; k < np; k += kThreads)
      row0[size_t(b) * np + k] = from_f<T>(row0_s[k] / heads);
  if constexpr (HM) {
    for (int i = tid; i < QB * np; i += kThreads) {
      const int r = i / np, k = i % np;
      if (q0 + r >= nq) break;
      store_f(hm_out, (size_t(b) * nq + q0 + r) * np + k, hm_s[r * ns + k] / heads, hm_bf16);
    }
  }
}

struct Args {
  const void *q, *kv, *bg_q, *bg_k;
  void *out, *row0, *hm;
  int batch, nq, np, n_real, heads;
  float scale, mask_value;
  int flags;
};

template <typename T, int QB, bool HM, bool CLAMP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_seq_kernel<T, QB, HM, CLAMP>;
  const size_t smem = smem_bytes(a.np, HM, QB);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + QB - 1) / QB, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kv),
      static_cast<const float*>(a.bg_q), static_cast<const float*>(a.bg_k),
      static_cast<T*>(a.out), static_cast<T*>(a.row0), a.hm, a.nq, a.np, a.n_real, a.heads,
      a.scale, a.mask_value, a.flags);
  return cudaGetLastError();
}

template <typename T, int QB, bool HM>
cudaError_t launch_clamp(int clamp, const Args& a, cudaStream_t stream) {
  return clamp ? launch<T, QB, HM, true>(a, stream) : launch<T, QB, HM, false>(a, stream);
}

template <typename T, int QB>
cudaError_t launch_hm(int with_hm, int clamp, const Args& a, cudaStream_t stream) {
  return with_hm ? launch_clamp<T, QB, true>(clamp, a, stream)
                 : launch_clamp<T, QB, false>(clamp, a, stream);
}

template <typename T>
cudaError_t launch_qb(int with_hm, int clamp, const Args& a, cudaStream_t stream) {
  switch (pick_qb(a.np, with_hm)) {
    case 32:
      return launch_hm<T, 32>(with_hm, clamp, a, stream);
    case 16:
      return launch_hm<T, 16>(with_hm, clamp, a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

extern "C" {

// q [batch, nq, heads*64], kv [batch, np, 2*heads*64] of dtype 0 = float32 or
// 1 = bfloat16; bg_q [batch, nq] and bg_k [batch, np] float32; out and row0
// in q's type; hm (with_hm) [batch, nq, np], bf16 with flag 1 else float32.
// Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_masked_attention_seq(const void* q, const void* kv, const void* bg_q,
                                const void* bg_k, void* out, void* row0, void* hm, int batch,
                                int nq, int np, int n_real, int heads, int head_dim,
                                float scale, float mask_value, int dtype, int with_hm,
                                int clamp, int flags, void* stream) {
  if (head_dim != kDH || batch < 1 || batch > 65535 || nq < 1 || np < nq || heads < 1 ||
      n_real < 1 || n_real > np || (with_hm != 0) != (hm != nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np, n_real, heads,
               scale, mask_value, flags};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_qb<float>(with_hm, clamp, a, s);
    case 1:
      return launch_qb<__nv_bfloat16>(with_hm, clamp, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t vitcam_masked_attention_seq_smem_bytes(int np, int with_hm) {
  const int qb = pick_qb(np, with_hm);
  return smem_bytes(np, with_hm, qb ? qb : 16);
}

}  // extern "C"
