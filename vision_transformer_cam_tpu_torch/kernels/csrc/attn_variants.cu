// Ablation variants of the fused attention kernel with the in-kernel rollout
// update, for Hopper (sm_90a): each strips or swaps one stage, so that the
// cost of exp, the mask, the softmax, the two products and their int8 forms
// can be read off differences of their times.
//
// Replaces the TPU kernels of scripts/attn_variants.py: _kernel (seven
// variants) and _headbatch_kernel.  Every variant takes the packed qkv
// [B, N, 3C] (bf16 or float32, heads of 64 contiguous inside q|k|v), bg
// [B, N] float32 and the float32 joint [B, N, N], and returns out [B, N, C]
// and the head-mean cls row [B, N] in qkv's type and J' = (hm J + J) / 2:
//
//   full         S = Q K^T * scale + (1 - bg_q) * (-100 bg_k); E = exp(min(S,
//                80)); P = E / rowsum(E); O = P V with P rounded to V's type
//   noexp        P = S / rowsum(S)
//   nomask       no mask term
//   matmul-only  P = S * 0.001, no softmax
//   int8qk       q and k rows quantized in the kernel, per row, to int8 at
//                max|.| / 127; S from the int8 product (int32 sum) times
//                (qa * scale) times ka
//   int8pv       P rounded to int8 at x127, V quantized per column over the
//                keys; O from the int8 product times va / 127
//   int8both     the two together
//   headbatch    the function of full, the heads side by side in the block
//                (one warp per head) in place of the serial head loop
//
// What bounds them on this card.  At B=512, N=197, C=768 a call moves 779 MB
// (qkv in, out, J in and out): 0.23 ms at 3.35 TB/s; its products are 61
// GFLOP at the bf16 rate and 7.8 GFLOP (hm J) at the float32 rate.  The float
// products here are float32 FMAs on the CUDA cores and the int8 ones __dp4a
// (four int8 multiply-adds an instruction) fed from shared memory, so every
// variant is bound by those pipes and shared-memory bandwidth.
//
// Design.  The seven serial variants are one kernel template on masked_
// attention.cu's plan: a block owns 32 query rows of an image across all
// heads, keeps a [32, N] float32 tile of S and one of the head mean in shared
// memory, stages K and V per head in 64-key chunks, and ends with the rollout
// product for its rows.  The int8 forms stage their operands as packed int8
// words (K by key with a 17-word stride, V transposed by column, P by row),
// so that both products run as __dp4a over four keys or four channels a
// step; the row scales come from a warp reduction at staging, V's column
// scales from a pass over the head's V before P V.  headbatch gives every
// head a warp: the [H, 16, N] float32 tile of P (154 KB at H=12, N=197) and
// the heads' q rows stay in shared memory, K and V rows are read from device
// memory (L2) by the lanes directly, and the head mean is one reduction over
// the tile after a block-wide barrier.
//
// Rounding follows the TPU kernels: round half to even (rintf, as jnp.round),
// scales as true float32 divisions, and every scale product rounded one by
// one (__fmul_rn), so no FMA contraction moves them away from the plain
// version.

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 32;               // query rows per block (serial variants)
constexpr int kHQB = 16;              // query rows per block (headbatch)
constexpr int kKWords = kDH / 4 + 1;  // packed int8 row of 64, padded: no bank conflicts
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may ask for

enum Softmax { kExp = 0, kNoExp = 1, kMatmulOnly = 2 };

__device__ __forceinline__ int8_t quant(float x, float a) {
  return a > 0.f ? static_cast<int8_t>(rintf(x / a)) : int8_t(0);
}

// words of a packed int8 P row: the keys padded to whole 64-key chunks
__host__ __device__ inline int p_words(int n) { return ((n + kKC - 1) / kKC) * (kKC / 4); }

size_t smem_bytes(int n, bool pv8) {
  const size_t ns = padded(n);
  size_t floats = size_t(kQB) * kDH + size_t(kKC) * kKVStride + 2 * kQB * ns + ns + n +
                  2 * kQB + kKC + 5 * kDH;
  if (pv8) floats += size_t(kQB) * p_words(n);
  return floats * sizeof(float);
}

template <typename T, bool QK8, bool PV8, int SOFT, bool MASK>
__global__ void __launch_bounds__(kThreads)
attn_variant_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                    const float* __restrict__ joint, T* __restrict__ out,
                    T* __restrict__ cls, float* __restrict__ newj, int n, int heads,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* q_s = smem;                                  // [kQB][kDH]; QK8: packed int8
  float* kv_s = q_s + kQB * kDH;                      // [kKC][kKVStride]; int8: packed
  float* s_s = kv_s + kKC * kKVStride;                // [kQB][ns]
  float* hm_s = s_s + kQB * ns;                       // [kQB][ns]
  float* cls_s = hm_s + kQB * ns;                     // [ns]
  float* km_s = cls_s + ns;                           // [n] key mask
  float* fg_s = km_s + n;                             // [kQB] 1 - bg_q
  float* qa_s = fg_s + kQB;                           // [kQB] q row scales (QK8)
  float* ka_s = qa_s + kQB;                           // [kKC] k row scales (QK8)
  float* va_s = ka_s + kKC;                           // [kDH] v column scales (PV8)
  float* vmax_s = va_s + kDH;                         // [4][kDH] partial column maxima
  int* p8_s = reinterpret_cast<int*>(vmax_s + 4 * kDH);   // [kQB][p_words] (PV8)
  int8_t* q8 = reinterpret_cast<int8_t*>(q_s);        // [kQB][kDH] bytes
  int8_t* kv8 = reinterpret_cast<int8_t*>(kv_s);      // [64][kKWords * 4] bytes
  const int* q8w = reinterpret_cast<const int*>(q_s);
  const int* kv8w = reinterpret_cast<const int*>(kv_s);
  const int pw = p_words(n);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const int c = heads * kDH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;

  for (int k = tid; k < n; k += kThreads) km_s[k] = bg_b[k] * -100.f;
  for (int r = tid; r < kQB; r += kThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  for (int k = tid; k < ns; k += kThreads) cls_s[k] = 0.f;
  for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    // the head's q rows: float32, or int8 with one scale a row
    if constexpr (QK8) {
      for (int r = warp; r < kQB; r += kThreads / 32) {
        const bool live = q0 + r < n;
        const T* row = qkv_b + size_t(q0 + r) * c3 + h * kDH;
        const float x0 = live ? to_f(row[lane]) : 0.f;
        const float x1 = live ? to_f(row[lane + 32]) : 0.f;
        const float a = warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f;
        q8[r * kDH + lane] = quant(x0, a);
        q8[r * kDH + lane + 32] = quant(x1, a);
        if (lane == 0) qa_s[r] = a;
      }
    } else {
      for (int i = tid; i < kQB * kDH; i += kThreads) {
        const int r = i / kDH, d = i % kDH;
        q_s[i] = (q0 + r < n) ? to_f(qkv_b[size_t(q0 + r) * c3 + h * kDH + d]) : 0.f;
      }
    }

    // S tile, one K chunk at a time.  Thread: one key, kQB/4 query rows.
    {
      constexpr int kRows = kQB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q staged; previous chunk consumed
        float raw[kRows];  // Q K^T * scale
        if constexpr (QK8) {
          for (int r = warp; r < kKC; r += kThreads / 32) {
            const bool live = k0 + r < n;
            const T* row = qkv_b + size_t(k0 + r) * c3 + c + h * kDH;
            const float x0 = live ? to_f(row[lane]) : 0.f;
            const float x1 = live ? to_f(row[lane + 32]) : 0.f;
            const float a = warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f;
            kv8[r * kKWords * 4 + lane] = quant(x0, a);
            kv8[r * kKWords * 4 + lane + 32] = quant(x1, a);
            if (lane == 0) ka_s[r] = a;
          }
          __syncthreads();
          int acc[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i] = 0;
#pragma unroll 4
          for (int w = 0; w < kDH / 4; ++w) {
            const int kw = kv8w[kj * kKWords + w];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              acc[i] = __dp4a(q8w[(rg + i * kStep) * (kDH / 4) + w], kw, acc[i]);
          }
          const float ka = ka_s[kj];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            raw[i] = __fmul_rn(
                __fmul_rn(float(acc[i]), __fmul_rn(qa_s[rg + i * kStep], scale)), ka);
        } else {
          stage_chunk<kThreads>(kv_s, qkv_b, k0, n, c3, c + h * kDH);
          __syncthreads();
          float acc[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
          const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kKVStride);
#pragma unroll 4
          for (int d4 = 0; d4 < kDH / 4; ++d4) {
            const float4 kv = k4[d4];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float4 qv =
                  reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * kDH)[d4];
              acc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
            }
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) raw[i] = __fmul_rn(acc[i], scale);
        }
        const int k = k0 + kj;
        if (k < n) {
          const float km = km_s[k];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            float s = raw[i];
            if (MASK) s = __fadd_rn(s, __fmul_rn(fg_s[r], km));
            if (SOFT == kExp) s = fminf(s, 80.f);
            s_s[r * ns + k] = s;
          }
        }
      }
      __syncthreads();
    }

    // V's column scales over all the keys of this head (PV8)
    if constexpr (PV8) {
      const int d = tid % kDH, g = tid / kDH;
      float m = 0.f;
      for (int r = g; r < n; r += kThreads / kDH)
        m = fmaxf(m, fabsf(to_f(qkv_b[size_t(r) * c3 + 2 * c + h * kDH + d])));
      vmax_s[g * kDH + d] = m;
      __syncthreads();
      if (tid < kDH)
        va_s[tid] = fmaxf(fmaxf(vmax_s[tid], vmax_s[kDH + tid]),
                          fmaxf(vmax_s[2 * kDH + tid], vmax_s[3 * kDH + tid])) / 127.f;
    }

    // P from S, one warp per row.  Accumulates P into the head mean and the
    // cls row; leaves what P.V consumes: the rounded P in s_s, or int8 in p8_s.
    for (int r = warp; r < kQB; r += kThreads / 32) {
      float* row = s_s + r * ns;
      float sum = 1.f;
      if (SOFT != kMatmulOnly) {
        sum = 0.f;
        for (int k = lane; k < n; k += 32) {
          const float e = SOFT == kExp ? expf(row[k]) : row[k];
          row[k] = e;
          sum += e;
        }
        sum = warp_sum(sum);
      }
      const bool hm_row = q0 + r < n;
      const bool cls_row = has_cls && r == 0;
      for (int k = lane; k < ns; k += 32) {
        if (k >= n) {
          row[k] = 0.f;
          continue;
        }
        const float p = SOFT == kMatmulOnly ? __fmul_rn(row[k], 0.001f) : row[k] / sum;
        if (hm_row) hm_s[r * ns + k] += p;
        if (cls_row) cls_s[k] += p;
        row[k] = PV8 ? p : round_to<T>(p);
      }
      if constexpr (PV8) {
        __syncwarp();
        for (int w = lane; w < pw; w += 32) {
          int word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * w + i;
            const int v8 = k < n ? int(rintf(__fmul_rn(row[k], 127.f))) : 0;
            word |= (v8 & 0xff) << (8 * i);
          }
          p8_s[r * pw + w] = word;
        }
      }
    }

    // O = P V, one V chunk at a time.  Thread: one column d, kQB/4 rows.
    {
      constexpr int kRows = kQB * kDH / kThreads, kStep = kThreads / kDH;
      const int d = tid % kDH, rg = tid / kDH;
      float acc[kRows];
      int acc8[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f, acc8[i] = 0;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // P done; previous chunk consumed
        if constexpr (PV8) {
          // V chunk transposed: bytes [d][key], four keys a word
          for (int i = tid; i < kKC * kDH; i += kThreads) {
            const int r = i / kDH, dd = i % kDH;
            const float x = (k0 + r < n)
                                ? to_f(qkv_b[size_t(k0 + r) * c3 + 2 * c + h * kDH + dd])
                                : 0.f;
            kv8[dd * kKWords * 4 + r] = quant(x, va_s[dd]);
          }
          __syncthreads();
#pragma unroll 4
          for (int w = 0; w < kKC / 4; ++w) {
            const int vw = kv8w[d * kKWords + w];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              acc8[i] = __dp4a(p8_s[(rg + i * kStep) * pw + k0 / 4 + w], vw, acc8[i]);
          }
        } else {
          stage_chunk<kThreads>(kv_s, qkv_b, k0, n, c3, 2 * c + h * kDH);
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
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        if (q0 + r < n) {
          const float o = PV8 ? __fmul_rn(float(acc8[i]), va_s[d] / 127.f) : acc[i];
          out[(size_t(b) * n + q0 + r) * c + h * kDH + d] = from_f<T>(o);
        }
      }
    }
    __syncthreads();   // every buffer is reused by the next head
  }

  if (has_cls)
    for (int k = tid; k < n; k += kThreads)
      cls[size_t(b) * n + k] = from_f<T>(cls_s[k] / heads);
  for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = hm_s[i] / heads;
  __syncthreads();

  // Rollout: newj[b, q0 + r, k] = (sum_j hm[r, j] J[b, j, k] + J[b, q0 + r, k]) / 2.
  // Thread: one column k, all kQB rows; hm_s reads are warp broadcasts.
  const float* jb = joint + size_t(b) * n * n;
  float* nb = newj + size_t(b) * n * n;
  for (int k = tid; k < n; k += kThreads) {
    float acc[kQB];
#pragma unroll
    for (int r = 0; r < kQB; ++r) acc[r] = 0.f;
    for (int j = 0; j < ns; j += 4) {   // j < n; j + 1..3 may not be
      const float j0 = jb[size_t(j) * n + k];
      const float j1 = j + 1 < n ? jb[size_t(j + 1) * n + k] : 0.f;
      const float j2 = j + 2 < n ? jb[size_t(j + 2) * n + k] : 0.f;
      const float j3 = j + 3 < n ? jb[size_t(j + 3) * n + k] : 0.f;
#pragma unroll
      for (int r = 0; r < kQB; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hm_s + r * ns + j);
        acc[r] += hv.x * j0 + hv.y * j1 + hv.z * j2 + hv.w * j3;
      }
    }
#pragma unroll
    for (int r = 0; r < kQB; ++r)
      if (q0 + r < n)
        nb[size_t(q0 + r) * n + k] = 0.5f * (acc[r] + jb[size_t(q0 + r) * n + k]);
  }
}

// ---------------------------------------------------------------------------
// headbatch: one warp per head
// ---------------------------------------------------------------------------

// four consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), c = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, c.x, c.y);
}

size_t headbatch_smem_bytes(int n, int heads) {
  const size_t ns = padded(n);
  return (size_t(heads) * kHQB * ns + size_t(heads) * kHQB * kDH + kHQB * ns + n + kHQB) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(512, 1)
attn_headbatch_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                      const float* __restrict__ joint, T* __restrict__ out,
                      T* __restrict__ cls, float* __restrict__ newj, int n, int heads,
                      float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* p_s = smem;                                  // [heads][kHQB][ns]
  float* q_s = p_s + heads * kHQB * ns;               // [heads][kHQB][kDH]
  float* hm_s = q_s + heads * kHQB * kDH;             // [kHQB][ns]
  float* km_s = hm_s + kHQB * ns;                     // [n] key mask
  float* fg_s = km_s + n;                             // [kHQB] 1 - bg_q

  const int tid = threadIdx.x, lane = tid & 31, h = tid >> 5;   // warp = head
  const int threads = blockDim.x;
  const int b = blockIdx.y, q0 = blockIdx.x * kHQB;
  const int c = heads * kDH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  float* p_h = p_s + h * kHQB * ns;
  float* q_h = q_s + h * kHQB * kDH;

  for (int k = tid; k < n; k += threads) km_s[k] = bg_b[k] * -100.f;
  for (int r = tid; r < kHQB; r += threads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  for (int i = lane; i < kHQB * kDH; i += 32) {
    const int r = i / kDH, d = i % kDH;
    q_h[i] = (q0 + r < n) ? to_f(qkv_b[size_t(q0 + r) * c3 + h * kDH + d]) : 0.f;
  }
  __syncthreads();

  // S of this head.  Lane: one key at a time, all kHQB rows; the key's row is
  // read from device memory, the q rows are broadcasts from shared memory.
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    if (k < n) {
      const T* krow = qkv_b + size_t(k) * c3 + c + h * kDH;
      float acc[kHQB];
#pragma unroll
      for (int r = 0; r < kHQB; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < kDH / 4; ++d4) {
        const float4 kv = load4(krow + 4 * d4);
#pragma unroll
        for (int r = 0; r < kHQB; ++r) {
          const float4 qv = reinterpret_cast<const float4*>(q_h + r * kDH)[d4];
          acc[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
      const float km = km_s[k];
#pragma unroll
      for (int r = 0; r < kHQB; ++r)
        p_h[r * ns + k] =
            fminf(__fadd_rn(__fmul_rn(acc[r], scale), __fmul_rn(fg_s[r], km)), 80.f);
    }
  }
  __syncwarp();

  // softmax of this head's rows
  for (int r = 0; r < kHQB; ++r) {
    float* row = p_h + r * ns;
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float e = expf(row[k]);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < ns; k += 32) row[k] = k < n ? row[k] / sum : 0.f;
  }
  __syncthreads();

  // the head mean across the warps' tiles, in head order; each P is left
  // rounded to V's type for P V
  for (int i = tid; i < kHQB * ns; i += threads) {
    float sum = 0.f;
    for (int hh = 0; hh < heads; ++hh) {
      const float p = p_s[hh * kHQB * ns + i];
      sum += p;
      p_s[hh * kHQB * ns + i] = round_to<T>(p);
    }
    hm_s[i] = sum / heads;
  }
  __syncthreads();
  if (q0 == 0)
    for (int k = tid; k < n; k += threads) cls[size_t(b) * n + k] = from_f<T>(hm_s[k]);

  // O = P V of this head.  Lane: columns lane and lane + 32, all kHQB rows.
  {
    float acc0[kHQB], acc1[kHQB];
#pragma unroll
    for (int r = 0; r < kHQB; ++r) acc0[r] = 0.f, acc1[r] = 0.f;
    const T* vcol = qkv_b + 2 * c + h * kDH + lane;
    for (int j = 0; j < ns; j += 4) {
      float va[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = j + i < n;
        va[i] = live ? to_f(vcol[size_t(j + i) * c3]) : 0.f;
        vb[i] = live ? to_f(vcol[size_t(j + i) * c3 + 32]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kHQB; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_h + r * ns + j);
        acc0[r] += p.x * va[0] + p.y * va[1] + p.z * va[2] + p.w * va[3];
        acc1[r] += p.x * vb[0] + p.y * vb[1] + p.z * vb[2] + p.w * vb[3];
      }
    }
#pragma unroll
    for (int r = 0; r < kHQB; ++r)
      if (q0 + r < n) {
        T* orow = out + (size_t(b) * n + q0 + r) * c + h * kDH;
        orow[lane] = from_f<T>(acc0[r]);
        orow[lane + 32] = from_f<T>(acc1[r]);
      }
  }

  // Rollout, as in the serial variants, for this tile's kHQB rows.
  const float* jb = joint + size_t(b) * n * n;
  float* nb = newj + size_t(b) * n * n;
  for (int k = tid; k < n; k += threads) {
    float acc[kHQB];
#pragma unroll
    for (int r = 0; r < kHQB; ++r) acc[r] = 0.f;
    for (int j = 0; j < ns; j += 4) {
      const float j0 = jb[size_t(j) * n + k];
      const float j1 = j + 1 < n ? jb[size_t(j + 1) * n + k] : 0.f;
      const float j2 = j + 2 < n ? jb[size_t(j + 2) * n + k] : 0.f;
      const float j3 = j + 3 < n ? jb[size_t(j + 3) * n + k] : 0.f;
#pragma unroll
      for (int r = 0; r < kHQB; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hm_s + r * ns + j);
        acc[r] += hv.x * j0 + hv.y * j1 + hv.z * j2 + hv.w * j3;
      }
    }
#pragma unroll
    for (int r = 0; r < kHQB; ++r)
      if (q0 + r < n)
        nb[size_t(q0 + r) * n + k] = 0.5f * (acc[r] + jb[size_t(q0 + r) * n + k]);
  }
}

struct Args {
  const void *qkv, *bg, *joint;
  void *out, *cls, *newj;
  int batch, n, heads;
  float scale;
};

bool bad(const Args& a, int head_dim) {
  return head_dim != kDH || a.batch < 1 || a.batch > 65535 || a.n < 1 || a.heads < 1;
}

template <typename T, bool QK8, bool PV8, int SOFT, bool MASK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = attn_variant_kernel<T, QK8, PV8, SOFT, MASK>;
  const size_t smem = smem_bytes(a.n, PV8);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kQB - 1) / kQB, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), static_cast<T*>(a.out), static_cast<T*>(a.cls),
      static_cast<float*>(a.newj), a.n, a.heads, a.scale);
  return cudaGetLastError();
}

template <bool QK8, bool PV8, int SOFT, bool MASK>
int launch_dtype(const Args& a, int head_dim, int dtype, void* stream) {
  if (bad(a, head_dim)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, QK8, PV8, SOFT, MASK>(a, s);
    case 1:
      return launch<__nv_bfloat16, QK8, PV8, SOFT, MASK>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_headbatch(const Args& a, cudaStream_t stream) {
  auto kernel = attn_headbatch_kernel<T>;
  const size_t smem = headbatch_smem_bytes(a.n, a.heads);
  if (smem > kMaxSmem || a.heads > 16) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kHQB - 1) / kHQB, a.batch);
  kernel<<<grid, 32 * a.heads, smem, stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), static_cast<T*>(a.out), static_cast<T*>(a.cls),
      static_cast<float*>(a.newj), a.n, a.heads, a.scale);
  return cudaGetLastError();
}

}  // namespace

// One entry per variant.  qkv [batch, n, 3 * heads * 64] of dtype 0 = float32
// or 1 = bfloat16; bg [batch, n] float32; joint and newj [batch, n, n]
// float32; out [batch, n, heads * 64] and cls [batch, n] in qkv's type.
// Returns a cudaError_t; 0 means the kernel was launched.
#define VITCAM_VARIANT(name, QK8, PV8, SOFT, MASK)                                        \
  int vitcam_attn_variant_##name(const void* qkv, const void* bg, const void* joint,      \
                                 void* out, void* cls, void* newj, int batch, int n,      \
                                 int heads, int head_dim, float scale, int dtype,         \
                                 void* stream) {                                          \
    const Args a{qkv, bg, joint, out, cls, newj, batch, n, heads, scale};                 \
    return launch_dtype<QK8, PV8, SOFT, MASK>(a, head_dim, dtype, stream);                \
  }

extern "C" {

VITCAM_VARIANT(full, false, false, kExp, true)
VITCAM_VARIANT(noexp, false, false, kNoExp, true)
VITCAM_VARIANT(nomask, false, false, kExp, false)
VITCAM_VARIANT(matmul_only, false, false, kMatmulOnly, true)
VITCAM_VARIANT(int8qk, true, false, kExp, true)
VITCAM_VARIANT(int8pv, false, true, kExp, true)
VITCAM_VARIANT(int8both, true, true, kExp, true)

int vitcam_attn_variant_headbatch(const void* qkv, const void* bg, const void* joint,
                                  void* out, void* cls, void* newj, int batch, int n,
                                  int heads, int head_dim, float scale, int dtype,
                                  void* stream) {
  const Args a{qkv, bg, joint, out, cls, newj, batch, n, heads, scale};
  if (bad(a, head_dim)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_headbatch<float>(a, s);
    case 1:
      return launch_headbatch<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// shared memory a launch needs: the serial variants (int8_pv: with the packed
// int8 P tile), or headbatch with heads > 0
size_t vitcam_attn_variant_smem_bytes(int n, int int8_pv, int headbatch_heads) {
  return headbatch_heads > 0 ? headbatch_smem_bytes(n, headbatch_heads)
                             : smem_bytes(n, int8_pv != 0);
}

}  // extern "C"
