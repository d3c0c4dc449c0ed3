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
//                in place of the serial head loop
//
// What bounds them on this card.  At B=512, N=197, C=768 a call moves 779 MB
// (qkv in, out, J in and out): 0.23 ms at 3.35 TB/s; its products are 61
// GFLOP at the bf16 rate and 7.8 GFLOP (hm J) at the float32 rate.
//
// Two designs.
//
// The tensor-core design (bf16): kernel 1's (masked_attention.cu, with the
// tile code of attention_tc.cuh) with one stage stripped or swapped, so that
// the differences say where kernel 1's own time goes.  A block of 8 warps
// owns 16 query rows; the warps take the key chunks in turn from private
// two-stage cp.async rings of swizzled tiles; S in registers; per head two
// passes over the keys, the warps' row sums meeting in shared memory, and the
// warps' partial O tiles summed in one order; the [16, N] float32 head mean in
// shared memory; flushed denormals; the rollout rows from the head mean.
// full is kernel 1's bf16 rollout variant (clamp on) instruction for
// instruction: the same outputs bit for bit.  nomask drops the mask term,
// noexp the exponentials, matmul-only pass 1 and the softmax.  int8qk
// quantizes the 16 q rows once a head and every staged K chunk (a lane or two
// a row, a true float32 division and rintf) into int8 tiles and runs QK^T on
// mma.sync.m16n8k32.s8, as kernel 1's int8_io.  int8pv takes 32-key chunks
// (one k32 step) and runs P V on m16n8k32.s8: V's column scales need every
// key of the head, so one pass over V a head forms the column maxima and,
// after a block barrier, the int8 V of the whole head, transposed, into
// shared memory, its keys in the order in which P's accumulator registers
// already hold them (pv8_key: an int32 sum is exact in any order, so P is
// never shuffled); the warps' int32 partials are summed and scaled at the
// end.  headbatch gives each of 4 warps whole heads (heads w, w + 4, ...):
// each warp walks every key chunk of its head through its own ring, sums its
// rows alone and writes O directly, and adds P into a [16, N] float32 tile of
// its own; one block barrier at the end, then the tiles are summed in warp
// order.  No barrier a head: the variant reads what kernel 1's three barriers
// a head cost.
//
// The FMA design (float32, and bf16 where it is asked for): the seven serial
// variants are one kernel template on the FMA plan of masked_attention.cu: a
// block owns 32 query rows of an image across all heads, keeps a [32, N]
// float32 tile of S and one of the head mean in shared memory, stages K and V
// per head in 64-key chunks, and ends with the rollout product for its rows.
// The int8 forms stage their operands as packed int8 words (K by key with a
// 17-word stride, V transposed by column, P by row), so that both products
// run as __dp4a over four keys or four channels a step.  headbatch gives
// every head a warp over a [H, 16, N] float32 tile of P (154 KB at H=12,
// N=197), K and V rows read from device memory (L2) by the lanes directly.
//
// Rounding follows the TPU kernels: round half to even (rintf, as jnp.round),
// scales as true float32 divisions, and every scale product rounded one by
// one (__fmul_rn), so no FMA contraction moves them away from the plain
// version.

#include <cmath>

#include "attention_tc.cuh"
#include "int8_common.cuh"

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

// quant(x, a) bit for bit, with inv = 1 / a computed once a row or column.
// |x / a| <= 127, so x * inv lies within 2e-5 of the true float32 quotient
// x / a: the two round to the same integer unless x * inv lies within 1e-4 of
// a half-integer, and only there the division (about a hundred instructions
// on this card) runs.
__device__ __forceinline__ int8_t quant_inv(float x, float a, float inv) {
  if (!(a > 0.f)) return 0;
  const float t = __fmul_rn(x, inv), r = rintf(t);
  if (__builtin_expect(fabsf(fabsf(t - r) - 0.5f) > 1e-4f, 1)) return static_cast<int8_t>(r);
  return static_cast<int8_t>(rintf(__fdiv_rn(x, a)));
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

// ---------------------------------------------------------------------------
// The tensor-core design (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcRing = tc_ring_bytes(2, 1);   // bytes of a warp's ring
constexpr int kHbWarps = 4;                    // headbatch: warps a block

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// words of a row of the transposed int8 V tile (int8pv): the head's keys in
// whole 32-key chunks, padded to 4 mod 32 words, so that the B fragment
// reads of a warp (rows g, words t) fall in 32 different banks
__host__ __device__ inline int vt_words(int n) {
  const int w = round_up(n, 32) / 4;
  return w + ((4 - w) % 32 + 32) % 32;
}

// The key, within a 32-key chunk, at position p of the k dimension of the
// int8 P V product.  The S accumulators of a thread (lane 4g + t) hold keys
// 8j + 2t and 8j + 2t + 1 of the chunk's n8 tiles j = 0..3; the s8 A fragment
// wants positions 4t..4t+3 and 16+4t..16+4t+3 in one register each.  So
// position 4t + i is key 2t + (i & 1) + 8 (i >> 1), plus 16 in the upper
// half: P stays in the registers it was formed in, and V is staged in this
// order (scripts/attn_variants.pv8_key_order is the same map).
__host__ __device__ inline int pv8_key(int p) {
  return (p & 16) + 2 * ((p & 15) >> 2) + (p & 1) + 8 * ((p >> 1) & 1);
}

size_t tc_smem_bytes(int n, bool qk8, bool pv8) {
  const int kc = pv8 ? 32 : kTcChunk, nk = round_up(n, kc);
  size_t bytes = size_t(kTcWarps) * kTcRing;
  size_t floats = size_t(2) * nk + kTcWarps * 16 * 2 + 16 + size_t(16) * tc_hm_stride(n);
  if (qk8) {
    bytes += size_t(kTcWarps) * kc * kDH + 16 * kDH;
    floats += 16 + kTcWarps * kc;
  }
  if (pv8) {
    bytes += size_t(kDH) * vt_words(n) * 4;
    floats += kTcWarps * kDH + kDH;
  }
  return bytes + floats * sizeof(float);
}

size_t hb_smem_bytes(int n) {
  return size_t(kHbWarps) * kTcRing +
         (size_t(tc_keys(n)) + 16 + size_t(kHbWarps) * 16 * tc_hm_stride(n)) * sizeof(float);
}

// A block owns 16 query rows of one image; its 8 warps take the key chunks in
// turn (warp w: chunks w, w + 8, ...) from private two-stage rings.  Per head:
// pass 1 forms each row's sum (exp or, noexp, the logits), the warps'
// partials meet in shared memory; pass 2 forms P, adds it into the head mean
// and the cls row (each element owned by one thread) and feeds it to P V
// (bf16 in registers, or int8); the warps' partial O tiles meet in their
// rings.  Every line that full runs is kernel 1's (masked_attention_tc_kernel
// at bf16, kRollout, clamp, one m16 tile), in its order.
template <int SOFT, bool MASK, bool QK8, bool PV8>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_variant_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bg,
                       const float* __restrict__ joint, bf16* __restrict__ out,
                       bf16* __restrict__ cls, float* __restrict__ newj, int n, int heads,
                       float scale) {
  using TC = Tc<bf16>;
  constexpr bool CLAMP = SOFT == kExp;        // min(S, 80) comes with exp
  constexpr bool kPass1 = SOFT != kMatmulOnly;
  constexpr int KC = PV8 ? 32 : kTcChunk;     // keys of a chunk
  constexpr int NT = KC / 8;                  // n8 tiles of keys in a chunk
  // a stage: K and V of 16 keys, or (int8 P V: V comes from vt_s) K of 32
  constexpr int kStage = PV8 ? KC * kDH : 2 * TC::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = round_up(n, KC), hs = tc_hm_stride(n), vw = vt_words(n);
  unsigned char* rings = smem_raw;                                  // [warps][kTcRing]
  int8_t* k8_all = reinterpret_cast<int8_t*>(rings + kTcWarps * kTcRing);  // [warps][KC][64]
  int8_t* q8_s = k8_all + (QK8 ? kTcWarps * KC * kDH : 0);          // [16][64]
  unsigned char* vt_s = reinterpret_cast<unsigned char*>(q8_s + (QK8 ? 16 * kDH : 0));
  float* km_s = reinterpret_cast<float*>(vt_s + (PV8 ? kDH * vw * 4 : 0));  // [nk]
  float* cls_s = km_s + nk;                             // [nk]
  float* st_s = cls_s + nk;                             // [warps][16][2]: max, sum
  float* fg_s = st_s + kTcWarps * 16 * 2;               // [16]
  float* hm_s = fg_s + 16;                              // [16][hs]
  float* qa_s = hm_s + 16 * hs;                         // [16] (QK8)
  float* ka_all = qa_s + (QK8 ? 16 : 0);                // [warps][KC] (QK8)
  float* vmax_s = ka_all + (QK8 ? kTcWarps * KC : 0);   // [warps][64] (PV8)
  float* va_s = vmax_s + (PV8 ? kTcWarps * kDH : 0);    // [64] (PV8)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * 16;
  const int c = heads * kDH, c3 = 3 * c;
  const bf16* qkv_b = qkv + size_t(b) * n * c3;
  const bool has_cls = q0 == 0;
  bf16* ring = reinterpret_cast<bf16*>(rings + warp * kTcRing);
  int8_t* k8_s = k8_all + warp * KC * kDH;
  float* ka_s = ka_all + warp * KC;
  const int n_chunks = nk / KC;
  const int mine = warp < n_chunks ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;

  for (int k = tid; k < nk; k += kTcThreads) {
    km_s[k] = k < n ? bg[size_t(b) * n + k] * -100.f : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < 16; r += kTcThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg[size_t(b) * n + q0 + r] : 0.f;
  for (int i = tid; i < 16 * hs; i += kTcThreads) hm_s[i] = 0.f;
  __syncthreads();
  const float fg[2] = {fg_s[g], fg_s[g + 8]};
  const bool row_ok[2] = {q0 + g < n, q0 + g + 8 < n};

  // stage chunk i of this warp (K, and V with with_v) into stage i % 2
  auto stage = [&](int h, int i, bool with_v) {
    const int k0 = (warp + i * kTcWarps) * KC;
    bf16* dst = ring + (i & 1) * kStage;
    const bf16* src = qkv_b + size_t(k0) * c3 + c + h * kDH;
    stage_rows64<KC, 32>(dst, src, c3, n - k0, lane);
    if (!PV8 && with_v) stage_rows64<KC, 32>(dst + KC * kDH, src + c, c3, n - k0, lane);
    cp_async_commit();
  };
  // int8qk: the staged K chunk quantized per row into the warp's int8 tile
  auto quant_k = [&](const bf16* k_s) {
    constexpr int kLanes = 32 / KC;      // lanes a row
    constexpr int kSegs = 8 / kLanes;    // 16-byte bf16 segments a lane reads
    const int r = lane / kLanes, part = lane % kLanes;
    auto seg = [&](int s, float (&x)[8]) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k_s + swz(r, (part * kSegs + s) * 8));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(e[j]);
    };
    float mx = 0.f;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      float x[8];
      seg(s, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(x[j]));
    }
    if (kLanes == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float a = mx / 127.f, inv = 1.f / a;
#pragma unroll
    for (int s = 0; s < kSegs / 2; ++s) {   // one 16-byte int8 segment from two bf16 ones
      int w[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x[8];
        seg(2 * s + half, x);
        int q[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) q[j] = quant_inv(x[j], a, inv);
        w[2 * half] = pack4(q[0], q[1], q[2], q[3]);
        w[2 * half + 1] = pack4(q[4], q[5], q[6], q[7]);
      }
      *reinterpret_cast<int4*>(k8_s + swz64(r, (part * kSegs / 2 + s) * 16)) =
          make_int4(w[0], w[1], w[2], w[3]);
    }
    if (part == 0) ka_s[r] = a;
    __syncwarp();
  };

  typename TC::QFrag qa[1];
  unsigned qa8[1][2][4];
  float qsc[2];   // int8qk: qa * scale of rows g, g + 8
  // S of one chunk (NT n8 tiles): scaled, masked, clamped; keys >= n -inf
  // (0 where no exp follows)
  auto logits = [&](float (&s)[NT][4], const bf16* k_s, int k0) {
#pragma unroll
    for (int sub = 0; sub < KC / 16; ++sub) {
      float d[1][2][4];
      if constexpr (QK8)
        Tc<int8_t>::dots<1>(d, qa8, k8_s + sub * 16 * kDH, lane);
      else
        TC::dots<1>(d, qa, k_s + sub * 16 * kDH, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * sub + nt][e] = d[0][nt][e];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + t * 8 + 2 * tg + (e & 1);
        float v = SOFT == kExp ? -INFINITY : 0.f;
        if (k < n) {
          const float raw = QK8 ? __fmul_rn(__fmul_rn(s[t][e], qsc[e >> 1]), ka_s[k - k0])
                                : __fmul_rn(s[t][e], scale);
          v = MASK ? __fadd_rn(raw, __fmul_rn(fg[e >> 1], km_s[k])) : raw;
          if (CLAMP) v = fminf(v, 80.f);
        }
        s[t][e] = v;
      }
  };

  if (mine && kPass1) stage(0, 0, false);
  for (int h = 0; h < heads; ++h) {
    if constexpr (QK8) {
      // the head's 16 q rows as int8, one scale a row
      for (int r = warp; r < 16; r += kTcWarps) {
        const bool live = q0 + r < n;
        const bf16* row = qkv_b + size_t(live ? q0 + r : 0) * c3 + h * kDH;
        const float x0 = live ? __bfloat162float(row[lane]) : 0.f;
        const float x1 = live ? __bfloat162float(row[lane + 32]) : 0.f;
        const float a = warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f;
        q8_s[r * kDH + lane] = quant_inv(x0, a, 1.f / a);
        q8_s[r * kDH + lane + 32] = quant_inv(x1, a, 1.f / a);
        if (lane == 0) qa_s[r] = a;
      }
      __syncthreads();
      const unsigned* plo = reinterpret_cast<const unsigned*>(q8_s + g * kDH);
      const unsigned* phi = reinterpret_cast<const unsigned*>(q8_s + (g + 8) * kDH);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        qa8[0][kk][0] = plo[kk * 8 + tg];
        qa8[0][kk][1] = phi[kk * 8 + tg];
        qa8[0][kk][2] = plo[kk * 8 + 4 + tg];
        qa8[0][kk][3] = phi[kk * 8 + 4 + tg];
      }
      qsc[0] = __fmul_rn(qa_s[g], scale);
      qsc[1] = __fmul_rn(qa_s[g + 8], scale);
    } else {
      TC::q_frags(qa[0], qkv_b + h * kDH, c3, q0, n, lane);
    }

    float mx[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};
    if constexpr (kPass1) {
      // pass 1: per row the sum of exp (clamp: no maximum) or of the logits
      float l[2] = {0.f, 0.f};
      for (int i = 0; i < mine; ++i) {
        if (i + 1 < mine) {
          stage(h, i + 1, false);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const bf16* k_s = ring + (i & 1) * kStage;
        if constexpr (QK8) quant_k(k_s);
        float s[NT][4];
        logits(s, k_s, (warp + i * kTcWarps) * KC);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (SOFT == kExp)
              l[hf] += exp_ftz(s[t][2 * hf] - mx[hf]) + exp_ftz(s[t][2 * hf + 1] - mx[hf]);
            else
              l[hf] += s[t][2 * hf] + s[t][2 * hf + 1];
          }
        __syncwarp();   // this stage is read before the chunk after next lands in it
      }
      if constexpr (PV8) {
        // V's column maxima over the head's keys: a thread reads 8 columns
        // (16 bytes) of every 32nd key; the 4 key lanes of a warp meet by
        // shuffles, the 8 warps' partials in shared memory
        const int cg = tid % 8, kl = tid / 8;
        float m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = 0.f;
        // four 16-byte loads in flight a thread: one at a time leaves the
        // loop waiting on L2 latency
        const bf16* vcol = qkv_b + 2 * c + h * kDH + cg * 8;
        for (int r0 = kl; r0 < n; r0 += 4 * (kTcThreads / 8)) {
          uint4 raw[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + u * (kTcThreads / 8);
            raw[u] = r < n ? *reinterpret_cast<const uint4*>(vcol + size_t(r) * c3)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
            for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], fabsf(__bfloat162float(e[j])));
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 8));
          m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 16));
        }
        if (lane < 8)
#pragma unroll
          for (int j = 0; j < 8; ++j) vmax_s[warp * kDH + cg * 8 + j] = m[j];
      }
      if (mine) stage(h, 0, true);   // pass 2's first chunk loads across the barrier
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float lsum = quad_sum(l[hf]);
        if (tg == 0) {
          float* st = st_s + (warp * 16 + g + 8 * hf) * 2;
          st[0] = mx[hf];
          st[1] = lsum;
        }
      }
      __syncthreads();
      // every thread combines the warps' partials of its rows, in one order
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        float den = 0.f;
        for (int w = 0; w < kTcWarps; ++w) den += st_s[(w * 16 + r) * 2 + 1];
        inv[hf] = 1.f / den;
      }
    } else {
      if (mine) stage(h, 0, true);
    }
    if constexpr (PV8) {
      // V of the whole head as int8 (per column, max|v| / 127), transposed:
      // word (d, w) holds the keys of positions 4w..4w+3 in pv8_key order.
      // An item is one word position and 8 columns: four 16-byte key rows in,
      // eight words out; consecutive threads write consecutive words
      const int nw = nk / 4;
      for (int i = tid; i < 8 * nw; i += kTcThreads) {
        const int w = i % nw, cg = i / nw;
        float va[8], inv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float m = vmax_s[cg * 8 + j];
#pragma unroll
          for (int p = 1; p < kTcWarps; ++p) m = fmaxf(m, vmax_s[p * kDH + cg * 8 + j]);
          va[j] = m / 127.f;
          inv[j] = 1.f / va[j];
        }
        int q[4][8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (w / 8) * 32 + pv8_key(4 * (w % 8) + e);
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (key < n)
            raw = *reinterpret_cast<const uint4*>(qkv_b + size_t(key) * c3 + 2 * c + h * kDH + cg * 8);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) q[e][j] = quant_inv(__bfloat162float(x[j]), va[j], inv[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<int*>(vt_s + (size_t(cg * 8 + j) * vw + w) * 4) =
              pack4(q[0][j], q[1][j], q[2][j], q[3][j]);
      }
      if (tid < kDH) {
        float m = vmax_s[tid];
        for (int p = 1; p < kTcWarps; ++p) m = fmaxf(m, vmax_s[p * kDH + tid]);
        va_s[tid] = m / 127.f;
      }
      __syncthreads();
    }

    // pass 2: P, the head mean and the cls row, O = P V
    float o[8][4];
    int o8[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f, o8[j][e] = 0;
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const bf16* k_s = ring + (i & 1) * kStage;
      const int k0 = (warp + i * kTcWarps) * KC;
      if constexpr (QK8) quant_k(k_s);
      float s[NT][4];
      logits(s, k_s, k0);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int k = k0 + t * 8 + 2 * tg;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (SOFT == kExp) {
            const float ex = exp_ftz(s[t][e] - mx[e >> 1]);
            p[e] = ftz(ex * inv[e >> 1]);
          } else if (SOFT == kNoExp) {
            p[e] = s[t][e] * inv[e >> 1];
          } else {
            p[e] = __fmul_rn(s[t][e], 0.001f);
          }
          s[t][e] = p[e];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (row_ok[hf]) {
            float2* h2 = reinterpret_cast<float2*>(hm_s + (g + 8 * hf) * hs + k);
            *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
          }
        if (has_cls && g == 0) {
          cls_s[k] += p[0];
          cls_s[k + 1] += p[1];
        }
      }
      if constexpr (PV8) {
        // P as int8 at x127, in the registers it was formed in (pv8_key)
        auto p8 = [](float x) { return int(rintf(__fmul_rn(x, 127.f))); };
        unsigned pa[4];
        pa[0] = pack4(p8(s[0][0]), p8(s[0][1]), p8(s[1][0]), p8(s[1][1]));
        pa[1] = pack4(p8(s[0][2]), p8(s[0][3]), p8(s[1][2]), p8(s[1][3]));
        pa[2] = pack4(p8(s[2][0]), p8(s[2][1]), p8(s[3][0]), p8(s[3][1]));
        pa[3] = pack4(p8(s[2][2]), p8(s[2][3]), p8(s[3][2]), p8(s[3][3]));
        const unsigned* vt = reinterpret_cast<const unsigned*>(vt_s) + (k0 / 32) * 8 + tg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned* col = vt + size_t(j * 8 + g) * vw;
          mma16832_s8(o8[j], pa, col[0], col[4]);
        }
      } else {
        unsigned pa[4];
        a_from_c(pa, s[0], s[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned vb[4];
          TC::v_frags(vb, k_s + TC::kChunk, j, 1.f, lane);
          mma16816(o[2 * j], pa, vb[0], vb[1]);
          mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
        }
      }
      __syncwarp();
    }

    // the warps' partial O tiles meet in their own rings, summed in one order
    // (int8pv: int32 partials, exact, scaled once)
    float* ox = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (PV8) {
        *reinterpret_cast<int2*>(ox + g * kTcOStride + j * 8 + 2 * tg) = make_int2(o8[j][0], o8[j][1]);
        *reinterpret_cast<int2*>(ox + (g + 8) * kTcOStride + j * 8 + 2 * tg) =
            make_int2(o8[j][2], o8[j][3]);
      } else {
        *reinterpret_cast<float2*>(ox + g * kTcOStride + j * 8 + 2 * tg) =
            make_float2(o[j][0], o[j][1]);
        *reinterpret_cast<float2*>(ox + (g + 8) * kTcOStride + j * 8 + 2 * tg) =
            make_float2(o[j][2], o[j][3]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * (kDH / 4); idx += kTcThreads) {
      const int r = idx / (kDH / 4), d = (idx % (kDH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (PV8) {
        int4 a8 = make_int4(0, 0, 0, 0);
        for (int w = 0; w < kTcWarps; ++w) {
          const int4 x = *reinterpret_cast<const int4*>(
              reinterpret_cast<const float*>(rings + w * kTcRing) + r * kTcOStride + d);
          a8.x += x.x, a8.y += x.y, a8.z += x.z, a8.w += x.w;
        }
        acc = make_float4(__fmul_rn(float(a8.x), va_s[d] / 127.f),
                          __fmul_rn(float(a8.y), va_s[d + 1] / 127.f),
                          __fmul_rn(float(a8.z), va_s[d + 2] / 127.f),
                          __fmul_rn(float(a8.w), va_s[d + 3] / 127.f));
      } else {
        for (int w = 0; w < kTcWarps; ++w) {
          const float4 x = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(rings + w * kTcRing) + r * kTcOStride + d);
          acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
        }
      }
      if (q0 + r >= n) continue;
      const size_t oi = (size_t(b) * n + q0 + r) * c + h * kDH + d;
      *reinterpret_cast<uint2*>(out + oi) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
    __syncthreads();   // the rings are free again
    if (mine && kPass1 && h + 1 < heads) stage(h + 1, 0, false);
  }

  if (has_cls)
    for (int k = tid; k < n; k += kTcThreads) cls[size_t(b) * n + k] = __float2bfloat16(cls_s[k] / heads);
  for (int i = tid; i < 16 * hs; i += kTcThreads) hm_s[i] = hm_s[i] / heads;
  __syncthreads();
  rollout_rows<16, kTcThreads, 4>(hm_s, hs, joint, newj, b, q0, n);
}

// headbatch on the tensor cores: a block of 4 warps owns 16 query rows; warp
// w takes heads w, w + 4, ... and walks every 16-key chunk of its head through
// its own two-stage ring (the function of full, no block barrier a head),
// adding P into its own [16, N] float32 tile; the tiles are summed in warp
// order after one block barrier.
__global__ void __launch_bounds__(32 * kHbWarps, 4)
attn_headbatch_tc_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bg,
                         const float* __restrict__ joint, bf16* __restrict__ out,
                         bf16* __restrict__ cls, float* __restrict__ newj, int n, int heads,
                         float scale) {
  using TC = Tc<bf16>;
  constexpr int kThreadsHb = 32 * kHbWarps;
  constexpr int kStage = 2 * TC::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = tc_keys(n), hs = tc_hm_stride(n);
  unsigned char* rings = smem_raw;                                     // [warps][kTcRing]
  float* km_s = reinterpret_cast<float*>(rings + kHbWarps * kTcRing);   // [nk]
  float* fg_s = km_s + nk;                                             // [16]
  float* part_s = fg_s + 16;                                           // [warps][16][hs]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * 16;
  const int c = heads * kDH, c3 = 3 * c;
  const bf16* qkv_b = qkv + size_t(b) * n * c3;
  bf16* ring = reinterpret_cast<bf16*>(rings + warp * kTcRing);
  float* part = part_s + warp * 16 * hs;
  const int n_chunks = nk / kTcChunk;

  for (int k = tid; k < nk; k += kThreadsHb) km_s[k] = k < n ? bg[size_t(b) * n + k] * -100.f : 0.f;
  for (int r = tid; r < 16; r += kThreadsHb)
    fg_s[r] = (q0 + r < n) ? 1.f - bg[size_t(b) * n + q0 + r] : 0.f;
  for (int i = tid; i < kHbWarps * 16 * hs; i += kThreadsHb) part_s[i] = 0.f;
  __syncthreads();
  const float fg[2] = {fg_s[g], fg_s[g + 8]};
  const bool row_ok[2] = {q0 + g < n, q0 + g + 8 < n};

  auto stage = [&](int h, int i, bool with_v) {
    const int k0 = i * kTcChunk;
    bf16* dst = ring + (i & 1) * kStage;
    const bf16* src = qkv_b + size_t(k0) * c3 + c + h * kDH;
    TC::stage(dst, src, c3, n - k0, lane);
    if (with_v) TC::stage(dst + TC::kChunk, src + c, c3, n - k0, lane);
    cp_async_commit();
  };
  auto logits = [&](float (&s)[1][2][4], const TC::QFrag (&qa)[1], const bf16* k_s, int k0) {
    TC::dots<1>(s, qa, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + nt * 8 + 2 * tg + (e & 1);
        float v = -INFINITY;
        if (k < n)
          v = fminf(__fadd_rn(__fmul_rn(s[0][nt][e], scale), __fmul_rn(fg[e >> 1], km_s[k])), 80.f);
        s[0][nt][e] = v;
      }
  };

  for (int h = warp; h < heads; h += kHbWarps) {
    TC::QFrag qa[1];
    TC::q_frags(qa[0], qkv_b + h * kDH, c3, q0, n, lane);
    stage(h, 0, false);
    float l[2] = {0.f, 0.f};
    for (int i = 0; i < n_chunks; ++i) {
      if (i + 1 < n_chunks) {
        stage(h, i + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float s[1][2][4];
      logits(s, qa, ring + (i & 1) * kStage, i * kTcChunk);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          l[hf] += exp_ftz(s[0][nt][2 * hf]) + exp_ftz(s[0][nt][2 * hf + 1]);
      __syncwarp();
    }
    stage(h, 0, true);
    const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      if (i + 1 < n_chunks) {
        stage(h, i + 1, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const bf16* k_s = ring + (i & 1) * kStage;
      const int k0 = i * kTcChunk;
      float s[1][2][4];
      logits(s, qa, k_s, k0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int k = k0 + nt * 8 + 2 * tg;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ftz(exp_ftz(s[0][nt][e]) * inv[e >> 1]);
          s[0][nt][e] = p[e];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (row_ok[hf]) {
            float2* h2 = reinterpret_cast<float2*>(part + (g + 8 * hf) * hs + k);
            *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
          }
      }
      unsigned pa[4];
      a_from_c(pa, s[0][0], s[0][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned vb[4];
        TC::v_frags(vb, k_s + TC::kChunk, j, 1.f, lane);
        mma16816(o[2 * j], pa, vb[0], vb[1]);
        mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();
    }
    // this warp saw every key of the head: O is complete in its registers
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row_ok[hf]) {
        bf16* orow = out + (size_t(b) * n + q0 + g + 8 * hf) * c + h * kDH + 2 * tg;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<unsigned*>(orow + j * 8) = pack_bf16(o[j][2 * hf], o[j][2 * hf + 1]);
      }
  }
  __syncthreads();

  // the head mean: the warps' tiles summed in warp order
  for (int i = tid; i < 16 * hs; i += kThreadsHb) {
    float sum = part_s[i];
    for (int w = 1; w < kHbWarps; ++w) sum += part_s[w * 16 * hs + i];
    part_s[i] = sum / heads;
  }
  __syncthreads();
  if (q0 == 0)
    for (int k = tid; k < n; k += kThreadsHb) cls[size_t(b) * n + k] = __float2bfloat16(part_s[k]);
  rollout_rows<16, kThreadsHb, 4>(part_s, hs, joint, newj, b, q0, n);
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

template <int SOFT, bool MASK, bool QK8, bool PV8>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kernel = attn_variant_tc_kernel<SOFT, MASK, QK8, PV8>;
  const size_t smem = tc_smem_bytes(a.n, QK8, PV8);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 15) / 16, a.batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), static_cast<bf16*>(a.out), static_cast<bf16*>(a.cls),
      static_cast<float*>(a.newj), a.n, a.heads, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_headbatch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = hb_smem_bytes(a.n);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      attn_headbatch_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 15) / 16, a.batch);
  attn_headbatch_tc_kernel<<<grid, 32 * kHbWarps, smem, stream>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), static_cast<bf16*>(a.out), static_cast<bf16*>(a.cls),
      static_cast<float*>(a.newj), a.n, a.heads, a.scale);
  return cudaGetLastError();
}

// design 0: the FMA design, float32 or bf16; design 1: the tensor-core
// design, bf16 (qkv 16-byte aligned)
template <bool QK8, bool PV8, int SOFT, bool MASK>
int launch_variant(const Args& a, int head_dim, int dtype, int design, void* stream) {
  if (bad(a, head_dim) || design < 0 || design > 1 || (design == 1 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) return launch_tc<SOFT, MASK, QK8, PV8>(a, s);
  switch (dtype) {
    case 0:
      return launch<float, QK8, PV8, SOFT, MASK>(a, s);
    case 1:
      return launch<__nv_bfloat16, QK8, PV8, SOFT, MASK>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry per variant.  qkv [batch, n, 3 * heads * 64] of dtype 0 = float32
// or 1 = bfloat16; bg [batch, n] float32; joint and newj [batch, n, n]
// float32; out [batch, n, heads * 64] and cls [batch, n] in qkv's type;
// design 0 = the FMA design, 1 = the tensor-core design (bfloat16).
// Returns a cudaError_t; 0 means the kernel was launched.
#define VITCAM_VARIANT(name, QK8, PV8, SOFT, MASK)                                        \
  int vitcam_attn_variant_##name(const void* qkv, const void* bg, const void* joint,      \
                                 void* out, void* cls, void* newj, int batch, int n,      \
                                 int heads, int head_dim, float scale, int dtype,         \
                                 int design, void* stream) {                              \
    const Args a{qkv, bg, joint, out, cls, newj, batch, n, heads, scale};                 \
    return launch_variant<QK8, PV8, SOFT, MASK>(a, head_dim, dtype, design, stream);      \
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
                                  int heads, int head_dim, float scale, int dtype, int design,
                                  void* stream) {
  const Args a{qkv, bg, joint, out, cls, newj, batch, n, heads, scale};
  if (bad(a, head_dim) || design < 0 || design > 1 || (design == 1 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) return launch_headbatch_tc(a, s);
  switch (dtype) {
    case 0:
      return launch_headbatch<float>(a, s);
    case 1:
      return launch_headbatch<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// shared memory a launch of `variant` needs (0..7: full, noexp, nomask,
// matmul_only, int8qk, int8pv, int8both, headbatch) at `heads` heads in
// `design`
size_t vitcam_attn_variant_smem_bytes(int n, int variant, int heads, int design) {
  const bool qk8 = variant == 4 || variant == 6, pv8 = variant == 5 || variant == 6;
  if (variant == 7) return design == 1 ? hb_smem_bytes(n) : headbatch_smem_bytes(n, heads);
  return design == 1 ? tc_smem_bytes(n, qk8, pv8) : smem_bytes(n, pv8);
}

}  // extern "C"
