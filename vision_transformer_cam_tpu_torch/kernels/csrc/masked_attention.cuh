// Fused masked multi-head attention with the CAM statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_kernel_fused, with its int8_io and int8_out options.  Per image and
// head, on the packed qkv [B, N, 3C] (heads contiguous inside q|k|v):
//
//   S   = Q K^T * scale + (1 - bg_q) * (mask_value * bg_k)   (rank-1 mask)
//   S   = min(S, 80)  (serving clamp)   or   S - rowmax(S)
//   P   = softmax(S);  O = P V  -> out[b, rows, h*dh:(h+1)*dh]
//   cls = mean_h P[0, :]                                      -> cls [B, N]
//   hm  = mean_h P            (with_headmean)                 -> hm [B, N, N]
//   J'  = (hm @ J + J) / 2    (rollout, f32, separate buffer) -> newj [B, N, N]
//
// int8_io (int8 qkv, the requantized qkv-GEMM output): S = dot * ((sq * sk) *
// scale) with the exact integer dot of q and k; V enters as (v * sv) rounded
// to bf16, and P is rounded to bf16 before P V, as the TPU kernel casts both.
// int8_out (float qkv) and int8_io store the output as int8 rint(O * inv_out)
// clipped to +-127 (round half to even, as jnp.round).  The scales live in a
// small device vector, [3H + 1] per head (sq_0.., sk_0.., sv_0.., inv_out),
// [4] per tensor, or [1] (inv_out), and are indexed per head at run time.
// cls and the head mean are float32 or bf16 (flags), whatever qkv's type.
//
// The head width dh is a template parameter, DH: 64 (ViT-S/B/L), 80 (ViT-H/14),
// and 16, 32 and 40 (the JAX quickstart's tiny ViT and the JAX kernel's fuzz
// widths) are compiled, each instantiated in its own translation unit
// (masked_attention.cu, masked_attention_w80.cu, masked_attention_w16.cu, ...,
// so that nvcc builds them in parallel); the C entry point dispatches on
// head_dim.  At 40 and 80 the FMA design's P V gives each thread (row, column)
// pairs (256 threads do not divide by the width; at 40 and 16 query rows the
// last pairs of a block are idle); at 40 the tensor-core design stages,
// multiplies and exchanges 48 columns, whose last 8 are zeros
// (attention_tc.cuh).  At 80 the tensor-core design stages rows of an odd
// number of 16-byte segments without a swizzle (bf16 176 bytes, int8 80), takes
// QK^T in five bf16 k16 steps (int8: two k32 steps and one m16n8k16.s8 step)
// and P V in ten n8 tiles, and at bf16 reads Q from shared memory (tc_q_bytes).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, B=64 N=257 H=16,
// bf16 rollout) the two-block bound of 128 registers spills 48 bytes with Q
// in registers (1.06 ms) and 32 with Q in shared memory (0.95 ms); one block
// an SM spills none and runs slower (scripts/w80_variants.py).
//
// What bounds it on this card.  At ViT-B/16 (N=197, C=768, H=12) and batch
// 64 one call reads the [B,N,3C] qkv (58 MB in bf16), writes the [B,N,C]
// output and, in the rollout variant, reads and writes the [B,N,N] f32 joint:
// about 97 MB, 0.029 ms at 3.35 TB/s.  Its products are 7.6 GFLOP for QK^T
// and PV (0.008 ms at the bf16 tensor-core peak) plus 1.0 GFLOP of float32
// for the rollout product (0.015 ms at the f32 peak): bound by bytes.
//
// Two designs.
//
// The FMA design (float32, and bf16 / int8 where it is asked for).  A block
// owns QB query rows of one image, QB = 32 or 16 (the wrapper's q_block: 32
// where the tiles fit the 227 KB a block may use, else 16, or the one the
// caller forces).  A whole key row of S ([QB, N] f32) fits in shared memory
// for N <= 780 at QB = 32 and for N <= 1536 at QB = 16 with the head mean or
// the rollout, so the softmax is exact in one pass.  K and V are staged per
// head in 64-key chunks, converted to float32 (int8 q and k as
// integer-valued floats: every partial sum of the dot is an integer below
// 80 * 127^2 < 2^24, so the f32 FMA loop gives the exact int32 dot), and
// both products are float32 FMAs on the CUDA cores, fed from shared memory
// with 16-byte loads.  The float32 instance stays on it: its gates need full
// float32 products.
//
// The tensor-core design (bf16 and int8 qkv, the serving and training paths';
// its tile code in attention_tc.cuh, shared with the split-tensor and the
// ablation kernels): the sequence-parallel kernel's tensor-core design on the
// packed qkv.  A block of 8 warps owns 16 query rows of one image (q_block 32:
// two m16 tiles that share every staged chunk; the same (q_block, N) pairs as
// the FMA design are taken), and S never sits in shared memory.  The warps take
// the 16-key chunks in turn, each staging its chunks of K and V with 16-byte
// cp.async copies into a private two-stage ring of swizzled tiles, so the key
// loops wait on no block barrier.  QK^T runs on mma.sync.m16n8k16 (bf16) or
// mma.sync.m16n8k32 (int8, the exact int32 dot); P V on m16n8k16, its V
// fragments built in registers from the int8 chunk under int8_io.  Per head two
// passes over the keys: the first forms each row's sum of exponentials (and its
// maximum without the clamp), the second forms P = E / den, adds it into the
// head mean and the cls row, and rounds it to bf16 in registers as the A
// fragment of P V.  The head mean, the one [QB, N] float32 state that crosses
// heads, lives in shared memory, each element owned by one thread: the sums run
// in a fixed order, no atomics, two launches and both q_block values give
// identical bits.  Exponentials and probabilities below 2^-126 are flushed to
// zero (a masked logit is s - 100, and exp(-100) is a denormal, on whose slow
// path exp and the division would otherwise run); the TPU flushes them too.
//
// Both designs write the cls row and the head mean or this tile's rows of the
// rollout update J' from the float32 head-mean tile (rollout_rows): the
// product reads the whole J[b], so the update is never in place.
//
// Numerics follow the TPU kernel: S, the softmax, the head mean, the cls row
// and the rollout product are f32; P (or the unnormalized exponentials when no
// head mean is needed) is rounded to V's element type (bf16 under int8_io)
// before P V, as the TPU kernel casts it for its matmul.  S's scale and mask
// terms are explicitly rounded (__fmul_rn / __fadd_rn), so no FMA contraction
// moves them away from the plain version.  The tensor-core design multiplies
// by 1 / den where the plain version divides, and sums P V in another order:
// an ulp apart.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#pragma once

#include <cmath>

#include "attention_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may ask for

enum Mode { kPlain = 0, kHeadmean = 1, kRollout = 2 };
// flags of the C entry point
enum Flags { kOutI8 = 1, kClsBf16 = 2, kHmBf16 = 4 };
// scales vector kinds
enum Scales { kNoScales = 0, kOutOnly = 1, kPerTensor = 2, kPerHead = 3 };

// V's element type, which P is rounded to before P V: bf16 under int8_io
template <typename T> struct PVType { using type = T; };
template <> struct PVType<int8_t> { using type = __nv_bfloat16; };

__device__ __forceinline__ void store_f(void* p, size_t i, float v, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

size_t smem_bytes(int n, int mode, int qb, int dh) {
  const size_t ns = padded(n);
  size_t floats = size_t(qb) * dh + size_t(kKC) * (dh + 4) + qb * ns;
  if (mode != kPlain) floats += qb * ns;
  floats += ns + n + 2 * qb;
  return floats * sizeof(float);
}

// query rows per block: the forced 16 or 32, or for 0 the larger one whose
// tiles fit; 0 when nothing fits (the launch then fails on its shared memory)
int pick_qb(int n, int mode, int q_block, int dh) {
  if (q_block) return q_block;
  if (smem_bytes(n, mode, 32, dh) <= kMaxSmem) return 32;
  if (smem_bytes(n, mode, 16, dh) <= kMaxSmem) return 16;
  return 0;
}

__device__ __forceinline__ int clip_i8(float t) {
  return static_cast<int>(fminf(fmaxf(t, -127.f), 127.f));
}

template <typename T, int MODE, bool CLAMP, int kQB, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                        const float* __restrict__ joint, void* __restrict__ out,
                        void* __restrict__ cls, void* __restrict__ hm_out,
                        float* __restrict__ newj, const float* __restrict__ scales,
                        int scales_kind, int n, int heads, float scale, float mask_value,
                        int flags) {
  constexpr bool kInt8In = sizeof(T) == 1;
  using PV = typename PVType<T>::type;
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  constexpr int kStride = kKVStrideOf<DH>;
  float* q_s = smem;                                  // [kQB][DH]
  float* kv_s = q_s + kQB * DH;                       // [kKC][kStride]
  float* s_s = kv_s + kKC * kStride;                  // [kQB][ns]
  float* hm_s = s_s + kQB * ns;                       // [kQB][ns], not in kPlain
  float* cls_s = hm_s + (MODE != kPlain ? kQB * ns : 0);  // [ns]
  float* km_s = cls_s + ns;                           // [n] key mask
  float* fg_s = km_s + n;                             // [kQB] 1 - bg_q
  float* den_s = fg_s + kQB;                          // [kQB] softmax sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const int c = heads * DH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;
  const bool out_i8 = kInt8In || (flags & kOutI8);
  const bool cls_bf16 = flags & kClsBf16, hm_bf16 = flags & kHmBf16;
  const float inv_out = scales_kind == kPerHead     ? scales[3 * heads]
                        : scales_kind == kPerTensor ? scales[3]
                        : scales_kind == kOutOnly   ? scales[0]
                                                    : 1.f;

  for (int k = tid; k < n; k += kThreads) km_s[k] = bg_b[k] * mask_value;
  for (int r = tid; r < kQB; r += kThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  for (int k = tid; k < ns; k += kThreads) cls_s[k] = 0.f;
  if (MODE != kPlain)
    for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    // int8 qkv: S's scale (sq * sk) * scale and V's dequantization scale
    float s_scale = scale;
    const float* v_scale = nullptr;
    if (kInt8In) {
      const bool ph = scales_kind == kPerHead;
      s_scale = __fmul_rn(__fmul_rn(scales[ph ? h : 0], scales[ph ? heads + h : 1]), scale);
      v_scale = scales + (ph ? 2 * heads + h : 2);
    }
    for (int i = tid; i < kQB * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      q_s[i] = (q0 + r < n) ? to_f(qkv_b[size_t(q0 + r) * c3 + h * DH + d]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, kQB/4 query rows.
    {
      constexpr int kRows = kQB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, qkv_b, k0, n, c3, c + h * DH);
        __syncthreads();
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kStride);
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kv = k4[d4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qv =
                reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * DH)[d4];
            acc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
        const int k = k0 + kj;
        if (k < n) {
          const float km = km_s[k];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            float s = __fadd_rn(__fmul_rn(acc[i], s_scale), __fmul_rn(fg_s[r], km));
            if (CLAMP) s = fminf(s, 80.f);
            s_s[r * ns + k] = s;
          }
        }
      }
      __syncthreads();
    }

    // Softmax, one warp per row.  Accumulates the normalized P into the head
    // mean and the cls row; leaves in s_s what P.V consumes.
    for (int r = warp; r < kQB; r += kThreads / 32) {
      float* row = s_s + r * ns;
      float m = 0.f;   // the clamp replaces the row-max subtraction
      if (!CLAMP) {
        m = -INFINITY;
        for (int k = lane; k < n; k += 32) m = fmaxf(m, row[k]);
        m = warp_max(m);
      }
      float sum = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float e = expf(row[k] - m);
        row[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const bool hm_row = MODE != kPlain && q0 + r < n;
      const bool cls_row = has_cls && r == 0;
      for (int k = lane; k < ns; k += 32) {
        if (k >= n) {
          row[k] = 0.f;
          continue;
        }
        const float e = row[k], p = e / sum;
        if (hm_row) hm_s[r * ns + k] += p;
        if (cls_row) cls_s[k] += p;
        row[k] = round_to<PV>(MODE != kPlain ? p : e);
      }
      if (lane == 0) den_s[r] = sum;
    }

    // O = P V, one V chunk at a time.  Where the threads divide by DH (16, 32,
    // 64): thread = one column d, kQB * DH / kThreads rows.  Else (40, 80):
    // ceil(kQB * DH / kThreads) (row, column) pairs, pair i at index tid + i *
    // kThreads of the [kQB][DH] tile (at 40 and kQB = 16 the pairs past the
    // tile are skipped).  The two branches store alike, written out in each:
    // the row computed from the pair index, or a shared lambda, moved ptxas's
    // register choice for some width-64 instances (chip_smoke.py, B=64 N=197:
    // the bf16 head-mean FMA instance at 1.36 ms against 1.19).
    if constexpr (kThreads % DH == 0) {
      constexpr int kRows = kQB * DH / kThreads, kStep = kThreads / DH;
      const int d = tid % DH, rg = tid / DH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, qkv_b, k0, n, c3, 2 * c + h * DH, v_scale);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
          const float v0 = kv_s[(j + 0) * kStride + d];
          const float v1 = kv_s[(j + 1) * kStride + d];
          const float v2 = kv_s[(j + 2) * kStride + d];
          const float v3 = kv_s[(j + 3) * kStride + d];
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
        if (q0 + r < n) {
          const float o = MODE != kPlain ? acc[i] : acc[i] / den_s[r];
          const size_t oi = (size_t(b) * n + q0 + r) * c + h * DH + d;
          if (out_i8) {
            const float t = rintf(__fmul_rn(o, inv_out));
            static_cast<int8_t*>(out)[oi] = static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
          } else if constexpr (!kInt8In) {
            static_cast<T*>(out)[oi] = from_f<T>(o);
          }
        }
      }
    } else {
      constexpr int kPairs = kQB * DH, kRows = (kPairs + kThreads - 1) / kThreads;
      constexpr bool kWholeP = kPairs % kThreads == 0;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, qkv_b, k0, n, c3, 2 * c + h * DH, v_scale);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int idx = tid + i * kThreads, r = idx / DH, d = idx % DH;
            if (!kWholeP && idx >= kPairs) break;
            const float4 p = *reinterpret_cast<const float4*>(s_s + r * ns + k0 + j);
            acc[i] += p.x * kv_s[(j + 0) * kStride + d] + p.y * kv_s[(j + 1) * kStride + d] +
                      p.z * kv_s[(j + 2) * kStride + d] + p.w * kv_s[(j + 3) * kStride + d];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int idx = tid + i * kThreads, r = idx / DH, d = idx % DH;
        if (!kWholeP && idx >= kPairs) break;
        if (q0 + r < n) {
          const float o = MODE != kPlain ? acc[i] : acc[i] / den_s[r];
          const size_t oi = (size_t(b) * n + q0 + r) * c + h * DH + d;
          if (out_i8) {
            const float t = rintf(__fmul_rn(o, inv_out));
            static_cast<int8_t*>(out)[oi] = static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
          } else if constexpr (!kInt8In) {
            static_cast<T*>(out)[oi] = from_f<T>(o);
          }
        }
      }
    }
    __syncthreads();   // s_s, den_s and kv_s are reused by the next head
  }

  if (has_cls)
    for (int k = tid; k < n; k += kThreads)
      store_f(cls, size_t(b) * n + k, cls_s[k] / heads, cls_bf16);
  if constexpr (MODE != kPlain) {
    for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = hm_s[i] / heads;
    __syncthreads();

    if constexpr (MODE == kHeadmean) {
      for (int i = tid; i < kQB * n; i += kThreads) {
        const int r = i / n, k = i % n;
        if (q0 + r >= n) break;
        const size_t idx = (size_t(b) * n + q0 + r) * n + k;
        store_f(hm_out, idx, hm_s[r * ns + k], hm_bf16);
      }
    } else {
      rollout_rows<kQB, kThreads, 1>(hm_s, ns, joint, newj, b, q0, n);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core design (bf16 and int8 qkv)
// ---------------------------------------------------------------------------

// bf16 at a head width other than 64 keeps the head's Q tile in shared memory
// (these bytes) and reads its A fragments per chunk, instead of holding them
// in registers: at 80 the 20 registers of Q a thread pushed the two-block
// bound of 128 registers into 48 bytes of spills (32 with Q in shared
// memory, and 11 % less time)
__host__ __device__ constexpr int tc_q_bytes(int elem_bytes, int mt, int dh) {
  return elem_bytes == 2 && dh != 64 ? 16 * mt * tc_pitch(2, dh) * 2 : 0;
}

size_t tc_smem_bytes(int n, int mode, int mt, int elem_bytes, int dh) {
  const int qb = 16 * mt;
  size_t floats = size_t(2) * tc_keys(n)             // key mask, cls sums
                  + size_t(kTcWarps) * qb * 2        // row statistics of each warp
                  + 2 * qb;                          // 1 - bg_q, den
  if (mode != kPlain) floats += size_t(qb) * tc_hm_stride(n);
  return size_t(kTcWarps) * tc_ring_bytes(elem_bytes, mt, dh) + floats * sizeof(float) +
         tc_q_bytes(elem_bytes, mt, dh);
}

// A block owns QB = 16 * MT query rows of one image (MT m16 tiles); its 8
// warps take the 16-key chunks in turn (warp w: chunks w, w + 8, ...), each
// staging its own chunks of K and V in a private two-stage ring, so the key
// loops wait on no block barrier; a staged chunk feeds all MT tiles.  Per
// head: pass 1 forms each row's softmax sum (and maximum without the clamp),
// the warps' partials meet in shared memory; pass 2 forms P, adds it into
// the head mean and the cls row (each element owned by one thread: a fixed
// order of sums, no atomics) and feeds it, rounded to bf16, to P V; the
// warps' partial O tiles are summed in shared memory.  After the heads the
// block writes the cls row, the head mean, or its rows of the rollout update.
// One m16 tile leaves room for two blocks an SM (at most 128 registers a
// thread); two hold their fragments in up to 255.  At head width 80 a
// thread holds 10 n8 tiles of O (40 floats) a tile, and a warp's ring is 11
// KB (bf16: rows of 176 bytes); bf16 reads Q from a [QB][88] tile in shared
// memory (tc_q_bytes), so one m16 tile at N = 257 takes 113 KB and two
// blocks still share an SM.  At 16, 32 and 40 a thread holds 2, 4 and 6 n8
// tiles (at 40 the sixth is the zero pad, kept so that P V runs in pairs of
// n8 tiles from one ldmatrix), and Q is in shared memory as at 80.
template <typename T, int MODE, bool CLAMP, int MT, int DH>
__global__ void __launch_bounds__(kTcThreads, MT == 1 ? 2 : 1)
masked_attention_tc_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                           const float* __restrict__ joint, void* __restrict__ out,
                           void* __restrict__ cls, void* __restrict__ hm_out,
                           float* __restrict__ newj, const float* __restrict__ scales,
                           int scales_kind, int n, int heads, float scale, float mask_value,
                           int flags) {
  using TC = Tc<T, DH>;
  constexpr bool kInt8In = sizeof(T) == 1;
  constexpr int QB = 16 * MT;
  constexpr int kRing = tc_ring_bytes(sizeof(T), MT, DH);
  constexpr int kOStride = kTcOStrideOf<DH>;
  constexpr int kNT = tc_width(DH) / 8;             // n8 tiles of O (zero past DH)
  constexpr int kStage = 2 * TC::kChunk;            // elements of one (K, V) stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = tc_keys(n), hs = tc_hm_stride(n);
  unsigned char* rings = smem_raw;                                       // [warps][kRing]
  float* km_s = reinterpret_cast<float*>(rings + kTcWarps * kRing);      // [nk]
  float* cls_s = km_s + nk;                                              // [nk]
  float* st_s = cls_s + nk;                          // [warps][QB][2]: max, sum
  float* fg_s = st_s + kTcWarps * QB * 2;            // [QB]
  float* den_s = fg_s + QB;                          // [QB]
  float* hm_s = den_s + QB;                          // [QB][hs], not in kPlain
  // bf16 past head width 64: the head's Q tile, [QB][BfTile<DH>::kPitch]
  constexpr bool kQs = tc_q_bytes(sizeof(T), MT, DH) != 0;
  bf16* q_s = reinterpret_cast<bf16*>(hm_s + (MODE != kPlain ? QB * hs : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const int c = heads * DH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const bool has_cls = q0 == 0;
  const bool out_i8 = kInt8In || (flags & kOutI8);
  const float inv_out = scales_kind == kPerHead     ? scales[3 * heads]
                        : scales_kind == kPerTensor ? scales[3]
                        : scales_kind == kOutOnly   ? scales[0]
                                                    : 1.f;
  T* ring = reinterpret_cast<T*>(rings + warp * kRing);
  const int n_chunks = nk / kTcChunk;
  const int mine = warp < n_chunks ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;

  for (int k = tid; k < nk; k += kTcThreads) {
    km_s[k] = k < n ? bg[size_t(b) * n + k] * mask_value : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < QB; r += kTcThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg[size_t(b) * n + q0 + r] : 0.f;
  if (MODE != kPlain)
    for (int i = tid; i < QB * hs; i += kTcThreads) hm_s[i] = 0.f;
  // head h's Q rows into q_s (rows and columns past n and DH zero), 16
  // bytes a thread
  auto stage_q = [&](int h) {
    constexpr int kSegs = BfTile<DH>::kWidth / 8;
    for (int i = tid; i < QB * kSegs; i += kTcThreads) {
      const int r = i / kSegs, sg = i % kSegs;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < n && (BfTile<DH>::kWidth == DH || sg < DH / 8))
        v = __ldg(reinterpret_cast<const uint4*>(qkv_b + size_t(q0 + r) * c3 + h * DH + sg * 8));
      *reinterpret_cast<uint4*>(q_s + BfTile<DH>::at(r, sg * 8)) = v;
    }
  };
  if constexpr (kQs) stage_q(0);
  __syncthreads();
  float fg[MT][2];
  bool row_ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fg[mt][0] = fg_s[mt * 16 + g];
    fg[mt][1] = fg_s[mt * 16 + g + 8];
    row_ok[mt][0] = q0 + mt * 16 + g < n;
    row_ok[mt][1] = q0 + mt * 16 + g + 8 < n;
  }

  // stage chunk i of this warp (K, and V with with_v) into stage i % 2
  auto stage = [&](int h, int i, bool with_v) {
    const int k0 = (warp + i * kTcWarps) * kTcChunk;
    T* dst = ring + (i & 1) * kStage;
    const T* src = qkv_b + size_t(k0) * c3 + c + h * DH;
    TC::stage(dst, src, c3, n - k0, lane);
    if (with_v) TC::stage(dst + TC::kChunk, src + c, c3, n - k0, lane);
    cp_async_commit();
  };
  // S of one chunk: scaled, masked, clamped; -inf on keys >= n
  auto logits = [&](float (&s)[MT][2][4], const typename TC::QFrag (&qa)[MT], const T* k_s,
                    int k0, float s_scale) {
    if constexpr (kQs) TC::template dots_smem<MT>(s, q_s, k_s, lane);
    else TC::template dots<MT>(s, qa, k_s, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + nt * 8 + 2 * tg + (e & 1);
          float v = -INFINITY;
          if (k < n) {
            v = __fadd_rn(__fmul_rn(s[mt][nt][e], s_scale), __fmul_rn(fg[mt][e >> 1], km_s[k]));
            if (CLAMP) v = fminf(v, 80.f);
          }
          s[mt][nt][e] = v;
        }
  };

  if (mine) stage(0, 0, false);
  for (int h = 0; h < heads; ++h) {
    // int8 qkv: S's scale (sq * sk) * scale and V's dequantization scale
    float s_scale = scale, sv = 1.f;
    if (kInt8In) {
      const bool ph = scales_kind == kPerHead;
      s_scale = __fmul_rn(__fmul_rn(scales[ph ? h : 0], scales[ph ? heads + h : 1]), scale);
      sv = scales[ph ? 2 * heads + h : 2];
    }
    typename TC::QFrag qa[MT];
    if constexpr (!kQs) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) TC::q_frags(qa[mt], qkv_b + h * DH, c3, q0 + mt * 16, n, lane);
    }

    // pass 1: per row the maximum (without the clamp) and the sum of exp
    float m[MT][2], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m[mt][0] = m[mt][1] = CLAMP ? 0.f : -INFINITY;
      l[mt][0] = l[mt][1] = 0.f;
    }
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float s[MT][2][4];
      logits(s, qa, ring + (i & 1) * kStage, (warp + i * kTcWarps) * kTcChunk, s_scale);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!CLAMP) {
            const float nm = fmaxf(m[mt][hf],
                                   quad_max(fmaxf(fmaxf(s[mt][0][2 * hf], s[mt][0][2 * hf + 1]),
                                                  fmaxf(s[mt][1][2 * hf], s[mt][1][2 * hf + 1]))));
            l[mt][hf] = nm == m[mt][hf] ? l[mt][hf] : l[mt][hf] * exp_ftz(m[mt][hf] - nm);
            m[mt][hf] = nm;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            l[mt][hf] += exp_ftz(s[mt][nt][2 * hf] - m[mt][hf]) +
                         exp_ftz(s[mt][nt][2 * hf + 1] - m[mt][hf]);
        }
      __syncwarp();   // this stage is read before the chunk after next lands in it
    }
    if (mine) stage(h, 0, true);   // pass 2's first chunk loads across the barrier
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float lsum = quad_sum(l[mt][hf]);
        if (tg == 0) {
          float* st = st_s + (warp * QB + mt * 16 + g + 8 * hf) * 2;
          st[0] = m[mt][hf];
          st[1] = lsum;
        }
      }
    __syncthreads();
    // every thread combines the warps' partials of its rows, in one order
    float mx[MT][2], inv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        float mr = CLAMP ? 0.f : -INFINITY, den = 0.f;
        if (!CLAMP)
          for (int w = 0; w < kTcWarps; ++w) mr = fmaxf(mr, st_s[(w * QB + r) * 2]);
        for (int w = 0; w < kTcWarps; ++w) {
          const float* st = st_s + (w * QB + r) * 2;
          den += CLAMP || st[0] == mr ? st[1] : st[1] * exp_ftz(st[0] - mr);
        }
        mx[mt][hf] = mr;
        inv[mt][hf] = 1.f / den;
        if (warp == 0 && tg == 0) den_s[r] = den;
      }

    // pass 2: P, the head mean and the cls row, O = P V
    float o[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const T* k_s = ring + (i & 1) * kStage;
      const int k0 = (warp + i * kTcWarps) * kTcChunk;
      float s[MT][2][4];
      logits(s, qa, k_s, k0, s_scale);
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int k = k0 + nt * 8 + 2 * tg;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = exp_ftz(s[mt][nt][e] - mx[mt][e >> 1]);
            p[e] = ftz(ex * inv[mt][e >> 1]);
            s[mt][nt][e] = MODE != kPlain ? p[e] : ex;
          }
          if (MODE != kPlain) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              if (row_ok[mt][hf]) {
                float2* h2 = reinterpret_cast<float2*>(hm_s + (mt * 16 + g + 8 * hf) * hs + k);
                *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
              }
          }
          if (has_cls && mt == 0 && g == 0) {
            cls_s[k] += p[0];
            cls_s[k + 1] += p[1];
          }
        }
        a_from_c(pa[mt], s[mt][0], s[mt][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        unsigned vb[4];
        TC::v_frags(vb, k_s + TC::kChunk, j, sv, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o[mt][2 * j], pa[mt], vb[0], vb[1]);
          mma16816(o[mt][2 * j + 1], pa[mt], vb[2], vb[3]);
        }
      }
      __syncwarp();
    }

    // the warps' partial O tiles meet in their own rings, summed in one order
    float* ox = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(ox + (mt * 16 + g) * kOStride + j * 8 + 2 * tg) =
            make_float2(o[mt][j][0], o[mt][j][1]);
        *reinterpret_cast<float2*>(ox + (mt * 16 + g + 8) * kOStride + j * 8 + 2 * tg) =
            make_float2(o[mt][j][2], o[mt][j][3]);
      }
    __syncthreads();
    // every warp is past this head's products: the next head's Q may land
    if constexpr (kQs)
      if (h + 1 < heads) stage_q(h + 1);
    for (int idx = tid; idx < QB * (DH / 4); idx += kTcThreads) {
      const int r = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kTcWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(rings + w * kRing) + r * kOStride + d);
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      if (q0 + r >= n) continue;
      if (MODE == kPlain) {
        const float den = den_s[r];
        acc.x /= den, acc.y /= den, acc.z /= den, acc.w /= den;
      }
      const size_t oi = (size_t(b) * n + q0 + r) * c + h * DH + d;
      if (out_i8) {
        auto q8 = [&](float v) { return clip_i8(rintf(__fmul_rn(v, inv_out))); };
        *reinterpret_cast<unsigned*>(static_cast<int8_t*>(out) + oi) =
            (q8(acc.x) & 0xffu) | ((q8(acc.y) & 0xffu) << 8) | ((q8(acc.z) & 0xffu) << 16) |
            (unsigned(q8(acc.w)) << 24);
      } else if constexpr (!kInt8In) {
        *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + oi) =
            make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
      }
    }
    __syncthreads();   // the rings are free again
    if (mine && h + 1 < heads) stage(h + 1, 0, false);
  }

  if (has_cls)
    for (int k = tid; k < n; k += kTcThreads)
      store_f(cls, size_t(b) * n + k, cls_s[k] / heads, flags & kClsBf16);
  if constexpr (MODE != kPlain) {
    for (int i = tid; i < QB * hs; i += kTcThreads) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    if constexpr (MODE == kHeadmean) {
      const bool hm_bf16 = flags & kHmBf16;
      for (int i = tid; i < QB * n; i += kTcThreads) {
        const int r = i / n, k = i % n;
        if (q0 + r >= n) break;
        store_f(hm_out, (size_t(b) * n + q0 + r) * n + k, hm_s[r * hs + k], hm_bf16);
      }
    } else {
      rollout_rows<QB, kTcThreads, 4>(hm_s, hs, joint, newj, b, q0, n);
    }
  }
}

// the launch arguments every instance shares
struct Args {
  const void *qkv, *bg, *joint;
  void *out, *cls, *hm, *newj;
  const float* scales;
  int scales_kind, batch, n, heads;
  float scale, mask_value;
  int flags, q_block;
};

template <typename T, int MODE, bool CLAMP, int kQB, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = a.n;
  auto kernel = masked_attention_kernel<T, MODE, CLAMP, kQB, DH>;
  const size_t smem = smem_bytes(n, MODE, kQB, DH);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQB - 1) / kQB, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), a.out, a.cls, a.hm, static_cast<float*>(a.newj),
      a.scales, a.scales_kind, n, a.heads, a.scale, a.mask_value, a.flags);
  return cudaGetLastError();
}

template <typename T, int MODE, bool CLAMP, int MT, int DH>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_tc_kernel<T, MODE, CLAMP, MT, DH>;
  const size_t smem = tc_smem_bytes(a.n, MODE, MT, sizeof(T), DH);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 16 * MT - 1) / (16 * MT), a.batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), a.out, a.cls, a.hm, static_cast<float*>(a.newj),
      a.scales, a.scales_kind, a.n, a.heads, a.scale, a.mask_value, a.flags);
  return cudaGetLastError();
}

// The tensor-core design takes the q_block contract of the FMA design, so
// that a configuration runs on either: 32 query rows (two m16 tiles) where
// the FMA design's [32, N] tiles fit, 16 (one) otherwise; auto takes 16, the
// tile that lets two blocks share an SM.
template <typename T, int MODE, bool CLAMP, int DH>
cudaError_t launch_qb(int design, const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) != sizeof(float)) {
    if (design == 1) {
      if (a.q_block != 32) return launch_tc<T, MODE, CLAMP, 1, DH>(a, stream);
      if (smem_bytes(a.n, MODE, 32, DH) > kMaxSmem) return cudaErrorInvalidConfiguration;
      return launch_tc<T, MODE, CLAMP, 2, DH>(a, stream);
    }
  }
  switch (pick_qb(a.n, MODE, a.q_block, DH)) {
    case 32:
      return launch<T, MODE, CLAMP, 32, DH>(a, stream);
    case 16:
      return launch<T, MODE, CLAMP, 16, DH>(a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T, int MODE, int DH>
cudaError_t launch_clamp(int clamp, int design, const Args& a, cudaStream_t stream) {
  return clamp ? launch_qb<T, MODE, true, DH>(design, a, stream)
               : launch_qb<T, MODE, false, DH>(design, a, stream);
}

template <typename T, int DH>
cudaError_t launch_mode(int mode, int clamp, int design, const Args& a, cudaStream_t stream) {
  switch (mode) {
    case kPlain:
      return launch_clamp<T, kPlain, DH>(clamp, design, a, stream);
    case kHeadmean:
      return launch_clamp<T, kHeadmean, DH>(clamp, design, a, stream);
    case kRollout:
      return launch_clamp<T, kRollout, DH>(clamp, design, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The C entry point's work at head width DH (its arguments documented there).
template <int DH>
int fused_entry(const void* qkv, const void* bg, const void* joint, void* out, void* cls,
                void* hm, void* newj, const void* scales, int scales_kind, int batch, int n,
                int heads, float scale, float mask_value, int dtype, int mode, int clamp,
                int flags, int q_block, int design, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || heads < 1 ||
      (q_block != 0 && q_block != 16 && q_block != 32) || design < 0 || design > 1 ||
      (design == 1 && dtype == 0))
    return cudaErrorInvalidValue;
  const bool int8_in = dtype == 2;
  if (scales_kind < 0 || scales_kind > 3 || (scales_kind != kNoScales) != (scales != nullptr))
    return cudaErrorInvalidValue;
  if (int8_in != (scales_kind == kPerTensor || scales_kind == kPerHead))
    return cudaErrorInvalidValue;
  if (!int8_in && ((flags & kOutI8) != 0) != (scales_kind == kOutOnly))
    return cudaErrorInvalidValue;
  const Args a{qkv, bg, joint, out, cls, hm, newj, static_cast<const float*>(scales),
               scales_kind, batch, n, heads, scale, mask_value, flags, q_block};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_mode<float, DH>(mode, clamp, design, a, s);
    case 1:
      return launch_mode<__nv_bfloat16, DH>(mode, clamp, design, a, s);
    case 2:
      return launch_mode<int8_t, DH>(mode, clamp, design, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The occupancy of the tensor-core instance (dtype 1 = bf16, 2 = int8; one
// m16 tile, clamp on) or of the FMA instance (dtype 0, 1 or 2; the q_block
// auto picks) that a launch at N takes: info[0] blocks an SM at once,
// info[1] registers a thread, info[2] local memory a thread (spills),
// info[3] shared memory a block.
template <typename T, int MODE, int DH>
cudaError_t occupancy_of(int design, int n, int* info) {
  const void* kernel = nullptr;
  size_t smem = 0;
  int threads = 0;
  if (design == 1) {
    if constexpr (sizeof(T) != sizeof(float)) {
      kernel = reinterpret_cast<const void*>(masked_attention_tc_kernel<T, MODE, true, 1, DH>);
      smem = tc_smem_bytes(n, MODE, 1, sizeof(T), DH);
      threads = kTcThreads;
    }
  } else {
    const int qb = pick_qb(n, MODE, 0, DH);
    if (qb == 0) return cudaErrorInvalidConfiguration;
    kernel = qb == 32 ? reinterpret_cast<const void*>(masked_attention_kernel<T, MODE, true, 32, DH>)
                      : reinterpret_cast<const void*>(masked_attention_kernel<T, MODE, true, 16, DH>);
    smem = smem_bytes(n, MODE, qb, DH);
    threads = kThreads;
  }
  if (kernel == nullptr || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, threads, smem);
  info[1] = fa.numRegs;
  info[2] = int(fa.localSizeBytes);
  info[3] = int(smem);
  return err;
}

template <int DH>
int occupancy_entry(int n, int mode, int dtype, int design, int* info) {
  if (n < 1 || design < 0 || design > 1 || (design == 1 && dtype == 0)) return cudaErrorInvalidValue;
  auto by_mode = [&](auto tag) -> cudaError_t {
    using T = decltype(tag);
    switch (mode) {
      case kPlain:
        return occupancy_of<T, kPlain, DH>(design, n, info);
      case kHeadmean:
        return occupancy_of<T, kHeadmean, DH>(design, n, info);
      case kRollout:
        return occupancy_of<T, kRollout, DH>(design, n, info);
      default:
        return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case 0:
      return by_mode(float{});
    case 1:
      return by_mode(__nv_bfloat16{});
    case 2:
      return by_mode(int8_t{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
