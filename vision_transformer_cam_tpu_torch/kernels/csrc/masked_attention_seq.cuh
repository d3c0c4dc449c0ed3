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
//   O    = P V  -> out[b, rows, h*dh:(h+1)*dh]
//   row0 = mean_h P[local row 0, :]                          -> row0 [B, Np]
//   hm   = mean_h P                   (with the head mean)   -> hm [B, NQ, Np]
//
// row0 is the cls row only on the rank that holds global row 0; the caller
// takes it from there.  Padded query rows (global row >= n_real on the last
// rank) carry zeros and bg 0: they attend to the real keys like any row, give
// finite values and are sliced off by the caller.
//
// The head width dh is a template parameter, DH: 64 (ViT-S/B/L), 80
// (ViT-H/14), and 16, 32 and 40 (the JAX quickstart's tiny ViT and the JAX
// kernel's fuzz widths), the widths kernel 1 takes, each instantiated in its
// own translation unit (masked_attention_seq.cu, masked_attention_seq_w80.cu,
// ..._w16.cu, ..._w32.cu, ..._w40.cu, so that nvcc builds them in parallel);
// the C entry point in masked_attention_seq.cu dispatches on head_dim.
//
// What bounds it on this card.  At ViT-L/16@384 (B=16, N=577, C=1024, 16
// heads) on one rank a call reads q, K | V and the two bg rows and writes
// out, row0 and the float32 head mean: 97.0 MB, 0.029 ms at 3.35 TB/s.  Its
// two products are 21.8 GFLOP, 0.022 ms at the bf16 tensor-core peak.  So
// bytes and products bound it about alike; the head mean alone is 21 MB.
//
// Two designs.
//
// The FMA design (float32, and bf16 where it is asked for): that of
// masked_attention.cuh with the query and the key / value tensors addressed
// apart (row strides C and 2C).  A block owns QB query rows of one image
// across all heads and keeps a whole float32 key row of S in shared memory,
// so the softmax is exact in one pass (row0 and hm need the normalised P).
// QB is 32 where the [QB, Np] tiles fit the 227 KB a block may use, and 16
// past that: with the head mean the S tile and the hm tile are both [QB, Np]
// float32, which at QB = 16 hold Np <= 1548 at head width 64 and 1512 at
// 80 (smem_bytes).  K and V are staged per head in 64-key chunks, converted
// to float32; both products are float32 FMAs on the CUDA cores.  Where the
// 256 threads divide by the width (16, 32, 64) a thread of P V owns one
// column; at 40 and 80 it owns (row, column) pairs of the [QB, DH] tile, as
// kernel 1's FMA design does.  The float32 instance stays on it: its gates
// need full float32 products.
//
// The tensor-core design (bf16, the serving path's): a block of 8 warps owns
// 16 query rows of one image (37 x 16 = 592 blocks at B=16, N=577; 160 on a
// shard of four), and S never sits in shared memory.  The warps take the
// 16-key chunks of the gathered keys in turn, each staging its chunks of K
// (and V) as bf16 with 16-byte cp.async copies into a private two-stage
// ring: no conversion pass, and the key loops wait on no block barrier.
// QK^T and P V run on mma.sync.m16n8k16 (bf16 in, float32 sums), S one
// chunk at a time in registers.  Per head two passes over the keys: the
// first forms each row's sum of exponentials (and its maximum without the
// clamp), the second forms P = E / den, adds it into the head mean and row
// 0, and rounds it to bf16 in registers as the A fragment of P V.  The warps
// meet three times a head in shared memory: for the row sums, for their
// partial O tiles, and before the rings are reused.  The head mean, the one
// [16, Np] float32 state that crosses heads, lives in shared memory, each
// element owned by one thread: the sums run in a fixed order, no atomics,
// and two launches give identical bits.  Exponentials and probabilities
// below 2^-126 are flushed to zero (a masked logit is s - 100, and exp(-100)
// is a denormal, on whose slow path exp and the division would otherwise
// run); the TPU flushes them too.  The tile code is kernel 1's
// (attention_tc.cuh, Tc<bf16, DH>): at 64 swizzled [16][64] chunks and Q in
// registers; at the other widths rows of an odd number of 16-byte segments
// and Q read from a [16][pitch] tile in shared memory (seq_q_bytes), as
// kernel 1 at 80 does; 40 is staged and multiplied as 48 zero-padded
// columns, whose extra n8 tile of P V is never stored.  With the head mean
// the [16, Np] tile and the rings take 108 KB at width 64 and Np = 580, and
// 113 KB at width 80 and Np = 257 (ViT-H/14 on one rank): two blocks share
// an SM; at 80 and Np = 580, 135 KB, one.
//
// Numerics follow the TPU kernel: S, the softmax and the means are float32;
// with the head mean P is normalised and then rounded to V's element type for
// P V; without it the unnormalised exponentials are rounded and O is divided
// by den afterwards.  S's scale, mask and kill terms are rounded one by one
// (__fmul_rn / __fadd_rn), so no FMA contraction moves them away from the
// plain version.  The tensor-core design multiplies by 1 / den where the
// plain version divides, and combines the warps' row sums in another order:
// an ulp apart.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#pragma once

#include <cmath>

#include "attention_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may ask for
constexpr int kHmBf16 = 1;            // flag: hm is bf16, else float32

__device__ __forceinline__ void store_f(void* p, size_t i, float v, bool as_bf16) {
  if (as_bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

size_t smem_bytes(int np, int with_hm, int qb, int dh) {
  const size_t ns = padded(np);
  size_t floats = size_t(qb) * dh + size_t(kKC) * (dh + 4) + qb * ns;
  if (with_hm) floats += qb * ns;
  floats += ns + np + 2 * qb;
  return floats * sizeof(float);
}

// query rows per block: 32 where the tiles fit, else 16, else 0 (too long)
int pick_qb(int np, int with_hm, int dh) {
  if (smem_bytes(np, with_hm, 32, dh) <= kMaxSmem) return 32;
  if (smem_bytes(np, with_hm, 16, dh) <= kMaxSmem) return 16;
  return 0;
}

// One block per SM is the target the compiler is given: with the head mean the
// two [QB, Np] tiles leave room for one block of 8 warps anyway, and with that
// hint ptxas spends 123 registers a thread on the two product loops where it
// would otherwise stop at 64 (6.28 -> 4.49 ms at B=16, N=577, bf16, on an
// NVIDIA H100 80GB HBM3 at 700 W).
template <typename T, int QB, bool HM, bool CLAMP, int DH>
__global__ void __launch_bounds__(kThreads, 1)
masked_attention_seq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                            const float* __restrict__ bg_q, const float* __restrict__ bg_k,
                            T* __restrict__ out, T* __restrict__ row0,
                            void* __restrict__ hm_out, int nq, int np, int n_real, int heads,
                            float scale, float mask_value, int flags) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(np);
  constexpr int kStride = kKVStrideOf<DH>;
  float* q_s = smem;                                  // [QB][DH]
  float* kv_s = q_s + QB * DH;                        // [kKC][kStride]
  float* s_s = kv_s + kKC * kStride;                  // [QB][ns]
  float* hm_s = s_s + QB * ns;                        // [QB][ns], with HM only
  float* row0_s = hm_s + (HM ? QB * ns : 0);          // [ns]
  float* km_s = row0_s + ns;                          // [np] key mask
  float* fg_s = km_s + np;                            // [QB] 1 - bg_q
  float* den_s = fg_s + QB;                           // [QB] softmax sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const int c = heads * DH, c2 = 2 * c;
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
    for (int i = tid; i < QB * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      q_s[i] = (q0 + r < nq) ? to_f(q_b[size_t(q0 + r) * c + h * DH + d]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, QB/4 query rows.
    {
      constexpr int kRows = QB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < np; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, kv_b, k0, np, c2, h * DH);
        __syncthreads();
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kStride);
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kvv = k4[d4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qv =
                reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * DH)[d4];
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

    // O = P V, one V chunk at a time.  Where the threads divide by DH (16, 32,
    // 64): thread = one column d, QB * DH / kThreads rows.  Else (40, 80):
    // ceil(QB * DH / kThreads) (row, column) pairs, pair i at index tid + i *
    // kThreads of the [QB][DH] tile (at 40 and QB = 16 the pairs past the
    // tile are skipped), as in masked_attention.cuh.
    if constexpr (kThreads % DH == 0) {
      constexpr int kRows = QB * DH / kThreads, kStep = kThreads / DH;
      const int d = tid % DH, rg = tid / DH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < np; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, kv_b, k0, np, c2, c + h * DH);
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
        if (q0 + r < nq) {
          const float o = HM ? acc[i] : acc[i] / den_s[r];
          out[(size_t(b) * nq + q0 + r) * c + h * DH + d] = from_f<T>(o);
        }
      }
    } else {
      constexpr int kPairs = QB * DH, kRows = (kPairs + kThreads - 1) / kThreads;
      constexpr bool kWholeP = kPairs % kThreads == 0;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < np; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, kv_b, k0, np, c2, c + h * DH);
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
        if (q0 + r < nq) {
          const float o = HM ? acc[i] : acc[i] / den_s[r];
          out[(size_t(b) * nq + q0 + r) * c + h * DH + d] = from_f<T>(o);
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

// ---------------------------------------------------------------------------
// The tensor-core design (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 16;                 // query rows of a block: one m16 tile

// Past head width 64 the head's Q tile sits in shared memory (these bytes,
// [16][tc_pitch]) and its A fragments are read per chunk, as kernel 1 does
// at those widths: at 80 its 20 registers of Q a thread push the two-block
// bound of 128 registers into spills
__host__ __device__ constexpr int seq_q_bytes(int dh) {
  return dh == 64 ? 0 : kTcRows * tc_pitch(2, dh) * 2;
}

size_t tc_smem_bytes(int np, int with_hm, int dh) {
  size_t floats = size_t(2) * tc_keys(np)                  // key mask, row0 sums
                  + size_t(kTcWarps) * kTcRows * 2         // row statistics of each warp
                  + 2 * kTcRows;                           // 1 - bg_q, den
  if (with_hm) floats += size_t(kTcRows) * tc_hm_stride(np);
  return size_t(kTcWarps) * tc_ring_bytes(2, 1, dh) + floats * sizeof(float) + seq_q_bytes(dh);
}

// S of one 16-key chunk (two n8 tiles) for the block's 16 rows: scaled,
// masked, killed past n_real, clamped; -inf on keys >= np.  Q from the
// fragments qa (width 64) or from the tile q_s (the other widths).
template <bool CLAMP, int DH>
__device__ __forceinline__ void tc_logits(float (&s)[2][4],
                                          const typename Tc<bf16, DH>::QFrag (&qa)[1],
                                          const bf16* q_s, const bf16* k_s, int k0, int np,
                                          int n_real, float scale, const float* km_s,
                                          float fg_lo, float fg_hi, int lane) {
  float d[1][2][4];
  if constexpr (DH == 64) Tc<bf16, DH>::template dots<1>(d, qa, k_s, lane);
  else Tc<bf16, DH>::template dots_smem<1>(d, q_s, k_s, lane);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
      float v = -INFINITY;
      if (k < np) {
        const float kill = k < n_real ? 0.f : -1e9f;
        v = __fadd_rn(__fadd_rn(__fmul_rn(d[0][nt][e], scale), __fmul_rn(e < 2 ? fg_lo : fg_hi,
                                                                             km_s[k])), kill);
        if (CLAMP) v = fminf(v, 80.f);
      }
      s[nt][e] = v;
    }
  }
}

// A block owns 16 query rows of one image; its 8 warps take the 16-key chunks
// of the gathered keys in turn (warp w: chunks w, w + 8, ...), each staging
// its own chunks in a private two-stage ring, so the key loops need no block
// barrier.  Per head: pass 1 forms each row's softmax sum (and maximum
// without the clamp), the warps' partials meet in shared memory; pass 2
// forms P, adds it into the head mean and row 0 (each element owned by one
// thread: a fixed order of sums, no atomics) and feeds it, rounded to bf16,
// to P V; the warps' partial O tiles are summed in shared memory.  A thread
// holds tc_width(DH) / 8 n8 tiles of O (8 at 64, 10 at 80; at 40 the sixth
// is the zero pad, kept so that P V runs in pairs of n8 tiles from one
// ldmatrix).
template <bool HM, bool CLAMP, int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
masked_attention_seq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                               const float* __restrict__ bg_q, const float* __restrict__ bg_k,
                               bf16* __restrict__ out, bf16* __restrict__ row0,
                               void* __restrict__ hm_out, int nq, int np, int n_real,
                               int heads, float scale, float mask_value, int flags) {
  using TC = Tc<bf16, DH>;
  constexpr int kRing = tc_ring_bytes(2, 1, DH);    // bytes of a warp's ring
  constexpr int kOStride = kTcOStrideOf<DH>;        // float row pitch of the O exchange
  constexpr int kNT = tc_width(DH) / 8;             // n8 tiles of O (zero past DH)
  constexpr int kStage = 2 * TC::kChunk;            // elements of one (K, V) stage
  constexpr bool kQs = seq_q_bytes(DH) != 0;        // Q from shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = tc_keys(np), hs = tc_hm_stride(np);
  unsigned char* rings = smem_raw;                                         // [warps][kRing]
  float* km_s = reinterpret_cast<float*>(rings + kTcWarps * kRing);       // [nk]
  float* row0_s = km_s + nk;                                               // [nk]
  float* st_s = row0_s + nk;                        // [warps][16][2]: max, sum
  float* fg_s = st_s + kTcWarps * kTcRows * 2;      // [16]
  float* den_s = fg_s + kTcRows;                    // [16]
  float* hm_s = den_s + kTcRows;                    // [16][hs], with HM only
  bf16* q_s = reinterpret_cast<bf16*>(hm_s + (HM ? kTcRows * hs : 0));   // [16][pitch], kQs

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kTcRows;
  const int c = heads * DH, c2 = 2 * c;
  const bf16* q_b = q + size_t(b) * nq * c;
  const bf16* kv_b = kv + size_t(b) * np * c2;
  const bool has_row0 = q0 == 0;
  bf16* ring = reinterpret_cast<bf16*>(rings + warp * kRing);
  const int n_chunks = nk / kTcChunk;
  const int mine = warp < n_chunks ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;

  for (int k = tid; k < nk; k += kTcThreads) {
    km_s[k] = k < np ? bg_k[size_t(b) * np + k] * mask_value : 0.f;
    row0_s[k] = 0.f;
  }
  for (int r = tid; r < kTcRows; r += kTcThreads)
    fg_s[r] = (q0 + r < nq) ? 1.f - bg_q[size_t(b) * nq + q0 + r] : 0.f;
  if (HM)
    for (int i = tid; i < kTcRows * hs; i += kTcThreads) hm_s[i] = 0.f;
  // head h's Q rows into q_s (rows and columns past nq and DH zero), 16
  // bytes a thread
  auto stage_q = [&](int h) {
    constexpr int kSegs = BfTile<DH>::kWidth / 8;
    for (int i = tid; i < kTcRows * kSegs; i += kTcThreads) {
      const int r = i / kSegs, sg = i % kSegs;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < nq && (BfTile<DH>::kWidth == DH || sg < DH / 8))
        v = __ldg(reinterpret_cast<const uint4*>(q_b + size_t(q0 + r) * c + h * DH + sg * 8));
      *reinterpret_cast<uint4*>(q_s + BfTile<DH>::at(r, sg * 8)) = v;
    }
  };
  if constexpr (kQs) stage_q(0);
  __syncthreads();
  const float fg_lo = fg_s[g], fg_hi = fg_s[g + 8];
  const bool lo_ok = q0 + g < nq, hi_ok = q0 + g + 8 < nq;

  // stage chunk i of this warp (K, and V with with_v) into stage i % 2
  auto stage = [&](int h, int i, bool with_v) {
    const int k0 = (warp + i * kTcWarps) * kTcChunk;
    bf16* dst = ring + (i & 1) * kStage;
    const bf16* src = kv_b + size_t(k0) * c2 + h * DH;
    TC::stage(dst, src, c2, np - k0, lane);
    if (with_v) TC::stage(dst + TC::kChunk, src + c, c2, np - k0, lane);
    cp_async_commit();
  };

  if (mine) stage(0, 0, false);
  for (int h = 0; h < heads; ++h) {
    typename TC::QFrag qa[1];
    if constexpr (!kQs) TC::q_frags(qa[0], q_b + h * DH, c, q0, nq, lane);

    // pass 1: per row the maximum (without the clamp) and the sum of exp
    float m_lo = CLAMP ? 0.f : -INFINITY, m_hi = m_lo, l_lo = 0.f, l_hi = 0.f;
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float s[2][4];
      tc_logits<CLAMP, DH>(s, qa, q_s, ring + (i & 1) * kStage,
                           (warp + i * kTcWarps) * kTcChunk, np, n_real, scale, km_s, fg_lo,
                           fg_hi, lane);
      if (!CLAMP) {
        const float n_lo = fmaxf(m_lo, quad_max(fmaxf(fmaxf(s[0][0], s[0][1]),
                                                      fmaxf(s[1][0], s[1][1]))));
        const float n_hi = fmaxf(m_hi, quad_max(fmaxf(fmaxf(s[0][2], s[0][3]),
                                                      fmaxf(s[1][2], s[1][3]))));
        l_lo = n_lo == m_lo ? l_lo : l_lo * exp_ftz(m_lo - n_lo);
        l_hi = n_hi == m_hi ? l_hi : l_hi * exp_ftz(m_hi - n_hi);
        m_lo = n_lo;
        m_hi = n_hi;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        l_lo += exp_ftz(s[nt][0] - m_lo) + exp_ftz(s[nt][1] - m_lo);
        l_hi += exp_ftz(s[nt][2] - m_hi) + exp_ftz(s[nt][3] - m_hi);
      }
      __syncwarp();   // this stage is read before the chunk after next lands in it
    }
    if (mine) stage(h, 0, true);   // pass 2's first chunk loads across the barrier
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (tg == 0) {
      st_s[(warp * kTcRows + g) * 2] = m_lo;
      st_s[(warp * kTcRows + g) * 2 + 1] = l_lo;
      st_s[(warp * kTcRows + g + 8) * 2] = m_hi;
      st_s[(warp * kTcRows + g + 8) * 2 + 1] = l_hi;
    }
    __syncthreads();
    // every thread combines the warps' partials of its two rows, in one order
    float mx_lo = CLAMP ? 0.f : -INFINITY, mx_hi = mx_lo, den_lo = 0.f, den_hi = 0.f;
    if (!CLAMP)
      for (int w = 0; w < kTcWarps; ++w) {
        mx_lo = fmaxf(mx_lo, st_s[(w * kTcRows + g) * 2]);
        mx_hi = fmaxf(mx_hi, st_s[(w * kTcRows + g + 8) * 2]);
      }
    for (int w = 0; w < kTcWarps; ++w) {
      const float* lo = st_s + (w * kTcRows + g) * 2;
      const float* hi = st_s + (w * kTcRows + g + 8) * 2;
      den_lo += CLAMP || lo[0] == mx_lo ? lo[1] : lo[1] * exp_ftz(lo[0] - mx_lo);
      den_hi += CLAMP || hi[0] == mx_hi ? hi[1] : hi[1] * exp_ftz(hi[0] - mx_hi);
    }
    den_lo = fmaxf(den_lo, 1e-30f);
    den_hi = fmaxf(den_hi, 1e-30f);
    const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
    if (warp == 0 && tg == 0) {
      den_s[g] = den_lo;
      den_s[g + 8] = den_hi;
    }

    // pass 2: P, the head mean and row 0, O = P V
    float o[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const bf16* k_s = ring + (i & 1) * kStage;
      const int k0 = (warp + i * kTcWarps) * kTcChunk;
      float s[2][4];
      tc_logits<CLAMP, DH>(s, qa, q_s, k_s, k0, np, n_real, scale, km_s, fg_lo, fg_hi, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int k = k0 + nt * 8 + 2 * tg;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = exp_ftz(s[nt][e] - (e < 2 ? mx_lo : mx_hi));
          p[e] = ftz(ex * (e < 2 ? inv_lo : inv_hi));
          s[nt][e] = HM ? p[e] : ex;
        }
        if (HM) {
          if (lo_ok) {
            float2* h2 = reinterpret_cast<float2*>(hm_s + g * hs + k);
            *h2 = make_float2(h2->x + p[0], h2->y + p[1]);
          }
          if (hi_ok) {
            float2* h2 = reinterpret_cast<float2*>(hm_s + (g + 8) * hs + k);
            *h2 = make_float2(h2->x + p[2], h2->y + p[3]);
          }
        }
        if (has_row0 && g == 0) {
          row0_s[k] += p[0];
          row0_s[k + 1] += p[1];
        }
      }
      unsigned pa[4];
      a_from_c(pa, s[0], s[1]);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        unsigned vb[4];
        TC::v_frags(vb, k_s + TC::kChunk, j, 1.f, lane);
        mma16816(o[2 * j], pa, vb[0], vb[1]);
        mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
      }
      __syncwarp();
    }

    // the warps' partial O tiles meet in their own rings, summed in one order
    float* ox = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      *reinterpret_cast<float2*>(ox + g * kOStride + j * 8 + 2 * tg) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(ox + (g + 8) * kOStride + j * 8 + 2 * tg) =
          make_float2(o[j][2], o[j][3]);
    }
    __syncthreads();
    // every warp is past this head's products: the next head's Q may land
    if constexpr (kQs)
      if (h + 1 < heads) stage_q(h + 1);
    for (int idx = tid; idx < kTcRows * (DH / 4); idx += kTcThreads) {
      const int r = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kTcWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(rings + w * kRing) + r * kOStride + d);
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      if (q0 + r < nq) {
        if (!HM) {
          const float den = den_s[r];
          acc.x /= den, acc.y /= den, acc.z /= den, acc.w /= den;
        }
        uint2 pk = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
        *reinterpret_cast<uint2*>(out + (size_t(b) * nq + q0 + r) * c + h * DH + d) = pk;
      }
    }
    __syncthreads();   // the rings are free again
    if (mine && h + 1 < heads) stage(h + 1, 0, false);
  }

  if (has_row0)
    for (int k = tid; k < np; k += kTcThreads)
      row0[size_t(b) * np + k] = __float2bfloat16(row0_s[k] / heads);
  if constexpr (HM) {
    const bool hm_bf16 = flags & kHmBf16;
    for (int i = tid; i < kTcRows * np; i += kTcThreads) {
      const int r = i / np, k = i % np;
      if (q0 + r >= nq) break;
      store_f(hm_out, (size_t(b) * nq + q0 + r) * np + k, hm_s[r * hs + k] / heads, hm_bf16);
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

template <typename T, int QB, bool HM, bool CLAMP, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_seq_kernel<T, QB, HM, CLAMP, DH>;
  const size_t smem = smem_bytes(a.np, HM, QB, DH);
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

template <typename T, int QB, bool HM, int DH>
cudaError_t launch_clamp(int clamp, const Args& a, cudaStream_t stream) {
  return clamp ? launch<T, QB, HM, true, DH>(a, stream) : launch<T, QB, HM, false, DH>(a, stream);
}

template <typename T, int QB, int DH>
cudaError_t launch_hm(int with_hm, int clamp, const Args& a, cudaStream_t stream) {
  return with_hm ? launch_clamp<T, QB, true, DH>(clamp, a, stream)
                 : launch_clamp<T, QB, false, DH>(clamp, a, stream);
}

template <bool HM, bool CLAMP, int DH>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_seq_tc_kernel<HM, CLAMP, DH>;
  const size_t smem = tc_smem_bytes(a.np, HM, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + kTcRows - 1) / kTcRows, a.batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kv),
      static_cast<const float*>(a.bg_q), static_cast<const float*>(a.bg_k),
      static_cast<bf16*>(a.out), static_cast<bf16*>(a.row0), a.hm, a.nq, a.np, a.n_real,
      a.heads, a.scale, a.mask_value, a.flags);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_tc_variant(int with_hm, int clamp, const Args& a, cudaStream_t stream) {
  if (with_hm)
    return clamp ? launch_tc<true, true, DH>(a, stream) : launch_tc<true, false, DH>(a, stream);
  return clamp ? launch_tc<false, true, DH>(a, stream) : launch_tc<false, false, DH>(a, stream);
}

template <typename T, int DH>
cudaError_t launch_qb(int with_hm, int clamp, const Args& a, cudaStream_t stream) {
  switch (pick_qb(a.np, with_hm, DH)) {
    case 32:
      return launch_hm<T, 32, DH>(with_hm, clamp, a, stream);
    case 16:
      return launch_hm<T, 16, DH>(with_hm, clamp, a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

// The C entry point's work at head width DH (its arguments documented there).
template <int DH>
int seq_entry(const void* q, const void* kv, const void* bg_q, const void* bg_k, void* out,
              void* row0, void* hm, int batch, int nq, int np, int n_real, int heads,
              float scale, float mask_value, int dtype, int with_hm, int clamp, int flags,
              int design, void* stream) {
  if (batch < 1 || batch > 65535 || nq < 1 || np < nq || heads < 1 || n_real < 1 ||
      n_real > np || (with_hm != 0) != (hm != nullptr) || (design == 1 && dtype != 1) ||
      design < 0 || design > 1)
    return cudaErrorInvalidValue;
  const Args a{q, kv, bg_q, bg_k, out, row0, hm, batch, nq, np, n_real, heads,
               scale, mask_value, flags};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) return launch_tc_variant<DH>(with_hm, clamp, a, s);
  switch (dtype) {
    case 0:
      return launch_qb<float, DH>(with_hm, clamp, a, s);
    case 1:
      return launch_qb<__nv_bfloat16, DH>(with_hm, clamp, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The occupancy of the instance a launch at Np takes, clamp on: the
// tensor-core instance (design 1, bf16) or the FMA instance (design 0; dtype
// 0 = float32, 1 = bf16) at the query tile pick_qb takes: info[0] blocks an
// SM at once, info[1] registers a thread, info[2] local memory a thread
// (spills), info[3] shared memory a block.
template <int DH>
int seq_occupancy_entry(int np, int with_hm, int dtype, int design, int* info) {
  if (np < 1 || design < 0 || design > 1 || dtype < 0 || dtype > 1 || (design == 1 && dtype != 1))
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  size_t smem = 0;
  if (design == 1) {
    kernel = with_hm ? reinterpret_cast<const void*>(masked_attention_seq_tc_kernel<true, true, DH>)
                     : reinterpret_cast<const void*>(masked_attention_seq_tc_kernel<false, true, DH>);
    smem = tc_smem_bytes(np, with_hm, DH);
  } else {
    const int qb = pick_qb(np, with_hm, DH);
    if (qb == 0) return cudaErrorInvalidConfiguration;
    auto pick = [&](auto t) -> const void* {
      using T = decltype(t);
      if (qb == 32)
        return with_hm ? reinterpret_cast<const void*>(masked_attention_seq_kernel<T, 32, true, true, DH>)
                       : reinterpret_cast<const void*>(masked_attention_seq_kernel<T, 32, false, true, DH>);
      return with_hm ? reinterpret_cast<const void*>(masked_attention_seq_kernel<T, 16, true, true, DH>)
                     : reinterpret_cast<const void*>(masked_attention_seq_kernel<T, 16, false, true, DH>);
    };
    kernel = dtype == 0 ? pick(float{}) : pick(__nv_bfloat16{});
    smem = smem_bytes(np, with_hm, qb, DH);
  }
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, kThreads, smem);
  info[1] = fa.numRegs;
  info[2] = int(fa.localSizeBytes);
  info[3] = int(smem);
  return err;
}

}  // namespace
