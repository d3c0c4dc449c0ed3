// Masked multi-head attention on split q, k, v tensors with the CAM
// statistics (the "v1" kernel), for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_kernel (entry point masked_attention).  Per image and head, with q, k
// and v [B, H, N, dh] (each head's rows contiguous) and bg [B, N]:
//
//   S   = Q K^T * scale + mask_value * min(bg_i + bg_j, 1)   (pair mask)
//   P   = softmax(S), by row-max subtraction (no clamp)
//   O   = P V                                   -> out [B, H, N, dh]
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
// The head width dh is a template parameter, DH, as the TPU kernel reads it
// from q's shape: 64 (ViT-S/B/L), 80 (ViT-H/14), and 16, 32 and 40 (the JAX
// kernel tests' widths), the widths kernel 1 takes, each instantiated in its
// own translation unit (masked_attention_v1.cu, masked_attention_v1_w16.cu,
// ..._w32.cu, ..._w40.cu, ..._w80.cu, so that nvcc builds them in parallel);
// the C entry point in masked_attention_v1.cu dispatches on head_dim.
//
// What bounds it on this card.  At B=64, H=12, N=197, dh=64 in bf16 it reads
// q, k, v and writes out once (77.5 MB; 82.5 MB with the bf16 head mean),
// 0.023 ms at 3.35 TB/s, and its two products are 7.6 GFLOP (0.008 ms at the
// bf16 tensor-core peak): bound by bytes.
//
// Two designs, one block per (16 or 32 query rows, image) looping over the
// heads, so the cls row and the head mean are summed in a fixed order
// without atomics.
//
// The tensor-core design (bf16, every N <= V1_MAX_N with and without the
// head mean): kernel 1's (masked_attention.cuh, attention_tc.cuh) on the
// split layout.  A block of 8 warps owns 16 query rows; the warps take the
// 16-key chunks of a head's [N, dh] K and V slabs in turn, each staging its
// chunks by cp.async into a private two-stage ring (swizzled [16][64] tiles
// at 64, rows of an odd number of 16-byte segments at the other widths);
// QK^T and P V on mma.sync.m16n8k16, S in registers; per head two passes over
// the keys (the row maximum and the sum of exponentials, then P = E / den,
// added into the head mean and the cls row and rounded to bf16 in registers
// as the A fragment of P V); the [16, N] float32 head mean in shared memory,
// each element owned by one thread; exponentials and probabilities below
// 2^-126 flushed to zero.  At 64 the A fragments of Q are held in registers;
// at the other widths Q sits in a [16][pitch] tile in shared memory
// (v1_q_bytes) and is read per chunk by ldmatrix, as kernel 1 does at 80,
// where Q in registers spills.  QK^T takes 1 / 2 / 3 / 4 / 5 k16 steps at
// 16 / 32 / 40 / 64 / 80, P V 2 / 4 / 6 / 8 / 10 n8 tiles.  Width 40 is
// staged and multiplied as 48 columns: q, k and v are contiguous [N, 40]
// slabs, so a 48-column read would take the next token's first 8 columns (and
// past the tensor's end on the last row); K, V and the Q tile are staged
// zero-filled to 48 columns instead (BfTile<40>), and O's sixth n8 tile, zero,
// is never stored.
//
// The FMA design (float32, and bf16 where it is asked for): a whole float32
// key row of S ([QB, N]) stays in shared memory, so the softmax is exact in
// one pass; QB is 32 where the tiles fit the 227 KB a block may use and 16
// past that; K and V are staged in 64-key chunks and both products are
// float32 FMAs on the CUDA cores.  Where the 256 threads divide by the width
// (16, 32, 64) a thread of P V owns one column; at 40 and 80 it owns (row,
// column) pairs of the [QB, DH] tile, as kernel 1's FMA design does.
//
// Numerics follow the TPU kernel: S, the softmax and the means are float32;
// the normalised P is rounded to v's element type before P V.  The scale and
// the mask term are rounded one by one (__fmul_rn / __fadd_rn), so no FMA
// contraction moves them away from the plain version.  The tensor-core design
// multiplies by 1 / den where the plain version divides, and sums P V in
// another order: an ulp apart.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#pragma once

#include <cmath>

#include "attention_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may ask for

size_t smem_bytes(int n, int with_hm, int qb, int dh) {
  const size_t ns = padded(n);
  size_t floats = size_t(qb) * dh + size_t(kKC) * (dh + 4) + qb * ns;
  if (with_hm) floats += qb * ns;
  floats += ns + n + qb;
  return floats * sizeof(float);
}

// query rows per block: 32 where the tiles fit, else 16, else 0 (too long)
int pick_qb(int n, int with_hm, int dh) {
  if (smem_bytes(n, with_hm, 32, dh) <= kMaxSmem) return 32;
  if (smem_bytes(n, with_hm, 16, dh) <= kMaxSmem) return 16;
  return 0;
}

template <typename T, int QB, bool HM, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_v1_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bg,
                           T* __restrict__ out, T* __restrict__ cls, T* __restrict__ hm_out,
                           int n, int heads, float scale, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  constexpr int kStride = kKVStrideOf<DH>;
  float* q_s = smem;                                  // [QB][DH]
  float* kv_s = q_s + QB * DH;                        // [kKC][kStride]
  float* s_s = kv_s + kKC * kStride;                  // [QB][ns]
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
    const size_t head = (size_t(b) * heads + h) * n * DH;   // this head's [N, DH] slab
    const T* q_h = q + head;
    const T* k_h = k + head;
    const T* v_h = v + head;
    for (int i = tid; i < QB * DH; i += kThreads) {
      const int r = i / DH;
      q_s[i] = (q0 + r < n) ? to_f(q_h[size_t(q0) * DH + i]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, QB/4 query rows.
    {
      constexpr int kRows = QB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, k_h, k0, n, DH, 0);
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

    // O = P V, one V chunk at a time.  Where the threads divide by DH (16,
    // 32, 64): thread = one column d, QB * DH / kThreads rows.  Else (40,
    // 80): ceil(QB * DH / kThreads) (row, column) pairs, pair i at index tid
    // + i * kThreads of the [QB][DH] tile (at 40 and QB = 16 the pairs past
    // the tile are skipped).
    if constexpr (kThreads % DH == 0) {
      constexpr int kRows = QB * DH / kThreads, kStep = kThreads / DH;
      const int d = tid % DH, rg = tid / DH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, v_h, k0, n, DH, 0);
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
        if (q0 + r < n) out[head + size_t(q0 + r) * DH + d] = from_f<T>(acc[i]);
      }
    } else {
      constexpr int kPairs = QB * DH, kRows = (kPairs + kThreads - 1) / kThreads;
      constexpr bool kWholeP = kPairs % kThreads == 0;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads, T, DH>(kv_s, v_h, k0, n, DH, 0);
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
        if (q0 + r < n) out[head + size_t(q0 + r) * DH + d] = from_f<T>(acc[i]);
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

// ---------------------------------------------------------------------------
// The tensor-core design (bf16)
// ---------------------------------------------------------------------------

// Past head width 64 and below it the head's Q rows sit in shared memory
// (these bytes, a [16][tc_pitch] bf16 tile, zeros past DH) and their A
// fragments are read per chunk, as kernel 1 does at those widths
__host__ __device__ constexpr int v1_q_bytes(int dh) {
  return dh == 64 ? 0 : 16 * tc_pitch(2, dh) * 2;
}

size_t tc_smem_bytes(int n, int with_hm, int dh) {
  size_t floats = size_t(2) * tc_keys(n)            // bg of the keys, cls sums
                  + size_t(kTcWarps) * 16 * 2       // row statistics of each warp
                  + 16;                             // bg of the query rows
  if (with_hm) floats += size_t(16) * tc_hm_stride(n);
  return size_t(kTcWarps) * tc_ring_bytes(2, 1, dh) + floats * sizeof(float) + v1_q_bytes(dh);
}

// A block owns 16 query rows of one image; its 8 warps take the 16-key
// chunks in turn (warp w: chunks w, w + 8, ...), each staging its own chunks
// of K and V in a private two-stage ring.  Per head: pass 1 forms each row's
// maximum and sum of exponentials, the warps' partials meet in shared memory;
// pass 2 forms P, adds it into the head mean and the cls row (each element
// owned by one thread) and feeds it, rounded to bf16, to P V; the warps'
// partial O tiles are summed in shared memory in one order.  A thread holds
// tc_width(DH) / 8 n8 tiles of O (at 40 the sixth is the zero pad, kept so
// that P V runs in pairs of n8 tiles from one ldmatrix).
template <bool HM, int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
masked_attention_v1_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ bg,
                              bf16* __restrict__ out, bf16* __restrict__ cls,
                              bf16* __restrict__ hm_out, int n, int heads, float scale,
                              float mask_value) {
  using TC = Tc<bf16, DH>;
  constexpr int kRing = tc_ring_bytes(2, 1, DH);    // bytes of a warp's ring
  constexpr int kOStride = kTcOStrideOf<DH>;        // float row pitch of the O exchange
  constexpr int kNT = tc_width(DH) / 8;             // n8 tiles of O (zero past DH)
  constexpr int kStage = 2 * TC::kChunk;            // elements of one (K, V) stage
  constexpr bool kQs = v1_q_bytes(DH) != 0;         // Q from shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = tc_keys(n), hs = tc_hm_stride(n);
  unsigned char* rings = smem_raw;                                     // [warps][kRing]
  float* bgk_s = reinterpret_cast<float*>(rings + kTcWarps * kRing);  // [nk]
  float* cls_s = bgk_s + nk;                                           // [nk]
  float* st_s = cls_s + nk;                          // [warps][16][2]: max, sum
  float* bgq_s = st_s + kTcWarps * 16 * 2;           // [16]
  float* hm_s = bgq_s + 16;                          // [16][hs], with HM only
  bf16* q_s = reinterpret_cast<bf16*>(hm_s + (HM ? 16 * hs : 0));   // [16][pitch], kQs

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * 16;
  const bool has_cls = q0 == 0;
  bf16* ring = reinterpret_cast<bf16*>(rings + warp * kRing);
  const int n_chunks = nk / kTcChunk;
  const int mine = warp < n_chunks ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;

  // this image's [N, DH] slab of head h
  auto slab = [&](const bf16* t, int h) { return t + (size_t(b) * heads + h) * n * DH; };
  // head h's Q rows into q_s (rows past n and columns past DH zero), 16
  // bytes a thread: never a read past a row's DH columns
  auto stage_q = [&](int h) {
    constexpr int kSegs = BfTile<DH>::kWidth / 8;
    const bf16* q_h = slab(q, h);
    for (int i = tid; i < 16 * kSegs; i += kTcThreads) {
      const int r = i / kSegs, sg = i % kSegs;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < n && (BfTile<DH>::kWidth == DH || sg < DH / 8))
        x = __ldg(reinterpret_cast<const uint4*>(q_h + size_t(q0 + r) * DH + sg * 8));
      *reinterpret_cast<uint4*>(q_s + BfTile<DH>::at(r, sg * 8)) = x;
    }
  };

  for (int j = tid; j < nk; j += kTcThreads) {
    bgk_s[j] = j < n ? bg[size_t(b) * n + j] : 0.f;
    cls_s[j] = 0.f;
  }
  for (int r = tid; r < 16; r += kTcThreads) bgq_s[r] = q0 + r < n ? bg[size_t(b) * n + q0 + r] : 0.f;
  if (HM)
    for (int i = tid; i < 16 * hs; i += kTcThreads) hm_s[i] = 0.f;
  if constexpr (kQs) stage_q(0);
  __syncthreads();
  const float bgq[2] = {bgq_s[g], bgq_s[g + 8]};
  const bool row_ok[2] = {q0 + g < n, q0 + g + 8 < n};

  // stage chunk i of this warp (K, and V with with_v) into stage i % 2
  auto stage = [&](int h, int i, bool with_v) {
    const int k0 = (warp + i * kTcWarps) * kTcChunk;
    bf16* dst = ring + (i & 1) * kStage;
    TC::stage(dst, slab(k, h) + size_t(k0) * DH, DH, n - k0, lane);
    if (with_v) TC::stage(dst + TC::kChunk, slab(v, h) + size_t(k0) * DH, DH, n - k0, lane);
    cp_async_commit();
  };
  // S of one chunk: scaled and pair-masked; -inf on keys >= n.  Q from the
  // fragments qa (width 64) or from the tile q_s (the other widths).
  auto logits = [&](float (&s)[1][2][4], const typename TC::QFrag (&qa)[1], const bf16* k_s,
                    int k0) {
    if constexpr (kQs) TC::template dots_smem<1>(s, q_s, k_s, lane);
    else TC::template dots<1>(s, qa, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tg + (e & 1);
        float x = -INFINITY;
        if (key < n) {
          const float pair = __fmul_rn(fminf(__fadd_rn(bgq[e >> 1], bgk_s[key]), 1.f), mask_value);
          x = __fadd_rn(__fmul_rn(s[0][nt][e], scale), pair);
        }
        s[0][nt][e] = x;
      }
  };

  if (mine) stage(0, 0, false);
  for (int h = 0; h < heads; ++h) {
    typename TC::QFrag qa[1];
    if constexpr (!kQs) TC::q_frags(qa[0], slab(q, h), DH, q0, n, lane);

    // pass 1: per row the maximum and the sum of exp
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage(h, i + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float s[1][2][4];
      logits(s, qa, ring + (i & 1) * kStage, (warp + i * kTcWarps) * kTcChunk);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float nm = fmaxf(m[hf], quad_max(fmaxf(fmaxf(s[0][0][2 * hf], s[0][0][2 * hf + 1]),
                                                     fmaxf(s[0][1][2 * hf], s[0][1][2 * hf + 1]))));
        l[hf] = nm == m[hf] ? l[hf] : l[hf] * exp_ftz(m[hf] - nm);
        m[hf] = nm;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          l[hf] += exp_ftz(s[0][nt][2 * hf] - m[hf]) + exp_ftz(s[0][nt][2 * hf + 1] - m[hf]);
      }
      __syncwarp();   // this stage is read before the chunk after next lands in it
    }
    if (mine) stage(h, 0, true);   // pass 2's first chunk loads across the barrier
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lsum = quad_sum(l[hf]);
      if (tg == 0) {
        float* st = st_s + (warp * 16 + g + 8 * hf) * 2;
        st[0] = m[hf];
        st[1] = lsum;
      }
    }
    __syncthreads();
    // every thread combines the warps' partials of its rows, in one order
    float mx[2], inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g + 8 * hf;
      float mr = -INFINITY, den = 0.f;
      for (int w = 0; w < kTcWarps; ++w) mr = fmaxf(mr, st_s[(w * 16 + r) * 2]);
      for (int w = 0; w < kTcWarps; ++w) {
        const float* st = st_s + (w * 16 + r) * 2;
        den += st[0] == mr ? st[1] : st[1] * exp_ftz(st[0] - mr);
      }
      mx[hf] = mr;
      inv[hf] = 1.f / den;
    }

    // pass 2: P, the head mean and the cls row, O = P V
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
      float s[1][2][4];
      logits(s, qa, k_s, k0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = k0 + nt * 8 + 2 * tg;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ftz(exp_ftz(s[0][nt][e] - mx[e >> 1]) * inv[e >> 1]);
          s[0][nt][e] = p[e];
        }
        if (HM) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (row_ok[hf]) {
              float2* h2 = reinterpret_cast<float2*>(hm_s + (g + 8 * hf) * hs + key);
              *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
            }
        }
        if (has_cls && g == 0) {
          cls_s[key] += p[0];
          cls_s[key + 1] += p[1];
        }
      }
      unsigned pa[4];
      a_from_c(pa, s[0][0], s[0][1]);
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
      *reinterpret_cast<float2*>(ox + g * kOStride + j * 8 + 2 * tg) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(ox + (g + 8) * kOStride + j * 8 + 2 * tg) =
          make_float2(o[j][2], o[j][3]);
    }
    __syncthreads();
    // every warp is past this head's products: the next head's Q may land
    if constexpr (kQs)
      if (h + 1 < heads) stage_q(h + 1);
    bf16* out_h = out + (size_t(b) * heads + h) * n * DH;
    for (int idx = tid; idx < 16 * (DH / 4); idx += kTcThreads) {
      const int r = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kTcWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(rings + w * kRing) + r * kOStride + d);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      if (q0 + r >= n) continue;
      *reinterpret_cast<uint2*>(out_h + size_t(q0 + r) * DH + d) =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
    __syncthreads();   // the rings are free again
    if (mine && h + 1 < heads) stage(h + 1, 0, false);
  }

  if (has_cls)
    for (int j = tid; j < n; j += kTcThreads)
      cls[size_t(b) * n + j] = __float2bfloat16(cls_s[j] / heads);
  if constexpr (HM) {
    for (int i = tid; i < 16 * n; i += kTcThreads) {
      const int r = i / n, j = i % n;
      if (q0 + r >= n) break;
      hm_out[(size_t(b) * n + q0 + r) * n + j] = __float2bfloat16(hm_s[r * hs + j] / heads);
    }
  }
}

struct Args {
  const void *q, *k, *v, *bg;
  void *out, *cls, *hm;
  int batch, n, heads;
  float scale, mask_value;
};

template <typename T, int QB, bool HM, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_v1_kernel<T, QB, HM, DH>;
  const size_t smem = smem_bytes(a.n, HM, QB, DH);
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

template <typename T, int QB, int DH>
cudaError_t launch_hm(int with_hm, const Args& a, cudaStream_t stream) {
  return with_hm ? launch<T, QB, true, DH>(a, stream) : launch<T, QB, false, DH>(a, stream);
}

template <typename T, int DH>
cudaError_t launch_qb(int with_hm, const Args& a, cudaStream_t stream) {
  switch (pick_qb(a.n, with_hm, DH)) {
    case 32:
      return launch_hm<T, 32, DH>(with_hm, a, stream);
    case 16:
      return launch_hm<T, 16, DH>(with_hm, a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <bool HM, int DH>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kernel = masked_attention_v1_tc_kernel<HM, DH>;
  const size_t smem = tc_smem_bytes(a.n, HM, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + 15) / 16, a.batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.bg), static_cast<bf16*>(a.out), static_cast<bf16*>(a.cls),
      static_cast<bf16*>(a.hm), a.n, a.heads, a.scale, a.mask_value);
  return cudaGetLastError();
}

// The C entry point's work at head width DH (its arguments documented there).
template <int DH>
int v1_entry(const void* q, const void* k, const void* v, const void* bg, void* out, void* cls,
             void* hm, int batch, int n, int heads, float scale, float mask_value, int dtype,
             int with_hm, int design, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || heads < 1 || (with_hm != 0) != (hm != nullptr) ||
      design < 0 || design > 1 || (design == 1 && dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, bg, out, cls, hm, batch, n, heads, scale, mask_value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) return with_hm ? launch_tc<true, DH>(a, s) : launch_tc<false, DH>(a, s);
  switch (dtype) {
    case 0:
      return launch_qb<float, DH>(with_hm, a, s);
    case 1:
      return launch_qb<__nv_bfloat16, DH>(with_hm, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The occupancy of the instance a launch at N takes: the tensor-core
// instance (design 1, bf16) or the FMA instance (design 0; dtype 0 =
// float32, 1 = bf16) at the query tile pick_qb takes: info[0] blocks an SM
// at once, info[1] registers a thread, info[2] local memory a thread
// (spills), info[3] shared memory a block.
template <int DH>
int v1_occupancy_entry(int n, int with_hm, int dtype, int design, int* info) {
  if (n < 1 || design < 0 || design > 1 || dtype < 0 || dtype > 1 || (design == 1 && dtype != 1))
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  size_t smem = 0;
  if (design == 1) {
    kernel = with_hm ? reinterpret_cast<const void*>(masked_attention_v1_tc_kernel<true, DH>)
                     : reinterpret_cast<const void*>(masked_attention_v1_tc_kernel<false, DH>);
    smem = tc_smem_bytes(n, with_hm, DH);
  } else {
    const int qb = pick_qb(n, with_hm, DH);
    if (qb == 0) return cudaErrorInvalidConfiguration;
    auto pick = [&](auto t) -> const void* {
      using T = decltype(t);
      if (qb == 32)
        return with_hm ? reinterpret_cast<const void*>(masked_attention_v1_kernel<T, 32, true, DH>)
                       : reinterpret_cast<const void*>(masked_attention_v1_kernel<T, 32, false, DH>);
      return with_hm ? reinterpret_cast<const void*>(masked_attention_v1_kernel<T, 16, true, DH>)
                     : reinterpret_cast<const void*>(masked_attention_v1_kernel<T, 16, false, DH>);
    };
    kernel = dtype == 0 ? pick(float{}) : pick(__nv_bfloat16{});
    smem = smem_bytes(n, with_hm, qb, DH);
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
