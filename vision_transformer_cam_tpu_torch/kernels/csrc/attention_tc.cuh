// The tile code of the tensor-core attention design, shared by kernel 1
// (masked_attention.cu), the split-tensor kernel (masked_attention_v1.cu) and
// the ablation kernels (attn_variants.cu): a block of 8 warps that take
// 16-key chunks in turn, each staging its chunks by cp.async into a private
// two-stage ring of swizzled [rows][64] tiles; the Q fragments of one m16
// tile, the dot products of a staged K chunk on mma.sync (bf16, or s8 with
// exact int32 sums) and the V fragments of P V.  One copy, so that an
// ablation variant and kernel 1 run the same instructions where they agree.
// Kernel 1 also takes head widths 16, 32, 40 and 80: Tc<T, DH> stages
// unswizzled rows of an odd number of 16-byte segments (tc_pitch), takes
// k16 steps (bf16, Q from shared memory: dots_smem) or k32 steps and a last
// k16 step (int8) for QK^T and tc_width(DH) / 8 n8 tiles for P V; at 64
// every helper is the one the other kernels use.  A width that is no
// multiple of 16 (40) is staged and multiplied as whole k16 steps (48
// columns): its 8 extra columns of Q, K and V are zeros in shared memory
// (int8 Q: in registers), so the int32 dot stays exact and P V's extra n8
// tile is zero and never stored.  int8 rows of width 40 lie 8 bytes apart
// from 16-byte alignment, so they are staged by 8-byte cp.async copies.

#pragma once

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcChunk = 16;                  // keys of a staged chunk
constexpr int kTcOStride = kDH + 8;           // float row pitch of the O exchange
// columns of a staged row of a head of width dh: whole k16 steps
__host__ __device__ constexpr int tc_width(int dh) { return k16_width(dh); }
template <int DH> constexpr int kTcOStrideOf = tc_width(DH) + 8;

__host__ __device__ inline int tc_keys(int n) { return (n + kTcChunk - 1) / kTcChunk * kTcChunk; }
__host__ __device__ inline int tc_hm_stride(int n) { return ((n + 31) & ~31) + 8; }

// element pitch of a staged K or V row of DH columns (tc_width(DH) of
// them, zeros past DH): 64 (the swizzled tiles) at DH = 64; otherwise an odd
// number of 16-byte segments, so that the 8 rows an ldmatrix reads lie in 8
// bank groups without a swizzle (bf16 at 16, 32, 40, 80: 24, 40, 56, 88
// elements; int8: 16, 48, 48, 80 bytes)
__host__ __device__ constexpr int tc_pitch(int elem_bytes, int dh) {
  return dh == 64 ? 64
         : (tc_width(dh) * elem_bytes / 16) % 2 ? tc_width(dh)
                                                 : tc_width(dh) + 16 / elem_bytes;
}

// bytes of a warp's ring: two stages of a (K, V) chunk pair, or the warp's
// partial O tile when the heads' products meet, whichever is larger
__host__ __device__ constexpr int tc_ring_bytes(int elem_bytes, int mt, int dh = kDH) {
  return 4 * kTcChunk * tc_pitch(elem_bytes, dh) * elem_bytes > mt * 16 * (tc_width(dh) + 8) * 4
             ? 4 * kTcChunk * tc_pitch(elem_bytes, dh) * elem_bytes
             : mt * 16 * (tc_width(dh) + 8) * 4;
}

// byte offset of (row, byte) in an int8 [rows][64] chunk: segment s of row r
// at s ^ (r / 2 % 4), so the 8 rows an ldmatrix reads lie in 8 bank groups
__device__ __forceinline__ int swz64(int row, int byte) {
  return row * kDH + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}
// the same for an int8 chunk of DH columns: swz64 at 64, else rows of
// tc_pitch(1, DH) bytes, unswizzled
template <int DH> __device__ __forceinline__ int i8_at(int row, int byte) {
  if constexpr (DH == 64) return swz64(row, byte);
  else return row * tc_pitch(1, DH) + byte;
}

// Stage 16 rows of 64 int8 (row r at src + r * pitch) into a swizzled chunk
// by one warp; rows >= `valid` are zero-filled.
__device__ __forceinline__ void stage_rows64_i8(int8_t* dst, const int8_t* __restrict__ src,
                                                size_t pitch, int valid, int lane) {
#pragma unroll
  for (int j = 0; j < kTcChunk * 4 / 32; ++j) {
    const int seg = lane + 32 * j, r = seg >> 2, sg = seg & 3;
    const bool ok = r < valid;
    cp_async16(dst + swz64(r, sg * 16), src + (ok ? size_t(r) * pitch + sg * 16 : 0), ok ? 16 : 0);
  }
}
// the same for 16 rows of DH int8 into a chunk laid out by i8_at<DH>; a
// width that is no multiple of 16 (40: rows 8-byte aligned) by 8-byte
// copies, its columns past DH zero-filled
template <int DH>
__device__ __forceinline__ void stage_rows_i8(int8_t* dst, const int8_t* __restrict__ src,
                                              size_t pitch, int valid, int lane) {
  if constexpr (DH == 64) {
    stage_rows64_i8(dst, src, pitch, valid, lane);
  } else if constexpr (DH % 16 != 0) {
    constexpr int kPieces = tc_width(DH) / 8, kTotal = kTcChunk * kPieces;
#pragma unroll
    for (int j = 0; j < (kTotal + 31) / 32; ++j) {
      const int seg = lane + 32 * j, r = seg / kPieces, pc = seg % kPieces;
      if (kTotal % 32 != 0 && seg >= kTotal) break;
      const bool ok = r < valid && pc < DH / 8;
      cp_async8(dst + i8_at<DH>(r, pc * 8), src + (ok ? size_t(r) * pitch + pc * 8 : 0),
                ok ? 8 : 0);
    }
  } else {
    constexpr int kSegs = DH / 16, kTotal = kTcChunk * kSegs;
#pragma unroll
    for (int j = 0; j < (kTotal + 31) / 32; ++j) {
      const int seg = lane + 32 * j, r = seg / kSegs, sg = seg % kSegs;
      if (kTotal % 32 != 0 && seg >= kTotal) break;
      const bool ok = r < valid;
      cp_async16(dst + i8_at<DH>(r, sg * 16), src + (ok ? size_t(r) * pitch + sg * 16 : 0),
                 ok ? 16 : 0);
    }
  }
}

// The A fragments of rows r0 + g, r0 + g + 8 of int8 q: DH / 32 k32 steps
// and, where DH is no multiple of 32, a last k16 step in a[DH / 32][0..1]
// (at 32 j + 8 its columns past DH zero); rows >= `valid` are zero.
template <int DH>
__device__ __forceinline__ void a_rows_i8(unsigned (&a)[(DH + 31) / 32][4],
                                          const int8_t* __restrict__ src, size_t pitch, int r0,
                                          int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool lo = r0 + g < valid, hi = r0 + g + 8 < valid;
  const unsigned* plo = reinterpret_cast<const unsigned*>(src + size_t(lo ? r0 + g : 0) * pitch);
  const unsigned* phi = reinterpret_cast<const unsigned*>(src + size_t(hi ? r0 + g + 8 : 0) * pitch);
#pragma unroll
  for (int kk = 0; kk < DH / 32; ++kk) {
    a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = lo ? __ldg(plo + kk * 8 + 4 + t) : 0u;
    a[kk][3] = hi ? __ldg(phi + kk * 8 + 4 + t) : 0u;
  }
  if constexpr (DH % 32 == 16) {
    constexpr int kk = DH / 32;
    a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = a[kk][3] = 0u;
  } else if constexpr (DH % 32 != 0) {
    static_assert(DH % 32 == 8, "a last step of 8 columns");
    constexpr int kk = DH / 32;
    const bool in = t < 2;   // words 0-1 of the step: columns 32 kk..32 kk + 7
    a[kk][0] = lo && in ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi && in ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = a[kk][3] = 0u;
  }
}
// The A fragments of rows r0 + g, r0 + g + 8 of int8 q (two k32 steps), as
// a_rows_i8<64>
__device__ __forceinline__ void a_rows64_i8(unsigned (&a)[2][4], const int8_t* __restrict__ src,
                                            size_t pitch, int r0, int valid, int lane) {
  a_rows_i8<64>(a, src, pitch, r0, valid, lane);
}

// What one instance keeps per element type and head width DH (16, 32, 40,
// 64 or 80; tc_width(DH) columns staged and multiplied):
// the Q fragments, the staging of K and V, the logits of a chunk and the V
// fragments of P V.
template <typename T, int DH = kDH> struct Tc;

template <int DH> struct Tc<bf16, DH> {
  static constexpr int kW = tc_width(DH);
  using QFrag = unsigned[kW / 16][4];
  static constexpr int kChunk = kTcChunk * BfTile<DH>::kPitch;   // elements of a staged chunk
  static __device__ __forceinline__ void q_frags(QFrag& qa, const bf16* q, size_t pitch, int r0,
                                                 int valid, int lane) {
    a_rows_w<DH>(qa, q, pitch, r0, valid, lane);
  }
  static __device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t pitch,
                                               int valid, int lane) {
    stage_rows<kTcChunk, 32, DH>(dst, src, pitch, valid, lane);
  }
  // the dot products of one 16-key chunk: d[mt][nt] (two n8 tiles of keys),
  // pairs of k16 steps from one ldmatrix (a width of 32 j + 16 reads Q from
  // shared memory: dots_smem)
  template <int MT>
  static __device__ __forceinline__ void dots(float (&d)[MT][2][4], const QFrag (&qa)[MT],
                                              const bf16* k_s, int lane) {
    static_assert(kW % 32 == 0, "whole pairs of k16 steps");
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) d[mt][nt][0] = d[mt][nt][1] = d[mt][nt][2] = d[mt][nt][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kW / 32; ++kp) {
        unsigned b[4];
        b_rows_w<DH>(b, k_s, nt, kp, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(d[mt][nt], qa[mt][2 * kp], b[0], b[1]);
          mma16816(d[mt][nt], qa[mt][2 * kp + 1], b[2], b[3]);
        }
      }
    }
  }
  // the same dot products with Q read from a BfTile<DH> of MT m16 tiles in
  // shared memory, its A fragments loaded by ldmatrix per k16 step (each
  // accumulator takes its k16 steps in the order dots() does)
  template <int MT>
  static __device__ __forceinline__ void dots_smem(float (&d)[MT][2][4], const bf16* q_s,
                                                   const bf16* k_s, int lane) {
    auto a_frag = [&](unsigned (&a)[4], int mt, int ks) {
      ldmatrix_x4(a, q_s + BfTile<DH>::at(mt * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8));
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) d[mt][nt][0] = d[mt][nt][1] = d[mt][nt][2] = d[mt][nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kW / 32; ++kp) {
      unsigned b0[4], b1[4];
      b_rows_w<DH>(b0, k_s, 0, kp, lane);
      b_rows_w<DH>(b1, k_s, 1, kp, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a0[4], a1[4];
        a_frag(a0, mt, 2 * kp);
        a_frag(a1, mt, 2 * kp + 1);
        mma16816(d[mt][0], a0, b0[0], b0[1]);
        mma16816(d[mt][0], a1, b0[2], b0[3]);
        mma16816(d[mt][1], a0, b1[0], b1[1]);
        mma16816(d[mt][1], a1, b1[2], b1[3]);
      }
    }
    if constexpr (kW % 32 != 0) {
      unsigned tail[4];
      b_rows_tail<DH>(tail, k_s, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        a_frag(a, mt, kW / 16 - 1);
        mma16816(d[mt][0], a, tail[0], tail[1]);
        mma16816(d[mt][1], a, tail[2], tail[3]);
      }
    }
  }
  // the B fragments of n8 tiles 2j and 2j + 1 of V
  static __device__ __forceinline__ void v_frags(unsigned (&vb)[4], const bf16* v_s, int j, float,
                                                 int lane) {
    b_cols_w<DH>(vb, v_s, 0, j, lane);
  }
};

template <int DH> struct Tc<int8_t, DH> {
  static constexpr int kW = tc_width(DH);
  using QFrag = unsigned[(DH + 31) / 32][4];
  static constexpr int kChunk = kTcChunk * tc_pitch(1, DH);
  static __device__ __forceinline__ void q_frags(QFrag& qa, const int8_t* q, size_t pitch,
                                                 int r0, int valid, int lane) {
    a_rows_i8<DH>(qa, q, pitch, r0, valid, lane);
  }
  static __device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, size_t pitch,
                                               int valid, int lane) {
    stage_rows_i8<DH>(dst, src, pitch, valid, lane);
  }
  // exact int32 dot products on the int8 tensor cores, as float: k32 steps
  // (two from one ldmatrix x4, or one from an x2), and a last k16 step where
  // tc_width(DH) is 32 j + 16 (at 40 its 8 columns past DH are zero in Q)
  template <int MT>
  static __device__ __forceinline__ void dots(float (&d)[MT][2][4], const QFrag (&qa)[MT],
                                              const int8_t* k_s, int lane) {
    constexpr int kK32 = kW / 32;
    static_assert(kK32 <= 2, "one ldmatrix x4 per n8 tile holds two k32 steps");
    unsigned tail[2];
    if constexpr (kW % 32 != 0) ldsm_x2(tail, k_s + i8_at<DH>(lane & 15, kW - 16));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned b[4];
      if constexpr (kK32 == 2)
        ldsm_x4(b, k_s + i8_at<DH>(nt * 8 + (lane & 7), (lane >> 3) * 16));
      else if constexpr (kK32 == 1)
        ldsm_x2(reinterpret_cast<unsigned(&)[2]>(b),
                k_s + i8_at<DH>(nt * 8 + (lane & 7), ((lane >> 3) & 1) * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        int c[4] = {0, 0, 0, 0};
        if constexpr (kK32 >= 1) mma16832_s8(c, qa[mt][0], b[0], b[1]);
        if constexpr (kK32 == 2) mma16832_s8(c, qa[mt][1], b[2], b[3]);
        if constexpr (kW % 32 != 0) mma16816_s8(c, qa[mt][kK32][0], qa[mt][kK32][1], tail[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][nt][e] = __int2float_rn(c[e]);
      }
    }
  }
  // (v * sv) rounded to bf16, as the B fragments of n8 tiles 2j and 2j + 1
  static __device__ __forceinline__ void v_frags(unsigned (&vb)[4], const int8_t* v_s, int j,
                                                 float sv, int lane) {
    const int g = lane >> 2, t = lane & 3;
    auto vf = [&](int key, int d) { return __fmul_rn(float(v_s[i8_at<DH>(key, d)]), sv); };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = (2 * j + h) * 8 + g;
      vb[2 * h] = pack_bf16(vf(2 * t, d), vf(2 * t + 1, d));
      vb[2 * h + 1] = pack_bf16(vf(2 * t + 8, d), vf(2 * t + 9, d));
    }
  }
};

}  // namespace
