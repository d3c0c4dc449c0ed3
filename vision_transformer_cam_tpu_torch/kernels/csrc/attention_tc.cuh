// The tile code of the tensor-core attention design, shared by kernel 1
// (masked_attention.cu), the split-tensor kernel (masked_attention_v1.cu) and
// the ablation kernels (attn_variants.cu): a block of 8 warps that take
// 16-key chunks in turn, each staging its chunks by cp.async into a private
// two-stage ring of swizzled [rows][64] tiles; the Q fragments of one m16
// tile, the dot products of a staged K chunk on mma.sync (bf16, or s8 with
// exact int32 sums) and the V fragments of P V.  One copy, so that an
// ablation variant and kernel 1 run the same instructions where they agree.

#pragma once

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcChunk = 16;                  // keys of a staged chunk
constexpr int kTcOStride = kDH + 8;           // float row pitch of the O exchange

__host__ __device__ inline int tc_keys(int n) { return (n + kTcChunk - 1) / kTcChunk * kTcChunk; }
__host__ __device__ inline int tc_hm_stride(int n) { return ((n + 31) & ~31) + 8; }

// bytes of a warp's ring: two stages of a (K, V) chunk pair, or the warp's
// partial O tile when the heads' products meet, whichever is larger
__host__ __device__ constexpr int tc_ring_bytes(int elem_bytes, int mt) {
  return 4 * kTcChunk * kDH * elem_bytes > mt * 16 * kTcOStride * 4
             ? 4 * kTcChunk * kDH * elem_bytes
             : mt * 16 * kTcOStride * 4;
}

// byte offset of (row, byte) in an int8 [rows][64] chunk: segment s of row r
// at s ^ (r / 2 % 4), so the 8 rows an ldmatrix reads lie in 8 bank groups
__device__ __forceinline__ int swz64(int row, int byte) {
  return row * kDH + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
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

// The A fragments of rows r0 + g, r0 + g + 8 of int8 q (two k32 steps);
// rows >= `valid` are zero.
__device__ __forceinline__ void a_rows64_i8(unsigned (&a)[2][4], const int8_t* __restrict__ src,
                                            size_t pitch, int r0, int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool lo = r0 + g < valid, hi = r0 + g + 8 < valid;
  const unsigned* plo = reinterpret_cast<const unsigned*>(src + size_t(lo ? r0 + g : 0) * pitch);
  const unsigned* phi = reinterpret_cast<const unsigned*>(src + size_t(hi ? r0 + g + 8 : 0) * pitch);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = lo ? __ldg(plo + kk * 8 + 4 + t) : 0u;
    a[kk][3] = hi ? __ldg(phi + kk * 8 + 4 + t) : 0u;
  }
}

// What one instance keeps per element type: the Q fragments, the staging of
// K and V, the logits of a chunk and the V fragments of P V.
template <typename T> struct Tc;

template <> struct Tc<bf16> {
  using QFrag = unsigned[4][4];
  static constexpr int kChunk = kTcChunk * kDH;     // elements of a staged K or V chunk
  static __device__ __forceinline__ void q_frags(QFrag& qa, const bf16* q, size_t pitch, int r0,
                                                 int valid, int lane) {
    a_rows64(qa, q, pitch, r0, valid, lane);
  }
  static __device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t pitch,
                                               int valid, int lane) {
    stage_rows64<kTcChunk, 32>(dst, src, pitch, valid, lane);
  }
  // the dot products of one 16-key chunk: d[mt][nt] (two n8 tiles of keys)
  template <int MT>
  static __device__ __forceinline__ void dots(float (&d)[MT][2][4], const QFrag (&qa)[MT],
                                              const bf16* k_s, int lane) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) d[mt][nt][0] = d[mt][nt][1] = d[mt][nt][2] = d[mt][nt][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        unsigned b[4];
        b_rows(b, k_s, nt, kp, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(d[mt][nt], qa[mt][2 * kp], b[0], b[1]);
          mma16816(d[mt][nt], qa[mt][2 * kp + 1], b[2], b[3]);
        }
      }
    }
  }
  // the B fragments of n8 tiles 2j and 2j + 1 of V
  static __device__ __forceinline__ void v_frags(unsigned (&vb)[4], const bf16* v_s, int j, float,
                                                 int lane) {
    b_cols(vb, v_s, 0, j, lane);
  }
};

template <> struct Tc<int8_t> {
  using QFrag = unsigned[2][4];
  static constexpr int kChunk = kTcChunk * kDH;
  static __device__ __forceinline__ void q_frags(QFrag& qa, const int8_t* q, size_t pitch,
                                                 int r0, int valid, int lane) {
    a_rows64_i8(qa, q, pitch, r0, valid, lane);
  }
  static __device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, size_t pitch,
                                               int valid, int lane) {
    stage_rows64_i8(dst, src, pitch, valid, lane);
  }
  // exact int32 dot products on the int8 tensor cores, as float
  template <int MT>
  static __device__ __forceinline__ void dots(float (&d)[MT][2][4], const QFrag (&qa)[MT],
                                              const int8_t* k_s, int lane) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned b[4];
      ldsm_x4(b, k_s + swz64(nt * 8 + (lane & 7), (lane >> 3) * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        int c[4] = {0, 0, 0, 0};
        mma16832_s8(c, qa[mt][0], b[0], b[1]);
        mma16832_s8(c, qa[mt][1], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][nt][e] = __int2float_rn(c[e]);
      }
    }
  }
  // (v * sv) rounded to bf16, as the B fragments of n8 tiles 2j and 2j + 1
  static __device__ __forceinline__ void v_frags(unsigned (&vb)[4], const int8_t* v_s, int j,
                                                 float sv, int lane) {
    const int g = lane >> 2, t = lane & 3;
    auto vf = [&](int key, int d) { return __fmul_rn(float(v_s[swz64(key, d)]), sv); };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = (2 * j + h) * 8 + g;
      vb[2 * h] = pack_bf16(vf(2 * t, d), vf(2 * t + 1, d));
      vb[2 * h + 1] = pack_bf16(vf(2 * t + 8, d), vf(2 * t + 9, d));
    }
  }
};

}  // namespace
