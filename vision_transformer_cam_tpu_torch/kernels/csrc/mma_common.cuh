// Tensor-core and asynchronous-copy building blocks for sm_90a, shared by the
// tensor-core kernels: 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads (plain and transposed, bf16 and int8 tiles), the m16n8k16
// bf16 mma.sync with float32 accumulators, the m16n8k32 s8 mma.sync with
// int32 accumulators, and an exponential that flushes float32 denormals to
// zero.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                           a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n)       b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16 x 8, float32)     c0, c1 = C[g][2t..2t+1]   c2, c3 = C[g+8][2t..2t+1]
// Two C tiles side by side (columns 0-7 and 8-15) are, rounded to bf16 and
// packed in pairs, the A fragment of a product over those 16 columns: this
// is how a row block of probabilities feeds the next product without leaving
// registers.
//
// Tiles staged for ldmatrix are [rows][64] bf16 (128 bytes a row, eight
// 16-byte segments), with segment s of row r stored at s ^ (r % 8): the eight
// rows an ldmatrix reads for one 8 x 8 matrix then lie in eight different
// bank groups.  A tile of another width (kernel 1's head width 80: 160 bytes,
// ten segments) is not swizzled but padded to an odd number of segments a
// row (BfTile: 176 bytes, eleven), which puts the eight rows in eight bank
// groups too.  A width that is no multiple of 16 (40) is staged as whole
// k16 steps (48 columns, zeros past 40), so that every product over it runs
// k16 steps whose extra columns add exact zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
// the same copy of 8 bytes (src and smem 8-byte aligned: int8 rows of a head
// width that is no multiple of 16)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element offset of (row, column) in a swizzled [rows][64] bf16 tile
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// Stage ROWS rows of 64 bf16 (src rows of pitch `pitch` elements, row r at
// src + r * pitch) into a swizzled tile by THREADS threads, thread `id`
// among them; rows >= `valid` are zero-filled.  src must be 16-byte aligned
// and pitch a multiple of 8.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows64(bf16* dst, const bf16* __restrict__ src,
                                             size_t pitch, int valid, int id) {
  static_assert(ROWS * 8 % THREADS == 0, "whole segments per thread");
#pragma unroll
  for (int j = 0; j < ROWS * 8 / THREADS; ++j) {
    const int seg = id + j * THREADS, r = seg >> 3, s = seg & 7;
    const bool ok = r < valid;
    cp_async16(dst + swz(r, s * 8), src + (ok ? size_t(r) * pitch + s * 8 : 0), ok ? 16 : 0);
  }
}

// columns of a head of width dh in whole k16 steps (zeros past dh)
__host__ __device__ constexpr int k16_width(int dh) { return (dh + 15) / 16 * 16; }

// A bf16 tile of DH columns staged for ldmatrix: the swizzled [rows][64]
// tile at DH = 64, else rows of kPitch elements, an odd number of 16-byte
// segments, unswizzled (16: 24, 32: 40, 40: 56, 80: 88), whose kWidth
// columns are whole k16 steps, zero past DH.
template <int DH> struct BfTile {
  static_assert(DH % 8 == 0, "whole 16-byte segments");
  static constexpr int kWidth = k16_width(DH);
  static constexpr bool kSwizzled = DH == 64;
  static constexpr int kPitch = kSwizzled ? 64 : (kWidth / 8) % 2 ? kWidth : kWidth + 8;
  static __device__ __forceinline__ int at(int row, int col) {
    if constexpr (kSwizzled) return swz(row, col);
    else return row * kPitch + col;
  }
};

// Stage ROWS rows of DH bf16 into a BfTile<DH> as stage_rows64 does (which
// it is at DH = 64); the columns past DH are zero-filled.
template <int ROWS, int THREADS, int DH>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           size_t pitch, int valid, int id) {
  if constexpr (DH == 64) {
    stage_rows64<ROWS, THREADS>(dst, src, pitch, valid, id);
  } else {
    constexpr bool kPad = BfTile<DH>::kWidth != DH;
    constexpr int kSegs = BfTile<DH>::kWidth / 8, kTotal = ROWS * kSegs;
#pragma unroll
    for (int j = 0; j < (kTotal + THREADS - 1) / THREADS; ++j) {
      const int seg = id + j * THREADS, r = seg / kSegs, s = seg % kSegs;
      if (kTotal % THREADS != 0 && seg >= kTotal) break;
      const bool ok = r < valid && (!kPad || s < DH / 8);
      cp_async16(dst + BfTile<DH>::at(r, s * 8), src + (ok ? size_t(r) * pitch + s * 8 : 0),
                 ok ? 16 : 0);
    }
  }
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The B fragments of a product with a swizzled [rows][64] tile X:
//   b_rows: B[k = column][n = row], n8 tile of rows 8*nt.., columns 32*kp..
//           +31 -> r[0..1] for k16 step 2*kp, r[2..3] for step 2*kp + 1
//   b_cols: B[k = row][n = column], k16 rows 16*kt.., n8 tiles of columns
//           16*np.. and 16*np + 8.. -> r[0..1] and r[2..3]
__device__ __forceinline__ void b_rows(unsigned (&r)[4], const bf16* x, int nt, int kp,
                                       int lane) {
  const int i = lane >> 3, row = nt * 8 + (lane & 7);
  ldmatrix_x4(r, x + swz(row, kp * 32 + i * 8));
}
__device__ __forceinline__ void b_cols(unsigned (&r)[4], const bf16* x, int kt, int np,
                                       int lane) {
  const int i = lane >> 3, row = kt * 16 + (i & 1) * 8 + (lane & 7);
  ldmatrix_x4_trans(r, x + swz(row, np * 16 + (i >> 1) * 8));
}

// b_rows and b_cols on a BfTile<DH> (b_rows and b_cols themselves at 64)
template <int DH>
__device__ __forceinline__ void b_rows_w(unsigned (&r)[4], const bf16* x, int nt, int kp,
                                         int lane) {
  const int i = lane >> 3, row = nt * 8 + (lane & 7);
  ldmatrix_x4(r, x + BfTile<DH>::at(row, kp * 32 + i * 8));
}
template <int DH>
__device__ __forceinline__ void b_cols_w(unsigned (&r)[4], const bf16* x, int kt, int np,
                                         int lane) {
  const int i = lane >> 3, row = kt * 16 + (i & 1) * 8 + (lane & 7);
  ldmatrix_x4_trans(r, x + BfTile<DH>::at(row, np * 16 + (i >> 1) * 8));
}
// The B fragments of the last k16 step of a tile whose kWidth is 32 j + 16
// (columns kWidth - 16..kWidth - 1), rows of both n8 tiles: r[0..1] for
// rows 0-7, r[2..3] for rows 8-15.
template <int DH>
__device__ __forceinline__ void b_rows_tail(unsigned (&r)[4], const bf16* x, int lane) {
  const int i = lane >> 3, row = (i >> 1) * 8 + (lane & 7);
  ldmatrix_x4(r, x + BfTile<DH>::at(row, BfTile<DH>::kWidth - 16 + (i & 1) * 8));
}

// four 8 x 16-byte matrices of any element type (int8 tiles): lane l gets
// the 32-bit word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// two of them: lanes 0-7 and 8-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a b on the int8 tensor cores over 16 columns, exact int32 sums
// (m16n8k16: a0 = A[g][4t..4t+3], a1 = A[g+8][4t..4t+3]; B 16 x 8 held as
// [n][k], b0 = B[n=g][4t..4t+3]; C as for m16n8k16 bf16)
__device__ __forceinline__ void mma16816_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// c += a b on the int8 tensor cores, exact int32 sums (m16n8k32: A 16 x 32
// row major, a0 = A[g][4t..4t+3], a1 = A[g+8][..], a2 = A[g][16+4t..],
// a3 = A[g+8][16+4t..]; B 32 x 8 held as [n][k], b0 = B[n=g][4t..4t+3],
// b1 = B[g][16+4t..]; C as for m16n8k16)
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                            unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on the tensor cores
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment of rows g, g+8 of a [16][16] block held as two C tiles.
__device__ __forceinline__ void a_from_c(unsigned (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragments (KS k16 steps) of rows r0 + g and r0 + g + 8 of a
// [rows][16 KS] bf16 slab in device memory, row pitch `pitch`; rows >=
// `valid` are zero.  a_rows64: the four of a head of width 64.
template <int KS>
__device__ __forceinline__ void a_rows(unsigned (&a)[KS][4], const bf16* __restrict__ src,
                                       size_t pitch, int r0, int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool lo = r0 + g < valid, hi = r0 + g + 8 < valid;
  const unsigned* plo = reinterpret_cast<const unsigned*>(src + size_t(r0 + g) * pitch);
  const unsigned* phi = reinterpret_cast<const unsigned*>(src + size_t(r0 + g + 8) * pitch);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = lo ? __ldg(plo + kk * 8 + 4 + t) : 0u;
    a[kk][3] = hi ? __ldg(phi + kk * 8 + 4 + t) : 0u;
  }
}
// a_rows over a head of DH columns in whole k16 steps (BfTile<DH>::kWidth):
// a_rows itself where DH is a multiple of 16, else the last step's columns
// past DH (a[.][2..3]) are zero and never read.
template <int DH>
__device__ __forceinline__ void a_rows_w(unsigned (&a)[k16_width(DH) / 16][4],
                                         const bf16* __restrict__ src, size_t pitch, int r0,
                                         int valid, int lane) {
  if constexpr (DH % 16 == 0) {
    a_rows<DH / 16>(a, src, pitch, r0, valid, lane);
  } else {
    static_assert(DH % 16 == 8, "a last step of 8 columns");
    const int g = lane >> 2, t = lane & 3;
    const bool lo = r0 + g < valid, hi = r0 + g + 8 < valid;
    const unsigned* plo = reinterpret_cast<const unsigned*>(src + size_t(r0 + g) * pitch);
    const unsigned* phi = reinterpret_cast<const unsigned*>(src + size_t(r0 + g + 8) * pitch);
#pragma unroll
    for (int kk = 0; kk < k16_width(DH) / 16; ++kk) {
      const bool whole = kk < DH / 16;
      a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
      a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
      a[kk][2] = lo && whole ? __ldg(plo + kk * 8 + 4 + t) : 0u;
      a[kk][3] = hi && whole ? __ldg(phi + kk * 8 + 4 + t) : 0u;
    }
  }
}
__device__ __forceinline__ void a_rows64(unsigned (&a)[4][4], const bf16* __restrict__ src,
                                         size_t pitch, int r0, int valid, int lane) {
  a_rows<4>(a, src, pitch, r0, valid, lane);
}

// max and sum over the four lanes that hold one row of a C fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(x) with results below 2^-126 (float32 denormals) flushed to zero, as
// the TPU flushes them; the flushed range never reaches expf, whose slow path
// a denormal result would take.
__device__ __forceinline__ float exp_ftz(float x) {
  if (x < -87.34f) return 0.f;
  const float e = expf(x);
  return e < 1.17549435e-38f ? 0.f : e;
}
__device__ __forceinline__ float ftz(float x) { return fabsf(x) < 1.17549435e-38f ? 0.f : x; }

}  // namespace
