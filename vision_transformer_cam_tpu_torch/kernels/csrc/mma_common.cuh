// Tensor-core and asynchronous-copy building blocks for sm_90a, shared by the
// bf16 kernels: 16-byte cp.async copies into shared memory, ldmatrix fragment
// loads (plain and transposed), the m16n8k16 bf16 mma.sync with float32
// accumulators, and an exponential that flushes float32 denormals to zero.
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
// bank groups.

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

// The A fragments (four k16 steps) of rows r0 + g and r0 + g + 8 of a
// [rows][64] bf16 slab in device memory, row pitch `pitch`; rows >= `valid`
// are zero.
__device__ __forceinline__ void a_rows64(unsigned (&a)[4][4], const bf16* __restrict__ src,
                                         size_t pitch, int r0, int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool lo = r0 + g < valid, hi = r0 + g + 8 < valid;
  const unsigned* plo = reinterpret_cast<const unsigned*>(src + size_t(r0 + g) * pitch);
  const unsigned* phi = reinterpret_cast<const unsigned*>(src + size_t(r0 + g + 8) * pitch);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = lo ? __ldg(plo + kk * 8 + t) : 0u;
    a[kk][1] = hi ? __ldg(phi + kk * 8 + t) : 0u;
    a[kk][2] = lo ? __ldg(plo + kk * 8 + 4 + t) : 0u;
    a[kk][3] = hi ? __ldg(phi + kk * 8 + 4 + t) : 0u;
  }
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
