// A tile GEMM for one thread block, shared by the fused MLP (mlp_fused.cu) and
// the fused attention block (attention_block.cu).
//
// A block of kGT = 256 threads owns kGM = 32 rows and computes, for one tile
// of BN output columns, acc[r][c] += sum_k A[r][k] * W[row_of(c)][k]: the
// weight is read in the torch layout [out, in] (k contiguous), so no
// transposed copy of it is ever made.  K is walked in chunks of kGK = 32,
// staged in shared memory, and a thread keeps TM * 12 accumulators in
// registers: BN = 384 for TM = 4, 192 for TM = 2.  Two paths, by element type:
//
//   float32   f32 FMAs on the CUDA cores.  The chunks are staged as float32,
//             W k-major; a thread owns a TM x 12 block of the tile and makes
//             TM + 12 16-byte shared loads per four k for 48 * TM FMAs (the 16
//             lanes of a half warp read 16 neighbouring 48-byte pieces of a W
//             row, both half warps the same ones; every A load a broadcast).
//   bfloat16  mma.sync.m16n8k16 on the tensor cores, f32 accumulators.  The
//             chunks are staged as they lie in device memory ([row][k] for A
//             and for W, the "row.col" operand order of mma.sync) by
//             16-byte cp.async copies into two buffers, so the next chunk
//             loads while this one is multiplied; rows are padded to 40
//             elements, which makes every fragment load conflict free.  A
//             warp owns all 32 rows and BN / 8 columns.
//
// The fused MLP's bf16 products ran here until its Hopper design
// (mlp_fused_wgmma.cu); they still do for its earlier design, which stays
// behind the private switch kernels.gemm._mlp_bf16_design = "mma", and for
// the shapes the new design does not take.
//
// Frag<TM, T> says which element of the tile an accumulator is, so callers
// write one epilogue for both.  Ragged rows, columns and k are staged as
// zeros, so no shape needs to be a multiple of anything; where the row pitch
// or an offset is not a multiple of the vector width, elements are staged one
// by one.

#pragma once

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kGT = 256;              // threads of the block
constexpr int kGM = 32;               // rows of the block's tile
constexpr int kGK = 32;               // k per staged chunk
constexpr int kGTN = 12;              // accumulators per thread and TM
constexpr int kGAStride = kGK + 4;    // f32 path: float4-aligned, conflict-free rows
constexpr int kHStride = kGK + 8;     // bf16 path: staged rows, in elements

template <int TM> struct Tile {
  static constexpr int kRowGroups = kGM / TM;
  static constexpr int kColGroups = kGT / kRowGroups;
  static constexpr int kBN = kColGroups * kGTN;     // 384 (TM = 4), 192 (TM = 2)
  static constexpr int kBStride = kBN + 4;          // f32 path, k-major W chunk
  static constexpr int kNT = TM * kGTN / 8;         // bf16 path: n8 tiles per warp
  // f32 path, thread -> (row group, column group): a half warp spans 16 column
  // groups of one row group
  __device__ static int tx() {
    return (threadIdx.x & 15) + 16 * ((threadIdx.x >> 5) % (kColGroups / 16));
  }
  __device__ static int ty() {
    return ((threadIdx.x >> 5) / (kColGroups / 16)) * 2 + ((threadIdx.x >> 4) & 1);
  }
};

// Row and column, inside the 32 x BN tile, of accumulator e < TM * 12.
template <int TM, typename T> struct Frag {           // f32 path: a TM x 12 block
  __device__ static int row(int e) { return Tile<TM>::ty() * TM + e / kGTN; }
  __device__ static int col(int e) { return Tile<TM>::tx() * kGTN + e % kGTN; }
};
template <int TM> struct Frag<TM, __nv_bfloat16> {    // the m16n8 C fragments
  // e = (m tile * kNT + n tile) * 4 + register
  __device__ static int row(int e) {
    return (e / (4 * Tile<TM>::kNT)) * 16 + ((threadIdx.x & 31) >> 2) + ((e & 2) ? 8 : 0);
  }
  __device__ static int col(int e) {
    return (threadIdx.x >> 5) * Tile<TM>::kNT * 8 + ((e / 4) % Tile<TM>::kNT) * 8 +
           (threadIdx.x & 3) * 2 + (e & 1);
  }
};

// bytes of staging a GEMM of this type and tile needs
template <typename T, int TM> __host__ __device__ constexpr int stage_bytes() {
  return sizeof(T) == 2 ? 2 * (kGM + Tile<TM>::kBN) * kHStride * 2
                        : (kGM * kGAStride + kGK * Tile<TM>::kBStride) * 4;
}
// elements between the rows of an A operand kept in shared memory (T [32][K])
template <typename T> __host__ __device__ constexpr int a_pad() {
  return sizeof(T) == 2 ? 8 : 4;
}

// ---------------------------------------------------------------------------
// float32 path
// ---------------------------------------------------------------------------

// Four consecutive elements p[0..3] of a row that holds `left` more elements
// from p on (zeros past it).
__device__ __forceinline__ float4 load4(const float* p, int left, bool vec) {
  if (vec && left >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = p[0];
  if (left > 1) v.y = p[1];
  if (left > 2) v.z = p[2];
  if (left > 3) v.w = p[3];
  return v;
}

// a_s[r][k] = A[(row0 + r) * lda + k0 + k] for r < kGM, k < kGK; zero for rows
// >= rows_end and k >= k_end.  One 4-element piece per thread.
__device__ __forceinline__ void stage_a(float* a_s, const float* __restrict__ a, int lda,
                                        int row0, int rows_end, int k0, int k_end) {
  const int r = threadIdx.x / (kGK / 4), k = (threadIdx.x % (kGK / 4)) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row0 + r < rows_end)
    v = load4(a + size_t(row0 + r) * lda + k0 + k, k_end - (k0 + k),
              (lda & 3) == 0 && (k0 & 3) == 0);
  *reinterpret_cast<float4*>(a_s + r * kGAStride + k) = v;
}

// b_s[k][c] = W[row_of(c) * ldw + k0 + k] for c < BN, k < kGK; row_of(c) < 0
// marks a column past the edge (zeros), as does k >= k_end.  Lanes walk the
// columns, so the shared stores are conflict free; the 4-element pieces of
// one weight row are read by the same lane in consecutive steps.
template <int TM, typename RowOf>
__device__ __forceinline__ void stage_b(float* b_s, const float* __restrict__ w, int ldw,
                                        RowOf row_of, int k0, int k_end) {
  constexpr int kBN = Tile<TM>::kBN, kStride = Tile<TM>::kBStride;
  const bool vec = (ldw & 3) == 0 && (k0 & 3) == 0;
#pragma unroll
  for (int it = 0; it < kBN * (kGK / 4) / kGT; ++it) {
    const int idx = threadIdx.x + it * kGT;
    const int c = idx % kBN, k = (idx / kBN) * 4;
    const int row = row_of(c);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0) v = load4(w + size_t(row) * ldw + k0 + k, k_end - (k0 + k), vec);
    b_s[(k + 0) * kStride + c] = v.x;
    b_s[(k + 1) * kStride + c] = v.y;
    b_s[(k + 2) * kStride + c] = v.z;
    b_s[(k + 3) * kStride + c] = v.w;
  }
}

// acc += A chunk (a_s, rows of pitch a_stride, k contiguous) x W chunk (b_s);
// with ROWS = 16 the threads of rows 16-31 (warps 4-7 at TM = 4) skip it,
// their accumulators left as they are
template <int TM, int ROWS = kGM>
__device__ __forceinline__ void tile_fma(float (&acc)[TM * kGTN], const float* a_s,
                                         int a_stride, const float* b_s) {
  constexpr int kStride = Tile<TM>::kBStride;
  if constexpr (ROWS < kGM) {
    if (Tile<TM>::ty() * TM >= ROWS) return;
  }
  const float* a_row = a_s + Tile<TM>::ty() * TM * a_stride;
  const float* b_col = b_s + Tile<TM>::tx() * kGTN;
#pragma unroll 2
  for (int k = 0; k < kGK; k += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(a_row + i * a_stride + k);
      a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[kGTN];
#pragma unroll
      for (int j4 = 0; j4 < kGTN / 4; ++j4) {
        const float4 v =
            *reinterpret_cast<const float4*>(b_col + (k + kk) * kStride + j4 * 4);
        b[j4 * 4 + 0] = v.x, b[j4 * 4 + 1] = v.y, b[j4 * 4 + 2] = v.z, b[j4 * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kGTN; ++j)
          acc[i * kGTN + j] = fmaf(a[i][kk], b[j], acc[i * kGTN + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path
// ---------------------------------------------------------------------------

// dst[0..8) = src[0..8) where the row holds `left` more elements (zeros past
// it; all zeros for src == nullptr): one 16-byte asynchronous copy where the
// address allows it, else element by element.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int left, bool vec) {
  left = src == nullptr ? 0 : min(max(left, 0), 8);
  if (vec && left > 0) {
    cp_async16(dst, src, left * 2);   // the copy zero-fills past src_bytes
    return;
  }
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = j < left ? src[j] : __float2bfloat16(0.f);
}

// a_s[r][k] = A[(row0 + r) * lda + k0 + k], rows of kHStride elements
__device__ __forceinline__ void stage_a(bf16* a_s, const bf16* __restrict__ a, int lda,
                                        int row0, int rows_end, int k0, int k_end) {
  if (threadIdx.x >= kGM * (kGK / 8)) return;
  const int r = threadIdx.x / (kGK / 8), k = (threadIdx.x % (kGK / 8)) * 8;
  const bf16* src = row0 + r < rows_end ? a + size_t(row0 + r) * lda + k0 + k : nullptr;
  stage8(a_s + r * kHStride + k, src, k_end - (k0 + k), (lda & 7) == 0 && (k0 & 7) == 0);
}

// b_s[c][k] = W[row_of(c) * ldw + k0 + k], rows of kHStride elements: W as it
// lies in device memory, four 16-byte pieces per row
template <int TM, typename RowOf>
__device__ __forceinline__ void stage_b(bf16* b_s, const bf16* __restrict__ w, int ldw,
                                        RowOf row_of, int k0, int k_end) {
  constexpr int kBN = Tile<TM>::kBN;
  const bool vec = (ldw & 7) == 0 && (k0 & 7) == 0;
#pragma unroll
  for (int it = 0; it < kBN * (kGK / 8) / kGT; ++it) {
    const int idx = threadIdx.x + it * kGT;
    const int c = idx / (kGK / 8), k = (idx % (kGK / 8)) * 8;
    const int row = row_of(c);
    const bf16* src = row >= 0 ? w + size_t(row) * ldw + k0 + k : nullptr;
    stage8(b_s + c * kHStride + k, src, k_end - (k0 + k), vec);
  }
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc += A chunk (a_s[r][k], rows of pitch a_stride) x W chunk (b_s[c][k]):
// ROWS / 16 m16 tiles (two, or the first alone) by kNT n8 tiles per warp,
// two k16 steps
template <int TM, int ROWS = kGM>
__device__ __forceinline__ void tile_mma(float (&acc)[TM * kGTN], const bf16* a_s,
                                         int a_stride, const bf16* b_s) {
  constexpr int kNT = Tile<TM>::kNT, kMT = ROWS / 16;
  static_assert(ROWS == 16 || ROWS == kGM, "one or two m16 tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const bf16* b_warp = b_s + ((threadIdx.x >> 5) * kNT * 8 + g) * kHStride + tig * 2;
#pragma unroll
  for (int kk = 0; kk < kGK; kk += 16) {
    unsigned a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const bf16* p = a_s + (mt * 16 + g) * a_stride + kk + tig * 2;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * a_stride);
      a[mt][2] = ld32(p + 8);
      a[mt][3] = ld32(p + 8 * a_stride + 8);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const unsigned b0 = ld32(b_warp + nt * 8 * kHStride + kk);
      const unsigned b1 = ld32(b_warp + nt * 8 * kHStride + kk + 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float* c = acc + (mt * kNT + nt) * 4;
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b0), "r"(b1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the two GEMM loops; every thread of the block must call them.  ROWS = 16:
// only the tile's first 16 rows are wanted (the products of the others are
// skipped, their accumulators stay zero or partial, and the caller drops
// them); A is still staged as 32 rows from device memory.
// ---------------------------------------------------------------------------

// acc += A[row0.., 0..K) x W[row_of(c), 0..K)^T, A read from device memory.
// `stage` holds stage_bytes<T, TM>() bytes, 16-byte aligned.
template <int TM, int ROWS = kGM, typename T, typename RowOf>
__device__ __forceinline__ void gemm_global_a(float (&acc)[TM * kGTN], const T* __restrict__ a,
                                              int lda, int row0, int rows_end,
                                              const T* __restrict__ w, int ldw, RowOf row_of,
                                              int K, void* stage) {
  if constexpr (sizeof(T) == 2) {
    constexpr int kBuf = (kGM + Tile<TM>::kBN) * kHStride;
    bf16* buf = static_cast<bf16*>(stage);
    __syncthreads();   // the caller's use of the staging is over
    stage_a(buf, a, lda, row0, rows_end, 0, K);
    stage_b<TM>(buf + kGM * kHStride, w, ldw, row_of, 0, K);
    cp_async_commit();
    for (int k0 = 0, i = 0; k0 < K; k0 += kGK, ++i) {
      bf16* cur = buf + (i & 1) * kBuf;
      if (k0 + kGK < K) {
        bf16* nxt = buf + ((i + 1) & 1) * kBuf;
        stage_a(nxt, a, lda, row0, rows_end, k0 + kGK, K);
        stage_b<TM>(nxt + kGM * kHStride, w, ldw, row_of, k0 + kGK, K);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tile_mma<TM, ROWS>(acc, cur, kHStride, cur + kGM * kHStride);
      __syncthreads();   // before the chunk after next overwrites this buffer
    }
  } else {
    float* a_s = static_cast<float*>(stage);
    float* b_s = a_s + kGM * kGAStride;
    for (int k0 = 0; k0 < K; k0 += kGK) {
      __syncthreads();   // the previous chunk (or the caller's use) is consumed
      stage_a(a_s, a, lda, row0, rows_end, k0, K);
      stage_b<TM>(b_s, w, ldw, row_of, k0, K);
      __syncthreads();
      tile_fma<TM, ROWS>(acc, a_s, kGAStride, b_s);
    }
  }
}

// The same with A already in shared memory: a_sm[r][k] of type T for k < K
// rounded up to kGK (the caller keeps zeros past K), rows of pitch a_stride;
// W's k runs from w_k0 and ends at w_k_end.  Its first barrier also publishes
// a_sm.
template <int TM, int ROWS = kGM, typename T, typename RowOf>
__device__ __forceinline__ void gemm_shared_a(float (&acc)[TM * kGTN], const T* a_sm,
                                              int a_stride, const T* __restrict__ w, int ldw,
                                              RowOf row_of, int w_k0, int w_k_end, int K,
                                              void* stage) {
  if constexpr (sizeof(T) == 2) {
    constexpr int kBuf = (kGM + Tile<TM>::kBN) * kHStride;
    bf16* buf = static_cast<bf16*>(stage) + kGM * kHStride;
    __syncthreads();
    stage_b<TM>(buf, w, ldw, row_of, w_k0, w_k_end);
    cp_async_commit();
    for (int k0 = 0, i = 0; k0 < K; k0 += kGK, ++i) {
      if (k0 + kGK < K) {
        stage_b<TM>(buf + ((i + 1) & 1) * kBuf, w, ldw, row_of, w_k0 + k0 + kGK, w_k_end);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      tile_mma<TM, ROWS>(acc, a_sm + k0, a_stride, buf + (i & 1) * kBuf);
      __syncthreads();
    }
  } else {
    float* b_s = static_cast<float*>(stage) + kGM * kGAStride;
    for (int k0 = 0; k0 < K; k0 += kGK) {
      __syncthreads();
      stage_b<TM>(b_s, w, ldw, row_of, w_k0 + k0, w_k_end);
      __syncthreads();
      tile_fma<TM, ROWS>(acc, a_sm + k0, a_stride, b_s);
    }
  }
}

}  // namespace
