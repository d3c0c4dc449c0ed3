// The fused MLP kernels, fc2(gelu(fc1(x))) in one launch, in their Hopper
// design (sm_90a): 64-row tiles, a TMA ring of weight tiles and wgmma.  The
// kernel template and its launcher; mlp_fused_wgmma.cu instantiates it at 384
// output columns a consumer warpgroup and holds the C entry points,
// mlp_fused_wgmma_wide.cu at 256 and 320 (one nvcc process each).
//
// Replace the TPU kernels vision_transformer_cam_tpu/kernels/gemm.py:
// _mlp_kernel (mlp_fused) and _mlp_int8_kernel (mlp_fused_int8).  What they
// compute is that of mlp_fused.cu, whose design (32 rows a block, mma.sync)
// stays compiled beside this one:
//
//   bf16  h = gelu(x w1^T + b1) in float32 (f32 sums), rounded to bf16;
//         out = h w2^T + b2 in float32, then bf16.
//   int8  xq = clip(rint(x * inv_a1)); acc1 = xq . w1q (int32);
//         hq = clip(rint(gelu(acc1 * cs1 + b1) * inv_a2)); acc2 = hq . w2q;
//         out = acc2 * cs2 + b2.  The float steps are the device functions of
//         int8_common.cuh in the order of int8_gemm.cu, and integer sums are
//         exact, so the result is the chain of two fused-route int8 GEMM
//         launches bit for bit.
//
// In both the [M, HID] hidden tensor never reaches device memory.
//
// What bounds them on this card.  At ViT-B/16 (C = 768, HID = 3072) a block
// streams all of W1 and W2 (9.44 MB at bf16, 4.72 MB at int8) for its rows,
// so the weights are read from L2 once per block.  mlp_fused.cu's blocks own
// 32 rows: at B=64 (M = 12608) that is 3.72 GB of L2 reads per bf16 call,
// 32 FLOP per weight byte, and its times match that traffic at 2.2-2.8 TB/s:
// L2 traffic and latency set its pace, not arithmetic (119 G operations,
// 0.12 ms at the bf16 peak, 0.06 ms at the int8 one).  This design:
//
//   * 64 rows a block: half the L2 weight traffic (1.86 GB bf16, 0.93 GB
//     int8 at M = 12608).
//   * Three warpgroups (384 threads, one block an SM).  Warpgroup 0 gives up
//     its registers (setmaxnreg 24) and one of its threads issues TMA loads of
//     the weight tiles, in the order the consumers use them, into a ring of
//     24 KB stages guarded by full / empty mbarriers.  Warpgroups 1 and 2
//     (setmaxnreg 240) run wgmma on the stages that have arrived.
//   * x stays in shared memory for the whole walk: bf16 [64, C] by TMA, 96 KB
//     at C = 768; int8 loaded once by the consumers, quantized with the same
//     clip_rint(__fmul_rn(x, inv_a1)) and written swizzled, 48 KB.  The ring
//     takes what x and the h tiles leave of the 227 KB a block may hold, up
//     to 4 stages at bf16 and 6 at int8 (ring_stages): 4 / 6 to C = 768, 3 /
//     6 at 1024, 2 / 5 at 1280.  At least 2 must fit, which sets the widths
//     the design takes: C <= 1280 at bf16, <= 2688 at int8.
//   * HID is walked in chunks of 64.  fc1: each consumer warpgroup forms 32
//     of the chunk's 64 columns (wgmma m64n32, W1 tiles of [64, 3 x 128 B]
//     per stage), applies the epilogue in registers (bias, GELU, rounding to
//     bf16; or dequantize, bias, GELU, requantize) and writes them into a
//     double-buffered swizzled [64, 64] h tile; a named barrier over the 256
//     consumer threads publishes it.  fc2: each consumer warpgroup owns kNW
//     output columns and keeps their sums in registers for the whole walk
//     (two m64n(kNW / 2) accumulators: 192 registers a thread at kNW = 384);
//     the W2 tiles ([kNW / 2, 64] bf16, [kNW, 64] int8 per stage) pass
//     through the ring and each is multiplied by the warpgroup that owns its
//     rows.  No __syncthreads in the main loop.
//   * Column groups.  A block owns the 2 kNW output columns of its group
//     (blockIdx.y): to C = 768 one group of kNW = 384 covers C, and the
//     kernel is the one-group design bit for bit.  Past it the sums of all C
//     columns would not fit in the registers (256 KB at C = 1024), so C is
//     cut into groups of at most 768 columns: two of 512 (kNW = 256) at
//     C = 1024, two of 640 (kNW = 320) at 1280.  Each block runs fc1 over the
//     whole of HID for its rows, as at one group, and fc2 only for its
//     group's rows of W2, b2 and cs2: with two groups fc1 is computed twice,
//     1.5x the call's 4 M C HID operations.
//
// On an H100 (PERF.md, rows 6-7) the bf16 kernel then streams its weights
// from L2 at about 5.6-5.8 TB/s at M = 50432, near what L2 delivers, and int8
// spends as long on latency: the ring, not arithmetic, still sets the pace.
// Two variants read slower and were left out: a cluster of two blocks with
// the weight tiles multicast to both (every refill then waits for the slower
// block), and releasing a stage one wgmma group late (bf16 then has fewer
// stages in flight).
//
// Operands are K-major slabs with TMA's 128-byte swizzle (x, W1; and at bf16
// the h tile and W2, whose k extent, a chunk of 64, is 128 bytes) or 64-byte
// swizzle (the int8 h tile and W2: 64 bytes of k) -- see wgmma_common.cuh.
// Ragged M comes in as TMA's out-of-bounds zeros (bf16 x) or is zeroed by the
// quantizing loads (int8 x); columns past C read zero weights and are not
// stored.  Shapes: C a multiple of 64 up to the ring's limit above, HID a
// multiple of 64, x and the weights 16-byte aligned; kernels.gemm.mlp_design
// sends every other shape to mlp_fused.cu.  The launch fails for any other
// shape.

#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstring>

#include "int8_common.cuh"
#include "wgmma_common.cuh"

namespace {

using bf16_t = __nv_bfloat16;

constexpr int kRows = 64;                      // rows of x per block
constexpr int kThreads = 384;                  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kSpan = 128;                     // bytes of k in a slab of x or W1
constexpr int kSlabBytes = kRows * kSpan;      // one [64, 128 B] slab: 8 KB
constexpr int kChunk = 64;                     // hidden units per chunk
constexpr int kW1Slabs = 3;                    // W1 slabs per ring stage
constexpr int kStageBytes = kW1Slabs * kSlabBytes;   // 24 KB
constexpr int kGroupCols = 768;                // most output columns of a block
constexpr int kSmemBudget = 232448;            // shared memory a block may hold (sm_90)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kHBarrier = 1;                   // named barrier of the consumers

template <bool kInt8> struct Traits;
template <> struct Traits<false> {
  using Acc = float;
  static constexpr int kEsz = 2;
  static constexpr int kHSpan = kChunk * 2;    // bytes of k of the h tile and W2 tiles
  static constexpr int kMaxStages = 4;
};
template <> struct Traits<true> {
  using Acc = int;
  static constexpr int kEsz = 1;
  static constexpr int kHSpan = kChunk;
  static constexpr int kMaxStages = 6;
};

struct Params {
  const void* x;        // [M, C]: bf16 (bf16 kernel), float32 or bf16 (int8 kernel)
  const void* b1;       // [HID]: bf16; int8 kernel: float32 or null
  const void* b2;       // [C]: as b1
  const float* cs1;     // int8 kernel: combined scales [HID], [C]
  const float* cs2;
  const float* inv_a1;  // int8 kernel: one float each, on the device
  const float* inv_a2;
  void* out;            // [M, C]
  int M, C, HID, gelu_approx;
};

__host__ __device__ constexpr int x_slabs(int c, int esz) { return (c * esz + kSpan - 1) / kSpan; }

// shared memory besides the ring: alignment slack, x, the two h tiles, x's
// mbarrier
template <bool kInt8> __host__ __device__ constexpr size_t fixed_bytes(int c) {
  using Tr = Traits<kInt8>;
  return 1024 + size_t(x_slabs(c, Tr::kEsz)) * kSlabBytes + 2 * kRows * Tr::kHSpan +
         sizeof(uint64_t);
}
// a ring stage with its full and empty mbarriers
constexpr size_t kStageCost = kStageBytes + 2 * sizeof(uint64_t);

// ring stages at width c: as many as fit beside x, up to kMaxStages, and at
// least 2 (past the width where 2 fit, smem_bytes states what the launch
// would need and takes() refuses it)
template <bool kInt8> __host__ __device__ constexpr int ring_stages(int c) {
  const long fit = (long(kSmemBudget) - long(fixed_bytes<kInt8>(c))) / long(kStageCost);
  return fit < 2 ? 2 : fit > Traits<kInt8>::kMaxStages ? Traits<kInt8>::kMaxStages : int(fit);
}

template <bool kInt8> __host__ __device__ constexpr size_t smem_bytes(int c) {
  return fixed_bytes<kInt8>(c) + size_t(ring_stages<kInt8>(c)) * kStageCost;
}

// output columns a consumer warpgroup owns at width c: 384 (one group) to
// C = 768; past it the narrowest instance (256, 320, 384) whose groups of
// 2 nw columns cover C in as few groups as groups of 768 would
inline int group_nw(int c) {
  if (c <= kGroupCols) return kGroupCols / 2;
  const int groups = (c + kGroupCols - 1) / kGroupCols;
  const int need = (c + 2 * groups - 1) / (2 * groups);
  return need <= 256 ? 256 : need <= 320 ? 320 : 384;
}

template <bool kInt8> bool takes(int M, int C, int HID) {
  return M >= 1 && C >= 64 && C % 64 == 0 && HID >= 64 && HID % 64 == 0 &&
         smem_bytes<kInt8>(C) <= size_t(kSmemBudget);
}

__device__ __forceinline__ float to_f(bf16_t v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16(a), __float2bfloat16(b));
}

// eight consecutive elements of x as float
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16_t* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}

__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  wgmma_bf16_n32(d, a, b);
}
__device__ __forceinline__ void mma_n32(int (&d)[16], uint64_t a, uint64_t b) {
  wgmma_s8_n32(d, a, b);
}
// the fc2 product of one half of a warpgroup's columns, by its width: n192
// (kNW = 384), n128 (256), n160 (320)
__device__ __forceinline__ void mma_half(float (&d)[96], uint64_t a, uint64_t b) {
  wgmma_bf16_n192(d, a, b);
}
__device__ __forceinline__ void mma_half(int (&d)[96], uint64_t a, uint64_t b) {
  wgmma_s8_n192(d, a, b);
}
__device__ __forceinline__ void mma_half(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_bf16_n128(d, a, b);
}
__device__ __forceinline__ void mma_half(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_s8_n128(d, a, b);
}
__device__ __forceinline__ void mma_half(float (&d)[80], uint64_t a, uint64_t b) {
  wgmma_bf16_n160(d, a, b);
}
__device__ __forceinline__ void mma_half(int (&d)[80], uint64_t a, uint64_t b) {
  wgmma_s8_n160(d, a, b);
}

// acc (+)= h tile . W2 tile^T over one chunk of 64 hidden units: one wgmma
// per 32 bytes of k
template <int kHSpan, typename Acc, int kN>
__device__ __forceinline__ void fc2_tile(Acc (&acc)[kN], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kHSpan; kk += 32)
    mma_half(acc, slab_desc(a + kk, kHSpan), slab_desc(b + kk, kHSpan));
}

// 2 kN columns of out from one accumulator: thread rows r and r + 8, columns
// col0 + 8 n + {0, 1}; bf16 adds b2, int8 dequantizes with cs2 and adds b2
template <bool kInt8, typename Acc, int kN, typename OT>
__device__ __forceinline__ void store_out(const Acc (&acc)[kN], OT* out, const Params& p, int r,
                                          int col0) {
#pragma unroll
  for (int i = 0; i < kN; i += 2) {
    const int col = col0 + 8 * (i / 4), row = r + 8 * ((i / 2) % 2);
    if (col < p.C && row < p.M) {
      float y0, y1;
      if constexpr (kInt8) {
        const float* b2 = static_cast<const float*>(p.b2);
        y0 = __fmul_rn(__int2float_rn(acc[i]), p.cs2[col]);
        y1 = __fmul_rn(__int2float_rn(acc[i + 1]), p.cs2[col + 1]);
        if (b2 != nullptr) {
          y0 = __fadd_rn(y0, b2[col]);
          y1 = __fadd_rn(y1, b2[col + 1]);
        }
      } else {
        const bf16_t* b2 = static_cast<const bf16_t*>(p.b2);
        y0 = __fadd_rn(float(acc[i]), to_f(b2[col]));
        y1 = __fadd_rn(float(acc[i + 1]), to_f(b2[col + 1]));
      }
      store2(out + size_t(row) * p.C + col, y0, y1);
    }
    asm volatile("" ::: "memory");
  }
}

// The hidden chunk's epilogue, from this warpgroup's fc1 accumulators (the
// chunk's columns 32 wg .. 32 wg + 31) into the swizzled h tile: bf16 bias,
// GELU, rounding; int8 dequantize, bias, GELU, requantize.  Two columns at a
// time; the empty asm between pairs keeps the compiler from hoisting every
// pair's scale and bias loads at once beside the live fc2 accumulators.
template <bool kInt8, int kApprox, typename Acc>
__device__ __forceinline__ void hidden_epilogue(const Acc (&acc1)[16], unsigned char* hb,
                                                const Params& p, int hc, int wg, int w, int l,
                                                float inv_a2) {
  constexpr int kHSpan = Traits<kInt8>::kHSpan;
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const int col = 32 * wg + 8 * (i / 4) + 2 * (l % 4);   // in the chunk
    const int row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int hcol = hc + col;
    if constexpr (kInt8) {
      const float* b1 = static_cast<const float*>(p.b1);
      float y0 = __fmul_rn(__int2float_rn(acc1[i]), p.cs1[hcol]);
      float y1 = __fmul_rn(__int2float_rn(acc1[i + 1]), p.cs1[hcol + 1]);
      if (b1 != nullptr) {
        y0 = __fadd_rn(y0, b1[hcol]);
        y1 = __fadd_rn(y1, b1[hcol + 1]);
      }
      const int q0 = clip_rint(__fmul_rn(gelu(y0, kApprox), inv_a2));
      const int q1 = clip_rint(__fmul_rn(gelu(y1, kApprox), inv_a2));
      *reinterpret_cast<uint16_t*>(hb + swizzle(row * kHSpan + col, kHSpan)) =
          uint16_t((q0 & 0xff) | ((q1 & 0xff) << 8));
    } else {
      const bf16_t* b1 = static_cast<const bf16_t*>(p.b1);
      const float h0 = gelu(__fadd_rn(float(acc1[i]), to_f(b1[hcol])), kApprox);
      const float h1 = gelu(__fadd_rn(float(acc1[i + 1]), to_f(b1[hcol + 1])), kApprox);
      store2(reinterpret_cast<bf16_t*>(hb + swizzle(row * kHSpan + 2 * col, kHSpan)), h0, h1);
    }
    asm volatile("" ::: "memory");
  }
}

// kNW: output columns of a consumer warpgroup, a block's group 2 kNW
template <bool kInt8, int kNW, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map,
                 const __grid_constant__ CUtensorMap x_map, const Params p) {
  using Tr = Traits<kInt8>;
  using Acc = typename Tr::Acc;
  constexpr int kN = kNW / 2;                          // columns of one fc2 wgmma
  constexpr int kW2Rows = kInt8 ? kNW : kN;            // W2 rows per ring stage
  constexpr int kW2Bytes = kW2Rows * Tr::kHSpan;
  static_assert(kW2Bytes <= kStageBytes, "W2 stage");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* x_s = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int stages = ring_stages<kInt8>(p.C);
  const int nk1 = x_slabs(p.C, Tr::kEsz);              // slabs of x and of a W1 chunk
  const int n1 = (nk1 + kW1Slabs - 1) / kW1Slabs;      // W1 stages per chunk
  const int col0 = blockIdx.y * 2 * kNW;               // the block's column group
  const int n2 = (min(2 * kNW, p.C - col0) + kW2Rows - 1) / kW2Rows;   // W2 stages per chunk
  unsigned char* h_s = x_s + nk1 * kSlabBytes;         // 2 x [64, kHSpan]
  unsigned char* ring = h_s + 2 * kRows * Tr::kHSpan;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint64_t* x_bar = empty + stages;
  const int row0 = blockIdx.x * kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);   // every consumer warp arrives
    }
    mbar_init(x_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler (a shuffle from
  // lane 0), so that no wgmma sits on a path it must treat as divergent
  const int wg_all = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg_all == 0) {
    // ---- producer: one thread issues every TMA load ----
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&w1_map);
      tma_prefetch_map(&w2_map);
      if constexpr (!kInt8) {
        mbar_expect_tx(x_bar, nk1 * kSlabBytes);
        for (int s = 0; s < nk1; ++s)
          tma_load_2d(x_s + s * kSlabBytes, &x_map, x_bar, s * (kSpan / 2), row0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int hc = 0; hc < p.HID; hc += kChunk) {
        for (int u = 0; u < n1; ++u) {
          mbar_wait(&empty[stage], phase ^ 1);
          const int slabs = min(kW1Slabs, nk1 - u * kW1Slabs);
          mbar_expect_tx(&full[stage], slabs * kSlabBytes);
          for (int s = 0; s < slabs; ++s)
            tma_load_2d(ring + stage * kStageBytes + s * kSlabBytes, &w1_map, &full[stage],
                        (u * kW1Slabs + s) * (kSpan / Tr::kEsz), hc);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
        for (int u = 0; u < n2; ++u) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kW2Bytes);
          for (int i = 0; i < kW2Rows / kN; ++i)
            tma_load_2d(ring + stage * kStageBytes + i * kN * Tr::kHSpan, &w2_map,
                        &full[stage], hc, col0 + u * kW2Rows + i * kN);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: warpgroups 1 and 2 ----
    reg_alloc<kConsumerRegs>();
    const int wg = wg_all - 1;                          // 0 or 1
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    const int ct = threadIdx.x - 128;                   // 0 .. 255

    if constexpr (kInt8) {
      // x of the block's rows, quantized once, eight k a thread and step;
      // zeros past M and past C
      const XT* x = static_cast<const XT*>(p.x);
      const float inv_a1 = *p.inv_a1;
      const int pieces = nk1 * (kSpan / 8);
      for (int idx = ct; idx < kRows * pieces; idx += kConsumerThreads) {
        const int r = idx / pieces, k = (idx % pieces) * 8;
        int lo = 0, hi = 0;
        if (row0 + r < p.M && k < p.C) {
          float v[8];
          load8(x + size_t(row0 + r) * p.C + k, v);
          int q[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) q[i] = clip_rint(__fmul_rn(v[i], inv_a1));
          lo = pack4(q[0], q[1], q[2], q[3]);
          hi = pack4(q[4], q[5], q[6], q[7]);
        }
        *reinterpret_cast<int2*>(x_s + (k / kSpan) * kSlabBytes +
                                 swizzle(r * kSpan + k % kSpan, kSpan)) = make_int2(lo, hi);
      }
      fence_proxy_async();
      named_barrier_sync<kConsumerThreads>(kHBarrier);
    } else {
      mbar_wait(x_bar, 0);
    }

    const uint32_t x_addr = smem_u32(x_s), h_addr = smem_u32(h_s), ring_addr = smem_u32(ring);
    const float inv_a2 = kInt8 ? *p.inv_a2 : 0.f;
    // fc2 sums of the warpgroup's columns col0 + kNW wg .. + kN - 1 and
    // + kN .. + kNW - 1
    Acc acc_lo[kN / 2], acc_hi[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc_lo[i] = acc_hi[i] = Acc(0);
    int stage = 0;
    uint32_t phase = 0;

    for (int hc = 0, j = 0; hc < p.HID; hc += kChunk, ++j) {
      // fc1: this warpgroup's 32 columns of the chunk
      Acc acc1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc1[i] = Acc(0);
      for (int u = 0; u < n1; ++u) {
        mbar_wait(&full[stage], phase);
        const int slabs = min(kW1Slabs, nk1 - u * kW1Slabs);
        wgmma_fence();
        for (int s = 0; s < slabs; ++s) {
          const uint32_t a = x_addr + (u * kW1Slabs + s) * kSlabBytes;
          const uint32_t b = ring_addr + stage * kStageBytes + s * kSlabBytes + wg * 32 * kSpan;
#pragma unroll
          for (int kk = 0; kk < kSpan; kk += 32)
            mma_n32(acc1, slab_desc(a + kk, kSpan), slab_desc(b + kk, kSpan));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1);
        if (l == 0) mbar_arrive(&empty[stage]);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      }

      // the chunk's epilogue in registers, into h tile j % 2
      unsigned char* hb = h_s + (j & 1) * kRows * Tr::kHSpan;
      if (p.gelu_approx)
        hidden_epilogue<kInt8, 1>(acc1, hb, p, hc, wg, w, l, inv_a2);
      else
        hidden_epilogue<kInt8, 0>(acc1, hb, p, hc, wg, w, l, inv_a2);
      fence_proxy_async();
      named_barrier_sync<kConsumerThreads>(kHBarrier);

      // fc2: every W2 stage of the group passes; the warpgroup owning its
      // rows multiplies
      const uint32_t a_base = h_addr + (j & 1) * kRows * Tr::kHSpan;
#pragma unroll
      for (int u = 0; u < 2 * kNW / kW2Rows; ++u) {
        if (u < n2) {
          mbar_wait(&full[stage], phase);
          if ((u * kW2Rows) / kNW == wg) {
            const uint32_t b = ring_addr + stage * kStageBytes;
            wgmma_fence();
            if constexpr (kInt8) {           // a stage holds both of the owner's halves
              fc2_tile<Tr::kHSpan>(acc_lo, a_base, b);
              fc2_tile<Tr::kHSpan>(acc_hi, a_base, b + kN * Tr::kHSpan);
            } else if (u % 2 == 0) {         // bf16: one half a stage
              fc2_tile<Tr::kHSpan>(acc_lo, a_base, b);
            } else {
              fc2_tile<Tr::kHSpan>(acc_hi, a_base, b);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc_lo);
            fence_regs(acc_hi);
          }
          if (l == 0) mbar_arrive(&empty[stage]);
          if (++stage == stages) { stage = 0; phase ^= 1; }
        }
      }
    }

    // out = acc (* cs2) + b2, straight from the registers; masked past M, C
    OT* out = static_cast<OT*>(p.out);
    const int r = row0 + 16 * w + l / 4;
    store_out<kInt8>(acc_lo, out, p, r, col0 + kNW * wg + 2 * (l % 4));
    store_out<kInt8>(acc_hi, out, p, r, col0 + kNW * wg + kN + 2 * (l % 4));
  }
}

template <bool kInt8, int kNW, typename XT, typename OT>
cudaError_t prepare(size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(mlp_wgmma_kernel<kInt8, kNW, XT, OT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <bool kInt8, int kNW, typename XT, typename OT>
cudaError_t launch(const void* w1, const void* w2, const Params& p, cudaStream_t stream) {
  using Tr = Traits<kInt8>;
  if (!takes<kInt8>(p.M, p.C, p.HID)) return cudaErrorInvalidValue;
  CUtensorMap w1_map, w2_map, x_map;
  std::memset(&x_map, 0, sizeof(x_map));
  // W1 [HID, C]: boxes of a chunk's 64 hidden rows by 128 bytes of C
  cudaError_t err = make_map_2d(&w1_map, w1, Tr::kEsz, p.C, p.HID, size_t(p.C) * Tr::kEsz,
                                kSpan / Tr::kEsz, kChunk, kSpan);
  if (err != cudaSuccess) return err;
  // W2 [C, HID]: boxes of kNW / 2 rows of C by one chunk of 64 hidden units
  err = make_map_2d(&w2_map, w2, Tr::kEsz, p.HID, p.C, size_t(p.HID) * Tr::kEsz, kChunk,
                    kNW / 2, Tr::kHSpan);
  if (err != cudaSuccess) return err;
  if (!kInt8) {   // bf16 x [M, C]: boxes of 64 rows by 64 elements
    err = make_map_2d(&x_map, p.x, 2, p.C, p.M, size_t(p.C) * 2, kSpan / 2, kRows, kSpan);
    if (err != cudaSuccess) return err;
  } else if (reinterpret_cast<uintptr_t>(p.x) & 15) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<kInt8>(p.C);
  err = prepare<kInt8, kNW, XT, OT>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kRows - 1) / kRows, (p.C + 2 * kNW - 1) / (2 * kNW));
  mlp_wgmma_kernel<kInt8, kNW, XT, OT><<<grid, kThreads, smem, stream>>>(w1_map, w2_map, x_map, p);
  return cudaGetLastError();
}

template <bool kInt8, int kNW, typename XT, typename OT>
cudaError_t occupancy(int c, int* info) {
  const size_t smem = smem_bytes<kInt8>(c);
  cudaError_t err = prepare<kInt8, kNW, XT, OT>(smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, mlp_wgmma_kernel<kInt8, kNW, XT, OT>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, mlp_wgmma_kernel<kInt8, kNW, XT, OT>, kThreads, smem);
  if (err != cudaSuccess) return err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = int(attr.localSizeBytes);
  info[3] = int(smem);
  return cudaSuccess;
}

// One launch of the instance kNW.  kind 1: the bf16 kernel; kind 2: the int8
// one, x_dtype and out_dtype 0 = float32, 1 = bfloat16.
template <int kNW>
cudaError_t launch_kind(int kind, int x_dtype, int out_dtype, const void* w1, const void* w2,
                        const Params& p, cudaStream_t s) {
  if (kind == 1) return launch<false, kNW, bf16_t, bf16_t>(w1, w2, p, s);
  if (kind != 2) return cudaErrorInvalidValue;
  switch (x_dtype * 2 + out_dtype) {
    case 0:
      return launch<true, kNW, float, float>(w1, w2, p, s);
    case 1:
      return launch<true, kNW, float, bf16_t>(w1, w2, p, s);
    case 2:
      return launch<true, kNW, bf16_t, float>(w1, w2, p, s);
    case 3:
      return launch<true, kNW, bf16_t, bf16_t>(w1, w2, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The instance the serving path runs (kind 1: bf16; kind 2: int8 with bf16 x
// and out) at width c
template <int kNW> cudaError_t occupancy_kind(int c, int kind, int* info) {
  return kind == 2 ? occupancy<true, kNW, bf16_t, bf16_t>(c, info)
                   : occupancy<false, kNW, bf16_t, bf16_t>(c, info);
}

}  // namespace
