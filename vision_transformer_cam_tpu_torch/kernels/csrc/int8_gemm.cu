// The int8 serving GEMM with fused quantize prologue and dequantize /
// requantize epilogues, for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/gemm.py:
// _linear_int8_kernel (linear_int8_fused), and stands in for the XLA-fused
// int8 GEMMs of ops/quant.py (qlinear, qlinear_requant, qlinear_gelu_requant),
// whose epilogues have no compiler to fuse them here.  For x [M, K] and the
// int8 weight W [N, K] (torch layout, K contiguous):
//
//   prologue  xq = x                              (int8 x)
//             xq = clip(rint(x * a), +-127)       (route fused, a = 1/act_scale)
//             xq = clip(rint(x / a), +-127)       (route qlinear, a = act_scale)
//   acc       = sum_k xq[m, k] * W[n, k]           int32, exact
//   dequant   y = acc * cs[n] + b[n]               (route fused, cs combined)
//             y = (acc * a) * ws[n] + b[n]         (route qlinear)
//   epilogue  float:   y as float32 / bfloat16
//             requant: clip(rint(y / s[n / (N / groups)]), +-127) as int8
//             gelu:    clip(rint(gelu(y) / s[0]), +-127) as int8 (tanh or erf)
//             On the fused route s holds inverse scales and multiplies
//             (rint(y * s)), as that route's prologue does: the op order of
//             the TPU fused MLP kernel, whose two GEMMs this route repeats.
//
// Every float step is an explicitly rounded __fmul_rn / __fadd_rn /
// __fdiv_rn, so nvcc cannot contract a multiply and an add into one FMA and
// move a requantized value across a .5 boundary; rintf rounds half to even,
// as jnp.round and torch.round do.  Both designs below run the one epilogue
// function on the exact int32 dot, so they give the same bits.
//
// What bounds it on this card.  At ViT-B/16 and batch 64 (M = 12608) the five
// GEMMs of a block are 193 G int8 operations, 0.098 ms at the int8
// tensor-core peak (1979 TOP/s), against 0.04 ms of bytes: bound by
// operations, on the tensor cores.
//
// The tensor-core design (every route, the path's).  A block of 8 warps owns
// a 128 x 128 output tile and walks K in steps of 128 bytes.  Both operands
// sit in shared memory as [128][128-byte] int8 tiles, each 16-byte segment s
// of row r stored at s ^ (r % 8) so that ldmatrix reads are conflict free, in
// a ring of three stages: W (and int8 x) arrive by 16-byte cp.async copies
// two steps ahead of the products; float x is loaded into registers one step
// ahead, and quantized and stored after the step's products, so no int8
// copy of x ever reaches device memory.  Each warp owns 64 x 32 of the tile
// (4 x 4 m16n8 fragments, 64 int32 accumulators a thread) and feeds
// mma.sync.m16n8k32.s8 from ldmatrix.x4 loads: four per k32 step for A, two
// per two steps for W.  The epilogue parks the int32 tile in shared memory
// and runs four neighbouring columns a thread: the requantize and GELU
// epilogues (a correctly rounded division, tanhf) cost more than the products
// at K = 768, and this gives them independent work and row-contiguous
// stores.  Ragged M and N are zero-filled rows; K that is not a multiple of
// 16 (or an unaligned operand) is staged byte by byte.  wgmma with TMA is
// the lever left.
//
// The __dp4a design (the first one, kept to time the two side by side): a
// block of 256 threads owns a 128 x 64 output tile and walks K in steps of
// 32 on the CUDA cores (four int8 products per __dp4a, roughly 1/15 of the
// int8 tensor-core rate): the prologue quantizes the x tile while staging
// it, both tiles sit in shared memory as packed 4-byte words, k-major with a
// padded stride, and each thread keeps an 8 x 4 block of int32 accumulators.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain
// C interface (no PyTorch headers) and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "int8_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 64;           // output columns per block
constexpr int kBK = 32;           // K per step (8 packed words)
constexpr int kKW = kBK / 4;      // packed words per row and step
constexpr int kTM = 8;            // rows per thread
constexpr int kTN = 4;            // columns per thread
constexpr int kAStride = kBM + 4; // words; 16-byte aligned, conflict-free
constexpr int kBStride = kBN + 4;

enum Route { kFused = 0, kQlinear = 1 };
enum Epilogue { kFloat = 0, kRequant = 1, kGelu = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The epilogue of one output column: dequantize the exact int32 dot, add the
// bias, and (int8 out) apply the GELU and requantize; the one function both
// designs run.
template <typename OT> struct ColEpi {
  float a, cs, b, s;
  bool has_bias, fused;
  int epilogue, gelu_approx;
  __device__ __forceinline__ ColEpi(int gn, int N, float a_, const float* col_scale,
                                    const float* bias, int route, int epi,
                                    const float* out_scales, int groups, int approx)
      : a(a_), cs(col_scale[gn]), b(bias != nullptr ? bias[gn] : 0.f), s(1.f),
        has_bias(bias != nullptr), fused(route == kFused), epilogue(epi),
        gelu_approx(approx) {
    if (epi == kRequant) s = out_scales[gn / (N / groups)];
    else if (epi == kGelu) s = out_scales[0];
  }
  __device__ __forceinline__ OT operator()(int acc) const {
    const float af = __int2float_rn(acc);
    float y = fused ? __fmul_rn(af, cs) : __fmul_rn(__fmul_rn(af, a), cs);
    if (has_bias) y = __fadd_rn(y, b);
    if constexpr (sizeof(OT) == 1) {
      if (epilogue == kGelu) y = gelu(y, gelu_approx);
      // fused route: s is an inverse scale
      const float t = fused ? __fmul_rn(y, s) : __fdiv_rn(y, s);
      return static_cast<OT>(clip_rint(t));
    } else if constexpr (sizeof(OT) == 2) {
      return __float2bfloat16(y);
    } else {
      return y;
    }
  }
};

// One element of the x tile as an int8 value (in an int).
template <typename XT>
__device__ __forceinline__ int quant_x(const XT* x, size_t idx, float a, int route) {
  const float v = to_f(x[idx]);
  return clip_rint(route == kFused ? __fmul_rn(v, a) : __fdiv_rn(v, a));
}
template <>
__device__ __forceinline__ int quant_x<int8_t>(const int8_t* x, size_t idx, float, int) {
  return x[idx];
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
linear_int8_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                   int K, const float* __restrict__ a_ptr,
                   const float* __restrict__ col_scale, const float* __restrict__ bias,
                   int route, int epilogue, const float* __restrict__ out_scales,
                   int groups, int gelu_approx, OT* __restrict__ out) {
  __shared__ __align__(16) int a_s[kKW * kAStride];   // [kw][m]
  __shared__ __align__(16) int b_s[kKW * kBStride];   // [kw][n]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float a = *a_ptr;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage x: kBM * kKW words, 4 per thread; 8 neighbouring threads read
    // one row's 32 consecutive k
#pragma unroll
    for (int it = 0; it < kBM * kKW / kThreads; ++it) {
      const int word = tid + it * kThreads;
      const int r = word / kKW, kw = word % kKW;
      const int gm = m0 + r, gk = k0 + kw * 4;
      int v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const size_t base = size_t(gm) * K;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = quant_x<XT>(x, base + gk + j, a, route);
      }
      a_s[kw * kAStride + r] = pack4(v[0], v[1], v[2], v[3]);
    }
    // stage W: kBN * kKW words, 2 per thread
#pragma unroll
    for (int it = 0; it < kBN * kKW / kThreads; ++it) {
      const int word = tid + it * kThreads;
      const int c = word / kKW, kw = word % kKW;
      const int gn = n0 + c, gk = k0 + kw * 4;
      int v[4] = {0, 0, 0, 0};
      if (gn < N) {
        const int8_t* wr = w + size_t(gn) * K;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = wr[gk + j];
      }
      b_s[kw * kBStride + c] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(a_s + kw * kAStride + ty * kTM);
      const int4 a1 = *reinterpret_cast<const int4*>(a_s + kw * kAStride + ty * kTM + 4);
      const int4 bv = *reinterpret_cast<const int4*>(b_s + kw * kBStride + tx * kTN);
      const int av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx * kTN + j;
    if (gn >= N) continue;
    const ColEpi<OT> ce(gn, N, a, col_scale, bias, route, epilogue, out_scales, groups,
                        gelu_approx);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty * kTM + i;
      if (gm < M) out[size_t(gm) * N + gn] = ce(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core design
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;                    // output rows per block
constexpr int kTcBN = 128;                    // output columns per block
constexpr int kTcBK = 128;                    // K (bytes) per step
constexpr int kTcStages = 3;
constexpr int kTcTile = kTcBM * kTcBK;        // bytes of one A or W stage
constexpr size_t kTcSmem = size_t(kTcStages) * 2 * kTcTile;   // 96 KB
constexpr int kTcAccStride = kTcBN + 8;       // int32 row pitch of the epilogue tile
static_assert(kTcBM == kTcBN, "A and W stages share one tile shape");
static_assert(size_t(kTcBM) * kTcAccStride * 4 <= kTcSmem, "the epilogue tile fits the ring");

// byte offset of (row, byte) in a [rows][128-byte] tile: segment s of row r
// at s ^ (r % 8), so the 8 rows an ldmatrix reads lie in 8 bank groups
__device__ __forceinline__ int swz8(int row, int byte) {
  return row * kTcBK + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// Rows [0, 128) x bytes [k0, k0 + 128) of an int8 [rows][K] matrix into a
// swizzled tile, by the block's 256 threads; rows >= `valid` and bytes past K
// are zeros.  vec: 16-byte cp.async copies (K a multiple of 16, src 16-byte
// aligned); else byte loads and shared stores.
__device__ __forceinline__ void stage_i8(int8_t* dst, const int8_t* __restrict__ src, int valid,
                                         int K, int k0, bool vec) {
#pragma unroll
  for (int j = 0; j < kTcBM * (kTcBK / 16) / kThreads; ++j) {
    const int seg = threadIdx.x + j * kThreads, r = seg >> 3, kb = k0 + (seg & 7) * 16;
    const int left = r < valid ? min(max(K - kb, 0), 16) : 0;
    const int8_t* p = src + (left > 0 ? size_t(r) * K + kb : 0);
    int8_t* d = dst + swz8(r, (seg & 7) * 16);
    if (vec) {
      cp_async16(d, p, left);   // zero-fills past src_bytes
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) d[e] = e < left ? p[e] : int8_t(0);
    }
  }
}

// float x: eight elements of a row, the unit one thread quantizes into 8 bytes
template <typename XT> struct alignas(16) XUnit { XT v[8]; };
constexpr int kXUnits = kTcBM * kTcBK / 8 / kThreads;   // units per thread and step

template <typename XT>
__device__ __forceinline__ void load_x(XUnit<XT> (&u)[kXUnits], const XT* __restrict__ x,
                                       int valid, int K, int k0, bool vec) {
#pragma unroll
  for (int j = 0; j < kXUnits; ++j) {
    const int unit = threadIdx.x + j * kThreads, r = unit >> 4, k = k0 + (unit & 15) * 8;
    const XT* p = x + size_t(r) * K + k;
    if (vec) {
      constexpr int kWords = sizeof(XT) * 8 / 16;
      uint4* d = reinterpret_cast<uint4*>(u[j].v);
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        d[w] = r < valid && k < K ? __ldg(reinterpret_cast<const uint4*>(p) + w)
                                  : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) u[j].v[e] = r < valid && k + e < K ? p[e] : XT(0.f);
    }
  }
}

template <typename XT>
__device__ __forceinline__ void store_x(const XUnit<XT> (&u)[kXUnits], int8_t* dst, float a,
                                        int route) {
#pragma unroll
  for (int j = 0; j < kXUnits; ++j) {
    const int unit = threadIdx.x + j * kThreads;
    int q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = to_f(u[j].v[e]);
      q[e] = clip_rint(route == kFused ? __fmul_rn(v, a) : __fdiv_rn(v, a));
    }
    *reinterpret_cast<uint2*>(dst + swz8(unit >> 4, (unit & 15) * 8)) =
        make_uint2(unsigned(pack4(q[0], q[1], q[2], q[3])),
                   unsigned(pack4(q[4], q[5], q[6], q[7])));
  }
}

// acc += the products of one staged step: the warp's 64 x 32 of the tile,
// four k32 steps; W fragments for two k32 steps per ldmatrix.x4
__device__ __forceinline__ void tile_mma(int (&acc)[4][4][4], const int8_t* a_s,
                                         const int8_t* b_s, int wm, int wn, int lane) {
  const int i = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kp = 0; kp < kTcBK / 64; ++kp) {
    unsigned bf[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) ldsm_x4(bf[nt], b_s + swz8(wn * 32 + nt * 8 + r8, kp * 64 + i * 16));
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], a_s + swz8(wm * 64 + mt * 16 + (i & 1) * 8 + r8,
                                   (kp * 2 + s) * 32 + (i >> 1) * 16));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16832_s8(acc[mt][nt], af[mt], bf[nt][2 * s], bf[nt][2 * s + 1]);
    }
  }
}

// four neighbouring outputs, stored in one access
template <typename OT> struct alignas(4 * sizeof(OT)) Quad { OT v[4]; };

// int8 x takes two blocks an SM (96 KB of shared memory each, at most 128
// registers a thread); float x holds its next step's x in registers too
template <typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, sizeof(XT) == 1 ? 2 : 1)
linear_int8_tc_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
                      int K, const float* __restrict__ a_ptr,
                      const float* __restrict__ col_scale, const float* __restrict__ bias,
                      int route, int epilogue, const float* __restrict__ out_scales,
                      int groups, int gelu_approx, OT* __restrict__ out) {
  constexpr bool kI8 = sizeof(XT) == 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* a_ring = reinterpret_cast<int8_t*>(smem_raw);   // [stages][128][128]
  int8_t* b_ring = a_ring + kTcStages * kTcTile;          // [stages][128][128]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;                // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const float a = *a_ptr;
  const int8_t* w_blk = w + size_t(n0) * K;
  const XT* x_blk = x + size_t(m0) * K;
  const bool w_vec = (K & 15) == 0 && (reinterpret_cast<size_t>(w) & 15) == 0;
  const bool x_vec = (K & (kI8 ? 15 : 7)) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  const int nk = (K + kTcBK - 1) / kTcBK;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
  XUnit<XT> xu[kI8 ? 1 : kXUnits];

  auto stage_async = [&](int kt) {   // the cp.async part of step kt
    const int slot = kt % kTcStages;
    stage_i8(b_ring + slot * kTcTile, w_blk, N - n0, K, kt * kTcBK, w_vec);
    if constexpr (kI8)
      stage_i8(a_ring + slot * kTcTile, reinterpret_cast<const int8_t*>(x_blk), M - m0, K,
               kt * kTcBK, x_vec);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) {
      stage_async(s);
      if constexpr (!kI8) {
        load_x(xu, x_blk, M - m0, K, s * kTcBK, x_vec);
        store_x(xu, a_ring + s * kTcTile, a, route);
      }
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // step kt landed; every warp is done with step kt - 1's slot
    const int nxt = kt + kTcStages - 1;
    if (nxt < nk) {
      stage_async(nxt);
      if constexpr (!kI8) load_x(xu, x_blk, M - m0, K, nxt * kTcBK, x_vec);
    }
    cp_async_commit();
    tile_mma(acc, a_ring + (kt % kTcStages) * kTcTile, b_ring + (kt % kTcStages) * kTcTile, wm,
             wn, lane);
    if constexpr (!kI8)
      if (nxt < nk) store_x(xu, a_ring + (nxt % kTcStages) * kTcTile, a, route);
  }

  // Epilogue through shared memory: the warps' int32 fragments are parked in
  // a [128][136] tile (the ring is free once every copy has landed), then
  // each thread takes 4 neighbouring columns of every 8th row, so its four
  // column epilogues are set up once, run independently of each other, and a
  // warp stores one contiguous row segment.
  cp_async_wait<0>();
  __syncthreads();
  int* acc_s = reinterpret_cast<int*>(smem_raw);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int* p = acc_s + (wm * 64 + mt * 16 + g) * kTcAccStride + wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(p) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(p + 8 * kTcAccStride) = make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const int c4 = (threadIdx.x & 31) * 4, gn = n0 + c4;
  if (gn >= N) return;
  const int last = N - 1;
  const ColEpi<OT> e[4] = {
      ColEpi<OT>(gn, N, a, col_scale, bias, route, epilogue, out_scales, groups, gelu_approx),
      ColEpi<OT>(min(gn + 1, last), N, a, col_scale, bias, route, epilogue, out_scales, groups,
                 gelu_approx),
      ColEpi<OT>(min(gn + 2, last), N, a, col_scale, bias, route, epilogue, out_scales, groups,
                 gelu_approx),
      ColEpi<OT>(min(gn + 3, last), N, a, col_scale, bias, route, epilogue, out_scales, groups,
                 gelu_approx)};
  const bool quad = (N & 3) == 0;   // then gn + 3 < N and the store is aligned
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < kTcBM; r += kThreads / 32) {
    const int gm = m0 + r;
    if (gm >= M) break;
    const int4 v = *reinterpret_cast<const int4*>(acc_s + r * kTcAccStride + c4);
    Quad<OT> q;
    q.v[0] = e[0](v.x);
    q.v[1] = e[1](v.y);
    q.v[2] = e[2](v.z);
    q.v[3] = e[3](v.w);
    OT* o = out + size_t(gm) * N + gn;
    if (quad) {
      *reinterpret_cast<Quad<OT>*>(o) = q;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) o[j] = q.v[j];
    }
  }
}

// the launch arguments both designs share
struct Args {
  const void *x, *w;
  int M, N, K;
  const float *a, *cs, *bias;
  int route, epilogue;
  const float* out_scales;
  int groups, gelu_approx;
  void* out;
};

template <typename XT, typename OT>
cudaError_t launch(int design, const Args& g, cudaStream_t stream) {
  const XT* x = static_cast<const XT*>(g.x);
  const int8_t* w = static_cast<const int8_t*>(g.w);
  OT* out = static_cast<OT*>(g.out);
  if (design == 1) {
    auto kernel = linear_int8_tc_kernel<XT, OT>;
    const dim3 grid((g.N + kTcBN - 1) / kTcBN, (g.M + kTcBM - 1) / kTcBM);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(kTcSmem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kTcSmem, stream>>>(x, w, g.M, g.N, g.K, g.a, g.cs, g.bias, g.route,
                                                g.epilogue, g.out_scales, g.groups,
                                                g.gelu_approx, out);
    return cudaGetLastError();
  }
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  linear_int8_kernel<XT, OT><<<grid, kThreads, 0, stream>>>(
      x, w, g.M, g.N, g.K, g.a, g.cs, g.bias, g.route, g.epilogue, g.out_scales, g.groups,
      g.gelu_approx, out);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_out(int out_dtype, int design, const Args& g, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch<XT, float>(design, g, stream);
    case 1:
      return launch<XT, __nv_bfloat16>(design, g, stream);
    case 2:
      return launch<XT, int8_t>(design, g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  route: 0 = fused, 1 = qlinear.
// epilogue: 0 = float, 1 = requant, 2 = gelu.  out_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (requant and gelu).  a_scale is a device pointer to
// one float.  design: 0 = __dp4a, 1 = tensor cores.  Returns a cudaError_t;
// 0 means the kernel was launched.
int vitcam_linear_int8(const void* x, int x_dtype, const void* w, int M, int N, int K,
                       const void* a_scale, const void* col_scale, const void* bias,
                       int route, int epilogue, const void* out_scales, int groups,
                       int gelu_approx, void* out, int out_dtype, int design, void* stream) {
  if (M < 1 || N < 1 || K < 1 || route < 0 || route > 1 || epilogue < 0 || epilogue > 2 ||
      design < 0 || design > 1)
    return cudaErrorInvalidValue;
  if ((epilogue == 0) == (out_dtype == 2)) return cudaErrorInvalidValue;
  if (epilogue == 1 && (groups < 1 || N % groups)) return cudaErrorInvalidValue;
  if (route == 0 && x_dtype == 2) return cudaErrorInvalidValue;
  const Args g{x, w, M, N, K,
               static_cast<const float*>(a_scale), static_cast<const float*>(col_scale),
               static_cast<const float*>(bias), route, epilogue,
               static_cast<const float*>(out_scales), groups, gelu_approx, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return launch_out<float>(out_dtype, design, g, s);
    case 1:
      return launch_out<__nv_bfloat16>(out_dtype, design, g, s);
    case 2:
      return launch_out<int8_t>(out_dtype, design, g, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
