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
// as jnp.round and torch.round do.
//
// What bounds it on this card.  At ViT-B/16 and batch 256 (M = 50432) the
// GEMMs of one forward are 4.3e12 multiply-adds.  This first design runs
// them on the CUDA cores with __dp4a (four int8 products per instruction),
// whose peak on an H100 is roughly 1/15 of the int8 tensor-core rate; the
// kernel is bound by dp4a throughput and shared-memory reads, not by device
// memory (it reads x once per 64-column tile of the output).  Tensor cores
// (mma.sync / wgmma int8) and TMA are the lever for later work.
//
// What the design does about it.  A block of 256 threads owns a 128 x 64
// output tile and walks K in steps of 32: the prologue quantizes the x tile
// while staging it (so no int8 copy of x ever reaches device memory), both
// tiles sit in shared memory as packed 4-byte words, k-major with a padded
// stride (conflict-free stores, 16-byte vector reads), and each thread
// keeps an 8 x 4 block of int32 accumulators in registers: 3 vector loads
// feed 32 dp4a.  Ragged M, N and K are masked element by element (zeros
// padded into the last words), so no shape needs to be a multiple of 4.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain
// C interface (no PyTorch headers) and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "int8_common.cuh"

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
  const int group_w = epilogue == kRequant ? N / groups : 1;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx * kTN + j;
    if (gn >= N) continue;
    const float cs = col_scale[gn];
    const float b = bias != nullptr ? bias[gn] : 0.f;
    const float s = epilogue == kRequant ? out_scales[gn / group_w]
                    : epilogue == kGelu  ? out_scales[0]
                                         : 1.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty * kTM + i;
      if (gm >= M) continue;
      const float af = __int2float_rn(acc[i][j]);
      float y = route == kFused ? __fmul_rn(af, cs) : __fmul_rn(__fmul_rn(af, a), cs);
      if (bias != nullptr) y = __fadd_rn(y, b);
      const size_t o = size_t(gm) * N + gn;
      if constexpr (sizeof(OT) == 1) {
        if (epilogue == kGelu) y = gelu(y, gelu_approx);
        // fused route: s is an inverse scale
        const float t = route == kFused ? __fmul_rn(y, s) : __fdiv_rn(y, s);
        out[o] = static_cast<OT>(clip_rint(t));
      } else if constexpr (sizeof(OT) == 2) {
        out[o] = __float2bfloat16(y);
      } else {
        out[o] = y;
      }
    }
  }
}

template <typename XT, typename OT>
cudaError_t launch(const void* x, const void* w, int M, int N, int K, const float* a,
                   const float* cs, const float* bias, int route, int epilogue,
                   const float* out_scales, int groups, int gelu_approx, void* out,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  linear_int8_kernel<XT, OT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w), M, N, K, a, cs, bias,
      route, epilogue, out_scales, groups, gelu_approx, static_cast<OT*>(out));
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_out(int out_dtype, const void* x, const void* w, int M, int N, int K,
                       const float* a, const float* cs, const float* bias, int route,
                       int epilogue, const float* out_scales, int groups,
                       int gelu_approx, void* out, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch<XT, float>(x, w, M, N, K, a, cs, bias, route, epilogue, out_scales,
                               groups, gelu_approx, out, stream);
    case 1:
      return launch<XT, __nv_bfloat16>(x, w, M, N, K, a, cs, bias, route, epilogue,
                                       out_scales, groups, gelu_approx, out, stream);
    case 2:
      return launch<XT, int8_t>(x, w, M, N, K, a, cs, bias, route, epilogue, out_scales,
                                groups, gelu_approx, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  route: 0 = fused, 1 = qlinear.
// epilogue: 0 = float, 1 = requant, 2 = gelu.  out_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (requant and gelu).  a_scale is a device pointer to
// one float.  Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_linear_int8(const void* x, int x_dtype, const void* w, int M, int N, int K,
                       const void* a_scale, const void* col_scale, const void* bias,
                       int route, int epilogue, const void* out_scales, int groups,
                       int gelu_approx, void* out, int out_dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || route < 0 || route > 1 || epilogue < 0 || epilogue > 2)
    return cudaErrorInvalidValue;
  if ((epilogue == 0) == (out_dtype == 2)) return cudaErrorInvalidValue;
  if (epilogue == 1 && (groups < 1 || N % groups)) return cudaErrorInvalidValue;
  if (route == 0 && x_dtype == 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(a_scale);
  const float* cs = static_cast<const float*>(col_scale);
  const float* b = static_cast<const float*>(bias);
  const float* os = static_cast<const float*>(out_scales);
  switch (x_dtype) {
    case 0:
      return launch_out<float>(out_dtype, x, w, M, N, K, a, cs, b, route, epilogue, os,
                               groups, gelu_approx, out, s);
    case 1:
      return launch_out<__nv_bfloat16>(out_dtype, x, w, M, N, K, a, cs, b, route,
                                       epilogue, os, groups, gelu_approx, out, s);
    case 2:
      return launch_out<int8_t>(out_dtype, x, w, M, N, K, a, cs, b, route, epilogue, os,
                                groups, gelu_approx, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
