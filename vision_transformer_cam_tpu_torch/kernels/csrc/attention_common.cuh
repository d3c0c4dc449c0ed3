// What the attention forward (masked_attention.cu) and backward
// (masked_attention_bwd.cu) kernels share: element conversions with the
// roundings the TPU kernels make, warp reductions, and the staging of one
// K / V chunk in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kKC = 64;              // keys per staged K / V chunk
constexpr int kDH = 64;              // head dim
constexpr int kKVStride = kDH + 4;   // float4-aligned, bank-conflict-free rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// the value the TPU kernels feed a matmul: cast to the element type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int padded(int n) { return (n + 3) & ~3; }

// Stage rows [k0, k0 + kKC) of one head's K or V (column offset col) as f32,
// by a block of THREADS threads; rows past n are zero.  With v_scale (int8 V)
// each value is dequantized and rounded to bf16.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_chunk(float* kv_s, const T* __restrict__ qkv_b,
                                            int k0, int n, int c3, int col,
                                            const float* v_scale = nullptr) {
  for (int i = threadIdx.x; i < kKC * kDH; i += THREADS) {
    const int r = i / kDH, d = i % kDH;
    float v = (k0 + r < n) ? to_f(qkv_b[size_t(k0 + r) * c3 + col + d]) : 0.f;
    if (v_scale != nullptr) v = round_to<__nv_bfloat16>(__fmul_rn(v, *v_scale));
    kv_s[r * kKVStride + d] = v;
  }
}

}  // namespace
