// What the int8 GEMM (int8_gemm.cu) and the fused int8 MLP (mlp_fused.cu)
// share: the round-and-clip of the static quantization, the packing of four
// int8 values into one __dp4a operand, and jax.nn.gelu in explicitly rounded
// float32 steps.  One copy, so that the fused MLP and the chain of two GEMMs
// give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

__device__ __forceinline__ int clip_rint(float t) {
  return static_cast<int>(fminf(fmaxf(rintf(t), -127.f), 127.f));
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (int(unsigned(d) << 24));
}

// jax.nn.gelu, op for op, in float32
__device__ __forceinline__ float gelu(float y, int approx) {
  if (approx) {
    const float c = 0.7978845608028654f;   // sqrt(2 / pi) in float32
    const float y3 = __fmul_rn(__fmul_rn(y, y), y);
    const float inner = __fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, y3)));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner)));
    return __fmul_rn(y, cdf);
  }
  const float sqrt_half = 0.7071067811865476f;
  return __fmul_rn(__fmul_rn(0.5f, y), erfcf(__fmul_rn(-y, sqrt_half)));
}

}  // namespace
