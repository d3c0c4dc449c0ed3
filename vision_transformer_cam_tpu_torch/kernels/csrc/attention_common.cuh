// What the attention forward (masked_attention.cu), backward
// (masked_attention_bwd.cu) and block (attention_block.cu) kernels share:
// element conversions with the roundings the TPU kernels make, warp
// reductions, the staging of one K / V chunk in shared memory, and the
// rollout product of a query tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kKC = 64;              // keys per staged K / V chunk
constexpr int kDH = 64;              // head dim (kernel 1 also takes 80: its DH)
// float row pitch of a staged chunk of DH columns: float4-aligned, and
// bank-conflict-free for the float4 reads of 8 neighbouring rows (DH + 4 is
// 4 mod 32 at 64 and 20 mod 32 at 80)
template <int DH> constexpr int kKVStrideOf = DH + 4;
constexpr int kKVStride = kKVStrideOf<kDH>;

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

// Stage rows [k0, k0 + kKC) of one head's K or V (DH columns from column
// offset col) as f32 rows of pitch kKVStrideOf<DH>, by a block of THREADS
// threads; rows past n are zero.  With v_scale (int8 V) each value is
// dequantized and rounded to bf16.
template <int THREADS, typename T, int DH = kDH>
__device__ __forceinline__ void stage_chunk(float* kv_s, const T* __restrict__ qkv_b,
                                            int k0, int n, int c3, int col,
                                            const float* v_scale = nullptr) {
  for (int i = threadIdx.x; i < kKC * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    float v = (k0 + r < n) ? to_f(qkv_b[size_t(k0 + r) * c3 + col + d]) : 0.f;
    if (v_scale != nullptr) v = round_to<__nv_bfloat16>(__fmul_rn(v, *v_scale));
    kv_s[r * kKVStrideOf<DH> + d] = v;
  }
}

// Rollout rows of one query tile: newj[b, q0 + r, k] = (sum_j hm[r, j]
// J[b, j, k] + J[b, q0 + r, k]) / 2 in float32, from the tile's head mean
// hm_s [QB][stride] (zeros past n; stride a multiple of 4).  Thread: one
// column k, all QB rows; hm_s reads are warp broadcasts.  The update is
// never in place: other tiles of the image read J[b] at the same time.  The
// tensor-core designs unroll the key loop four times (UNROLL), so that the
// loads of later J rows are in flight while earlier ones are summed (a
// 16-row tile is bound by their latency from L2); the FMA designs' register
// budget does not take that (kernel 1's bf16 rollout went from 1.26 to 1.91
// ms at B=64 N=197 on an NVIDIA H100 80GB HBM3 at 700 W).
template <int QB, int THREADS, int UNROLL>
__device__ __forceinline__ void rollout_rows(const float* hm_s, int stride,
                                             const float* __restrict__ joint,
                                             float* __restrict__ newj, int b, int q0, int n) {
  const float* jb = joint + size_t(b) * n * n;
  float* nb = newj + size_t(b) * n * n;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.f;
#pragma unroll (UNROLL)
    for (int j = 0; j < n; j += 4) {   // j < n; j + 1..3 may not be
      const float j0 = jb[size_t(j) * n + k];
      const float j1 = j + 1 < n ? jb[size_t(j + 1) * n + k] : 0.f;
      const float j2 = j + 2 < n ? jb[size_t(j + 2) * n + k] : 0.f;
      const float j3 = j + 3 < n ? jb[size_t(j + 3) * n + k] : 0.f;
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hm_s + r * stride + j);
        acc[r] += hv.x * j0 + hv.y * j1 + hv.z * j2 + hv.w * j3;
      }
    }
#pragma unroll
    for (int r = 0; r < QB; ++r)
      if (q0 + r < n) nb[size_t(q0 + r) * n + k] = 0.5f * (acc[r] + jb[size_t(q0 + r) * n + k]);
  }
}

}  // namespace
