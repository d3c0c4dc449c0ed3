// Fused masked multi-head attention with the CAM statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_kernel_fused, with its int8_io and int8_out options.  Per image and
// head, on the packed qkv [B, N, 3C] (heads contiguous inside q|k|v):
//
//   S   = Q K^T * scale + (1 - bg_q) * (mask_value * bg_k)   (rank-1 mask)
//   S   = min(S, 80)  (serving clamp)   or   S - rowmax(S)
//   P   = softmax(S);  O = P V  -> out[b, rows, h*64:(h+1)*64]
//   cls = mean_h P[0, :]                                      -> cls [B, N]
//   hm  = mean_h P            (with_headmean)                 -> hm [B, N, N]
//   J'  = (hm @ J + J) / 2    (rollout, f32, separate buffer) -> newj [B, N, N]
//
// int8_io (int8 qkv, the requantized qkv-GEMM output): q and k are staged as
// integer-valued floats; with dh = 64 and |q|, |k| <= 127 every partial sum
// of q.k is an integer below 64 * 127^2 < 2^24, so the f32 FMA loop gives
// the exact int32 dot, and S = dot * ((sq * sk) * scale).  V is staged as
// (v * sv) rounded to bf16, and P is rounded to bf16 before P V, as the TPU
// kernel casts both.  int8_out (float qkv) and int8_io store the output as
// int8 rint(O * inv_out) clipped to +-127 (round half to even, as
// jnp.round).  The scales live in a small device vector, [3H + 1] per head
// (sq_0.., sk_0.., sv_0.., inv_out), [4] per tensor, or [1] (inv_out), and
// are indexed per head at run time.  cls and the head mean are float32 or
// bf16 (flags), whatever qkv's type.
//
// What bounds it on this card.  At ViT-B/16 (N=197, C=768, H=12) and batch
// 256 one call reads the [B,N,3C] qkv (232 MB in bf16), writes the [B,N,C]
// output (77 MB) and, in the rollout variant, reads and writes the [B,N,N]
// f32 joint (40 MB each way): about 0.4 GB, 0.12 ms at 3.35 TB/s.  Its
// arithmetic is 2*2*N*N*64*H*B = 30.5 GFLOP for QK^T and PV plus 2*N^3*B =
// 3.9 GFLOP for the rollout product.  This first design runs all of it as
// f32 FMAs on the CUDA cores, fed from shared memory (67 TFLOP/s peak,
// >= 0.5 ms), so the kernel is bound by the FMA pipes and shared-memory
// bandwidth, not by device memory.  Tensor cores (mma / wgmma) are the lever
// for later work.
//
// What the design does about it.  A block owns QB query rows of one image,
// QB = 32 or 16 (the wrapper's q_block: 32 where the tiles fit the 227 KB a
// block may use, else 16, or the one the caller forces).  A whole key row of
// S ([QB, N] f32) fits in shared memory for N <= 780 at QB = 32 and for
// N <= 1536 at QB = 16 with the head mean or the rollout, so the softmax is
// exact in one pass and needs no online rescaling; the cls row and the head mean need the
// normalized P anyway.  S, P and the head-mean tile never reach device
// memory; K and V are staged per head in 64-key chunks and re-read from L2
// by each of the ceil(N/32) query tiles.  Inner loops use 16-byte shared
// loads with a 68-float row stride (conflict free), and every operand that
// all lanes of a warp share is a broadcast.  The rollout product reads the
// whole J[b] and writes only this tile's rows of newj: other tiles of the
// same image read J[b] at the same time, so the update is never in place.
//
// Numerics follow the TPU kernel: S, the softmax, the head mean, the cls row
// and the rollout product are f32; P (or the unnormalized exponentials when no
// head mean is needed) is rounded to V's element type (bf16 under int8_io)
// before P V, as the TPU kernel casts it for its matmul.  S's scale and mask
// terms are explicitly rounded (__fmul_rn / __fadd_rn), so no FMA contraction
// moves them away from the plain version.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#include <cmath>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may ask for

enum Mode { kPlain = 0, kHeadmean = 1, kRollout = 2 };
// flags of the C entry point
enum Flags { kOutI8 = 1, kClsBf16 = 2, kHmBf16 = 4 };
// scales vector kinds
enum Scales { kNoScales = 0, kOutOnly = 1, kPerTensor = 2, kPerHead = 3 };

// V's element type, which P is rounded to before P V: bf16 under int8_io
template <typename T> struct PVType { using type = T; };
template <> struct PVType<int8_t> { using type = __nv_bfloat16; };

__device__ __forceinline__ void store_f(void* p, size_t i, float v, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

size_t smem_bytes(int n, int mode, int qb) {
  const size_t ns = padded(n);
  size_t floats = size_t(qb) * kDH + size_t(kKC) * kKVStride + qb * ns;
  if (mode != kPlain) floats += qb * ns;
  floats += ns + n + 2 * qb;
  return floats * sizeof(float);
}

// query rows per block: the forced 16 or 32, or for 0 the larger one whose
// tiles fit; 0 when nothing fits (the launch then fails on its shared memory)
int pick_qb(int n, int mode, int q_block) {
  if (q_block) return q_block;
  if (smem_bytes(n, mode, 32) <= kMaxSmem) return 32;
  if (smem_bytes(n, mode, 16) <= kMaxSmem) return 16;
  return 0;
}

template <typename T, int MODE, bool CLAMP, int kQB>
__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                        const float* __restrict__ joint, void* __restrict__ out,
                        void* __restrict__ cls, void* __restrict__ hm_out,
                        float* __restrict__ newj, const float* __restrict__ scales,
                        int scales_kind, int n, int heads, float scale, float mask_value,
                        int flags) {
  constexpr bool kInt8In = sizeof(T) == 1;
  using PV = typename PVType<T>::type;
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* q_s = smem;                                  // [kQB][kDH]
  float* kv_s = q_s + kQB * kDH;                      // [kKC][kKVStride]
  float* s_s = kv_s + kKC * kKVStride;                // [kQB][ns]
  float* hm_s = s_s + kQB * ns;                       // [kQB][ns], not in kPlain
  float* cls_s = hm_s + (MODE != kPlain ? kQB * ns : 0);  // [ns]
  float* km_s = cls_s + ns;                           // [n] key mask
  float* fg_s = km_s + n;                             // [kQB] 1 - bg_q
  float* den_s = fg_s + kQB;                          // [kQB] softmax sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const int c = heads * kDH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;
  const bool out_i8 = kInt8In || (flags & kOutI8);
  const bool cls_bf16 = flags & kClsBf16, hm_bf16 = flags & kHmBf16;
  const float inv_out = scales_kind == kPerHead     ? scales[3 * heads]
                        : scales_kind == kPerTensor ? scales[3]
                        : scales_kind == kOutOnly   ? scales[0]
                                                    : 1.f;

  for (int k = tid; k < n; k += kThreads) km_s[k] = bg_b[k] * mask_value;
  for (int r = tid; r < kQB; r += kThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  for (int k = tid; k < ns; k += kThreads) cls_s[k] = 0.f;
  if (MODE != kPlain)
    for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    // int8 qkv: S's scale (sq * sk) * scale and V's dequantization scale
    float s_scale = scale;
    const float* v_scale = nullptr;
    if (kInt8In) {
      const bool ph = scales_kind == kPerHead;
      s_scale = __fmul_rn(__fmul_rn(scales[ph ? h : 0], scales[ph ? heads + h : 1]), scale);
      v_scale = scales + (ph ? 2 * heads + h : 2);
    }
    for (int i = tid; i < kQB * kDH; i += kThreads) {
      const int r = i / kDH, d = i % kDH;
      q_s[i] = (q0 + r < n) ? to_f(qkv_b[size_t(q0 + r) * c3 + h * kDH + d]) : 0.f;
    }

    // S tile, one K chunk at a time.  Thread: one key, kQB/4 query rows.
    {
      constexpr int kRows = kQB * kKC / kThreads, kStep = kThreads / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q_s staged; previous chunk consumed
        stage_chunk<kThreads>(kv_s, qkv_b, k0, n, c3, c + h * kDH);
        __syncthreads();
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kKVStride);
#pragma unroll 4
        for (int d4 = 0; d4 < kDH / 4; ++d4) {
          const float4 kv = k4[d4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qv =
                reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * kDH)[d4];
            acc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
        const int k = k0 + kj;
        if (k < n) {
          const float km = km_s[k];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            float s = __fadd_rn(__fmul_rn(acc[i], s_scale), __fmul_rn(fg_s[r], km));
            if (CLAMP) s = fminf(s, 80.f);
            s_s[r * ns + k] = s;
          }
        }
      }
      __syncthreads();
    }

    // Softmax, one warp per row.  Accumulates the normalized P into the head
    // mean and the cls row; leaves in s_s what P.V consumes.
    for (int r = warp; r < kQB; r += kThreads / 32) {
      float* row = s_s + r * ns;
      float m = 0.f;   // the clamp replaces the row-max subtraction
      if (!CLAMP) {
        m = -INFINITY;
        for (int k = lane; k < n; k += 32) m = fmaxf(m, row[k]);
        m = warp_max(m);
      }
      float sum = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float e = expf(row[k] - m);
        row[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const bool hm_row = MODE != kPlain && q0 + r < n;
      const bool cls_row = has_cls && r == 0;
      for (int k = lane; k < ns; k += 32) {
        if (k >= n) {
          row[k] = 0.f;
          continue;
        }
        const float e = row[k], p = e / sum;
        if (hm_row) hm_s[r * ns + k] += p;
        if (cls_row) cls_s[k] += p;
        row[k] = round_to<PV>(MODE != kPlain ? p : e);
      }
      if (lane == 0) den_s[r] = sum;
    }

    // O = P V, one V chunk at a time.  Thread: one column d, kQB/4 rows.
    {
      constexpr int kRows = kQB * kDH / kThreads, kStep = kThreads / kDH;
      const int d = tid % kDH, rg = tid / kDH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; previous chunk consumed
        stage_chunk<kThreads>(kv_s, qkv_b, k0, n, c3, 2 * c + h * kDH, v_scale);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
          const float v0 = kv_s[(j + 0) * kKVStride + d];
          const float v1 = kv_s[(j + 1) * kKVStride + d];
          const float v2 = kv_s[(j + 2) * kKVStride + d];
          const float v3 = kv_s[(j + 3) * kKVStride + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 p = *reinterpret_cast<const float4*>(
                s_s + (rg + i * kStep) * ns + k0 + j);
            acc[i] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        if (q0 + r < n) {
          const float o = MODE != kPlain ? acc[i] : acc[i] / den_s[r];
          const size_t oi = (size_t(b) * n + q0 + r) * c + h * kDH + d;
          if (out_i8) {
            const float t = rintf(__fmul_rn(o, inv_out));
            static_cast<int8_t*>(out)[oi] = static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
          } else if constexpr (!kInt8In) {
            static_cast<T*>(out)[oi] = from_f<T>(o);
          }
        }
      }
    }
    __syncthreads();   // s_s, den_s and kv_s are reused by the next head
  }

  if (has_cls)
    for (int k = tid; k < n; k += kThreads)
      store_f(cls, size_t(b) * n + k, cls_s[k] / heads, cls_bf16);
  if constexpr (MODE != kPlain) {
    for (int i = tid; i < kQB * ns; i += kThreads) hm_s[i] = hm_s[i] / heads;
    __syncthreads();

    if constexpr (MODE == kHeadmean) {
      for (int i = tid; i < kQB * n; i += kThreads) {
        const int r = i / n, k = i % n;
        if (q0 + r >= n) break;
        const size_t idx = (size_t(b) * n + q0 + r) * n + k;
        store_f(hm_out, idx, hm_s[r * ns + k], hm_bf16);
      }
    } else {
      // Rollout: newj[b, q0 + r, k] = (sum_j hm[r, j] J[b, j, k] + J[b, q0 + r, k]) / 2.
      // Thread: one column k, all kQB rows; hm_s reads are warp broadcasts.
      const float* jb = joint + size_t(b) * n * n;
      float* nb = newj + size_t(b) * n * n;
      for (int k = tid; k < n; k += kThreads) {
        float acc[kQB];
#pragma unroll
        for (int r = 0; r < kQB; ++r) acc[r] = 0.f;
        for (int j = 0; j < ns; j += 4) {   // j < n; j + 1..3 may not be
          const float j0 = jb[size_t(j) * n + k];
          const float j1 = j + 1 < n ? jb[size_t(j + 1) * n + k] : 0.f;
          const float j2 = j + 2 < n ? jb[size_t(j + 2) * n + k] : 0.f;
          const float j3 = j + 3 < n ? jb[size_t(j + 3) * n + k] : 0.f;
#pragma unroll
          for (int r = 0; r < kQB; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(hm_s + r * ns + j);
            acc[r] += hv.x * j0 + hv.y * j1 + hv.z * j2 + hv.w * j3;
          }
        }
#pragma unroll
        for (int r = 0; r < kQB; ++r)
          if (q0 + r < n)
            nb[size_t(q0 + r) * n + k] = 0.5f * (acc[r] + jb[size_t(q0 + r) * n + k]);
      }
    }
  }
}

// the launch arguments every instance shares
struct Args {
  const void *qkv, *bg, *joint;
  void *out, *cls, *hm, *newj;
  const float* scales;
  int scales_kind, batch, n, heads;
  float scale, mask_value;
  int flags, q_block;
};

template <typename T, int MODE, bool CLAMP, int kQB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n = a.n;
  auto kernel = masked_attention_kernel<T, MODE, CLAMP, kQB>;
  const size_t smem = smem_bytes(n, MODE, kQB);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQB - 1) / kQB, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const float*>(a.bg),
      static_cast<const float*>(a.joint), a.out, a.cls, a.hm, static_cast<float*>(a.newj),
      a.scales, a.scales_kind, n, a.heads, a.scale, a.mask_value, a.flags);
  return cudaGetLastError();
}

template <typename T, int MODE, bool CLAMP>
cudaError_t launch_qb(const Args& a, cudaStream_t stream) {
  switch (pick_qb(a.n, MODE, a.q_block)) {
    case 32:
      return launch<T, MODE, CLAMP, 32>(a, stream);
    case 16:
      return launch<T, MODE, CLAMP, 16>(a, stream);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

template <typename T, int MODE>
cudaError_t launch_clamp(int clamp, const Args& a, cudaStream_t stream) {
  return clamp ? launch_qb<T, MODE, true>(a, stream) : launch_qb<T, MODE, false>(a, stream);
}

template <typename T>
cudaError_t launch_mode(int mode, int clamp, const Args& a, cudaStream_t stream) {
  switch (mode) {
    case kPlain:
      return launch_clamp<T, kPlain>(clamp, a, stream);
    case kHeadmean:
      return launch_clamp<T, kHeadmean>(clamp, a, stream);
    case kRollout:
      return launch_clamp<T, kRollout>(clamp, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (qkv; out too unless int8).
// mode: 0 = plain, 1 = head mean (hm), 2 = rollout (joint -> newj, f32).
// scales: device float vector of scales_kind 0 = none, 1 = [inv_out],
// 2 = [sq, sk, sv, inv_out], 3 = [sq_*, sk_*, sv_*, inv_out] (3H + 1).
// flags: 1 = int8 out (int8_out; implied by int8 qkv), 2 = cls bf16 (else
// f32), 4 = hm bf16 (else f32).
// q_block: query rows per block, 16 or 32, or 0 for the larger one that fits.
// Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_masked_attention_fused(const void* qkv, const void* bg, const void* joint,
                                  void* out, void* cls, void* hm, void* newj,
                                  const void* scales, int scales_kind, int batch, int n,
                                  int heads, int head_dim, float scale, float mask_value,
                                  int dtype, int mode, int clamp, int flags, int q_block,
                                  void* stream) {
  if (head_dim != kDH || batch < 1 || batch > 65535 || n < 1 || heads < 1 ||
      (q_block != 0 && q_block != 16 && q_block != 32))
    return cudaErrorInvalidValue;
  const bool int8_in = dtype == 2;
  if (scales_kind < 0 || scales_kind > 3 || (scales_kind != kNoScales) != (scales != nullptr))
    return cudaErrorInvalidValue;
  if (int8_in != (scales_kind == kPerTensor || scales_kind == kPerHead))
    return cudaErrorInvalidValue;
  if (!int8_in && ((flags & kOutI8) != 0) != (scales_kind == kOutOnly))
    return cudaErrorInvalidValue;
  const Args a{qkv, bg, joint, out, cls, hm, newj, static_cast<const float*>(scales),
               scales_kind, batch, n, heads, scale, mask_value, flags, q_block};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_mode<float>(mode, clamp, a, s);
    case 1:
      return launch_mode<__nv_bfloat16>(mode, clamp, a, s);
    case 2:
      return launch_mode<int8_t>(mode, clamp, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t vitcam_masked_attention_smem_bytes(int n, int mode, int q_block) {
  const int qb = pick_qb(n, mode, q_block);
  return smem_bytes(n, mode, qb ? qb : 16);
}

const char* vitcam_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
