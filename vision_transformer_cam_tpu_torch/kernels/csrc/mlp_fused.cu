// The fused MLP kernels, fc2(gelu(fc1(x))) in one launch, for Hopper (sm_90a).
//
// Replace the TPU kernels vision_transformer_cam_tpu/kernels/gemm.py:
// _mlp_kernel (mlp_fused) and _mlp_int8_kernel (mlp_fused_int8).  What both
// keep is the property, not the tiling: the [M, HID] hidden tensor never
// reaches device memory.  The TPU kernels hold both weights and a [512, HID]
// hidden tile in VMEM; an SM has 227 KB, so here a block owns 32 rows of x
// and one group of at most 768 output columns (blockIdx.y), walks HID in
// chunks of 384, forms the chunk of the hidden tensor in shared memory and
// adds its product with the group's columns of fc2 into a [32, <= 768]
// accumulator, also in shared memory.  To C = 768 one group covers C; past
// it each group's blocks compute fc1 again (ViT-L's C = 1024 and ViT-H's
// 1280: two groups).  The weights are read in the torch layout [out, in]
// and stream from L2 (they are read once per 32 rows and group).
//
//   mlp_fused       h = gelu(x w1^T + b1) in float32 (f32 sums), rounded to
//                   x's type; out = h w2^T + b2 in float32, then x's type.
//   mlp_fused_int8  xq = clip(rint(x * inv_a1)); acc1 = xq . w1q (int32);
//                   h = gelu(acc1 * cs1 + b1); hq = clip(rint(h * inv_a2));
//                   acc2 = hq . w2q (int32); out = acc2 * cs2 + b2.
//                   Every float step is explicitly rounded and the device
//                   functions are those of int8_gemm.cu, so the result equals
//                   the chain of two fused-route int8 GEMM launches bit for bit
//                   (integer sums are exact, so chunking HID changes nothing).
//
// What bounds them on this card.  At ViT-B/16 (C = 768, HID = 3072) and batch
// 64 (M = 12608) a call is 119 G operations against 48 MB (43 MB int8): bound
// by operations, 0.12 ms at the bf16 tensor-core peak and 0.06 ms at the int8
// one.  The float kernel's products go through tile_gemm.cuh: mma.sync on the
// tensor cores with cp.async double buffering at bf16, f32 FMAs on the CUDA
// cores at float32 (a thread makes 16 vector loads for 192 FMAs).  The int8
// kernel runs mma.sync.m16n8k32 on the int8 tensor cores, its weight chunks
// double buffered the same way.  Each block streams both weights from L2 for
// its 32 rows, and that traffic sets the pace (PERF.md).
// Limits: the float kernels take any C (their shared memory does not grow
// past one group); the int8 kernel keeps the quantized rows of x, [32, C], in
// shared memory beside the accumulator, which fits to C = 1856
// (mlp_int8_smem_bytes); the launch fails past it.
//
// This is the earlier design.  bf16 and int8 calls whose shape the Hopper
// design takes (mlp_fused_wgmma.cu: 64-row tiles, a TMA ring, wgmma) run that
// one; this file keeps float32, the shapes it does not take (C or HID not a
// multiple of 64), and, behind the private switches
// kernels.gemm._mlp_bf16_design / _mlp_int8_design = "mma", the earlier
// design of bf16 and int8 for timing beside the new one.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#include <cmath>

#include "int8_common.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int kTM = 4;
constexpr int kBN = Tile<kTM>::kBN;            // 384: columns per tile, hidden chunk
constexpr int kAcc = kTM * kGTN;               // accumulators per thread
constexpr int kGroupTiles = 2;                 // column tiles of a group: 768 columns

__host__ __device__ inline int col_tiles(int c) { return (c + kBN - 1) / kBN; }
// column tiles a block's accumulator holds, and column groups of a call
__host__ __device__ inline int acc_tiles(int c) {
  return col_tiles(c) < kGroupTiles ? col_tiles(c) : kGroupTiles;
}
inline int col_groups(int c) { return (col_tiles(c) + kGroupTiles - 1) / kGroupTiles; }

template <typename T> size_t mlp_smem_bytes(int c) {
  return sizeof(float) * kGM * acc_tiles(c) * kBN + sizeof(T) * kGM * (kBN + a_pad<T>()) +
         stage_bytes<T, kTM>();
}

template <typename T>
__global__ void __launch_bounds__(kGT)
mlp_fused_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                 int M, int C, int HID, int gelu_approx) {
  using F = Frag<kTM, T>;
  constexpr int kHS = kBN + a_pad<T>();         // hidden chunk rows (A of fc2)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int acc_stride = acc_tiles(C) * kBN;
  float* acc_s = reinterpret_cast<float*>(smem_raw);     // [kGM][acc_stride]
  T* h_s = reinterpret_cast<T*>(acc_s + kGM * acc_stride);   // [kGM][kHS]
  void* stage = h_s + kGM * kHS;

  const int row0 = blockIdx.x * kGM;
  // the group's column tiles ct0 .. ct1 - 1, local tile ct - ct0 of acc_s
  const int ct0 = blockIdx.y * kGroupTiles, ct1 = min(ct0 + kGroupTiles, col_tiles(C));
  // every accumulator element belongs to one thread, which alone reads and
  // writes it: no barrier guards acc_s
  for (int ct = ct0; ct < ct1; ++ct)
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)] = 0.f;

  for (int hc0 = 0; hc0 < HID; hc0 += kBN) {
    float acc[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    gemm_global_a<kTM>(
        acc, x, C, row0, M, w1, C, [=](int c) { return hc0 + c < HID ? hc0 + c : -1; }, C,
        stage);
    // the hidden chunk: bias and GELU in float32, rounded to x's type; zeros
    // past HID.  The last reads of the previous chunk's h_s were made before
    // the barriers of the GEMM above.
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int c = F::col(e);
      float h = 0.f;
      if (hc0 + c < HID) h = gelu(__fadd_rn(acc[e], to_f(b1[hc0 + c])), gelu_approx);
      h_s[F::row(e) * kHS + c] = from_f<T>(h);
    }
    const int kh = min(kBN, (HID - hc0 + kGK - 1) / kGK * kGK);
    for (int ct = ct0; ct < ct1; ++ct) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        acc[e] = acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)];
      gemm_shared_a<kTM>(
          acc, h_s, kHS, w2, HID, [=](int c) { return ct * kBN + c < C ? ct * kBN + c : -1; },
          hc0, HID, kh, stage);
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)] = acc[e];
    }
  }

  for (int ct = ct0; ct < ct1; ++ct)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int lc = (ct - ct0) * kBN + F::col(e), c = ct * kBN + F::col(e);
      const int r = row0 + F::row(e);
      if (c < C && r < M)
        out[size_t(r) * C + c] =
            from_f<T>(__fadd_rn(acc_s[F::row(e) * acc_stride + lc], to_f(b2[c])));
    }
}

// ---------------------------------------------------------------------------
// int8: the same walk with mma.sync.m16n8k32 (s8 x s8 -> s32) on the tensor
// cores.  xq_s and hq_s hold the quantized A operands as int8 [row][k]; the
// weight chunks, 64 k at a time, are staged as they lie in device memory
// ([column][k]) by 16-byte cp.async copies into two buffers.  Rows are padded
// by 16 bytes, which makes every fragment load conflict free.  The C fragments
// are those of the bf16 path, so Frag<kTM, bf16> names the accumulators.
// ---------------------------------------------------------------------------

constexpr int kK8 = 64;                        // k per staged int8 chunk
constexpr int kW8Stride = kK8 + 16;            // bytes; staged weight rows
constexpr int kHQStride = kBN + 16;            // bytes; rows of hq_s
constexpr int kW8Buf = kBN * kW8Stride;        // bytes of one staging buffer

__host__ __device__ inline int xq_stride(int c) { return (c + kK8 - 1) / kK8 * kK8 + 16; }

size_t mlp_int8_smem_bytes(int c) {
  return size_t(kGM) * xq_stride(c) + sizeof(int) * kGM * acc_tiles(c) * kBN +
         kGM * kHQStride + 2 * kW8Buf;
}

// w_s[c][k] = W[row_of(c)][k0 + k] for c < kBN, k < kK8; zeros past k_end and
// for row_of(c) < 0.  16-byte asynchronous copies where the pitch allows them.
template <typename RowOf>
__device__ __forceinline__ void stage_w8(int8_t* w_s, const int8_t* __restrict__ w, int ldw,
                                         RowOf row_of, int k0, int k_end) {
  const bool vec = (ldw & 15) == 0 && (k0 & 15) == 0;
#pragma unroll
  for (int it = 0; it < kBN * (kK8 / 16) / kGT; ++it) {
    const int idx = threadIdx.x + it * kGT;
    const int c = idx / (kK8 / 16), k = (idx % (kK8 / 16)) * 16;
    const int row = row_of(c);
    int8_t* dst = w_s + c * kW8Stride + k;
    const int left = row >= 0 ? min(max(k_end - (k0 + k), 0), 16) : 0;
    const int8_t* src = w + size_t(row >= 0 ? row : 0) * ldw + k0 + k;
    if (vec && left > 0) {
      cp_async16(dst, src, left);   // the copy zero-fills past src_bytes
    } else if (vec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = j < left ? src[j] : int8_t(0);
    }
  }
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc += A chunk (a_s[r][k] int8, rows of pitch a_stride bytes) . W chunk
// (w_s[c][k]): two m16 tiles by kNT n8 tiles per warp, two k32 steps
__device__ __forceinline__ void tile_mma_s8(int (&acc)[kAcc], const int8_t* a_s, int a_stride,
                                            const int8_t* w_s) {
  constexpr int kNT = Tile<kTM>::kNT;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int8_t* b_warp = w_s + ((threadIdx.x >> 5) * kNT * 8 + g) * kW8Stride + tig * 4;
#pragma unroll
  for (int kk = 0; kk < kK8; kk += 32) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p = a_s + (mt * 16 + g) * a_stride + kk + tig * 4;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * a_stride);
      a[mt][2] = ld32(p + 16);
      a[mt][3] = ld32(p + 8 * a_stride + 16);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const unsigned b0 = ld32(b_warp + nt * 8 * kW8Stride + kk);
      const unsigned b1 = ld32(b_warp + nt * 8 * kW8Stride + kk + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        int* c = acc + (mt * kNT + nt) * 4;
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b0), "r"(b1));
      }
    }
  }
}

// acc += a_sm[r][0..K) . W[row_of(c)][w_k0 .. w_k0 + K)^T, K a multiple of kK8
// (a_sm holds zeros past the operand's end, W is staged as zeros past
// w_k_end).  Its first barrier also publishes a_sm.
template <typename RowOf>
__device__ __forceinline__ void gemm_s8(int (&acc)[kAcc], const int8_t* a_sm, int a_stride,
                                        const int8_t* __restrict__ w, int ldw, RowOf row_of,
                                        int w_k0, int w_k_end, int K, int8_t* w_s) {
  __syncthreads();
  stage_w8(w_s, w, ldw, row_of, w_k0, w_k_end);
  cp_async_commit();
  for (int k0 = 0, i = 0; k0 < K; k0 += kK8, ++i) {
    if (k0 + kK8 < K) {
      stage_w8(w_s + ((i + 1) & 1) * kW8Buf, w, ldw, row_of, w_k0 + k0 + kK8, w_k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_mma_s8(acc, a_sm + k0, a_stride, w_s + (i & 1) * kW8Buf);
    __syncthreads();   // before the chunk after next overwrites this buffer
  }
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(kGT)
mlp_fused_int8_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w1q,
                      const float* __restrict__ cs1, const float* __restrict__ b1,
                      const int8_t* __restrict__ w2q, const float* __restrict__ cs2,
                      const float* __restrict__ b2, const float* __restrict__ inv_a1_ptr,
                      const float* __restrict__ inv_a2_ptr, OT* __restrict__ out, int M,
                      int C, int HID, int gelu_approx) {
  using F = Frag<kTM, bf16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xs = xq_stride(C), acc_stride = acc_tiles(C) * kBN;
  int* acc_s = reinterpret_cast<int*>(smem_raw);                      // [kGM][acc_stride]
  int8_t* xq_s = reinterpret_cast<int8_t*>(acc_s + kGM * acc_stride);   // [kGM][xs]
  int8_t* hq_s = xq_s + kGM * xs;                                     // [kGM][kHQStride]
  int8_t* w_s = hq_s + kGM * kHQStride;                               // 2 x [kBN][kW8Stride]

  const int row0 = blockIdx.x * kGM;
  const int ct0 = blockIdx.y * kGroupTiles, ct1 = min(ct0 + kGroupTiles, col_tiles(C));
  const float inv_a1 = *inv_a1_ptr, inv_a2 = *inv_a2_ptr;

  // prologue: the block's rows of x, quantized once, four k per thread and
  // step; zeros past C and past M
  const int xw = (xs - 16) / 4;
  for (int idx = threadIdx.x; idx < kGM * xw; idx += kGT) {
    const int kw = idx % xw, r = idx / xw;
    int v[4] = {0, 0, 0, 0};
    if (row0 + r < M) {
      const size_t base = size_t(row0 + r) * C + kw * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kw * 4 + j < C) v[j] = clip_rint(__fmul_rn(to_f(x[base + j]), inv_a1));
    }
    *reinterpret_cast<int*>(xq_s + r * xs + kw * 4) = pack4(v[0], v[1], v[2], v[3]);
  }
  // every accumulator element belongs to one thread, which alone reads and
  // writes it: no barrier guards acc_s
  for (int ct = ct0; ct < ct1; ++ct)
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)] = 0;

  for (int hc0 = 0; hc0 < HID; hc0 += kBN) {
    int acc[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0;
    gemm_s8(acc, xq_s, xs, w1q, C, [=](int c) { return hc0 + c < HID ? hc0 + c : -1; }, 0, C,
            xs - 16, w_s);
    // hidden chunk: dequantize, GELU, requantize to fc2's scale; zeros past
    // HID.  The previous chunk's hq_s was last read before the barriers above.
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int c = hc0 + F::col(e);
      int q = 0;
      if (c < HID) {
        float y = __fmul_rn(__int2float_rn(acc[e]), cs1[c]);
        if (b1 != nullptr) y = __fadd_rn(y, b1[c]);
        q = clip_rint(__fmul_rn(gelu(y, gelu_approx), inv_a2));
      }
      hq_s[F::row(e) * kHQStride + F::col(e)] = static_cast<int8_t>(q);
    }
    const int kh = min(kBN, (HID - hc0 + kK8 - 1) / kK8 * kK8);
    for (int ct = ct0; ct < ct1; ++ct) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        acc[e] = acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)];
      gemm_s8(acc, hq_s, kHQStride, w2q, HID,
              [=](int c) { return ct * kBN + c < C ? ct * kBN + c : -1; }, hc0, HID, kh, w_s);
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        acc_s[F::row(e) * acc_stride + (ct - ct0) * kBN + F::col(e)] = acc[e];
    }
  }

  for (int ct = ct0; ct < ct1; ++ct)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int lc = (ct - ct0) * kBN + F::col(e), c = ct * kBN + F::col(e);
      const int r = row0 + F::row(e);
      if (c >= C || r >= M) continue;
      float y = __fmul_rn(__int2float_rn(acc_s[F::row(e) * acc_stride + lc]), cs2[c]);
      if (b2 != nullptr) y = __fadd_rn(y, b2[c]);
      out[size_t(r) * C + c] = from_f<OT>(y);
    }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <typename T>
cudaError_t launch_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int M, int C, int HID, int gelu_approx,
                       cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes<T>(C);
  cudaError_t err = prepare(mlp_fused_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGM - 1) / kGM, col_groups(C));
  mlp_fused_kernel<T><<<grid, kGT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), M, C, HID,
      gelu_approx);
  return cudaGetLastError();
}

struct Int8Args {
  const void *x, *w1q, *cs1, *b1, *w2q, *cs2, *b2, *inv_a1, *inv_a2;
  void* out;
  int M, C, HID, gelu_approx;
};

template <typename XT, typename OT>
cudaError_t launch_mlp_int8(const Int8Args& a, cudaStream_t stream) {
  const size_t smem = mlp_int8_smem_bytes(a.C);
  cudaError_t err = prepare(mlp_fused_int8_kernel<XT, OT>, smem);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((a.M + kGM - 1) / kGM, col_groups(a.C));
  mlp_fused_int8_kernel<XT, OT><<<grid, kGT, smem, stream>>>(
      static_cast<const XT*>(a.x), static_cast<const int8_t*>(a.w1q), f(a.cs1), f(a.b1),
      static_cast<const int8_t*>(a.w2q), f(a.cs2), f(a.b2), f(a.inv_a1), f(a.inv_a2),
      static_cast<OT*>(a.out), a.M, a.C, a.HID, a.gelu_approx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, C], w1 [HID, C], b1 [HID], w2 [C, HID], b2 [C], out [M, C], all of
// dtype 0 = float32 or 1 = bfloat16.  Returns a cudaError_t; 0 means the
// kernel was launched.
int vitcam_mlp_fused(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int M, int C, int HID, int dtype,
                     int gelu_approx, void* stream) {
  if (M < 1 || C < 1 || HID < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_mlp<float>(x, w1, b1, w2, b2, out, M, C, HID, gelu_approx, s);
    case 1:
      return launch_mlp<__nv_bfloat16>(x, w1, b1, w2, b2, out, M, C, HID, gelu_approx, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x [M, C] of x_dtype (0 = float32, 1 = bfloat16); w1q int8 [HID, C], w2q int8
// [C, HID]; cs1 [HID], cs2 [C] (combined scales), b1, b2 (or null) float32;
// inv_a1, inv_a2 device pointers to one float each; out [M, C] of out_dtype.
int vitcam_mlp_fused_int8(const void* x, int x_dtype, const void* w1q, const void* cs1,
                          const void* b1, const void* w2q, const void* cs2, const void* b2,
                          const void* inv_a1, const void* inv_a2, void* out, int out_dtype,
                          int M, int C, int HID, int gelu_approx, void* stream) {
  if (M < 1 || C < 1 || HID < 1) return cudaErrorInvalidValue;
  const Int8Args a{x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, out, M, C, HID, gelu_approx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + out_dtype) {
    case 0:
      return launch_mlp_int8<float, float>(a, s);
    case 1:
      return launch_mlp_int8<float, __nv_bfloat16>(a, s);
    case 2:
      return launch_mlp_int8<__nv_bfloat16, float>(a, s);
    case 3:
      return launch_mlp_int8<__nv_bfloat16, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// kind: 0 = float32, 1 = bfloat16, 2 = the int8 kernel
size_t vitcam_mlp_fused_smem_bytes(int c, int kind) {
  return kind == 2   ? mlp_int8_smem_bytes(c)
         : kind == 1 ? mlp_smem_bytes<__nv_bfloat16>(c)
                     : mlp_smem_bytes<float>(c);
}

// The kernel instance the serving path runs (kind 0: float32, 1: bf16, 2:
// int8 with bf16 x and out) at width c: info = {blocks an SM holds at once,
// registers a thread, local memory bytes a thread, dynamic shared memory
// bytes a block}.
int vitcam_mlp_fused_occupancy(int c, int kind, int* info) {
  const size_t smem = vitcam_mlp_fused_smem_bytes(c, kind);
  const void* fn = kind == 2   ? reinterpret_cast<const void*>(
                                     mlp_fused_int8_kernel<__nv_bfloat16, __nv_bfloat16>)
                   : kind == 1 ? reinterpret_cast<const void*>(mlp_fused_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(mlp_fused_kernel<float>);
  cudaError_t err = kind == 2   ? prepare(mlp_fused_int8_kernel<__nv_bfloat16, __nv_bfloat16>, smem)
                    : kind == 1 ? prepare(mlp_fused_kernel<__nv_bfloat16>, smem)
                                : prepare(mlp_fused_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kGT, smem);
  if (err != cudaSuccess) return err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = int(attr.localSizeBytes);
  info[3] = int(smem);
  return cudaSuccess;
}

}  // extern "C"
