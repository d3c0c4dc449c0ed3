// The whole attention sub-block in one launch, for Hopper (sm_90a):
//
//   qkv  = round(xn Wqkv^T + bqkv)                       (f32 sums, xn's type)
//   S    = Q K^T * scale + (1 - bg_q) * (mask_value * bg_k),  min(S, 80) or
//          S - rowmax(S);  E = exp(S);  P = E / rowsum(E)   per head, f32
//   O    = round(P) V  (with a joint)  or  round(E) V / rowsum(E)  (without)
//   out  = tokens + round(O) Wproj^T + bproj              (f32, then xn's type)
//   cls  = mean_h P[0, :]                                 -> cls [B, N]
//   J'   = (mean_h P @ J + J) / 2   (f32, separate buffer; with a joint)
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_block_kernel (attention_block_fused).  The TPU program holds one
// image's [N, 3C] qkv and [N, C] attention output in VMEM; neither fits an
// SM, and neither may go to device memory (then it would be the attention
// kernel between two GEMMs).  proj sums over all heads and the rollout needs
// the head mean of a query tile over all heads, so the unit of work is a
// query tile across all heads: a block owns 32 query rows of one image, and
// the ceil(N / 32) blocks of an image form one thread-block cluster.  Per
// head every block computes q, k and v of its own 32 rows (a [32, C] x
// [C, 192] GEMM from xn and the weight rows of that head), keeps k and v in
// its shared memory, and after a cluster barrier reads the other blocks' k and
// v through distributed shared memory: K and V are computed once per image
// and never leave the chip.  The softmax is exact in one pass over a [32, N]
// f32 row block, as in masked_attention.cu; the head's output lands in a
// [32, C] tile in shared memory, which the proj GEMM consumes at the end, so
// no float atomics and no dependence on block order.  The weights are read in
// the torch layout [out, in] and stream from L2.
//
// What bounds it on this card.  At ViT-B/16 (N = 197, C = 768, H = 12), batch
// 64 and with the rollout, a call is 67 GFLOP (qkv 44.6, proj 14.9, QK^T and
// PV 7.6) plus 0.98 GFLOP for hm @ J against 83 MB: bound by operations,
// 0.068 ms at the bf16 tensor-core peak.  The two GEMMs, nine tenths of the
// operations, go through tile_gemm.cuh: mma.sync on the tensor cores at bf16,
// f32 FMAs at float32.  The attention core (QK^T, the softmax, PV) and the
// rollout product run as f32 FMAs on the CUDA cores fed from shared memory,
// as in masked_attention.cu, and now take most of the time.  One block per SM
// (169 KB of shared memory at bf16, 206 KB at float32) in clusters of 7.
// wgmma for the GEMMs and tensor cores for the core are the levers left.
//
// Limits: head width 64; N <= 256 (a cluster has at most 8 blocks); the
// shared memory holds C <= 768 at that N.  The launch fails past them.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#include <cooperative_groups.h>

#include <cmath>

#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kQB = kGM;             // query rows per block
constexpr int kMaxCluster = 8;       // the portable cluster size

// offsets, in bytes, of the block's shared memory
struct Smem {
  int attn, hm, q, k_own, v_own, cls, km, fg, den, u, total;
};

template <typename T> __host__ __device__ inline Smem layout(int n, int c, bool rollout) {
  const int ns = padded(n), f = sizeof(float);
  Smem s;
  int o = 0;
  s.attn = o, o += kQB * (c + a_pad<T>()) * int(sizeof(T));   // all heads' output, T
  s.hm = o, o += rollout ? kQB * ns * f : 0;     // [kQB][ns] sum of P over heads
  s.q = o, o += kQB * kDH * f;                   // [kQB][kDH]
  s.k_own = o, o += kQB * kKVStride * f;         // this block's rows of K, V:
  s.v_own = o, o += kQB * kKVStride * f;         //   read by the whole cluster
  s.cls = o, o += ns * f;
  s.km = o, o += ns * f;                         // key mask
  s.fg = o, o += kQB * f;                        // 1 - bg_q
  s.den = o, o += kQB * f;                       // softmax sums
  s.u = o;
  // the GEMMs' staging (of the wider tile) and the attention core's (s_s
  // [kQB][ns], kv_s [kKC][kKVStride]) are never live together
  const int gemm = stage_bytes<T, 4>();
  const int core = (kQB * ns + kKC * kKVStride) * f;
  s.total = o + (gemm > core ? gemm : core);
  return s;
}

// kv_s rows [0, kKC) = rows of `own` (K or V of this head) in the blocks of
// rank first, first + 1 of the cluster; zeros past the last block
__device__ __forceinline__ void copy_chunk(float* kv_s, float* own, int first, int blocks,
                                           cg::cluster_group& cluster) {
  for (int i = threadIdx.x; i < kKC * (kDH / 4); i += kGT) {
    const int r = i / (kDH / 4), d = (i % (kDH / 4)) * 4;
    const int rank = first + r / kQB;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rank < blocks) {
      const float* src = cluster.map_shared_rank(own, rank);
      v = *reinterpret_cast<const float4*>(src + (r % kQB) * kKVStride + d);
    }
    *reinterpret_cast<float4*>(kv_s + r * kKVStride + d) = v;
  }
}

template <typename T, bool ROLLOUT, bool CLAMP>
__global__ void __launch_bounds__(kGT)
attention_block_kernel(const T* __restrict__ xn, const T* __restrict__ tok,
                       const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                       const T* __restrict__ wproj, const T* __restrict__ bproj,
                       const float* __restrict__ bg, const float* __restrict__ joint,
                       T* __restrict__ out, T* __restrict__ cls, float* __restrict__ newj, int n,
                       int heads, float scale, float mask_value) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = heads * kDH, ns = padded(n), cs = c + a_pad<T>();
  const Smem lay = layout<T>(n, c, ROLLOUT);
  auto floats = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  T* attn_s = reinterpret_cast<T*>(smem + lay.attn);
  float* hm_s = floats(lay.hm);
  float* q_s = floats(lay.q);
  float* k_own = floats(lay.k_own);
  float* v_own = floats(lay.v_own);
  float* cls_s = floats(lay.cls);
  float* km_s = floats(lay.km);
  float* fg_s = floats(lay.fg);
  float* den_s = floats(lay.den);
  void* stage = smem + lay.u;                // GEMM staging ...
  float* s_s = floats(lay.u);                // ... or the attention core's
  float* kv_s = s_s + kQB * ns;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, blocks = gridDim.x, q0 = blockIdx.x * kQB;
  const T* xn_b = xn + size_t(b) * n * c;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;

  for (int k = tid; k < ns; k += kGT) {
    km_s[k] = k < n ? bg_b[k] * mask_value : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < kQB; r += kGT) fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  if (ROLLOUT)
    for (int i = tid; i < kQB * ns; i += kGT) hm_s[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    // q, k, v of this block's rows and this head: columns [0, 64) q, [64, 128)
    // k, [128, 192) v, from the weight rows part * C + h * 64 + d
    {
      using F = Frag<2, T>;
      float acc[2 * kGTN];
#pragma unroll
      for (int e = 0; e < 2 * kGTN; ++e) acc[e] = 0.f;
      auto row_of = [=](int col) { return (col >> 6) * c + h * kDH + (col & 63); };
      gemm_global_a<2>(acc, xn_b, c, q0, n, wqkv, c, row_of, c, stage);
#pragma unroll
      for (int e = 0; e < 2 * kGTN; ++e) {
        const int r = F::row(e), col = F::col(e), part = col >> 6, d = col & 63;
        const float v = round_to<T>(__fadd_rn(acc[e], to_f(bqkv[row_of(col)])));
        if (part == 0) q_s[r * kDH + d] = v;
        else if (part == 1) k_own[r * kKVStride + d] = v;
        else v_own[r * kKVStride + d] = v;
      }
    }
    cluster.sync();   // every block's K and V of this head are in place

    // S tile, 64 keys (two blocks' rows) at a time.  Thread: one key, 8 rows.
    {
      constexpr int kRows = kQB * kKC / kGT, kStep = kGT / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // the previous chunk is consumed
        copy_chunk(kv_s, k_own, k0 / kQB, blocks, cluster);
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
            const float4 qv = reinterpret_cast<const float4*>(q_s + (rg + i * kStep) * kDH)[d4];
            acc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
        const int k = k0 + kj;
        if (k < n) {
          const float km = km_s[k];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = rg + i * kStep;
            float s = __fadd_rn(__fmul_rn(acc[i], scale), __fmul_rn(fg_s[r], km));
            if (CLAMP) s = fminf(s, 80.f);
            s_s[r * ns + k] = s;
          }
        }
      }
      __syncthreads();
    }

    // Softmax, one warp per row.  Adds the normalized P into the head mean
    // and the cls row; leaves in s_s what the product with V consumes.
    for (int r = warp; r < kQB; r += kGT / 32) {
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
      const bool hm_row = ROLLOUT && q0 + r < n;
      const bool cls_row = has_cls && r == 0;
      for (int k = lane; k < ns; k += 32) {
        if (k >= n) {
          row[k] = 0.f;
          continue;
        }
        const float e = row[k], p = e / sum;
        if (hm_row) hm_s[r * ns + k] += p;
        if (cls_row) cls_s[k] += p;
        row[k] = round_to<T>(ROLLOUT ? p : e);
      }
      if (lane == 0) den_s[r] = sum;
    }

    // O = P V, 64 keys at a time.  Thread: one column d, 8 rows.
    {
      constexpr int kRows = kQB * kDH / kGT, kStep = kGT / kDH;
      const int d = tid % kDH, rg = tid / kDH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; the previous chunk is consumed
        copy_chunk(kv_s, v_own, k0 / kQB, blocks, cluster);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
          const float v0 = kv_s[(j + 0) * kKVStride + d];
          const float v1 = kv_s[(j + 1) * kKVStride + d];
          const float v2 = kv_s[(j + 2) * kKVStride + d];
          const float v3 = kv_s[(j + 3) * kKVStride + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 p =
                *reinterpret_cast<const float4*>(s_s + (rg + i * kStep) * ns + k0 + j);
            acc[i] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        const float o = ROLLOUT ? acc[i] : acc[i] / den_s[r];
        attn_s[r * cs + h * kDH + d] = from_f<T>(o);
      }
    }
    // no block overwrites its K and V (or leaves) while another reads them
    cluster.sync();
  }

  if (has_cls)
    for (int k = tid; k < n; k += kGT) cls[size_t(b) * n + k] = from_f<T>(cls_s[k] / heads);

  if constexpr (ROLLOUT) {
    for (int i = tid; i < kQB * ns; i += kGT) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    // newj[b, q0 + r, k] = (sum_j hm[r, j] J[b, j, k] + J[b, q0 + r, k]) / 2.
    // Thread: one column k, all kQB rows; hm_s reads are warp broadcasts.
    const float* jb = joint + size_t(b) * n * n;
    float* nb = newj + size_t(b) * n * n;
    for (int k = tid; k < n; k += kGT) {
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

  // out = tokens + round(O) Wproj^T + bproj, 384 columns at a time
  {
    using F = Frag<4, T>;
    constexpr int kBN = Tile<4>::kBN;
    for (int c0 = 0; c0 < c; c0 += kBN) {
      float acc[4 * kGTN];
#pragma unroll
      for (int e = 0; e < 4 * kGTN; ++e) acc[e] = 0.f;
      gemm_shared_a<4>(
          acc, attn_s, cs, wproj, c, [=](int col) { return c0 + col < c ? c0 + col : -1; }, 0,
          c, c, stage);
#pragma unroll
      for (int e = 0; e < 4 * kGTN; ++e) {
        const int col = c0 + F::col(e), r = q0 + F::row(e);
        if (col >= c || r >= n) continue;
        const size_t o = (size_t(b) * n + r) * c + col;
        out[o] = from_f<T>(__fadd_rn(to_f(tok[o]), __fadd_rn(acc[e], to_f(bproj[col]))));
      }
    }
  }
}

struct Args {
  const void *xn, *tok, *wqkv, *bqkv, *wproj, *bproj, *bg, *joint;
  void *out, *cls, *newj;
  int batch, n, heads, cluster;
  float scale, mask_value;
};

template <typename T, bool ROLLOUT, bool CLAMP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = attention_block_kernel<T, ROLLOUT, CLAMP>;
  const size_t smem = layout<T>(a.n, a.heads * kDH, ROLLOUT).total;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.cluster, a.batch);
  config.blockDim = dim3(kGT);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(a.xn), static_cast<const T*>(a.tok),
      static_cast<const T*>(a.wqkv), static_cast<const T*>(a.bqkv),
      static_cast<const T*>(a.wproj), static_cast<const T*>(a.bproj),
      static_cast<const float*>(a.bg), static_cast<const float*>(a.joint),
      static_cast<T*>(a.out), static_cast<T*>(a.cls), static_cast<float*>(a.newj), a.n,
      a.heads, a.scale, a.mask_value);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_variant(bool rollout, int clamp, const Args& a, cudaStream_t stream) {
  if (rollout)
    return clamp ? launch<T, true, true>(a, stream) : launch<T, true, false>(a, stream);
  return clamp ? launch<T, false, true>(a, stream) : launch<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// xn, tok, out [B, N, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C] and
// cls [B, N] of dtype 0 = float32 or 1 = bfloat16; bg [B, N] float32; joint
// and newj [B, N, N] float32, both null without the rollout.  cluster: blocks
// per image, at least ceil(N / 32) and at most 8.  Returns a cudaError_t; 0
// means the kernel was launched.
int vitcam_attention_block_fused(const void* xn, const void* tok, const void* wqkv,
                                 const void* bqkv, const void* wproj, const void* bproj,
                                 const void* bg, const void* joint, void* out, void* cls,
                                 void* newj, int batch, int n, int heads, int head_dim,
                                 float scale, float mask_value, int dtype, int clamp,
                                 int cluster, void* stream) {
  if (head_dim != kDH || batch < 1 || batch > 65535 || n < 1 || heads < 1)
    return cudaErrorInvalidValue;
  if (cluster > kMaxCluster || cluster * kQB < n) return cudaErrorInvalidValue;
  if ((joint == nullptr) != (newj == nullptr)) return cudaErrorInvalidValue;
  const Args a{xn,  tok,  wqkv,  bqkv, wproj, bproj, bg,      joint,     out,
               cls, newj, batch, n,    heads, cluster, scale, mask_value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_variant<float>(joint != nullptr, clamp, a, s);
    case 1:
      return launch_variant<__nv_bfloat16>(joint != nullptr, clamp, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t vitcam_attention_block_smem_bytes(int n, int heads, int rollout, int dtype) {
  return dtype == 1 ? layout<__nv_bfloat16>(n, heads * kDH, rollout != 0).total
                    : layout<float>(n, heads * kDH, rollout != 0).total;
}

}  // extern "C"
