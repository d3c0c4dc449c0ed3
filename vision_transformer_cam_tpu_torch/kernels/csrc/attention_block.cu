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
// [C, 192] GEMM from xn and the weight rows of that head); K and V are
// computed once per image and never leave the chip.  The head's output lands
// in a [32, C] tile in shared memory, which the proj GEMM consumes at the
// end, so no float atomics and no dependence on block order.  The weights
// are read in the torch layout [out, in] and stream from L2.  The two GEMMs
// go through tile_gemm.cuh: mma.sync on the tensor cores at bf16, f32 FMAs
// at float32.
//
// Two designs of the attention core.
//
// The FMA design (float32, and bf16 where it is asked for): each block keeps
// its own rows of K and V as float32; after a cluster barrier the core pulls
// the cluster's rows 64 keys at a time through distributed shared memory into
// a float32 chunk, and forms QK^T, the softmax (exact in one pass over a
// [32, N] float32 tile of S) and P V as float32 FMAs on the CUDA cores, as
// masked_attention.cu's FMA design does.  float32 stays on it: its gates need
// full float32 products.
//
// The tensor-core design (bf16): every block holds the whole head's K and V
// as bf16, in swizzled [Np, 64] tiles (Np = 32 x blocks).  Each block rounds
// its own 32 rows as the qkv GEMM's epilogue rounds them, writes them into
// its tiles and pushes them, 16 bytes a store, into the same rows of every
// other block's tiles through distributed shared memory; one cluster barrier
// then publishes the head, and the core reads only local shared memory, with
// no barrier per chunk.  The 8 warps split the work into two m16 tiles of
// query rows by four groups of 16-key chunks (warp w: tile w % 2, chunks
// w / 2, w / 2 + 4, ...).  QK^T and P V run on mma.sync.m16n8k16 from
// ldmatrix fragments, and S stays in registers: a warp holds at most four
// chunks (N <= 256), 32 floats of S.  Two passes over them a head: the first
// forms S and each row's sum of exponentials (and its maximum without the
// clamp; with it, whose maximum is 0, it keeps the exponentials in place of
// S), whose four partials meet in shared memory; the second forms P, adds it
// into the head mean and the cls row and feeds it, rounded to bf16 in
// registers, to P V; the four partial O tiles are summed in shared memory in
// one order.  The head mean, the [32, N] float32 state that crosses heads,
// lives in shared memory, each element owned by one thread: fixed order, no
// atomics.  Exponentials and probabilities below 2^-126 are flushed to zero
// (a masked logit is s - 100, and exp(-100) is a float32 denormal, on whose
// slow path exp would otherwise run); the TPU flushes them too.  The barrier
// that frees the K and V tiles for the next head is split: a block arrives
// when its core has read them and waits only after its next qkv GEMM, so the
// GEMM hides the wait.  The rollout product runs in float32 FMAs from the
// head-mean tile (rollout_rows, shared with masked_attention.cu).
//
// What bounds it on this card.  At ViT-B/16 (N = 197, C = 768, H = 12), batch
// 64 and with the rollout, a call is 67 GFLOP (qkv 44.6, proj 14.9, QK^T and
// PV 7.6) plus 0.98 GFLOP for hm @ J against 83 MB: bound by operations,
// 0.068 ms at the bf16 tensor-core peak.  Shared memory holds one block an SM
// in either design (bf16 at N = 197: 169,280 bytes in the FMA design, 210,304
// in the tensor-core design, whose K and V tiles take 57,344 and its [32, C]
// output tile 49,664); each of the 448 blocks streams all of Wqkv and Wproj
// (4.7 MB) from L2 for its 32 rows.
//
// Limits: head width 64; N <= 256 (a cluster has at most 8 blocks); C as
// far as the layout fits the 232,448 bytes a block may hold (bf16 at N =
// 197: C = 1024, 226,688 bytes).  The launch fails past them; the wrapper
// (kernels.attention.block_design) sends those shapes to the streamed
// design, attention_block_streamed.cuh.
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
constexpr int kChunk = 16;           // tensor-core design: keys of a chunk
constexpr int kKG = kGT / 32 / 2;    // ... and its groups of chunks (4)
constexpr int kMine = kMaxCluster * kQB / kChunk / kKG;   // chunks a warp holds (4)
constexpr int kOStride = kDH + 8;    // float row pitch of the O exchange

enum Design { kFma = 0, kTensorCore = 1 };

// the cluster barrier in two halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// offsets, in bytes, of the block's shared memory: the FMA design
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

// ... and the tensor-core design (bf16); every offset a multiple of 16
struct TcSmem {
  int attn, hm, k, v, q, cls, km, fg, den, st, u, total;
};

__host__ __device__ inline int tc_rows(int n) { return (n + kQB - 1) / kQB * kQB; }
__host__ __device__ inline int tc_keys(int n) { return (n + kChunk - 1) / kChunk * kChunk; }
__host__ __device__ inline int tc_hm_stride(int n) { return ((n + 31) & ~31) + 8; }

__host__ __device__ inline TcSmem tc_layout(int n, int c, bool rollout) {
  const int f = sizeof(float), nk = tc_keys(n);
  TcSmem s;
  int o = 0;
  s.attn = o, o += kQB * (c + a_pad<bf16>()) * 2;          // all heads' output
  s.hm = o, o += rollout ? kQB * tc_hm_stride(n) * f : 0;  // sum of P over heads
  s.k = o, o += tc_rows(n) * kDH * 2;                      // the head's K, V:
  s.v = o, o += tc_rows(n) * kDH * 2;                      //   swizzled [Np][64]
  s.q = o, o += kQB * kDH * 2;                             // swizzled [kQB][64]
  s.cls = o, o += nk * f;
  s.km = o, o += nk * f;                                   // key mask
  s.fg = o, o += kQB * f;                                  // 1 - bg_q
  s.den = o, o += kQB * f;                                 // softmax sums
  s.st = o, o += kKG * kQB * 2 * f;                        // row max, sum per group
  s.u = o;
  // the GEMMs' staging and the partial O tiles are never live together
  const int gemm = stage_bytes<bf16, 4>();
  const int ox = kKG * kQB * kOStride * f;
  s.total = o + (gemm > ox ? gemm : ox);
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

// the weight row of column col of head h's q | k | v tile: [0, 64) q,
// [64, 128) k, [128, 192) v
struct QkvRows {
  int c, h;
  __device__ int operator()(int col) const { return (col >> 6) * c + h * kDH + (col & 63); }
};

// q, k and v of rows q0.. of this block and head h (two m16 tiles by 192
// columns, Frag<2, T>)
template <typename T>
__device__ __forceinline__ void qkv_gemm(float (&acc)[2 * kGTN], const T* xn_b, int q0, int n,
                                         const T* __restrict__ wqkv, int c, int h, void* stage) {
#pragma unroll
  for (int e = 0; e < 2 * kGTN; ++e) acc[e] = 0.f;
  gemm_global_a<2>(acc, xn_b, c, q0, n, wqkv, c, QkvRows{c, h}, c, stage);
}

// the cls row, from this image's first block
template <typename T>
__device__ __forceinline__ void store_cls(T* cls, const float* cls_s, int b, int n, int heads) {
  for (int k = threadIdx.x; k < n; k += kGT) cls[size_t(b) * n + k] = from_f<T>(cls_s[k] / heads);
}

// out = tokens + round(O) Wproj^T + bproj, 384 columns at a time
template <typename T>
__device__ __forceinline__ void proj_out(const T* attn_s, int cs, const T* __restrict__ wproj,
                                         const T* __restrict__ bproj, const T* __restrict__ tok,
                                         T* __restrict__ out, int b, int q0, int n, int c,
                                         void* stage) {
  using F = Frag<4, T>;
  constexpr int kBN = Tile<4>::kBN;
  for (int c0 = 0; c0 < c; c0 += kBN) {
    float acc[4 * kGTN];
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) acc[e] = 0.f;
    gemm_shared_a<4>(
        acc, attn_s, cs, wproj, c, [=](int col) { return c0 + col < c ? c0 + col : -1; }, 0, c,
        c, stage);
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) {
      const int col = c0 + F::col(e), r = q0 + F::row(e);
      if (col >= c || r >= n) continue;
      const size_t o = (size_t(b) * n + r) * c + col;
      out[o] = from_f<T>(__fadd_rn(to_f(tok[o]), __fadd_rn(acc[e], to_f(bproj[col]))));
    }
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
    {
      using F = Frag<2, T>;
      float acc[2 * kGTN];
      qkv_gemm(acc, xn_b, q0, n, wqkv, c, h, stage);
      const QkvRows row_of{c, h};
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

  if (has_cls) store_cls(cls, cls_s, b, n, heads);
  if constexpr (ROLLOUT) {
    for (int i = tid; i < kQB * ns; i += kGT) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    rollout_rows<kQB, kGT, 1>(hm_s, ns, joint, newj, b, q0, n);
  }
  proj_out(attn_s, cs, wproj, bproj, tok, out, b, q0, n, c, stage);
}

// The tensor-core design (bf16); see the head of this file.  One block an SM
// (its shared memory), so its threads may hold up to 255 registers.
template <bool ROLLOUT, bool CLAMP>
__global__ void __launch_bounds__(kGT, 1)
attention_block_tc_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ tok,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                          const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                          const float* __restrict__ bg, const float* __restrict__ joint,
                          bf16* __restrict__ out, bf16* __restrict__ cls,
                          float* __restrict__ newj, int n, int heads, float scale,
                          float mask_value) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = heads * kDH, cs = c + a_pad<bf16>(), hs = tc_hm_stride(n);
  const TcSmem lay = tc_layout(n, c, ROLLOUT);
  auto floats = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  bf16* attn_s = reinterpret_cast<bf16*>(smem + lay.attn);
  float* hm_s = floats(lay.hm);
  bf16* k_s = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  float* cls_s = floats(lay.cls);
  float* km_s = floats(lay.km);
  float* fg_s = floats(lay.fg);
  float* den_s = floats(lay.den);
  float* st_s = floats(lay.st);              // [kKG][kQB][2]: max, sum
  void* stage = smem + lay.u;                // GEMM staging ...
  float* ox = floats(lay.u);                 // ... or [kKG][kQB][kOStride] partial O

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, blocks = gridDim.x, rank = blockIdx.x, q0 = rank * kQB;
  const int mt = warp & 1, kg = warp >> 1, r0 = mt * 16;   // this warp's tile, chunk group
  const int n_chunks = tc_keys(n) / kChunk;
  const bf16* xn_b = xn + size_t(b) * n * c;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;

  for (int k = tid; k < tc_keys(n); k += kGT) {
    km_s[k] = k < n ? bg_b[k] * mask_value : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < kQB; r += kGT) fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  if (ROLLOUT)
    for (int i = tid; i < kQB * hs; i += kGT) hm_s[i] = 0.f;
  __syncthreads();
  float fg[2];
  bool row_ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    fg[hf] = fg_s[r0 + g + 8 * hf];
    row_ok[hf] = q0 + r0 + g + 8 * hf < n;
  }
  // every block of the cluster has started, and its K and V tiles are free
  cluster_arrive();

  for (int h = 0; h < heads; ++h) {
    {
      using F = Frag<2, bf16>;
      float acc[2 * kGTN];
      qkv_gemm(acc, xn_b, q0, n, wqkv, c, h, stage);
      const QkvRows row_of{c, h};
      // every block has read the previous head's K and V
      cluster_wait();
      // this block's rows of q, k and v, rounded to bf16 (zeros past n)
#pragma unroll
      for (int e = 0; e < 2 * kGTN; e += 2) {
        const int r = F::row(e), col = F::col(e), part = col >> 6, d = col & 63;
        const unsigned v =
            q0 + r < n ? pack_bf16(__fadd_rn(acc[e], to_f(bqkv[row_of(col)])),
                                   __fadd_rn(acc[e + 1], to_f(bqkv[row_of(col + 1)])))
                       : 0u;
        bf16* dst = part == 0 ? q_s + swz(r, d) : (part == 1 ? k_s : v_s) + swz(q0 + r, d);
        *reinterpret_cast<unsigned*>(dst) = v;
      }
      __syncthreads();
      // ... pushed into the same rows of every other block's K and V tiles
      for (int i = tid; i < 2 * kQB * (kDH / 8); i += kGT) {
        bf16* tile = i < kQB * (kDH / 8) ? k_s : v_s;
        const int off = q0 * kDH + (i % (kQB * (kDH / 8))) * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(tile + off);
        for (int dst = 0; dst < blocks; ++dst)
          if (dst != rank) *reinterpret_cast<uint4*>(cluster.map_shared_rank(tile, dst) + off) = v;
      }
    }
    cluster_arrive();
    cluster_wait();   // every block's K and V of this head are in place

    unsigned qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(qa[kk], q_s + swz(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8));
    // S of one chunk: scaled, masked, clamped; -inf on keys >= n
    auto logits = [&](float (&s)[2][4], int k0) {
      const bf16* kc = k_s + k0 * kDH;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          unsigned kb[4];
          b_rows(kb, kc, nt, kp, lane);
          mma16816(s[nt], qa[2 * kp], kb[0], kb[1]);
          mma16816(s[nt], qa[2 * kp + 1], kb[2], kb[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + nt * 8 + 2 * tg + (e & 1);
          float v = -INFINITY;
          if (k < n) {
            v = __fadd_rn(__fmul_rn(s[nt][e], scale), __fmul_rn(fg[e >> 1], km_s[k]));
            if (CLAMP) v = fminf(v, 80.f);
          }
          s[nt][e] = v;
        }
      }
    };

    // pass 1: per row the maximum (without the clamp) and the sum of exp.
    // The warp's logits of the head stay in registers for pass 2 (with the
    // clamp, whose maximum is 0, their exponentials).
    float sv[kMine][2][4];
    float m[2], l[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) m[hf] = CLAMP ? 0.f : -INFINITY, l[hf] = 0.f;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      if (kg + i * kKG >= n_chunks) continue;   // warp-uniform
      float (&s)[2][4] = sv[i];
      logits(s, (kg + i * kKG) * kChunk);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!CLAMP) {
          const float nm = fmaxf(m[hf], quad_max(fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                                                       fmaxf(s[1][2 * hf], s[1][2 * hf + 1]))));
          l[hf] = nm == m[hf] ? l[hf] : l[hf] * exp_ftz(m[hf] - nm);
          m[hf] = nm;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float ex = exp_ftz(s[nt][e] - m[hf]);
            if (CLAMP) s[nt][e] = ex;
            l[hf] += ex;
          }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lsum = quad_sum(l[hf]);
      if (tg == 0) {
        float* st = st_s + (kg * kQB + r0 + g + 8 * hf) * 2;
        st[0] = m[hf];
        st[1] = lsum;
      }
    }
    __syncthreads();
    // every thread combines the groups' partials of its rows, in one order
    float mx[2], inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
      float mr = CLAMP ? 0.f : -INFINITY, den = 0.f;
      if (!CLAMP)
        for (int w = 0; w < kKG; ++w) mr = fmaxf(mr, st_s[(w * kQB + r) * 2]);
      for (int w = 0; w < kKG; ++w) {
        const float* st = st_s + (w * kQB + r) * 2;
        den += CLAMP || st[0] == mr ? st[1] : st[1] * exp_ftz(st[0] - mr);
      }
      mx[hf] = mr;
      inv[hf] = 1.f / den;
      if (kg == 0 && tg == 0) den_s[r] = den;
    }

    // pass 2: P, the head mean and the cls row, O = P V
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      if (kg + i * kKG >= n_chunks) continue;   // warp-uniform
      const int k0 = (kg + i * kKG) * kChunk;
      float (&s)[2][4] = sv[i];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int k = k0 + nt * 8 + 2 * tg;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = CLAMP ? s[nt][e] : exp_ftz(s[nt][e] - mx[e >> 1]);
          p[e] = ftz(ex * inv[e >> 1]);
          s[nt][e] = ROLLOUT ? p[e] : ex;
        }
        if (ROLLOUT) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            if (row_ok[hf]) {
              float2* h2 = reinterpret_cast<float2*>(hm_s + (r0 + g + 8 * hf) * hs + k);
              *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
            }
        }
        if (has_cls && mt == 0 && g == 0) {
          cls_s[k] += p[0];
          cls_s[k + 1] += p[1];
        }
      }
      unsigned pa[4];
      a_from_c(pa, s[0], s[1]);
      const bf16* vc = v_s + k0 * kDH;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned vb[4];
        b_cols(vb, vc, 0, j, lane);
        mma16816(o[2 * j], pa, vb[0], vb[1]);
        mma16816(o[2 * j + 1], pa, vb[2], vb[3]);
      }
    }
    // this thread has read the head's K and V: the next push may land
    cluster_arrive();

    // the groups' partial O tiles meet in shared memory, summed in one order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(ox + (kg * kQB + r0 + g) * kOStride + j * 8 + 2 * tg) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(ox + (kg * kQB + r0 + g + 8) * kOStride + j * 8 + 2 * tg) =
          make_float2(o[j][2], o[j][3]);
    }
    __syncthreads();
    for (int idx = tid; idx < kQB * (kDH / 4); idx += kGT) {
      const int r = idx / (kDH / 4), d = (idx % (kDH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kKG; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(ox + (w * kQB + r) * kOStride + d);
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      if (!ROLLOUT) {
        const float den = den_s[r];
        acc.x /= den, acc.y /= den, acc.z /= den, acc.w /= den;
      }
      *reinterpret_cast<uint2*>(attn_s + r * cs + h * kDH + d) =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
    // the next qkv GEMM's first barrier frees ox for its staging
  }
  // no block leaves while another may still push into it
  cluster_wait();

  if (has_cls) store_cls(cls, cls_s, b, n, heads);
  if constexpr (ROLLOUT) {
    for (int i = tid; i < kQB * hs; i += kGT) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    rollout_rows<kQB, kGT, 4>(hm_s, hs, joint, newj, b, q0, n);
  }
  proj_out(attn_s, cs, wproj, bproj, tok, out, b, q0, n, c, stage);
}

struct Args {
  const void *xn, *tok, *wqkv, *bqkv, *wproj, *bproj, *bg, *joint;
  void *out, *cls, *newj;
  int batch, n, heads, cluster;
  float scale, mask_value;
};

template <typename T>
using BlockKernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                             const float*, const float*, T*, T*, float*, int, int, float, float);

// the instance of (design, rollout, clamp) at T: the tensor-core design only
// at bf16, else null
template <typename T> BlockKernel<T> pick(int design, bool rollout, bool clamp) {
  if (design == kTensorCore) {
    if constexpr (sizeof(T) == 2) {
      if (rollout)
        return clamp ? attention_block_tc_kernel<true, true> : attention_block_tc_kernel<true, false>;
      return clamp ? attention_block_tc_kernel<false, true> : attention_block_tc_kernel<false, false>;
    }
    return nullptr;
  }
  if (rollout)
    return clamp ? attention_block_kernel<T, true, true> : attention_block_kernel<T, true, false>;
  return clamp ? attention_block_kernel<T, false, true> : attention_block_kernel<T, false, false>;
}

template <typename T> size_t smem_bytes(int design, int n, int c, bool rollout) {
  return design == kTensorCore ? tc_layout(n, c, rollout).total : layout<T>(n, c, rollout).total;
}

// the launch configuration of one cluster of `cluster` blocks per image, with
// the instance's shared memory granted; `attr` must outlive `config`
template <typename T>
cudaError_t configure(BlockKernel<T> kernel, size_t smem, int cluster, int batch,
                      cudaStream_t stream, cudaLaunchAttribute& attr,
                      cudaLaunchConfig_t& config) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  config = {};
  config.gridDim = dim3(cluster, batch);
  config.blockDim = dim3(kGT);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int design, int clamp, const Args& a, cudaStream_t stream) {
  const bool rollout = a.joint != nullptr;
  const BlockKernel<T> kernel = pick<T>(design, rollout, clamp);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cudaError_t err = configure<T>(kernel, smem_bytes<T>(design, a.n, a.heads * kDH, rollout),
                                 a.cluster, a.batch, stream, attr, config);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(a.xn), static_cast<const T*>(a.tok),
      static_cast<const T*>(a.wqkv), static_cast<const T*>(a.bqkv),
      static_cast<const T*>(a.wproj), static_cast<const T*>(a.bproj),
      static_cast<const float*>(a.bg), static_cast<const float*>(a.joint),
      static_cast<T*>(a.out), static_cast<T*>(a.cls), static_cast<float*>(a.newj), a.n,
      a.heads, a.scale, a.mask_value);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// info = {clusters that fit on the card at once, registers per thread, local
// memory per thread (bytes: spills and stack), shared memory per block}
template <typename T>
cudaError_t occupancy(int design, int n, int heads, bool rollout, int clamp, int* info) {
  const BlockKernel<T> kernel = pick<T>(design, rollout, clamp);
  const size_t smem = smem_bytes<T>(design, n, heads * kDH, rollout);
  const int cluster = (n + kQB - 1) / kQB;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cudaError_t err = configure<T>(kernel, smem, cluster, 1, nullptr, attr, config);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(&info[0], kernel, &config);
  info[1] = fa.numRegs;
  info[2] = int(fa.localSizeBytes);
  info[3] = int(smem);
  return err;
}

}  // namespace

extern "C" {

// xn, tok, out [B, N, C], wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C] and
// cls [B, N] of dtype 0 = float32 or 1 = bfloat16; bg [B, N] float32; joint
// and newj [B, N, N] float32, both null without the rollout.  cluster: blocks
// per image, at least ceil(N / 32) and at most 8.  design: 0 = the FMA design
// (both dtypes), 1 = the tensor-core design (bfloat16, cluster = ceil(N /
// 32)).  Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_attention_block_fused(const void* xn, const void* tok, const void* wqkv,
                                 const void* bqkv, const void* wproj, const void* bproj,
                                 const void* bg, const void* joint, void* out, void* cls,
                                 void* newj, int batch, int n, int heads, int head_dim,
                                 float scale, float mask_value, int dtype, int clamp,
                                 int cluster, int design, void* stream) {
  if (head_dim != kDH || batch < 1 || batch > 65535 || n < 1 || heads < 1)
    return cudaErrorInvalidValue;
  if (cluster > kMaxCluster || cluster * kQB < n) return cudaErrorInvalidValue;
  if ((joint == nullptr) != (newj == nullptr)) return cudaErrorInvalidValue;
  if (design != kFma && (design != kTensorCore || dtype != 1 || cluster != tc_rows(n) / kQB))
    return cudaErrorInvalidValue;
  const Args a{xn,  tok,  wqkv,  bqkv, wproj, bproj, bg,      joint,     out,
               cls, newj, batch, n,    heads, cluster, scale, mask_value};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(design, clamp, a, s);
    case 1:
      return launch<__nv_bfloat16>(design, clamp, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t vitcam_attention_block_smem_bytes(int n, int heads, int rollout, int dtype, int design) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(design, n, heads * kDH, rollout != 0)
                    : smem_bytes<float>(kFma, n, heads * kDH, rollout != 0);
}

// The occupancy of one instance on this card at N (clusters of ceil(N / 32)
// blocks): info[4] as occupancy() above.  Returns a cudaError_t.
int vitcam_attention_block_occupancy(int n, int heads, int rollout, int clamp, int dtype,
                                     int design, int* info) {
  if (n < 1 || n > kMaxCluster * kQB || heads < 1 || design < kFma || design > kTensorCore)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return occupancy<float>(design, n, heads, rollout != 0, clamp, info);
    case 1:
      return occupancy<__nv_bfloat16>(design, n, heads, rollout != 0, clamp, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
