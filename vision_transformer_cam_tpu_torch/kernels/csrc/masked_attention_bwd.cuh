// Fused backward of the masked multi-head attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_transformer_cam_tpu/kernels/attention.py:
// _attn_bwd_kernel (entry point masked_attention_bwd).  Per image and head,
// on the packed qkv [B, N, 3C] (heads contiguous inside q|k|v) and the output
// cotangent dO [B, N, C], it recomputes the probabilities and writes the packed
// d_qkv [B, N, 3C]:
//
//   S  = Q K^T * scale + (1 - bg_q) * (mask_value * bg_k)   (rank-1 mask)
//   S  = min(S, 80)  (clamp, differentiated as the identity)  or  S - rowmax(S)
//   P  = softmax(S)                                     (f32)
//   dV = Pb^T dO          dP = dO V^T
//   dS = (P * (dP - rowsum(dP * P))) * scale            (f32)
//   dQ = dSb K            dK = dSb^T Q
//
// Pb and dSb are P and dS rounded to qkv's element type before the products
// they feed, as the TPU kernel casts them; every sum is f32.  bg gets no
// gradient and the cotangent of the cls row is dropped, as there.  P, dP and
// dS, [B, H, N, N] each, never reach device memory.
//
// The head width dh is a template parameter, DH: 64 (ViT-S/B/L) and 80
// (ViT-H/14) are compiled, each in its own translation unit
// (masked_attention_bwd.cu, which holds the C entry points, and
// masked_attention_bwd_w80.cu, so that nvcc builds the two in parallel); the C
// entry point dispatches on head_dim.
//
// What bounds it on this card.  At ViT-B/16 (N=197, C=768, H=12) and batch 64
// a call reads qkv and dO and writes d_qkv, 7 * B*N*C elements: 135.6 MB in
// bf16, 0.040 ms at 3.35 TB/s.  Its five products are 5*2*N*N*64*H*B =
// 19.1 GFLOP, 0.019 ms at the bf16 tensor-core peak: bound by bytes.  At
// ViT-L/16@512 (N=1025, B=16) the products (172 GFLOP) bound it.  The FMA
// designs run them on the CUDA cores fed from shared memory (67 TFLOP/s
// peak), so the FMA pipes, shared-memory traffic and barriers bound them.
//
// Every design keeps each accumulator element in one thread: dK and dV sum
// over every query row, so a block that owned a query tile (the forward's
// layout) could only add its share with atomics, in an order that changes
// from run to run.  In each the order of the sums is fixed and the result
// deterministic.  Three designs:
//
// The tensor-core design (bf16): two kernels, every product on
// mma.sync.m16n8k16 (bf16 in, float32 sums), blocks of 4 warps.
// masked_attention_bwd_tc_dq_kernel owns 64 query rows (a warp 16, its Q and
// dO fragments in registers), grid (ceil(N / 64), H, B).  It stages K and V
// 64 keys at a time as bf16 with 16-byte cp.async copies into a two-stage
// ring of BfTile<DH> tiles (no conversion pass, one barrier a stage) and walks
// the keys twice: pass 1 forms S = Q K^T and dP = dO V^T in registers and
// each row's maximum, sum of exponentials and rowsum(dP * P) (float32 P, as
// the reference forms it, rescaled as the maximum grows: over 17 slabs at N =
// 1025); pass 2 forms them again, then P, dS, and dQ += dSb K with dSb rounded
// to bf16 in registers (the m16n8 accumulator layout is the A fragment's), K
// entering transposed through ldmatrix.trans.  It writes dQ and per row (max,
// 1 / sum, rowsum) to the [B, H, N, 3] scratch.
// masked_attention_bwd_tc_dkv_kernel owns 64 keys (a warp 16), grid
// (ceil(N / 64), H, B): it stages Q and dO 64 rows at a time the same way with
// those rows' statistics, forms S^T = K Q^T and dP^T = V dO^T, rebuilds P and
// dS with the first kernel's expressions and adds Pb^T dO and dSb^T Q into dV
// and dK, which stay in registers.  Its shared memory is the same whatever N
// is, and the dQ kernel's grows by one float a key (the key-mask row): the
// design's own limit is far past any N its float32 twin takes.  S and dP are
// formed twice in the first kernel and once more in the second: the products
// are cheap on the tensor cores, and 3072 blocks of 128 threads at B=64,
// N=197 keep every SM busy with 33 KB of shared memory a block.  At head
// width 64 the tiles are swizzled [rows][64]; at 80 they are rows of 88
// elements (176 bytes: eleven 16-byte segments, so the eight rows an ldmatrix
// reads lie in eight bank groups without a swizzle), QK^T and dO V^T take
// five k16 steps (two ldmatrix pairs and one ldmatrix of the last step of
// both n8 key tiles) and dQ, dK and dV ten n8 tiles.  A warp of the dK / dV
// kernel holds dK and dV for 16 keys in 2 * DH / 2 floats a thread (80 at
// width 80); at 64 it keeps its K and V fragments in registers too (32), at
// 80 (40 more) it reads them by ldmatrix from a [64][88] tile of the block's
// keys staged once (kKvSmem).  Exponentials and probabilities below 2^-126
// are flushed to zero (a masked logit is s - 100, and exp(-100) is a float32
// denormal, on whose slow path exp would otherwise run); the TPU flushes them
// too.  P is E times 1 / sum where the reference divides: an ulp apart.
//
// The FMA designs, float32 (and bf16 where they are asked for, to time them
// beside the tensor-core design).  One block per (image, head)
// (masked_attention_bwd_kernel): the block keeps dK and dV [N, DH] in f32 in
// shared memory, walks the query rows in tiles of kQB = 32, and per tile
// (query_tile)
//   1. stages Q and dO rows, then K (V) in 64-key chunks, and forms the S and
//      dP tiles [32, N] in shared memory (thread: one key, four rows);
//   2. one warp per row: softmax, rowsum(dP * P), dS; leaves Pb and dSb;
//   3. stages K again in chunks for dQ = dSb K (thread: one column, every
//      kThreads / DH-th row) and stores the tile's dQ rows;
// then adds Pb^T dO and dSb^T Q into dV and dK: a thread owns one column d
// and every (kThreads / DH)-th group of 4 keys (8 groups at width 64; at 80
// six, and the last 32 threads sit this step out), holds its column of dO and
// Q (32 values each) in registers and reads Pb / dSb as float4 broadcasts.  At
// the end it stores dK and dV.  Shared memory is (2 * DH + 64) * ceil4(N) + N
// + 64 * DH + 64 * (DH + 4) + 32 floats: at 64 (192 * ceil4(N) + N + 8480) for
// N <= 256, at 80 (224 * ceil4(N) + N + 10528) for N <= 208, of the 227 KB a
// block may use.  One block (512 threads) fits per SM; the grid is (H, B).
//
// Two FMA kernels, past the one-block limit.  masked_attention_bwd_dq_kernel
// runs query_tile for one query tile per block, grid (ceil(N / QB), H, B), and
// also writes each row's softmax statistics (row max, sum of exponentials,
// rowsum(dP * P)) to the [B, H, N, 3] f32 scratch: (2 QB * ceil4(N) + N + 2 QB
// * DH + 64 * (DH + 4) + QB) floats of shared memory.  QB is 32 where that
// fits (N <= 760 at width 64, 732 at 80) and 16 past it, as kernel 1's FMA
// design halves its query tile past 780: (32 * ceil4(N) + N + 6416) floats at
// 64 and (32 * ceil4(N) + N + 7952) at 80 take N <= 1564 and 1520.
// masked_attention_bwd_dkv_kernel owns 64 keys of one (image, head), grid
// (ceil(N / 64), H, B): it stages their K and V once, walks the query tiles of
// 32 rows, recomputes the [32, 64] pieces of S and dP, rebuilds P and dS from
// the row statistics with the first kernel's expressions, and sums dV and dK
// in registers (column d and every (kThreads / DH)-th group of 4 keys: two
// groups a thread at 64, at most three at 80).  It pays two more products
// (seven in all) for a shared memory of 69 KB (81 KB at 80) whatever N is.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#pragma once

#include <cmath>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kQB = 32;              // query rows per tile (the dQ kernel: 32 or 16)
constexpr int kStats = 3;            // per row statistics, see the designs
constexpr int kOneBlock = 0, kTwoKernel = 1, kTensorCore = 2;   // the designs
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may ask for

// shared memory of query_tile at QB rows: Q and dO tiles, a K / V chunk, the
// S / P and dP / dS tiles, 1 - bg_q and the key mask
template <int QB, int DH> size_t tile_floats(int n) {
  return 2 * size_t(QB) * DH + size_t(kKC) * kKVStrideOf<DH> + 2 * size_t(QB) * padded(n) +
         QB + n;
}

// shared memory of the dK / dV kernel: K and V tiles, Q and dO tiles, Pb and
// dSb pieces, the rows' statistics and 1 - bg_q, the key mask
template <int DH>
constexpr size_t kDkvFloats = 2 * size_t(kKC) * kKVStrideOf<DH> + 2 * size_t(kQB) * DH +
                              2 * size_t(kQB) * kKC + size_t(kQB) * (kStats + 1) + kKC;

// the dQ kernel's query rows at N: 32 where its tiles fit, else 16
template <int DH> int dq_rows(int n) {
  return tile_floats<kQB, DH>(n) * sizeof(float) <= kMaxSmem ? kQB : kQB / 2;
}

// bytes of the one-block design, or of the two-kernel design (the larger of
// its two kernels' needs)
template <int DH> size_t bwd_smem_bytes(int n, bool split) {
  if (!split) return (tile_floats<kQB, DH>(n) + 2 * size_t(padded(n)) * DH) * sizeof(float);
  const size_t dq = dq_rows<DH>(n) == kQB ? tile_floats<kQB, DH>(n) : tile_floats<kQB / 2, DH>(n);
  return (dq > kDkvFloats<DH> ? dq : kDkvFloats<DH>) * sizeof(float);
}

// out_s[r, k] = sum_d a_s[r, d] * X[k, d] for the tile's QB rows and every
// key, X = this head's K or V (column offset col), staged in chunks.  With
// IS_S the scale, the rank-1 mask and the clamp are applied.  Thread: one key
// of the chunk, QB / (kThreads / kKC) rows.
template <typename T, bool IS_S, bool CLAMP, int QB, int DH>
__device__ __forceinline__ void rows_times_keys(const float* a_s, float* kv_s, float* out_s,
                                                const T* __restrict__ qkv_b, int col, int n,
                                                int ns, int c3, float scale,
                                                const float* fg_s, const float* km_s) {
  constexpr int kRows = QB * kKC / kThreads, kStep = kThreads / kKC;
  constexpr int kStride = kKVStrideOf<DH>;
  const int kj = threadIdx.x % kKC, rg = threadIdx.x / kKC;
  for (int k0 = 0; k0 < n; k0 += kKC) {
    __syncthreads();   // a_s staged; previous chunk consumed
    stage_chunk<kThreads, T, DH>(kv_s, qkv_b, k0, n, c3, col);
    __syncthreads();
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kStride);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kv = k4[d4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 av = reinterpret_cast<const float4*>(a_s + (rg + i * kStep) * DH)[d4];
        acc[i] += av.x * kv.x + av.y * kv.y + av.z * kv.z + av.w * kv.w;
      }
    }
    const int k = k0 + kj;
    if (k < n) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        float v = acc[i];
        if (IS_S) {
          v = __fadd_rn(__fmul_rn(v, scale), __fmul_rn(fg_s[r], km_s[k]));
          if (CLAMP) v = fminf(v, 80.f);
        }
        out_s[r * ns + k] = v;
      }
    }
  }
}

// Stage rows [q0, q0 + QB) of this head's Q and dO as f32 (rows past n are
// zero) and 1 - bg of those rows.
template <typename T, int QB, int DH>
__device__ __forceinline__ void stage_qdo_rows(float* q_s, float* do_s, float* fg_s,
                                           const T* __restrict__ qkv_b,
                                           const T* __restrict__ do_b,
                                           const float* __restrict__ bg_b, int q0, int n,
                                           int h, int c) {
  for (int i = threadIdx.x; i < QB * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const bool ok = q0 + r < n;
    q_s[i] = ok ? to_f(qkv_b[size_t(q0 + r) * 3 * c + h * DH + d]) : 0.f;
    do_s[i] = ok ? to_f(do_b[size_t(q0 + r) * c + h * DH + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < QB; r += kThreads)
    fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
}

// One query tile of QB rows: leaves Pb in p_s and dSb in ds_s ([QB][ns]; rows
// past n and the padded key columns zero), Q and dO rows in q_s and do_s, and
// stores the tile's dQ rows.  With stats_bh (this image and head's [N,
// kStats]) it also stores each row's statistics.  The caller has synchronised
// the block since the last reader of these buffers, and km_s is written.
template <typename T, bool CLAMP, int QB, int DH>
__device__ __forceinline__ void query_tile(float* q_s, float* do_s, float* kv_s, float* p_s,
                                           float* ds_s, float* fg_s, const float* km_s,
                                           const T* __restrict__ qkv_b,
                                           const T* __restrict__ do_b, T* __restrict__ dqkv_b,
                                           const float* __restrict__ bg_b,
                                           float* __restrict__ stats_bh, int q0, int n,
                                           int ns, int h, int c, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c3 = 3 * c;
  constexpr int kStride = kKVStrideOf<DH>;
  stage_qdo_rows<T, QB, DH>(q_s, do_s, fg_s, qkv_b, do_b, bg_b, q0, n, h, c);

  // 1. S = Q K^T (scaled, masked) -> p_s;  dP = dO V^T -> ds_s
  rows_times_keys<T, true, CLAMP, QB, DH>(q_s, kv_s, p_s, qkv_b, c + h * DH, n, ns, c3, scale,
                                          fg_s, km_s);
  rows_times_keys<T, false, CLAMP, QB, DH>(do_s, kv_s, ds_s, qkv_b, 2 * c + h * DH, n, ns, c3,
                                           scale, fg_s, km_s);
  __syncthreads();

  // 2. One warp per row: P = softmax(S), D = rowsum(dP * P),
  //    dS = (P * (dP - D)) * scale.
  for (int r = warp; r < QB; r += kThreads / 32) {
    float* prow = p_s + r * ns;
    float* drow = ds_s + r * ns;
    float m = 0.f;   // the clamp replaces the row-max subtraction
    if (!CLAMP) {
      m = -INFINITY;
      for (int k = lane; k < n; k += 32) m = fmaxf(m, prow[k]);
      m = warp_max(m);
    }
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float e = expf(prow[k] - m);
      prow[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dsum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float p = prow[k] / sum;
      prow[k] = p;
      dsum += drow[k] * p;
    }
    dsum = warp_sum(dsum);
    const bool valid = q0 + r < n;
    if (stats_bh != nullptr && valid && lane == 0) {
      float* st = stats_bh + size_t(q0 + r) * kStats;
      st[0] = m;
      st[1] = sum;
      st[2] = dsum;
    }
    for (int k = lane; k < ns; k += 32) {
      if (k >= n || !valid) {
        prow[k] = 0.f;
        drow[k] = 0.f;
        continue;
      }
      const float p = prow[k];
      drow[k] = round_to<T>(__fmul_rn(__fmul_rn(p, drow[k] - dsum), scale));
      prow[k] = round_to<T>(p);
    }
  }

  // 3. dQ = dSb K, one K chunk at a time (the loop's first barrier also ends
  //    step 2).  Thread: column d, rows rg, rg + kStep, ... (kStep =
  //    kThreads / DH row groups: 8 at 64; at 80 six, the last kThreads % DH
  //    threads idle and each group's rows checked against QB).
  constexpr int kStep = kThreads / DH, kRows = (QB + kStep - 1) / kStep;
  constexpr bool kWhole = kThreads % DH == 0 && QB % kStep == 0;
  const int d = tid % DH, rg = tid / DH;
  const bool owner = kWhole || rg < kStep;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kKC) {
    __syncthreads();   // previous chunk consumed
    stage_chunk<kThreads, T, DH>(kv_s, qkv_b, k0, n, c3, c + h * DH);
    __syncthreads();
    if (!owner) continue;
    const int kend = min(kKC, ns - k0);   // a multiple of 4
    for (int j = 0; j < kend; j += 4) {
      const float k0v = kv_s[(j + 0) * kStride + d];
      const float k1v = kv_s[(j + 1) * kStride + d];
      const float k2v = kv_s[(j + 2) * kStride + d];
      const float k3v = kv_s[(j + 3) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!kWhole && rg + i * kStep >= QB) break;
        const float4 s = *reinterpret_cast<const float4*>(
            ds_s + (rg + i * kStep) * ns + k0 + j);
        acc[i] += s.x * k0v + s.y * k1v + s.z * k2v + s.w * k3v;
      }
    }
  }
  if (!owner) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg + i * kStep;
    if ((kWhole || r < QB) && q0 + r < n) dqkv_b[size_t(q0 + r) * c3 + h * DH + d] = from_f<T>(acc[i]);
  }
}

// The one-block design: grid (H, B).
template <typename T, bool CLAMP, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                            const T* __restrict__ d_out, T* __restrict__ d_qkv, int n,
                            int heads, float scale, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* dk_s = smem;                      // [ns][DH]
  float* dv_s = dk_s + ns * DH;            // [ns][DH]
  float* q_s = dv_s + ns * DH;             // [kQB][DH]
  float* do_s = q_s + kQB * DH;            // [kQB][DH]
  float* kv_s = do_s + kQB * DH;           // [kKC][kKVStrideOf<DH>]
  float* p_s = kv_s + kKC * kKVStrideOf<DH>;   // [kQB][ns]  S, then P, then Pb
  float* ds_s = p_s + kQB * ns;            // [kQB][ns]  dP, then dSb
  float* fg_s = ds_s + kQB * ns;           // [kQB] 1 - bg_q
  float* km_s = fg_s + kQB;                // [n] key mask

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = heads * DH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const T* do_b = d_out + size_t(b) * n * c;
  T* dqkv_b = d_qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;

  for (int i = tid; i < 2 * ns * DH; i += kThreads) dk_s[i] = 0.f;   // dK and dV
  for (int k = tid; k < n; k += kThreads) km_s[k] = bg_b[k] * mask_value;

  for (int q0 = 0; q0 < n; q0 += kQB) {
    __syncthreads();   // the previous tile's readers of q_s, do_s, fg_s, p_s, ds_s are done
    query_tile<T, CLAMP, kQB, DH>(q_s, do_s, kv_s, p_s, ds_s, fg_s, km_s, qkv_b, do_b, dqkv_b,
                                  bg_b, nullptr, q0, n, ns, h, c, scale);

    // dV += Pb^T dO, dK += dSb^T Q.  Thread: column d, every kGroups-th group
    // of 4 keys; its columns of dO and Q live in registers.  At 80 the last
    // kThreads % DH threads have no column here.
    constexpr int kGroups = kThreads / DH;
    const int d = tid % DH, kg = tid / DH;
    if (kThreads % DH != 0 && kg >= kGroups) continue;
    float dor[kQB], qr[kQB];
#pragma unroll
    for (int r = 0; r < kQB; ++r) {
      dor[r] = do_s[r * DH + d];
      qr[r] = q_s[r * DH + d];
    }
    for (int k = 4 * kg; k < ns; k += 4 * kGroups) {
      float av[4] = {0.f, 0.f, 0.f, 0.f}, ak[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < kQB; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + r * ns + k);
        const float4 s = *reinterpret_cast<const float4*>(ds_s + r * ns + k);
        av[0] += p.x * dor[r];
        av[1] += p.y * dor[r];
        av[2] += p.z * dor[r];
        av[3] += p.w * dor[r];
        ak[0] += s.x * qr[r];
        ak[1] += s.y * qr[r];
        ak[2] += s.z * qr[r];
        ak[3] += s.w * qr[r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv_s[(k + i) * DH + d] += av[i];
        dk_s[(k + i) * DH + d] += ak[i];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < n * DH; i += kThreads) {
    const int k = i / DH, d = i % DH;
    dqkv_b[size_t(k) * c3 + c + h * DH + d] = from_f<T>(dk_s[i]);
    dqkv_b[size_t(k) * c3 + 2 * c + h * DH + d] = from_f<T>(dv_s[i]);
  }
}

// The two-kernel design, first kernel: dQ and the row statistics of one query
// tile of QB rows.  Grid (ceil(N / QB), H, B).
template <typename T, bool CLAMP, int QB, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                               const T* __restrict__ d_out, T* __restrict__ d_qkv,
                               float* __restrict__ stats, int n, int heads, float scale,
                               float mask_value) {
  extern __shared__ __align__(16) float smem[];
  const int ns = padded(n);
  float* q_s = smem;                       // [QB][DH]
  float* do_s = q_s + QB * DH;             // [QB][DH]
  float* kv_s = do_s + QB * DH;            // [kKC][kKVStrideOf<DH>]
  float* p_s = kv_s + kKC * kKVStrideOf<DH>;   // [QB][ns]
  float* ds_s = p_s + QB * ns;             // [QB][ns]
  float* fg_s = ds_s + QB * ns;            // [QB]
  float* km_s = fg_s + QB;                 // [n]

  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int c = heads * DH;
  const float* bg_b = bg + size_t(b) * n;
  for (int k = threadIdx.x; k < n; k += kThreads) km_s[k] = bg_b[k] * mask_value;
  query_tile<T, CLAMP, QB, DH>(q_s, do_s, kv_s, p_s, ds_s, fg_s, km_s,
                               qkv + size_t(b) * n * 3 * c, d_out + size_t(b) * n * c,
                               d_qkv + size_t(b) * n * 3 * c, bg_b,
                               stats + (size_t(b) * heads + h) * n * kStats, q0, n, ns, h, c,
                               scale);
}

// The two-kernel design, second kernel: dK and dV of kKC keys, from the row
// statistics the first kernel left.  Grid (ceil(N / kKC), H, B).
template <typename T, bool CLAMP, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ bg,
                                const T* __restrict__ d_out, T* __restrict__ d_qkv,
                                const float* __restrict__ stats, int n, int heads,
                                float scale, float mask_value) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStride = kKVStrideOf<DH>;
  float* k_s = smem;                       // [kKC][kStride]
  float* v_s = k_s + kKC * kStride;        // [kKC][kStride]
  float* q_s = v_s + kKC * kStride;        // [kQB][DH]
  float* do_s = q_s + kQB * DH;            // [kQB][DH]
  float* p_s = do_s + kQB * DH;            // [kQB][kKC] Pb
  float* ds_s = p_s + kQB * kKC;           // [kQB][kKC] dSb
  float* st_s = ds_s + kQB * kKC;          // [kQB][kStats]
  float* fg_s = st_s + kQB * kStats;       // [kQB]
  float* km_s = fg_s + kQB;                // [kKC]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kKC, h = blockIdx.y, b = blockIdx.z;
  const int c = heads * DH, c3 = 3 * c;
  const T* qkv_b = qkv + size_t(b) * n * c3;
  const T* do_b = d_out + size_t(b) * n * c;
  T* dqkv_b = d_qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  const float* stats_bh = stats + (size_t(b) * heads + h) * n * kStats;

  stage_chunk<kThreads, T, DH>(k_s, qkv_b, k0, n, c3, c + h * DH);
  stage_chunk<kThreads, T, DH>(v_s, qkv_b, k0, n, c3, 2 * c + h * DH);
  for (int j = tid; j < kKC; j += kThreads)
    km_s[j] = (k0 + j < n) ? bg_b[k0 + j] * mask_value : 0.f;

  // S and dP: one key, kRows query rows.  Sums: column d, key groups kg,
  // kg + kGroups, ... of 4 keys (kSlots of them: two at 64; at 80 three, the
  // last ones checked against the tile's 16 groups, and the last kThreads %
  // DH threads hold none).
  constexpr int kRows = kQB * kKC / kThreads, kStep = kThreads / kKC;
  constexpr int kKeyGroups = kKC / 4, kGroups = kThreads / DH;
  constexpr int kSlots = (kKeyGroups + kGroups - 1) / kGroups;
  constexpr bool kWhole = kThreads % DH == 0 && kKeyGroups % kGroups == 0;
  const int kj = tid % kKC, rg = tid / kKC;
  const int d = tid % DH, kg = tid / DH;
  const bool owner = kWhole || kg < kGroups;
  float av[4 * kSlots], ak[4 * kSlots];
#pragma unroll
  for (int i = 0; i < 4 * kSlots; ++i) av[i] = ak[i] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kQB) {
    __syncthreads();   // the previous tile's readers are done
    stage_qdo_rows<T, kQB, DH>(q_s, do_s, fg_s, qkv_b, do_b, bg_b, q0, n, h, c);
    for (int i = tid; i < kQB * kStats; i += kThreads)
      st_s[i] = (q0 + i / kStats < n) ? stats_bh[size_t(q0) * kStats + i] : 1.f;
    __syncthreads();

    float s_acc[kRows], p_acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s_acc[i] = p_acc[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + kj * kStride);
    const float4* v4 = reinterpret_cast<const float4*>(v_s + kj * kStride);
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kv = k4[d4], vv = v4[d4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kStep;
        const float4 qv = reinterpret_cast<const float4*>(q_s + r * DH)[d4];
        const float4 ov = reinterpret_cast<const float4*>(do_s + r * DH)[d4];
        s_acc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        p_acc[i] += ov.x * vv.x + ov.y * vv.y + ov.z * vv.z + ov.w * vv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg + i * kStep;
      float pb = 0.f, dsb = 0.f;
      if (q0 + r < n && k0 + kj < n) {
        float s = __fadd_rn(__fmul_rn(s_acc[i], scale), __fmul_rn(fg_s[r], km_s[kj]));
        if (CLAMP) s = fminf(s, 80.f);
        const float* st = st_s + r * kStats;
        const float p = expf(s - st[0]) / st[1];
        dsb = round_to<T>(__fmul_rn(__fmul_rn(p, p_acc[i] - st[2]), scale));
        pb = round_to<T>(p);
      }
      p_s[r * kKC + kj] = pb;
      ds_s[r * kKC + kj] = dsb;
    }
    __syncthreads();
    if (!owner) continue;

#pragma unroll 8
    for (int r = 0; r < kQB; ++r) {
      const float dor = do_s[r * DH + d], qr = q_s[r * DH + d];
#pragma unroll
      for (int g = 0; g < kSlots; ++g) {
        if (!kWhole && kg + g * kGroups >= kKeyGroups) break;
        const int k = 4 * (kg + g * kGroups);
        const float4 p = *reinterpret_cast<const float4*>(p_s + r * kKC + k);
        const float4 s = *reinterpret_cast<const float4*>(ds_s + r * kKC + k);
        av[4 * g + 0] += p.x * dor;
        av[4 * g + 1] += p.y * dor;
        av[4 * g + 2] += p.z * dor;
        av[4 * g + 3] += p.w * dor;
        ak[4 * g + 0] += s.x * qr;
        ak[4 * g + 1] += s.y * qr;
        ak[4 * g + 2] += s.z * qr;
        ak[4 * g + 3] += s.w * qr;
      }
    }
  }
  if (!owner) return;

#pragma unroll
  for (int i = 0; i < 4 * kSlots; ++i) {
    const int group = kg + (i / 4) * kGroups;
    const int k = k0 + 4 * group + i % 4;
    if ((kWhole || group < kKeyGroups) && k < n) {
      dqkv_b[size_t(k) * c3 + c + h * DH + d] = from_f<T>(ak[i]);
      dqkv_b[size_t(k) * c3 + 2 * c + h * DH + d] = from_f<T>(av[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core design (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcSlab = 64;                   // query rows (dQ) or keys (dK / dV) of a block
// bf16 elements of one staged 64-row slab of DH columns (a BfTile<DH>)
template <int DH> constexpr int kTcStageOf = kTcSlab * BfTile<DH>::kPitch;
// the dK / dV kernel reads its K and V fragments from shared memory past
// head width 64 (their registers would join dK and dV's 2 * DH / 2 a thread)
template <int DH> constexpr bool kKvSmem = DH != 64;

__host__ __device__ inline int tc_rows(int n) { return (n + kTcSlab - 1) / kTcSlab * kTcSlab; }
// two stages of two slabs, and the key mask
template <int DH> size_t tc_dq_smem(int n) {
  return 4 * size_t(kTcStageOf<DH>) * 2 + size_t(tc_rows(n)) * 4;
}
// two stages of two slabs, the rows' statistics, and past width 64 the
// block's K and V slabs
template <int DH>
constexpr size_t kTcDkvSmem = (kKvSmem<DH> ? 6 : 4) * size_t(kTcStageOf<DH>) * 2 +
                              2 * kTcSlab * 4 * 4;

// The A fragment of k16 step ks of rows row0..row0 + 15 of a BfTile<DH> in
// shared memory, by ldmatrix.
template <int DH>
__device__ __forceinline__ void a_tile(unsigned (&a)[4], const bf16* x, int row0, int ks,
                                       int lane) {
  ldmatrix_x4(a, x + BfTile<DH>::at(row0 + (lane & 15), ks * 16 + (lane >> 4) * 8));
}

// acc[t] += A B^T over DH columns for the two n8 tiles t of rows 16 * sc..
// of a staged BfTile<DH> x, A's k16 fragments from a(ks, frag): pairs of k16
// steps from one ldmatrix, and past a multiple of 32 one ldmatrix of the last
// step of both n8 tiles.  Each accumulator takes its k16 steps in order.
template <int DH, typename AFrag>
__device__ __forceinline__ void tc_rows_product(float (&acc)[2][4], AFrag a, const bf16* x,
                                                int sc, int lane) {
#pragma unroll
  for (int kp = 0; kp < DH / 32; ++kp) {
    unsigned a0[4], a1[4];
    a(2 * kp, a0);
    a(2 * kp + 1, a1);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      unsigned b[4];
      b_rows_w<DH>(b, x, sc * 2 + t, kp, lane);
      mma16816(acc[t], a0, b[0], b[1]);
      mma16816(acc[t], a1, b[2], b[3]);
    }
  }
  if constexpr (DH % 32 != 0) {
    unsigned a0[4], b[4];
    a(DH / 16 - 1, a0);
    b_rows_tail<DH>(b, x + BfTile<DH>::at(sc * 16, 0), lane);
    mma16816(acc[0], a0, b[0], b[1]);
    mma16816(acc[1], a0, b[2], b[3]);
  }
}

// S (scaled, masked, clamped) and dP = dO V^T of one 16-key piece of the
// staged K and V slabs, for the warp's 16 query rows; -inf past n.
template <bool CLAMP, int DH>
__device__ __forceinline__ void tc_s_dp(float (&s)[2][4], float (&dp)[2][4],
                                        const unsigned (&qa)[DH / 16][4],
                                        const unsigned (&da)[DH / 16][4], const bf16* k_s,
                                        const bf16* v_s, int sc, int kb, int n, float scale,
                                        const float* km_s, float fg_lo, float fg_hi, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
  auto q_frag = [&](int ks, unsigned (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qa[ks][i];
  };
  auto d_frag = [&](int ks, unsigned (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = da[ks][i];
  };
  tc_rows_product<DH>(s, q_frag, k_s, sc, lane);
  tc_rows_product<DH>(dp, d_frag, v_s, sc, lane);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kb + t * 8 + 2 * (lane & 3) + (e & 1);
      float v = -INFINITY;
      if (k < n) {
        v = __fadd_rn(__fmul_rn(s[t][e], scale), __fmul_rn(e < 2 ? fg_lo : fg_hi, km_s[k]));
        if (CLAMP) v = fminf(v, 80.f);
      }
      s[t][e] = v;
    }
  }
}

// dQ and the row statistics of 64 query rows (a warp: 16 of them, its Q and
// dO fragments in registers).  Two passes over the keys, staged 64 at a time:
// the first forms each row's maximum (without the clamp), sum of
// exponentials and rowsum(dP * P) with float32 P; the second forms dS, rounds
// it to bf16 in registers and adds dSb K into dQ.  Grid (ceil(N / 64), H, B).
template <bool CLAMP, int DH>
__global__ void __launch_bounds__(kTcThreads)
masked_attention_bwd_tc_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bg,
                                  const bf16* __restrict__ d_out, bf16* __restrict__ d_qkv,
                                  float* __restrict__ stats, int n, int heads, float scale,
                                  float mask_value) {
  constexpr int kStage = kTcStageOf<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);            // [2][K, V][64][pitch]
  float* km_s = reinterpret_cast<float*>(ring + 4 * kStage);   // [tc_rows(n)]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * kTcSlab + warp * 16;
  const int c = heads * DH, c3 = 3 * c, nk = tc_rows(n), n_slabs = nk / kTcSlab;
  const bf16* qkv_b = qkv + size_t(b) * n * c3;
  const float* bg_b = bg + size_t(b) * n;
  for (int k = tid; k < nk; k += kTcThreads) km_s[k] = k < n ? bg_b[k] * mask_value : 0.f;

  auto stage = [&](int j) {
    const int k0 = (j % n_slabs) * kTcSlab;
    bf16* dst = ring + (j & 1) * 2 * kStage;
    const bf16* src = qkv_b + size_t(k0) * c3 + c + h * DH;
    stage_rows<kTcSlab, kTcThreads, DH>(dst, src, c3, n - k0, tid);
    stage_rows<kTcSlab, kTcThreads, DH>(dst + kStage, src + c, c3, n - k0, tid);
    cp_async_commit();
  };
  stage(0);

  const bool active = r0 < n;
  const int lo = r0 + g, hi = r0 + g + 8;
  const float fg_lo = lo < n ? 1.f - bg_b[lo] : 0.f, fg_hi = hi < n ? 1.f - bg_b[hi] : 0.f;
  unsigned qa[DH / 16][4], da[DH / 16][4];
  a_rows<DH / 16>(qa, qkv_b + h * DH, c3, r0, n, lane);
  a_rows<DH / 16>(da, d_out + size_t(b) * n * c + h * DH, c, r0, n, lane);

  float m_lo = CLAMP ? 0.f : -INFINITY, m_hi = m_lo;   // pass 1: running statistics
  float l_lo = 0.f, l_hi = 0.f, d_lo = 0.f, d_hi = 0.f;
  float inv_lo = 0.f, inv_hi = 0.f;                     // pass 2: 1 / sum and the rowsum
  float dq[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int j = 0; j < 2 * n_slabs; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // slab j has landed everywhere; slab j - 1 is consumed
    if (j + 1 < 2 * n_slabs) stage(j + 1);
    const bool second = j >= n_slabs;
    if (j == n_slabs) {
      l_lo = quad_sum(l_lo);
      l_hi = quad_sum(l_hi);
      inv_lo = 1.f / l_lo;
      inv_hi = 1.f / l_hi;
      d_lo = quad_sum(d_lo) * inv_lo;
      d_hi = quad_sum(d_hi) * inv_hi;
    }
    if (!active) continue;
    const bf16* k_s = ring + (j & 1) * 2 * kStage;
    const int k0 = (j % n_slabs) * kTcSlab;
    for (int sc = 0; sc < kTcSlab / 16 && k0 + sc * 16 < n; ++sc) {
      float s[2][4], dp[2][4];
      tc_s_dp<CLAMP, DH>(s, dp, qa, da, k_s, k_s + kStage, sc, k0 + sc * 16, n, scale, km_s,
                         fg_lo, fg_hi, lane);
      if (!second) {
        if (!CLAMP) {
          const float n_lo = fmaxf(m_lo, quad_max(fmaxf(fmaxf(s[0][0], s[0][1]),
                                                        fmaxf(s[1][0], s[1][1]))));
          const float n_hi = fmaxf(m_hi, quad_max(fmaxf(fmaxf(s[0][2], s[0][3]),
                                                        fmaxf(s[1][2], s[1][3]))));
          if (n_lo != m_lo) {
            const float f = exp_ftz(m_lo - n_lo);
            l_lo *= f;
            d_lo *= f;
          }
          if (n_hi != m_hi) {
            const float f = exp_ftz(m_hi - n_hi);
            l_hi *= f;
            d_hi *= f;
          }
          m_lo = n_lo;
          m_hi = n_hi;
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = exp_ftz(s[t][e] - (e < 2 ? m_lo : m_hi));
            if (e < 2) {
              l_lo += ex;
              d_lo += dp[t][e] * ex;
            } else {
              l_hi += ex;
              d_hi += dp[t][e] * ex;
            }
          }
        continue;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool l = e < 2;
          const float p = ftz(exp_ftz(s[t][e] - (l ? m_lo : m_hi)) * (l ? inv_lo : inv_hi));
          s[t][e] = __fmul_rn(__fmul_rn(p, dp[t][e] - (l ? d_lo : d_hi)), scale);
        }
      unsigned dsa[4];
      a_from_c(dsa, s[0], s[1]);
#pragma unroll
      for (int jd = 0; jd < DH / 16; ++jd) {
        unsigned kb[4];
        b_cols_w<DH>(kb, k_s, sc, jd, lane);
        mma16816(dq[2 * jd], dsa, kb[0], kb[1]);
        mma16816(dq[2 * jd + 1], dsa, kb[2], kb[3]);
      }
    }
  }

  bf16* dq_b = d_qkv + size_t(b) * n * c3 + h * DH;
  float* st_b = stats + (size_t(b) * heads + h) * n * kStats;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    if (lo < n)
      *reinterpret_cast<unsigned*>(dq_b + size_t(lo) * c3 + jd * 8 + 2 * tg) =
          pack_bf16(dq[jd][0], dq[jd][1]);
    if (hi < n)
      *reinterpret_cast<unsigned*>(dq_b + size_t(hi) * c3 + jd * 8 + 2 * tg) =
          pack_bf16(dq[jd][2], dq[jd][3]);
  }
  if (tg == 0) {
    if (lo < n) {
      st_b[size_t(lo) * kStats] = m_lo;
      st_b[size_t(lo) * kStats + 1] = inv_lo;
      st_b[size_t(lo) * kStats + 2] = d_lo;
    }
    if (hi < n) {
      st_b[size_t(hi) * kStats] = m_hi;
      st_b[size_t(hi) * kStats + 1] = inv_hi;
      st_b[size_t(hi) * kStats + 2] = d_hi;
    }
  }
}

// dK and dV of 64 keys (a warp: 16 of them; its K and V fragments in
// registers, or past width 64 read from the block's staged K and V slabs),
// from the statistics of the dQ kernel.  The query rows are staged 64 at a
// time; per 16 rows the warp forms S^T = K Q^T and dP^T = V dO^T, rebuilds P
// and dS with the dQ kernel's expressions, and adds Pb^T dO and dSb^T Q into
// dV and dK, which stay in registers.  Grid (ceil(N / 64), H, B).
template <bool CLAMP, int DH>
__global__ void __launch_bounds__(kTcThreads)
masked_attention_bwd_tc_dkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bg,
                                   const bf16* __restrict__ d_out, bf16* __restrict__ d_qkv,
                                   const float* __restrict__ stats, int n, int heads,
                                   float scale, float mask_value) {
  constexpr int kStage = kTcStageOf<DH>;
  constexpr bool kSmemKV = kKvSmem<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                // [2][Q, dO][64][pitch]
  float* st_s = reinterpret_cast<float*>(ring + 4 * kStage);     // [2][64][max, 1/sum, D, fg]
  bf16* kv_t = reinterpret_cast<bf16*>(st_s + 2 * kTcSlab * 4);  // [K, V][64][pitch] (kSmemKV)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, kw = blockIdx.x * kTcSlab + warp * 16;
  const int c = heads * DH, c3 = 3 * c, n_slabs = tc_rows(n) / kTcSlab;
  const bf16* qkv_b = qkv + size_t(b) * n * c3;
  const bf16* do_b = d_out + size_t(b) * n * c;
  const float* bg_b = bg + size_t(b) * n;
  const float* st_g = stats + (size_t(b) * heads + h) * n * kStats;

  if constexpr (kSmemKV) {   // in the first commit group, with slab 0
    const int k0 = blockIdx.x * kTcSlab;
    const bf16* src = qkv_b + size_t(k0) * c3 + c + h * DH;
    stage_rows<kTcSlab, kTcThreads, DH>(kv_t, src, c3, n - k0, tid);
    stage_rows<kTcSlab, kTcThreads, DH>(kv_t + kStage, src + c, c3, n - k0, tid);
  }
  auto stage = [&](int i) {
    const int q0 = i * kTcSlab;
    bf16* dst = ring + (i & 1) * 2 * kStage;
    stage_rows<kTcSlab, kTcThreads, DH>(dst, qkv_b + size_t(q0) * c3 + h * DH, c3, n - q0,
                                        tid);
    stage_rows<kTcSlab, kTcThreads, DH>(dst + kStage, do_b + size_t(q0) * c + h * DH, c,
                                        n - q0, tid);
    cp_async_commit();
    if (tid < kTcSlab) {   // rows past n: P = 0 and dS = 0
      const int r = q0 + tid;
      const bool ok = r < n;
      *reinterpret_cast<float4*>(st_s + ((i & 1) * kTcSlab + tid) * 4) =
          ok ? make_float4(st_g[size_t(r) * kStats], st_g[size_t(r) * kStats + 1],
                           st_g[size_t(r) * kStats + 2], 1.f - bg_b[r])
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  stage(0);

  const bool active = kw < n;
  const int lo = kw + g, hi = kw + g + 8;
  const float km_lo = lo < n ? bg_b[lo] * mask_value : 0.f;
  const float km_hi = hi < n ? bg_b[hi] * mask_value : 0.f;
  // the warp's K and V fragments: registers at width 64 (kSmemKV false)
  unsigned ka[kSmemKV ? 1 : DH / 16][4], va[kSmemKV ? 1 : DH / 16][4];
  if constexpr (!kSmemKV) {
    a_rows<DH / 16>(ka, qkv_b + c + h * DH, c3, kw, n, lane);
    a_rows<DH / 16>(va, qkv_b + 2 * c + h * DH, c3, kw, n, lane);
  }
  auto k_frag = [&](int ks, unsigned (&a)[4]) {
    if constexpr (kSmemKV) {
      a_tile<DH>(a, kv_t, warp * 16, ks, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ka[ks][i];
    }
  };
  auto v_frag = [&](int ks, unsigned (&a)[4]) {
    if constexpr (kSmemKV) {
      a_tile<DH>(a, kv_t + kStage, warp * 16, ks, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = va[ks][i];
    }
  };
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait<0>();
    __syncthreads();   // slab i and its statistics are in; slab i - 1 is consumed
    if (i + 1 < n_slabs) stage(i + 1);
    if (!active) continue;
    const bf16* q_s = ring + (i & 1) * 2 * kStage;
    const bf16* do_s = q_s + kStage;
    const float* st = st_s + (i & 1) * kTcSlab * 4;
    for (int sc = 0; sc < kTcSlab / 16 && i * kTcSlab + sc * 16 < n; ++sc) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      tc_rows_product<DH>(s, k_frag, q_s, sc, lane);
      tc_rows_product<DH>(dp, v_frag, do_s, sc, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 r = *reinterpret_cast<const float4*>(
              st + (sc * 16 + t * 8 + 2 * tg + (e & 1)) * 4);
          float v = __fadd_rn(__fmul_rn(s[t][e], scale), __fmul_rn(r.w, e < 2 ? km_lo : km_hi));
          if (CLAMP) v = fminf(v, 80.f);
          const float p = ftz(exp_ftz(v - r.x) * r.y);
          s[t][e] = p;
          dp[t][e] = __fmul_rn(__fmul_rn(p, dp[t][e] - r.z), scale);
        }
      }
      unsigned pa[4], dsa[4];
      a_from_c(pa, s[0], s[1]);
      a_from_c(dsa, dp[0], dp[1]);
#pragma unroll
      for (int jd = 0; jd < DH / 16; ++jd) {
        unsigned bo[4];
        b_cols_w<DH>(bo, do_s, sc, jd, lane);
        mma16816(dv[2 * jd], pa, bo[0], bo[1]);
        mma16816(dv[2 * jd + 1], pa, bo[2], bo[3]);
        b_cols_w<DH>(bo, q_s, sc, jd, lane);
        mma16816(dk[2 * jd], dsa, bo[0], bo[1]);
        mma16816(dk[2 * jd + 1], dsa, bo[2], bo[3]);
      }
    }
  }

  bf16* dk_b = d_qkv + size_t(b) * n * c3 + c + h * DH;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    const int d = jd * 8 + 2 * tg;
    if (lo < n) {
      *reinterpret_cast<unsigned*>(dk_b + size_t(lo) * c3 + d) = pack_bf16(dk[jd][0], dk[jd][1]);
      *reinterpret_cast<unsigned*>(dk_b + size_t(lo) * c3 + c + d) =
          pack_bf16(dv[jd][0], dv[jd][1]);
    }
    if (hi < n) {
      *reinterpret_cast<unsigned*>(dk_b + size_t(hi) * c3 + d) = pack_bf16(dk[jd][2], dk[jd][3]);
      *reinterpret_cast<unsigned*>(dk_b + size_t(hi) * c3 + c + d) =
          pack_bf16(dv[jd][2], dv[jd][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// the two FMA kernels with a dQ tile of QB rows
template <typename T, bool CLAMP, int QB, int DH>
cudaError_t launch_two_kernel(const T* qkv, const float* bg, const T* d_out, T* d_qkv,
                              float* stats, int batch, int n, int heads, float scale,
                              float mask_value, cudaStream_t stream) {
  auto dq = masked_attention_bwd_dq_kernel<T, CLAMP, QB, DH>;
  auto dkv = masked_attention_bwd_dkv_kernel<T, CLAMP, DH>;
  const size_t smem_dq = tile_floats<QB, DH>(n) * sizeof(float);
  const size_t smem_dkv = kDkvFloats<DH> * sizeof(float);
  cudaError_t err = allow_smem(dq, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkv, smem_dkv);
  if (err != cudaSuccess) return err;
  dq<<<dim3((n + QB - 1) / QB, heads, batch), kThreads, smem_dq, stream>>>(
      qkv, bg, d_out, d_qkv, stats, n, heads, scale, mask_value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<dim3((n + kKC - 1) / kKC, heads, batch), kThreads, smem_dkv, stream>>>(
      qkv, bg, d_out, d_qkv, stats, n, heads, scale, mask_value);
  return cudaGetLastError();
}

template <typename T, bool CLAMP, int DH>
cudaError_t launch_bwd(const void* qkv_, const void* bg_, const void* d_out_, void* d_qkv_,
                       void* stats_, int batch, int n, int heads, float scale,
                       float mask_value, int design, cudaStream_t stream) {
  const T* qkv = static_cast<const T*>(qkv_);
  const float* bg = static_cast<const float*>(bg_);
  const T* d_out = static_cast<const T*>(d_out_);
  T* d_qkv = static_cast<T*>(d_qkv_);
  float* stats = static_cast<float*>(stats_);
  if (design == kOneBlock) {
    auto kernel = masked_attention_bwd_kernel<T, CLAMP, DH>;
    const size_t smem = bwd_smem_bytes<DH>(n, false);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(heads, batch), kThreads, smem, stream>>>(qkv, bg, d_out, d_qkv, n, heads,
                                                           scale, mask_value);
    return cudaGetLastError();
  }
  if (stats == nullptr) return cudaErrorInvalidValue;
  if (design == kTensorCore) {
    if constexpr (sizeof(T) != 2) {
      return cudaErrorInvalidValue;
    } else {
      auto dq = masked_attention_bwd_tc_dq_kernel<CLAMP, DH>;
      auto dkv = masked_attention_bwd_tc_dkv_kernel<CLAMP, DH>;
      cudaError_t err = allow_smem(dq, tc_dq_smem<DH>(n));
      if (err != cudaSuccess) return err;
      err = allow_smem(dkv, kTcDkvSmem<DH>);
      if (err != cudaSuccess) return err;
      const dim3 grid(tc_rows(n) / kTcSlab, heads, batch);
      dq<<<grid, kTcThreads, tc_dq_smem<DH>(n), stream>>>(qkv, bg, d_out, d_qkv, stats, n,
                                                          heads, scale, mask_value);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      dkv<<<grid, kTcThreads, kTcDkvSmem<DH>, stream>>>(qkv, bg, d_out, d_qkv, stats, n, heads,
                                                        scale, mask_value);
      return cudaGetLastError();
    }
  }
  if (dq_rows<DH>(n) == kQB)
    return launch_two_kernel<T, CLAMP, kQB, DH>(qkv, bg, d_out, d_qkv, stats, batch, n, heads,
                                                scale, mask_value, stream);
  return launch_two_kernel<T, CLAMP, kQB / 2, DH>(qkv, bg, d_out, d_qkv, stats, batch, n, heads,
                                                  scale, mask_value, stream);
}

// The C entry point's work at head width DH (its arguments documented there).
template <int DH>
int bwd_entry(const void* qkv, const void* bg, const void* d_out, void* d_qkv, void* stats,
              int batch, int n, int heads, float scale, float mask_value, int dtype, int clamp,
              int design, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || heads < 1 || heads > 65535 ||
      design < kOneBlock || design > kTensorCore)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return clamp ? launch_bwd<float, true, DH>(qkv, bg, d_out, d_qkv, stats, batch, n, heads,
                                               scale, mask_value, design, s)
                 : launch_bwd<float, false, DH>(qkv, bg, d_out, d_qkv, stats, batch, n, heads,
                                                scale, mask_value, design, s);
  if (dtype == 1)
    return clamp ? launch_bwd<__nv_bfloat16, true, DH>(qkv, bg, d_out, d_qkv, stats, batch, n,
                                                       heads, scale, mask_value, design, s)
                 : launch_bwd<__nv_bfloat16, false, DH>(qkv, bg, d_out, d_qkv, stats, batch, n,
                                                        heads, scale, mask_value, design, s);
  return cudaErrorInvalidValue;
}

// the bytes of shared memory a block of the design asks for at N (the larger
// of its two kernels')
template <int DH> size_t bwd_smem_entry(int n, int design) {
  if (design == kTensorCore)
    return tc_dq_smem<DH>(n) > kTcDkvSmem<DH> ? tc_dq_smem<DH>(n) : kTcDkvSmem<DH>;
  return bwd_smem_bytes<DH>(n, design == kTwoKernel);
}

// The occupancy of one kernel of the design a launch at N takes, on the
// training path's instance (no clamp): part 0 the one-block kernel or the
// dQ kernel (the FMA one at the query rows N takes), part 1 the dK / dV
// kernel.  info[0] blocks an SM at once, info[1] registers a thread, info[2]
// local memory a thread (spills), info[3] shared memory a block.  dtype 0 =
// float32, 1 = bf16; the tensor-core design takes bf16 only.
template <int DH>
int bwd_occupancy_entry(int n, int dtype, int design, int part, int* info) {
  if (n < 1 || dtype < 0 || dtype > 1 || part < 0 || part > 1 ||
      (design == kOneBlock && part != 0) || (design == kTensorCore && dtype != 1) ||
      design < kOneBlock || design > kTensorCore)
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  size_t smem = 0;
  int threads = kThreads;
  auto fma = [&](auto tag) {
    using T = decltype(tag);
    if (design == kOneBlock) {
      kernel = reinterpret_cast<const void*>(masked_attention_bwd_kernel<T, false, DH>);
      smem = bwd_smem_bytes<DH>(n, false);
    } else if (part == 1) {
      kernel = reinterpret_cast<const void*>(masked_attention_bwd_dkv_kernel<T, false, DH>);
      smem = kDkvFloats<DH> * sizeof(float);
    } else if (dq_rows<DH>(n) == kQB) {
      kernel = reinterpret_cast<const void*>(masked_attention_bwd_dq_kernel<T, false, kQB, DH>);
      smem = tile_floats<kQB, DH>(n) * sizeof(float);
    } else {
      kernel = reinterpret_cast<const void*>(
          masked_attention_bwd_dq_kernel<T, false, kQB / 2, DH>);
      smem = tile_floats<kQB / 2, DH>(n) * sizeof(float);
    }
  };
  if (design == kTensorCore) {
    threads = kTcThreads;
    kernel = part == 0 ? reinterpret_cast<const void*>(masked_attention_bwd_tc_dq_kernel<false, DH>)
                       : reinterpret_cast<const void*>(masked_attention_bwd_tc_dkv_kernel<false, DH>);
    smem = part == 0 ? tc_dq_smem<DH>(n) : kTcDkvSmem<DH>;
  } else if (dtype == 0) {
    fma(float{});
  } else {
    fma(__nv_bfloat16{});
  }
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, threads, smem);
  info[1] = fa.numRegs;
  info[2] = int(fa.localSizeBytes);
  info[3] = int(smem);
  return err;
}

}  // namespace
