// The attention sub-block's second design, "streamed", for Hopper (sm_90a):
// the same function as attention_block.cu (see its head for the formulas and
// the roundings), for the shapes its cluster design does not take: N past 256
// (an image's query tiles no longer fit one cluster of 8 blocks), C past what
// its shared memory holds, and the head widths other than 64: 80 (ViT-H/14),
// and 16, 32 and 40 (the JAX quickstart's tiny ViT and the JAX kernel tests'
// fuzz widths), the widths kernel 1 takes.
//
// Replaces, with attention_block.cu, the TPU kernel
// vision_transformer_cam_tpu/kernels/attention.py: _attn_block_kernel
// (attention_block_fused), which tiles queries at min(N, 512) and takes any
// N, C and head width.
//
// Two launches a call.
//
//   1. block_kv_kernel: K and V of every head, the k | v columns of the qkv
//      GEMM (float32 sums plus bias, rounded to xn's type exactly where the
//      cluster design's epilogue rounds them), into a scratch [B, 2, H, N,
//      dh] in xn's type that the wrapper allocates.  A block owns 32 rows of
//      [B N, C] and 384 of the 2C columns (tile_gemm.cuh: mma.sync at bf16,
//      FMAs at float32).
//   2. attention_block_streamed_*_kernel: a block owns one tile of QB query
//      rows of one image across all heads, the present design's unit of
//      work (proj sums over all heads, the rollout needs the head mean of a
//      query tile over all heads), so the sums keep one order, no float
//      atomics, and a second launch gives the same bits.  It computes the q
//      rows of every head at once ([QB, C] x [C, C], 384 columns at a time)
//      into a [QB, C] tile in shared memory; per head the attention core
//      reads its q columns there and streams the head's K and V from the
//      scratch, and writes the head's output over the same columns (its q is
//      no longer read by then).  The tile ends as the attention output, which
//      the proj GEMM consumes beside the residual.  Neither q nor the
//      attention output reaches device memory.
//
// The cores.  bf16 runs kernel 1's tensor-core core (attention_tc.cuh): the 8
// warps take the 16-key chunks in turn, each staging its chunks of K and V by
// cp.async into a private two-stage ring (swizzled [16][64] tiles at width
// 64, rows of an odd number of 16-byte segments at the other widths: 24, 40,
// 56, 88 elements at 16, 32, 40, 80); QK^T and P V on mma.sync.m16n8k16 with
// the A fragments of q read by ldmatrix from the [QB, C] tile (its rows are C
// + 8 elements, an odd number of 16-byte segments where C is a multiple of
// 16, so the 8 rows an ldmatrix reads lie in 8 bank groups) in 1 / 2 / 3 / 4
// / 5 k16 steps at 16 / 32 / 40 / 64 / 80; S in registers; two passes over the keys a head (row sums, then P, the head
// mean, the cls row and P V); the warps' partial O tiles meet in their own
// rings, summed in one order.  float32 runs the FMA core of the cluster
// design on 64-key chunks of K and V staged from the scratch, with a [QB, N]
// float32 tile of S: its gates need full float32 products; its P V gives a
// thread one column where the 256 threads divide by the width (16, 32, 64),
// (row, column) pairs at 40 and 80.
//
// Width 40 is staged and multiplied as 48 columns (BfTile<40>: K and V
// zero-filled past 40 in the rings).  Head h's q is the 40 columns h * 40..
// of the [QB, C + 8] tile, so the last k16 step of its QK^T reads 8 columns
// past them: head h + 1's first q columns, or for the last head the tile's
// pad.  That step's A fragments are zeroed past the head's columns in
// registers, and the pad columns of the tile are zeroed once: the proj GEMM
// walks K = C in steps of 32 and, at C = 120, reads the pad as A columns
// 120..127 (a NaN bit pattern left there by an earlier kernel would turn the
// zero weights' products into NaN).  O's sixth n8 tile, zero, is never
// stored.
//
// The row tile QB is 32 query rows (two m16 tiles) where the layout fits the
// 232,448 bytes a block may hold, else 16 (st_layout_tc / st_layout_fma,
// mirrored by kernels.attention.block_smem_bytes): with the rollout the
// [QB, N] float32 head mean, the [QB, C] tile and the rings or the S tile
// are live together.  At 16 the tile GEMMs (32 rows, tile_gemm.cuh) skip
// the second m16 tile (bf16) or the warps of rows 16-31 (float32).
//
// What bounds it on this card.  At ViT-L/16@512 (N = 1025, C = 1024, 16
// heads of 64), batch 32, with the rollout: the qkv GEMM 206 GFLOP, proj 69,
// QK^T and P V 138, hm @ J 68.9 GFLOP of float32 FMAs; the bytes are the
// joint twice (269 MB) and xn, tokens, out (201 MB) plus the scratch written
// and read (134 MB): bound by operations.  Every block streams Wq and Wproj
// (4 MB at C = 1024, bf16) and the image's K and V from L2.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain C
// interface (no PyTorch headers) and called through ctypes; the width-64
// instances and the C entry points are attention_block_streamed.cu, the
// ones at 80, 16, 32 and 40 attention_block_streamed_w80.cu, _w16.cu, _w32.cu
// and _w40.cu.

#pragma once

#include <cmath>

#include "attention_tc.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr size_t kStMaxSmem = 232448;   // 227 KB, the most a block may ask for

// byte offsets of a block's shared memory in the streamed design; every
// offset a multiple of 16
struct StSmem {
  int attn, hm, km, cls, st, fg, den, u, total;
};

__host__ __device__ inline int st_max(int a, int b) { return a > b ? a : b; }

// bf16, the tensor-core core: the [qb, C + 8] q / output tile, the head mean,
// the key mask, the cls sums, each warp's row statistics, 1 - bg_q, the
// softmax sums; then the warps' rings, which the GEMMs' staging replaces
// before and after the heads
__host__ __device__ inline StSmem st_layout_tc(int n, int c, int dh, bool rollout, int qb) {
  const int f = sizeof(float), nk = tc_keys(n);
  StSmem s;
  int o = 0;
  s.attn = o, o += qb * (c + a_pad<bf16>()) * 2;
  s.hm = o, o += rollout ? qb * tc_hm_stride(n) * f : 0;
  s.km = o, o += nk * f;
  s.cls = o, o += nk * f;
  s.st = o, o += kTcWarps * qb * 2 * f;
  s.fg = o, o += qb * f;
  s.den = o, o += qb * f;
  s.u = o;
  s.total = o + st_max(kTcWarps * tc_ring_bytes(2, qb / 16, dh), stage_bytes<bf16, 4>());
  return s;
}

// float32, the FMA core: the [qb, C + 4] q / output tile, the head mean, the
// cls sums, the key mask, 1 - bg_q, the softmax sums; then the S tile [qb,
// ns] and a K or V chunk [64, dh + 4], which the GEMMs' staging replaces
// before and after the heads
__host__ __device__ inline StSmem st_layout_fma(int n, int c, int dh, bool rollout, int qb) {
  const int f = sizeof(float), ns = padded(n);
  StSmem s{};   // no row statistics (st) in this core
  int o = 0;
  s.attn = o, o += qb * (c + a_pad<float>()) * f;
  s.hm = o, o += rollout ? qb * ns * f : 0;
  s.cls = o, o += ns * f;
  s.km = o, o += ns * f;
  s.fg = o, o += qb * f;
  s.den = o, o += qb * f;
  s.u = o;
  s.total = o + st_max(stage_bytes<float, 4>(), (qb * ns + kKC * (dh + 4)) * f);
  return s;
}

// the q rows q0.. of every head: attn_s[r][col] = round(xn Wq^T + bq), zero
// on rows past n, 384 columns at a time
template <typename T, int ROWS>
__device__ __forceinline__ void q_rows(T* attn_s, int cs, const T* __restrict__ xn_b, int q0,
                                       int n, const T* __restrict__ wqkv,
                                       const T* __restrict__ bqkv, int c, void* stage) {
  using F = Frag<4, T>;
  constexpr int kBN = Tile<4>::kBN;
  for (int c0 = 0; c0 < c; c0 += kBN) {
    float acc[4 * kGTN];
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) acc[e] = 0.f;
    gemm_global_a<4, ROWS>(
        acc, xn_b, c, q0, n, wqkv, c, [=](int col) { return c0 + col < c ? c0 + col : -1; }, c,
        stage);
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) {
      const int col = c0 + F::col(e), r = F::row(e);
      if (col >= c || r >= ROWS) continue;
      attn_s[r * cs + col] =
          from_f<T>(q0 + r < n ? round_to<T>(__fadd_rn(acc[e], to_f(bqkv[col]))) : 0.f);
    }
  }
}

// out = tokens + round(O) Wproj^T + bproj for the tile's rows, 384 columns
// at a time
template <typename T, int ROWS>
__device__ __forceinline__ void proj_rows(const T* attn_s, int cs, const T* __restrict__ wproj,
                                          const T* __restrict__ bproj, const T* __restrict__ tok,
                                          T* __restrict__ out, int b, int q0, int n, int c,
                                          void* stage) {
  using F = Frag<4, T>;
  constexpr int kBN = Tile<4>::kBN;
  for (int c0 = 0; c0 < c; c0 += kBN) {
    float acc[4 * kGTN];
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) acc[e] = 0.f;
    gemm_shared_a<4, ROWS>(
        acc, attn_s, cs, wproj, c, [=](int col) { return c0 + col < c ? c0 + col : -1; }, 0, c,
        c, stage);
#pragma unroll
    for (int e = 0; e < 4 * kGTN; ++e) {
      const int col = c0 + F::col(e), r = F::row(e);
      if (col >= c || r >= ROWS || q0 + r >= n) continue;
      const size_t o = (size_t(b) * n + q0 + r) * c + col;
      out[o] = from_f<T>(__fadd_rn(to_f(tok[o]), __fadd_rn(acc[e], to_f(bproj[col]))));
    }
  }
}

// the first launch: kv[b][part][h][i][d] = round(xn[b, i] Wkv^T + bkv) for
// the 2C k | v columns; a block owns 32 of the B N rows and 384 columns
template <typename T>
__global__ void __launch_bounds__(kGT)
block_kv_kernel(const T* __restrict__ xn, const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                T* __restrict__ kv, int rows, int n, int heads, int dh) {
  extern __shared__ __align__(16) unsigned char smem[];
  using F = Frag<4, T>;
  const int c = heads * dh, r0 = blockIdx.x * kGM, c0 = blockIdx.y * Tile<4>::kBN;
  float acc[4 * kGTN];
#pragma unroll
  for (int e = 0; e < 4 * kGTN; ++e) acc[e] = 0.f;
  gemm_global_a<4>(
      acc, xn, c, r0, rows, wqkv, c,
      [=](int col) { return c0 + col < 2 * c ? c + c0 + col : -1; }, c, smem);
#pragma unroll
  for (int e = 0; e < 4 * kGTN; ++e) {
    const int col = c0 + F::col(e), r = r0 + F::row(e);
    if (col >= 2 * c || r >= rows) continue;
    const int part = col >= c, within = col - part * c, h = within / dh, d = within - h * dh;
    const int b = r / n, i = r - b * n;
    kv[(((size_t(b) * 2 + part) * heads + h) * n + i) * dh + d] =
        from_f<T>(__fadd_rn(acc[e], to_f(bqkv[c + col])));
  }
}

// The dot products of one 16-key chunk of K (a BfTile<DH> in a ring) with
// the q rows of MT m16 tiles, their A fragments loaded by ldmatrix from the
// [QB, C + 8] tile (q: the head's first column, row pitch `pitch`), per k16
// step; a width of 32 j + 16 takes its last step from b_rows_tail, and at a
// width of 16 j + 8 (40) that step's A columns past the head (the next head's
// q, or the tile's pad) are zeros in registers.
template <int DH, int MT>
__device__ __forceinline__ void dots_q(float (&d)[MT][2][4], const bf16* q, int pitch,
                                       const bf16* k_s, int lane) {
  constexpr int kW = k16_width(DH);
  auto a_frag = [&](unsigned (&a)[4], int mt, int ks) {
    ldmatrix_x4(a, q + (mt * 16 + (lane & 15)) * pitch + ks * 16 + (lane >> 4) * 8);
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) d[mt][nt][0] = d[mt][nt][1] = d[mt][nt][2] = d[mt][nt][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < kW / 32; ++kp) {
    unsigned b0[4], b1[4];
    b_rows_w<DH>(b0, k_s, 0, kp, lane);
    b_rows_w<DH>(b1, k_s, 1, kp, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned a0[4], a1[4];
      a_frag(a0, mt, 2 * kp);
      a_frag(a1, mt, 2 * kp + 1);
      mma16816(d[mt][0], a0, b0[0], b0[1]);
      mma16816(d[mt][0], a1, b0[2], b0[3]);
      mma16816(d[mt][1], a0, b1[0], b1[1]);
      mma16816(d[mt][1], a1, b1[2], b1[3]);
    }
  }
  if constexpr (kW % 32 != 0) {
    unsigned tail[4];
    b_rows_tail<DH>(tail, k_s, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned a[4];
      a_frag(a, mt, kW / 16 - 1);
      if constexpr (DH % 16 != 0) a[2] = a[3] = 0u;   // columns 8..15 of the step
      mma16816(d[mt][0], a, tail[0], tail[1]);
      mma16816(d[mt][1], a, tail[2], tail[3]);
    }
  }
}

// The bf16 kernel (the tensor-core core).  One block an SM (its shared
// memory), so its threads may hold up to 255 registers.
template <bool ROLLOUT, bool CLAMP, int MT, int DH>
__global__ void __launch_bounds__(kGT, 1)
attention_block_streamed_tc_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ tok,
                                   const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                                   const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                                   const float* __restrict__ bg, const float* __restrict__ joint,
                                   const bf16* __restrict__ kv, bf16* __restrict__ out,
                                   bf16* __restrict__ cls, float* __restrict__ newj, int n,
                                   int heads, float scale, float mask_value) {
  using TC = Tc<bf16, DH>;
  constexpr int QB = 16 * MT;
  constexpr int kRing = tc_ring_bytes(2, MT, DH);
  constexpr int kOStride = kTcOStrideOf<DH>;
  constexpr int kNT = tc_width(DH) / 8;             // n8 tiles of O (zero past DH)
  constexpr int kStage = 2 * TC::kChunk;            // elements of one (K, V) stage
  static_assert(kTcThreads == kGT, "one block shape for the GEMMs and the core");
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = heads * DH, cs = c + a_pad<bf16>(), nk = tc_keys(n), hs = tc_hm_stride(n);
  const StSmem lay = st_layout_tc(n, c, DH, ROLLOUT, QB);
  auto floats = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  bf16* attn_s = reinterpret_cast<bf16*>(smem + lay.attn);   // q, then O, of every head
  float* hm_s = floats(lay.hm);
  float* km_s = floats(lay.km);
  float* cls_s = floats(lay.cls);
  float* st_s = floats(lay.st);              // [warps][QB][2]: max, sum
  float* fg_s = floats(lay.fg);
  float* den_s = floats(lay.den);
  unsigned char* rings = smem + lay.u;       // the warps' rings, or the GEMMs' staging
  void* stage = rings;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const bf16* xn_b = xn + size_t(b) * n * c;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;
  bf16* ring = reinterpret_cast<bf16*>(rings + warp * kRing);
  const int n_chunks = nk / kTcChunk;
  const int mine = warp < n_chunks ? (n_chunks - warp + kTcWarps - 1) / kTcWarps : 0;

  for (int k = tid; k < nk; k += kGT) {
    km_s[k] = k < n ? bg_b[k] * mask_value : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < QB; r += kGT) fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  if (ROLLOUT)
    for (int i = tid; i < QB * hs; i += kGT) hm_s[i] = 0.f;
  for (int i = tid; i < QB * (cs - c); i += kGT)   // the pad columns: zero A columns of proj
    attn_s[i / (cs - c) * cs + c + i % (cs - c)] = __float2bfloat16(0.f);
  q_rows<bf16, QB>(attn_s, cs, xn_b, q0, n, wqkv, bqkv, c, stage);
  __syncthreads();   // q of every head is in place; the staging is free
  float fg[MT][2];
  bool row_ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fg[mt][0] = fg_s[mt * 16 + g];
    fg[mt][1] = fg_s[mt * 16 + g + 8];
    row_ok[mt][0] = q0 + mt * 16 + g < n;
    row_ok[mt][1] = q0 + mt * 16 + g + 8 < n;
  }

  // K (part 0) or V (part 1) of head h of this image in the scratch
  auto kv_head = [&](int part, int h) {
    return kv + ((size_t(b) * 2 + part) * heads + h) * size_t(n) * DH;
  };
  // stage chunk i of this warp (K, and V with with_v) into stage i % 2
  auto stage_kv = [&](int h, int i, bool with_v) {
    const int k0 = (warp + i * kTcWarps) * kTcChunk;
    bf16* dst = ring + (i & 1) * kStage;
    TC::stage(dst, kv_head(0, h) + size_t(k0) * DH, DH, n - k0, lane);
    if (with_v) TC::stage(dst + TC::kChunk, kv_head(1, h) + size_t(k0) * DH, DH, n - k0, lane);
    cp_async_commit();
  };
  // S of one chunk: scaled, masked, clamped; -inf on keys >= n
  auto logits = [&](float (&s)[MT][2][4], const bf16* q_h, const bf16* k_s, int k0) {
    dots_q<DH, MT>(s, q_h, cs, k_s, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + nt * 8 + 2 * tg + (e & 1);
          float v = -INFINITY;
          if (k < n) {
            v = __fadd_rn(__fmul_rn(s[mt][nt][e], scale), __fmul_rn(fg[mt][e >> 1], km_s[k]));
            if (CLAMP) v = fminf(v, 80.f);
          }
          s[mt][nt][e] = v;
        }
  };

  if (mine) stage_kv(0, 0, false);
  for (int h = 0; h < heads; ++h) {
    const bf16* q_h = attn_s + h * DH;
    // pass 1: per row the maximum (without the clamp) and the sum of exp
    float m[MT][2], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m[mt][0] = m[mt][1] = CLAMP ? 0.f : -INFINITY;
      l[mt][0] = l[mt][1] = 0.f;
    }
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage_kv(h, i + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      float s[MT][2][4];
      logits(s, q_h, ring + (i & 1) * kStage, (warp + i * kTcWarps) * kTcChunk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!CLAMP) {
            const float nm = fmaxf(m[mt][hf],
                                   quad_max(fmaxf(fmaxf(s[mt][0][2 * hf], s[mt][0][2 * hf + 1]),
                                                  fmaxf(s[mt][1][2 * hf], s[mt][1][2 * hf + 1]))));
            l[mt][hf] = nm == m[mt][hf] ? l[mt][hf] : l[mt][hf] * exp_ftz(m[mt][hf] - nm);
            m[mt][hf] = nm;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            l[mt][hf] += exp_ftz(s[mt][nt][2 * hf] - m[mt][hf]) +
                         exp_ftz(s[mt][nt][2 * hf + 1] - m[mt][hf]);
        }
      __syncwarp();   // this stage is read before the chunk after next lands in it
    }
    if (mine) stage_kv(h, 0, true);   // pass 2's first chunk loads across the barrier
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float lsum = quad_sum(l[mt][hf]);
        if (tg == 0) {
          float* st = st_s + (warp * QB + mt * 16 + g + 8 * hf) * 2;
          st[0] = m[mt][hf];
          st[1] = lsum;
        }
      }
    __syncthreads();
    // every thread combines the warps' partials of its rows, in one order
    float mx[MT][2], inv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        float mr = CLAMP ? 0.f : -INFINITY, den = 0.f;
        if (!CLAMP)
          for (int w = 0; w < kTcWarps; ++w) mr = fmaxf(mr, st_s[(w * QB + r) * 2]);
        for (int w = 0; w < kTcWarps; ++w) {
          const float* st = st_s + (w * QB + r) * 2;
          den += CLAMP || st[0] == mr ? st[1] : st[1] * exp_ftz(st[0] - mr);
        }
        mx[mt][hf] = mr;
        inv[mt][hf] = 1.f / den;
        if (warp == 0 && tg == 0) den_s[r] = den;
      }

    // pass 2: P, the head mean and the cls row, O = P V
    float o[MT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    for (int i = 0; i < mine; ++i) {
      if (i + 1 < mine) {
        stage_kv(h, i + 1, true);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const bf16* k_s = ring + (i & 1) * kStage;
      const int k0 = (warp + i * kTcWarps) * kTcChunk;
      float s[MT][2][4];
      logits(s, q_h, k_s, k0);
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int k = k0 + nt * 8 + 2 * tg;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = exp_ftz(s[mt][nt][e] - mx[mt][e >> 1]);
            p[e] = ftz(ex * inv[mt][e >> 1]);
            s[mt][nt][e] = ROLLOUT ? p[e] : ex;
          }
          if (ROLLOUT) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              if (row_ok[mt][hf]) {
                float2* h2 = reinterpret_cast<float2*>(hm_s + (mt * 16 + g + 8 * hf) * hs + k);
                *h2 = make_float2(h2->x + p[2 * hf], h2->y + p[2 * hf + 1]);
              }
          }
          if (has_cls && mt == 0 && g == 0) {
            cls_s[k] += p[0];
            cls_s[k + 1] += p[1];
          }
        }
        a_from_c(pa[mt], s[mt][0], s[mt][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        unsigned vb[4];
        TC::v_frags(vb, k_s + TC::kChunk, j, 1.f, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o[mt][2 * j], pa[mt], vb[0], vb[1]);
          mma16816(o[mt][2 * j + 1], pa[mt], vb[2], vb[3]);
        }
      }
      __syncwarp();
    }

    // the warps' partial O tiles meet in their own rings, summed in one order
    float* ox = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        *reinterpret_cast<float2*>(ox + (mt * 16 + g) * kOStride + j * 8 + 2 * tg) =
            make_float2(o[mt][j][0], o[mt][j][1]);
        *reinterpret_cast<float2*>(ox + (mt * 16 + g + 8) * kOStride + j * 8 + 2 * tg) =
            make_float2(o[mt][j][2], o[mt][j][3]);
      }
    __syncthreads();   // ... and every warp has read this head's q
    for (int idx = tid; idx < QB * (DH / 4); idx += kGT) {
      const int r = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kTcWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(rings + w * kRing) + r * kOStride + d);
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      if (!ROLLOUT) {
        const float den = den_s[r];
        acc.x /= den, acc.y /= den, acc.z /= den, acc.w /= den;
      }
      *reinterpret_cast<uint2*>(attn_s + r * cs + h * DH + d) =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
    __syncthreads();   // the rings are free again
    if (mine && h + 1 < heads) stage_kv(h + 1, 0, false);
  }

  if (has_cls)
    for (int k = tid; k < n; k += kGT) cls[size_t(b) * n + k] = from_f<bf16>(cls_s[k] / heads);
  if constexpr (ROLLOUT) {
    for (int i = tid; i < QB * hs; i += kGT) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    rollout_rows<QB, kGT, 4>(hm_s, hs, joint, newj, b, q0, n);
  }
  proj_rows<bf16, QB>(attn_s, cs, wproj, bproj, tok, out, b, q0, n, c, stage);
}

// The float32 kernel (the FMA core): QB query rows of one image.
template <bool ROLLOUT, bool CLAMP, int QB, int DH>
__global__ void __launch_bounds__(kGT)
attention_block_streamed_fma_kernel(const float* __restrict__ xn, const float* __restrict__ tok,
                                    const float* __restrict__ wqkv,
                                    const float* __restrict__ bqkv,
                                    const float* __restrict__ wproj,
                                    const float* __restrict__ bproj, const float* __restrict__ bg,
                                    const float* __restrict__ joint, const float* __restrict__ kv,
                                    float* __restrict__ out, float* __restrict__ cls,
                                    float* __restrict__ newj, int n, int heads, float scale,
                                    float mask_value) {
  constexpr int kStride = kKVStrideOf<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = heads * DH, cs = c + a_pad<float>(), ns = padded(n);
  const StSmem lay = st_layout_fma(n, c, DH, ROLLOUT, QB);
  auto floats = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  float* attn_s = floats(lay.attn);          // q, then O, of every head
  float* hm_s = floats(lay.hm);
  float* cls_s = floats(lay.cls);
  float* km_s = floats(lay.km);
  float* fg_s = floats(lay.fg);
  float* den_s = floats(lay.den);
  void* stage = smem + lay.u;                // GEMM staging ...
  float* s_s = floats(lay.u);                // ... or the S tile [QB][ns]
  float* kv_s = s_s + QB * ns;               //   and a K or V chunk [kKC][kStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * QB;
  const float* xn_b = xn + size_t(b) * n * c;
  const float* bg_b = bg + size_t(b) * n;
  const bool has_cls = q0 == 0;

  for (int k = tid; k < ns; k += kGT) {
    km_s[k] = k < n ? bg_b[k] * mask_value : 0.f;
    cls_s[k] = 0.f;
  }
  for (int r = tid; r < QB; r += kGT) fg_s[r] = (q0 + r < n) ? 1.f - bg_b[q0 + r] : 0.f;
  if (ROLLOUT)
    for (int i = tid; i < QB * ns; i += kGT) hm_s[i] = 0.f;
  for (int i = tid; i < QB * (cs - c); i += kGT)   // the pad columns: zero A columns of proj
    attn_s[i / (cs - c) * cs + c + i % (cs - c)] = 0.f;
  q_rows<float, QB>(attn_s, cs, xn_b, q0, n, wqkv, bqkv, c, stage);

  // rows [k0, k0 + kKC) of K or V of head h (part 0 or 1), zeros past n
  auto stage_f32 = [&](int part, int h, int k0) {
    const float* src = kv + ((size_t(b) * 2 + part) * heads + h) * size_t(n) * DH;
    for (int i = tid; i < kKC * (DH / 4); i += kGT) {
      const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n) v = __ldg(reinterpret_cast<const float4*>(src + size_t(k0 + r) * DH + d));
      *reinterpret_cast<float4*>(kv_s + r * kStride + d) = v;
    }
  };

  for (int h = 0; h < heads; ++h) {
    const float* q_h = attn_s + h * DH;
    // S tile, one K chunk at a time.  Thread: one key, QB / 4 rows.
    {
      constexpr int kRows = QB * kKC / kGT, kStep = kGT / kKC;
      const int kj = tid % kKC, rg = tid / kKC;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // q in place; the previous chunk (or the staging) consumed
        stage_f32(0, h, k0);
        __syncthreads();
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
        const float4* k4 = reinterpret_cast<const float4*>(kv_s + kj * kStride);
#pragma unroll 4
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kv4 = k4[d4];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float4 qv = reinterpret_cast<const float4*>(q_h + (rg + i * kStep) * cs)[d4];
            acc[i] += qv.x * kv4.x + qv.y * kv4.y + qv.z * kv4.z + qv.w * kv4.w;
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
    for (int r = warp; r < QB; r += kGT / 32) {
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
        row[k] = ROLLOUT ? p : e;
      }
      if (lane == 0) den_s[r] = sum;
    }

    // O = P V, one V chunk at a time, over the head's q columns of attn_s
    // (read by now).  Where the threads divide by DH (16, 32, 64): thread =
    // one column d, QB * DH / kGT rows.  Else (40, 80): (row, column) pairs,
    // pair i at index tid + i * kGT of the [QB][DH] tile (at 40 and QB = 16
    // the pairs past the tile are skipped).
    if constexpr (kGT % DH == 0) {
      constexpr int kRows = QB * DH / kGT, kStep = kGT / DH;
      const int d = tid % DH, rg = tid / DH;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; the previous chunk consumed
        stage_f32(1, h, k0);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
          const float v0 = kv_s[(j + 0) * kStride + d];
          const float v1 = kv_s[(j + 1) * kStride + d];
          const float v2 = kv_s[(j + 2) * kStride + d];
          const float v3 = kv_s[(j + 3) * kStride + d];
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
        attn_s[r * cs + h * DH + d] = ROLLOUT ? acc[i] : acc[i] / den_s[r];
      }
    } else {
      constexpr int kPairs = QB * DH, kRows = (kPairs + kGT - 1) / kGT;
      constexpr bool kWholeP = kPairs % kGT == 0;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < n; k0 += kKC) {
        __syncthreads();   // softmax done; the previous chunk consumed
        stage_f32(1, h, k0);
        __syncthreads();
        const int kend = min(kKC, ns - k0);   // a multiple of 4
        for (int j = 0; j < kend; j += 4) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int idx = tid + i * kGT, r = idx / DH, d = idx % DH;
            if (!kWholeP && idx >= kPairs) break;
            const float4 p = *reinterpret_cast<const float4*>(s_s + r * ns + k0 + j);
            acc[i] += p.x * kv_s[(j + 0) * kStride + d] + p.y * kv_s[(j + 1) * kStride + d] +
                      p.z * kv_s[(j + 2) * kStride + d] + p.w * kv_s[(j + 3) * kStride + d];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int idx = tid + i * kGT, r = idx / DH, d = idx % DH;
        if (!kWholeP && idx >= kPairs) break;
        attn_s[r * cs + h * DH + d] = ROLLOUT ? acc[i] : acc[i] / den_s[r];
      }
    }
    __syncthreads();   // s_s, den_s and kv_s are reused by the next head
  }

  if (has_cls)
    for (int k = tid; k < n; k += kGT) cls[size_t(b) * n + k] = cls_s[k] / heads;
  if constexpr (ROLLOUT) {
    for (int i = tid; i < QB * ns; i += kGT) hm_s[i] = hm_s[i] / heads;
    __syncthreads();
    rollout_rows<QB, kGT, 1>(hm_s, ns, joint, newj, b, q0, n);
  }
  proj_rows<float, QB>(attn_s, cs, wproj, bproj, tok, out, b, q0, n, c, stage);
}

// the launch arguments every instance shares
struct StArgs {
  const void *xn, *tok, *wqkv, *bqkv, *wproj, *bproj, *bg, *joint, *kv;
  void *out, *cls, *newj;
  int batch, n, heads;
  float scale, mask_value;
};

// the instance of (dtype, rollout, clamp, row tile) at width DH, and its
// shared memory
template <int DH, bool ROLLOUT, bool CLAMP>
const void* st_pick(int dtype, int qb) {
  if (dtype == 1) {
    return qb == 32 ? reinterpret_cast<const void*>(
                          attention_block_streamed_tc_kernel<ROLLOUT, CLAMP, 2, DH>)
                    : reinterpret_cast<const void*>(
                          attention_block_streamed_tc_kernel<ROLLOUT, CLAMP, 1, DH>);
  }
  return qb == 32 ? reinterpret_cast<const void*>(
                        attention_block_streamed_fma_kernel<ROLLOUT, CLAMP, 32, DH>)
                  : reinterpret_cast<const void*>(
                        attention_block_streamed_fma_kernel<ROLLOUT, CLAMP, 16, DH>);
}

template <int DH>
const void* st_kernel(int dtype, bool rollout, int clamp, int qb) {
  if (rollout) return clamp ? st_pick<DH, true, true>(dtype, qb) : st_pick<DH, true, false>(dtype, qb);
  return clamp ? st_pick<DH, false, true>(dtype, qb) : st_pick<DH, false, false>(dtype, qb);
}

inline size_t st_smem_bytes(int n, int c, int dh, bool rollout, int dtype, int qb) {
  return dtype == 1 ? st_layout_tc(n, c, dh, rollout, qb).total
                    : st_layout_fma(n, c, dh, rollout, qb).total;
}

// the second launch at width DH: grid (ceil(N / qb), B), one block of kGT
// threads a query tile
template <int DH>
cudaError_t st_launch(const StArgs& a, int dtype, int clamp, int qb, cudaStream_t stream) {
  const bool rollout = a.joint != nullptr;
  const void* kernel = st_kernel<DH>(dtype, rollout, clamp, qb);
  const size_t smem = st_smem_bytes(a.n, a.heads * DH, DH, rollout, dtype, qb);
  if (smem > kStMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + qb - 1) / qb, a.batch);
  int n = a.n, heads = a.heads;
  float scale = a.scale, mask_value = a.mask_value;
  void* args[] = {const_cast<const void**>(&a.xn),   const_cast<const void**>(&a.tok),
                  const_cast<const void**>(&a.wqkv), const_cast<const void**>(&a.bqkv),
                  const_cast<const void**>(&a.wproj), const_cast<const void**>(&a.bproj),
                  const_cast<const void**>(&a.bg),   const_cast<const void**>(&a.joint),
                  const_cast<const void**>(&a.kv),   const_cast<void**>(&a.out),
                  const_cast<void**>(&a.cls),        const_cast<void**>(&a.newj),
                  &n, &heads, &scale, &mask_value};
  err = cudaLaunchKernel(kernel, grid, dim3(kGT), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the second launch's C entry at width DH (the arguments of
// vitcam_attention_block_streamed, attention_block_streamed.cu)
template <int DH>
int st_entry(const void* xn, const void* tok, const void* wqkv, const void* bqkv,
             const void* wproj, const void* bproj, const void* bg, const void* joint,
             const void* kv, void* out, void* cls, void* newj, int batch, int n, int heads,
             float scale, float mask_value, int dtype, int clamp, int q_block, void* stream) {
  const StArgs a{xn,  tok, wqkv, bqkv,  wproj, bproj, bg,    joint,     kv,
                 out, cls, newj, batch, n,     heads, scale, mask_value};
  return st_launch<DH>(a, dtype, clamp, q_block, static_cast<cudaStream_t>(stream));
}

// info = {blocks an SM at once, registers per thread, local memory per thread
// (bytes: spills and stack), shared memory per block} of the instance at N
template <int DH>
cudaError_t st_occupancy(int n, int heads, bool rollout, int clamp, int dtype, int qb,
                         int* info) {
  const void* kernel = st_kernel<DH>(dtype, rollout, clamp, qb);
  const size_t smem = st_smem_bytes(n, heads * DH, DH, rollout, dtype, qb);
  if (smem > kStMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, kGT, smem);
  info[1] = fa.numRegs;
  info[2] = int(fa.localSizeBytes);
  info[3] = int(smem);
  return err;
}

}  // namespace
