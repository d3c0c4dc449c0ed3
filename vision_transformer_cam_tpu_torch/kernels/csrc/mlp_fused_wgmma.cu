// The fused MLP kernels in their Hopper design (sm_90a): the C entry points
// and the instance of mlp_fused_wgmma.cuh that takes C <= 768 in one column
// group (384 output columns a consumer warpgroup).  Past C = 768 the entry
// points launch the instances of mlp_fused_wgmma_wide.cu (256 and 320
// columns, two groups at ViT-L's C = 1024 and ViT-H's 1280), or this one's
// in more groups.  The design, the shapes it takes and what bounds it are
// described in mlp_fused_wgmma.cuh.
//
// Built by kernels/_build.py with nvcc into the shared library with a plain C
// interface (no PyTorch headers) and called through ctypes.

#include "mlp_fused_wgmma.cuh"

extern "C" {

// the instances at 256 and 320 columns (mlp_fused_wgmma_wide.cu)
int vitcam_mlp_wgmma_wide_launch(int nw, int kind, int x_dtype, int out_dtype, const void* w1,
                                 const void* w2, const void* params, void* stream);
int vitcam_mlp_wgmma_wide_occupancy(int nw, int c, int kind, int* info);

}  // extern "C"

namespace {

int run(int kind, int x_dtype, int out_dtype, const void* w1, const void* w2, const Params& p,
        void* stream) {
  const int nw = group_nw(p.C);
  if (nw != 384)
    return vitcam_mlp_wgmma_wide_launch(nw, kind, x_dtype, out_dtype, w1, w2, &p, stream);
  return launch_kind<384>(kind, x_dtype, out_dtype, w1, w2, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// x, w1 [HID, C], b1 [HID], w2 [C, HID], b2 [C], out [M, C], all bfloat16.
// Returns a cudaError_t; 0 means the kernel was launched.
int vitcam_mlp_wgmma(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int M, int C, int HID, int gelu_approx,
                     void* stream) {
  const Params p{x, b1, b2, nullptr, nullptr, nullptr, nullptr, out, M, C, HID, gelu_approx};
  return run(1, 1, 1, w1, w2, p, stream);
}

// x [M, C] of x_dtype (0 = float32, 1 = bfloat16); w1q int8 [HID, C], w2q int8
// [C, HID]; cs1 [HID], cs2 [C] (combined scales), b1, b2 (or null) float32;
// inv_a1, inv_a2 device pointers to one float each; out [M, C] of out_dtype.
int vitcam_mlp_wgmma_int8(const void* x, int x_dtype, const void* w1q, const void* cs1,
                          const void* b1, const void* w2q, const void* cs2, const void* b2,
                          const void* inv_a1, const void* inv_a2, void* out, int out_dtype,
                          int M, int C, int HID, int gelu_approx, void* stream) {
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  const Params p{x, b1, b2, f(cs1), f(cs2), f(inv_a1), f(inv_a2), out, M, C, HID, gelu_approx};
  return run(2, x_dtype, out_dtype, w1q, w2q, p, stream);
}

// kind: 1 = the bfloat16 kernel, 2 = the int8 one.  The bytes a block of
// width c needs, its ring at ring_stages (at least 2 stages: past the widths
// the design takes, what a launch would need).
size_t vitcam_mlp_wgmma_smem_bytes(int c, int kind) {
  return kind == 2 ? smem_bytes<true>(c) : smem_bytes<false>(c);
}

// ring stages of a block of width c (kind as above)
int vitcam_mlp_wgmma_ring_stages(int c, int kind) {
  return kind == 2 ? ring_stages<true>(c) : ring_stages<false>(c);
}

// output columns of a consumer warpgroup at width c: 384, 320 or 256 (the
// instance, mlp_fused_wgmma.cuh: group_nw); a block's column group is twice
// that
int vitcam_mlp_wgmma_group_cols(int c) { return group_nw(c); }

// The kernel instance the serving path runs (kind 1: bf16; kind 2: int8 with
// bf16 x and out) at width c: info = {blocks an SM holds at once, registers
// a thread at launch, local memory bytes a thread, dynamic shared memory
// bytes a block}.
int vitcam_mlp_wgmma_occupancy(int c, int kind, int* info) {
  if (!(kind == 2 ? takes<true>(1, c, 64) : takes<false>(1, c, 64)))
    return cudaErrorInvalidValue;
  const int nw = group_nw(c);
  if (nw != 384) return vitcam_mlp_wgmma_wide_occupancy(nw, c, kind, info);
  return occupancy_kind<384>(c, kind, info);
}

}  // extern "C"
