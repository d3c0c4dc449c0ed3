// The wide instances of the fused MLP kernels' Hopper design
// (mlp_fused_wgmma.cuh): 256 and 320 output columns a consumer warpgroup,
// a column group of 512 or 640 a block, which the entry points of
// mlp_fused_wgmma.cu launch past C = 768 (ViT-L's C = 1024 and ViT-H's
// 1280 in two groups each).  A translation unit of its own, so that nvcc
// builds them beside the C <= 768 instance and not after it.

#include "mlp_fused_wgmma.cuh"

extern "C" {

// one launch of the instance nw (256 or 320) on params (a Params of
// mlp_fused_wgmma.cuh); kind, x_dtype, out_dtype as launch_kind
int vitcam_mlp_wgmma_wide_launch(int nw, int kind, int x_dtype, int out_dtype, const void* w1,
                                 const void* w2, const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 256:
      return launch_kind<256>(kind, x_dtype, out_dtype, w1, w2, p, s);
    case 320:
      return launch_kind<320>(kind, x_dtype, out_dtype, w1, w2, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int vitcam_mlp_wgmma_wide_occupancy(int nw, int c, int kind, int* info) {
  switch (nw) {
    case 256:
      return occupancy_kind<256>(c, kind, info);
    case 320:
      return occupancy_kind<320>(c, kind, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
