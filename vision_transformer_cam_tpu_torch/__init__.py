"""vision_transformer_cam_tpu_torch: the PyTorch / CUDA port of
vision_transformer_cam_tpu for NVIDIA Hopper.  ViT-CAM inference (the
rollout CAM main path) in float, bf16 and int8 serving modes, with
hand-written kernels for the masked attention, the int8 GEMM and the fused
LayerNorm -> int8 quantize; the JAX package beside it is the reference each
part is tested against."""

__version__ = "0.1.0"

from vision_transformer_cam_tpu_torch.models.vit import (  # noqa: F401
    ViTCAM, ViTCAMOutput)
