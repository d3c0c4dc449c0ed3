"""vision_transformer_cam_tpu_torch: the PyTorch / CUDA port of
vision_transformer_cam_tpu for NVIDIA Hopper.  ViT-CAM inference (the
rollout CAM main path) in float, bf16 and int8 serving modes, and
fine-tuning (train step, AdamW and schedule, loop, checkpoints, CLI), the
sequence-parallel inference layout for the long-N models and the validate /
pseudo-seg entry point, with hand-written kernels for the masked attention,
its backward and its sequence-parallel form, the int8 GEMM, the fused
LayerNorm -> int8 quantize, the fused MLP and the fused attention sub-block;
the JAX package beside it is
the reference each part is tested against.  Entry points run on the card
unless the caller asks for the CPU (``utils.resolve_device``)."""

__version__ = "0.1.0"

from vision_transformer_cam_tpu_torch.models.vit import (  # noqa: F401
    ViTCAM, ViTCAMOutput)
