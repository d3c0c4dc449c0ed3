"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: fused masked attention with the CAM statistics."""

from vision_transformer_cam_tpu_torch.kernels.attention import (  # noqa: F401
    masked_attention_fused, masked_attention_fused_ref)
