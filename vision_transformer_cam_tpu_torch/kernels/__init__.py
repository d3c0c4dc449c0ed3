"""Hand-written kernels for Hopper (sm_90a), each beside its plain PyTorch
version: fused masked attention with the CAM statistics (CUDA), the int8
serving GEMM (CUDA) and the fused LayerNorm -> int8 quantize (Triton)."""

from vision_transformer_cam_tpu_torch.kernels.attention import (  # noqa: F401
    masked_attention_fused, masked_attention_fused_ref)
from vision_transformer_cam_tpu_torch.kernels.gemm import (  # noqa: F401
    linear_int8, linear_int8_ref, ln_quant, ln_quant_ref)
