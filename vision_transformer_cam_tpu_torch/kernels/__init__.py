"""Hand-written kernels for Hopper (sm_90a), each beside its plain PyTorch
version: fused masked attention with the CAM statistics, its backward and
its sequence-parallel form (CUDA), the int8 serving GEMM (CUDA), the fused
MLP and attention sub-block (CUDA) and the fused LayerNorm -> int8 quantize
(Triton)."""

from vision_transformer_cam_tpu_torch.kernels.attention import (  # noqa: F401
    fused_attention_diff, masked_attention_bwd, masked_attention_bwd_ref,
    masked_attention_fused, masked_attention_fused_ref, masked_attention_seq,
    masked_attention_seq_local, masked_attention_seq_local_ref)
from vision_transformer_cam_tpu_torch.kernels.gemm import (  # noqa: F401
    linear_int8, linear_int8_ref, ln_quant, ln_quant_ref)
