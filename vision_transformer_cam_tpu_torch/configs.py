"""Typed model configuration: the PyTorch counterpart of
vision_transformer_cam_tpu/configs.py's ``ViTCAMConfig`` and ViT model zoo.

Field for field the same dataclass, with torch dtypes.  ``attn_impl`` names
the port's two attention paths: ``"eager"`` (plain PyTorch with the reference's
symmetric pair mask, the JAX ``"xla"`` path) and ``"kernel"`` (the fused CUDA
kernel, the JAX ``"pallas"`` path).  The TPU tuning and sharding knobs keep
their fields so configurations carry over, but the model raises when one is
set that this package does not implement yet (``models.vit.check_supported``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ViTCAMConfig:
    """Model + CAM-mechanism configuration (the reference VisionTransformer's
    constructor surface plus the CAM mechanism constants)."""

    # --- architecture ---
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 20
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    representation_size: Optional[int] = None  # pre_logits layer if set
    distilled: bool = False

    # --- regularization (training only; the forward here is inference) ---
    drop_ratio: float = 0.0
    attn_drop_ratio: float = 0.0
    drop_path_ratio: float = 0.0

    # --- CAM / attention-mask mechanism ---
    # The bg mask is recomputed at the end of every block with index >=
    # mask_from and applied (mask_value on bg-involving pairs) from the next.
    mask_from: int = 4
    mask_threshold: float = 0.25
    mask_value: float = -100.0
    top_k_patches: int = 16
    # the reference normalizes the cls row by the batch-global max; True
    # normalizes per sample (the serving semantics)
    per_sample_mask_norm: bool = False

    # --- numerics ---
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32        # activation dtype
    param_dtype: torch.dtype = torch.float32

    # --- implementation switches ---
    attn_impl: str = "eager"  # "eager" | "kernel"
    # None or "highest": float32 GEMMs in full float32 (TF32 stays off)
    matmul_precision: Optional[str] = None
    gelu_approx: bool = False     # tanh GELU (serving); exact erf otherwise
    remat: bool = True            # training slice
    softmax_clamp: bool = False   # min(S, 80) instead of the row-max subtract
    attn_block_fusion: bool = False
    mlp_fusion: bool = False
    int8_fused_gemm: bool = False
    int8_attn_io: bool = False
    int8_attn_out: bool = False
    attn_block_b: int = 0
    attn_q_block: int = 0
    # rollout CAM as a post-loop vector chain over the per-layer head-mean
    # matrices instead of the [B, N, N] joint carry; None = auto (N > 512)
    rollout_post: Optional[bool] = None
    ln_quant_fusion: bool = False
    data_axis: Optional[str] = None
    seq_axis: Optional[str] = None

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.qk_scale if self.qk_scale is not None else self.head_dim ** -0.5

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def has_logits(self) -> bool:
        return self.representation_size is not None and not self.distilled

    def replace(self, **kw) -> "ViTCAMConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model zoo: the reference's ViT factories plus the long-sequence configs
# ---------------------------------------------------------------------------

def vit_base_patch16_224(num_classes: int = 1000) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=16, embed_dim=768, depth=12,
                        num_heads=12, representation_size=None,
                        num_classes=num_classes)


def vit_base_patch16_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True) -> ViTCAMConfig:
    """The flagship model used by all entries."""
    return ViTCAMConfig(img_size=224, patch_size=16, embed_dim=768, depth=12,
                        num_heads=12,
                        representation_size=768 if has_logits else None,
                        num_classes=num_classes)


def vit_base_patch32_224(num_classes: int = 1000) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=32, embed_dim=768, depth=12,
                        num_heads=12, representation_size=None,
                        num_classes=num_classes)


def vit_base_patch32_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=32, embed_dim=768, depth=12,
                        num_heads=12,
                        representation_size=768 if has_logits else None,
                        num_classes=num_classes)


def vit_large_patch16_224(num_classes: int = 1000) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=16, embed_dim=1024, depth=24,
                        num_heads=16, representation_size=None,
                        num_classes=num_classes)


def vit_large_patch16_224_in21k(num_classes: int = 21843,
                                has_logits: bool = True) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=16, embed_dim=1024, depth=24,
                        num_heads=16,
                        representation_size=1024 if has_logits else None,
                        num_classes=num_classes)


def vit_large_patch16_384(num_classes: int = 1000) -> ViTCAMConfig:
    """384 px -> 577 tokens."""
    return ViTCAMConfig(img_size=384, patch_size=16, embed_dim=1024, depth=24,
                        num_heads=16, representation_size=None,
                        num_classes=num_classes)


def vit_large_patch16_512(num_classes: int = 1000) -> ViTCAMConfig:
    """512 px / patch 16 -> 32x32 grid, N = 1025."""
    return ViTCAMConfig(img_size=512, patch_size=16, embed_dim=1024, depth=24,
                        num_heads=16, representation_size=None,
                        num_classes=num_classes)


def vit_large_patch32_224_in21k(num_classes: int = 21843,
                                has_logits: bool = True) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=32, embed_dim=1024, depth=24,
                        num_heads=16,
                        representation_size=1024 if has_logits else None,
                        num_classes=num_classes)


def vit_huge_patch14_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True) -> ViTCAMConfig:
    return ViTCAMConfig(img_size=224, patch_size=14, embed_dim=1280, depth=32,
                        num_heads=16,
                        representation_size=1280 if has_logits else None,
                        num_classes=num_classes)


MODEL_ZOO = {
    "vit_base_patch16_224": vit_base_patch16_224,
    "vit_base_patch16_224_in21k": vit_base_patch16_224_in21k,
    "vit_base_patch32_224": vit_base_patch32_224,
    "vit_base_patch32_224_in21k": vit_base_patch32_224_in21k,
    "vit_large_patch16_224": vit_large_patch16_224,
    "vit_large_patch16_224_in21k": vit_large_patch16_224_in21k,
    "vit_large_patch16_384": vit_large_patch16_384,
    "vit_large_patch16_512": vit_large_patch16_512,
    "vit_large_patch32_224_in21k": vit_large_patch32_224_in21k,
    "vit_huge_patch14_224_in21k": vit_huge_patch14_224_in21k,
}

# the reference's --model_name value maps to the factory all entries build
MODEL_ALIASES = {"vit_base": "vit_base_patch16_224_in21k"}


def resolve_model(name: str):
    """Zoo factory for `name`, honoring the 'vit_base' alias; unknown names
    raise."""
    key = MODEL_ALIASES.get(name, name)
    if key not in MODEL_ZOO:
        raise SystemExit(
            f"unknown model_name {name!r}; choose from "
            f"{sorted(MODEL_ZOO) + sorted(MODEL_ALIASES)}")
    return MODEL_ZOO[key]
