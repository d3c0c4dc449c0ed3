"""Typed model configuration: the PyTorch counterpart of
vision_transformer_cam_tpu/configs.py's ``ViTCAMConfig`` and ViT model zoo.

Field for field the same dataclasses (``ViTCAMConfig``, ``DataConfig``,
``OptimConfig``, ``TrainConfig``), with torch dtypes.  ``attn_impl`` names
the port's two attention paths: ``"eager"`` (plain PyTorch with the reference's
symmetric pair mask, the JAX ``"xla"`` path) and ``"kernel"`` (the fused CUDA
kernel, the JAX ``"pallas"`` path).  The TPU tuning and sharding knobs keep
their fields so configurations carry over, but the model raises when one is
set that this package does not implement yet (``models.vit.check_supported``);
``seq_axis`` with ``data_axis`` beside it (``parallel.apply_seq_parallel``)
is the sequence-parallel inference layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    # --- regularization (the training forward only) ---
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
    # float32 GEMM precision, set around each forward
    # (torch.set_float32_matmul_precision): None, "highest" or "float32" =
    # full float32; "high" or "tensorfloat32" = TF32 in the cuBLAS GEMMs,
    # the hand-written kernels' own products staying float32
    matmul_precision: Optional[str] = None
    gelu_approx: bool = False     # tanh GELU (serving); exact erf otherwise
    remat: bool = True            # training slice
    softmax_clamp: bool = False   # min(S, 80) instead of the row-max subtract
    attn_block_fusion: bool = False
    mlp_fusion: bool = False
    int8_fused_gemm: bool = False
    int8_attn_io: bool = False
    int8_attn_out: bool = False
    # images per TPU kernel program: no counterpart on the card, whose grid
    # is one thread block per (query tile, image) already; any value >= 0 is
    # taken and changes nothing
    attn_block_b: int = 0
    # query rows per thread block of the attention kernel, the rows of S it
    # holds in shared memory: 16 or 32; 0 = 32 where the tiles fit, else 16
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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """VOC12 data pipeline configuration (the JAX package's DataConfig)."""

    voc12_root: str = ""
    img_name_list_path: str = ""
    cls_labels_path: str = ""  # cls_labels.npy; derived from voc12 dir if empty
    img_size: int = 224
    # ImageNet normalization, exactly the reference's constants
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    batch_size: int = 32
    shuffle: bool = True
    drop_last: bool = True
    seg_labels: bool = False
    num_threads: int = 4
    # the C++ batched JPEG pipeline (io/native_loader); PIL where the
    # library is absent
    native_decode: bool = False
    prefetch: int = 2
    seed: int = 0
    loader_impl: str = "auto"  # "auto" | "native" | "pil"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """timm create_optimizer / create_scheduler-compatible hyperparameters
    (the reference's argparse defaults)."""

    opt: str = "adamw"
    lr: float = 5e-4
    # the entry scales lr by batch / 512
    linear_lr_scaling: bool = True
    opt_eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.05
    clip_grad: Optional[float] = None
    sched: str = "cosine"
    epochs: int = 1000
    warmup_epochs: int = 5
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    cooldown_epochs: int = 10
    decay_epochs: float = 30
    decay_rate: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    batch_size: int = 16
    seed: int = 0
    freeze_backbone: bool = False
    log_every: int = 50
    ckpt_dir: str = "./weights"
    # the sharding knobs of the JAX package keep their fields; the trainer
    # runs on one device and raises when one is set away from these defaults
    # (train.loop.check_supported)
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # gradient accumulation: microbatches per optimizer step (exact
    # full-batch semantics: the dual loss is a sample mean)
    grad_accum: int = 1
    zero1: bool = False
    pipeline: int = 0
    pp_microbatches: int = 0


@dataclasses.dataclass(frozen=True)
class PseudoSegConfig:
    """validate.py pseudo-segmentation constants (validate.py:133,184,244)."""

    cls_threshold: float = 0.9
    fg_cos_threshold: float = 0.5
    bg_rollout_threshold: float = 0.05
    bg_blocks_from: int = 5  # rollout bg mask uses blocks 6..12 (validate.py:227)


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
