"""One-call serving-mode configuration (the port of
vision_transformer_cam_tpu/serving.py).

    model = serving.apply_serving_mode(model, "bf16")

Modes
-----
- "off":  reference-parity graph; the model is returned unchanged.
- "bf16": bf16 parameters and activations, tanh GELU, clamped softmax,
          per-sample mask normalization and the fused CUDA attention kernel
          (``attn_impl="kernel"``; on CPU tensors the kernel's plain
          PyTorch version runs instead).
- "int8", "int8_hifi": W8A8 GEMMs and int8 attention I/O; not ported yet
          (ROADMAP Queue 1 item 4), so they raise.
"""

from __future__ import annotations

import torch

SERVING_MODES = ("off", "bf16", "int8", "int8_hifi")


def serving_config(cfg, mode: str):
    """The config half of apply_serving_mode."""
    if mode not in SERVING_MODES:
        raise ValueError(f"serving mode {mode!r}: expected one of "
                         f"{SERVING_MODES}")
    if mode in ("int8", "int8_hifi"):
        raise NotImplementedError(
            f"serving mode {mode!r} is not ported yet (ROADMAP Queue 1 item "
            "4: int8 serving)")
    if mode == "off":
        return cfg
    # per_sample_mask_norm: the reference validates at batch 1, where its
    # batch-global mask normalization is the per-sample one; per sample also
    # keeps a batched server's outputs independent of the batch's makeup
    return cfg.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       gelu_approx=True, softmax_clamp=True,
                       attn_impl="kernel", per_sample_mask_norm=True)


def apply_serving_mode(model, mode: str):
    """Rewrite ``model`` (a models.vit.ViTCAM) in place for ``mode`` and
    return it: floating parameters cast to the mode's dtype, ``model.cfg``
    replaced."""
    cfg = serving_config(model.cfg, mode)
    if mode != "off":
        model.to(dtype=cfg.param_dtype)
    model.cfg = cfg
    return model
