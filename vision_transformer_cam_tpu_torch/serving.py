"""One-call serving-mode configuration (the port of
vision_transformer_cam_tpu/serving.py).

    model = serving.apply_serving_mode(model, "int8", calib_images=batch)

Modes
-----
- "off":  reference-parity graph; the model is returned unchanged.
- "bf16": bf16 parameters and activations, tanh GELU, clamped softmax,
          per-sample mask normalization and the fused CUDA attention kernel
          (``attn_impl="kernel"``; on CPU tensors the kernel's plain
          PyTorch version runs instead).
- "int8": bf16 mode plus W8A8 GEMMs with static calibrated activation
          scales (the int8 GEMM kernel) and int8 attention I/O with
          per-head q/k/v scales.  Past 640 tokens the attention takes float
          qkv and writes int8 output instead (the "int8_hifi" attention).
- "int8_hifi": int8 W8A8 GEMMs, but the attention core stays float: the
          kernel only writes its output as int8 for the proj GEMM, so the
          probabilities the rollout CAM is built from are unquantized.

The int8 modes calibrate on ``calib_images`` (8-16 representative images;
the JAX package's quality protocol uses 16) and raise without them.
"""

from __future__ import annotations

import torch

SERVING_MODES = ("off", "bf16", "int8", "int8_hifi")


def serving_config(cfg, mode: str):
    """The config half of apply_serving_mode."""
    if mode not in SERVING_MODES:
        raise ValueError(f"serving mode {mode!r}: expected one of "
                         f"{SERVING_MODES}")
    if mode == "off":
        return cfg
    # per_sample_mask_norm: the reference validates at batch 1, where its
    # batch-global mask normalization is the per-sample one; per sample also
    # keeps a batched server's outputs independent of the batch's makeup
    cfg = cfg.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                      gelu_approx=True, softmax_clamp=True,
                      attn_impl="kernel", per_sample_mask_norm=True)
    if mode == "int8":
        # past 640 tokens the JAX package routes the "int8" tier's attention
        # through the output-only int8 path (measured faster there on its
        # TPU, with equivalent fidelity); the port keeps the same routing
        # until the H100 measures otherwise
        if cfg.seq_len > 640:
            cfg = cfg.replace(int8_attn_out=True)
        else:
            cfg = cfg.replace(int8_attn_io=True)
    elif mode == "int8_hifi":
        cfg = cfg.replace(int8_attn_out=True)
    return cfg


def apply_serving_mode(model, mode: str, calib_images=None,
                       calib_margin: float = 1.0):
    """Rewrite ``model`` (a models.vit.ViTCAM) in place for ``mode`` and
    return it: floating parameters cast to bf16, ``model.cfg`` replaced,
    and for the int8 modes the GEMMs quantized with static activation
    scales calibrated on ``calib_images`` ([N, H, W, 3] float images, numpy
    or tensor; scale = absmax * calib_margin / 127).  Calibration and
    weight quantization see the bf16-cast weights, as in the JAX package."""
    cfg = serving_config(model.cfg, mode)
    if mode == "off":
        return model
    if mode in ("int8", "int8_hifi") and calib_images is None:
        raise ValueError(
            f"serving mode {mode!r} needs calib_images for the static "
            "activation scales (dynamic quantization is not the "
            "characterized configuration)")
    model.to(dtype=cfg.param_dtype)
    if mode in ("int8", "int8_hifi"):
        from vision_transformer_cam_tpu_torch.ops.quant import (
            calibrate_act_scales, quantize_params)
        scales = calibrate_act_scales(model, cfg, calib_images,
                                      margin=calib_margin)
        quantize_params(model, act_scales=scales)
    model.cfg = cfg
    return model


def serving_mode_help() -> str:
    """One-line-per-mode summary for CLI --serving help strings."""
    return ("off = reference-parity f32; bf16 = bf16 + tanh GELU + clamp "
            "softmax + fused CUDA attention kernel; int8 adds W8A8 GEMMs + "
            "per-head int8 attention I/O (past 640 tokens it routes to the "
            "output-only int8 attention path, with equivalent fidelity); "
            "int8_hifi keeps the attention core float and only writes its "
            "output as int8")
