"""Headline benchmark of the port: ViT-B/16 CAM-extraction throughput
(images/sec/gpu), the counterpart of the TPU package's root ``bench.py``.

    python3 -m vision_transformer_cam_tpu_torch.bench [flags]

The rollout CAM is fused into the forward and everything stays on the device.
The flags are the TPU bench's, so its command lines mean the same thing here:

  --bf16 / --f32 / --int8 / --int8-hifi   serving dtype (default: int8)
  --eager (alias --xla)                    the eager attention path
  --no-cam                                 multi-label inference, no rollout
  --latency                                batch 1, p50 of the windows
  --train [--mixed] [--accum N]            the fine-tune step
  --model NAME  --batch N  --precision P   zoo model, batch (default 512),
                                           cfg.matmul_precision
  --mlp-fusion --int8-fused --ln-quant --rollout-post --rollout-carry
  --gelu-exact --stable-softmax --no-int8-attn --int8-attn --int8-dynamic
  --batch-global-mask --block-b N --q-block N      one ablation each
  --device D                               default the card; cpu for a dry run

Prints ONE JSON line: {"metric", "value", "unit", "device"}; ``device`` is the
card's name and power limit as nvidia-smi prints them ("cpu", with units
that say cpu, for a dry run there).  Weights are the
port's seeded init, inputs come from seeded CPU generators.
"""

from __future__ import annotations

import json
import sys
import time

import torch

_FLAGS = {"--gelu-exact", "--stable-softmax", "--mlp-fusion", "--int8-fused",
          "--rollout-post", "--rollout-carry", "--ln-quant", "--int8",
          "--int8-hifi", "--bf16", "--f32", "--xla", "--eager",
          "--no-int8-attn", "--int8-attn", "--int8-dynamic", "--no-cam",
          "--latency", "--train", "--mixed", "--batch-global-mask"}
_VALUE_FLAGS = {"--block-b", "--q-block", "--batch", "--model",
                "--dispatch-chunks", "--precision", "--accum", "--device"}
DEFAULT_MODEL = "vit_base_patch16_224_in21k"


def _check_flags(argv):
    """Reject unknown or misspelled flags and value flags missing their
    value: silently ignoring a typo'd ablation flag benchmarks the WRONG
    config and the JSON line looks legitimate.  ``argv[0]`` is the program
    name."""
    i = 1
    while i < len(argv):
        tok = argv[i]
        if tok in _VALUE_FLAGS:
            # a following "--flag" is NOT a value
            if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                raise SystemExit(f"bench.py: {tok} needs a value")
            i += 2
            continue
        if tok.startswith("--") and tok not in _FLAGS:
            raise SystemExit(f"bench.py: unknown flag {tok!r} (known: "
                             f"{sorted(_FLAGS | _VALUE_FLAGS)})")
        i += 1
    if "--dispatch-chunks" in argv:
        raise SystemExit(
            "bench.py: --dispatch-chunks batches several dispatches under one "
            "compiled scan to probe a TPU host-dispatch gap; the port runs "
            "eagerly and has no such dispatch to batch")


def _value(argv, flag, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def _eager(argv) -> bool:
    return "--xla" in argv or "--eager" in argv


def build_cfg(argv, model=None):
    """Bench config from ablation flags.  Deliberately NOT routed through
    serving.apply_serving_mode: bench is the ablation surface, so every piece
    of the serving recipe stays individually switchable (--no-int8-attn,
    --int8-dynamic, --gelu-exact, ...), but with NO ablation flag the result
    equals the product serving config, ``serving.serving_config(base,
    "int8")``.  Returns (cfg, use_int8); int8 is the default, --bf16 / --f32
    opt out."""
    from vision_transformer_cam_tpu_torch import configs

    _check_flags(argv)
    if model is None:
        model = _value(argv, "--model", DEFAULT_MODEL)
    # bf16 is the serving dtype; --f32 measures the parity dtype
    dtype = torch.float32 if "--f32" in argv else torch.bfloat16
    cfg = configs.resolve_model(model)(num_classes=20)
    cfg = cfg.replace(representation_size=None,
                      dtype=dtype, param_dtype=dtype)
    # the fused attention kernel unless --eager
    if not _eager(argv):
        cfg = cfg.replace(attn_impl="kernel")
    # serving mask-norm semantics (mirrors serving_config);
    # --batch-global-mask reproduces the coupled graph for A/B
    if "--f32" not in argv and "--batch-global-mask" not in argv:
        cfg = cfg.replace(per_sample_mask_norm=True)
    if "--gelu-exact" not in argv:
        cfg = cfg.replace(gelu_approx=True)
    if "--stable-softmax" not in argv:
        cfg = cfg.replace(softmax_clamp=True)
    if "--mlp-fusion" in argv:
        cfg = cfg.replace(mlp_fusion=True)
    if "--int8-fused" in argv:
        cfg = cfg.replace(int8_fused_gemm=True)
    if "--rollout-post" in argv:
        cfg = cfg.replace(rollout_post=True)
    if "--rollout-carry" in argv:
        # force the joint carry (auto picks rollout_post at N > 512)
        cfg = cfg.replace(rollout_post=False)
    if "--ln-quant" in argv:
        cfg = cfg.replace(ln_quant_fusion=True)
    if "--block-b" in argv:
        cfg = cfg.replace(attn_block_b=int(_value(argv, "--block-b")))
    if "--q-block" in argv:
        # query rows per attention-kernel block (0 = auto)
        cfg = cfg.replace(attn_q_block=int(_value(argv, "--q-block")))
    if "--precision" in argv:
        cfg = cfg.replace(matmul_precision=_value(argv, "--precision"))
    use_int8 = ("--int8" in argv or "--int8-hifi" in argv
                or not ("--bf16" in argv or "--f32" in argv))
    # --int8-hifi == serving mode "int8_hifi".  --no-int8-attn stays a pure
    # ablation flag: int8 GEMMs with the attention kernel fully float and the
    # proj input quantized outside the kernel.
    hifi = "--int8-hifi" in argv or "--no-int8-attn" in argv
    if use_int8 and not hifi:
        # as serving.serving_config: past 640 tokens the "int8" tier routes
        # attention through the output-only int8 kernel
        if cfg.seq_len > 640:
            cfg = cfg.replace(int8_attn_out=True)
        else:
            cfg = cfg.replace(int8_attn_io=True)
    elif "--int8-hifi" in argv:
        cfg = cfg.replace(int8_attn_out=True)
    if "--int8-attn" in argv:
        cfg = cfg.replace(int8_attn_io=True)
    return cfg, use_int8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _emit(metric, value, unit, device):
    from vision_transformer_cam_tpu_torch.utils.profiling import card_line
    if device.type != "cuda":
        # a dry run on the CPU is no device metric, and its unit says so
        unit = unit.replace("/gpu", "/cpu").replace("(device,", "(cpu,")
    line = {"metric": metric, "value": value, "unit": unit,
            "device": card_line(device)}
    print(json.dumps(line), flush=True)
    return line


def _inputs(batch, size, device):
    images = torch.randn((batch, size, size, 3),
                         generator=torch.Generator().manual_seed(1))
    labels = (torch.rand((batch, 20),
                         generator=torch.Generator().manual_seed(2))
              < 0.15).to(torch.float32)
    return images.to(device), labels.to(device)


def bench_train(argv, batch, dtype, device, *, chunk=5, iters=3):
    """Fine-tune step throughput.

    --accum N: gradient accumulation (train_step_accum), N microbatches of
    batch / N and one optimizer update; throughput counts the FULL batch.
    --model <zoo name>: any zoo config (default the flagship ViT-B/16-21k).
    --mixed: float32 master weights and AdamW state with bf16 compute; plain
    --train keeps parameters in the compute dtype."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    from vision_transformer_cam_tpu_torch.train.step import (train_step,
                                                             train_step_accum)

    accum = int(_value(argv, "--accum", 1))
    if "--model" in argv:
        name = _value(argv, "--model")
        cfg = configs.resolve_model(name)(num_classes=20)
        if cfg.representation_size:
            cfg = cfg.replace(representation_size=None)
        metric_model = name
    else:
        cfg = configs.vit_base_patch16_224_in21k(num_classes=20,
                                                 has_logits=False)
        metric_model = "vit_b16"
    mixed = "--mixed" in argv
    cfg = cfg.replace(dtype=dtype,
                      param_dtype=torch.float32 if mixed else dtype)
    if not _eager(argv):
        cfg = cfg.replace(attn_impl="kernel")
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(model, configs.OptimConfig(), batch, 100)
    state = create_train_state(model, opt)
    images, labels = _inputs(batch, cfg.img_size, device)
    rng = 3

    def step(st):
        if accum > 1:
            return train_step_accum(st, images, labels, rng,
                                    accum_steps=accum)
        return train_step(st, images, labels, rng)

    for _ in range(2):
        state, m = step(state)
        float(m["loss"])
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(chunk):
            state, m = step(state)
        float(m["loss"])          # waits for the card
        best = min(best, (time.perf_counter() - t0) / chunk)
    return _emit(f"torch_{metric_model}_train_step_throughput"
                 + ("_mixed" if mixed else "")
                 + (f"_accum{accum}" if accum > 1 else ""),
                 round(batch / best, 1), "images/sec/gpu", device)


def main(argv=None, *, chunk=None, iters=None):
    """One run, one JSON line (returned as a dict too).  ``argv`` without the
    program name; ``chunk`` forwards (or steps) per timed window and ``iters``
    windows, so that a test can pass small ones: by default (10, 3) for
    throughput, (10, 15) with --latency and (5, 3) with --train."""
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops import rollout
    from vision_transformer_cam_tpu_torch.utils import resolve_device

    argv = ["bench.py"] + list(sys.argv[1:] if argv is None else argv)
    _check_flags(argv)
    device = resolve_device(_value(argv, "--device"))
    batch = int(_value(argv, "--batch", 512))
    dtype = torch.float32 if "--f32" in argv else torch.bfloat16

    if "--train" in argv:
        return bench_train(argv, batch, dtype, device, chunk=chunk or 5,
                           iters=iters or 3)

    model_name = _value(argv, "--model", DEFAULT_MODEL)
    cfg, use_int8 = build_cfg(argv, model_name)
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    if use_int8:
        from vision_transformer_cam_tpu_torch.ops.quant import (
            calibrate_act_scales, quantize_params)
        scales = None
        if "--int8-dynamic" not in argv:
            calib = torch.randn((8, cfg.img_size, cfg.img_size, 3),
                                generator=torch.Generator().manual_seed(7))
            scales = calibrate_act_scales(model, cfg, calib.to(device))
        quantize_params(model, act_scales=scales)

    with_cam = "--no-cam" not in argv
    latency = "--latency" in argv
    if latency:
        batch = 1
    images, _ = _inputs(batch, cfg.img_size, device)

    def cam_extract():
        # --no-cam: the batched multi-label inference path without the CAM
        out = model(images, need_rollout=with_cam)
        if not with_cam:
            return out.logits, out.head1_logits, torch.sigmoid(
                out.head1_logits)
        cam = rollout.cam_from_rollout_row(out.rollout_row, cfg.grid_size)
        return out.logits, out.head1_logits, cam

    # warm-up (the kernels' build and first launches)
    for _ in range(2):
        cam_extract()
        _sync(device)

    # CHUNK forwards per timing window, closed by one wait for the card, so
    # the wait's own cost amortizes out.  --latency: batch 1, the p50 of the
    # windows' means as the per-image latency of a serving loop.
    chunk, iters = chunk or 10, iters or (15 if latency else 3)
    windows = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(chunk):
            cam_extract()
        _sync(device)
        windows.append((time.perf_counter() - t0) / chunk)

    kind = "cam_extraction" if with_cam else "multilabel_inference"
    stem = "vit_b16" if model_name == DEFAULT_MODEL else model_name
    if latency:
        p50 = sorted(windows)[len(windows) // 2] * 1e3
        return _emit(f"torch_{stem}_{kind}_p50_latency", round(p50, 3),
                     "ms/image (device, batch 1)", device)
    return _emit(f"torch_{stem}_{kind}_throughput",
                 round(batch / min(windows), 1), "images/sec/gpu", device)


if __name__ == "__main__":
    main()
