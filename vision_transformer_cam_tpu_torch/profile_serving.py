"""Device time of the rollout-CAM forward, by kernel group, on one CUDA GPU.

    python -m vision_transformer_cam_tpu_torch.profile_serving \
        [--batch 256] [--forwards 3] [--modes bf16 eager int8 int8_hifi] \
        [--out FILE]

Serves ViT-B/16 (in21k, the VOC head: 20 classes, no representation layer)
with random weights from seed 0, as ``chip_smoke.py`` does: "bf16" through
the attention kernel, "eager" the same bf16 model with ``attn_impl="eager"``,
"int8" and "int8_hifi" calibrated on 16 numpy images from seed 1 with
``ln_quant_fusion`` and ``int8_fused_gemm`` on.  It prints the card's name
and power limit (nvidia-smi), then for each mode the
wall time per forward (host clock around synchronised forwards, after two
warm-up forwards), then the device time per forward of each kernel group
under torch.profiler, the number of launches per forward, and the device's
busy share (device time / wall time).  The last line is one JSON object of
those numbers.  ``--out`` writes each mode's full key_averages table there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# kernel groups, first match of a substring of the kernel's name
GROUPS = (
    ("attention kernel", ("masked_attention_kernel",)),
    ("int8 GEMM kernel", ("linear_int8_kernel",)),
    ("ln_quant kernel", ("ln_quant_kernel",)),
    ("float GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
    ("softmax", ("softmax",)),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu",)),
)
OTHER = "other (elementwise, copies, reductions)"


def group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return OTHER


def served_models(modes, device="cuda"):
    """{mode: model} for the requested modes; "bf16" and "eager" share one
    model and differ in ``cfg.attn_impl``, set by ``forward_fn``."""
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM

    cfg = configs.vit_base_patch16_224_in21k(num_classes=20).replace(
        representation_size=None)

    def new_model():
        return ViTCAM(cfg, device=device,
                      generator=torch.Generator().manual_seed(0))

    models = {}
    if {"bf16", "eager"} & set(modes):
        bf16 = serving.apply_serving_mode(new_model(), "bf16")
        models.update({m: bf16 for m in ("bf16", "eager") if m in modes})
    calib = np.random.default_rng(1).standard_normal(
        (16, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
    for mode in ("int8", "int8_hifi"):
        if mode in modes:
            m = serving.apply_serving_mode(new_model(), mode,
                                           calib_images=calib)
            m.cfg = m.cfg.replace(ln_quant_fusion=True, int8_fused_gemm=True)
            models[mode] = m
    return models


def forward_fn(model, mode, x):
    """One served request: the forward with the rollout CAM."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    impl = "eager" if mode == "eager" else "kernel"
    cfg = model.cfg.replace(attn_impl=impl)
    g = cfg.grid_size

    def step():
        model.cfg = cfg
        cam_from_rollout_row(model(x, need_rollout=True).rollout_row, g)
    return step


def profile_mode(step, forwards: int):
    """(wall ms per forward, {group: (device ms, launches) per forward},
    key_averages table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(forwards):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / forwards
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            step()
        torch.cuda.synchronize()
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms, n = groups.get(group_of(evt.key), (0.0, 0))
        groups[group_of(evt.key)] = (
            ms + evt.self_device_time_total / 1e3 / forwards,
            n + evt.count / forwards)
    if not groups:
        raise RuntimeError("the profiler recorded no device time")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    return wall, groups, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--forwards", type=int, default=3)
    ap.add_argument("--modes", nargs="+",
                    default=["bf16", "eager", "int8", "int8_hifi"],
                    choices=["bf16", "eager", "int8", "int8_hifi"])
    ap.add_argument("--out", help="file for the full key_averages tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    models = served_models(args.modes)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 224, 224, 3), dtype=np.float32)).cuda()
    result, tables = {}, []
    for mode in args.modes:
        wall, groups, table = profile_mode(
            forward_fn(models[mode], mode, x), args.forwards)
        busy = sum(ms for ms, _ in groups.values())
        print(f"== {mode}, batch {args.batch}: wall {wall:.2f} ms per forward, "
              f"device {busy:.2f} ms ({busy / wall:.1%} busy)", flush=True)
        for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"   {group:42s} {ms:9.3f} ms {n:7.1f} launches "
                  f"{ms / busy:6.1%}", flush=True)
        result[mode] = {"wall_ms": wall, "device_ms": busy,
                        "groups": {g: {"ms": ms, "launches": n}
                                   for g, (ms, n) in groups.items()}}
        tables.append(f"== {mode}\n{table}\n")
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(tables)
    print(json.dumps({"batch": args.batch, "forwards": args.forwards,
                      "card": card, "modes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
