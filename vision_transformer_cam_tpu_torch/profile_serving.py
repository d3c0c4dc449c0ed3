"""Device time of the rollout-CAM forward, by kernel group, on one CUDA GPU.

    python -m vision_transformer_cam_tpu_torch.profile_serving \
        [--batch 256] [--forwards 3] [--modes bf16 eager int8 int8_hifi] \
        [--model vit_base] [--seq-parallel 1] \
        [--mlp-fusion] [--attn-block-fusion] [--out FILE]

Serves ``--model`` (default ViT-B/16 in21k; any zoo name, for example
``vit_large_patch16_384``; the VOC head: 20 classes, no representation layer)
with random weights from seed 0, as ``chip_smoke.py`` does: "bf16" through
the attention kernel, "eager" the same bf16 model with ``attn_impl="eager"``,
"int8" and "int8_hifi" calibrated on 16 numpy images from seed 1 with
``ln_quant_fusion`` and ``int8_fused_gemm`` on.  ``--mlp-fusion`` and
``--attn-block-fusion`` turn the serving fusions on in every serving mode
(``cfg.mlp_fusion``: the fused MLP kernels; ``cfg.attn_block_fusion``: the
whole-sub-block attention kernel, which a quantized qkv layer falls
through).  ``--seq-parallel 1`` serves through the sequence-parallel
forward on a mesh of this one rank (``parallel.apply_seq_parallel``: the
"seq" attention kernel, no fusions, no int8 attention I/O).  The modes
"train" and
"train_eager" profile one training step of ``--model`` instead
(``--train_batch`` images, float32 masters with bf16 compute, remat on) on
the kernel and the eager attention path.  It prints the card's name
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
import sys
import time

import numpy as np
import torch

# kernel groups, first match of a substring of the kernel's name
GROUPS = (
    # the cluster design's kernels, then the streamed design's two launches
    ("attention block kernel", ("attention_block_kernel",
                                "attention_block_tc_kernel",
                                "attention_block_streamed_",
                                "block_kv_kernel")),
    ("fused MLP kernel", ("mlp_wgmma_kernel", "mlp_fused_kernel",
                          "mlp_fused_int8_kernel")),
    ("sequence-parallel attention kernel", ("masked_attention_seq_kernel",
                                            "masked_attention_seq_tc_kernel")),
    ("attention kernel", ("masked_attention_kernel",
                          "masked_attention_tc_kernel")),
    ("attention backward kernel", ("masked_attention_bwd_",)),
    ("int8 GEMM kernel", ("linear_int8_kernel", "linear_int8_tc_kernel")),
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


def served_models(modes, device=None, model_name="vit_base"):
    """{mode: model} for the requested modes; "bf16" and "eager" share one
    model and differ in ``cfg.attn_impl``, set by ``forward_fn``."""
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    cfg = configs.resolve_model(model_name)(num_classes=20).replace(
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


def forward_fn(model, mode, x, mlp_fusion=False, attn_block_fusion=False,
               seq_parallel=0):
    """One served request: the forward with the rollout CAM."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    impl = "eager" if mode == "eager" else "kernel"
    cfg = model.cfg.replace(attn_impl=impl, mlp_fusion=mlp_fusion,
                            attn_block_fusion=attn_block_fusion)
    mesh = None
    if seq_parallel:
        cfg = pmesh.apply_seq_parallel(cfg)
        mesh = pmesh.seq_parallel_mesh(seq_parallel)
    g = cfg.grid_size

    def step():
        model.cfg = cfg
        with pmesh.set_mesh(mesh):
            cam_from_rollout_row(model(x, need_rollout=True).rollout_row, g)
    return step


def train_step_fn(batch: int, impl: str, device=None, model_name="vit_base"):
    """One training step of ``model_name`` (mixed precision: float32
    masters, bf16 compute; remat on; the VOC head, no representation layer;
    weights from seed 0 and a seeded batch) on the ``impl`` attention path,
    for ``profile_mode``."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.train import state as statelib
    from vision_transformer_cam_tpu_torch.train.step import train_step
    from vision_transformer_cam_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    cfg = configs.resolve_model(model_name)(num_classes=20).replace(
        representation_size=None, dtype=torch.bfloat16, attn_impl=impl)
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    opt, _ = statelib.make_optimizer(model, configs.OptimConfig(), batch, 1)
    holder = [statelib.create_train_state(model, opt)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.img_size, cfg.img_size, 3), dtype=np.float32)).to(device)
    y = torch.from_numpy((rng.random((batch, cfg.num_classes)) < 0.1)
                         .astype(np.float32)).to(device)

    def step():
        holder[0], _ = train_step(holder[0], x, y)
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
                    choices=["bf16", "eager", "int8", "int8_hifi", "train",
                             "train_eager"],
                    help="serving modes (a forward at --batch), or train / "
                         "train_eager: one training step at --train_batch "
                         "on the kernel / eager attention path")
    ap.add_argument("--mlp-fusion", action="store_true",
                    help="serve with cfg.mlp_fusion (the fused MLP kernels)")
    ap.add_argument("--attn-block-fusion", action="store_true",
                    help="serve with cfg.attn_block_fusion (the "
                         "whole-sub-block attention kernel)")
    ap.add_argument("--model", default="vit_base",
                    help="zoo name of the served (or, train modes, "
                         "trained) model")
    ap.add_argument("--seq-parallel", type=int, default=0, choices=[0, 1],
                    help="1: serve through the sequence-parallel forward on "
                         "a mesh of this one rank")
    ap.add_argument("--train_batch", type=int, default=64)
    ap.add_argument("--out", help="file for the full key_averages tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    from vision_transformer_cam_tpu_torch.utils.profiling import card_line
    card = card_line()
    print(card, flush=True)
    models = served_models([m for m in args.modes
                            if not m.startswith("train")],
                           model_name=args.model)
    size = next(iter(models.values())).cfg.img_size if models else 224
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, size, size, 3), dtype=np.float32)).cuda()
    result, tables = {}, []
    for mode in args.modes:
        step = train_step_fn(
            args.train_batch, "eager" if mode == "train_eager" else "kernel",
            model_name=args.model) \
            if mode.startswith("train") else forward_fn(
                models[mode], mode, x, args.mlp_fusion,
                args.attn_block_fusion, args.seq_parallel)
        wall, groups, table = profile_mode(step, args.forwards)
        busy = sum(ms for ms, _ in groups.values())
        batch = args.train_batch if mode.startswith("train") else args.batch
        print(f"== {mode}, batch {batch}: wall {wall:.2f} ms per forward, "
              f"device {busy:.2f} ms ({busy / wall:.1%} busy)", flush=True)
        for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"   {group:42s} {ms:9.3f} ms {n:7.1f} launches "
                  f"{ms / busy:6.1%}", flush=True)
        result[mode] = {"batch": batch, "wall_ms": wall, "device_ms": busy,
                        "groups": {g: {"ms": ms, "launches": n}
                                   for g, (ms, n) in groups.items()}}
        tables.append(f"== {mode}\n{table}\n")
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(tables)
    print(json.dumps({"forwards": args.forwards, "card": card,
                      "model": args.model, "seq_parallel": args.seq_parallel,
                      "mlp_fusion": args.mlp_fusion,
                      "attn_block_fusion": args.attn_block_fusion,
                      "modes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
