#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs a CUDA GPU and nvcc

Phases (any failure raises, and the exit code is non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. builds the hand-written CUDA kernels from this checkout;
  3. holds the attention kernel against its plain PyTorch version on the card
     (ViT-B shapes and a ragged N=37; bf16 and float32; plain, head-mean and
     rollout variants; clamp on and off) and times both at ViT-B shapes;
  4. the main path: ViT-B/16 with random weights from a seed, put through
     serving mode "bf16", answers 3 requests of 32 images with the rollout
     CAM; the kernel's launch count must show one launch per layer; the CAM
     is compared with the same model on the eager attention path, and both
     paths are timed at batch 256.
It prints one JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "vision_transformer_cam_tpu_torch/kernels/csrc/masked_attention.cu"
KERNEL_REPLACES = "vision_transformer_cam_tpu/kernels/attention.py:133"
VARIANTS = ("plain", "headmean", "rollout")
# kernel vs plain version on the same card inputs: |a - b| <= atol + rtol*|b|,
# by output kind.  float32: the two sum in different orders, and the hot query
# rows (logits past the clamp at 80) carry the f32 rounding of logits ~1e2
# into exp, hence the rtol.  bf16: both round P and the outputs to bf16;
# rtol is 2 bf16 ulps (2^-6).  The rollout joint is float32 in both modes.
TOL = {(torch.float32, "out"): (5e-5, 1e-4),
       (torch.float32, "prob"): (1e-6, 1e-4),
       (torch.bfloat16, "out"): (1e-2, 2 ** -6),
       (torch.bfloat16, "prob"): (1e-5, 2 ** -6)}
TOL_JOINT = (1e-6, 1e-4)


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    from vision_transformer_cam_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    log = (_build.lib_path().parent / "build.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    say(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0:.1f} s), {len(regs)} entry points, "
        f"registers max {max(regs, default=0)}, spill stores max "
        f"{max(spills, default=0)} bytes; {_build.lib_path()}")


def attention_inputs(b, n, heads, dtype, seed):
    """Packed qkv with random bg (cls column 0), hot query rows 1-3 whose
    logits pass the clamp at 80, and a row-stochastic float32 joint."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * 64
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    return qkv.to(dtype).contiguous(), bg.to(dtype), joint


def _call(fn, variant, qkv, bg, joint, heads, clamp):
    kw = dict(num_heads=heads, scale=64 ** -0.5, clamp_softmax=clamp)
    if variant == "rollout":
        return fn(qkv, bg, joint, **kw)
    return fn(qkv, bg, with_headmean=variant == "headmean", **kw)


def check_kernels():
    """Kernel vs plain version on the card; returns {(dtype, variant, clamp,
    n): max abs error} for the ViT-B and ragged shapes."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    for (b, n) in ((8, 197), (3, 37)):
        for dtype in (torch.bfloat16, torch.float32):
            qkv, bg, joint = attention_inputs(b, n, 12, dtype, seed=n)
            for variant in VARIANTS:
                for clamp in (False, True):
                    got = _call(ka.masked_attention_fused, variant, qkv, bg,
                                joint, 12, clamp)
                    want = _call(ka.masked_attention_fused_ref, variant, qkv,
                                 bg, joint, 12, clamp)
                    torch.cuda.synchronize()
                    case = f"{str(dtype):14s} {variant:8s} clamp={clamp!s:5s} " \
                           f"B={b} N={n}"
                    worst, msg = 0.0, []
                    for name, g_, w_ in zip(("out", "cls", "third"), got, want):
                        atol, rtol = TOL_JOINT if (
                            name == "third" and variant == "rollout") \
                            else TOL[(dtype, "out" if name == "out" else "prob")]
                        g_, w_ = g_.float(), w_.float()
                        err = (g_ - w_).abs()
                        worst = max(worst, float(err.max()))
                        excess = float((err - atol - rtol * w_.abs()).max())
                        msg.append(f"{name} {float(err.max()):.2e}")
                        if not torch.isfinite(g_).all() or excess > 0:
                            failures.append(f"{case} {name}: max abs err "
                                            f"{float(err.max()):.3e} (atol "
                                            f"{atol}, rtol {rtol:.3g})")
                    errs[(dtype, variant, clamp, n)] = worst
                    say(f"check {case}: max abs err " + ", ".join(msg))
    if failures:
        raise AssertionError("kernel != plain version:\n" + "\n".join(failures))
    return errs


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(b=64, n=197):
    """Kernel and plain version at ViT-B shapes, in turns (plain, kernel,
    kernel, plain); bf16 with the serving clamp, float32 without."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    times = {}
    for dtype, clamp in ((torch.bfloat16, True), (torch.float32, False)):
        qkv, bg, joint = attention_inputs(b, n, 12, dtype, seed=1)
        for variant in VARIANTS:
            def kern():
                _call(ka.masked_attention_fused, variant, qkv, bg, joint, 12,
                      clamp)

            def plain():
                _call(ka.masked_attention_fused_ref, variant, qkv, bg, joint,
                      12, clamp)
            p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                              time_ms(plain))
            times[(dtype, variant)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            say(f"time {str(dtype):15s} {variant:8s} B={b} N={n}: kernel "
                f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms")
    return times


def main_path(batch=32, requests=3, bench_batch=256):
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)

    cfg = configs.vit_base_patch16_224_in21k(num_classes=20).replace(
        representation_size=None)
    model = ViTCAM(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, 3), dtype=np.float32)).cuda()

    # float32, small batch: the kernel path against the eager path at the
    # CPU tests' tolerances (rollout row 1e-5, logits 2e-4)
    x = images(4)
    model.cfg = cfg.replace(attn_impl="kernel")
    got = model(x, need_rollout=True)
    model.cfg = cfg
    want = model(x, need_rollout=True)
    d_roll = float((got.rollout_row - want.rollout_row).abs().max())
    d_logit = float((got.logits - want.logits).abs().max())
    say(f"f32 kernel vs eager (B=4): rollout row {d_roll:.3e} (tol 1e-5), "
        f"logits {d_logit:.3e} (tol 2e-4)")
    if not (d_roll <= 1e-5 and d_logit <= 2e-4):
        raise AssertionError("f32 kernel path disagrees with the eager path")

    serving.apply_serving_mode(model, "bf16")
    kcfg = model.cfg
    reqs = [images(batch) for _ in range(requests)]
    # the main path: count the kernel's launches over exactly these requests
    ka.launches = 0
    outs = []
    t0 = time.perf_counter()
    for x in reqs:
        before = ka.launches
        out = model(x, need_rollout=True)
        if ka.launches - before != cfg.depth:
            raise AssertionError(f"{ka.launches - before} kernel launches in "
                                 f"one forward, expected {cfg.depth}")
        outs.append((out, cam_from_rollout_row(out.rollout_row,
                                               cfg.grid_size)))
    torch.cuda.synchronize()
    launches = ka.launches
    say(f"main path: {requests} requests x {batch} images in "
        f"{time.perf_counter() - t0:.3f} s (first includes warm-up), "
        f"{launches} kernel launches (expected {requests * cfg.depth}: one "
        "rollout-variant launch per layer)")
    if launches != requests * cfg.depth:
        raise AssertionError("the main path did not run the kernel in every "
                             "layer")
    g = cfg.grid_size
    for out, cam in outs:
        if tuple(cam.shape) != (batch, g, g) or not torch.isfinite(cam).all():
            raise AssertionError(f"CAM {tuple(cam.shape)} not finite "
                                 f"[{batch},{g},{g}]")
        if not torch.all(cam.amax(dim=(1, 2)) == 1.0):
            raise AssertionError("CAM max is not 1.0 for every image")
        if not torch.isfinite(out.logits.float()).all():
            raise AssertionError("logits not finite")

    # the same model on the eager attention path
    model.cfg = kcfg.replace(attn_impl="eager")
    d_cam = d_logit = 0.0
    overlap = []
    for x, (out, cam) in zip(reqs, outs):
        ref = model(x, need_rollout=True)
        ref_cam = cam_from_rollout_row(ref.rollout_row, g)
        d_cam = max(d_cam, float((cam - ref_cam).abs().max()))
        d_logit = max(d_logit, float(
            (out.logits.float() - ref.logits.float()).abs().max()))
        for a, b_ in zip(out.top_patch_idx.tolist(),
                         ref.top_patch_idx.tolist()):
            overlap.append(len(set(a) & set(b_)) / len(a))
    say(f"bf16 kernel vs eager: CAM max abs dev {d_cam:.3e} (tol 5e-2), "
        f"logits max abs dev {d_logit:.3e} (tol 5e-2), top-16 overlap "
        f"{np.mean(overlap):.4f}")
    if not (d_cam <= 5e-2 and d_logit <= 5e-2):
        raise AssertionError("bf16 kernel path disagrees with the eager path")

    # throughput at batch 256, in turns (eager, kernel, kernel, eager)
    xb = images(bench_batch)

    def rate(impl, iters=5):
        model.cfg = kcfg.replace(attn_impl=impl)
        for _ in range(2):
            cam_from_rollout_row(model(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            cam_from_rollout_row(model(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        return bench_batch * iters / (time.perf_counter() - t)
    e1, k1, k2, e2 = rate("eager"), rate("kernel"), rate("kernel"), rate("eager")
    say(f"bf16 CAM throughput, batch {bench_batch}: kernel "
        f"{(k1 + k2) / 2:.1f} img/s ({k1:.1f}, {k2:.1f}), eager "
        f"{(e1 + e2) / 2:.1f} img/s ({e1:.1f}, {e2:.1f})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    sys.path.insert(0, REPO)
    # float32 paths run in full float32: no TF32 in GEMMs or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    errs = check_kernels()
    times = time_kernels()
    launches = main_path()
    main_err = errs[(torch.bfloat16, "rollout", True, 197)]
    k_ms, p_ms = times[(torch.bfloat16, "rollout")]
    say(json.dumps({"kernels": [{
        "name": "masked_attention_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": main_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
