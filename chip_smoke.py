#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root; needs a CUDA GPU and nvcc

Phases (any failure raises, and the exit code is non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. builds the hand-written CUDA kernels from this checkout (one nvcc per
     source, in parallel) and JIT-compiles the Triton ln_quant kernel;
  3. holds every kernel against its plain PyTorch version on the card:
     the attention kernel (bf16 and float32; int8_io with per-head and
     per-tensor scales; int8_out; plain, head-mean and rollout variants;
     clamp on and off; ViT-B B=8 N=197 and a ragged B=3 N=37), the int8 GEMM
     (each prologue and epilogue at the five ViT-B GEMM shapes, M = 8*197,
     and a ragged M=111 K=200 N=72) and ln_quant; then times each kernel
     against its plain version at B=64;
  4. the main path: ViT-B/16 with random weights from a seed answers 3
     requests of 32 images with the rollout CAM in serving mode "bf16",
     then, calibrated on 16 seeded images, in "int8" and "int8_hifi" with
     ln_quant_fusion and int8_fused_gemm on.  Every launch count is set to 0
     before each path and read after it: one attention launch per layer,
     49 int8 GEMM launches and 24 (int8) / 12 (int8_hifi) ln_quant launches
     per forward.  The bf16 path is compared with the eager path, each int8
     path with the same quantized model on the CPU (the plain versions) on
     five seeded batches of 4 and 8 images; int8 CAMs against the bf16 ones
     are recorded; bf16, bf16 eager, int8 and int8_hifi are timed at batch
     256, in turns.
It prints one JSON line describing the kernels, the card line, and as its
last line {"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "vision_transformer_cam_tpu_torch/kernels/csrc/"
KERNELS = {   # name: (route, source, TPU kernel replaced)
    "masked_attention_fused": (
        "cuda", CSRC + "masked_attention.cu",
        "vision_transformer_cam_tpu/kernels/attention.py:133"),
    "linear_int8_fused": (
        "cuda", CSRC + "int8_gemm.cu",
        "vision_transformer_cam_tpu/kernels/gemm.py:232"),
    "ln_quant": (
        "triton", "vision_transformer_cam_tpu_torch/kernels/gemm.py",
        "vision_transformer_cam_tpu/kernels/gemm.py:167"),
}
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
# int8 outputs: the two round the same float value after sums in another
# order, so a value next to a .5 boundary may round the other way: at most
# one step, on at most 0.1 % of the elements
I8_STEP, I8_FRAC = 1, 1e-3
# the five GEMMs of a ViT-B/16 forward, (K, N)
GEMM_SHAPES = {"patch": (768, 768), "qkv": (768, 2304), "proj": (768, 768),
               "fc1": (768, 3072), "fc2": (3072, 768)}
# whole int8 path, card (kernels) vs the same model on the CPU (plain
# versions), B=4.  The kernels agree with their plain versions (above), but
# bf16 rounds at other places in the two devices' own ops (LayerNorm, the
# residual adds, the float heads), and where that moves a value across a .5
# boundary its int8 quantization moves by a whole step.  With random
# weights the cls token is small and the final LayerNorm magnifies such
# steps into the logits: two int8 routes of the same model (ln_quant and
# the fused GEMM on against off) differ by 4.3e-2 on logits of magnitude
# 0.7 (ViT-B/16, seed 0, on the CPU).  On an NVIDIA H100 80GB HBM3 (700 W),
# over WHOLE_CASES and one more batch of 4 images in both int8 modes (12
# cases), card against CPU read 4.0e-2 to 6.0e-2 on the logits and 5.9e-5 to
# 1.2e-4 on the CAM.  So the logits are held to 1e-1, and the CAM, built
# from the attention rows and far less sensitive, to 1e-3: about 8x its
# worst reading, tight enough that a wrongly scaled or rounded int8 route
# fails it.
WHOLE_TOL = {"cam": 1e-3, "logits": 1e-1}
# (batch, numpy seed of the images) of the whole-path check
WHOLE_CASES = ((4, 11), (4, 12), (4, 13), (8, 14), (8, 15))


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    from vision_transformer_cam_tpu_torch.kernels import _build, gemm
    t0 = time.perf_counter()
    _build.load()
    log = (_build.lib_path().parent / "build.log").read_text()
    for part in re.split(r"^== ", log, flags=re.M)[1:]:
        name, _, body = part.partition("\n")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", body)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", body)]
        if regs:
            say(f"build {name}: {len(regs)} entry points, registers max "
                f"{max(regs)}, spill stores max {max(spills, default=0)} bytes")
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc, parallel, "
        f"{_build.build_seconds or 0:.1f} s); {_build.lib_path()}")
    t0 = time.perf_counter()
    x = torch.randn((4, 768), device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda")
    gemm.ln_quant(x, w, w, eps=1e-6,
                  inv_a=torch.ones((), device="cuda"))
    torch.cuda.synchronize()
    say(f"build ln_quant (Triton JIT): {time.perf_counter() - t0:.1f} s")


def attention_inputs(b, n, heads, dtype, seed):
    """Packed qkv with random bg (cls column 0), hot query rows 1-3 whose
    logits pass the clamp at 80, and a row-stochastic float32 joint.  For
    int8 qkv: integers in [-127, 127] and per-head scales, head 0's q scale
    large enough for the clamp."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * 64
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    if dtype == torch.int8:
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g,
                            device="cuda", dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand((3 * heads,), generator=g,
                                      device="cuda")
        sc[0] = 0.3
        return qkv, bg, joint, sc
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    return qkv.to(dtype).contiguous(), bg.to(dtype), joint, None


def _call(fn, variant, qkv, bg, joint, heads, clamp, scales=None,
          float_dtype=torch.bfloat16):
    kw = dict(num_heads=heads, scale=64 ** -0.5, clamp_softmax=clamp,
              float_dtype=float_dtype)
    j = joint if variant == "rollout" else None
    return fn(qkv, bg, j, scales, with_headmean=variant == "headmean", **kw)


def int8_excess(got, want):
    """(max step, share of elements that differ) of two int8 tensors, and
    whether they are within one step on at most 0.1 %."""
    d = (got.int() - want.int()).abs()
    step, frac = int(d.max()), float((d > 0).float().mean())
    return step, frac, step <= I8_STEP and frac <= I8_FRAC


def _compare(case, got, want, tols, failures):
    """Compare output tuples; tols: one (atol, rtol) per output or None for
    an int8 output.  Returns the worst absolute error."""
    worst, msg = 0.0, []
    for name, g_, w_, tol in zip(("out", "cls", "third"), got, want, tols):
        if tol is None:
            step, frac, ok = int8_excess(g_, w_)
            worst = max(worst, float(step))
            msg.append(f"{name} {step} step on {frac:.2e}")
            if not ok:
                failures.append(f"{case} {name}: int8 off by {step} on "
                                f"{frac:.2e} of the elements")
            continue
        atol, rtol = tol
        g_, w_ = g_.float(), w_.float()
        err = (g_ - w_).abs()
        worst = max(worst, float(err.max()))
        excess = float((err - atol - rtol * w_.abs()).max())
        msg.append(f"{name} {float(err.max()):.2e}")
        if not torch.isfinite(g_).all() or excess > 0:
            failures.append(f"{case} {name}: max abs err {float(err.max()):.3e}"
                            f" (atol {atol}, rtol {rtol:.3g})")
    say(f"check {case}: max abs err " + ", ".join(msg))
    return worst


def check_attention():
    """Attention kernel vs plain version on the card; returns {(kind,
    variant, clamp, n): worst error} (int8 outputs count in steps)."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    errs, failures = {}, []
    for (b, n) in ((8, 197), (3, 37)):
        kinds = [(dt, None) for dt in (torch.bfloat16, torch.float32)] + \
            [(torch.int8, "per_head"), (torch.int8, "per_tensor"),
             (torch.bfloat16, "int8_out")]
        for dtype, opt in kinds:
            qkv, bg, joint, sc = attention_inputs(b, n, 12, dtype, seed=n)
            scales = None
            if opt == "per_head":
                scales = torch.cat([sc, torch.tensor([20.0], device="cuda")])
            elif opt == "per_tensor":
                scales = torch.tensor([0.3, 0.02, 0.02, 20.0], device="cuda")
            elif opt == "int8_out":
                scales = torch.tensor([20.0], device="cuda")
            fdt = torch.bfloat16 if dtype == torch.int8 else dtype
            for variant in VARIANTS:
                for clamp in (False, True):
                    got = _call(ka.masked_attention_fused, variant, qkv, bg,
                                joint, 12, clamp, scales)
                    want = _call(ka.masked_attention_fused_ref, variant, qkv,
                                 bg, joint, 12, clamp, scales)
                    torch.cuda.synchronize()
                    kind = opt or str(dtype).split(".")[-1]
                    case = f"attention {kind:10s} {variant:8s} " \
                           f"clamp={clamp!s:5s} B={b} N={n}"
                    tols = [None if scales is not None else TOL[(fdt, "out")],
                            TOL[(fdt, "prob")],
                            TOL_JOINT if variant == "rollout"
                            else TOL[(fdt, "prob")]]
                    errs[(kind, variant, clamp, n)] = _compare(
                        case, got, want, tols, failures)
    if failures:
        raise AssertionError("attention kernel != plain version:\n"
                             + "\n".join(failures))
    return errs


def gemm_operands(m, k, n, seed, bias=True):
    """Activations ~N(0, 1) in bf16, int8 weights with per-channel scales,
    a static act scale (absmax / 127) and its inverse, a bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                       dtype=torch.int8)
    ws = 1e-3 * (1 + torch.rand((n,), generator=g, device="cuda"))
    act = x.float().abs().amax() / 127.0
    b = torch.randn((n,), generator=g, device="cuda") if bias else None
    return dict(x=x, wq=wq, ws=ws, act=act, inv=1.0 / act, cs=ws * act, b=b)


def gemm_cases(shape, n):
    """(label, route, x kind, epilogue, extra) for every prologue and
    epilogue at this GEMM shape (requant with 3 and 36 column groups where
    they divide N), plus the float32 and bias-free forms on the ragged
    shape."""
    cases = [("fused bf16->bf16", "fused", "x", "float", {}),
             ("qlinear bf16->bf16", "qlinear", "x", "float", {}),
             ("qlinear int8->bf16", "qlinear", "xq", "float", {})]
    for x_kind in ("x", "xq"):
        for groups in (3, 36):
            if n % groups == 0:
                cases.append((f"requant/{groups} {x_kind}", "qlinear", x_kind,
                              "requant", {"groups": groups}))
        for approx in (True, False):
            cases.append((f"gelu {'tanh' if approx else 'erf'} {x_kind}",
                          "qlinear", x_kind, "gelu", {"gelu_approx": approx}))
    if shape == "ragged":
        cases += [("fused f32->f32", "fused", "x32", "float", {}),
                  ("qlinear f32->f32 nobias", "qlinear", "x32", "float",
                   {"nobias": True})]
    return cases


def _gemm_args(ops, route, x_kind, epilogue, extra, seed):
    x = {"x": ops["x"], "x32": ops["x"].float(),
         "xq": torch.clamp(torch.round(ops["x"].float() / ops["act"]),
                           -127, 127).to(torch.int8)}[x_kind]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    kw = dict(route=route, epilogue=epilogue)
    if epilogue == "float":
        kw["out_dtype"] = torch.float32 if x_kind == "x32" else torch.bfloat16
    elif epilogue == "requant":
        kw["groups"] = extra["groups"]
        kw["out_scales"] = 0.1 + 0.1 * torch.rand(
            (extra["groups"],), generator=g, device="cuda")
    else:
        kw["gelu_approx"] = extra["gelu_approx"]
        kw["out_scales"] = torch.full((1,), 0.1, device="cuda")
    cs = ops["cs"] if route == "fused" else ops["ws"]
    a = ops["inv"] if route == "fused" else ops["act"]
    b = None if extra.get("nobias") else ops["b"]
    return (x, ops["wq"], cs, b, a), kw


def check_gemm(m=8 * 197):
    """int8 GEMM vs its plain version on the card.  Float outputs: the two
    run the same rounded operations on the exact integer dot, so they are
    held to 1e-6 relative (float32) or one bf16 ulp (2^-8 relative); int8
    outputs to one step on at most 0.1 %.  Returns the worst float error."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    shapes = dict(GEMM_SHAPES, ragged=(200, 72))
    worst, failures = 0.0, []
    for si, (shape, (k, n)) in enumerate(shapes.items()):
        mm = 111 if shape == "ragged" else m
        ops = gemm_operands(mm, k, n, seed=si)
        for label, route, x_kind, epi, extra in gemm_cases(shape, n):
            args, kw = _gemm_args(ops, route, x_kind, epi, extra, si)
            got = gemm.linear_int8(*args, **kw)
            want = gemm.linear_int8_ref(*args, **kw)
            torch.cuda.synchronize()
            case = f"gemm {shape:6s} M={mm} K={k} N={n} {label}"
            if epi == "float":
                rtol = 1e-6 if kw["out_dtype"] == torch.float32 else 2 ** -8
                tol = (0.0, rtol)
            else:
                tol = None
            w = _compare(case, (got,), (want,), (tol,), failures)
            if tol is not None:
                worst = max(worst, w)
    if failures:
        raise AssertionError("int8 GEMM != plain version:\n"
                             + "\n".join(failures))
    return worst


def check_ln_quant():
    """ln_quant vs its plain version: int8 within one step on <= 0.1 %
    (the two sum the row statistics in another order).  Returns the worst
    step."""
    from vision_transformer_cam_tpu_torch.kernels import gemm
    g = torch.Generator(device="cuda").manual_seed(7)
    worst, failures = 0, []
    for (m, c) in ((8 * 197, 768), (111, 72)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (3.0 * torch.randn((m, c), generator=g, device="cuda")
                 + 0.5).to(dtype)
            w = 1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
            b = 0.1 * torch.randn((c,), generator=g, device="cuda")
            inv = torch.tensor(127.0 / 4.0, device="cuda")
            args = (x, w.to(dtype), b.to(dtype))
            got = gemm.ln_quant(*args, eps=1e-6, inv_a=inv)
            want = gemm.ln_quant_ref(*args, eps=1e-6, inv_a=inv)
            torch.cuda.synchronize()
            worst = max(worst, _compare(
                f"ln_quant [{m}, {c}] {str(dtype).split('.')[-1]}",
                (got,), (want,), (None,), failures))
    if failures:
        raise AssertionError("ln_quant != plain version:\n"
                             + "\n".join(failures))
    return worst


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


def in_turns(kern, plain, iters=20):
    """(kernel ms, plain ms), each the mean of two runs, in turns."""
    p1, k1 = time_ms(plain, iters), time_ms(kern, iters)
    k2, p2 = time_ms(kern, iters), time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_kernels(b=64, n=197):
    """Each kernel against its plain version at ViT-B shapes and B=64;
    the int8 GEMMs also against bf16 F.linear at the same shape."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    times = {}
    for kind in ("bf16", "float32", "int8_io", "int8_out"):
        dtype = {"bf16": torch.bfloat16, "float32": torch.float32,
                 "int8_io": torch.int8, "int8_out": torch.bfloat16}[kind]
        clamp = kind != "float32"
        qkv, bg, joint, sc = attention_inputs(b, n, 12, dtype, seed=1)
        scales = torch.cat([sc, torch.tensor([20.0], device="cuda")]) \
            if kind == "int8_io" else (torch.tensor([20.0], device="cuda")
                                       if kind == "int8_out" else None)
        for variant in VARIANTS if kind in ("bf16", "float32") \
                else ("rollout",):
            def kern():
                _call(ka.masked_attention_fused, variant, qkv, bg, joint, 12,
                      clamp, scales)

            def plain():
                _call(ka.masked_attention_fused_ref, variant, qkv, bg, joint,
                      12, clamp, scales)
            times[("attention", kind, variant)] = in_turns(kern, plain)
            k_ms, p_ms = times[("attention", kind, variant)]
            say(f"time attention {kind:8s} {variant:8s} B={b} N={n}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    # the int8 GEMMs as the int8 main path calls them (ln_quant and the
    # fused route on): patch fused bf16 -> bf16, qkv int8 -> requant/36,
    # proj int8 -> bf16, fc1 int8 -> gelu, fc2 int8 -> bf16
    path = {"patch": ("fused", "x", "float", {}),
            "qkv": ("qlinear", "xq", "requant", {"groups": 36}),
            "proj": ("qlinear", "xq", "float", {}),
            "fc1": ("qlinear", "xq", "gelu", {"gelu_approx": True}),
            "fc2": ("qlinear", "xq", "float", {})}
    for si, (shape, (k, n_out)) in enumerate(GEMM_SHAPES.items()):
        ops = gemm_operands(b * n, k, n_out, seed=10 + si)
        route, x_kind, epi, extra = path[shape]
        args, kw = _gemm_args(ops, route, x_kind, epi, extra, si)
        times[("gemm", shape)] = in_turns(
            lambda: gemm.linear_int8(*args, **kw),
            lambda: gemm.linear_int8_ref(*args, **kw), iters=5)
        wb = torch.randn((n_out, k), device="cuda").to(torch.bfloat16)
        times[("gemm_bf16", shape)] = time_ms(
            lambda: torch.nn.functional.linear(ops["x"], wb, None), 5)
        k_ms, p_ms = times[("gemm", shape)]
        say(f"time int8 GEMM {shape:5s} M={b * n} K={k} N={n_out} "
            f"({route}, {x_kind}, {epi}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bf16 F.linear {times[('gemm_bf16', shape)]:.4f} "
            f"ms")
    x = torch.randn((b * n, 768), device="cuda").to(torch.bfloat16)
    w = torch.ones(768, device="cuda", dtype=torch.bfloat16)
    inv = torch.tensor(30.0, device="cuda")
    times[("ln_quant",)] = in_turns(
        lambda: gemm.ln_quant(x, w, w, eps=1e-6, inv_a=inv),
        lambda: gemm.ln_quant_ref(x, w, w, eps=1e-6, inv_a=inv))
    say(f"time ln_quant [{b * n}, 768] bf16: kernel "
        f"{times[('ln_quant',)][0]:.4f} ms, plain "
        f"{times[('ln_quant',)][1]:.4f} ms")
    return times


def reset_counts():
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    ka.launches = 0
    gemm.linear_int8_launches = 0
    gemm.ln_quant_launches = 0


def read_counts():
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    return {"masked_attention_fused": ka.launches,
            "linear_int8_fused": gemm.linear_int8_launches,
            "ln_quant": gemm.ln_quant_launches}


def serve(model, reqs, per_forward, label):
    """The requests through ``model`` with the rollout CAM; the launch
    counts are set to 0 before and read after, and must be ``per_forward``
    times the number of requests."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    g = model.cfg.grid_size
    reset_counts()
    t0 = time.perf_counter()
    outs = []
    for x in reqs:
        out = model(x, need_rollout=True)
        outs.append((out, cam_from_rollout_row(out.rollout_row, g)))
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: v * len(reqs) for k, v in per_forward.items()}
    say(f"main path {label}: {len(reqs)} requests x {reqs[0].shape[0]} images "
        f"in {time.perf_counter() - t0:.3f} s (first includes warm-up), "
        f"launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    b = reqs[0].shape[0]
    for out, cam in outs:
        if tuple(cam.shape) != (b, g, g) or not torch.isfinite(cam).all():
            raise AssertionError(f"{label}: CAM {tuple(cam.shape)} not finite "
                                 f"[{b},{g},{g}]")
        if not torch.all(cam.amax(dim=(1, 2)) == 1.0):
            raise AssertionError(f"{label}: CAM max is not 1.0 for every "
                                 "image")
        if not torch.isfinite(out.logits.float()).all():
            raise AssertionError(f"{label}: logits not finite")
    return outs, counts


def deviation(outs, refs):
    """(CAM max abs dev, logits max abs dev, mean top-16 overlap)."""
    d_cam = d_logit = 0.0
    overlap = []
    for (out, cam), (ref, ref_cam) in zip(outs, refs):
        d_cam = max(d_cam, float((cam - ref_cam).abs().max()))
        d_logit = max(d_logit, float(
            (out.logits.float() - ref.logits.float()).abs().max()))
        for a, b_ in zip(out.top_patch_idx.tolist(),
                         ref.top_patch_idx.tolist()):
            overlap.append(len(set(a) & set(b_)) / len(a))
    return d_cam, d_logit, float(np.mean(overlap))


def whole_path_check(qm, mode, g):
    """The quantized model on the card (kernels) against the same model
    on the CPU (plain versions), on WHOLE_CASES; every case is printed
    before any failure raises."""
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)
    cpu = copy.deepcopy(qm).cpu()
    size = qm.cfg.img_size
    bad = []
    for b, seed in WHOLE_CASES:
        xs = np.random.default_rng(seed).standard_normal(
            (b, size, size, 3), dtype=np.float32)
        got = qm(torch.from_numpy(xs).cuda(), need_rollout=True)
        ref = cpu(torch.from_numpy(xs), need_rollout=True)
        dc = float((cam_from_rollout_row(got.rollout_row, g).cpu()
                    - cam_from_rollout_row(ref.rollout_row, g)).abs().max())
        gl, rl = got.logits.float().cpu(), ref.logits.float()
        dl = float((gl - rl).abs().max())
        rel = float(((gl - rl).norm(dim=-1) / rl.norm(dim=-1)).max())
        say(f"{mode} card vs CPU plain versions (B={b}, images seed {seed}): "
            f"CAM max abs dev {dc:.3e} (tol {WHOLE_TOL['cam']}), logits max "
            f"abs dev {dl:.3e} (tol {WHOLE_TOL['logits']}; max |logits| "
            f"{float(rl.abs().max()):.3f}, worst per-image relative L2 "
            f"{rel:.3e})")
        if not (dc <= WHOLE_TOL["cam"] and dl <= WHOLE_TOL["logits"]):
            bad.append((b, seed))
    if bad:
        raise AssertionError(f"{mode}: the card disagrees with the plain "
                             f"versions on (B, seed) {bad}")


def main_path(batch=32, requests=3, bench_batch=256):
    from vision_transformer_cam_tpu_torch import configs, serving
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.ops.rollout import (
        cam_from_rollout_row)

    cfg = configs.vit_base_patch16_224_in21k(num_classes=20).replace(
        representation_size=None)

    def new_model():
        return ViTCAM(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))

    model = new_model()
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
    g = cfg.grid_size
    reqs = [images(batch) for _ in range(requests)]
    totals = {}
    outs_bf16, counts = serve(model, reqs, {"masked_attention_fused":
                                            cfg.depth, "linear_int8_fused": 0,
                                            "ln_quant": 0}, "bf16")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v

    # the same model on the eager attention path
    model.cfg = kcfg.replace(attn_impl="eager")
    refs = []
    for x in reqs:
        ref = model(x, need_rollout=True)
        refs.append((ref, cam_from_rollout_row(ref.rollout_row, g)))
    model.cfg = kcfg
    d_cam, d_logit, ov = deviation(outs_bf16, refs)
    say(f"bf16 kernel vs eager: CAM max abs dev {d_cam:.3e} (tol 5e-2), "
        f"logits max abs dev {d_logit:.3e} (tol 5e-2), top-16 overlap "
        f"{ov:.4f}")
    if not (d_cam <= 5e-2 and d_logit <= 5e-2):
        raise AssertionError("bf16 kernel path disagrees with the eager path")

    # int8 serving, calibrated on 16 seeded images, with the fused LN ->
    # int8 and the fused-quantize GEMM route on
    calib = np.random.default_rng(1).standard_normal(
        (16, cfg.img_size, cfg.img_size, 3), dtype=np.float32)
    served = {"bf16": (model, kcfg),
              "eager": (model, kcfg.replace(attn_impl="eager"))}
    for mode in ("int8", "int8_hifi"):
        qm = serving.apply_serving_mode(new_model(), mode,
                                        calib_images=calib)
        qm.cfg = qm.cfg.replace(ln_quant_fusion=True, int8_fused_gemm=True)
        per_fwd = {"masked_attention_fused": cfg.depth,
                   "linear_int8_fused": 1 + 4 * cfg.depth,
                   "ln_quant": (2 if mode == "int8" else 1) * cfg.depth}
        outs, counts = serve(qm, reqs, per_fwd, mode)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        whole_path_check(qm, mode, g)
        d_cam, d_logit, ov = deviation(outs, outs_bf16)
        say(f"{mode} vs bf16 kernel path (recorded, not gated): CAM max abs "
            f"dev {d_cam:.3e}, logits max abs dev {d_logit:.3e}, top-16 "
            f"overlap {ov:.4f}")
        served[mode] = (qm, qm.cfg)

    # throughput at batch 256, in turns; "eager" is the bf16 model on the
    # eager attention path
    xb = images(bench_batch)

    def rate(mode, iters=5):
        m, mcfg = served[mode]
        m.cfg = mcfg
        for _ in range(2):
            cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            cam_from_rollout_row(m(xb, need_rollout=True).rollout_row, g)
        torch.cuda.synchronize()
        return bench_batch * iters / (time.perf_counter() - t)
    order = ("bf16", "eager", "int8", "int8_hifi", "int8_hifi", "int8",
             "eager", "bf16")
    rates = {}
    for mode in order:
        rates.setdefault(mode, []).append(rate(mode))
    model.cfg = kcfg
    for mode, r in rates.items():
        say(f"{mode} CAM throughput, batch {bench_batch}: "
            f"{np.mean(r):.1f} img/s ({r[0]:.1f}, {r[1]:.1f})")
    return totals


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
    attn_errs = check_attention()
    gemm_err = check_gemm()
    ln_err = check_ln_quant()
    times = time_kernels()
    launches = main_path()
    gemm_ms = sum(times[("gemm", s)][0] for s in GEMM_SHAPES)
    gemm_plain = sum(times[("gemm", s)][1] for s in GEMM_SHAPES)
    stats = {
        "masked_attention_fused": (
            attn_errs[("per_head", "rollout", True, 197)],
            *times[("attention", "int8_io", "rollout")]),
        "linear_int8_fused": (gemm_err, gemm_ms, gemm_plain),
        "ln_quant": (float(ln_err), *times[("ln_quant",)]),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": stats[name][0],
         "ms": stats[name][1], "plain_ms": stats[name][2]}
        for name, (route, src, rep) in KERNELS.items()]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
