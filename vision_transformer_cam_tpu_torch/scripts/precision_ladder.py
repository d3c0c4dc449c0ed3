"""Matmul-precision ladder: CAM fidelity against a CPU reference, and
throughput, per float32 GEMM precision and attention path (the port of the
TPU package's scripts/precision_ladder.py).

    python3 -m vision_transformer_cam_tpu_torch.scripts.precision_ladder \
        [--precisions default,high,highest] [--impls eager,kernel] \
        [--dev-batch 16] [--batch 256] [--no-throughput] [--mask-from -1] \
        [--ref f64|f32] [--hybrid] [--model ZOO] [--device cuda]

The rungs are ``cfg.matmul_precision`` through
``models.vit._MATMUL_PRECISION``.  On an NVIDIA H100 ``default`` and
``highest`` are both full float32 (``torch.set_float32_matmul_precision(
"highest")``), and ``high`` is TF32 in the cuBLAS GEMMs while the
hand-written kernels' own products stay float32.  There is no bf16 rung: the
TPU script's ``default`` rung, one bf16 pass per f32 dot, is a property of the
TPU's matrix unit and has no counterpart here.

--ref picks the question.  f64 (the default) measures absolute accuracy
against a float64 ``ViTCAM`` on the CPU: even exact float32 math carries a
floor of deviation there.  f32 measures parity against a float32 eager
forward on the CPU, the arithmetic class of the BASELINE parity bar (CAM
<= 1e-5).  The reference runs in this process, on the same weights (one
seeded init, its state dict carried across devices and dtypes) and images
as the card rows, and is cached under ``build/`` keyed by reference, model,
deviation batch and --mask-from.  Deviation is measured at --dev-batch,
throughput at --batch: 2 warm-up forwards, then the best of 3 windows of 5
forwards, each window closed by one synchronisation.  --hybrid adds the
int8 rung: W8A8 GEMMs (static scales calibrated on 8 seeded images) with
float32 attention and rollout.  --mask-from above the depth switches the
background-mask feedback off, so the deviation is the raw per-product
rounding without the 0.25-threshold tie cascade.  Every rung: float32
storage, exact-erf GELU, no softmax clamp, the rollout CAM.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import rollout
from vision_transformer_cam_tpu_torch.utils import resolve_device

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")


def _build(model: str, impl: str, precision: str, mask_from=None):
    cfg = configs.resolve_model(model)(num_classes=20)
    cfg = cfg.replace(representation_size=None, dtype=torch.float32,
                      param_dtype=torch.float32, attn_impl=impl,
                      matmul_precision=None if precision == "default"
                      else precision)
    if mask_from is not None:
        # mask_from > depth disables the bg-mask feedback: deviation then
        # measures raw per-product rounding with no 0.25-threshold cascade
        cfg = cfg.replace(mask_from=mask_from)
    return cfg


def _state_images(cfg, batch: int):
    """(float32 CPU state dict of the seed-0 init, images [batch, H, W, 3]
    float32 on the CPU from a seed-1 generator): one model and one set of
    images for every rung and for the reference."""
    net = ViTCAM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    images = torch.randn((batch, cfg.img_size, cfg.img_size, 3),
                         generator=torch.Generator().manual_seed(1))
    return {k: v.detach() for k, v in net.state_dict().items()}, images


def _model(cfg, state, device):
    net = ViTCAM(cfg, device=device)
    net.load_state_dict(state)
    return net


def cam_logits(net, images):
    """(rollout CAM [B, g, g], logits [B, classes]) of one forward."""
    out = net(images, need_rollout=True)
    return (rollout.cam_from_rollout_row(out.rollout_row,
                                         net.cfg.grid_size), out.logits)


def reference(model: str, batch: int, mask_from=None, ref: str = "f64"):
    """The reference (CAM, logits) as float64 numpy on the CPU: "f64" a
    float64 ``ViTCAM`` (exact-math truth), "f32" the float32 eager forward
    (the parity class), on ``_state_images``' weights and images."""
    cfg32 = _build(model, "eager", "default", mask_from)
    state, images = _state_images(cfg32, batch)
    if ref == "f64":
        cfg = cfg32.replace(dtype=torch.float64, param_dtype=torch.float64)
        state = {k: v.double() for k, v in state.items()}
        images = images.double()
    else:
        cfg = cfg32
    cam, logits = cam_logits(_model(cfg, state, "cpu"), images)
    return cam.double().numpy(), logits.double().numpy()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ref_path(args):
    return os.path.join(BUILD, f"ladder_ref_{args.ref}_{args.model}_"
                        f"{args.dev_batch}_mf{args.mask_from}.npz")


def main(argv=None):
    """Prints one JSON line per rung and returns the rows."""
    ap = argparse.ArgumentParser(prog="precision_ladder")
    ap.add_argument("--model", default="vit_base_patch16_224_in21k")
    ap.add_argument("--precisions", default="default,high,highest")
    ap.add_argument("--impls", default="eager,kernel")
    ap.add_argument("--dev-batch", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--no-throughput", action="store_true")
    ap.add_argument("--mask-from", type=int, default=-1,
                    help="override cfg.mask_from (a value > depth switches "
                         "the bg-mask feedback off and measures raw "
                         "per-product rounding without the 0.25-threshold "
                         "tie cascade); -1 = model default")
    ap.add_argument("--ref", default="f64", choices=("f64", "f32"))
    ap.add_argument("--hybrid", action="store_true",
                    help="add the int8 rung: W8A8 GEMMs with float32 "
                         "attention and rollout")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    mask_from = None if args.mask_from < 0 else args.mask_from

    dev = resolve_device(args.device)
    ref_path = _ref_path(args)
    if not os.path.exists(ref_path):
        os.makedirs(BUILD, exist_ok=True)
        cam, logits = reference(args.model, args.dev_batch, mask_from,
                                args.ref)
        np.savez(ref_path, cam=cam, logits=logits)
    ref = np.load(ref_path)
    cam_ref, logits_ref = ref["cam"], ref["logits"]

    # one model and one set of images for every rung
    state, dev_images = _state_images(
        _build(args.model, "eager", "default", mask_from), args.dev_batch)
    net0 = _model(_build(args.model, "eager", "default", mask_from), state,
                  dev)
    rows = []
    combos = [(prec, impl, False) for prec in args.precisions.split(",")
              for impl in args.impls.split(",")]
    if args.hybrid:
        combos += [("highest", impl, True) for impl in args.impls.split(",")]
    for prec, impl, hybrid in combos:
        cfg = _build(args.model, impl, prec, mask_from)
        net = copy.deepcopy(net0)
        net.cfg = cfg
        label = impl
        if hybrid:
            # the int8 GEMM tier on the same float weights: the deviation
            # isolates what W8A8 GEMM quantization adds on top of a float32
            # attention core and rollout chain
            from vision_transformer_cam_tpu_torch.ops.quant import (
                calibrate_act_scales, quantize_params)
            calib = torch.randn((8, cfg.img_size, cfg.img_size, 3),
                                generator=torch.Generator().manual_seed(7))
            scales = calibrate_act_scales(net, cfg, calib.to(dev))
            net = quantize_params(net, act_scales=scales)
            label = f"{impl}+int8gemm"
        cam, logits = cam_logits(net, dev_images.to(dev))
        d = np.abs(cam.double().cpu().numpy() - cam_ref)
        row = {"impl": label, "precision": prec,
               f"cam_max_dev_vs_{args.ref}": float(np.max(d)),
               "cam_mean_dev": float(np.mean(d)),
               "cam_p99_dev": float(np.percentile(d, 99)),
               "logits_max_dev": float(np.max(np.abs(
                   logits.double().cpu().numpy() - logits_ref)))}
        if not args.no_throughput:
            images = torch.randn(
                (args.batch, cfg.img_size, cfg.img_size, 3),
                generator=torch.Generator().manual_seed(1)).to(dev)
            for _ in range(2):
                cam_logits(net, images)
            _sync(dev)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(5):
                    cam_logits(net, images)
                _sync(dev)
                best = min(best, (time.perf_counter() - t0) / 5)
            row["img_per_s"] = round(args.batch / best, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
