"""Single-image CAM prediction / visualization entry (the port of
vision_transformer_cam_tpu/cli/predict.py; the reference's predict.py).

Produces the reference's 7x6 matplotlib grid — per-block token cosine-sim
matrices, per-block attention maps (raw 14x14 + overlay), the full-rollout
mask overlay, the original image — plus GT-label / top-k prediction text from
sigmoid(head1), and saves it under --out instead of requiring an X display.
``--device`` is honoured: the card by default, the CPU on request.

Parity notes:
  * per-block maps are row 0 of the row-normalized (A_i + I), computed from
    the model's per-layer cls rows, no full matrices needed;
  * the rollout mask is the model's fused in-loop joint product;
  * the reference normalizes block embeddings with F.normalize over dim=1 of
    the [1, N, C] tensor — i.e. across TOKENS, not features; reproduced
    verbatim so the similarity panels match pixel for pixel.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.data.transforms import (
    load_and_preprocess)
from vision_transformer_cam_tpu_torch.data.voc12 import (
    CAT_LIST, load_image_label_from_xml)
from vision_transformer_cam_tpu_torch.io import weights as wio
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import rollout
from vision_transformer_cam_tpu_torch.utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img_name", type=str, default="2007_003011",
                   help="VOC image id or full path to an image")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--model_name", type=str, default="vit_base",
                   help="'vit_base' (reference alias) or a MODEL_ZOO name")
    p.add_argument("--out", type=str, default="./predict_cam")
    p.add_argument("--no_figure", action="store_true",
                   help="skip the matplotlib grid (arrays only)")
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "eager", "kernel"],
                   help="auto = fused CUDA kernel on the card, eager on the "
                        "CPU")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def predict_image(model: ViTCAM, image_hw3: np.ndarray,
                  ori_img_bgr: np.ndarray) -> dict:
    """Runs the model on one preprocessed image ([H, W, 3] float32) and
    derives every visualization artifact.  Returns a dict of numpy
    arrays."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(image_hw3[None])).to(
        device=dev, dtype=cfg.dtype)
    out = model(x, need_blocks=True, need_rollout=True)
    g = cfg.grid_size

    per_block = _host(rollout.per_block_cams(
        out.attn_cls_rows, g))[:, 0]                       # [L, g, g] in [0,1]
    cam = _host(rollout.cam_from_rollout_row(out.rollout_row, g))[0]

    # token cosine-sim panels with the reference's dim=1 normalize quirk
    blocks = _host(out.block_outputs)[:, 0]                # [L, N, C]
    bn = blocks / np.linalg.norm(blocks, axis=1, keepdims=True).clip(1e-12)
    sim = np.einsum("lnc,lmc->lnm", bn, bn)                # [L, N, N]

    probs = 1.0 / (1.0 + np.exp(-_host(out.head1_logits)[0]))
    return {"per_block_cams": per_block, "rollout_cam": cam,
            "token_sim": sim, "probs_head1": probs,
            "logits": _host(out.logits)[0]}


def render_grid(arts: dict, ori_img_bgr: np.ndarray, str_label: str,
                str_pred: str, out_path: str) -> None:
    """The reference's 7x6 grid layout."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from vision_transformer_cam_tpu_torch.cam.pseudo_seg import (
        np_bilinear_resize)

    img_rgb = ori_img_bgr[..., ::-1]
    h, w = img_rgb.shape[:2]
    n_blocks = arts["per_block_cams"].shape[0]
    # 2 blocks (3 panels each) per 6-wide row + a final summary row: the
    # reference's 7x6 at depth 12, scaled to any zoo depth
    rows = -(-3 * n_blocks // 6) + 1
    plt.figure(figsize=(12, 14 * rows / 7.0))
    for i in range(n_blocks):
        plt.subplot(rows, 6, 3 * i + 1)
        plt.imshow(arts["token_sim"][i])
        plt.xticks([]); plt.yticks([])
        plt.subplot(rows, 6, 3 * i + 2)
        plt.imshow(arts["per_block_cams"][i])
        plt.xticks([]); plt.yticks([])
        plt.subplot(rows, 6, 3 * (i + 1))
        plt.imshow(img_rgb)
        up = np_bilinear_resize(arts["per_block_cams"][i], (h, w))
        plt.imshow((up * 255).astype(np.uint8), alpha=0.4, cmap="rainbow")
        plt.xticks([]); plt.yticks([])
    base = (rows - 1) * 6
    plt.subplot(rows, 6, base + 3)
    plt.imshow(img_rgb)
    plt.xticks([]); plt.yticks([])
    plt.subplot(rows, 6, base + 6)
    plt.imshow(img_rgb)
    up = np_bilinear_resize(arts["rollout_cam"], (h, w))
    plt.imshow(up * 255, alpha=0.4, cmap="rainbow")
    plt.xticks([]); plt.yticks([])
    plt.axis("off")
    plt.figtext(0.1, 0.97, str_label, fontsize=10, color="green")
    plt.figtext(0.1, 0.95, str_pred, fontsize=10, color="black")
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close()


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    factory = configs.resolve_model(args.model_name)
    cfg = factory(num_classes=args.num_classes)
    cfg = cfg.replace(representation_size=None)  # has_logits=False
    # single-image CLI: per-sample vs batch-global mask normalization are
    # IDENTICAL at batch 1 (the reference's predict/validate case); set
    # per-sample so the graph matches the batched serving surfaces
    cfg = cfg.replace(per_sample_mask_norm=True)
    impl = args.attn_impl
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "eager"
    cfg = cfg.replace(attn_impl=impl)
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    if args.weights:
        # a reference .pth drops its head keys, which keep the init (the
        # reference's strict=False load); other containers load verbatim
        wio.load_weights(args.weights, model,
                         del_keys=("head.weight", "head.bias"))

    if os.path.sep in args.img_name or args.img_name.endswith(".jpg"):
        img_path, name = args.img_name, os.path.splitext(
            os.path.basename(args.img_name))[0]
    else:
        name = args.img_name
        img_path = os.path.join(args.dataset_path, "JPEGImages",
                                name + ".jpg")
    import PIL.Image
    pil = PIL.Image.open(img_path).convert("RGB")
    ori_bgr = np.asarray(pil)[..., ::-1]
    x = load_and_preprocess(img_path, cfg.img_size,
                            np.asarray((0.485, 0.456, 0.406), np.float32),
                            np.asarray((0.229, 0.224, 0.225), np.float32))

    arts = predict_image(model, x, ori_bgr)

    # GT labels + top-k prediction strings
    try:
        gt = load_image_label_from_xml(name, args.dataset_path)
    except Exception:
        gt = None
    if gt is not None and gt.sum() > 0:
        gt_idx = np.flatnonzero(gt)
        str_label = "GT labels: " + " ".join(CAT_LIST[i] for i in gt_idx)
        k = len(gt_idx)
    else:
        str_label, k = "GT labels: (unknown)", 1
    order = np.argsort(-arts["probs_head1"])[:k]
    str_pred = " ".join(f"{CAT_LIST[i]}:{arts['probs_head1'][i]:.3}"
                        for i in order)
    print(str_label)
    print("pred: " + str_pred)

    if not args.no_figure:
        out_path = os.path.join(args.out, f"{name}_cam_grid.jpg")
        render_grid(arts, ori_bgr, str_label, str_pred, out_path)
        print(f"saved {out_path}")
    return arts


if __name__ == "__main__":
    main()
