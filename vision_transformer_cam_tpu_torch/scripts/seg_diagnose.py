"""Stage-level diagnosis of the pseudo-seg pipeline on the synthetic data of
``scripts.quality_eval`` (the port of the TPU package's
scripts/seg_diagnose.py).

Fine-tunes as quality_eval does (or loads its weights), runs the float32
truth forward and the device half of the pseudo-seg pipeline on the card,
then prints per-stage statistics of the host half, so that a broken link in
the localization chain is measured, not guessed:

  0. mask:      per block, the share of patches the in-model feedback marks
                background (m < 0.25 of the augmented cls row, normalized
                per image);
  1. fg gate:   the share of pixels with winner_v >= fg_cos_threshold, and
                the IoU of that mask against the GT foreground;
  2. bg gate:   the same for the rollout-row gate (bg_up >= bg_rollout_thr);
  3. classes:   accuracy of the class assignment at the top-16 patch centres
                against the GT class there, and the filler share (patches no
                feature maps to);
  4. end:       class-agnostic IoU of the final nonzero mask, the per-class
                IoU and the mIoU (what quality_eval scores).

    python3 -m vision_transformer_cam_tpu_torch.scripts.seg_diagnose \
        [--steps 300] [--batch 64] [--eval 64] [--model ZOO] [--fg 0.5] \
        [--bg 0.05] [--cls 0.9] [--seed 0] [--objects 1] [--size_lo 5] \
        [--size_hi 3] [--save_state PATH] [--load_state PATH] [--freeze 0] \
        [--pairs] [--device cuda]

--save_state / --load_state write and read quality_eval's weight files (a
``torch.save`` state dict).  The raw eval tensors go to
``build/segdiag_last.npz`` under the repository root, for offline analysis.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cam import pseudo_seg as ps
from vision_transformer_cam_tpu_torch.ops.rollout import aug_cls_row
from vision_transformer_cam_tpu_torch.scripts import quality_eval as qe
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.metrics import ConfusionMatrix

_BOOL = ("--pairs",)
_VALUE = ("--steps", "--batch", "--eval", "--model", "--fg", "--bg", "--cls",
          "--seed", "--objects", "--size_lo", "--size_hi", "--save_state",
          "--load_state", "--freeze", "--device")
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "segdiag_last.npz")

finetune = qe.finetune


def _iou(a, b):
    inter = (a & b).sum()
    union = (a | b).sum()
    return inter / union if union else np.nan


def main(argv=None):
    """Prints the stage lines and returns them as numbers: {"masked_frac":
    [(mean, median, max) per block], "gt_fg", "fg_pass", "bg_pass",
    "winner_v_fg", "winner_v_bg", "bgup_fg", "bgup_bg", "fg_iou", "bg_iou",
    "nonzero", "end_fg_iou", "filler", "cls_acc", "per_class_iou" (list),
    "miou"}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["seg_diagnose.py"] + argv, bool_flags=_BOOL,
                    value_flags=_VALUE, prog="seg_diagnose.py")

    def arg(flag, default, cast=int):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    dev = resolve_device(arg("--device", None, str))
    steps = arg("--steps", 300)
    batch = arg("--batch", 64)
    n_eval = arg("--eval", 64)
    seed = arg("--seed", 0)
    model = arg("--model", "vit_base_patch16_224_in21k", str)
    pcfg = configs.PseudoSegConfig(
        cls_threshold=arg("--cls", 0.9, float),
        fg_cos_threshold=arg("--fg", 0.5, float),
        bg_rollout_threshold=arg("--bg", 0.05, float))
    data_kw = dict(max_objects=arg("--objects", 1),
                   size_lo=arg("--size_lo", 5), size_hi=arg("--size_hi", 3),
                   pairs="--pairs" in argv)
    base = qe.base_config(model)
    load = arg("--load_state", "", str)
    if load:
        net = qe.load_params(load, model, dev)
    else:
        net = finetune(steps, batch, model, seed=seed, data_kw=data_kw,
                       freeze_below=arg("--freeze", 0), device=dev)
    if "--save_state" in argv:
        qe.save_params(arg("--save_state", "", str), net)
    images, labels, segs = qe.make_batch(9999, n_eval, img=base.img_size,
                                         with_seg=True, **data_kw)

    f32 = qe.truth_config(base)
    m32 = qe.with_config(net, f32)
    out = m32(images.to(dev), need_rollout=True)
    d = ps.pseudo_seg_device(out, f32, pcfg)
    p2c_all = d.patch_to_cls.cpu().numpy()
    cos_all = d.cos_maps.float().cpu().numpy()
    bg_all = d.bg_row.float().cpu().numpy()
    topi = out.top_patch_idx.cpu().numpy()
    rows = out.attn_cls_rows.float().cpu()                 # [L, B, N]
    size = segs.shape[1:]
    os.makedirs(os.path.dirname(NPZ), exist_ok=True)
    np.savez(NPZ, patch_to_cls=p2c_all, cos_maps=cos_all, bg_row=bg_all,
             topi=topi, segs=segs, labels=labels.numpy(),
             cls_rows=rows.numpy())
    # per-block mask dynamics: the share of patches the in-model feedback
    # marks bg after each block (the mask block l computes gates block l+1)
    res = {"masked_frac": []}
    for lyr in range(rows.shape[0]):
        m = aug_cls_row(rows[lyr]).numpy()[:, 1:]
        m = m / m.max(axis=-1, keepdims=True)
        frac = (m < 0.25).mean(axis=-1)               # per image
        res["masked_frac"].append((float(frac.mean()),
                                   float(np.median(frac)),
                                   float(frac.max())))
        print(f"  block {lyr:2d}: masked-frac mean {frac.mean():.3f} "
              f"med {np.median(frac):.3f} max {frac.max():.3f}")

    stats = dict(fg_pass=[], bg_pass=[], gt_fg=[], fg_iou=[], bg_iou=[],
                 nonzero=[], end_fg_iou=[], filler=[], cls_acc=[],
                 winner_v_fg=[], winner_v_bg=[], bgup_fg=[], bgup_bg=[])
    cm = ConfusionMatrix(qe.NUM_CLASSES)
    g = f32.grid_size
    patch_px = f32.img_size // g
    for i in range(n_eval):
        cos_up = ps.np_bilinear_resize(cos_all[i].astype(np.float64), size)
        winner_v = np.max(cos_up, axis=0)
        bg_up = ps.np_bilinear_resize(bg_all[i].astype(np.float64), size)
        fg = winner_v >= pcfg.fg_cos_threshold
        bg = bg_up >= pcfg.bg_rollout_threshold
        gt_fg = segs[i] > 0
        stats["gt_fg"].append(gt_fg.mean())
        stats["fg_pass"].append(fg.mean())
        stats["bg_pass"].append(bg.mean())
        stats["winner_v_fg"].append(winner_v[gt_fg].mean()
                                    if gt_fg.any() else np.nan)
        stats["winner_v_bg"].append(winner_v[~gt_fg].mean())
        stats["bgup_fg"].append(bg_up[gt_fg].mean() if gt_fg.any() else np.nan)
        stats["bgup_bg"].append(bg_up[~gt_fg].mean())
        stats["fg_iou"].append(_iou(fg, gt_fg))
        stats["bg_iou"].append(_iou(bg, gt_fg))
        seg = ps.compose_pseudo_seg(p2c_all[i], cos_all[i], bg_all[i], size,
                                    pcfg)
        scored = seg.reshape(-1).astype(np.int64)
        scored[scored > qe.NUM_CLASSES] = 0
        cm.update(segs[i].reshape(-1).astype(np.int64), scored)
        stats["nonzero"].append((seg > 0).mean())
        stats["end_fg_iou"].append(_iou(seg.reshape(size) > 0, gt_fg))
        # top-16 patch class assignment against the GT class at the patch
        # centre
        p2c = p2c_all[i]
        stats["filler"].append((p2c > qe.NUM_CLASSES).mean())
        acc = []
        for k in range(p2c.shape[0]):
            if p2c[k] > qe.NUM_CLASSES:
                continue
            pi = int(topi[i, k])
            cy = (pi // g) * patch_px + patch_px // 2
            cx = (pi % g) * patch_px + patch_px // 2
            acc.append(float(int(segs[i][cy, cx]) == p2c[k] + 1))
        stats["cls_acc"].append(np.mean(acc) if acc else np.nan)

    for k, v in stats.items():
        res[k] = float(np.nanmean(np.asarray(v, np.float64)))
    _, _, iou_c = cm.compute()
    res["per_class_iou"] = [float(v) for v in np.asarray(iou_c)]
    res["miou"] = float(np.nanmean(np.asarray(iou_c)) * 100)
    print(f"\nGT fg fraction                 {res['gt_fg']:.3f}")
    print(f"fg gate pass fraction          {res['fg_pass']:.3f}   "
          f"(winner_v mean on GT-fg {res['winner_v_fg']:.3f} / on GT-bg "
          f"{res['winner_v_bg']:.3f}; thr {pcfg.fg_cos_threshold})")
    print(f"bg gate pass fraction          {res['bg_pass']:.3f}   "
          f"(bg_up mean on GT-fg {res['bgup_fg']:.4f} / on GT-bg "
          f"{res['bgup_bg']:.4f}; thr {pcfg.bg_rollout_threshold})")
    print(f"fg-gate-vs-GT-fg IoU           {res['fg_iou']:.3f}")
    print(f"bg-gate-vs-GT-fg IoU           {res['bg_iou']:.3f}")
    print(f"final nonzero fraction         {res['nonzero']:.3f}")
    print(f"final fg-mask IoU              {res['end_fg_iou']:.3f}")
    print(f"top-16 filler fraction         {res['filler']:.3f}")
    print(f"top-16 class accuracy @center  {res['cls_acc']:.3f}")
    print(f"per-class IoU: {[f'{v:.2f}' for v in res['per_class_iou']]}")
    print(f"mIoU {res['miou']:.2f}")
    return res


if __name__ == "__main__":
    main()
