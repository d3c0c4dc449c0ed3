"""Serving-mode quality on TRAINED weights (the port of the TPU package's
scripts/quality_eval.py).

No VOC12 images or pretrained checkpoint are needed: a ViT is fine-tuned on
a synthetic 20-class dataset of textured squares over noise, whose
ground-truth segmentation is known from where the squares were drawn, until
its attention separates foreground from background.  Then every serving mode
is scored against the float32 path on those trained weights: the two sigmoid
mAPs, the pseudo-seg mIoU against the known masks, the CAM deviation (max,
p99.9, share above 1 %, mean), the top-16 overlap, the pixel match of the
pseudo-seg maps and the tie margins of the flipped mask decisions.  Random
weights leave attention near uniform and the background mask idle; this
script measures the case users meet.

    python3 -m vision_transformer_cam_tpu_torch.scripts.quality_eval \
        [--steps 300] [--batch 64] [--eval 256] [--chunk 0] [--seed 0] \
        [--model vit_base_patch16_224_in21k] [--freeze 0] [--objects 1] \
        [--size_lo 5] [--size_hi 3] [--params PATH] [--sabotage] [--pairs] \
        [--device cuda]

Rows, in order: the truth (float32 weights and activations, full float32
GEMMs, per-sample mask norm, the eager attention path); with --sabotage the
same weights with a broken background gate (bg_rollout_threshold 0.05 ->
0.5), which must crater the mIoU; bf16 serving (bf16 weights, the attention
kernel, tanh GELU, the clamped softmax); int8_hifi (W8A8 GEMMs, int8 attention
output); int8 (W8A8 GEMMs, per-head int8 attention I/O); and the per-tensor
("r2") int8 attention scales, the ablation.  The int8 rows calibrate on 16
seeded images and leave ``ln_quant_fusion`` and ``int8_fused_gemm`` off.

--freeze K leaves blocks 0..K-1 at their init, so that the selection emerges
where the pipeline reads it (blocks >= mask_from).  --params PATH loads the
fine-tuned weights where PATH exists, else fine-tunes and saves them there
(a ``torch.save`` state dict; keep model, seed and protocol in the name).
The data generator is the TPU script's, bit for bit: the same seeds give the
same images, labels and masks.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import concurrent.futures
import copy
import os
import sys
import time

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cam.pseudo_seg import pseudo_seg_batch
from vision_transformer_cam_tpu_torch.io.weights import (load_state_dict,
                                                         load_weights)
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import rollout
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.metrics import (ConfusionMatrix,
                                                            compute_mAP)

NUM_CLASSES = 20
# deterministic class colors/textures (means in normalized-image units); the
# draws' order is the TPU script's, so every image is the same
_rng = np.random.RandomState(0)
CLASS_COLOR = _rng.uniform(-1.8, 1.8, size=(NUM_CLASSES, 3))
CLASS_FREQ = _rng.randint(2, 6, size=NUM_CLASSES)
# relational "pairs" protocol: 7 texture primitives; a class is an unordered
# pair of primitives (two squares in the image), so the classifier must bind
# both squares, which puts the cls token's late-block attention on the
# objects, where the pipeline reads localization (blocks >= mask_from)
N_PRIM = 7
PRIM_COLOR = _rng.uniform(-1.8, 1.8, size=(N_PRIM, 3))
PRIM_FREQ = _rng.randint(2, 9, size=N_PRIM)
PAIRS = [(a, b) for a in range(N_PRIM) for b in range(a + 1, N_PRIM)]
PAIRS = PAIRS[:NUM_CLASSES]          # 21 pairs -> first 20 are classes

_BOOL = ("--sabotage", "--pairs")
_VALUE = ("--steps", "--batch", "--eval", "--chunk", "--seed", "--model",
          "--freeze", "--objects", "--size_lo", "--size_hi", "--params",
          "--device")
# batches the host draws ahead of the training step (each from its own seed,
# so the order of the draws changes nothing)
PREFETCH = 4


def _paste_square(images, segs, i, y0, x0, sq, color, freq, seg_val):
    yy, xx = np.mgrid[0:sq, 0:sq]
    tex = np.sin((xx + yy) * (np.pi / freq))[..., None]
    images[i, y0:y0 + sq, x0:x0 + sq] += (
        color[None, None, :] * (0.75 + 0.25 * tex)).astype(np.float32)
    if segs is not None:
        segs[i, y0:y0 + sq, x0:x0 + sq] = seg_val


def make_pairs_batch(seed: int, n: int, img: int = 224,
                     with_seg: bool = False, size_lo: int = 5,
                     size_hi: int = 3):
    """Relational protocol: one class per image = an unordered pair of
    texture primitives, drawn as two non-overlapping squares; the GT seg
    marks both squares with the class id (+1).  Returns NHWC float32 images
    and labels as CPU tensors (and the uint8 masks as numpy)."""
    r = np.random.RandomState(seed)
    images = r.normal(0.0, 0.25, size=(n, img, img, 3)).astype(np.float32)
    labels = np.zeros((n, NUM_CLASSES), np.float32)
    segs = np.zeros((n, img, img), np.uint8) if with_seg else None
    for i in range(n):
        c = int(r.randint(NUM_CLASSES))
        labels[i, c] = 1.0
        placed = []
        for prim in PAIRS[c]:
            sq = r.randint(img // size_lo, img // size_hi + 1)
            for _ in range(16):
                y0, x0 = r.randint(0, img - sq), r.randint(0, img - sq)
                if all(y0 + sq <= py or py + ps <= y0
                       or x0 + sq <= px or px + ps <= x0
                       for py, px, ps in placed):
                    break
            placed.append((y0, x0, sq))
            _paste_square(images, segs, i, y0, x0, sq,
                          PRIM_COLOR[prim], PRIM_FREQ[prim], c + 1)
    if with_seg:
        return torch.from_numpy(images), torch.from_numpy(labels), segs
    return torch.from_numpy(images), torch.from_numpy(labels)


def make_batch(seed: int, n: int, img: int = 224, with_seg: bool = False,
               max_objects: int = 1, size_lo: int = 5, size_hi: int = 3,
               pairs: bool = False):
    """n images, each with 1..max_objects of the 20 classes; a present class
    contributes a textured square (side drawn from [img/size_lo,
    img/size_hi]) at a non-overlapping random location over a noise
    background.  One object by default: the background gate is
    max-normalized per image, so with two objects the rollout suppresses
    whichever the cls token attends to less, and the mIoU floor would be
    structural.

    Returns NHWC float32 images and multi-hot labels as CPU tensors (the
    caller moves them to the model's device); with_seg adds the uint8
    ground-truth masks [n, img, img] as numpy (0 = background, c + 1 = class
    c, the VOC convention)."""
    if pairs:
        return make_pairs_batch(seed, n, img, with_seg,
                                size_lo=size_lo, size_hi=size_hi)
    r = np.random.RandomState(seed)
    images = r.normal(0.0, 0.25, size=(n, img, img, 3)).astype(np.float32)
    labels = np.zeros((n, NUM_CLASSES), np.float32)
    segs = np.zeros((n, img, img), np.uint8) if with_seg else None
    for i in range(n):
        occupied = np.zeros((img, img), bool)
        n_obj = r.randint(1, max_objects + 1)
        for c in r.choice(NUM_CLASSES, size=n_obj, replace=False):
            sq = r.randint(img // size_lo, img // size_hi + 1)
            # up to 8 placement attempts to avoid overlap: overlapping
            # squares make the GT mask ambiguous
            for _ in range(8):
                y0 = r.randint(0, img - sq)
                x0 = r.randint(0, img - sq)
                if not occupied[y0:y0 + sq, x0:x0 + sq].any():
                    break
            else:
                continue
            labels[i, c] = 1.0
            occupied[y0:y0 + sq, x0:x0 + sq] = True
            yy, xx = np.mgrid[0:sq, 0:sq]
            tex = np.sin((xx + yy) * (np.pi / CLASS_FREQ[c]))[..., None]
            patch = CLASS_COLOR[c][None, None, :] * (0.75 + 0.25 * tex)
            images[i, y0:y0 + sq, x0:x0 + sq] += patch.astype(np.float32)
            if with_seg:
                segs[i, y0:y0 + sq, x0:x0 + sq] = c + 1
        if not labels[i].any():
            # every placement failed: retry the image as single-object, since
            # the mAP metric needs >= 1 positive per row
            sq = img // 3
            c = int(r.randint(NUM_CLASSES))
            labels[i, c] = 1.0
            yy, xx = np.mgrid[0:sq, 0:sq]
            tex = np.sin((xx + yy) * (np.pi / CLASS_FREQ[c]))[..., None]
            images[i, :sq, :sq] += (CLASS_COLOR[c][None, None, :]
                                    * (0.75 + 0.25 * tex)).astype(np.float32)
            if with_seg:
                segs[i, :sq, :sq] = c + 1
    if with_seg:
        return torch.from_numpy(images), torch.from_numpy(labels), segs
    return torch.from_numpy(images), torch.from_numpy(labels)


def freeze_mask(model: torch.nn.Module, freeze_below: int):
    """{parameter name: trains}: False for every parameter of blocks
    0..freeze_below-1, True for the rest (``train.state.Optimizer``'s
    freeze mask)."""
    return {name: not (name.startswith("blocks.")
                       and int(name.split(".")[1]) < freeze_below)
            for name, _ in model.named_parameters()}


def train_config(model: str) -> configs.ViTCAMConfig:
    """The fine-tune's configuration: the zoo model with the 20-class head
    and no representation layer, bf16 compute over float32 masters, the
    kernel attention path, every dropout ratio 0."""
    cfg = configs.resolve_model(model)(num_classes=NUM_CLASSES)
    return cfg.replace(representation_size=None, dtype=torch.bfloat16,
                       param_dtype=torch.float32, attn_impl="kernel",
                       drop_ratio=0.0, attn_drop_ratio=0.0,
                       drop_path_ratio=0.0)


def finetune(steps: int, batch: int, model: str, seed: int = 0,
             data_kw: dict | None = None, freeze_below: int = 0, *,
             device=None, init_state=None, history: list | None = None):
    """Fine-tune ``model`` for ``steps`` steps at ``batch`` on make_batch's
    data; returns the trained ``ViTCAM`` (float32 masters).

    freeze_below=K: blocks 0..K-1 stay at their init (left out of AdamW).  A
    from-scratch model solves the synthetic task with block-0..2 attention
    selection, but the pipeline reads localization from blocks mask_from=4
    and bg_blocks_from=5; freezing the early blocks makes the selection
    emerge where the pipeline looks, as it does in pretrained ViTs.

    The init is ``ViTCAM.init`` from a ``torch.Generator`` seeded with
    ``seed``; ``init_state`` (a state dict) replaces it.  The loss and F1 are
    read and printed every 25 steps and at the last; ``history`` (a list)
    receives (step, loss, f1, seconds) for each printed line.  The host draws
    the next batches in threads while the card runs the step."""
    from vision_transformer_cam_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    from vision_transformer_cam_tpu_torch.train.step import train_step
    data_kw = data_kw or {}
    dev = resolve_device(device)
    cfg = train_config(model)
    net = ViTCAM(cfg, device=dev,
                 generator=torch.Generator().manual_seed(seed))
    if init_state is not None:
        load_state_dict(net, init_state)
    opt, _ = make_optimizer(
        net, configs.OptimConfig(lr=5e-4, weight_decay=5e-5, warmup_epochs=1,
                                 epochs=max(steps // 50, 2)),
        global_batch_size=batch, steps_per_epoch=50,
        freeze_mask=freeze_mask(net, freeze_below) if freeze_below else None)
    state = create_train_state(net, opt)

    def draw(s):
        return make_batch(1000 + s + 100000 * seed, batch, img=cfg.img_size,
                          **data_kw)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(PREFETCH) as pool:
        ahead = [pool.submit(draw, s) for s in range(min(PREFETCH, steps))]
        for s in range(steps):
            images, labels = ahead.pop(0).result()
            if s + PREFETCH < steps:
                ahead.append(pool.submit(draw, s + PREFETCH))
            state, m = train_step(state, images.to(dev, non_blocking=True),
                                  labels.to(dev, non_blocking=True))
            if s % 25 == 0 or s == steps - 1:
                loss, f1 = float(m["loss"]), float(m["f1"])
                secs = time.perf_counter() - t0
                print(f"  step {s:4d}  loss {loss:.4f}  f1 {f1:.3f}  "
                      f"({secs:.0f}s)", flush=True)
                if history is not None:
                    history.append((s, loss, f1, secs))
    return net


def _mask_stack(cls_rows, num_tokens):
    """attn_cls_rows [L, B, N] -> the model's per-layer normalized patch
    masks [L, B, P] (numpy replica of the model's mask from the cls row with
    per-sample normalization, the inference semantics): the values the 0.25
    mask-feedback threshold and the final top-16 selection are applied
    to."""
    aug0 = np.asarray(cls_rows, np.float64).copy()
    aug0[..., 0] += 1.0
    aug0 /= aug0.sum(axis=-1, keepdims=True)
    m = aug0[..., num_tokens:]
    return m / m.max(axis=-1, keepdims=True)


def tie_margins(row, truth, cfg, mask_threshold=0.25):
    """Threshold-distance metrics: where a mode's decisions flip against the
    float32 truth, how far were the flipped patches from the decision
    boundary, in the truth's own normalized mask units?  Flips within ~1e-2
    of the boundary are threshold-tie noise; flips far from it would be
    structural quantization damage.

      mask_flip_frac:  share of (layer, image, patch) 0.25-mask-feedback
                       decisions that differ from the truth;
      tie_dist_mask:   median min(|truth_mask - 0.25|, |mode_mask - 0.25|)
                       over those flips (the side near the threshold; a
                       patch the truth masked underflows to exactly 0, so the
                       truth's distance alone reads 0.25 at every cascade
                       site);
      tie_dist_top16:  median distance of top-16 membership flips from the
                       truth's own 16th/17th-value boundary (last layer).
    Index sets are compared as sets: torch and JAX order ties differently."""
    mt = _mask_stack(truth["cls_rows"], cfg.num_tokens)
    mm = _mask_stack(row["cls_rows"], cfg.num_tokens)
    flips = (mt >= mask_threshold) != (mm >= mask_threshold)
    row["mask_flip_frac"] = float(flips.mean())
    row["tie_dist_mask"] = float(np.median(np.minimum(
        np.abs(mt[flips] - mask_threshold),
        np.abs(mm[flips] - mask_threshold)))) \
        if flips.any() else float("nan")
    last_t, last_m = mt[-1], mm[-1]
    d16 = []
    for i in range(last_t.shape[0]):
        st = set(np.asarray(truth["topi"][i]).tolist())
        sm = set(np.asarray(row["topi"][i]).tolist())
        flipped = st ^ sm
        if not flipped:
            continue
        v = np.sort(last_t[i])[::-1]
        k = truth["topi"].shape[1]
        boundary = 0.5 * (v[k - 1] + v[k])
        d16.extend(abs(last_t[i][p] - boundary) for p in flipped)
    row["tie_dist_top16"] = float(np.median(d16)) if d16 else float("nan")
    return row


def _host(t):
    return t.float().cpu().numpy()


@torch.no_grad()
def eval_mode(name, model, images, labels, truth=None, seg_gt=None, chunk=0,
              pcfg=None):
    """One row: ``model`` (its ``cfg`` is the mode) over ``images`` (on the
    model's device) in chunks of ``chunk`` (0 = all at once), with the
    rollout CAM.  Keys: mode, mAP_196patch, mAP_16patch, cam, topi, cls_rows;
    with seg_gt the pseudo-seg maps (seg) and their mIoU (filler ids above
    NUM_CLASSES folded to background); with truth (a row) the deviations:
    cam_max_dev, cam_mean_dev, cam_p999, cam_frac_gt_1pct, top16_overlap,
    seg_match and the tie margins."""
    cfg = model.cfg
    n_total = int(images.shape[0])
    chunk = chunk or n_total
    logits_l, h1_l, topi_l, cam_l, preds_l, rows_l = [], [], [], [], [], []
    pcfg = pcfg or configs.PseudoSegConfig()
    for lo in range(0, n_total, chunk):
        out = model(images[lo:lo + chunk], need_rollout=True)
        cam_c = rollout.cam_from_rollout_row(out.rollout_row, cfg.grid_size)
        logits_l.append(_host(out.logits))
        h1_l.append(_host(out.head1_logits))
        topi_l.append(out.top_patch_idx.cpu().numpy())
        cam_l.append(_host(cam_c))
        rows_l.append(_host(out.attn_cls_rows))             # [L, chunk, N]
        if seg_gt is not None:
            n_c = logits_l[-1].shape[0]
            preds_l.extend(pseudo_seg_batch(out, cfg, pcfg,
                                            [seg_gt.shape[1:]] * n_c))
    logits, h1 = np.concatenate(logits_l), np.concatenate(h1_l)
    topi, cam = np.concatenate(topi_l), np.concatenate(cam_l)
    cls_rows = np.concatenate(rows_l, axis=1)
    lab = np.asarray(labels)
    m196 = compute_mAP(lab, 1 / (1 + np.exp(-logits.astype(np.float32))))
    m16 = compute_mAP(lab, 1 / (1 + np.exp(-h1.astype(np.float32))))
    row = {"mode": name, "mAP_196patch": float(np.mean(m196)),
           "mAP_16patch": float(np.mean(m16)),
           "cam": cam.astype(np.float32), "topi": topi,
           "cls_rows": cls_rows}
    if seg_gt is not None:
        # the end artifact: the full pseudo-seg pipeline scored as mIoU
        # against the known square masks (filler ids > num_classes fold to
        # background, as cli.validate scores it)
        preds = np.stack(preds_l).astype(np.int64)
        preds[preds > NUM_CLASSES] = 0
        cm = ConfusionMatrix(NUM_CLASSES)
        cm.update(seg_gt.reshape(-1).astype(np.int64), preds.reshape(-1))
        _, _, iou = cm.compute()
        row["miou"] = float(np.nanmean(np.asarray(iou)) * 100)
        row["seg"] = preds
    if truth is not None:
        dev = np.abs(row["cam"] - truth["cam"])
        row["cam_max_dev"] = float(dev.max())
        row["cam_mean_dev"] = float(dev.mean())
        # max dev is a tail metric: one mask-threshold tie flip in an early
        # layer cascades into a large local CAM change while the bulk of the
        # map is untouched; p99.9 and the >1 % share describe the body
        row["cam_p999"] = float(np.quantile(dev, 0.999))
        row["cam_frac_gt_1pct"] = float((dev > 0.01).mean())
        inter = [len(set(a.tolist()) & set(b.tolist())) / len(a)
                 for a, b in zip(topi, truth["topi"])]
        row["top16_overlap"] = float(np.mean(inter))
        if seg_gt is not None and "seg" in truth:
            # pixel agreement of this mode's pseudo-seg maps with the
            # float32 path's: the artifact-level fidelity the top-16 overlap
            # only proxies
            row["seg_match"] = float((row["seg"] == truth["seg"]).mean())
        tie_margins(row, truth, cfg, mask_threshold=cfg.mask_threshold)
    return row


def base_config(model: str) -> configs.ViTCAMConfig:
    cfg = configs.resolve_model(model)(num_classes=NUM_CLASSES)
    return cfg.replace(representation_size=None)


def truth_config(base: configs.ViTCAMConfig) -> configs.ViTCAMConfig:
    """float32 weights and activations, full float32 GEMMs, per-sample mask
    norm (the reference validates at batch 1, where its global-max norm is
    the per-sample one), the eager attention path."""
    return base.replace(dtype=torch.float32, param_dtype=torch.float32,
                        matmul_precision="highest", per_sample_mask_norm=True)


def bf16_config(base: configs.ViTCAMConfig) -> configs.ViTCAMConfig:
    """The bf16 serving graph: bf16 weights, the attention kernel, tanh
    GELU, the clamped softmax, per-sample mask norm."""
    return base.replace(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                        attn_impl="kernel", gelu_approx=True,
                        softmax_clamp=True, per_sample_mask_norm=True)


def with_config(model: ViTCAM, cfg: configs.ViTCAMConfig) -> ViTCAM:
    """A copy of ``model`` with its parameters cast to ``cfg.param_dtype``
    and ``cfg`` as its configuration."""
    m = copy.deepcopy(model).to(dtype=cfg.param_dtype)
    m.cfg = cfg
    return m


def per_tensor_scales(model: ViTCAM) -> ViTCAM:
    """The round-2 per-tensor (q | k | v thirds) attention scales, in place:
    each layer's qkv ``out_scales`` [3, H] set to its maximum over the heads,
    repeated over the H heads (with every head's scale equal, the per-head
    kernel computes the per-tensor quantization)."""
    for blk in model.blocks:
        osc = blk.attn.qkv.out_scales
        blk.attn.qkv.out_scales = osc.amax(dim=1, keepdim=True).expand_as(
            osc).contiguous()
    return model


def int8_models(model_bf16: ViTCAM, cfg_bf16, calib):
    """(int8_hifi, int8, int8 per-tensor r2) models from the bf16 one:
    static activation scales calibrated on ``calib``, then
    ``quantize_params`` on a copy for each row (it swaps modules in place);
    ``ln_quant_fusion`` and ``int8_fused_gemm`` stay off."""
    from vision_transformer_cam_tpu_torch.ops.quant import (
        calibrate_act_scales, quantize_params)
    scales = calibrate_act_scales(model_bf16, cfg_bf16, calib)

    def quantized(cfg):
        m = quantize_params(copy.deepcopy(model_bf16), act_scales=scales)
        m.cfg = cfg
        return m

    hifi = quantized(cfg_bf16.replace(int8_attn_out=True))
    int8 = quantized(cfg_bf16.replace(int8_attn_io=True))
    r2 = per_tensor_scales(quantized(cfg_bf16.replace(int8_attn_io=True)))
    return hifi, int8, r2


def load_params(path: str, model: str, device) -> ViTCAM:
    """The fine-tuned weights at ``path`` in a float32 model of the truth
    configuration."""
    net = ViTCAM(truth_config(base_config(model)), device=device)
    return load_weights(path, net)


def save_params(path: str, model: ViTCAM) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


HEADER = (f"\n{'mode':36s} {'mAP_196':>8s} {'mAP_16':>8s} {'mIoU':>6s} "
          f"{'camMaxD':>8s} {'camP99.9':>8s} {'cam>1%':>7s} "
          f"{'camMeanD':>9s} {'top16ovl':>8s} {'segMatch':>8s} "
          f"{'mskFlip%':>8s} {'tieD.25':>8s} {'tieD16':>8s}")


def format_row(r) -> str:
    miou = f" {r['miou']:6.2f}" if "miou" in r else "       "
    extra = (f" {r['cam_max_dev']:8.5f} {r['cam_p999']:8.5f} "
             f"{r['cam_frac_gt_1pct']:7.4f} {r['cam_mean_dev']:9.6f} "
             f"{r['top16_overlap']:8.3f}") if "cam_max_dev" in r else ""
    match = f" {r['seg_match']:8.4f}" if "seg_match" in r else ""
    tie = (f" {100 * r['mask_flip_frac']:8.4f} {r['tie_dist_mask']:8.5f}"
           f" {r['tie_dist_top16']:8.5f}") if "mask_flip_frac" in r else ""
    return (f"{r['mode']:36s} {r['mAP_196patch']:8.4f} "
            f"{r['mAP_16patch']:8.4f}{miou}{extra}{match}{tie}")


def main(argv=None):
    """Prints the rows' table and returns {"rows": [truth, bf16, int8_hifi,
    int8, r2], "truth", "sabotaged" (or None), "history" (the printed
    fine-tune lines, empty when loaded), "finetune_s", "images" (the eval
    set on the device), "labels", "seg_gt", "model_f32" (the trained model in
    the truth configuration), "data_kw", "seed", "model", "chunk"}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["quality_eval.py"] + argv, bool_flags=_BOOL,
                    value_flags=_VALUE, prog="quality_eval.py")

    def arg(flag, default):
        return int(argv[argv.index(flag) + 1]) if flag in argv else default

    def sarg(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    dev = resolve_device(sarg("--device", None))
    steps = arg("--steps", 300)
    batch = arg("--batch", 64)
    n_eval = arg("--eval", 256)
    chunk = arg("--chunk", 0)
    # --seed N: an independent replicate (init, train data and eval draw)
    seed = arg("--seed", 0)
    model = sarg("--model", "vit_base_patch16_224_in21k")
    data_kw = dict(max_objects=arg("--objects", 1),
                   size_lo=arg("--size_lo", 5), size_hi=arg("--size_hi", 3),
                   pairs="--pairs" in argv)
    freeze_below = arg("--freeze", 0)
    base = base_config(model)

    params_path = sarg("--params", "")
    history, finetune_s = [], 0.0
    if params_path and os.path.exists(params_path):
        net = load_params(params_path, model, dev)
        print(f"loaded fine-tuned params from {params_path}")
    else:
        print(f"fine-tuning {model} {steps} steps @ batch {batch} "
              f"on synthetic data  (protocol: {data_kw}, "
              f"freeze_below={freeze_below})")
        t0 = time.perf_counter()
        net = finetune(steps, batch, model, seed=seed, data_kw=data_kw,
                       freeze_below=freeze_below, device=dev,
                       history=history)
        finetune_s = time.perf_counter() - t0
        if params_path:
            save_params(params_path, net)
            print(f"saved fine-tuned params to {params_path}")
    images, labels, seg_gt = make_batch(9999 + 100000 * seed, n_eval,
                                        img=base.img_size, with_seg=True,
                                        **data_kw)
    images = images.to(dev)

    f32 = truth_config(base)
    m32 = with_config(net, f32)
    truth = eval_mode("f32 exact (truth)", m32, images, labels,
                      seg_gt=seg_gt, chunk=chunk)

    bad = None
    if "--sabotage" in argv:
        # dynamic-range proof: a deliberately broken bg gate (threshold 0.05
        # -> 0.5 marks most foreground rollout mass as background) must
        # crater the truth mIoU, or the protocol has no power to catch a
        # pipeline regression
        broken = configs.PseudoSegConfig(bg_rollout_threshold=0.5)
        bad = eval_mode("f32 + SABOTAGED bg gate", m32, images, labels,
                        seg_gt=seg_gt, chunk=chunk, pcfg=broken)
        print(f"\ntruth mIoU {truth['miou']:.2f}  ->  sabotaged bg gate "
              f"mIoU {bad['miou']:.2f}")

    bf = bf16_config(base)
    mbf = with_config(net, bf)
    rows = [truth,
            eval_mode("bf16+kernel+tanh+clamp (serving)", mbf, images,
                      labels, truth, seg_gt, chunk=chunk)]
    calib, _ = make_batch(777 + 100000 * seed, 16, img=base.img_size,
                          **data_kw)
    hifi, int8, r2 = int8_models(mbf, bf, calib.to(dev))
    # int8_hifi serves output-only int8 attention I/O (float probabilities,
    # the kernel emits int8 for the proj GEMM)
    rows.append(eval_mode("int8_hifi (W8A8, float attn, int8-OUT)", hifi,
                          images, labels, truth, seg_gt, chunk=chunk))
    rows.append(eval_mode("int8 + attn I/O per-head (default)", int8, images,
                          labels, truth, seg_gt, chunk=chunk))
    rows.append(eval_mode("int8 + attn I/O per-tensor (r2)", r2, images,
                          labels, truth, seg_gt, chunk=chunk))

    print(HEADER)
    for r in rows:
        print(format_row(r))
    return {"rows": rows, "truth": truth, "sabotaged": bad,
            "history": history, "finetune_s": finetune_s, "images": images,
            "labels": labels, "seg_gt": seg_gt, "model_f32": m32,
            "data_kw": data_kw, "seed": seed, "model": model, "chunk": chunk}


if __name__ == "__main__":
    main()
