"""Epoch-level training and evaluation on one device (the port of
vision_transformer_cam_tpu/train/loop.py).

As there, and unlike the reference: the F1 accumulator averages over steps
(the reference overwrites it and reports only the last sample's value), and
evaluation runs batched (the reference hard-codes batch 1).
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.data.loader import (BatchLoader,
                                                          device_prefetch)
from vision_transformer_cam_tpu_torch.data.voc12 import VOC12Dataset
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.train import checkpoint as ckptlib
from vision_transformer_cam_tpu_torch.train.state import (create_train_state,
                                                          make_optimizer,
                                                          trainable_mask)
from vision_transformer_cam_tpu_torch.train.step import (eval_step,
                                                         train_step,
                                                         train_step_accum)
from vision_transformer_cam_tpu_torch.utils import resolve_device
from vision_transformer_cam_tpu_torch.utils.metrics import compute_mAP


def check_supported(train_cfg: configs.TrainConfig) -> None:
    """Raise for a sharded layout: the trainer runs on one device."""
    item = "Queue 1 item 10"
    if tuple(train_cfg.mesh_shape) not in ((-1,), (1,)) \
            or tuple(train_cfg.mesh_axes) != ("data",):
        raise NotImplementedError(
            f"mesh_shape={train_cfg.mesh_shape!r} mesh_axes="
            f"{train_cfg.mesh_axes!r}: the trainer runs on one device; "
            f"multi-GPU training is not ported yet (ROADMAP {item})")
    for name in ("zero1", "pipeline", "pp_microbatches"):
        if getattr(train_cfg, name):
            raise NotImplementedError(
                f"train_cfg.{name}={getattr(train_cfg, name)!r} is not ported "
                f"yet (ROADMAP {item})")


def _log_line(path: Optional[str], text: str):
    print(text, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(text + "\n")


def train_one_epoch(state, loader, rng, epoch, log_every=50, grad_accum=1):
    """One pass over ``loader`` on the device of ``state.model``.  Returns
    (state, means of the step metrics)."""
    device = next(state.model.parameters()).device
    sums, steps = {}, 0
    t0 = time.time()
    for batch in device_prefetch(loader, device):
        if grad_accum > 1:
            state, metrics = train_step_accum(
                state, batch["image"], batch["label"], rng,
                accum_steps=grad_accum)
        else:
            state, metrics = train_step(state, batch["image"],
                                        batch["label"], rng)
        steps += 1
        # One device -> host read per step, deliberately: the reference reads
        # loss.item() every step for the same per-step non-finite abort.
        host = dict(zip(metrics, torch.stack(
            [v.double() for v in metrics.values()]).tolist()))
        if not np.isfinite(host["loss"]):
            print(f"WARNING: non-finite loss {host['loss']}, ending training",
                  file=sys.stderr)
            sys.exit(1)
        for k, v in host.items():
            sums[k] = sums.get(k, 0.0) + v
        if log_every and steps % log_every == 0:
            print(f"[epoch {epoch}] step {steps}/{len(loader)} "
                  f"loss {host['loss']:.4f} f1 {host['f1']:.4f} "
                  f"({(time.time() - t0) / steps:.3f}s/step)", flush=True)
    means = {k: v / max(steps, 1) for k, v in sums.items()}
    return state, means


def evaluate(model, loader):
    """Dual-head mAP over the val split, batched, on the model's device.
    Rows the loader padded by wrapping (``is_pad``, multi-process striping)
    are dropped, so every sample counts once."""
    device = next(model.parameters()).device
    labels, p_cls, p_h1, keeps = [], [], [], []
    for batch in device_prefetch(loader, device):
        out = eval_step(model, batch["image"])
        labels.append(batch["label"].cpu().numpy())
        p_cls.append(out["probs_cls"].cpu().numpy())
        p_h1.append(out["probs_head1"].cpu().numpy())
        keeps.append(~np.asarray(batch["is_pad"]) if "is_pad" in batch
                     else np.ones(len(labels[-1]), bool))
    y, pc, ph, keep = (np.concatenate(v)
                       for v in (labels, p_cls, p_h1, keeps))
    y, pc, ph = y[keep], pc[keep], ph[keep]
    return {"mAP_196patch": float(np.mean(compute_mAP(y, pc))),
            "mAP_16patch": float(np.mean(compute_mAP(y, ph))),
            "n_samples": int(len(y))}


def _dataset(data: configs.DataConfig) -> VOC12Dataset:
    return VOC12Dataset(data.img_name_list_path, data.voc12_root,
                        cls_labels_path=data.cls_labels_path or None,
                        img_size=data.img_size, mean=data.mean, std=data.std)


def fit(model_cfg: configs.ViTCAMConfig, train_cfg: configs.TrainConfig,
        train_data: configs.DataConfig, val_data: configs.DataConfig,
        *, init_model: Optional[ViTCAM] = None, epochs: Optional[int] = None,
        log_dir: str = ".", resume: bool = False, device=None):
    """Full fine-tune entry: builds the loaders, the model (``init_model``,
    or a fresh ``ViTCAM`` seeded with ``train_cfg.seed``) on ``device`` (the
    card unless asked otherwise), the optimizer and schedule; trains
    ``epochs`` epochs with an evaluation and a log line after each, saving
    the best-train-loss and the final checkpoint; ``resume`` continues from
    the newest checkpoint in ``train_cfg.ckpt_dir``.  Returns the state."""
    check_supported(train_cfg)
    device = resolve_device(device)
    loader = BatchLoader(_dataset(train_data), train_cfg.batch_size,
                         shuffle=True, seed=train_cfg.seed,
                         num_threads=train_data.num_threads,
                         native_decode=train_data.native_decode)
    val_loader = BatchLoader(_dataset(val_data), train_cfg.batch_size,
                             shuffle=False, drop_last=False,
                             num_threads=val_data.num_threads,
                             native_decode=val_data.native_decode)
    model = init_model if init_model is not None else ViTCAM(
        model_cfg, device=device,
        generator=torch.Generator().manual_seed(train_cfg.seed))
    model.to(device)
    mask = trainable_mask(model, train_cfg.freeze_backbone)
    optimizer, schedule = make_optimizer(
        model, train_cfg.optim, train_cfg.batch_size, max(len(loader), 1),
        freeze_mask=mask if train_cfg.freeze_backbone else None)
    state = create_train_state(model, optimizer)
    if resume:
        tag = ckptlib.latest_tag(train_cfg.ckpt_dir)
        if tag:
            state = ckptlib.restore(train_cfg.ckpt_dir, tag, state)
            print(f"resumed from {tag} at step {state.step}")

    n_epochs = epochs if epochs is not None else train_cfg.optim.epochs
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    log_path = os.path.join(log_dir, f"train_log_{stamp}.txt")
    tb = None
    try:  # TensorBoard scalars, the reference's tags; optional
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(os.path.join(log_dir, f"tb_{stamp}"))
    except ImportError:
        pass
    best_loss = float("inf")
    for epoch in range(n_epochs):
        loader.set_epoch(epoch)
        state, tm = train_one_epoch(state, loader, train_cfg.seed, epoch,
                                    train_cfg.log_every,
                                    grad_accum=train_cfg.grad_accum)
        em = evaluate(model, val_loader)
        lr = schedule(state.step)
        _log_line(log_path,
                  f"[epoch {epoch}] loss {tm.get('loss', 0):.6f} "
                  f"f1 {tm.get('f1', 0):.4f} "
                  f"mAP_196 {em['mAP_196patch']:.4f} "
                  f"mAP_16 {em['mAP_16patch']:.4f} lr {lr:.2e}")
        if tb is not None:
            tb.add_scalar("train_loss", tm.get("loss", 0.0), epoch)
            tb.add_scalar("f1_score", tm.get("f1", 0.0), epoch)
            # the reference logs the cls-head mAP under this tag
            tb.add_scalar("mAP_multiple_class_label", em["mAP_196patch"],
                          epoch)
            tb.add_scalar("learning_rate", lr, epoch)
        if tm.get("loss", float("inf")) < best_loss:
            best_loss = tm["loss"]
            ckptlib.save(train_cfg.ckpt_dir,
                         f"{stamp}-cur_ep{epoch}-bestloss", state)
    ckptlib.save(train_cfg.ckpt_dir, f"{stamp}-cur_ep{n_epochs - 1}-final",
                 state)
    if tb is not None:
        tb.close()
    return state
