"""Epoch-level training and evaluation (the port of
vision_transformer_cam_tpu/train/loop.py), on one device or data-parallel
over the ranks of a process group (the reference's DDP; the JAX package's
data mesh): one rank per device, each loading its rows of every global
batch, gradients averaged over the ranks, optionally the optimizer state
sharded (ZeRO-1).

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
from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
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
    """Raise for a layout the trainer does not run: it runs a ('data',)
    mesh of any size, with or without ZeRO-1; tensor, pipeline and
    sequence-parallel training are not ported."""
    item = "Queue 1 item 10, its second half"
    axes = tuple(train_cfg.mesh_axes)
    if axes != ("data",) or len(tuple(train_cfg.mesh_shape)) != 1:
        raise NotImplementedError(
            f"mesh_shape={train_cfg.mesh_shape!r} mesh_axes={axes!r}: the "
            f"trainer runs a ('data',) mesh; tensor-parallel ('model'), "
            f"pipeline ('stage') and sequence-parallel ('seq') training are "
            f"not ported yet (ROADMAP {item})")
    for name in ("pipeline", "pp_microbatches"):
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
    Rows the loader padded (``is_pad``, multi-process striping) are dropped,
    so every sample counts once.  Under data parallelism (an ambient mesh)
    every batch's labels, probabilities and pad marks are gathered over the
    data group before the mAP, as JAX's ``process_allgather`` does, so every
    rank returns the same mAP (over the rows in the one-process order: the
    loader gives each rank its rows of every global batch)."""
    device = next(model.parameters()).device
    mesh = meshlib.ambient_mesh()
    labels, p_cls, p_h1, keeps = [], [], [], []
    for batch in device_prefetch(loader, device):
        out = eval_step(model, batch["image"])
        keep = torch.from_numpy((~np.asarray(batch["is_pad"])).astype(
            np.uint8)) if "is_pad" in batch else torch.ones(
            len(batch["label"]), dtype=torch.uint8)
        rows = [batch["label"], out["probs_cls"], out["probs_head1"],
                keep.to(device)]
        if mesh is not None:
            rows = [mesh.data_all_gather(r) for r in rows]
        for acc, r in zip((labels, p_cls, p_h1, keeps), rows):
            acc.append(r.cpu().numpy())
    y, pc, ph, keep = (np.concatenate(v)
                       for v in (labels, p_cls, p_h1, keeps))
    keep = keep.astype(bool)
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
    """Full fine-tune entry: joins the process group the environment
    describes (``parallel.distributed_init``; one process without one),
    builds the ('data',) mesh of ``train_cfg.mesh_shape`` over it, the
    loaders (each rank its rows of every global batch of
    ``train_cfg.batch_size``), the model (``init_model``, or a fresh
    ``ViTCAM`` seeded with ``train_cfg.seed``) on ``device`` (the card
    unless asked otherwise), the optimizer (ZeRO-1 with ``train_cfg.zero1``)
    and the schedule, scaled by the global batch as in JAX; trains
    ``epochs`` epochs with an evaluation and a log line after each, saving
    the best-train-loss and the final checkpoint; ``resume`` continues from
    the newest checkpoint in ``train_cfg.ckpt_dir``.  Only the main process
    writes logs and checkpoints.  Returns the state."""
    check_supported(train_cfg)
    device = resolve_device(device)
    meshlib.distributed_init(device)
    mesh = meshlib.make_mesh(train_cfg.mesh_shape, train_cfg.mesh_axes)
    dp, rank = mesh.data_size, mesh.data_rank
    is_main = meshlib.is_main_process()
    if train_cfg.batch_size % (dp * train_cfg.grad_accum):
        raise ValueError(
            f"batch_size {train_cfg.batch_size} (the global batch) is not "
            f"divisible by {dp} rank(s) x grad_accum {train_cfg.grad_accum}")
    stripe = dict(process_index=rank, process_count=dp)
    loader = BatchLoader(_dataset(train_data), train_cfg.batch_size // dp,
                         shuffle=True, seed=train_cfg.seed,
                         num_threads=train_data.num_threads,
                         native_decode=train_data.native_decode,
                         microbatches=train_cfg.grad_accum, **stripe)
    val_loader = BatchLoader(_dataset(val_data), train_cfg.batch_size // dp,
                             shuffle=False, drop_last=False,
                             num_threads=val_data.num_threads,
                             native_decode=val_data.native_decode, **stripe)
    model = init_model if init_model is not None else ViTCAM(
        model_cfg, device=device,
        generator=torch.Generator().manual_seed(train_cfg.seed))
    model.to(device)
    if dp > 1:
        # every rank starts from data rank 0's parameters, as DDP does
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(mesh.data_broadcast(p.detach()))
        print(f"data parallelism: {dp} ranks, this rank {rank}; "
              f"collectives: {mesh.transport(device)}"
              + ("; ZeRO-1 optimizer state" if train_cfg.zero1 else ""),
              flush=True)
    mask = trainable_mask(model, train_cfg.freeze_backbone)
    optimizer, schedule = make_optimizer(
        model, train_cfg.optim, train_cfg.batch_size, max(len(loader), 1),
        freeze_mask=mask if train_cfg.freeze_backbone else None,
        zero1_mesh=mesh if train_cfg.zero1 else None)
    state = create_train_state(model, optimizer)
    if resume:
        tag = ckptlib.latest_tag(train_cfg.ckpt_dir)
        if tag:
            state = ckptlib.restore(train_cfg.ckpt_dir, tag, state)
            print(f"resumed from {tag} at step {state.step}")

    n_epochs = epochs if epochs is not None else train_cfg.optim.epochs
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    log_path = os.path.join(log_dir, f"train_log_{stamp}.txt") \
        if is_main else None
    tb = None
    if is_main:
        os.makedirs(log_dir, exist_ok=True)
        try:  # TensorBoard scalars, the reference's tags; optional
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(os.path.join(log_dir, f"tb_{stamp}"))
        except ImportError:
            pass
    best_loss = float("inf")
    with meshlib.set_mesh(mesh if dp > 1 else None):
        for epoch in range(n_epochs):
            loader.set_epoch(epoch)
            state, tm = train_one_epoch(state, loader, train_cfg.seed, epoch,
                                        train_cfg.log_every if is_main
                                        else 0,
                                        grad_accum=train_cfg.grad_accum)
            em = evaluate(model, val_loader)
            lr = schedule(state.step)
            if is_main:
                _log_line(log_path,
                          f"[epoch {epoch}] loss {tm.get('loss', 0):.6f} "
                          f"f1 {tm.get('f1', 0):.4f} "
                          f"mAP_196 {em['mAP_196patch']:.4f} "
                          f"mAP_16 {em['mAP_16patch']:.4f} lr {lr:.2e}")
            if tb is not None:
                tb.add_scalar("train_loss", tm.get("loss", 0.0), epoch)
                tb.add_scalar("f1_score", tm.get("f1", 0.0), epoch)
                # the reference logs the cls-head mAP under this tag
                tb.add_scalar("mAP_multiple_class_label",
                              em["mAP_196patch"], epoch)
                tb.add_scalar("learning_rate", lr, epoch)
            # the loss is the global batch's on every rank, so every rank
            # takes the same branch (saving is collective under ZeRO-1)
            if tm.get("loss", float("inf")) < best_loss:
                best_loss = tm["loss"]
                ckptlib.save(train_cfg.ckpt_dir,
                             f"{stamp}-cur_ep{epoch}-bestloss", state)
        ckptlib.save(train_cfg.ckpt_dir,
                     f"{stamp}-cur_ep{n_epochs - 1}-final", state)
    if tb is not None:
        tb.close()
    return state
