"""Fine-tune entry (the port of vision_transformer_cam_tpu/cli/train.py).

The same hyperparameter surface as the reference argparse (timm-style names),
driving the loop in train/loop.py.  ``--freeze_layers`` and the lr scaling
lr * batch / 512 behave as the reference's; ``--syncBN`` is accepted and
ignored (the model has no BN).  ``--device`` is honoured: the card by
default, the CPU on request.

Data parallelism, the reference's DDP: one process per card under a launcher
that sets the ``torch.distributed`` environment, e.g.

    torchrun --nproc_per_node N -m vision_transformer_cam_tpu_torch.cli.train \
        --mesh_shape N [--zero1] ...

``--batch_size`` is the global batch (each rank loads batch / N of it) and
scales the lr as in JAX; ``--zero1`` shards the AdamW moments over the
ranks.  NCCL carries the collectives when each rank has a card of its own,
gloo otherwise (ranks that share one card, for correctness runs only).

Tensor parallelism: ``--mesh_shape d,m`` over d x m ranks, the ('data',
'model') mesh of JAX, each block's heads and MLP hidden units cut over the
m ranks of a model group.  The pipeline: ``--pipeline S`` over the
('data', 'stage') mesh (-1, S), the blocks cut into S stages,
``--pp_microbatches M`` microbatches a step (default S); it sets the
per-sample mask norm, as JAX does, and refuses ``--grad_accum`` /
``--zero1`` and nonzero drop ratios.  Sequence parallelism: ``--seq_parallel
N`` over the ('data', 'seq') mesh (-1, N), the token axis of every batch cut
over the N ranks of a seq group (``cfg.seq_axis``), e.g. on the CPU

    torchrun --nproc_per_node 4 -m vision_transformer_cam_tpu_torch.cli.train \
        --seq_parallel 2 --device cpu [--zero1] [--grad_accum 2] ...

It trains on the eager attention (the trainer's, and the JAX package's XLA
attention there); it and ``--pipeline`` are distinct layouts.
"""

from __future__ import annotations

import argparse
import os

import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.io import weights as wio
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.train import loop as looplib
from vision_transformer_cam_tpu_torch.utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name", type=str,
                   default="vit_base_patch16_224_in21k",
                   choices=sorted(configs.MODEL_ZOO)
                   + sorted(configs.MODEL_ALIASES))
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--opt_eps", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=5e-2)
    p.add_argument("--sched", type=str, default="cosine")
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--decay_epochs", type=float, default=30)
    p.add_argument("--decay_rate", type=float, default=0.1)
    p.add_argument("--cooldown_epochs", type=int, default=10)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--weights", type=str, default="",
                   help="pretrained .pth (head keys dropped on load) or a "
                        "checkpoint of this trainer (loaded verbatim)")
    p.add_argument("--freeze_layers", action="store_true")
    p.add_argument("--syncBN", action="store_true",
                   help="accepted for parity; no-op (model has no BN)")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--train_img_name_path", type=str, required=True)
    p.add_argument("--val_img_name_path", type=str, required=True)
    p.add_argument("--cls_labels_path", type=str, default="")
    p.add_argument("--ckpt_dir", type=str, default="./weights")
    p.add_argument("--log_dir", type=str, default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_shape", type=str, default="-1",
                   help="the mesh over the launched ranks: '-1' (all of "
                        "them data-parallel) or their count, or 'd,m' "
                        "(dp, tp: the ('data', 'model') mesh)")
    p.add_argument("--native_decode", action="store_true",
                   help="the C++ batched JPEG pipeline (PIL where the "
                        "library is unavailable)")
    p.add_argument("--resume", action="store_true",
                   help="resume full train state from the latest checkpoint")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step (use when the "
                        "effective batch exceeds the card's memory)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the AdamW moments over the data "
                        "ranks")
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="sequence parallelism: the token axis over N ranks "
                        "((-1, N) ('data', 'seq') mesh, eager attention); "
                        "overrides --mesh_shape")
    p.add_argument("--pipeline", type=int, default=0,
                   help="pipeline parallelism: the blocks over N stages "
                        "((-1, N) ('data', 'stage') mesh, GPipe schedule); "
                        "implies the per-sample mask norm, needs zero drop "
                        "ratios; overrides --mesh_shape")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipeline step (0 = stage count)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--local_rank", type=int, default=0,
                   help="this process's card on its host, as the legacy "
                        "torch.distributed.launch passes it (torchrun sets "
                        "LOCAL_RANK instead)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.local_rank and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(args.local_rank)
    device = resolve_device(args.device)
    model_cfg = configs.resolve_model(args.model_name)(
        num_classes=args.num_classes)
    if model_cfg.has_logits:
        model_cfg = model_cfg.replace(representation_size=None)

    optim = configs.OptimConfig(
        opt=args.opt, lr=args.lr, opt_eps=args.opt_eps,
        weight_decay=args.weight_decay, sched=args.sched,
        epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        warmup_lr=args.warmup_lr, min_lr=args.min_lr,
        decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
        cooldown_epochs=args.cooldown_epochs, clip_grad=args.clip_grad)
    if args.seq_parallel and args.pipeline:
        raise SystemExit("--seq_parallel and --pipeline are distinct mesh "
                         "layouts; pick one (dp composes with either)")
    if args.seq_parallel:
        # the (dp, sp) mesh; the config names the axes its forward reads
        mesh_shape, mesh_axes = (-1, args.seq_parallel), ("data", "seq")
        model_cfg = model_cfg.replace(data_axis="data", seq_axis="seq")
    elif args.pipeline:
        mesh_shape, mesh_axes = (-1, args.pipeline), ("data", "stage")
        # the microbatched carry: the per-sample mask norm (the reference's
        # batch-global max would make results depend on the microbatch count)
        model_cfg = model_cfg.replace(per_sample_mask_norm=True)
    else:
        mesh_shape = tuple(int(s) for s in args.mesh_shape.split(","))
        # the JAX CLI's axes: ('data',), ('data', 'model'), or ax0, ax1, ...
        mesh_axes = ("data", "model")[:len(mesh_shape)] \
            if len(mesh_shape) <= 2 \
            else tuple(f"ax{i}" for i in range(len(mesh_shape)))
    train_cfg = configs.TrainConfig(
        optim=optim, batch_size=args.batch_size, seed=args.seed,
        freeze_backbone=args.freeze_layers, ckpt_dir=args.ckpt_dir,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        grad_accum=args.grad_accum, zero1=args.zero1,
        pipeline=args.pipeline, pp_microbatches=args.pp_microbatches)
    looplib.check_supported(train_cfg)
    dc = dict(voc12_root=args.dataset_path,
              cls_labels_path=args.cls_labels_path,
              img_size=model_cfg.img_size,
              native_decode=args.native_decode)
    train_data = configs.DataConfig(
        img_name_list_path=args.train_img_name_path, **dc)
    val_data = configs.DataConfig(
        img_name_list_path=args.val_img_name_path, **dc)

    init_model = None
    if args.weights:
        # head-key surgery applies to reference-format .pth pretrained
        # checkpoints; the trainer's own checkpoints load verbatim
        init_model = ViTCAM(model_cfg, device=device,
                            generator=torch.Generator().manual_seed(args.seed))
        wio.load_weights(args.weights, init_model,
                         del_keys=wio.PRETRAIN_DEL_KEYS)

    return looplib.fit(model_cfg, train_cfg, train_data, val_data,
                       init_model=init_model, epochs=args.epochs,
                       log_dir=args.log_dir, resume=args.resume,
                       device=device)


if __name__ == "__main__":
    main()
