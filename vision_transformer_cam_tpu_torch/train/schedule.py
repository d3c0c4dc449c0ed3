"""LR schedule matching the reference's timm ``create_scheduler`` setup.

The reference builds a timm CosineLRScheduler from its argparse defaults
(sched=cosine, warmup 5 epochs from warmup_lr 1e-6, min_lr 1e-5) and steps it
once per epoch, so the LR is piecewise constant within an epoch.  This is
that curve as a plain function of the global step: resumable by construction.
"""

from __future__ import annotations

import math

from vision_transformer_cam_tpu_torch.configs import OptimConfig


def scaled_base_lr(cfg: OptimConfig, global_batch_size: int) -> float:
    """Linear LR scaling lr * batch / 512."""
    if cfg.linear_lr_scaling:
        return cfg.lr * global_batch_size / 512.0
    return cfg.lr


def timm_cosine_schedule(cfg: OptimConfig, base_lr: float,
                         steps_per_epoch: int):
    """timm CosineLRScheduler(t_in_epochs=True) semantics, as the reference
    builds it: warmup_prefix=False, cycle_mul=1, cycle_limit=1.

      epoch <  warmup:           warmup_lr + epoch/warmup * (lr - warmup_lr)
      warmup <= epoch < epochs:  min_lr + (lr - min_lr)/2 * (1 + cos(pi u)),
                                 u = epoch / epochs (the cosine runs over the
                                 full ``epochs`` including the warm-up)
      epoch >= epochs:           min_lr

    Returns schedule(step) -> float for an integer global step."""
    warm, total = float(cfg.warmup_epochs), float(cfg.epochs)

    def schedule(step: int) -> float:
        epoch = float(step // steps_per_epoch)
        if epoch < warm:
            return cfg.warmup_lr + epoch / max(warm, 1.0) \
                * (base_lr - cfg.warmup_lr)
        u = min(max(epoch / max(total, 1.0), 0.0), 1.0)
        return cfg.min_lr + 0.5 * (base_lr - cfg.min_lr) \
            * (1.0 + math.cos(math.pi * u))

    return schedule
