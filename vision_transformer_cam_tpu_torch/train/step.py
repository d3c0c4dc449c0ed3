"""Train and eval steps (the port of vision_transformer_cam_tpu/train/step.py).

One step is: the training forward, the top-k-by-label-count multi-hot F1, the
dual multilabel-soft-margin loss, the backward (through the attention
backward kernel on the kernel path) and one AdamW update.  The steps make no
host sync: metrics come back as device tensors and the loop reads them.
"""

from __future__ import annotations

import torch

from vision_transformer_cam_tpu_torch.models.vit import _fold
from vision_transformer_cam_tpu_torch.ops.losses import (
    dual_head_loss, multilabel_soft_margin_loss)
from vision_transformer_cam_tpu_torch.train.state import TrainState


def topk_by_label_count(logits, labels):
    """Predict exactly k_i = sum(labels_i) classes per sample (the k_i
    highest logits) as a multi-hot tensor, by rank-thresholding the sorted
    order (a stable sort: ties keep the lower class index first)."""
    k = labels.sum(dim=-1, keepdim=True)
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(logits.shape[1], device=logits.device)
        .expand_as(order))
    return (ranks < k).to(logits.dtype)


def f1_micro(pred_multihot, labels):
    """Micro-averaged multi-label F1 over the batch."""
    tp = (pred_multihot * labels).sum()
    return 2.0 * tp / torch.clamp_min(pred_multihot.sum() + labels.sum(), 1.0)


def loss_fn(model, images, labels, rng):
    """(loss, (parts, logits)) of the training forward."""
    out = model.forward_train(images, rng=rng)
    loss, parts = dual_head_loss(out.logits, out.head1_logits, labels)
    if out.dist_logits is not None:
        # distilled: the dist head gets the same multilabel loss, so that it
        # trains (eval averages the two heads)
        loss = loss + multilabel_soft_margin_loss(out.dist_logits, labels)
    return loss, (parts, out.logits)


def _grads(model, images, labels, rng):
    loss, (parts, logits) = loss_fn(model, images, labels, rng)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        logits.detach(), grads


def _f1(logits, labels):
    # the metric in at least float32, whatever the compute dtype
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    labels = labels.to(logits.dtype)
    return f1_micro(topk_by_label_count(logits, labels), labels)


def _step_rng(rng, step):
    return None if rng is None else _fold(rng, step)


def train_step(state: TrainState, images, labels, rng=None):
    """One optimizer step on ``state.model`` (updated in place).  ``rng``: an
    integer seed for dropout, folded with the step; None leaves dropout off.
    Returns (new_state, metrics) with the metrics as device tensors."""
    loss, parts, logits, grads = _grads(state.model, images, labels,
                                        _step_rng(rng, state.step))
    state.optimizer.update(grads)
    return state._replace(step=state.step + 1), \
        {"loss": loss, "f1": _f1(logits, labels), **parts}


def train_step_accum(state: TrainState, images, labels, rng=None, *,
                     accum_steps: int):
    """``train_step`` with gradient accumulation: the batch is split into
    ``accum_steps`` microbatches run one after the other, their gradients
    summed in float32 (at least) and rounded once to the parameter dtype
    after the mean, then one optimizer update.  With zero dropout ratios
    this is the full-batch step exactly where samples do not couple (the
    dual loss is a sample mean); the batch-global mask norm is taken per
    microbatch."""
    b = images.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} not divisible by accum_steps "
                         f"{accum_steps}")
    mb = b // accum_steps
    params = list(state.model.parameters())
    acc = [torch.zeros(p.shape, device=p.device,
                       dtype=torch.promote_types(p.dtype, torch.float32))
           for p in params]
    step_rng = _step_rng(rng, state.step)
    loss_sum, parts_sum, all_logits = 0.0, {}, []
    for i in range(accum_steps):
        sl = slice(i * mb, (i + 1) * mb)
        loss, parts, logits, grads = _grads(
            state.model, images[sl], labels[sl],
            None if step_rng is None else _fold(step_rng, i))
        torch._foreach_add_(acc, [g.to(a.dtype) for g, a in zip(grads, acc)])
        loss_sum = loss_sum + loss
        for k, v in parts.items():
            parts_sum[k] = parts_sum.get(k, 0.0) + v
        all_logits.append(logits)
    inv = 1.0 / accum_steps
    state.optimizer.update([(a * inv).to(p.dtype)
                            for a, p in zip(acc, params)])
    metrics = {"loss": loss_sum * inv,
               "f1": _f1(torch.cat(all_logits), labels),
               **{k: v * inv for k, v in parts_sum.items()}}
    return state._replace(step=state.step + 1), metrics


def eval_step(model, images):
    """Sigmoid probabilities of both heads; AP / mAP runs on the host over
    the gathered outputs."""
    out = model(images)
    return {"probs_cls": torch.sigmoid(out.logits.float()),
            "probs_head1": torch.sigmoid(out.head1_logits.float())}
