"""Train and eval steps (the port of vision_transformer_cam_tpu/train/step.py).

One step is: the training forward, the top-k-by-label-count multi-hot F1, the
dual multilabel-soft-margin loss, the backward (through the attention
backward kernel on the kernel path) and one AdamW update.  The steps make no
host sync: metrics come back as device tensors and the loop reads them.

Under an ambient mesh whose data axis spans several ranks (data parallelism,
``parallel.set_mesh(parallel.make_mesh(...))``) each rank passes its rows of
the global batch (``parallel.shard_batch``; ``data.loader.BatchLoader`` with
``process_count``).  The step is then JAX's GSPMD step written out: the
forward's batch-global mask max is all-reduced over the data group
(``models.vit._mask_from_cls_row``), the gradients are averaged over it in
float32 (at least) buckets before the optimizer (so that the clip sees the
global gradient's norm), and the loss, its parts and the F1 counts are
reduced, so every rank returns the global batch's metrics.  Equal local
batches make the mean of the local mean-losses' gradients the full-batch
gradient: the dual loss is a sample mean.  Dropout draws per rank (the data
rank is folded into the step's seed).

Under sequence parallelism (``cfg.seq_axis``, the ('data', 'seq') grid)
the ranks of a sequence group pass the same rows and each runs the forward
on its rows of the token axis.  Their gradients of the parameters used on
those rows (``models.vit.SEQ_ROW_PARAMS``: the blocks, the patch embedding,
the position embedding and the prefix tokens) are shares of the gradient
and are summed over the group, in float32 (at least) buckets; the final
norm and the heads act on the gathered tokens, so every rank holds their
whole gradient, which is not summed.  Then comes the data-group mean, then
the clip.  Every rank of a group draws the same dropout masks.
"""

from __future__ import annotations

import torch

from vision_transformer_cam_tpu_torch.models.vit import (SEQ_ROW_PARAMS,
                                                        _fold,
                                                        matmul_precision)
from vision_transformer_cam_tpu_torch.ops.losses import (
    dual_head_loss, multilabel_soft_margin_loss)
from vision_transformer_cam_tpu_torch.parallel.mesh import (ambient_mesh,
                                                            current_mesh)
from vision_transformer_cam_tpu_torch.train.state import TrainState

# elements per gradient all-reduce (64 MiB of float32)
GRAD_BUCKET = 1 << 24


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


def _f1_sums(pred_multihot, labels):
    """(true positives, predicted positives, positive labels): the micro
    F1's three sums, which add over ranks."""
    return torch.stack([(pred_multihot * labels).sum(), pred_multihot.sum(),
                        labels.sum()])


def _f1_of(sums):
    tp, pred, true = sums
    return 2.0 * tp / torch.clamp_min(pred + true, 1.0)


def f1_micro(pred_multihot, labels):
    """Micro-averaged multi-label F1 over the batch."""
    return _f1_of(_f1_sums(pred_multihot, labels))


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
    # the backward's GEMMs at the forward's precision (cfg.matmul_precision)
    with matmul_precision(model.cfg):
        loss, (parts, logits) = loss_fn(model, images, labels, rng)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        logits.detach(), grads


def _f1_counts(logits, labels):
    """``_f1_sums`` of the top-k multi-hot prediction, in at least float32
    whatever the compute dtype."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    labels = labels.to(logits.dtype)
    return _f1_sums(topk_by_label_count(logits, labels), labels)


def _step_rng(rng, step):
    if rng is None:
        return None
    mesh = ambient_mesh()
    seed = _fold(rng, step)
    return seed if mesh is None else _fold(seed, mesh.data_rank)


def _bucketed(grads, reduce):
    """``reduce`` of every gradient: flattened into buckets of at most
    ``GRAD_BUCKET`` elements in the gradient's dtype promoted to float32 at
    least (float64 stays float64), one collective a bucket, then cast
    back."""
    out = list(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        wide = torch.promote_types(g.dtype, torch.float32)
        by_dtype.setdefault(wide, []).append(i)
    for wide, idx in by_dtype.items():
        buckets, cur, size = [], [], 0
        for i in idx:
            if cur and size + grads[i].numel() > GRAD_BUCKET:
                buckets.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += grads[i].numel()
        buckets.append(cur)
        for bucket in buckets:
            flat = reduce(torch.cat([grads[i].reshape(-1).to(wide)
                                     for i in bucket]))
            off = 0
            for i in bucket:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape) \
                    .to(grads[i].dtype)
                off += n
    return out


def average_grads(grads, mesh):
    """Every gradient's mean over the data group of ``mesh``, in float32 (at
    least) buckets (``_bucketed``).  Every rank gets the same bits."""
    return _bucketed(grads, lambda f: mesh.data_sum(f) / mesh.data_size)


def seq_sum_grads(model, grads, mesh):
    """The gradients of ``model``'s parameters used on the rank's rows of
    the token axis (``SEQ_ROW_PARAMS``) summed over the sequence group of
    ``mesh`` in float32 (at least) buckets; the others as they are (whole
    on every rank).  Every rank gets the same bits."""
    idx = [i for i, (name, _) in enumerate(model.named_parameters())
           if name.startswith(SEQ_ROW_PARAMS)]
    out = list(grads)
    for i, g in zip(idx, _bucketed([grads[i] for i in idx],
                                   mesh.inner_sum)):
        out[i] = g
    return out


def _reduce_grads(model, grads):
    """The step's gradients from the rank's: summed over the sequence group
    (``seq_sum_grads``) where the model's token axis is sharded, averaged
    over the data group (``average_grads``) where the batch is."""
    seq = model.cfg.seq_axis
    if seq and current_mesh(seq).inner_size > 1:
        grads = seq_sum_grads(model, grads, current_mesh(seq))
    mesh = ambient_mesh()
    return grads if mesh is None else average_grads(grads, mesh)


def _group_metrics(mesh, loss, parts, counts):
    """The global batch's metrics from each rank's local loss, parts (local
    means over equal batches) and F1 counts, in one all-reduce."""
    names = list(parts)
    wide = torch.promote_types(counts.dtype, torch.float64 if
                               loss.dtype == torch.float64 else torch.float32)
    vec = torch.cat([torch.stack([loss.to(wide)]
                                 + [parts[k].to(wide) for k in names]),
                     counts.to(wide)])
    vec = mesh.data_sum(vec)
    k = 1 + len(names)
    means = vec[:k] / mesh.data_size
    return {"loss": means[0], "f1": _f1_of(vec[k:]),
            **{name: means[1 + j] for j, name in enumerate(names)}}


def train_step(state: TrainState, images, labels, rng=None):
    """One optimizer step on ``state.model`` (updated in place).  ``rng``: an
    integer seed for dropout, folded with the step; None leaves dropout off.
    Returns (new_state, metrics) with the metrics as device tensors."""
    mesh = ambient_mesh()
    loss, parts, logits, grads = _grads(state.model, images, labels,
                                        _step_rng(rng, state.step))
    state.optimizer.update(_reduce_grads(state.model, grads))
    if mesh is None:
        return state._replace(step=state.step + 1), \
            {"loss": loss, "f1": _f1_of(_f1_counts(logits, labels)),
             **parts}
    return state._replace(step=state.step + 1), \
        _group_metrics(mesh, loss, parts, _f1_counts(logits, labels))


def train_step_accum(state: TrainState, images, labels, rng=None, *,
                     accum_steps: int):
    """``train_step`` with gradient accumulation: the batch is split into
    ``accum_steps`` microbatches run one after the other, their gradients
    summed in float32 (at least) and rounded once to the parameter dtype
    after the mean, then one optimizer update.  With zero dropout ratios
    this is the full-batch step exactly where samples do not couple (the
    dual loss is a sample mean); the batch-global mask norm is taken per
    microbatch.

    Under data parallelism microbatch k is rows [k mb, (k+1) mb) of the
    global batch split over the ranks, as JAX's reshape to [accum, B /
    accum] with the constraint P(None, 'data') makes it: each rank must pass
    its stripe of every microbatch, microbatch after microbatch
    (``parallel.shard_batch(mesh, batch, accum_steps)``, or the loader with
    ``process_count`` and ``microbatches=accum_steps``, which is what
    ``train.loop.fit`` uses).  The step then cuts the local batch into
    consecutive microbatches; the summed gradients are all-reduced once."""
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
    mesh = ambient_mesh()
    acc = _reduce_grads(state.model, acc)
    state.optimizer.update([(a * inv).to(p.dtype)
                            for a, p in zip(acc, params)])
    if mesh is not None:
        return state._replace(step=state.step + 1), _group_metrics(
            mesh, loss_sum * inv, {k: v * inv for k, v in parts_sum.items()},
            _f1_counts(torch.cat(all_logits), labels))
    metrics = {"loss": loss_sum * inv,
               "f1": _f1_of(_f1_counts(torch.cat(all_logits), labels)),
               **{k: v * inv for k, v in parts_sum.items()}}
    return state._replace(step=state.step + 1), metrics


def eval_step(model, images):
    """Sigmoid probabilities of both heads; AP / mAP runs on the host over
    the gathered outputs."""
    out = model(images)
    return {"probs_cls": torch.sigmoid(out.logits.float()),
            "probs_head1": torch.sigmoid(out.head1_logits.float())}
