"""Pipeline parallelism over depth (the port of
vision_transformer_cam_tpu/parallel/pipeline.py): the blocks stage-sharded
over the 'stage' axis of a ('data', 'stage') mesh, microbatches handed from
stage to stage by point-to-point sends over the process group.

Stage s of S holds blocks [s L / S, (s + 1) L / S) (``stage_shard_params``)
and every other leaf (embedding, final LayerNorm, heads) whole, as JAX
places them.  The carry between blocks, (tokens, bg indicator, rollout
joint), is the model's only inter-layer state; it is what a stage sends to
the next.  Schedule: GPipe fill-and-drain.  Stage 0 embeds microbatch k and
runs its blocks while stage 1 runs microbatch k - 1, and so on; the last
stage collects the M outputs and computes the heads.  In training the
backward runs the microbatches in reverse, each stage sending the gradient
of its input to the stage before.

As in JAX: ``cfg.per_sample_mask_norm`` is required (the reference's
batch-global mask max would couple samples across microbatches, so the
result would depend on M); the blocks run the eager path (JAX refuses its
Pallas path here and runs XLA): no kernel is launched; no dropout rng
threads through the schedule; no remat.  With a data axis, rank (d, s)
takes microbatch rows k mb + d mb / dp + [0, mb / dp) of the global batch
(JAX's P(None, 'data') on [M, mb, ...], ``parallel.shard_batch(mesh, batch,
accum_steps=M)``); each rank passes its rows, and every stage of a data
group the same rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from vision_transformer_cam_tpu_torch.configs import ViTCAMConfig
from vision_transformer_cam_tpu_torch.models.vit import (
    ViTCAMOutput, _attention_eager, _ftz, _gelu, _layer_norm, _linear,
    _mask_from_cls_row, matmul_precision)
from vision_transformer_cam_tpu_torch.ops.losses import (
    dual_head_loss, multilabel_soft_margin_loss)
from vision_transformer_cam_tpu_torch.ops.rollout import aug_normalize
from vision_transformer_cam_tpu_torch.parallel.mesh import Layout, SeqMesh
from vision_transformer_cam_tpu_torch.train.state import TrainState
from vision_transformer_cam_tpu_torch.train.step import (_f1_counts, _f1_of,
                                                        _group_metrics,
                                                        average_grads)

_PARTS = ("loss_cls", "loss_head1")


def _check(cfg: ViTCAMConfig, mesh: SeqMesh, b: int,
           microbatches: Optional[int]) -> int:
    """The microbatch count, after JAX's refusals."""
    if not cfg.per_sample_mask_norm:
        raise ValueError(
            "pipeline_forward requires cfg.per_sample_mask_norm=True: the "
            "reference's batch-global mask max (vit_model.py:335) would "
            "couple samples across microbatches, making the output depend "
            "on the microbatch count.")
    if (cfg.attn_impl == "kernel" or cfg.attn_block_fusion or cfg.mlp_fusion
            or cfg.ln_quant_fusion or cfg.int8_fused_gemm):
        raise ValueError("pipeline_forward runs the eager block path; drop "
                         "the kernel knobs (attn_impl='kernel', "
                         "attn_block_fusion, mlp_fusion, ln_quant_fusion, "
                         "int8_fused_gemm).")
    _stage_mesh(mesh, "pipeline_forward")
    s = mesh.inner_size
    if cfg.depth % s:
        raise ValueError(f"depth {cfg.depth} not divisible by {s} stages")
    m = microbatches or s
    if b % m:
        raise ValueError(f"batch {b} (this rank's rows) not divisible by {m} "
                         "microbatches")
    return m


def _stage_mesh(mesh: SeqMesh, who: str):
    if mesh.axis_names[1:] != ("stage",):
        raise ValueError(f"{who} needs a ('data', 'stage') mesh, got axes "
                         f"{mesh.axis_names}")


def stage_shard_params(mesh: SeqMesh, model):
    """Keep on this rank only its stage's blocks of ``model`` (a
    ``models.vit.ViTCAM`` with all its blocks), in place: the others are
    dropped (``model.blocks[i]`` is None) and their memory freed; every
    other leaf stays whole.  The port of JAX ``stage_shard_params``."""
    _stage_mesh(mesh, "stage_shard_params")
    s, n = mesh.inner_rank, mesh.inner_size
    depth = model.cfg.depth
    if depth % n:
        raise ValueError(f"depth {depth} not divisible by {n} stages")
    lps = depth // n
    held = range(s * lps, (s + 1) * lps)
    for i in range(depth):
        if i not in held:
            model.blocks[i] = None
    model.layout = Layout(mesh, "stage", held=held)
    return model


def _block_apply(blk, tok, bg, joint, i: int, cfg: ViTCAMConfig,
                 need_rollout: bool):
    """One block and its mask update, on the eager path (JAX
    ``_block_apply``); ``i`` is the global layer index."""
    xn = _layer_norm(tok, blk.norm1.weight, blk.norm1.bias, cfg.ln_eps)
    o, cls_row, hm, _, _ = _attention_eager(
        blk.attn, xn, bg, cfg, "headmean" if need_rollout else None)
    tok = tok + o
    yn = _layer_norm(tok, blk.norm2.weight, blk.norm2.bias, cfg.ln_eps)
    hmid = _gelu(_linear(yn, blk.mlp.fc1, cfg), cfg.gelu_approx)
    tok = tok + _linear(hmid, blk.mlp.fc2, cfg)
    cls_row = _ftz(cls_row.detach())
    if i >= cfg.mask_from:
        _, bg = _mask_from_cls_row(cls_row, cfg)
    if need_rollout:
        pt = torch.promote_types(torch.float32, joint.dtype)
        joint = torch.matmul(aug_normalize(hm).to(pt),
                             joint.to(pt)).to(joint.dtype)
    return tok, bg, joint, cls_row


def _run_stage(model, x, cfg: ViTCAMConfig, mesh: SeqMesh, m: int,
               need_rollout: bool):
    """This stage's part of the fill-and-drain schedule over the ``m``
    microbatches of ``x``.  Returns (the received inputs, None on stage 0;
    the outputs; the cls rows of this stage's layers [L / S, B, N]; the
    joints)."""
    n_st, s = mesh.inner_size, mesh.inner_rank
    lps = cfg.depth // n_st
    mb, n, c = x.shape[0] // m, cfg.seq_len, cfg.embed_dim
    dev = x.device
    rdt = torch.float32 if cfg.dtype == torch.bfloat16 else cfg.dtype
    ins, outs, rows, joints = [], [], [], []
    for k in range(m):
        inp = None
        if s == 0:
            tok = model.embed_tokens(x[k * mb:(k + 1) * mb], cfg)
            bg = torch.zeros((mb, n), dtype=cfg.dtype, device=dev)
            joint = torch.eye(n, dtype=rdt, device=dev).expand(
                mb, n, n).contiguous() if need_rollout else None
        else:
            tok = mesh.stage_recv((mb, n, c), cfg.dtype, dev, s - 1)
            bg = mesh.stage_recv((mb, n), cfg.dtype, dev, s - 1)
            joint = mesh.stage_recv((mb, n, n), rdt, dev, s - 1) \
                if need_rollout else None
            if torch.is_grad_enabled():
                inp = tok.requires_grad_()
        layer_rows = []
        for li in range(lps):
            i = s * lps + li
            tok, bg, joint, row = _block_apply(model.blocks[i], tok, bg,
                                               joint, i, cfg, need_rollout)
            layer_rows.append(row)
        if s < n_st - 1:
            for t in (tok, bg) + ((joint,) if need_rollout else ()):
                mesh.stage_send(t, s + 1)
        ins.append(inp)
        outs.append(tok)
        rows.append(torch.stack(layer_rows))
        joints.append(joint)
    return ins, outs, torch.cat(rows, dim=1).contiguous(), joints


def pipeline_forward(model, x, cfg: ViTCAMConfig, mesh: SeqMesh, *,
                     microbatches: Optional[int] = None,
                     need_rollout: bool = False) -> ViTCAMOutput:
    """The CAM eval forward with the blocks over the 'stage' axis of
    ``mesh``: every stage of a data group calls it with the same rows ``x``
    [B, H, W, 3] and gets the same complete outputs (the fields a plain
    eager forward with ``need_rollout`` fills).  ``model``: stage-sharded
    (``stage_shard_params``) or whole (a stage then runs only its blocks);
    ``microbatches`` defaults to the stage count.  The last stage's tokens
    and rollout row are broadcast over the stage group and every stage
    computes the heads."""
    m = _check(cfg, mesh, x.shape[0], microbatches)
    last = mesh.inner_size - 1
    with torch.inference_mode(), matmul_precision(cfg):
        _, outs, rows, joints = _run_stage(model, x, cfg, mesh, m,
                                           need_rollout)
        cls_rows = mesh.all_gather(rows, dim=0)          # [L, B, N]
        b, n = x.shape[0], cfg.seq_len
        rdt = torch.float32 if cfg.dtype == torch.bfloat16 else cfg.dtype
        if mesh.inner_rank == last:
            tokens = torch.cat(outs)
            row = torch.cat([j[:, 0, :] for j in joints]) if need_rollout \
                else None
        else:
            tokens = torch.empty((b, n, cfg.embed_dim), dtype=cfg.dtype,
                                 device=x.device)
            row = torch.empty((b, n), dtype=rdt, device=x.device) \
                if need_rollout else None
        tokens = mesh.inner_broadcast(tokens, last)
        if need_rollout:
            row = mesh.inner_broadcast(row.contiguous(), last)
        return model._heads(cfg, tokens, cls_rows, row, False,
                            attn_headmean=None, attn_perhead=None,
                            block_outputs=None)


def pipeline_train_step(state: TrainState, images, labels, mesh: SeqMesh, *,
                        microbatches: Optional[int] = None):
    """One optimizer step through the pipeline (JAX ``pipeline_train_step``)
    on a stage-sharded model: every microbatch forward, the dual loss (and
    the distilled head's) on this rank's whole batch at the last stage, the
    backward in reverse microbatch order with each stage sending its input's
    gradient to the stage before; the gradients of the non-block leaves
    (stage 0 holds the embedding's, the last stage the heads') summed over
    the stage group, then every gradient averaged over the data group, then
    the clip over the whole gradient and AdamW (``train.state.Optimizer``).
    Deterministic: no rng, as in JAX.  Returns (new_state, metrics) with the
    global batch's metrics on every rank."""
    model = state.model
    cfg = model.cfg
    layout = getattr(model, "layout", None)
    if layout is None or layout.axis != "stage":
        raise ValueError("pipeline_train_step takes a stage-sharded model "
                         "(parallel.pipeline.stage_shard_params)")
    m = _check(cfg, mesh, images.shape[0], microbatches)
    s, last = mesh.inner_rank, mesh.inner_size - 1
    names, params = zip(*model.named_parameters())
    params = list(params)
    acc = [torch.zeros(p.shape, device=p.device,
                       dtype=torch.promote_types(p.dtype, torch.float32))
           for p in params]

    def add(grads):
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.to(a.dtype))

    wide = torch.float64 if cfg.dtype == torch.float64 else torch.float32
    with matmul_precision(cfg):
        ins, outs, rows, _ = _run_stage(model, images, cfg, mesh, m, False)
        cls_rows = mesh.all_gather(rows, dim=0)
        if s == last:
            out = model._heads(cfg, torch.cat(outs), cls_rows, None, True,
                               attn_headmean=None, attn_perhead=None,
                               block_outputs=None)
            loss, parts = dual_head_loss(out.logits, out.head1_logits,
                                         labels)
            if out.dist_logits is not None:
                loss = loss + multilabel_soft_margin_loss(out.dist_logits,
                                                          labels)
            got = [t for t in ins if t is not None]
            grads = torch.autograd.grad(loss, params + got,
                                        allow_unused=True)
            add(grads[:len(params)])
            for k in reversed(range(len(got))):
                mesh.stage_send(grads[len(params) + k], s - 1)
            vec = torch.cat([torch.stack([loss.detach()] + [
                parts[k].detach() for k in _PARTS]).to(wide),
                _f1_counts(out.logits.detach(), labels).to(wide)])
        else:
            for k in reversed(range(m)):
                d_out = mesh.stage_recv(outs[k].shape, outs[k].dtype,
                                        images.device, s + 1)
                inputs = params + ([ins[k]] if ins[k] is not None else [])
                grads = torch.autograd.grad(outs[k], inputs, d_out,
                                            allow_unused=True)
                add(grads[:len(params)])
                if ins[k] is not None:
                    mesh.stage_send(grads[-1], s - 1)
            vec = torch.empty(1 + len(_PARTS) + 3, dtype=wide,
                              device=images.device)
    # the non-block gradients: one stage's each, summed over the stage group
    whole = [i for i, name in enumerate(names) if not layout.is_part(name)]
    if mesh.inner_size > 1 and whole:
        flat = mesh.inner_sum(torch.cat([acc[i].reshape(-1) for i in whole]))
        off = 0
        for i in whole:
            acc[i] = flat[off:off + acc[i].numel()].view(acc[i].shape)
            off += acc[i].numel()
    grads = [a.to(p.dtype) for a, p in zip(acc, params)]
    if mesh.data_size > 1:
        grads = average_grads(grads, mesh)
    state.optimizer.update(grads)
    vec = mesh.inner_broadcast(vec, last)
    loss, part_vals, counts = vec[0], vec[1:1 + len(_PARTS)], vec[-3:]
    parts = dict(zip(_PARTS, part_vals))
    if mesh.data_size > 1:
        metrics = _group_metrics(mesh, loss, parts, counts)
    else:
        metrics = {"loss": loss, "f1": _f1_of(counts), **parts}
    return state._replace(step=state.step + 1), metrics
