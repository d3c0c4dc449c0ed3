"""Multi-rank dry run (the port's counterpart of
``__graft_entry__.dryrun_multichip``, for what the port has of it).

Spawns ``--world`` ranks on one host (``parallel.worker.launch``, each
running ``dp_rank``; gloo on the CPU or where ranks share the card), with a
tiny model on the kernel path at float32 (the JAX dry run's img 32, patch
8, depth 6, mask from block 2, top-4 patches, with C 256 in 4 heads of 64,
a width the CUDA kernels are compiled for, where JAX takes 4 heads of 16:
under tensor parallelism over 2 ranks each runs 2 heads of 64), a global
batch of 2 rows a rank, and holds each result to the one-rank result
computed in this process.  On the ('data',) mesh of the world:

  1. a data-parallel train step (loss, and every parameter's change);
  2. two accumulation steps under data parallelism against the full-batch
     data-parallel step;
  3. a ZeRO-1 step against the unsharded data-parallel step (bit for bit),
     each rank holding 1 / world of the AdamW moments;
  4. batch-sharded CAM extraction (the rollout CAM of each rank's rows).

On the (dp, tp) ('data', 'model') mesh (tp 2 where the world is even, as
JAX picks it; the model sharded by ``parallel.shard_params``):

  5. the tensor-parallel train step against one rank;
  6. accumulation 2 under the mesh against its full-batch step;
  7. ZeRO-1 over dp x tp against its step, bit for bit;
  8. CAM extraction at float32 against one rank.

On the (dp, 2) ('data', 'stage') mesh, the model on the eager path with the
per-sample mask norm (``parallel.pipeline``):

  9. ``pipeline_forward`` with ``need_rollout`` and 2 microbatches against
     the one-rank forward (logits and rollout row);
  10. one ``pipeline_train_step`` against one-rank ``train_step``.

On the (dp, 2) ('data', 'seq') mesh (``parallel.apply_seq_parallel``; N =
17 pads to 18, so the halves are 9 rows each and the last row of the
second is padding):

  11. CAM extraction on the eager path against the one-rank eager path;
  12. CAM extraction on the kernel path (the sequence-parallel kernel, one
      call a block) against the one-rank kernel path;
  13. one sequence-parallel train step (the eager path) against the
      one-rank step (the JAX dry run only asks for a finite loss there).

The ranks of a data group (and, for the leaves every rank holds whole, of
the whole world) must hold bit for bit equal parameters after every step.
The optimizer is AdamW with eps 1 and lr 1 and no decay, so that a first
step's change is -g / (|g| + 1), a contraction of the gradient: the
tolerance on the changes is one on the gradients.

    python -m vision_transformer_cam_tpu_torch.scripts.dryrun_multichip \\
        [--world 2] [--device cpu]

prints one JSON line of the deviations and returns it as a dict.
``train_steps`` is the data-parallel training run of one rank that
``dp_rank`` takes three times; the tests and the smoke run call it from
their own rank functions.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
from vision_transformer_cam_tpu_torch.kernels import attention as ka
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops.rollout import cam_from_rollout_row
from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.train import checkpoint as ckptlib
from vision_transformer_cam_tpu_torch.train import state as statelib
from vision_transformer_cam_tpu_torch.train import step as steplib
from vision_transformer_cam_tpu_torch.utils import resolve_device

# one float32 step, rank-split against one rank: loss, and the parameter
# changes at the tolerance of the smoke run's gradients (TRAIN_TOL)
TOL = {"loss": 1e-5, "delta": (2e-5, 1e-3), "cam": (1e-5, 1e-4)}
OPTIM = dict(lr=1.0, opt_eps=1.0, weight_decay=0.0, warmup_epochs=0,
             epochs=10, linear_lr_scaling=False)


def tiny_config() -> configs.ViTCAMConfig:
    return configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=256,
                                depth=6, num_heads=4, num_classes=20,
                                mask_from=2, top_k_patches=4,
                                attn_impl="kernel")


def delta_excess(got, want, before, tol=TOL["delta"]):
    """(max abs deviation of the changes, names past atol + rtol |change|)
    of two parameter dicts from the same ``before``."""
    atol, rtol = tol
    worst, bad = 0.0, []
    for k, b in before.items():
        dg, dw = got[k].double() - b.double(), want[k].double() - b.double()
        err = (dg - dw).abs()
        worst = max(worst, float(err.max()))
        if float((err - atol - rtol * dw.abs()).max()) > 0:
            bad.append(k)
    return worst, bad


def host_state(sd):
    """A state dict's tensors on the host."""
    return {k: v.detach().cpu() for k, v in sd.items()}


def param_digest(model, whole_only: bool = False) -> str:
    """sha256 of every parameter's bytes, in ``named_parameters`` order:
    equal digests are bit-equal parameters.  ``whole_only``: only the
    leaves a sharded model holds whole on every rank (its
    ``layout.is_part`` is false)."""
    layout = getattr(model, "layout", None)
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        if whole_only and layout is not None and layout.is_part(name):
            continue
        h.update(p.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def train_steps(cfg, state_dict, batches, mesh, *, optim, global_batch,
                device, zero1=False, accum_steps=1, steps=None,
                steps_per_epoch=100, rng=None, restore=None):
    """Training on this rank of ``mesh`` (a ('data',) or ('data', 'model')
    mesh of the process group every rank has joined): the model of ``cfg``
    from ``state_dict`` (sharded over a 'model' axis,
    ``parallel.shard_params``), AdamW of ``optim`` with the schedule scaled
    by ``global_batch`` (the moments sharded over the data ranks with
    ``zero1``), and ``steps`` train steps (default one a batch; the batches
    cycle) on this rank's rows of the global batches ``batches`` ([(images,
    labels)], CPU tensors; ``accum_steps`` microbatches a step; ``rng``
    the dropout seed; ``restore`` (ckpt_dir, tag): the state restored from
    that checkpoint before the first step).  Returns
    (state, result): ``metrics``, ``launches`` (kernel 1 and the backward),
    ``heads`` (the head counts kernel 1 and the backward ran at),
    ``digests`` (``param_digest``) and ``whole_digests`` (of the leaves
    every rank holds whole) per step, and ``moment_elements`` /
    ``moment_bytes`` of the optimizer state and ``param_bytes`` of the
    parameters this rank holds."""
    model = ViTCAM(cfg, device=device)
    load_state_dict(model, state_dict)
    meshlib.shard_params(mesh, model, "model")
    opt, _ = statelib.make_optimizer(model, optim, global_batch,
                                     steps_per_epoch,
                                     zero1_mesh=mesh if zero1 else None)
    state = statelib.create_train_state(model, opt)
    if restore is not None:
        state = ckptlib.restore(*restore, state)
    local = [tuple(meshlib.shard_batch(mesh, t, accum_steps).to(device)
                   for t in b) for b in batches]
    res = {"metrics": [], "digests": [], "whole_digests": [], "launches": [],
           "heads": []}
    with meshlib.set_mesh(mesh), heads_seen() as heads:
        for i in range(len(local) if steps is None else steps):
            ka.launches = ka.bwd_launches = 0
            heads.clear()
            x, y = local[i % len(local)]
            if accum_steps > 1:
                state, m = steplib.train_step_accum(state, x, y, rng,
                                                    accum_steps=accum_steps)
            else:
                state, m = steplib.train_step(state, x, y, rng)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["launches"].append(
                {"masked_attention_fused": ka.launches,
                 "masked_attention_bwd": ka.bwd_launches})
            res["heads"].append(sorted(heads))
            res["digests"].append(param_digest(model))
            res["whole_digests"].append(param_digest(model, whole_only=True))
    res["moment_elements"] = opt.moment_elements()
    res["moment_bytes"] = 2 * sum(t.numel() * t.element_size()
                                  for t in opt.mu)
    res["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    return state, res


@contextlib.contextmanager
def calls_seen(module, name):
    """A list that ``module.name`` appends to at each call while it is
    open (a spy; on the CPU the wrappers count no launch)."""
    seen = []
    orig = getattr(module, name)

    def call(*a, **kw):
        seen.append(1)
        return orig(*a, **kw)
    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def heads_seen():
    """The set of head counts kernel 1 and the backward are called with
    while it is open (a spy on the two wrappers of ``kernels.attention``)."""
    seen = set()
    orig = {name: getattr(ka, name) for name in
            ("masked_attention_fused", "masked_attention_bwd")}

    def spy(fn):
        def call(*a, **kw):
            seen.add(kw["num_heads"])
            return fn(*a, **kw)
        return call
    for name, fn in orig.items():
        setattr(ka, name, spy(fn))
    try:
        yield seen
    finally:
        for name, fn in orig.items():
            setattr(ka, name, fn)


def _runs(cfg, state_dict, x, y, optim, device, mesh, out, prefix):
    """The train step, accumulation 2 and the ZeRO-1 step on ``mesh``, each
    from ``state_dict`` on this rank's rows of (x, y), into ``out``, and
    the CAMs of this rank's rows."""
    for name, kw in (("", {}), ("accum2", dict(accum_steps=2)),
                     ("zero1", dict(zero1=True))):
        state, res = train_steps(cfg, state_dict, [(x, y)], mesh,
                                 optim=optim, global_batch=x.shape[0],
                                 device=device, **kw)
        res["state"] = host_state(meshlib.full_state_dict(state.model))
        out[f"{prefix}_{name}" if name else prefix] = res
    model = ViTCAM(cfg.replace(data_axis="data"), device=device)
    load_state_dict(model, state_dict)
    meshlib.shard_params(mesh, model, "model")
    with meshlib.set_mesh(mesh):
        row = model(meshlib.shard_batch(mesh, x).to(device),
                    need_rollout=True).rollout_row
    out[f"{prefix}_cam"] = cam_from_rollout_row(row, cfg.grid_size).cpu()


def pp_config(cfg):
    """The pipeline's config: the eager path with the per-sample norm."""
    return cfg.replace(attn_impl="eager", per_sample_mask_norm=True)


def dp_rank(cfg, state_dict, x, y, optim, device):
    """One rank of the dry run (``parallel.worker.launch``): on the ('data',)
    mesh of the world, then on the (dp, tp) ('data', 'model') mesh, the
    step, accumulation 2 and the ZeRO-1 step, each from ``state_dict`` on
    this rank's rows of the global batch (x, y), and the CAMs of this rank's
    rows; then on the (dp, 2) ('data', 'stage') mesh the pipeline forward
    and one pipeline step, and on the (dp, 2) ('data', 'seq') mesh the CAMs
    on both attention paths and one step.  Returns every run's result with
    its final parameters in the one-rank layout, the CAMs and the
    transport."""
    from vision_transformer_cam_tpu_torch.models import vit
    from vision_transformer_cam_tpu_torch.parallel import pipeline
    meshlib.distributed_init(device)
    world = meshlib.get_world_size()
    mesh = meshlib.make_mesh((-1,), ("data",))
    out = {"transport": mesh.transport(device)}
    _runs(cfg, state_dict, x, y, optim, device, mesh, out, "dp")
    tp = 2 if world % 2 == 0 else 1
    mesh = meshlib.make_mesh((world // tp, tp), ("data", "model"))
    out["tp_shape"] = (world // tp, tp)
    _runs(cfg, state_dict, x, y, optim, device, mesh, out, "tp")
    if world % 2:
        return out
    mesh = meshlib.make_mesh((world // 2, 2), ("data", "stage"))
    pcfg = pp_config(cfg)
    model = ViTCAM(pcfg, device=device)
    load_state_dict(model, state_dict)
    pipeline.stage_shard_params(mesh, model)
    xs, ys = (meshlib.shard_batch(mesh, t, 2).to(device) for t in (x, y))
    ka.launches = ka.bwd_launches = 0
    res = pipeline.pipeline_forward(model, xs, pcfg, mesh, microbatches=2,
                                    need_rollout=True)
    out["pp_fwd"] = {"logits": res.logits.cpu(),
                     "rollout_row": res.rollout_row.cpu()}
    opt, _ = statelib.make_optimizer(model, optim, x.shape[0], 100)
    state = statelib.create_train_state(model, opt)
    with meshlib.set_mesh(mesh):
        state, m = pipeline.pipeline_train_step(state, xs, ys, mesh,
                                                microbatches=2)
    out["pp_step"] = {
        "metrics": {k: float(v) for k, v in m.items()},
        "launches": ka.launches + ka.bwd_launches,
        "blocks": sorted({int(n.split(".")[1]) for n, _ in
                          model.named_parameters()
                          if n.startswith("blocks.")}),
        "whole_digest": param_digest(model, whole_only=True),
        "state": host_state(meshlib.full_state_dict(model))}

    mesh = meshlib.make_mesh((world // 2, 2), ("data", "seq"))
    xs = meshlib.shard_batch(mesh, x).to(device)
    for impl in ("eager", "kernel"):
        scfg = meshlib.apply_seq_parallel(cfg.replace(attn_impl=impl))
        model = ViTCAM(scfg, device=device)
        load_state_dict(model, state_dict)
        with meshlib.set_mesh(mesh), \
                calls_seen(vit, "masked_attention_seq") as calls:
            row = model(xs, need_rollout=True).rollout_row
        out[f"sp_cam_{impl}"] = cam_from_rollout_row(row, cfg.grid_size).cpu()
        out[f"sp_calls_{impl}"] = len(calls)
    state, res = train_steps(sp_config(cfg), state_dict, [(x, y)], mesh,
                             optim=optim, global_batch=x.shape[0],
                             device=device)
    res["state"] = host_state(meshlib.full_state_dict(state.model))
    out["sp"] = res
    return out


def sp_config(cfg):
    """The sequence-parallel training config: the eager path."""
    return meshlib.apply_seq_parallel(cfg.replace(attn_impl="eager"))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default: every rank on the card) or 'cpu'")
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    world, batch = args.world, 2 * args.world
    cfg = tiny_config()
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.img_size, cfg.img_size, 3), dtype=np.float32))
    y = (torch.from_numpy(rng.random((batch, cfg.num_classes))) < 0.2) \
        .float()
    y[:, 0] = 1.0
    optim = configs.OptimConfig(**OPTIM)
    ranks = launch(dp_rank, (cfg, before, x, y, optim, str(device)),
                   world=world, timeout=args.timeout)
    failures = []
    tp = ranks[0]["tp_shape"][1]
    for pre in ("dp", "tp"):
        n_part = tp if pre == "tp" else 1
        for name in (pre, f"{pre}_accum2", f"{pre}_zero1"):
            # a data group holds the same parts, every rank the same whole
            # leaves
            if any(r[name]["digests"] != ranks[i % n_part][name]["digests"]
                   for i, r in enumerate(ranks)) or any(
                    r[name]["whole_digests"] != ranks[0][name]["whole_digests"]
                    for r in ranks):
                failures.append(f"{name}: the ranks' parameters differ")

    # the one-rank steps in this process
    def one_step(c, x, y):
        m_ = ViTCAM(c, device=device)
        m_.load_state_dict(before)
        opt, _ = statelib.make_optimizer(m_, optim, batch, 100)
        state = statelib.create_train_state(m_, opt)
        state, m = steplib.train_step(state, x.to(device), y.to(device))
        return {k: v.detach().cpu() for k, v in m_.state_dict().items()}, \
            float(m["loss"])
    one, one_loss = one_step(cfg, x, y)
    out = {"world": world, "device": str(device),
           "transport": ranks[0]["transport"],
           "tp_shape": list(ranks[0]["tp_shape"])}
    model.load_state_dict(before)
    want_cam = cam_from_rollout_row(
        model(x.to(device), need_rollout=True).rollout_row,
        cfg.grid_size).cpu()
    atol, rtol = TOL["cam"]
    for pre in ("dp", "tp"):
        out[f"{pre}_loss_dev"] = abs(ranks[0][pre]["metrics"][0]["loss"]
                                     - one_loss)
        out[f"{pre}_delta_dev"], bad = delta_excess(ranks[0][pre]["state"],
                                                    one, before)
        if out[f"{pre}_loss_dev"] > TOL["loss"] or bad:
            failures.append(f"{pre} step vs one rank: loss "
                            f"{out[f'{pre}_loss_dev']}, changes of {bad}")
        out[f"{pre}_accum2_delta_dev"], bad = delta_excess(
            ranks[0][f"{pre}_accum2"]["state"], ranks[0][pre]["state"],
            before)
        if bad:
            failures.append(f"{pre} accum 2 vs its full-batch step: {bad}")
        zero = ranks[0][f"{pre}_zero1"]["state"]
        out[f"{pre}_zero1_bit_equal"] = all(
            torch.equal(zero[k], v) for k, v in ranks[0][pre]["state"].items())
        shards = [r[f"{pre}_zero1"]["moment_elements"] for r in ranks]
        full = [r[pre]["moment_elements"] for r in ranks]
        key = "zero1" if pre == "dp" else "tp_zero1"
        out[f"{key}_moment_elements"] = shards
        out[f"{pre}_moment_elements"] = full[0] if pre == "dp" else full
        # each data group partitions its ranks' (model part's) moments
        dp_n = world if pre == "dp" else world // tp
        if not out[f"{pre}_zero1_bit_equal"] or sum(shards) * dp_n != \
                sum(full):
            failures.append(f"{pre} zero1 step differs from its step, or its "
                            "moments are not a partition")
        got = torch.cat([r[f"{pre}_cam"] for i, r in enumerate(ranks)
                         if pre == "dp" or i % tp == 0])
        out[f"{pre}_cam_dev"] = float((got - want_cam).abs().max())
        if not torch.allclose(got, want_cam, rtol=rtol, atol=atol) or \
                not torch.isfinite(got).all():
            failures.append(f"{pre} batch-sharded CAMs: max dev "
                            f"{out[f'{pre}_cam_dev']}")
    out["zero1_bit_equal"] = out.pop("dp_zero1_bit_equal")
    if tp > 1:
        heads = {h for r in ranks for st in r["tp"]["heads"] for h in st}
        out["tp_heads"] = sorted(heads)
        if heads != {cfg.num_heads // tp}:
            failures.append(f"tp kernels ran at heads {heads}")

    if "pp_fwd" in ranks[0]:
        pcfg = pp_config(cfg)
        ref = ViTCAM(pcfg, device=device)
        ref.load_state_dict(before)
        want = ref(x.to(device), need_rollout=True)
        rows = [meshlib.local_batch_rows(batch, world // 2, d, 2)
                for d in range(world // 2)]
        dev = {}
        for k in ("logits", "rollout_row"):
            w = getattr(want, k).cpu()
            dev[k] = max(float((r["pp_fwd"][k] - w[rows[i // 2]]).abs()
                               .max()) for i, r in enumerate(ranks))
            if dev[k] > atol + rtol * float(w.abs().max()):
                failures.append(f"pipeline_forward {k} vs one rank: {dev[k]}")
        out["pp_fwd_dev"] = dev
        pone, ploss = one_step(pcfg, x, y)
        out["pp_loss_dev"] = abs(ranks[0]["pp_step"]["metrics"]["loss"]
                                 - ploss)
        out["pp_delta_dev"], bad = delta_excess(
            ranks[0]["pp_step"]["state"], pone, before)
        if out["pp_loss_dev"] > TOL["loss"] or bad:
            failures.append(f"pipeline_train_step vs one rank: loss "
                            f"{out['pp_loss_dev']}, changes of {bad}")
        out["pp_blocks"] = [r["pp_step"]["blocks"] for r in ranks[:2]]
        if any(r["pp_step"]["launches"] for r in ranks) or any(
                len(b) != cfg.depth // 2 for b in out["pp_blocks"]) or any(
                r["pp_step"]["whole_digest"]
                != ranks[0]["pp_step"]["whole_digest"] for r in ranks):
            failures.append(f"pipeline: launches, blocks a stage "
                            f"{out['pp_blocks']} or whole leaves differ")

    if "sp" in ranks[0]:
        ecfg = cfg.replace(attn_impl="eager")
        ref = ViTCAM(ecfg, device=device)
        ref.load_state_dict(before)
        wants = {"kernel": want_cam, "eager": cam_from_rollout_row(
            ref(x.to(device), need_rollout=True).rollout_row,
            cfg.grid_size).cpu()}
        for impl, want in wants.items():
            # seq rank 0 of each data group, in data-rank order
            got = torch.cat([r[f"sp_cam_{impl}"] for r in ranks[::2]])
            out[f"sp_cam_{impl}_dev"] = float((got - want).abs().max())
            calls = [r[f"sp_calls_{impl}"] for r in ranks]
            want_calls = cfg.depth if impl == "kernel" else 0
            if not torch.allclose(got, want, rtol=rtol, atol=atol) or \
                    any(c != want_calls for c in calls):
                failures.append(f"sp {impl} CAMs: max dev "
                                f"{out[f'sp_cam_{impl}_dev']}, seq-kernel "
                                f"calls {calls} (expected {want_calls})")
        sone, sloss = one_step(sp_config(cfg).replace(seq_axis=None,
                                                      data_axis=None), x, y)
        out["sp_loss_dev"] = abs(ranks[0]["sp"]["metrics"][0]["loss"]
                                 - sloss)
        out["sp_delta_dev"], bad = delta_excess(ranks[0]["sp"]["state"],
                                                sone, before)
        if out["sp_loss_dev"] > TOL["loss"] or bad:
            failures.append(f"sp step vs one rank: loss "
                            f"{out['sp_loss_dev']}, changes of {bad}")
        if any(r["sp"]["digests"] != ranks[0]["sp"]["digests"]
               for r in ranks) or any(
                sum(st.values()) for r in ranks
                for st in r["sp"]["launches"]):
            failures.append("sp step: the ranks' parameters differ, or a "
                            "kernel launched on the eager path")
    out["ok"] = not failures
    print(json.dumps(out))
    if failures:
        raise AssertionError("dryrun_multichip: " + "; ".join(failures))
    return out


if __name__ == "__main__":
    main()
