"""Data-parallel dry run over several ranks (the port's counterpart of
``__graft_entry__.dryrun_multichip``, for what the port has of it).

Spawns ``--world`` ranks on one host (``parallel.worker.launch``, each
running ``dp_rank``; gloo on the CPU or where ranks share the card), with a
tiny model on the kernel path at float32 (the JAX dry run's img 32, patch
8, depth 6, mask from block 2, top-4 patches, with C 128 in 2 heads of 64,
a width the CUDA kernels are compiled for, where JAX takes 4 heads of 16),
a global batch of 2 rows a rank, and holds
each result to the one-rank result computed in this process:

  1. a data-parallel train step (loss, and every parameter's change);
  2. two accumulation steps under data parallelism against the full-batch
     data-parallel step;
  3. a ZeRO-1 step against the unsharded data-parallel step (bit for bit),
     each rank holding 1 / world of the AdamW moments;
  4. batch-sharded CAM extraction (the rollout CAM of each rank's rows).

Every rank's parameters must be bit for bit equal after every step.  The
optimizer is AdamW with eps 1 and lr 1 and no decay, so that a first step's
change is -g / (|g| + 1), a contraction of the gradient: the tolerance on
the changes is one on the gradients.  The JAX function's tensor-parallel
('model' axis), sequence-parallel training and pipeline blocks are not
ported yet (ROADMAP Queue 1 item 10, its second half).

    python -m vision_transformer_cam_tpu_torch.scripts.dryrun_multichip \\
        [--world 2] [--device cpu]

prints one JSON line of the deviations and returns it as a dict.
``train_steps`` is the data-parallel training run of one rank that
``dp_rank`` takes three times; the tests and the smoke run call it from
their own rank functions.
"""

from __future__ import annotations

import argparse
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
from vision_transformer_cam_tpu_torch.train import state as statelib
from vision_transformer_cam_tpu_torch.train import step as steplib
from vision_transformer_cam_tpu_torch.utils import resolve_device

# one float32 step, rank-split against one rank: loss, and the parameter
# changes at the tolerance of the smoke run's gradients (TRAIN_TOL)
TOL = {"loss": 1e-5, "delta": (2e-5, 1e-3), "cam": (1e-5, 1e-4)}
OPTIM = dict(lr=1.0, opt_eps=1.0, weight_decay=0.0, warmup_epochs=0,
             epochs=10, linear_lr_scaling=False)


def tiny_config() -> configs.ViTCAMConfig:
    return configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=128,
                                depth=6, num_heads=2, num_classes=20,
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


def param_digest(model) -> str:
    """sha256 of every parameter's bytes, in ``named_parameters`` order:
    equal digests are bit-equal parameters."""
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def train_steps(cfg, state_dict, batches, mesh, *, optim, global_batch,
                device, zero1=False, accum_steps=1, steps=None,
                steps_per_epoch=100):
    """Data-parallel training on this rank of ``mesh`` (a ('data',) mesh of
    the process group every rank has joined): the model of ``cfg`` from
    ``state_dict``, AdamW of ``optim`` with the schedule scaled by
    ``global_batch`` (the moments sharded over the ranks with ``zero1``),
    and ``steps`` train steps (default one a batch; the batches cycle) on
    this rank's rows of the global batches ``batches`` ([(images, labels)],
    CPU tensors; ``accum_steps`` microbatches a step).  Returns (state,
    result): ``metrics``, ``launches`` (kernel 1 and the backward) and
    ``digests`` (``param_digest``) per step, and ``moment_elements`` /
    ``moment_bytes`` of the optimizer state this rank holds."""
    model = ViTCAM(cfg, device=device)
    load_state_dict(model, state_dict)
    opt, _ = statelib.make_optimizer(model, optim, global_batch,
                                     steps_per_epoch,
                                     zero1_mesh=mesh if zero1 else None)
    state = statelib.create_train_state(model, opt)
    local = [tuple(meshlib.shard_batch(mesh, t, accum_steps).to(device)
                   for t in b) for b in batches]
    res = {"metrics": [], "digests": [], "launches": []}
    with meshlib.set_mesh(mesh):
        for i in range(len(local) if steps is None else steps):
            ka.launches = ka.bwd_launches = 0
            x, y = local[i % len(local)]
            if accum_steps > 1:
                state, m = steplib.train_step_accum(state, x, y,
                                                    accum_steps=accum_steps)
            else:
                state, m = steplib.train_step(state, x, y)
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["launches"].append(
                {"masked_attention_fused": ka.launches,
                 "masked_attention_bwd": ka.bwd_launches})
            res["digests"].append(param_digest(model))
    res["moment_elements"] = opt.moment_elements()
    res["moment_bytes"] = 2 * sum(t.numel() * t.element_size()
                                  for t in opt.mu)
    return state, res


def dp_rank(cfg, state_dict, x, y, optim, device):
    """One rank of the dry run (``parallel.worker.launch``): the DP step,
    accumulation 2 and the ZeRO-1 step, each from ``state_dict`` on this
    rank's rows of the global batch (x, y), and the CAMs of this rank's rows
    under ``cfg.data_axis``.  Returns every run's result and final
    parameters, the CAMs and the transport."""
    meshlib.distributed_init(device)
    mesh = meshlib.make_mesh((-1,), ("data",))
    out = {"transport": mesh.transport(device)}
    for name, kw in (("dp", {}), ("accum2", dict(accum_steps=2)),
                     ("zero1", dict(zero1=True))):
        state, res = train_steps(cfg, state_dict, [(x, y)], mesh,
                                 optim=optim, global_batch=x.shape[0],
                                 device=device, **kw)
        res["state"] = {k: v.detach().cpu()
                        for k, v in state.model.state_dict().items()}
        out[name] = res
    model = ViTCAM(cfg.replace(data_axis="data"), device=device)
    load_state_dict(model, state_dict)
    with meshlib.set_mesh(mesh):
        row = model(meshlib.shard_batch(mesh, x).to(device),
                    need_rollout=True).rollout_row
    out["cam"] = cam_from_rollout_row(row, cfg.grid_size).cpu()
    return out


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
    for name in ("dp", "accum2", "zero1"):
        if any(r[name]["digests"] != ranks[0][name]["digests"]
               for r in ranks):
            failures.append(f"{name}: the ranks' parameters differ")

    # the one-rank step in this process
    opt, _ = statelib.make_optimizer(model, optim, batch, 100)
    state = statelib.create_train_state(model, opt)
    state, m = steplib.train_step(state, x.to(device), y.to(device))
    one = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {"world": world, "device": str(device),
           "transport": ranks[0]["transport"]}
    out["dp_loss_dev"] = abs(ranks[0]["dp"]["metrics"][0]["loss"]
                             - float(m["loss"]))
    out["dp_delta_dev"], bad = delta_excess(ranks[0]["dp"]["state"], one,
                                            before)
    if out["dp_loss_dev"] > TOL["loss"] or bad:
        failures.append(f"dp step vs one rank: loss {out['dp_loss_dev']}, "
                        f"changes of {bad}")
    out["accum2_delta_dev"], bad = delta_excess(
        ranks[0]["accum2"]["state"], ranks[0]["dp"]["state"], before)
    if bad:
        failures.append(f"accum 2 vs the full-batch dp step: {bad}")
    zero = ranks[0]["zero1"]["state"]
    out["zero1_bit_equal"] = all(torch.equal(zero[k], v) for k, v in
                                 ranks[0]["dp"]["state"].items())
    shards = [r["zero1"]["moment_elements"] for r in ranks]
    out["zero1_moment_elements"] = shards
    out["dp_moment_elements"] = ranks[0]["dp"]["moment_elements"]
    if not out["zero1_bit_equal"] or sum(shards) != \
            out["dp_moment_elements"]:
        failures.append("zero1 step differs from the dp step, or its "
                        "moments are not a partition")

    # batch-sharded CAM extraction against the one-rank forward
    model.load_state_dict(before)
    want = cam_from_rollout_row(
        model(x.to(device), need_rollout=True).rollout_row,
        cfg.grid_size).cpu()
    got = torch.cat([r["cam"] for r in ranks])
    atol, rtol = TOL["cam"]
    out["cam_dev"] = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol) or \
            not torch.isfinite(got).all():
        failures.append(f"batch-sharded CAMs: max dev {out['cam_dev']}")
    out["ok"] = not failures
    print(json.dumps(out))
    if failures:
        raise AssertionError("dryrun_multichip: " + "; ".join(failures))
    return out


if __name__ == "__main__":
    main()
