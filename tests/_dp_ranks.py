"""Functions the data-parallel tests run in spawned ranks
(``parallel.worker.launch``).  Not a test module: it imports torch and the
port only, so a spawned rank does not import jax.  The tiny models are
registered here, as the tests' ``monkeypatch`` of the zoo does not reach a
spawned process."""

import sys

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def tiny_factory(dtype="float64", depth=3, mask_from=1):
    def factory(num_classes=20, has_logits=False):
        dt = DTYPES[dtype]
        return configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                    depth=depth, num_heads=4,
                                    num_classes=num_classes,
                                    mask_from=mask_from, top_k_patches=4,
                                    dtype=dt, param_dtype=dt)
    return factory


def register(zoo, **kw):
    configs.MODEL_ZOO[zoo] = tiny_factory(**kw)


def no_tensorboard():
    """Make ``fit``'s optional TensorBoard import fail: where TensorFlow is
    installed, importing it takes longer than the tiny training run."""
    sys.modules["torch.utils.tensorboard"] = None


def train_cli(zoo, zoo_kw, argv):
    """cli.train.main on this rank; returns the step and the parameters in
    the one-rank layout."""
    from vision_transformer_cam_tpu_torch.cli import train as tcli
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    register(zoo, **zoo_kw)
    no_tensorboard()
    state = tcli.main(argv)
    return {"step": state.step,
            "params": {k: v.detach().cpu() for k, v in
                       pmesh.full_state_dict(state.model).items()}}


def validate_cli(zoo, zoo_kw, argv):
    from vision_transformer_cam_tpu_torch.cli import validate as vcli
    register(zoo, **zoo_kw)
    return vcli.main(argv)


def evaluate_split(zoo, zoo_kw, weights, split, root, batch_size):
    """train.loop.evaluate over ``split`` as fit builds its val loader: each
    rank its rows of every global batch of ``batch_size``, under the data
    mesh of the ranks there are."""
    from vision_transformer_cam_tpu_torch.data.loader import BatchLoader
    from vision_transformer_cam_tpu_torch.data.voc12 import VOC12Dataset
    from vision_transformer_cam_tpu_torch.io.weights import load_weights
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    from vision_transformer_cam_tpu_torch.train import loop
    register(zoo, **zoo_kw)
    pmesh.distributed_init("cpu")
    mesh = pmesh.make_mesh((-1,), ("data",))
    model = ViTCAM(configs.MODEL_ZOO[zoo](), device="cpu")
    load_weights(weights, model)
    ds = VOC12Dataset(split, root, img_size=32)
    loader = BatchLoader(ds, batch_size // mesh.data_size, shuffle=False,
                         drop_last=False, process_index=mesh.data_rank,
                         process_count=mesh.data_size)
    with pmesh.set_mesh(mesh):
        return loop.evaluate(model, loader)


def seq_forward(cfg, state_dict, images, n_seq, overrides):
    """The sequence-parallel forward on this rank of the (world / n_seq,
    n_seq) grid, each data group on its block of rows of ``images`` (the
    global batch): the complete outputs of the group's rows."""
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    pmesh.distributed_init("cpu")
    model = ViTCAM(cfg, device="cpu")
    load_state_dict(model, state_dict)
    model.cfg = pmesh.apply_seq_parallel(model.cfg.replace(**overrides))
    mesh = pmesh.seq_parallel_mesh(n_seq)
    with pmesh.set_mesh(mesh):
        out = model(pmesh.shard_batch(mesh, images), need_rollout=True)
    return {k: getattr(out, k) for k in ("logits", "rollout_row",
                                         "head1_logits", "top_patch_idx",
                                         "attn_cls_rows")}


def collectives():
    """Every data-group collective on this rank's seeded tensor, under the
    ('data',) mesh of the ranks there are."""
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    pmesh.distributed_init("cpu")
    mesh = pmesh.make_mesh((-1,), ("data",))
    r = mesh.data_rank
    x = torch.from_numpy(np.random.default_rng(r).standard_normal((3, 5)))
    bf = x.to(torch.bfloat16)
    return {"rank": r, "x": x, "sum": mesh.data_sum(x),
            "mean": mesh.data_mean(x), "max": mesh.data_max(x),
            "gather": mesh.data_all_gather(x, dim=0),
            "gather_bf16": mesh.data_all_gather(bf, dim=1),
            "max_bf16": mesh.data_max(bf), "sum_bf16": mesh.data_sum(bf),
            "bcast": mesh.data_broadcast(x, src=1),
            "reduce_value": pmesh.reduce_value(x, average=False, mesh=mesh),
            "slice": pmesh.process_local_slice(10, 7),
            "main": pmesh.is_main_process(),
            "world": pmesh.get_world_size(), "rank_fn": pmesh.get_rank(),
            "transport": mesh.transport("cpu")}


def dp_forward(cfg, state_dict, images):
    """The data-parallel forward (``cfg.data_axis`` under the ('data',) mesh
    of the ranks there are) on this rank's rows of ``images``."""
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    pmesh.distributed_init("cpu")
    mesh = pmesh.make_mesh((-1,), ("data",))
    model = ViTCAM(cfg.replace(data_axis="data"), device="cpu")
    load_state_dict(model, state_dict)
    with pmesh.set_mesh(mesh):
        out = model(pmesh.shard_batch(mesh, images), need_rollout=True)
    return {"transport": mesh.transport("cpu"),
            **{k: getattr(out, k) for k in ("logits", "rollout_row",
                                            "head1_logits",
                                            "attn_cls_rows")}}


def train_runs(cfg, state_dict, batches, runs, optim, global_batch,
               steps_per_epoch, ckpt_dir, mesh_shape=(-1,), forwards=None,
               inner="model"):
    """Training runs on this rank of the ('data',) mesh, or with a second
    entry in ``mesh_shape`` of the ('data', ``inner``) mesh ('model' or
    'seq'), each from
    ``state_dict`` (``scripts.dryrun_multichip.train_steps``): ``runs`` maps
    a name to (config fields replaced, train_steps keywords, save a
    checkpoint ``<ckpt_dir>/<name>.pt``; a keyword ``batches`` replaces the
    batches).  ``forwards`` maps a name to (config fields replaced, global
    images, forward keywords): the forward of this rank's rows.  Returns
    each run's result with its final parameters in the one-rank layout."""
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
        train_steps)
    from vision_transformer_cam_tpu_torch.train import checkpoint as ckptlib
    pmesh.distributed_init("cpu")
    axes = ("data", inner)[:len(mesh_shape)]
    mesh = pmesh.make_mesh(mesh_shape, axes)
    out = {"transport": mesh.transport("cpu"), "data_rank": mesh.data_rank,
           "model_rank": mesh.inner_rank}
    for name, (over, images, kw) in (forwards or {}).items():
        model = ViTCAM(cfg.replace(**over), device="cpu")
        load_state_dict(model, state_dict)
        pmesh.shard_params(mesh, model, "model")
        with pmesh.set_mesh(mesh):
            res = model(pmesh.shard_batch(mesh, images), **kw)
        out[name] = {k: getattr(res, k) for k in (
            "logits", "head1_logits", "rollout_row", "attn_cls_rows",
            "top_patch_idx", "attn_headmean", "attn_perhead")
            if getattr(res, k) is not None}
    for name, (over, kw, save) in runs.items():
        kw = dict(kw)
        state, res = train_steps(cfg.replace(**over), state_dict,
                                 kw.pop("batches", batches), mesh,
                                 optim=optim, global_batch=global_batch,
                                 device="cpu",
                                 steps_per_epoch=steps_per_epoch, **kw)
        if save:
            ckptlib.save(ckpt_dir, name, state)
        res["state"] = {k: v.detach().cpu() for k, v in
                        pmesh.full_state_dict(state.model).items()}
        out[name] = res
    return out


def pipeline_runs(cfg, state_dict, images, labels, shape, micro, optim,
                  global_batch, steps_per_epoch, ckpt_dir):
    """On this rank of the ('data', 'stage') mesh ``shape``:
    ``pipeline_forward`` with ``need_rollout`` of this rank's rows (those of
    ``shard_batch(mesh, x, M)``) at each microbatch count of ``micro`` with
    the whole model, then the model stage-sharded and one
    ``pipeline_train_step`` at the first count, saved as
    ``<ckpt_dir>/pipeline.pt``.  Returns the outputs, the metrics, the
    blocks this rank holds and the parameters in the one-rank layout."""
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    from vision_transformer_cam_tpu_torch.parallel import pipeline
    from vision_transformer_cam_tpu_torch.train import checkpoint as ckptlib
    from vision_transformer_cam_tpu_torch.train import state as statelib
    pmesh.distributed_init("cpu")
    mesh = pmesh.make_mesh(shape, ("data", "stage"))
    model = ViTCAM(cfg, device="cpu")
    load_state_dict(model, state_dict)
    out = {"data_rank": mesh.data_rank, "stage_rank": mesh.inner_rank}
    for m in micro:
        res = pipeline.pipeline_forward(
            model, pmesh.shard_batch(mesh, images, m), cfg, mesh,
            microbatches=m, need_rollout=True)
        out[f"fwd{m}"] = {k: getattr(res, k) for k in (
            "logits", "head1_logits", "rollout_row", "attn_cls_rows",
            "top_patch_idx")}
    pipeline.stage_shard_params(mesh, model)
    out["blocks"] = sorted({int(n.split(".")[1]) for n, _ in
                            model.named_parameters()
                            if n.startswith("blocks.")})
    opt, _ = statelib.make_optimizer(model, optim, global_batch,
                                     steps_per_epoch)
    state = statelib.create_train_state(model, opt)
    x, y = (pmesh.shard_batch(mesh, t, micro[0]) for t in (images, labels))
    with pmesh.set_mesh(mesh):
        state, m = pipeline.pipeline_train_step(state, x, y, mesh,
                                                microbatches=micro[0])
    out["metrics"] = {k: float(v) for k, v in m.items()}
    ckptlib.save(ckpt_dir, "pipeline", state)
    out["state"] = {k: v.detach().cpu() for k, v in
                    pmesh.full_state_dict(model).items()}
    return out


def export_cli(zoo, zoo_kw, argvs, serve_argv):
    """``cli.export.main`` of each argv on this rank, then, with
    ``serve_argv``, ``examples.serve_artifact.main``: what each printed, or
    the text of its ``SystemExit``."""
    import contextlib
    import io

    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.examples import serve_artifact
    register(zoo, **zoo_kw)
    out = []
    calls = [(ecli.main, a) for a in argvs]
    if serve_argv:
        calls.append((serve_artifact.main, serve_argv))
    for fn, argv in calls:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                fn(argv)
            out.append(buf.getvalue())
        except SystemExit as e:
            out.append(f"SystemExit: {e}")
    return out


def _fresh_group(work, step):
    """A process group of its own for ``step`` on this rank (the launcher's
    ranks, a FileStore under ``work``): its groups are named from the
    first, as in a process that a launcher starts for one CLI run."""
    import os

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    world = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, f"store_{step}"),
                                     world),
        rank=int(os.environ["RANK"]), world_size=world)


def export_seq(zoo, zoo_kw, work, argvs, serve_argv, x, run, trap):
    """``cli.export.main`` of each argv, then ``examples.serve_artifact.
    main`` of ``serve_argv``, each in a fresh process group, what each
    printed or the text of its ``SystemExit``; then, in a fresh group with
    the (world / 2, 2) ('data', 'seq') grid made first, each sidecar of
    ``run`` served on ``x`` (the global batch): this rank's program on its
    data rank's rows, the outputs gathered over the data group; then, in a
    fresh group whose grid's groups are made in another order (the data
    groups first), ``kernels.ops.load_program`` of this rank's program of
    the sidecar ``trap``: what it raised."""
    import contextlib
    import io
    import json
    import os

    import torch.distributed as dist

    from vision_transformer_cam_tpu_torch.cli import export as ecli
    from vision_transformer_cam_tpu_torch.examples import serve_artifact
    from vision_transformer_cam_tpu_torch.kernels import ops as kops
    from vision_transformer_cam_tpu_torch.parallel import mesh as pmesh
    register(zoo, **zoo_kw)
    printed = []
    calls = [(ecli.main, a) for a in argvs] + [(serve_artifact.main,
                                                 serve_argv)]
    for step, (fn, argv) in enumerate(calls):
        _fresh_group(work, step)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                fn(argv)
            printed.append(buf.getvalue())
        except SystemExit as e:
            printed.append(f"SystemExit: {e}")

    def program(sidecar):
        meta = json.load(open(sidecar))
        path = os.path.join(os.path.dirname(sidecar),
                            meta["programs"][dist.get_rank()])
        return meta, path, meta["process_groups"][dist.get_rank()]

    _fresh_group(work, "run")
    grids = {2: pmesh.seq_parallel_mesh(2),
             None: pmesh.make_mesh((-1,), ("data",))}
    outputs = {}
    for name, sidecar in run.items():
        meta, path, groups = program(sidecar)
        mesh = grids[meta["seq_parallel"]]
        local = x.shape[0] // mesh.data_size
        fn = kops.load_program(path, "cpu", groups).module()
        with torch.no_grad():
            got = fn(x[mesh.data_rank * local:(mesh.data_rank + 1) * local])
        outputs[name] = [mesh.data_all_gather(t) for t in got]

    _fresh_group(work, "trap")
    world = dist.get_world_size()
    for s in range(2):
        dist.new_group([d * 2 + s for d in range(world // 2)])
    for d in range(world // 2):
        dist.new_group([d * 2 + s for s in range(2)])
    _, path, groups = program(trap)
    try:
        kops.load_program(path, "cpu", groups)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return printed, outputs, refused
