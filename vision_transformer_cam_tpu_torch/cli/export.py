"""Export the serving model as a ``torch.export`` artifact (the port of
vision_transformer_cam_tpu/cli/export.py).

The CAM-extraction function (forward + in-loop rollout + CAM grid), with
the weights baked in and any serving mode applied, is saved ahead of time
as one ``.pt2`` program that a server loads without the model code, the
config or the checkpoint:

  python -m vision_transformer_cam_tpu_torch.cli.export \\
      --weights ckpt.npz --serving int8 --batch 512 --out model.pt2

The hand-written kernels travel in the program as ``vitcam::...`` custom
ops (``kernels/ops.py``): the program launches them where it runs on the
card, and runs their plain versions on the CPU.  Loading it needs those
ops registered first: ``import vision_transformer_cam_tpu_torch.kernels.ops``
before ``torch.export.load`` (``examples/serve_artifact.py`` does).

``--check`` loads the artifact back, runs it and verifies its outputs equal
the live function's bit for bit.  A JSON sidecar (``--out`` + ".json")
records the model / mode / shape contract with the JAX sidecar's keys, plus
``matmul_precision``: the float32 GEMM precision the function was traced
under, a process global no graph records, which the server sets before it
calls the program.  The batch is static.  The program's tensors live on
the device it was exported on (``--device``; ``--platform`` must name the
same), so export on the platform you deploy to.

``--data_parallel`` is the batch-sharded artifact, the port's counterpart of
the JAX package's one SPMD program for every device.  Run by the N ranks of
a process group (one device a rank: ``torchrun --nproc_per_node N``, or
``parallel.worker.launch``), it exports one program at the local batch
``--batch`` / N, which each rank serves on its rows
(``examples/serve_artifact.py``); ``--batch`` is the global batch and the
sidecar's ``nr_devices`` is N.  Rank 0 writes the program and the sidecar;
``--check`` runs on every rank, on its rows of the check batch.  Without a
process group N is 1 and the artifact is the plain one.  Under ``--serving
off`` (the batch-global mask norm) the program takes the max over the whole
global batch: an all-reduce over the ranks inside the program, as JAX's
GSPMD program spans its devices.

``--seq_parallel N`` is the sequence-sharded artifact (JAX's
``--seq_parallel``): the ranks of the process group form the (world / N, N)
('data', 'seq') grid (``parallel.seq_parallel_mesh``), the config gets
``apply_seq_parallel`` after the serving mode (the batch-axis fusions are
cleared; the attention is the sequence-parallel kernel on each rank's token
rows), ``--batch`` must be a multiple of the data axis, and the ranks of a
data group serve the same rows.  A trace bakes in the rank (its token rows
and the group-rank roots), so every rank exports and saves a program of its
own: rank r's is ``--out`` with ``.rank<r>`` before the suffix (rank 0's is
``--out`` itself), and the sidecar's ``programs`` names them by rank.

The collectives of both (``parallel.mesh.SeqMesh``: the all-gathers of K |
V and of the key mask, the cls-row broadcast, the rollout sums, the
mask-norm max; staged through host memory where gloo carries CUDA tensors)
are functional ``_c10d_functional`` ops in the program.  They name their
process group by the name the exporting process gave it, which comes from
the order in which that process made its groups.  On more than one rank the
sidecar records every rank's groups (``process_groups``: name -> world
ranks and backend), and ``kernels.ops.load_program`` refuses a program
where a name resolves to no group or to other ranks: a server makes its
grid first, in the exporter's order (``examples/serve_artifact.py`` does).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vision_transformer_cam_tpu_torch import configs, serving
from vision_transformer_cam_tpu_torch.io import weights as wio
from vision_transformer_cam_tpu_torch.kernels import ops as kops
from vision_transformer_cam_tpu_torch.models.vit import (
    _MATMUL_PRECISION, ServingFn, ViTCAM, matmul_precision)
from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
from vision_transformer_cam_tpu_torch.utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name", type=str,
                   default="vit_base_patch16_224_in21k")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--weights", type=str, default="",
                   help=".pth / .npz fine-tuned weights or a checkpoint of "
                        "the port's trainer; empty = random (shape/perf "
                        "testing)")
    p.add_argument("--serving", type=str, default="int8",
                   choices=list(serving.SERVING_MODES))
    p.add_argument("--batch", type=int, default=512,
                   help="static batch size baked into the artifact")
    p.add_argument("--calib_npy", type=str, default="",
                   help="[N,H,W,3] float .npy calibration batch for int8; "
                        "default: unit-normal random (document your own!)")
    p.add_argument("--no-cam", action="store_true",
                   help="export the classification-only function")
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "eager", "kernel"],
                   help="override the serving mode's attention impl "
                        "(auto = the fused CUDA kernel on the card, eager "
                        "on the CPU)")
    p.add_argument("--data_parallel", action="store_true",
                   help="the batch-sharded artifact: one program at batch / "
                        "N that the N ranks of the process group serve, "
                        "each on its rows")
    p.add_argument("--seq_parallel", type=int, default=0, metavar="N",
                   help="shard the token axis over N ranks of the process "
                        "group (the sequence-parallel kernel; the batch over "
                        "the remaining world size / N): one program a rank, "
                        "each rank exports and checks its own")
    p.add_argument("--out", type=str, required=True,
                   help="artifact path (.pt2); a .json sidecar is written "
                        "next to it")
    p.add_argument("--platform", type=str, default="",
                   help="the artifact's platform (cuda/cpu); must equal "
                        "the device's type")
    p.add_argument("--check", action="store_true",
                   help="load + run + compare against the live fn")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def build_fn(args, **overrides):
    """(fn(images), cfg, calib_provenance): ``fn`` a ``models.vit.ServingFn``
    with the weights loaded and the serving mode applied, on ``args.device``.
    ``overrides`` are config fields set last (the serving fusions, for
    example); they are no flag of the JAX CLI."""
    device = resolve_device(args.device)
    # strict resolution (no silent ViT-B fallback: the sidecar would record
    # the wrong model), with the reference's 'vit_base' alias
    factory = configs.resolve_model(args.model_name)
    cfg = factory(num_classes=args.num_classes)
    cfg = cfg.replace(representation_size=None)
    model = ViTCAM(cfg, device=device,
                   generator=torch.Generator().manual_seed(0))
    if args.weights:
        wio.load_weights(args.weights, model, del_keys=())
    calib = None
    calib_provenance = None
    if args.serving.startswith("int8"):
        if args.calib_npy:
            calib = np.load(args.calib_npy)
            calib_provenance = args.calib_npy
        else:
            calib = np.random.default_rng(7).standard_normal(
                (8, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
            calib_provenance = "random-unit-normal (NOT real images)"
            if args.weights:
                # real weights with scales calibrated on noise: say so
                print("WARNING: --weights given but no --calib_npy: int8 "
                      "activation scales are calibrated on RANDOM NOISE. "
                      "Pass a representative [N,H,W,3] .npy batch for a "
                      "production artifact (sidecar records provenance).")
    serving.apply_serving_mode(model, args.serving, calib_images=calib)
    impl = args.attn_impl
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "eager"
    model.cfg = model.cfg.replace(attn_impl=impl, **overrides)
    if args.seq_parallel:
        # after the serving mode, as in JAX: clears the batch-axis fusions
        model.cfg = meshlib.apply_seq_parallel(model.cfg)
    elif args.data_parallel:
        # the batch-global mask norm reads the data group of the mesh
        model.cfg = model.cfg.replace(data_axis="data")
    model.requires_grad_(False)
    return ServingFn(model, with_cam=not args.no_cam), model.cfg, \
        calib_provenance


def serving_mesh(args):
    """The grid the artifact is traced, checked and served on: the
    ('data', 'seq') grid of ``--seq_parallel`` N or the ('data',) mesh of
    ``--data_parallel``, over the process group (one rank without one);
    None for the plain artifact.  Every rank calls it (the groups are made
    collectively)."""
    if args.seq_parallel:
        try:
            return meshlib.seq_parallel_mesh(args.seq_parallel)
        except ValueError as e:
            raise SystemExit(f"--seq_parallel {args.seq_parallel}: {e}") \
                from None
    if args.data_parallel:
        return meshlib.make_mesh((-1,), ("data",))
    return None


def program_path(out: str, rank: int) -> str:
    """Where rank ``rank`` of a ``--seq_parallel`` export saves its program:
    ``out`` for rank 0, else ``out`` with ``.rank<r>`` before its
    suffix."""
    if rank == 0:
        return out
    stem, ext = os.path.splitext(out)
    return f"{stem}.rank{rank}{ext}"


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.data_parallel or args.seq_parallel:
        # the group a launcher describes (none: one rank)
        meshlib.distributed_init(device)
    mesh = serving_mesh(args)
    if mesh is not None and args.batch % mesh.data_size:
        raise SystemExit(f"--batch {args.batch} must be a multiple of "
                         f"the mesh's {mesh.data_size}-way batch axis")
    if args.platform and args.platform != device.type:
        # the program's tensors and the kernels it launches belong to the
        # device it was traced on
        raise SystemExit(
            f"--platform {args.platform} != the device's type "
            f"{device.type}: export on the platform you deploy to (pass "
            f"--device {args.platform} there)")
    fn, cfg, calib_provenance = build_fn(args)
    return write_artifact(args, fn, cfg, calib_provenance, mesh)


def write_artifact(args, fn, cfg, calib_provenance, mesh=None) -> str:
    """Export ``fn`` (from ``build_fn``) at the static batch (a data rank's
    rows under ``--data_parallel`` and ``--seq_parallel``), save it to
    ``args.out`` with its sidecar (rank 0; under ``--seq_parallel`` every
    rank saves its own program) and, with ``args.check``, hold the loaded
    artifact to ``fn`` bit for bit (every rank, on its rows).  ``mesh``:
    ``serving_mesh(args)``, made here when not given.  Returns
    ``args.out``."""
    device = resolve_device(args.device)
    if mesh is None:
        mesh = serving_mesh(args)
    world = meshlib.get_world_size() if mesh is not None else 1
    rank = meshlib.get_rank() if world > 1 else 0
    data_size, data_rank = (mesh.data_size, mesh.data_rank) if mesh \
        else (1, 0)
    local = args.batch // data_size
    # the sequence ranks' traces differ (each bakes in its rows and its
    # groups); the data-parallel program is one for every rank
    own = bool(args.seq_parallel) and world > 1
    path = program_path(args.out, rank) if own else args.out
    groups = None
    t0 = time.perf_counter()
    if own or rank == 0:
        spec = torch.zeros((local, cfg.img_size, cfg.img_size, 3),
                           dtype=torch.float32, device=device)
        with matmul_precision(cfg), torch.no_grad(), meshlib.set_mesh(mesh):
            exported = torch.export.export(fn, (spec,), strict=False)
        # the example batch is no part of the program (and 38.5 MB at
        # ViT-B/16's batch 64): not saved
        exported.example_inputs = None
        torch.export.save(exported, path)
        groups = kops.process_groups(kops.program_groups(exported))
        print(f"exported {os.path.getsize(path) / 1e6:.1f} MB -> {path} "
              f"(platforms {[device.type]}, "
              f"{time.perf_counter() - t0:.1f} s)" + (
                  f", rank {rank}'s program: batch {local} on the "
                  f"({data_size}, {args.seq_parallel}) ('data', 'seq') grid"
                  if own else f", batch {local} a rank of {world}"
                  if world > 1 else ""))
    meta = {"model_name": args.model_name, "serving": args.serving,
            "scoped_vmem_kib": None,
            "batch": args.batch, "img_size": cfg.img_size,
            "num_classes": args.num_classes, "with_cam": not args.no_cam,
            "nr_devices": world, "seq_parallel": args.seq_parallel or None,
            "platforms": [device.type],
            "calibration": calib_provenance,
            "input": "float32 [batch, H, W, 3], ImageNet-normalized",
            "mean": list(configs.DataConfig.mean),
            "std": list(configs.DataConfig.std),
            "outputs": "(logits, head1_logits" +
                       (", cam [batch, grid, grid])" if not args.no_cam
                        else ")"),
            "matmul_precision": _MATMUL_PRECISION[cfg.matmul_precision]}
    if world > 1:
        # by rank: the program it serves and the process groups that
        # program's collectives name (rank 0's for every data-parallel rank)
        ranks = meshlib.all_objects((os.path.basename(path), groups))
        if not own:
            ranks = [ranks[0]] * world
        meta["programs"] = [p for p, _ in ranks]
        meta["process_groups"] = [g for _, g in ranks]
    if rank == 0:
        with open(args.out + ".json", "w") as f:
            json.dump(meta, f, indent=1)
    if world > 1:
        meshlib.barrier()       # the files are there for every rank

    if args.check:
        program = kops.load_program(
            path, device,
            meta["process_groups"][rank] if world > 1 else None).module()
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (args.batch, cfg.img_size, cfg.img_size, 3)).astype(
                np.float32))[data_rank * local:(data_rank + 1) * local]
        x = x.to(device)
        with matmul_precision(cfg), torch.no_grad(), meshlib.set_mesh(mesh):
            got = program(x)
            want = fn(x)
        if len(got) != len(want):
            raise AssertionError(f"--check: the artifact returns {len(got)} "
                                 f"outputs, the live function {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.equal(g, w):
                raise AssertionError(
                    f"--check: output {i} of the artifact differs from the "
                    f"live function ({g.dtype} {tuple(g.shape)} against "
                    f"{w.dtype} {tuple(w.shape)})")
        print(f"check OK: artifact == live fn on random input "
              f"({len(got)} outputs, bit-identical)" + (
                  f" on rank {rank}'s rows" if world > 1 else ""))
    return args.out


if __name__ == "__main__":
    main()
