"""Run the port's multi-process paths in several processes on one host.

``run_forward`` spawns ``world`` processes that join one process group
(``tcp://localhost:<free port>``), build the same model from the same state
dict, put it into a serving mode and call it on the sequence-parallel
(world / n_seq, n_seq) grid (``apply_seq_parallel``); every rank saves its
outputs and the caller gets them back as a list by rank.

``launch`` is a stand-in for ``torchrun`` on one host: it spawns ranks with
the ``torch.distributed`` environment set (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ...), each calls a function such as
``cli.validate.main`` or a data-parallel training run of
``scripts.dryrun_multichip`` with the same arguments, and it returns what
each returned.  They are what the multi-process tests,
``scripts.dryrun_multichip`` and the smoke run's two-ranks-on-one-card
phases use; a launcher such as ``torchrun`` with ``cli.validate
--seq_parallel N`` / ``--data_parallel`` or ``cli.train --mesh_shape N`` is
the user's way to the same paths.

Each call has a time limit of its own: ranks that are still alive when it
ends are killed and the call raises.  A script that calls them must guard
its entry with ``if __name__ == "__main__":`` (the ranks are spawned, and
import the caller's main module).
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vision_transformer_cam_tpu_torch.utils import resolve_device

_FIELDS = ("logits", "head1_logits", "attn_cls_rows", "top_patch_embeds",
           "top_patch_idx", "attn_headmean", "block_outputs", "rollout_row",
           "tokens_prenorm")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, n_seq, port, backend, device, cfg, workdir,
               serving_mode, overrides, fwd_kw, threads):
    from vision_transformer_cam_tpu_torch import serving
    from vision_transformer_cam_tpu_torch.io.weights import load_state_dict
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    from vision_transformer_cam_tpu_torch.parallel.mesh import (
        apply_seq_parallel, seq_parallel_mesh, set_mesh)
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        model = ViTCAM(cfg, device=device)
        load_state_dict(model, torch.load(os.path.join(workdir, "state.pt")))
        images = torch.load(os.path.join(workdir, "images.pt")).to(device)
        serving.apply_serving_mode(model, serving_mode, calib_images=images)
        model.cfg = apply_seq_parallel(model.cfg.replace(**overrides))
        mesh = seq_parallel_mesh(n_seq)
        with set_mesh(mesh):
            out = model(images, **fwd_kw)
        res = {k: getattr(out, k).cpu() for k in _FIELDS
               if getattr(out, k) is not None}
        res["seq_launches"] = ka.seq_launches
        res["transport"] = mesh.transport(device)
        torch.save(res, os.path.join(workdir, f"out.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(fn, args, world, timeout, what):
    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} {what} ranks did not finish in {timeout:.0f} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def run_forward(cfg, state_dict, images, *, world: int, n_seq: int,
                device=None, backend="gloo", serving_mode="off",
                overrides=None, fwd_kw=None, timeout: float = 120.0,
                threads: int = 1):
    """Outputs of every rank, [rank] -> {field: CPU tensor}, of ``world``
    processes calling the sequence-parallel forward together.

    cfg: the config the model is built with; state_dict: its float weights
    (``ViTCAM.state_dict()`` keys); images: [B, H, W, 3] CPU tensor, the
    same batch for every rank (with more than one sequence group every group
    still gets this batch); serving_mode: as ``serving.apply_serving_mode``
    (the int8 modes calibrate on ``images``); overrides: config fields set
    after the serving mode (``attn_impl``, ``rollout_post``, ...); fwd_kw:
    the forward's keyword arguments; device: where every rank runs, the card
    unless the caller asks for the CPU (``utils.resolve_device``, checked
    here before any rank is spawned)."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as workdir:
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   os.path.join(workdir, "state.pt"))
        torch.save(images.cpu(), os.path.join(workdir, "images.pt"))
        _spawn(_rank_main,
               (world, n_seq, _free_port(), backend, str(device), cfg,
                workdir, serving_mode, overrides or {}, fwd_kw or {},
                threads),
               world, timeout, "sequence-parallel")
        return [torch.load(os.path.join(workdir, f"out.{rank}.pt"))
                for rank in range(world)]


def _launch_rank(rank, world, port, fn, args, workdir, threads, cwd):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    if cwd:
        os.chdir(cwd)
    try:
        res = fn(*args)
        torch.save(res, os.path.join(workdir, f"ret.{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, args=(), *, world: int, timeout: float = 120.0,
           threads: int = 1, cwd=None):
    """What ``fn(*args)`` returned on each of ``world`` ranks, by rank: a
    ``torchrun --nproc_per_node world`` stand-in on this host.  ``fn`` must
    be importable by the spawned processes (a module-level function, e.g.
    ``cli.validate.main``), join the group through
    ``parallel.distributed_init`` and return something ``torch.save``
    takes; ``cwd``: the ranks' working directory."""
    with tempfile.TemporaryDirectory() as workdir:
        _spawn(_launch_rank,
               (world, _free_port(), fn, tuple(args), workdir, threads, cwd),
               world, timeout, "launched")
        return [torch.load(os.path.join(workdir, f"ret.{rank}.pt"),
                           weights_only=False)
                for rank in range(world)]
