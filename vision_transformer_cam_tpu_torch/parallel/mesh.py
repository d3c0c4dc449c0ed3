"""The sequence-parallel process grid (the port of the sequence part of
vision_transformer_cam_tpu/parallel/mesh.py).

The JAX package builds a ('data', 'seq') device mesh and lets the compiler
place the collectives; here the same grid is made of ``torch.distributed``
process groups and the model writes the collectives out.  Rank r of the
world sits at (data, seq) = (r // n_seq, r % n_seq): the ranks of one
sequence group share a batch and each hold a slice of its token axis; the
sequence groups (one per data index) work on different batches.

``set_mesh`` makes a mesh the ambient one, as ``jax.set_mesh`` does: a model
whose config names ``seq_axis`` reads it with ``current_mesh`` and raises
without one.  NCCL carries the collectives between cards; gloo carries them
between CPU processes, and between processes that share one card, where
NCCL refuses: CUDA tensors are then staged through host memory (a
transport, not another path: the kernels still run on the card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class SeqMesh:
    """One rank's view of the (data, seq) grid."""

    data_size: int = 1
    seq_size: int = 1
    data_rank: int = 0
    seq_rank: int = 0
    seq_group: Optional[object] = None    # the ranks that share this batch
    data_group: Optional[object] = None   # the ranks with this token slice
    axis_names = ("data", "seq")

    @property
    def shape(self):
        return {"data": self.data_size, "seq": self.seq_size}

    @property
    def seq_root(self) -> int:
        """World rank of sequence-rank 0 of this rank's sequence group."""
        return self.data_rank * self.seq_size

    def transport(self, device) -> str:
        """How a collective moves a tensor that lives on ``device``."""
        if self.seq_size == 1:
            return "none (one rank)"
        backend = dist.get_backend(self.seq_group)
        if backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, CUDA tensors staged through host memory"
        return backend

    def _staged(self, t):
        """(tensor the backend can carry, how to bring a result back)."""
        back_dtype = None
        if dist.get_backend(self.seq_group) == "gloo":
            dev = t.device
            if t.dtype == torch.bfloat16:
                # gloo moves bytes and knows float16: carried as its bits
                back_dtype, t = torch.bfloat16, t.view(torch.float16)
            if dev.type == "cuda":
                t = t.cpu()

            def back(r):
                r = r.to(dev)
                return r.view(back_dtype) if back_dtype else r
            return t, back
        return t, lambda r: r

    def all_gather(self, t, dim: int):
        """Every rank's ``t`` of the sequence group, joined along ``dim`` in
        sequence-rank order."""
        if self.seq_size == 1:
            return t
        t, back = self._staged(t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.seq_size)]
        dist.all_gather(parts, t, group=self.seq_group)
        return back(torch.cat(parts, dim=dim))

    def broadcast_from_seq0(self, t):
        """Sequence-rank 0's ``t`` on every rank of the group."""
        if self.seq_size == 1:
            return t
        t, back = self._staged(t.contiguous())
        if self.seq_rank != 0:
            t = torch.empty_like(t)
        dist.broadcast(t, src=self.seq_root, group=self.seq_group)
        return back(t)

    def all_reduce_sum(self, t):
        """Sum of a float32 / float64 ``t`` over the sequence group."""
        if self.seq_size == 1:
            return t
        t, back = self._staged(t.contiguous().clone())
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.seq_group)
        return back(t)

    def local_rows(self, t, dim: int = 1):
        """This rank's slice of a replicated tensor along ``dim``, the axis
        zero-padded to a multiple of the group size first."""
        n = t.shape[dim]
        nq = -(-n // self.seq_size)
        pad = nq * self.seq_size - n
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        return t.narrow(dim, self.seq_rank * nq, nq)


def distributed_init(device=None) -> None:
    """Join the process group that the standard ``torch.distributed``
    environment describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a no-op without it or when a group exists already, so
    a single process needs no launcher.  NCCL when ``device`` is a card and
    every rank of this host can have one of its own, else gloo."""
    if dist.is_initialized() or "RANK" not in os.environ \
            or "WORLD_SIZE" not in os.environ:
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and torch.cuda.device_count() >= local:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def seq_parallel_mesh(n_seq: int) -> SeqMesh:
    """The (-1, n_seq) ('data', 'seq') grid over the ranks there are: the
    token axis over ``n_seq`` ranks, batches over the remaining world size /
    n_seq groups.  Without a process group the world is this one rank.
    Every rank of the world must call it (the groups are made
    collectively)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_seq <= 0 or world % n_seq:
        raise ValueError(
            f"mesh shape (-1, {n_seq}) over axes ('data', 'seq'): the non-"
            f"wildcard axes multiply to {n_seq}, which does not divide the "
            f"{world} rank(s) of the process group")
    n_data = world // n_seq
    mesh = SeqMesh(data_size=n_data, seq_size=n_seq,
                   data_rank=rank // n_seq, seq_rank=rank % n_seq)
    if world > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_seq + s for s in range(n_seq)])
            if d == mesh.data_rank:
                mesh.seq_group = g
        for s in range(n_seq):
            g = dist.new_group([d * n_seq + s for d in range(n_data)])
            if s == mesh.seq_rank:
                mesh.data_group = g
    return mesh


_ambient: Optional[SeqMesh] = None


@contextlib.contextmanager
def set_mesh(mesh: Optional[SeqMesh]):
    """Make ``mesh`` the ambient mesh of the models called inside."""
    global _ambient
    prev, _ambient = _ambient, mesh
    try:
        yield mesh
    finally:
        _ambient = prev


def current_mesh(seq_axis: str = "seq") -> SeqMesh:
    if _ambient is None or seq_axis not in _ambient.axis_names:
        raise ValueError(
            f"a model with cfg.seq_axis={seq_axis!r} must be called under a "
            f"mesh that carries that axis (use `with set_mesh("
            f"seq_parallel_mesh(n)):`)")
    return _ambient


def apply_seq_parallel(cfg):
    """Rewrite a model config for sequence parallelism over the
    seq_parallel_mesh axes: token axis on 'seq', batch on 'data'.

    The one definition of the override policy (the validate CLI's
    --seq_parallel).  attn_impl='kernel' is kept
    (kernels.attention.masked_attention_seq runs the attention kernel on
    each rank's token slice); the batch-axis kernel fusions (block, MLP,
    ln-quant, int8 fused GEMM, and the int8 attention I/O) are cleared with
    a printed note: under sequence parallelism the int8 GEMMs run as plain
    qlinear and the attention core stays float."""
    fusion_knobs = [name for name, on in
                    (("attn_block_fusion", cfg.attn_block_fusion),
                     ("mlp_fusion", cfg.mlp_fusion),
                     ("ln_quant_fusion", cfg.ln_quant_fusion),
                     ("int8_fused_gemm", cfg.int8_fused_gemm),
                     ("int8_attn_io", cfg.int8_attn_io),
                     ("int8_attn_out", cfg.int8_attn_out)) if on]
    if fusion_knobs:
        print(f"note: sequence parallelism keeps the attention kernel "
              f"(token-sharded) but overrides batch-axis "
              f"fusions: {', '.join(fusion_knobs)}")
    return cfg.replace(attn_block_fusion=False,
                       mlp_fusion=False, ln_quant_fusion=False,
                       int8_fused_gemm=False, int8_attn_io=False,
                       int8_attn_out=False,
                       data_axis="data", seq_axis="seq")
