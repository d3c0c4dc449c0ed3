"""The process grid of the port (the port of
vision_transformer_cam_tpu/parallel/mesh.py): the data-parallel ('data',)
and the sequence-parallel ('data', 'seq') layouts.

The JAX package builds a device mesh and lets the compiler place the
collectives; here the same grid is made of ``torch.distributed`` process
groups and the model, the train step and the optimizer write the collectives
out.  Rank r of the world sits at (data, seq) = (r // n_seq, r % n_seq): the
ranks of one sequence group share a batch and each hold a slice of its token
axis; the ranks of one data group hold different rows of the global batch
(a ('data',) mesh is the grid with n_seq = 1).

``set_mesh`` makes a mesh the ambient one, as ``jax.set_mesh`` does: a model
whose config names ``seq_axis`` or ``data_axis`` reads it with
``current_mesh`` and raises without one; the batch-global mask norm, the
train step's gradient mean and the ZeRO-1 optimizer read it with
``ambient_mesh``.  NCCL carries the collectives between cards; gloo carries
them between CPU processes, and between processes that share one card, where
NCCL refuses: CUDA tensors are then staged through host memory (a transport,
not another path: the kernels still run on the card).  A 'model' (tensor
parallel) or 'stage' (pipeline) axis is not ported (ROADMAP Queue 1 item 10,
its second half).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

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
    axis_names: Tuple[str, ...] = ("data", "seq")

    @property
    def shape(self):
        return {"data": self.data_size, "seq": self.seq_size}

    @property
    def seq_root(self) -> int:
        """World rank of sequence-rank 0 of this rank's sequence group."""
        return self.data_rank * self.seq_size

    def transport(self, device) -> str:
        """How a collective moves a tensor that lives on ``device``."""
        group = self.seq_group if self.seq_size > 1 else self.data_group
        if self.seq_size == 1 and self.data_size == 1:
            return "none (one rank)"
        backend = dist.get_backend(group)
        if backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, CUDA tensors staged through host memory"
        return backend

    def _staged(self, t, group=None):
        """(tensor the backend of ``group`` (default: the sequence group)
        can carry, how to bring a result back)."""
        back_dtype = None
        group = self.seq_group if group is None else group
        if dist.get_backend(group) == "gloo":
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

    # -- the data group: ranks that hold other rows of the global batch ----

    def data_all_gather(self, t, dim: int = 0):
        """Every data rank's ``t`` joined along ``dim`` in data-rank order
        (on dim 0, the global batch's rows in ``local_batch_rows``' one-
        microbatch layout); ``t`` has the same shape on every rank."""
        if self.data_size == 1:
            return t
        t, back = self._staged(t.contiguous(), self.data_group)
        parts = [torch.empty_like(t) for _ in range(self.data_size)]
        dist.all_gather(parts, t, group=self.data_group)
        return back(torch.cat(parts, dim=dim))

    def _data_reduce(self, t, op):
        # carried in float32 at least: a sum never moves bf16 bits, and the
        # max of bf16 values is one of them, so the cast back is exact
        wide = torch.promote_types(t.dtype, torch.float32)
        r, back = self._staged(t.to(wide).contiguous().clone(),
                               self.data_group)
        dist.all_reduce(r, op=op, group=self.data_group)
        return back(r)

    def data_sum(self, t):
        """Sum of ``t`` over the data group, in float32 at least (float64
        stays float64)."""
        if self.data_size == 1:
            return t.to(torch.promote_types(t.dtype, torch.float32))
        return self._data_reduce(t, dist.ReduceOp.SUM)

    def data_mean(self, t):
        """Mean of ``t`` over the data group, in float32 at least."""
        return self.data_sum(t) / self.data_size

    def data_max(self, t):
        """Elementwise max of ``t`` over the data group, in ``t``'s dtype."""
        if self.data_size == 1:
            return t
        return self._data_reduce(t, dist.ReduceOp.MAX).to(t.dtype)

    def data_broadcast(self, t, src: int = 0):
        """Data-rank ``src``'s ``t`` on every rank of the data group."""
        if self.data_size == 1:
            return t
        root = src * self.seq_size + self.seq_rank
        s, back = self._staged(t.contiguous(), self.data_group)
        if self.data_rank != src:
            s = torch.empty_like(s)
        dist.broadcast(s, src=root, group=self.data_group)
        return back(s)


def local_batch_rows(global_batch: int, data_size: int, data_rank: int,
                     accum_steps: int = 1) -> List[int]:
    """The rows of a global batch that data rank ``data_rank`` holds, in
    its local order.  The global batch is cut into ``accum_steps``
    microbatches of consecutive rows (JAX ``train_step_accum`` reshapes it
    to [accum, B / accum]) and each microbatch is split over the data ranks
    (its sharding constraint P(None, 'data')): local rows
    [k mb_l, (k+1) mb_l) are global rows k mb + r mb_l + [0, mb_l) with mb =
    B / accum and mb_l = mb / data_size.  With one microbatch, rank r holds
    the r-th block of B / data_size rows (P('data'))."""
    if global_batch % (data_size * accum_steps):
        raise ValueError(
            f"global batch {global_batch} is not divisible by {data_size} "
            f"data rank(s) x {accum_steps} microbatch(es)")
    mb = global_batch // accum_steps
    mb_l = mb // data_size
    return [k * mb + data_rank * mb_l + j
            for k in range(accum_steps) for j in range(mb_l)]


def shard_batch(mesh: Optional[SeqMesh], batch, accum_steps: int = 1):
    """This rank's rows of a global batch: a tensor / array, or a dict of
    them with the batch on axis 0 (the port of JAX ``shard_batch`` /
    ``data_sharding``; the layout is ``local_batch_rows``)."""
    if mesh is None or mesh.data_size == 1:
        return batch

    def take(x):
        rows = local_batch_rows(x.shape[0], mesh.data_size, mesh.data_rank,
                                accum_steps)
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(rows, device=x.device)]
        return x[rows]
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


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
    world, rank = get_world_size(), get_rank()
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


_UNPORTED_AXES = {"model": "tensor parallelism", "stage": "pipeline "
                  "parallelism"}


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> SeqMesh:
    """The grid of the process group (one rank per device) for axes
    ('data',) or ('data', 'seq'); one -1 wildcard absorbs the remaining
    world size, as JAX ``make_mesh`` does with the visible devices.  Every
    rank of the world must call it (the groups are made collectively)."""
    shape, axes = list(shape), tuple(axes)
    for ax in axes:
        if ax in _UNPORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {ax!r} ({_UNPORTED_AXES[ax]}) is not ported yet "
                "(ROADMAP Queue 1 item 10, its second half)")
    if axes not in (("data",), ("data", "seq")) or len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {axes}: the "
                         "port builds ('data',) and ('data', 'seq') meshes")
    world = get_world_size()
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {tuple(shape)}: one -1 at most")
    if -1 in shape:
        known = math.prod(s_ for s_ in shape if s_ != -1)
        if known <= 0 or world % known:
            raise ValueError(
                f"mesh shape {tuple(shape)} over axes {axes}: the non-"
                f"wildcard axes multiply to {known}, which does not divide "
                f"the {world} rank(s) of the process group")
        shape[shape.index(-1)] = world // known
    n = math.prod(shape)
    if n != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} over axes {axes} needs {n} rank(s) "
            f"but the process group has {world}; launch {n} processes "
            "(torchrun --nproc_per_node) or use a -1 wildcard")
    if axes == ("data", "seq"):
        return seq_parallel_mesh(shape[1])
    mesh = SeqMesh(data_size=world, seq_size=1, data_rank=get_rank(),
                   seq_rank=0, axis_names=("data",))
    if world > 1:
        mesh.data_group = dist.group.WORLD
    return mesh


def get_world_size() -> int:
    """Ranks in the process group (1 without one): JAX counts devices, and
    the port runs one rank per device."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (none without one)."""
    if get_world_size() > 1:
        dist.barrier()


def reduce_value(value, average: bool = True,
                 mesh: Optional[SeqMesh] = None):
    """All-reduce ``value`` over the data group of ``mesh`` (the ambient
    mesh by default), its mean or its sum, in float32 at least."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return value
    return mesh.data_mean(value) if average else mesh.data_sum(value)


def process_local_slice(n: int, batch_size: int):
    """[start, stop) of the global index range this process loads; the last
    process takes the remainder."""
    pi, pc = get_rank(), get_world_size()
    per = batch_size // pc
    return pi * per, (pi + 1) * per if pi != pc - 1 else batch_size


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


def current_mesh(seq_axis: str = "seq", field: str = "seq_axis") -> SeqMesh:
    if _ambient is None or seq_axis not in _ambient.axis_names:
        raise ValueError(
            f"a model with cfg.{field}={seq_axis!r} must be called under a "
            f"mesh that carries that axis (use `with set_mesh(make_mesh("
            f"...)):` or `with set_mesh(seq_parallel_mesh(n)):`)")
    return _ambient


def ambient_mesh() -> Optional[SeqMesh]:
    """The ambient mesh when its data axis spans more than one rank, else
    None: where the batch is split over ranks and a batch statistic must be
    reduced over them."""
    if _ambient is not None and _ambient.data_size > 1:
        return _ambient
    return None


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
