"""The process grid of the port (the port of
vision_transformer_cam_tpu/parallel/mesh.py): the data-parallel ('data',),
the sequence-parallel ('data', 'seq'), the tensor-parallel ('data',
'model') and the pipeline ('data', 'stage') layouts.

The JAX package builds a device mesh and lets the compiler place the
collectives; here the same grid is made of ``torch.distributed`` process
groups and the model, the train step and the optimizer write the collectives
out.  Rank r of the world sits at (data, inner) = (r // n, r % n), JAX's
reshape of the device list, where the second axis of n ranks is 'seq',
'model' or 'stage': the ranks of one inner group share a batch and each
hold a slice of its token axis ('seq'), a slice of every block's heads and
MLP hidden units ('model', Megatron's layout: ``shard_params``) or a run of
the blocks ('stage': ``stage_shard_params`` and ``parallel.pipeline``); the
ranks of one data group hold different rows of the global batch (a
('data',) mesh is the grid with n = 1).  The inner axis lives in the
``inner_*`` fields whatever its name; its name, ``axis_names[1]``, is read
only where a layout depends on it.

``set_mesh`` makes a mesh the ambient one, as ``jax.set_mesh`` does: a model
whose config names ``seq_axis`` or ``data_axis`` reads it with
``current_mesh`` and raises without one; the batch-global mask norm, the
train step's gradient mean and the ZeRO-1 optimizer read it with
``ambient_mesh``.  NCCL carries the collectives between cards; gloo carries
them between CPU processes, and between processes that share one card, where
NCCL refuses: CUDA tensors are then staged through host memory (a transport,
not another path: the kernels still run on the card).  The collectives are
the functional ``_c10d_functional`` ops, so that a ``torch.export`` program
of a forward holds them (``cli.export --seq_parallel``).

A model sharded over 'model' or 'stage' carries a ``Layout`` (``model.
layout``): which of its parameters are parts of a larger whole, how to
gather them into the one-rank layout (checkpoints, ``full_state_dict``)
and how to cut this rank's part out of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

_C10D = torch.ops._c10d_functional


@dataclasses.dataclass
class SeqMesh:
    """One rank's view of the (data, inner) grid; the inner axis ('seq',
    'model' or 'stage') is ``axis_names[1]``, of ``inner_size`` ranks."""

    data_size: int = 1
    inner_size: int = 1
    data_rank: int = 0
    inner_rank: int = 0
    inner_group: Optional[object] = None  # the ranks that share this batch
    data_group: Optional[object] = None   # the ranks at this inner index
    axis_names: Tuple[str, ...] = ("data", "seq")

    @property
    def shape(self):
        inner = self.axis_names[1] if len(self.axis_names) > 1 else "seq"
        return {"data": self.data_size, inner: self.inner_size}

    @property
    def inner_root(self) -> int:
        """World rank of inner-rank 0 of this rank's inner group."""
        return self.data_rank * self.inner_size

    def transport(self, device) -> str:
        """How a collective moves a tensor that lives on ``device``."""
        group = self.inner_group if self.inner_size > 1 else self.data_group
        if self.inner_size == 1 and self.data_size == 1:
            return "none (one rank)"
        backend = dist.get_backend(group)
        if backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, CUDA tensors staged through host memory"
        return backend

    def _staged(self, t, group=None):
        """(tensor the backend of ``group`` (default: the inner group)
        can carry, how to bring a result back)."""
        back_dtype = None
        group = self.inner_group if group is None else group
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

    # The collectives below are the functional ``_c10d_functional`` ops:
    # out of place, so that a ``torch.export`` trace of the forward holds
    # them (and the staging around them) as graph nodes, which name their
    # group by its process-group name.  Their results carry no gradient,
    # as the in-place ``torch.distributed`` calls' did; the autograd
    # wrappers (``_GatherRows``, ``models.vit``'s) give the backwards.

    def _gather(self, t, group, size: int, dim: int):
        """Every rank's ``t`` of ``group`` (``size`` ranks) joined along
        ``dim`` in group-rank order."""
        s, back = self._staged(t.detach().contiguous(), group)
        r = _C10D.wait_tensor(_C10D.all_gather_into_tensor(
            s, size, group.group_name))
        if dim != 0:
            r = torch.cat(r.chunk(size), dim=dim)
        return back(r)

    def _reduce(self, t, group, op: str):
        """``op`` ("sum" or "max") of ``t`` over ``group``, carried in
        float32 at least and returned in that width."""
        wide = torch.promote_types(t.dtype, torch.float32)
        s, back = self._staged(t.detach().to(wide).contiguous(), group)
        return back(_C10D.wait_tensor(_C10D.all_reduce(s, op,
                                                       group.group_name)))

    def _broadcast(self, t, group, src: int):
        """Group-rank ``src``'s ``t`` on every rank of ``group``."""
        s, back = self._staged(t.detach().contiguous(), group)
        return back(_C10D.wait_tensor(_C10D.broadcast(s, src,
                                                      group.group_name)))

    def all_gather(self, t, dim: int):
        """Every rank's ``t`` of the inner group, joined along ``dim`` in
        inner-rank order."""
        if self.inner_size == 1:
            return t
        return self._gather(t, self.inner_group, self.inner_size, dim)

    def inner_broadcast(self, t, src: int):
        """Inner-rank ``src``'s ``t`` on every rank of the inner group (the
        other ranks pass a tensor of the same shape and dtype)."""
        if self.inner_size == 1:
            return t
        return self._broadcast(t, self.inner_group, src)

    def inner_sum(self, t):
        """Sum of ``t`` over the inner group (the 'seq', 'model' or 'stage'
        ranks), carried in float32 at least and returned in ``t``'s dtype;
        every rank gets the same bits."""
        if self.inner_size == 1:
            return t
        return self._reduce(t, self.inner_group, "sum").to(t.dtype)

    def inner_list(self, t):
        """Every inner rank's ``t`` (the same shape on each), by inner
        rank."""
        if self.inner_size == 1:
            return [t]
        return list(self._gather(t, self.inner_group, self.inner_size,
                                 0).chunk(self.inner_size))

    def inner_objects(self, obj):
        """Every inner rank's picklable ``obj``, by inner rank."""
        if self.inner_size == 1:
            return [obj]
        out = [None] * self.inner_size
        dist.all_gather_object(out, obj, group=self.inner_group)
        return out

    def stage_send(self, t, stage: int):
        """Send ``t`` to inner rank ``stage`` of this rank's inner group."""
        s, _ = self._staged(t.detach().contiguous())
        dist.send(s, dst=self.inner_root + stage)

    def stage_recv(self, shape, dtype, device, stage: int):
        """A tensor of ``shape`` and ``dtype`` on ``device`` from inner rank
        ``stage`` of this rank's inner group (its ``stage_send``)."""
        s, back = self._staged(torch.empty(shape, dtype=dtype,
                                           device=device))
        dist.recv(s, src=self.inner_root + stage)
        return back(s)

    def local_rows(self, t, dim: int = 1):
        """This rank's slice of a replicated tensor along ``dim``, the axis
        zero-padded to a multiple of the group size first."""
        n = t.shape[dim]
        nq = -(-n // self.inner_size)
        pad = nq * self.inner_size - n
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        return t.narrow(dim, self.inner_rank * nq, nq)

    # -- the data group: ranks that hold other rows of the global batch ----

    def data_all_gather(self, t, dim: int = 0):
        """Every data rank's ``t`` joined along ``dim`` in data-rank order
        (on dim 0, the global batch's rows in ``local_batch_rows``' one-
        microbatch layout); ``t`` has the same shape on every rank."""
        if self.data_size == 1:
            return t
        return self._gather(t, self.data_group, self.data_size, dim)

    def data_sum(self, t):
        """Sum of ``t`` over the data group, in float32 at least (float64
        stays float64)."""
        if self.data_size == 1:
            return t.to(torch.promote_types(t.dtype, torch.float32))
        # a sum never moves bf16 bits
        return self._reduce(t, self.data_group, "sum")

    def data_mean(self, t):
        """Mean of ``t`` over the data group, in float32 at least."""
        return self.data_sum(t) / self.data_size

    def data_max(self, t):
        """Elementwise max of ``t`` over the data group, in ``t``'s dtype
        (the max of bf16 values is one of them: the cast back is exact)."""
        if self.data_size == 1:
            return t
        return self._reduce(t, self.data_group, "max").to(t.dtype)

    def data_broadcast(self, t, src: int = 0):
        """Data-rank ``src``'s ``t`` on every rank of the data group."""
        if self.data_size == 1:
            return t
        return self._broadcast(t, self.data_group, src)


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with its backward."""

    @staticmethod
    def forward(ctx, t, mesh, dim, n, partial):
        ctx.mesh, ctx.dim, ctx.partial = mesh, dim, partial
        return mesh.all_gather(t, dim).narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.mesh.inner_sum(g)
        return ctx.mesh.local_rows(g, ctx.dim), None, None, None, None


def gather_rows(t, mesh: SeqMesh, dim: int, n: int, partial: bool = False):
    """The whole tensor from every inner rank's rows of the padded token
    axis (``dim`` of ``t``), cut to the ``n`` real rows; differentiable.
    In the backward each rank takes its rows of the gradient.  With
    ``partial`` the gradient over all n rows that a rank holds is only its
    share, and the shares are summed over the inner group first: K and V
    gathered for the rank's queries, whose gradients over every key add up
    over the ranks' queries.  Without it every rank holds the same whole
    gradient (the tokens gathered before the final norm and the heads,
    which every rank computes alike), and a sum would count it once a
    rank."""
    if mesh.inner_size == 1:
        return t.narrow(dim, 0, n)
    return _GatherRows.apply(t.contiguous(), mesh, dim, n, partial)


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
    return _grid(n_seq, ("data", "seq"))


def _grid(n: int, axes: Tuple[str, str]) -> SeqMesh:
    """The (-1, n) grid over axes ('data', inner) with its groups."""
    world, rank = get_world_size(), get_rank()
    if n <= 0 or world % n:
        raise ValueError(
            f"mesh shape (-1, {n}) over axes {axes}: the non-"
            f"wildcard axes multiply to {n}, which does not divide the "
            f"{world} rank(s) of the process group")
    n_data = world // n
    mesh = SeqMesh(data_size=n_data, inner_size=n, data_rank=rank // n,
                   inner_rank=rank % n, axis_names=axes)
    if world > 1:
        for d in range(n_data):
            g = dist.new_group([d * n + s for s in range(n)])
            if d == mesh.data_rank:
                mesh.inner_group = g
        for s in range(n):
            g = dist.new_group([d * n + s for d in range(n_data)])
            if s == mesh.inner_rank:
                mesh.data_group = g
    return mesh


_AXES = (("data",), ("data", "seq"), ("data", "model"), ("data", "stage"))


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> SeqMesh:
    """The grid of the process group (one rank per device) for axes
    ('data',), ('data', 'seq'), ('data', 'model') or ('data', 'stage'); one
    -1 wildcard absorbs the remaining world size, as JAX ``make_mesh`` does
    with the visible devices.  Rank r sits at (r // n, r % n) of a (d, n)
    grid.  Every rank of the world must call it (the groups are made
    collectively)."""
    shape, axes = list(shape), tuple(axes)
    if axes not in _AXES or len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {axes}: the "
                         "port builds ('data',), ('data', 'seq'), ('data', "
                         "'model') and ('data', 'stage') meshes")
    world = get_world_size()
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {tuple(shape)}: one -1 at most")
    if -1 in shape:
        known = math.prod(s_ for s_ in shape if s_ != -1)
        if known <= 0 or world % known:
            raise ValueError(
                f"mesh shape {tuple(shape)} over axes {axes}: the non-"
                f"wildcard axes multiply to {known}, which does not divide "
                f"the {world} rank(s) of the process group (the mesh needs "
                f"{known} rank(s) or a multiple; launch them with torchrun "
                "--nproc_per_node)")
        shape[shape.index(-1)] = world // known
    n = math.prod(shape)
    if n != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} over axes {axes} needs {n} rank(s) "
            f"but the process group has {world}; launch {n} processes "
            "(torchrun --nproc_per_node) or use a -1 wildcard")
    if len(axes) == 2:
        return _grid(shape[1], axes)
    mesh = SeqMesh(data_size=world, inner_size=1, data_rank=get_rank(),
                   inner_rank=0, axis_names=("data",))
    if world > 1:
        mesh.data_group = dist.group.WORLD
    return mesh


# -- tensor parallelism: Megatron's layout over the 'model' axis ------------

class ShardedLinear(nn.Module):
    """A Linear layer of which this rank holds one part of ``parts`` (the
    ``index``-th), in Megatron's layout.  "column": the rows of the weight
    and of the bias of this rank's heads or hidden units (``groups`` 3 for
    qkv: the rank's heads inside each of q, k and v); its replicated input
    enters as is and its gradient is summed over the group.  "row": the
    weight's columns of this rank's heads or hidden units and the whole
    bias; the partial products are summed over the group (the all-reduce)
    and the bias is added once, after it.  ``models.vit._linear`` runs
    both; the parameters keep the names ``weight`` and ``bias``."""

    def __init__(self, weight, bias, *, kind: str, axis: str, parts: int,
                 index: int, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.kind, self.axis = kind, axis
        self.parts, self.index, self.groups = parts, index, groups

    def extra_repr(self):
        return (f"{self.kind}, part {self.index} of {self.parts} over "
                f"{self.axis!r}, weight {tuple(self.weight.shape)}")


# (module, kind, groups) of the sharded layers of a block
_TP_LAYERS = (("attn.qkv", "column", 3), ("attn.proj", "row", 1),
              ("mlp.fc1", "column", 1), ("mlp.fc2", "row", 1))


def _model_spec(keys, ndim: int, model_axis: Optional[str]):
    """The tensor-parallel spec of a parameter (or of a parameter-shaped
    optimizer moment) named by its dotted-name keys, in the torch [out, in]
    layout: a tuple of one axis name or None a dimension, () for a
    replicated leaf.  The layout of JAX ``_model_spec``: qkv and fc1
    (weight and bias) column-parallel, the proj and fc2 weights
    row-parallel, their biases and every other leaf replicated."""
    if model_axis is None or "blocks" not in keys:
        return ()
    if "qkv" in keys or "fc1" in keys:
        return (model_axis, None) if ndim == 2 else (model_axis,)
    if ("proj" in keys or "fc2" in keys) and ndim == 2:
        return (None, model_axis)
    return ()


def param_pspecs(model: nn.Module, model_axis: Optional[str] = None):
    """{parameter name: ``_model_spec``} of ``model`` (the port of JAX
    ``param_pspecs``; the names are the reference's state-dict keys)."""
    return {name: _model_spec(name.split("."), p.dim(), model_axis)
            for name, p in model.named_parameters()}


def _part(full, dim: int, groups: int, parts: int, index: int):
    """Part ``index`` of ``parts`` of ``full`` along ``dim``, cut inside
    each of ``groups`` equal runs (qkv: the rank's heads of q, k and v)."""
    v = full.unflatten(dim, (groups, parts, -1))
    return v.select(dim + 1, index).flatten(dim, dim + 1).contiguous()


def _join(pieces, dim: int, groups: int):
    """The whole of ``_part``'s pieces, given in part order."""
    return torch.cat([p.unflatten(dim, (groups, -1)) for p in pieces],
                     dim=dim + 1).flatten(dim, dim + 1)


class Layout:
    """How the parameters of a model sharded over the inner axis of
    ``mesh`` lie on this rank.  ``axis`` "model": ``specs`` {name: (dim,
    groups)} of the tensor-parallel parts (``shard_params``); "stage":
    the rank holds the blocks ``held`` and every other leaf whole
    (``parallel.pipeline.stage_shard_params``)."""

    def __init__(self, mesh: SeqMesh, axis: str, *, specs=None, held=()):
        self.mesh, self.axis = mesh, axis
        self.specs = specs or {}
        self.held = set(held)

    @staticmethod
    def _block(name: str):
        keys = name.split(".")
        return int(keys[1]) if keys[0] == "blocks" else None

    def is_part(self, name: str) -> bool:
        """True where the rank's tensor of ``name`` is a part of the whole
        (a slice, or under 'stage' a block only this stage holds): its
        squared norm sums over the inner group."""
        if self.axis == "model":
            return name in self.specs
        return self._block(name) is not None

    def gather(self, local: dict) -> dict:
        """The one-rank layout of a {name: tensor} dict of this rank's
        parameters (or parameter-shaped moments): a collective over the
        inner group, every rank calls it with the same names ('model') or
        its own blocks ('stage').  Gathered tensors come back on the
        host."""
        if self.axis == "model":
            out = {}
            for name, t in local.items():
                if name in self.specs:
                    dim, groups = self.specs[name]
                    t = _join([p.cpu() for p in
                               self.mesh.inner_list(t.detach())], dim, groups)
                out[name] = t
            return out
        parts = self.mesh.inner_objects(
            {k: v.detach().cpu() for k, v in local.items()
             if self._block(k) is not None})
        out = dict(local)
        for p in parts:
            out.update(p)
        return out

    def part(self, full: dict) -> dict:
        """This rank's part of a {name: tensor} dict in the one-rank
        layout (no collective)."""
        if self.axis == "model":
            m, j = self.mesh.inner_size, self.mesh.inner_rank
            out = {}
            for name, t in full.items():
                if name in self.specs:
                    dim, groups = self.specs[name]
                    t = _part(torch.as_tensor(t), dim, groups, m, j)
                out[name] = t
            return out
        return {k: v for k, v in full.items()
                if self._block(k) is None or self._block(k) in self.held}


def shard_params(mesh: SeqMesh, model: nn.Module,
                 model_axis: Optional[str] = "model") -> nn.Module:
    """Keep on this rank only its part of every tensor-parallel parameter of
    ``model`` (a ``models.vit.ViTCAM`` with its whole parameters, the same
    on every rank), in place: the port of JAX ``shard_params``.  The qkv and
    fc1 layers become column-parallel ``ShardedLinear`` s (this rank's
    num_heads / m heads inside each of q, k and v; its mlp_hidden / m
    hidden units), proj and fc2 row-parallel; the rest stays whole.
    Without a model axis, or with one of size 1, nothing changes (JAX
    replicates).  Raises where the heads or the hidden width do not divide
    by the model size (JAX's ``device_put`` refuses an uneven sharding) and
    for an int8 model (the JAX dry run replicates quantized parameters)."""
    if model_axis is None or mesh.axis_names[1:] != (model_axis,) \
            or mesh.inner_size == 1:
        return model
    m = mesh.inner_size
    cfg = model.cfg
    for what, n in (("num_heads", cfg.num_heads),
                    ("the MLP hidden width", cfg.mlp_hidden)):
        if n % m:
            raise ValueError(f"tensor parallelism over {m} ranks: {what} "
                             f"{n} is not a multiple of {m}")
    from vision_transformer_cam_tpu_torch.ops.quant import QLinear
    if any(isinstance(mod, QLinear) for mod in model.modules()):
        raise NotImplementedError(
            "tensor parallelism of an int8 model: the JAX package "
            "replicates quantized parameters; shard the float model and "
            "serve it in bf16 (ROADMAP Queue 3)")
    j, specs = mesh.inner_rank, {}
    for i, blk in enumerate(model.blocks):
        for path, kind, groups in _TP_LAYERS:
            holder, attr = blk.get_submodule(path.split(".")[0]), \
                path.split(".")[1]
            lin = getattr(holder, attr)
            dim = 0 if kind == "column" else 1
            w = _part(lin.weight.detach(), dim, groups, m, j)
            b = None if lin.bias is None else lin.bias.detach()
            if b is not None and kind == "column":
                b = _part(b, 0, groups, m, j)
            setattr(holder, attr, ShardedLinear(
                w, None if b is None else b.clone(), kind=kind,
                axis=model_axis, parts=m, index=j, groups=groups))
            name = f"blocks.{i}.{path}"
            specs[f"{name}.weight"] = (dim, groups)
            if b is not None and kind == "column":
                specs[f"{name}.bias"] = (0, groups)
    model.layout = Layout(mesh, model_axis, specs=specs)
    return model


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` in the one-rank layout: a collective over the
    inner group of a sharded model's mesh (every rank calls it)."""
    layout = getattr(model, "layout", None)
    sd = model.state_dict()
    return sd if layout is None else layout.gather(sd)


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load a one-rank-layout state dict into ``model``, each rank its
    part."""
    layout = getattr(model, "layout", None)
    model.load_state_dict(sd if layout is None else layout.part(sd))


def get_world_size() -> int:
    """Ranks in the process group (1 without one): JAX counts devices, and
    the port runs one rank per device."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def all_objects(obj) -> list:
    """Every rank's picklable ``obj``, by world rank (``[obj]`` without a
    process group)."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


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
    """The ambient mesh, which must carry ``seq_axis``; ``field`` names
    what asks for it in the error (a config field, or "layout" for a
    model sharded over that axis)."""
    if _ambient is None or seq_axis not in _ambient.axis_names:
        what = f"cfg.{field}={seq_axis!r}" if field != "layout" else \
            f"its parameters sharded over {seq_axis!r}"
        raise ValueError(
            f"a model with {what} must be called under a "
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
