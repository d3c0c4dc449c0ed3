"""The serving kernels as ``torch.library`` custom ops (namespace ``vitcam``).

A serving forward reaches seven hand-written kernels.  Each is registered here
as a custom op whose implementation calls the kernel's wrapper, so that a
``torch.export`` program of the forward (``cli/export.py``) holds
``vitcam::...`` nodes and launches the kernels wherever it runs on the card:

  vitcam::masked_attention_fused        kernel 1, plain variant: (out, cls_row)
  vitcam::masked_attention_fused_stats  kernel 1 with the head mean or the
                                        rollout update: (out, cls_row, third)
  vitcam::linear_int8                   the int8 GEMM, every route / epilogue
  vitcam::ln_quant                      LayerNorm -> int8 (Triton)
  vitcam::mlp_fused                     fc1 -> GELU -> fc2, float layers
  vitcam::mlp_fused_int8                the same on two static int8 layers
  vitcam::attention_block_fused         the attention sub-block: (out, cls_row)
  vitcam::attention_block_fused_rollout the same with the rollout update
  vitcam::masked_attention_seq_local    the sequence-parallel kernel on one
                                        rank's query rows: (out, row0)
  vitcam::masked_attention_seq_local_hm the same with the head mean:
                                        (out, row0, hm)

A schema has one fixed return, so kernel 1, the block kernel and the
sequence-parallel kernel have one op per arity.  The implementations are the
wrappers of ``kernels/attention.py`` and ``kernels/gemm.py`` unchanged: on a
CUDA tensor the kernel (or a raise), on a CPU tensor the plain version, and
the wrappers' launch counters count every launch made through an op.  Each
op's fake implementation states the wrapper's output shapes and dtypes; a
wrong dtype there would change the casts the traced graph puts after the op.

The functions below have the wrappers' signatures and pick the op; the
model (``models/vit.py``), ``ops/quant.py`` and
``attention.masked_attention_seq`` call them, on the live path and under
export alike.  The kernels no serving forward reaches are not
registered: the v1 split-tensor kernel and the ablation variants (scripts
only) and the backward (training, which keeps
``attention.fused_attention_diff``).  The sequence-parallel kernel's op holds
the kernel alone: the all-gathers of K | V and of the key mask around it and
the broadcast of the cls row after it are the functional collectives of
``parallel.mesh.SeqMesh``, which a traced program holds as
``_c10d_functional`` nodes.  No op has an autograd formula.
"""

from __future__ import annotations

from typing import Optional

import torch

from vision_transformer_cam_tpu_torch.kernels import attention as ka
from vision_transformer_cam_tpu_torch.kernels import gemm

Tensor = torch.Tensor


def _attention_dtypes(qkv, bg, joint, scales, num_heads, with_headmean,
                      hm_dtype, float_dtype):
    """(out dtype, cls_row dtype, third dtype or None) of kernel 1, with the
    wrapper's shape and scales checks."""
    ka._check_shapes(qkv, bg, joint, num_heads)
    kind = ka._scales_kind(qkv, scales, num_heads)
    f_dtype = float_dtype if kind in (ka._PER_TENSOR, ka._PER_HEAD) \
        else qkv.dtype
    third = joint.dtype if joint is not None else (
        (hm_dtype or f_dtype) if with_headmean else None)
    return (torch.int8 if kind else qkv.dtype), f_dtype, third


@torch.library.custom_op("vitcam::masked_attention_fused", mutates_args=())
def _attention(qkv: Tensor, bg: Tensor, scales: Optional[Tensor],
               num_heads: int, scale: float, mask_value: float,
               clamp_softmax: bool, float_dtype: torch.dtype,
               q_block: int) -> tuple[Tensor, Tensor]:
    return ka.masked_attention_fused(
        qkv, bg, None, scales, num_heads=num_heads, scale=scale,
        mask_value=mask_value, clamp_softmax=clamp_softmax,
        float_dtype=float_dtype, q_block=q_block)


@_attention.register_fake
def _(qkv, bg, scales, num_heads, scale, mask_value, clamp_softmax,
      float_dtype, q_block):
    out_dt, cls_dt, _ = _attention_dtypes(qkv, bg, None, scales, num_heads,
                                          False, None, float_dtype)
    b, n, c3 = qkv.shape
    return (qkv.new_empty((b, n, c3 // 3), dtype=out_dt),
            qkv.new_empty((b, n), dtype=cls_dt))


@torch.library.custom_op("vitcam::masked_attention_fused_stats",
                         mutates_args=())
def _attention_stats(qkv: Tensor, bg: Tensor, joint: Optional[Tensor],
                     scales: Optional[Tensor], num_heads: int, scale: float,
                     mask_value: float, with_headmean: bool,
                     clamp_softmax: bool, hm_dtype: Optional[torch.dtype],
                     float_dtype: torch.dtype,
                     q_block: int) -> tuple[Tensor, Tensor, Tensor]:
    return ka.masked_attention_fused(
        qkv, bg, joint, scales, num_heads=num_heads, scale=scale,
        mask_value=mask_value, with_headmean=with_headmean,
        clamp_softmax=clamp_softmax, hm_dtype=hm_dtype,
        float_dtype=float_dtype, q_block=q_block)


@_attention_stats.register_fake
def _(qkv, bg, joint, scales, num_heads, scale, mask_value, with_headmean,
      clamp_softmax, hm_dtype, float_dtype, q_block):
    out_dt, cls_dt, third_dt = _attention_dtypes(
        qkv, bg, joint, scales, num_heads, with_headmean, hm_dtype,
        float_dtype)
    b, n, c3 = qkv.shape
    return (qkv.new_empty((b, n, c3 // 3), dtype=out_dt),
            qkv.new_empty((b, n), dtype=cls_dt),
            qkv.new_empty((b, n, n), dtype=third_dt))


def masked_attention_fused(qkv, bg, joint=None, scales=None, *,
                           num_heads: int, scale: float,
                           mask_value: float = -100.0,
                           with_headmean: bool = False,
                           clamp_softmax: bool = False, hm_dtype=None,
                           float_dtype=torch.bfloat16, q_block: int = 0):
    """``kernels.attention.masked_attention_fused`` through its op: two
    outputs for the plain variant, three with ``joint`` or
    ``with_headmean``."""
    if joint is None and not with_headmean:
        return _attention(qkv, bg, scales, num_heads, scale, mask_value,
                          clamp_softmax, float_dtype, q_block)
    return _attention_stats(qkv, bg, joint, scales, num_heads, scale,
                            mask_value, with_headmean, clamp_softmax,
                            hm_dtype, float_dtype, q_block)


@torch.library.custom_op("vitcam::linear_int8", mutates_args=())
def _linear_int8(x: Tensor, weight_q: Tensor, col_scale: Tensor,
                 bias: Optional[Tensor], a_scale: Tensor, route: str,
                 epilogue: str, out_scales: Optional[Tensor], groups: int,
                 gelu_approx: bool, out_dtype: torch.dtype) -> Tensor:
    return gemm.linear_int8(x, weight_q, col_scale, bias, a_scale,
                            route=route, epilogue=epilogue,
                            out_scales=out_scales, groups=groups,
                            gelu_approx=gelu_approx, out_dtype=out_dtype)


@_linear_int8.register_fake
def _(x, weight_q, col_scale, bias, a_scale, route, epilogue, out_scales,
      groups, gelu_approx, out_dtype):
    gemm._check_linear(x, weight_q, col_scale, bias, a_scale, route,
                       epilogue, out_scales, groups)
    return x.new_empty((*x.shape[:-1], weight_q.shape[0]),
                       dtype=out_dtype if epilogue == "float" else torch.int8)


def linear_int8(x, weight_q, col_scale, bias, a_scale, *, route,
                epilogue="float", out_scales=None, groups=1,
                gelu_approx=True, out_dtype=torch.float32):
    """``kernels.gemm.linear_int8`` through its op."""
    return _linear_int8(x, weight_q, col_scale, bias, a_scale, route,
                        epilogue, out_scales, groups, gelu_approx, out_dtype)


@torch.library.custom_op("vitcam::ln_quant", mutates_args=())
def _ln_quant(x: Tensor, weight: Tensor, bias: Tensor, eps: float,
              inv_a: Tensor) -> Tensor:
    return gemm.ln_quant(x, weight, bias, eps=eps, inv_a=inv_a)


@_ln_quant.register_fake
def _(x, weight, bias, eps, inv_a):
    gemm._check_ln(x, weight, bias)
    return x.new_empty(x.shape, dtype=torch.int8)


def ln_quant(x, weight, bias, *, eps: float, inv_a):
    """``kernels.gemm.ln_quant`` through its op."""
    return _ln_quant(x, weight, bias, eps, inv_a)


@torch.library.custom_op("vitcam::mlp_fused", mutates_args=())
def _mlp_fused(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
               gelu_approx: bool) -> Tensor:
    return gemm.mlp_fused(x, w1, b1, w2, b2, gelu_approx=gelu_approx)


@_mlp_fused.register_fake
def _(x, w1, b1, w2, b2, gelu_approx):
    gemm._check_mlp(x, w1, b1, w2, b2)
    return x.new_empty(x.shape)


def mlp_fused(x, w1, b1, w2, b2, *, gelu_approx: bool = True):
    """``kernels.gemm.mlp_fused`` through its op."""
    return _mlp_fused(x, w1, b1, w2, b2, gelu_approx)


@torch.library.custom_op("vitcam::mlp_fused_int8", mutates_args=())
def _mlp_fused_int8(x: Tensor, w1q: Tensor, cs1: Tensor, b1: Optional[Tensor],
                    w2q: Tensor, cs2: Tensor, b2: Optional[Tensor],
                    inv_a1: Tensor, inv_a2: Tensor, gelu_approx: bool,
                    out_dtype: torch.dtype) -> Tensor:
    return gemm.mlp_fused_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2,
                               gelu_approx=gelu_approx, out_dtype=out_dtype)


@_mlp_fused_int8.register_fake
def _(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, gelu_approx, out_dtype):
    gemm._check_mlp_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2)
    return x.new_empty(x.shape, dtype=out_dtype)


def mlp_fused_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2, *,
                   gelu_approx: bool = True, out_dtype=torch.bfloat16):
    """``kernels.gemm.mlp_fused_int8`` through its op."""
    return _mlp_fused_int8(x, w1q, cs1, b1, w2q, cs2, b2, inv_a1, inv_a2,
                           gelu_approx, out_dtype)


@torch.library.custom_op("vitcam::attention_block_fused", mutates_args=())
def _block(xn: Tensor, tokens: Tensor, wqkv: Tensor, bqkv: Tensor,
           wproj: Tensor, bproj: Tensor, bg: Tensor, num_heads: int,
           scale: float, mask_value: float,
           clamp_softmax: bool) -> tuple[Tensor, Tensor]:
    return ka.attention_block_fused(
        xn, tokens, wqkv, bqkv, wproj, bproj, bg, None, num_heads=num_heads,
        scale=scale, mask_value=mask_value, clamp_softmax=clamp_softmax)


@_block.register_fake
def _(xn, tokens, wqkv, bqkv, wproj, bproj, bg, num_heads, scale,
      mask_value, clamp_softmax):
    ka._check_block(xn, tokens, wqkv, bqkv, wproj, bproj, bg, None,
                    num_heads)
    return xn.new_empty(xn.shape), xn.new_empty(bg.shape)


@torch.library.custom_op("vitcam::attention_block_fused_rollout",
                         mutates_args=())
def _block_rollout(xn: Tensor, tokens: Tensor, wqkv: Tensor, bqkv: Tensor,
                   wproj: Tensor, bproj: Tensor, bg: Tensor, joint: Tensor,
                   num_heads: int, scale: float, mask_value: float,
                   clamp_softmax: bool) -> tuple[Tensor, Tensor, Tensor]:
    return ka.attention_block_fused(
        xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint, num_heads=num_heads,
        scale=scale, mask_value=mask_value, clamp_softmax=clamp_softmax)


@_block_rollout.register_fake
def _(xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint, num_heads, scale,
      mask_value, clamp_softmax):
    ka._check_block(xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint,
                    num_heads)
    return xn.new_empty(xn.shape), xn.new_empty(bg.shape), \
        joint.new_empty(joint.shape)


def attention_block_fused(xn, tokens, wqkv, bqkv, wproj, bproj, bg,
                          joint=None, *, num_heads: int, scale: float,
                          mask_value: float = -100.0,
                          clamp_softmax: bool = False):
    """``kernels.attention.attention_block_fused`` through its op: two
    outputs, three with ``joint``."""
    if joint is None:
        return _block(xn, tokens, wqkv, bqkv, wproj, bproj, bg, num_heads,
                      scale, mask_value, clamp_softmax)
    return _block_rollout(xn, tokens, wqkv, bqkv, wproj, bproj, bg, joint,
                          num_heads, scale, mask_value, clamp_softmax)


def _seq_fake(q, kv, bg_q, bg_k, num_heads, with_headmean, hm_dtype,
              n_real):
    ka._check_seq_shapes(q, kv, bg_q, bg_k, num_heads, n_real)
    b, nq, _ = q.shape
    np_ = kv.shape[1]
    out = (q.new_empty(q.shape), q.new_empty((b, np_)))
    if with_headmean:
        return out + (q.new_empty((b, nq, np_), dtype=hm_dtype or q.dtype),)
    return out


@torch.library.custom_op("vitcam::masked_attention_seq_local",
                         mutates_args=())
def _seq(q: Tensor, kv: Tensor, bg_q: Tensor, bg_k: Tensor, num_heads: int,
         scale: float, mask_value: float, clamp_softmax: bool,
         n_real: int) -> tuple[Tensor, Tensor]:
    return ka.masked_attention_seq_local(
        q, kv, bg_q, bg_k, num_heads=num_heads, scale=scale,
        mask_value=mask_value, clamp_softmax=clamp_softmax, n_real=n_real)


@_seq.register_fake
def _(q, kv, bg_q, bg_k, num_heads, scale, mask_value, clamp_softmax,
      n_real):
    return _seq_fake(q, kv, bg_q, bg_k, num_heads, False, None, n_real)


@torch.library.custom_op("vitcam::masked_attention_seq_local_hm",
                         mutates_args=())
def _seq_hm(q: Tensor, kv: Tensor, bg_q: Tensor, bg_k: Tensor,
            num_heads: int, scale: float, mask_value: float,
            clamp_softmax: bool, hm_dtype: Optional[torch.dtype],
            n_real: int) -> tuple[Tensor, Tensor, Tensor]:
    return ka.masked_attention_seq_local(
        q, kv, bg_q, bg_k, num_heads=num_heads, scale=scale,
        mask_value=mask_value, with_headmean=True,
        clamp_softmax=clamp_softmax, hm_dtype=hm_dtype, n_real=n_real)


@_seq_hm.register_fake
def _(q, kv, bg_q, bg_k, num_heads, scale, mask_value, clamp_softmax,
      hm_dtype, n_real):
    return _seq_fake(q, kv, bg_q, bg_k, num_heads, True, hm_dtype, n_real)


def masked_attention_seq_local(q, kv, bg_q, bg_k, *, num_heads: int,
                               scale: float, mask_value: float = -100.0,
                               with_headmean: bool = False,
                               clamp_softmax: bool = False, hm_dtype=None,
                               n_real: int = 0):
    """``kernels.attention.masked_attention_seq_local`` through its op: two
    outputs, three with ``with_headmean``."""
    if with_headmean:
        return _seq_hm(q, kv, bg_q, bg_k, num_heads, scale, mask_value,
                       clamp_softmax, hm_dtype, n_real)
    return _seq(q, kv, bg_q, bg_k, num_heads, scale, mask_value,
                clamp_softmax, n_real)


def program_groups(exported) -> dict:
    """{process-group name: the ``_c10d_functional`` ops that name it} of
    an ``ExportedProgram``: the groups its collectives run on."""
    names = {}
    for node in exported.graph.nodes:
        if node.op == "call_function" and \
                str(node.target).startswith("_c10d_functional.") and \
                isinstance(node.args[-1], str):
            names.setdefault(node.args[-1], set()).add(
                str(node.target).split(".")[1])
    return names


def process_groups(names) -> dict:
    """{name: {"ranks": the group's world ranks, "backend": ...}} of this
    process's process groups ``names``; raises where a name resolves to no
    group this process is a member of."""
    import torch.distributed as dist
    out = {}
    for name in names:
        try:
            pg = torch._C._distributed_c10d._resolve_process_group(name)
        except RuntimeError as e:
            raise RuntimeError(
                f"the program's collectives run on the process group named "
                f"{name!r}, which this process does not hold ({e}); make "
                f"the process grid as the exporter made it, first and in "
                f"its order (the sidecar's seq_parallel)") from None
        out[name] = {"ranks": dist.get_process_group_ranks(pg),
                     "backend": dist.get_backend(pg)}
    return out


def load_program(path: str, device, groups=None):
    """The ``ExportedProgram`` that ``cli.export`` saved at ``path`` (its
    ops are registered here), on ``device``: a program exported on another
    card of the same kind (rank 0's, for the ranks of a ``--data_parallel``
    group that each have a card) is moved to this rank's.

    A program whose collectives name process groups runs only where every
    name resolves to a group of the ranks and the backend the exporter's
    group had: ``groups`` is what the sidecar recorded for this rank
    ({name: {"ranks", "backend"}}, ``process_groups`` at export).  The
    names come from the order in which a process made its groups, so a
    server that made them in another order would run a collective on other
    ranks, or find no group: both raise here."""
    exported = torch.export.load(path)
    names = program_groups(exported)
    if names:
        have = process_groups(names)
        want = groups or {}
        for name in sorted(names):
            if want.get(name) != have[name]:
                raise RuntimeError(
                    f"the program's process group {name!r} "
                    f"({', '.join(sorted(names[name]))}) was exported as "
                    f"{want.get(name)}, but here it is {have[name]}: make "
                    f"the process grid as the exporter made it, first and "
                    f"in its order")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        held = {t.device for t in exported.state_dict.values()}
        if held and held != {device}:
            from torch.export.passes import move_to_device_pass
            exported = move_to_device_pass(exported, device)
    return exported
