"""The serving kernels as ``torch.library`` custom ops (namespace ``vitcam``).

A serving forward reaches six hand-written kernels.  Each is registered here
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

A schema has one fixed return, so kernel 1 and the block kernel have one op
per arity.  The implementations are the wrappers of ``kernels/attention.py``
and ``kernels/gemm.py`` unchanged: on a CUDA tensor the kernel (or a raise),
on a CPU tensor the plain version, and the wrappers' launch counters count
every launch made through an op.  Each op's fake implementation states the
wrapper's output shapes and dtypes; a wrong dtype there would change the
casts the traced graph puts after the op.

The functions below have the wrappers' signatures and pick the op; the
model (``models/vit.py``) and ``ops/quant.py`` call them, on the live path
and under export alike.  The kernels no serving forward reaches are not
registered: the v1 split-tensor kernel and the ablation variants (scripts
only), the sequence-parallel kernel (its collectives cannot be exported, and
``cli.export`` refuses ``--seq_parallel``) and the backward (training, which
keeps ``attention.fused_attention_diff``).  No op has an autograd formula.
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


def load_program(path: str, device):
    """The ``ExportedProgram`` that ``cli.export`` saved at ``path`` (its
    ops are registered here), on ``device``: a program exported on another
    card of the same kind (rank 0's, for the ranks of a ``--data_parallel``
    group that each have a card) is moved to this rank's."""
    exported = torch.export.load(path)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        held = {t.device for t in exported.state_dict.values()}
        if held and held != {device}:
            from torch.export.passes import move_to_device_pass
            exported = move_to_device_pass(exported, device)
    return exported
