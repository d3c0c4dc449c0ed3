"""Int8 W8A8 quantization for the serving path (the port of
vision_transformer_cam_tpu/ops/quant.py).

Weights are symmetric per output channel, activations symmetric per tensor
with a static scale from ``calibrate_act_scales`` (or a dynamic absmax when a
layer has none).  A quantized GEMM is a ``QLinear`` module holding
torch-layout buffers:

  weight_q      int8 [out, in] (K-contiguous, what an int8 dot along K reads)
  weight_scale  float32 [out]
  act_scale     float32 scalar, or None (dynamic absmax quantization)
  bias          float32 [out], or None (qkv_bias=False)
  out_scales    float32 [3, H] per-head (q, k, v) output scales on qkv (int8
                attention I/O), or None

Every int8 GEMM goes through ``kernels.gemm.linear_int8`` by its custom op
(``kernels.ops``): the CUDA kernel on CUDA tensors, its plain PyTorch
version on CPU tensors.  Each function below follows the op order of the
JAX function it ports (divide against multiply-by-inverse, ``(acc * sx) *
scale`` against ``acc * cs``), so the CPU tests can hold the int8 tensors
bit for bit.  Rounding is round half to even
(``torch.round``, as ``jnp.round``), clipped to +-127.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vision_transformer_cam_tpu_torch.kernels import ops as kops


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: w ~ w_q * scale[:, None].

    w: [out, in] (torch layout; the reduction runs over ``in``).  Returns
    (w_q int8 [out, in], scale float32 [out]); the same values as the JAX
    function on the transposed [in, out] kernel."""
    w32 = w.detach().to(torch.float32)
    amax = w32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    wq = torch.clamp(torch.round(w32 / scale[..., None]), -127, 127)
    return wq.to(torch.int8), scale


class QLinear(nn.Module):
    """An int8 linear layer (see the module docstring for its buffers).
    ``inv_act`` (1 / act_scale) and ``comb_scale`` (weight_scale x
    act_scale, the fused route's column scale) are derived once here, with
    the same float32 operations the JAX package runs per call."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 act_scale: Optional[torch.Tensor] = None,
                 out_scales: Optional[torch.Tensor] = None):
        super().__init__()
        if weight_q.dtype != torch.int8 or weight_q.dim() != 2:
            raise TypeError(f"weight_q must be int8 [out, in], got "
                            f"{weight_q.dtype} {tuple(weight_q.shape)}")
        dev = weight_q.device

        def f32(t):
            return None if t is None else torch.as_tensor(
                t, dtype=torch.float32, device=dev).detach().clone()

        self.register_buffer("weight_q", weight_q.contiguous())
        self.register_buffer("weight_scale", f32(weight_scale).reshape(-1))
        self.register_buffer("bias", None if bias is None
                             else f32(bias).reshape(-1))
        act = None if act_scale is None else f32(act_scale).reshape(())
        self.register_buffer("act_scale", act)
        self.register_buffer("out_scales", f32(out_scales))
        self.register_buffer("inv_act", None, persistent=False)
        self.register_buffer("comb_scale", None, persistent=False)
        self._derive()

    def _derive(self):
        act = self.act_scale
        self.inv_act = None if act is None else 1.0 / act
        self.comb_scale = None if act is None else combined_scale(self)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

    @classmethod
    def from_float(cls, weight, bias=None, act_scale=None, out_scales=None):
        wq, scale = quantize_weight(weight)
        return cls(wq, scale, bias, act_scale, out_scales)

    def extra_repr(self) -> str:
        out, k = self.weight_q.shape
        return f"in={k}, out={out}, static={self.act_scale is not None}"


def _dynamic_scale(x):
    return torch.clamp_min(x.to(torch.float32).abs().amax(), 1e-8) / 127.0


def _qlinear_call(x, ql: QLinear, **kw):
    """The qlinear route of the int8 GEMM: x int8 (already quantized to the
    layer's static scale), or float quantized as round(x / act_scale)."""
    if x.dtype == torch.int8:
        if ql.act_scale is None:
            raise ValueError(
                "int8 input to qlinear requires a static act_scale on the "
                "consuming layer (the producer must requantize to it); a "
                "dynamically-quantized layer cannot accept int8 inputs")
        sx = ql.act_scale
    elif ql.act_scale is not None:
        sx = ql.act_scale
    else:
        sx = _dynamic_scale(x)
    return kops.linear_int8(x, ql.weight_q, ql.weight_scale, ql.bias, sx,
                            route="qlinear", **kw)


def qlinear(x, ql: QLinear, out_dtype=torch.bfloat16):
    """y = x @ w.T + b with int8 x int8 -> int32.  Activation scale: static
    (``ql.act_scale``) when present, dynamic per-tensor absmax otherwise; an
    int8 ``x`` is taken as already quantized to the static scale."""
    return _qlinear_call(x, ql, epilogue="float", out_dtype=out_dtype)


def qlinear_requant(x, ql: QLinear, out_scales, groups: int = 3):
    """int8 GEMM whose output is requantized to int8 in the epilogue:
    round(y / s_col), one scale per contiguous output group (3 for the
    q|k|v thirds, 3H for the per-head scales sq_0..sq_{H-1}, sk_*, sv_*).
    The bias is added before the requantization."""
    return _qlinear_call(x, ql, epilogue="requant",
                         out_scales=out_scales.reshape(-1), groups=groups)


def combined_scale(ql: QLinear):
    """weight_scale x act_scale [out] float32: the fused route's column
    scale."""
    return (ql.weight_scale * ql.act_scale).to(torch.float32)


def qlinear_gelu_requant(x, ql: QLinear, out_scale, gelu_approx=True):
    """fc1 GEMM -> GELU -> int8 requantize to ``out_scale`` (fc2's
    act_scale) as one epilogue: the hidden activation leaves the GEMM as
    int8."""
    return _qlinear_call(x, ql, epilogue="gelu",
                         out_scales=torch.as_tensor(out_scale).reshape(1),
                         gelu_approx=gelu_approx)


def linear_int8_fused(x, ql: QLinear, out_dtype=torch.bfloat16):
    """The JAX ``int8_fused_gemm`` route (kernels/gemm.py:
    linear_int8_fused): quant(x * inv_a) @ w_q, dequantized by the combined
    scale, plus bias.  Needs a static act_scale and a float ``x``."""
    return kops.linear_int8(x, ql.weight_q, ql.comb_scale, ql.bias,
                            ql.inv_act, route="fused", epilogue="float",
                            out_dtype=out_dtype)


def mlp_fused_int8(x, fc1: QLinear, fc2: QLinear, gelu_approx=True,
                   out_dtype=torch.bfloat16):
    """The JAX ``mlp_fusion`` route for two static int8 layers
    (kernels/gemm.py: mlp_fused_int8): fc1 -> GELU -> fc2 in one launch, the
    float ``x`` quantized in the kernel by ``x * inv_act``."""
    return kops.mlp_fused_int8(
        x, fc1.weight_q, fc1.comb_scale, fc1.bias, fc2.weight_q,
        fc2.comb_scale, fc2.bias, fc1.inv_act, fc2.inv_act,
        gelu_approx=gelu_approx, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# model-level quantization and calibration
# ---------------------------------------------------------------------------

_BLOCK_GEMMS = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                ("mlp", "fc2"))


@torch.no_grad()
def _refuse_sharded(model):
    if getattr(model, "layout", None) is not None:
        raise NotImplementedError(
            f"int8 serving of a model sharded over {model.layout.axis!r}: "
            "the JAX package replicates quantized parameters (ROADMAP "
            "Queue 3)")


def quantize_params(model, act_scales=None):
    """Replace the patch-embed GEMM and the four GEMMs of every block with
    ``QLinear`` modules, in place, and return the model; the heads stay
    float.  ``act_scales`` (from ``calibrate_act_scales``) attaches static
    activation scales and the qkv output scales; without it every layer
    quantizes its input dynamically.  A model sharded over 'model' or
    'stage' is refused: the JAX package replicates quantized parameters."""
    _refuse_sharded(model)
    a = act_scales or {}
    ab = a.get("blocks", {})
    pe = model.patch_embed
    if not isinstance(pe.proj, QLinear):
        pe.proj = QLinear.from_float(pe.weight2d(), pe.proj["bias"],
                                     a.get("patch_embed"))
    for i, blk in enumerate(model.blocks):
        for parent, name in _BLOCK_GEMMS:
            owner = getattr(blk, parent)
            lin = getattr(owner, name)
            if isinstance(lin, QLinear):
                continue
            act = ab[name][i] if name in ab else None
            osc = ab["qkv_out"][i] if (name == "qkv" and "qkv_out" in ab) \
                else None
            setattr(owner, name, QLinear.from_float(
                lin.weight.detach(),
                None if lin.bias is None else lin.bias.detach(), act, osc))
    return model


def _absmax(x):
    return x.to(torch.float32).abs().amax()


@torch.inference_mode()
def calibrate_act_scales(model, cfg, images, margin: float = 1.0):
    """One float forward over a calibration batch at ``cfg.dtype``,
    recording the absmax of every quantized GEMM's input and the per-head
    (q, k, v) absmax of each qkv output; returns the act_scales tree for
    ``quantize_params`` (scale = absmax * margin / 127):

      {"patch_embed": float, "blocks": {"qkv", "proj", "fc1", "fc2":
       float32 [depth], "qkv_out": float32 [depth, 3, H]}}

    ``model`` must still hold float weights.  Attention runs with the
    serving graph's math (symmetric pair mask, then the clamp when
    ``cfg.softmax_clamp``), as the JAX ``_attn_calib``."""
    _refuse_sharded(model)
    from vision_transformer_cam_tpu_torch.models import vit as m

    dev = model.pos_embed.device
    x = torch.as_tensor(images, dtype=torch.float32, device=dev).to(cfg.dtype)
    s_patch = _absmax(x)
    tokens = model.embed_tokens(x, cfg)
    b = x.shape[0]
    bg = torch.zeros((b, cfg.seq_len), dtype=cfg.dtype, device=dev)
    sc = {"qkv": [], "proj": [], "fc1": [], "fc2": []}
    qkv_out_amax = []

    def dense(t, lin):
        y = torch.matmul(t, lin.weight.to(cfg.dtype).t())
        return y if lin.bias is None else y + lin.bias.to(cfg.dtype)

    for i, blk in enumerate(model.blocks):
        xn = m._layer_norm(tokens, blk.norm1.weight, blk.norm1.bias,
                           cfg.ln_eps)
        sc["qkv"].append(_absmax(xn))
        qkv_out = dense(xn, blk.attn.qkv)
        qh = qkv_out.reshape(b, cfg.seq_len, 3, cfg.num_heads,
                             cfg.head_dim).to(torch.float32).abs()
        qkv_out_amax.append(qh.amax(dim=(0, 1, 4)))
        pre, cls_row = _attn_calib(qkv_out, bg, cfg)
        sc["proj"].append(_absmax(pre))
        tokens = tokens + dense(pre, blk.attn.proj)
        yn = m._layer_norm(tokens, blk.norm2.weight, blk.norm2.bias,
                           cfg.ln_eps)
        sc["fc1"].append(_absmax(yn))
        hmid = m._gelu(dense(yn, blk.mlp.fc1), cfg.gelu_approx)
        sc["fc2"].append(_absmax(hmid))
        tokens = tokens + dense(hmid, blk.mlp.fc2)
        if i >= cfg.mask_from:
            _, bg = m._mask_from_cls_row(cls_row, cfg)

    # float32 products, as the JAX package's numpy and jnp ones; the patch
    # absmax it multiplies as a Python float
    f = margin / 127.0
    ff = torch.tensor(f, dtype=torch.float32, device=dev)
    blocks = {k: torch.stack(v) * ff for k, v in sc.items()}
    blocks["qkv_out"] = torch.stack(qkv_out_amax) * ff
    return {"patch_embed": float(s_patch) * f, "blocks": blocks}


def _attn_calib(qkv_out, bg, cfg):
    """(pre_proj [B, N, C], cls_row [B, N]) from the fused qkv output: one
    attention pass in ``cfg.dtype`` with the symmetric pair mask."""
    b, n, _ = qkv_out.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q, k, v = qkv_out.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * cfg.scale
    pair = torch.clamp_max(bg[:, :, None] + bg[:, None, :], 1.0)
    s = s + (cfg.mask_value * pair)[:, None, :, :]
    if cfg.softmax_clamp:
        s = torch.clamp_max(s, 80.0)
    p = torch.softmax(s, dim=-1)
    cls_row = p.mean(dim=1)[:, 0, :]
    o = torch.matmul(p, v)
    return o.transpose(1, 2).reshape(b, n, h * dh), cls_row
