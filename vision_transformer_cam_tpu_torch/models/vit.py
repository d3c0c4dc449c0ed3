"""Vision Transformer with the CAM attention-mask feedback, for PyTorch.

The port of vision_transformer_cam_tpu/models/vit.py:

* the blocks run in a Python loop that carries the background-token
  indicator bg [B, N]; the reference's additive -100 pair mask is rebuilt
  from it in each block (eager path) or inside the attention kernel;
* attention emits the head-mean cls row, the statistic the mask update,
  the rollout and the top-16 selection need, so nothing forces the
  [B, H, N, N] probabilities out unless a caller asks for them;
* the attention-rollout joint J <- ((hm + I) / 2) J is carried through the
  blocks (updated inside the kernel on the kernel path), in float32 under
  bf16.

Parameter names are the reference's state-dict keys (``blocks.{i}.attn.qkv
.weight``, ...), so its ``.pth`` state dicts load directly
(``io.weights.load_state_dict``).  Images are NHWC, as in the JAX package.
The forward has no host syncs and no data-dependent shapes.

``ViTCAM.forward`` is the eval forward (under ``torch.inference_mode``);
``ViTCAM.forward_train`` is the training forward of the JAX ``forward(...,
train=True, rng=...)``: gradients enabled, the clamped softmax neutralised,
dropout at the embedding and at six sites per block, stochastic depth,
``cfg.remat`` as ``torch.utils.checkpoint`` per block, the int8 routes off,
and on the kernel path the differentiable ``fused_attention_diff``.

int8 serving (``ops.quant.quantize_params`` swaps the GEMMs for ``QLinear``
modules) follows the JAX package's routing: every int8 GEMM goes through the
port's one int8 GEMM kernel (``kernels.gemm.linear_int8``), on the
``int8_fused_gemm`` route or the ``qlinear`` route; on the kernel path the
attention takes int8 qkv (``int8_attn_io``) or writes int8 output
(``int8_attn_out``), and ``ln_quant_fusion`` replaces a LayerNorm whose
consumers are all int8 GEMMs with the fused LayerNorm -> int8 kernel.  The
eager path keeps the JAX XLA path's meaning: int8 GEMMs, float attention,
the int8 attention flags ignored.

The eval forward reaches the serving kernels through their custom ops
(``kernels.ops``: kernel 1, ``linear_int8``, ``ln_quant``, the fused MLP
kernels and the block kernel), the same calls on the live path and under
``torch.export``; ``ServingFn`` is the traceable function ``cli.export``
exports.

The serving fusions follow the JAX routing too, in the eval forward only
(the kernels have no backward): ``cfg.attn_block_fusion`` on the kernel path
replaces the qkv GEMM, the attention, the proj GEMM and the residual add of
a block whose attention layers are float with one launch of
``attention_block_fused`` (a quantized qkv falls through to the attention
kernel); ``cfg.mlp_fusion`` replaces fc1 -> GELU -> fc2 with one launch of
``mlp_fused`` (float layers) or ``mlp_fused_int8`` (two static int8 layers,
fed the float LayerNorm output), and a partially quantized MLP takes the
unfused chain.

Sequence parallelism (``cfg.seq_axis``, set by ``parallel.apply_seq_parallel``;
inference only) is the JAX package's token-sharded layout with the
collectives written out: every rank of a sequence group embeds the same
batch, keeps its slice of the token axis (zero-padded to a multiple of the
group size; the padded rows never reach a statistic or an output), runs
LayerNorm, the GEMMs, the MLP and the residuals on its rows, and meets the
other ranks in the attention (``masked_attention_seq``: K | V gathered, the
cls row from sequence-rank 0), in the rollout and at the end, where the
tokens are gathered and the heads run alike on every rank.  The model must
be called under ``parallel.set_mesh``.

Data parallelism (an ambient mesh whose data axis spans several ranks, and
``cfg.data_axis``, which then requires one) changes one line of the forward:
each rank runs its rows of the global batch, and the batch-global mask norm
takes its max over the data group (``_mask_from_cls_row``).  Nothing else in
the forward couples samples.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vision_transformer_cam_tpu_torch.configs import ViTCAMConfig
from vision_transformer_cam_tpu_torch.kernels.attention import (
    fused_attention_diff, masked_attention_seq)
from vision_transformer_cam_tpu_torch.kernels.ops import (
    attention_block_fused, ln_quant, masked_attention_fused, mlp_fused)
from vision_transformer_cam_tpu_torch.ops.quant import (QLinear,
                                                        linear_int8_fused,
                                                        mlp_fused_int8,
                                                        qlinear,
                                                        qlinear_gelu_requant,
                                                        qlinear_requant)
from vision_transformer_cam_tpu_torch.ops.rollout import (
    aug_cls_row, aug_normalize, cam_from_rollout_row)
from vision_transformer_cam_tpu_torch.parallel.mesh import (ambient_mesh,
                                                            current_mesh)
from vision_transformer_cam_tpu_torch.utils import resolve_device


class ViTCAMOutput(NamedTuple):
    """The reference's 6-tuple return in structured form (same fields as the
    JAX package's ViTCAMOutput).

      logits            cls-head logits [B, num_classes]
      head1_logits      top-16 patch-head logits [B, num_classes]
      attn_cls_rows     head-mean cls attention row per layer [depth, B, N]
      top_patch_embeds  [B, K, C];  top_patch_idx [B, K]
      head1_kernel      head1 weight as [C, num_classes] (JAX layout)
      attn_headmean     [depth, B, N, N] (need_headmean / need_perhead)
      attn_perhead      [depth, B, H, N, N] (need_perhead)
      block_outputs     [depth, B, N, C] (need_blocks)
      rollout_row       row 0 of the rollout joint [B, N] (need_rollout)
      tokens_prenorm    final block output before the last LayerNorm
      dist_logits       distilled models in training only, else None
    """

    logits: torch.Tensor
    head1_logits: torch.Tensor
    attn_cls_rows: torch.Tensor
    top_patch_embeds: torch.Tensor
    top_patch_idx: torch.Tensor
    head1_kernel: torch.Tensor
    attn_headmean: Optional[torch.Tensor] = None
    attn_perhead: Optional[torch.Tensor] = None
    block_outputs: Optional[torch.Tensor] = None
    rollout_row: Optional[torch.Tensor] = None
    tokens_prenorm: Optional[torch.Tensor] = None
    dist_logits: Optional[torch.Tensor] = None


# config knobs of the JAX package that this package does not implement yet,
# with the ROADMAP item that ports them
_UNPORTED = {}

# cfg.matmul_precision -> torch.set_float32_matmul_precision: full float32,
# or TF32 in the cuBLAS GEMMs ("high").  The hand-written kernels' in-kernel
# products stay float32 either way, the hybrid the JAX package runs on its
# TPU kernels.
_MATMUL_PRECISION = {None: "highest", "highest": "highest",
                     "float32": "highest", "high": "high",
                     "tensorfloat32": "high"}


@contextlib.contextmanager
def matmul_precision(cfg: ViTCAMConfig):
    """``cfg.matmul_precision`` set around a forward and restored after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(
        _MATMUL_PRECISION[cfg.matmul_precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def check_supported(cfg: ViTCAMConfig) -> None:
    """Raise for a configuration this package cannot run as asked."""
    if cfg.attn_impl not in ("eager", "kernel"):
        raise ValueError(f"attn_impl {cfg.attn_impl!r}: expected 'eager' or "
                         "'kernel'")
    for name, item in _UNPORTED.items():
        if getattr(cfg, name):
            raise NotImplementedError(
                f"cfg.{name}={getattr(cfg, name)!r} is not ported yet "
                f"(ROADMAP {item})")
    if cfg.seq_axis:
        bad = [name for name in
               ("attn_block_fusion", "mlp_fusion", "ln_quant_fusion",
                "int8_fused_gemm", "int8_attn_io", "int8_attn_out")
               if getattr(cfg, name)]
        if bad:
            raise ValueError(
                f"cfg.seq_axis={cfg.seq_axis!r} (sequence parallelism) "
                f"composes with attn_impl='kernel', but {', '.join(bad)} "
                "request batch-axis kernel fusions that would see "
                "sequence-sharded operands. Drop those knobs (plain int8 "
                "qlinear GEMMs are fine) or drop seq_axis.")
    if cfg.matmul_precision not in _MATMUL_PRECISION:
        raise ValueError(
            f"matmul_precision={cfg.matmul_precision!r}: expected one of "
            f"{[k for k in _MATMUL_PRECISION]}")
    if cfg.attn_q_block not in (0, 16, 32):
        raise ValueError(
            f"attn_q_block={cfg.attn_q_block!r}: the attention kernel's "
            "query tile is 16 or 32 rows (0 = auto)")
    if cfg.attn_block_b < 0:
        raise ValueError(f"attn_block_b={cfg.attn_block_b!r} must be >= 0")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _layer_norm(x, weight, bias, eps):
    # affine params cast to the activation dtype, so float32 params never
    # promote a bf16 residual stream
    return F.layer_norm(x, (x.shape[-1],), weight.to(x.dtype),
                        bias.to(x.dtype), eps)


def _gelu(x, approx=False):
    return F.gelu(x, approximate="tanh" if approx else "none")


def _linear(x, lin, cfg: ViTCAMConfig):
    """GEMM dispatch.  A float layer runs in the activation dtype (the
    weights are cast, a no-op unless params and activations differ).  A
    ``QLinear`` runs the int8 GEMM: with ``cfg.int8_fused_gemm``, a static
    act_scale and a float x on the fused route (x * inv_a, acc * cs), else
    on the qlinear route (x / act_scale or int8 x, (acc * sx) * ws)."""
    if isinstance(lin, QLinear):
        if cfg.int8_fused_gemm and lin.act_scale is not None \
                and x.dtype != torch.int8:
            return linear_int8_fused(x, lin, out_dtype=cfg.dtype)
        return qlinear(x, lin, out_dtype=cfg.dtype)
    dtype = cfg.dtype
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _is_static(lin, *extra) -> bool:
    """An int8 layer with a static act_scale (and the named buffers)."""
    return isinstance(lin, QLinear) and lin.act_scale is not None and all(
        getattr(lin, name) is not None for name in extra)


# the dropout sites of one block, in the JAX body's order
_SITES = ("attn", "proj", "mlp1", "mlp2", "dp1", "dp2")
_EMBED_SITE = 0xD0


def _fold(seed: int, *data: int) -> int:
    """A new seed from ``seed`` and integers (the port's jax.random.fold_in):
    every dropout site of every layer and step draws from its own stream."""
    for d in data:
        seed = (seed * 6364136223846793005 + d + 1442695040888963407) \
            % (1 << 63)
    return seed


def _uniform(shape, seed: int, device):
    """float32 U[0, 1) of ``shape`` from a generator seeded with ``seed``, so
    a block recomputed under ``torch.utils.checkpoint`` (which restores only
    the global RNG state) redraws the same mask."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def _dropout(x, rate: float, seed: Optional[int]):
    if rate == 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, seed, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _drop_path(x, rate: float, seed: Optional[int]):
    """Per-sample stochastic depth."""
    if seed is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.floor(keep + _uniform(shape, seed, x.device)).to(x.dtype)
    return x / keep * mask


def _ftz(t):
    """Probabilities ``t`` with values below the dtype's smallest normal
    flushed to zero, as XLA computes them on the TPU and on the CPU, and as
    the kernels do: a patch the feedback masked has the logit s - 100, and
    exp(-100) is a float32 denormal, so its cls-row weight is exactly 0 and
    it ties with the other masked patches in the top-16 selection.  Applied
    to every path's cls row in the block loop and to the head-mean and
    per-head statistics the eager attention returns; the P V product keeps
    the denormals, which move its output by less than 1e-38 |v|."""
    return t.masked_fill(t < torch.finfo(t.dtype).tiny, 0.0)


def _top_k(x, k):
    """Indices of the k largest values over the last axis, the lower index
    first among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _attention_eager(ap, x, bg, cfg: ViTCAMConfig, need_probs, joint=None,
                     hm_dtype=None, train=False, rngs=None):
    """Reference-shaped attention with the symmetric pair mask
    mask_value * min(bg_q + bg_k, 1), clamp (serving) after the mask.
    Returns (out, cls_row [B, N], headmean or None, perhead or None, None);
    ``joint`` is not consumed here: the caller updates the rollout.  With
    ``rngs`` (training) dropout falls on the probabilities and on the
    projection's output."""
    b, n, c = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    qkv = _linear(x, ap.qkv, cfg)
    q, k, v = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    attn = torch.matmul(q, k.transpose(-1, -2)) * cfg.scale
    pair = torch.clamp_max(bg[:, :, None] + bg[:, None, :], 1.0)
    attn = attn + (cfg.mask_value * pair)[:, None, :, :]
    if cfg.softmax_clamp:
        attn = torch.clamp_max(attn, 80.0)
    probs = torch.softmax(attn, dim=-1)
    cls_row = probs[:, :, 0, :].mean(dim=1)     # flushed by the caller
    hm = _ftz(probs.mean(dim=1)) if need_probs else None
    used = _dropout(probs, cfg.attn_drop_ratio, rngs["attn"]) if rngs \
        else probs
    out = torch.matmul(used, v).transpose(1, 2).reshape(b, n, c)
    out = _linear(out, ap.proj, cfg)
    if rngs:
        out = _dropout(out, cfg.drop_ratio, rngs["proj"])
    ph = _ftz(probs) if need_probs == "perhead" else None
    if hm is not None and hm_dtype is not None:
        hm = hm.to(hm_dtype)
    return out, cls_row, hm, ph, None


def attention_kernel(ap, x, bg, cfg: ViTCAMConfig, need_probs, joint=None,
                     hm_dtype=None, train=False, rngs=None):
    """Same signature and returns as ``_attention_eager``, through the fused
    attention kernel: with ``joint`` it returns the updated rollout joint as
    the fifth value (rollout variant); need_probs "headmean" emits the
    head-mean matrix; otherwise the plain variant.  The per-head
    probabilities only the eager path produces.

    Under ``train`` only the plain call is differentiable
    (``fused_attention_diff``: forward kernel, backward kernel).  By a static
    rule on the arguments, as the JAX attention_pallas, a training call goes
    to the eager path when it needs the rollout joint, the head mean, the
    per-head probabilities, or dropout on the probabilities or the
    projection (``rngs`` with ``attn_drop_ratio`` or ``drop_ratio`` > 0);
    the int8 options are off under ``train``.

    int8 routing, as the JAX attention_pallas: with ``cfg.int8_attn_io`` and
    a static int8 qkv carrying per-head [3, H] out_scales, the qkv GEMM
    requantizes its output per head, the kernel
    takes int8 qkv and writes int8 output at the proj layer's act_scale;
    with ``cfg.int8_attn_out`` and a static int8 proj, float qkv and int8
    output.  ``x`` may be int8 (from ``ln_quant``)."""
    needs_dropout = rngs is not None and (cfg.attn_drop_ratio > 0
                                          or cfg.drop_ratio > 0)
    if need_probs == "perhead" or needs_dropout or (
            train and (joint is not None or need_probs == "headmean")):
        return _attention_eager(ap, x, bg, cfg, need_probs, joint=joint,
                                hm_dtype=hm_dtype, train=train, rngs=rngs)
    if train:
        if _MATMUL_PRECISION[cfg.matmul_precision] != "highest":
            # the JAX package sends this case to its XLA path; nothing here
            # leaves the kernels unasked
            raise ValueError(
                f"matmul_precision={cfg.matmul_precision!r} with "
                "attn_impl='kernel' in training: the backward kernel's "
                "products are full float32; train this precision with "
                "attn_impl='eager'")
        qkv = _linear(x, ap.qkv, cfg)
        out, cls_row = fused_attention_diff(
            qkv, bg, num_heads=cfg.num_heads, scale=cfg.scale,
            mask_value=cfg.mask_value, clamp_softmax=cfg.softmax_clamp)
        return _linear(out, ap.proj, cfg), cls_row.to(cfg.dtype), None, \
            None, None
    scales = None
    if cfg.int8_attn_io and _is_static(ap.qkv, "out_scales") \
            and _is_static(ap.proj):
        osc = ap.qkv.out_scales
        if tuple(osc.shape) != (3, cfg.num_heads):
            raise ValueError(f"qkv out_scales must be per head [3, "
                             f"{cfg.num_heads}], got {tuple(osc.shape)}")
        flat = osc.reshape(-1)
        qkv = qlinear_requant(x, ap.qkv, flat, groups=3 * cfg.num_heads)
        scales = torch.cat([flat, ap.proj.inv_act.reshape(1)])
    else:
        qkv = _linear(x, ap.qkv, cfg)
        if cfg.int8_attn_out and _is_static(ap.proj):
            scales = ap.proj.inv_act.reshape(1)
    kw = dict(num_heads=cfg.num_heads, scale=cfg.scale,
              mask_value=cfg.mask_value, clamp_softmax=cfg.softmax_clamp,
              float_dtype=cfg.dtype, q_block=cfg.attn_q_block)
    hm = newj = None
    if joint is not None:
        out, cls_row, newj = masked_attention_fused(qkv, bg, joint, scales,
                                                    **kw)
    elif need_probs == "headmean":
        out, cls_row, hm = masked_attention_fused(
            qkv, bg, None, scales, with_headmean=True, hm_dtype=hm_dtype,
            **kw)
    else:
        out, cls_row = masked_attention_fused(qkv, bg, None, scales, **kw)
    out = _linear(out, ap.proj, cfg)
    return out, cls_row.to(cfg.dtype), hm, None, newj


def _attention_seq(ap, x, bg, cfg: ViTCAMConfig, need_probs, mesh,
                   hm_dtype=None):
    """Attention on one rank of a sequence group.  x: [B, NQ, C], this rank's
    rows of the padded token axis; bg: [B, N], the same on every rank.
    Returns (out [B, NQ, C], cls_row [B, N] the same on every rank, the
    local rows of the head mean [B, NQ, N] or None, the local rows of the
    per-head probabilities [B, H, NQ, N] or None).

    ``attn_impl="kernel"`` goes through ``masked_attention_seq``; the
    per-head probabilities only the eager form produces.  The eager form is
    ``_attention_eager`` on the local query rows against the gathered K and
    V, cut back to the N real keys, with the symmetric pair mask and the
    clamp after it."""
    b, nq, c = x.shape
    n, h, dh = cfg.seq_len, cfg.num_heads, cfg.head_dim
    bg_local = mesh.local_rows(bg)
    qkv = _linear(x, ap.qkv, cfg)
    if cfg.attn_impl == "kernel" and need_probs != "perhead":
        res = masked_attention_seq(
            qkv, bg_local, group=mesh, n_real=n, num_heads=h,
            scale=cfg.scale, mask_value=cfg.mask_value,
            with_headmean=need_probs == "headmean",
            clamp_softmax=cfg.softmax_clamp, hm_dtype=hm_dtype)
        out, cls_row = res[0], _ftz(res[1].to(cfg.dtype))
        hm = res[2] if need_probs == "headmean" else None
        return _linear(out, ap.proj, cfg), cls_row, hm, None
    q, k, v = qkv.reshape(b, nq, 3, h, dh).permute(2, 0, 3, 1, 4)
    k = mesh.all_gather(k.contiguous(), dim=2)[:, :, :n]
    v = mesh.all_gather(v.contiguous(), dim=2)[:, :, :n]
    attn = torch.matmul(q, k.transpose(-1, -2)) * cfg.scale
    pair = torch.clamp_max(bg_local[:, :, None] + bg[:, None, :], 1.0)
    attn = attn + (cfg.mask_value * pair)[:, None, :, :]
    if cfg.softmax_clamp:
        attn = torch.clamp_max(attn, 80.0)
    probs = torch.softmax(attn, dim=-1)
    cls_row = mesh.broadcast_from_seq0(
        _ftz(probs[:, :, 0, :].mean(dim=1)).contiguous())
    hm = _ftz(probs.mean(dim=1)) if need_probs else None
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, nq, c)
    out = _linear(out, ap.proj, cfg)
    if hm is not None and hm_dtype is not None:
        hm = hm.to(hm_dtype)
    return out, cls_row, hm, _ftz(probs) if need_probs == "perhead" else None


def _mask_from_cls_row(cls_row, cfg: ViTCAMConfig):
    """One rollout step on the cls row -> normalized patch weights mask14
    [B, num_patches] and the bg indicator [B, N].  Prefix tokens are never
    background.

    The batch-global norm divides by the max over the whole global batch:
    under an ambient mesh whose data axis spans several ranks (data
    parallelism, or the data groups of the sequence-parallel grid) the
    rank's max of the detached cls row is all-reduced (MAX) over the data
    group, as JAX's ``jnp.max(mask_i)`` spans the GSPMD-sharded batch
    (vision_transformer_cam_tpu/models/vit.py:307-310).  It is the only
    place where the forward couples samples; the per-sample norm needs no
    collective."""
    mask_i = aug_cls_row(cls_row)[:, cfg.num_tokens:]
    if cfg.per_sample_mask_norm:
        mask14 = mask_i / mask_i.amax(dim=-1, keepdim=True)
    else:
        top = mask_i.amax()                      # batch-global, as reference
        mesh = ambient_mesh()
        if mesh is not None:
            top = mesh.data_max(top)
        mask14 = mask_i / top
    bg_patches = (mask14 < cfg.mask_threshold).to(cls_row.dtype)
    prefix = torch.zeros((cls_row.shape[0], cfg.num_tokens),
                         dtype=cls_row.dtype, device=cls_row.device)
    return mask14, torch.cat([prefix, bg_patches], dim=1)


# ---------------------------------------------------------------------------
# modules (names follow the reference's state-dict keys)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim, qkv_bias, **fk):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **fk)
        self.proj = nn.Linear(dim, dim, **fk)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, **fk):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **fk)
        self.fc2 = nn.Linear(hidden, dim, **fk)


class Block(nn.Module):
    def __init__(self, cfg: ViTCAMConfig, **fk):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, **fk)
        self.attn = Attention(d, cfg.qkv_bias, **fk)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, **fk)
        self.mlp = Mlp(d, cfg.mlp_hidden, **fk)


class PatchEmbed(nn.Module):
    """The reference's p x p / stride p conv, kept in its [D, C, p, p] layout
    and applied as a reshape plus one GEMM on NHWC images (no cuDNN, so no
    TF32 convolution).  ``ops.quant.quantize_params`` replaces ``proj`` with
    a ``QLinear`` of the [D, p*p*C] GEMM weight."""

    def __init__(self, cfg: ViTCAMConfig, **fk):
        super().__init__()
        p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
        self.img_size, self.patch_size = cfg.img_size, p
        self.proj = nn.ParameterDict({
            "weight": nn.Parameter(torch.empty((d, c, p, p), **fk)),
            "bias": nn.Parameter(torch.empty((d,), **fk))})

    def weight2d(self):
        """The conv weight as the [D, p*p*C] GEMM weight (K in the NHWC
        patch order p, p, C)."""
        weight = self.proj["weight"]
        return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)

    def forward(self, x, cfg: ViTCAMConfig):
        """x: [B, H, W, C] -> [B, num_patches, D] in ``cfg.dtype``."""
        b, h, w, c = x.shape
        p = self.patch_size
        if h != self.img_size or w != self.img_size:
            raise ValueError(
                f"Input image size ({h}*{w}) doesn't match model "
                f"({self.img_size}*{self.img_size}).")
        g = h // p
        x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, g * g, p * p * c)
        if isinstance(self.proj, QLinear):
            return _linear(x.to(cfg.dtype).contiguous(), self.proj, cfg)
        dtype = cfg.dtype
        return F.linear(x.to(dtype), self.weight2d().to(dtype),
                        self.proj["bias"].to(dtype))


class PreLogits(nn.Module):
    def __init__(self, dim, rep, **fk):
        super().__init__()
        self.fc = nn.Linear(dim, rep, **fk)


class ServingFn(nn.Module):
    """The serving function that ``cli.export`` exports (the JAX
    ``cli/export.py: build_fn``'s ``fn``): images [B, H, W, 3] float32 ->
    (logits, head1_logits, cam [B, g, g]), or the first two when
    ``with_cam`` is false.  The eval forward of ``model`` without
    ``torch.inference_mode`` (an inference-mode trace is not exportable) and
    without ``matmul_precision``, a process global no graph records: the
    caller sets it around the call."""

    def __init__(self, model: "ViTCAM", with_cam: bool = True):
        super().__init__()
        self.model = model
        self.with_cam = with_cam

    def forward(self, images):
        cfg = self.model.cfg
        out = self.model._forward(images, False, None, False, False, False,
                                  self.with_cam)
        if not self.with_cam:
            return out.logits, out.head1_logits
        cam = cam_from_rollout_row(out.rollout_row, cfg.grid_size)
        return out.logits, out.head1_logits, cam


class ViTCAM(nn.Module):
    """ViT-CAM model.  ``cfg`` may be replaced after construction (for
    example by ``serving.apply_serving_mode`` or to switch ``attn_impl``); the
    parameters stay.  They are built on ``device``: the card by default
    (``utils.resolve_device``), the CPU only when asked (``device="cpu"``)."""

    def __init__(self, cfg: ViTCAMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=cfg.param_dtype)
        d, nc = cfg.embed_dim, cfg.num_classes
        self.patch_embed = PatchEmbed(cfg, **fk)
        self.cls_token = nn.Parameter(torch.empty((1, 1, d), **fk))
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.empty((1, 1, d), **fk))
        self.pos_embed = nn.Parameter(torch.empty((1, cfg.seq_len, d), **fk))
        self.blocks = nn.ModuleList(Block(cfg, **fk) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps, **fk)
        if cfg.has_logits:
            self.pre_logits = PreLogits(d, cfg.representation_size, **fk)
        self.head = nn.Linear(cfg.representation_size if cfg.has_logits
                              else d, nc, **fk)
        if cfg.distilled:
            self.head_dist = nn.Linear(d, nc, **fk)
        self.head1 = nn.Linear(d, nc, **fk)
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's init scheme, drawn on the CPU from ``generator``
        (so a seed gives the same weights on every device): trunc-normal
        (std 0.01, cut at +-2) Linears with zero bias, trunc-normal (0.02)
        tokens and position embedding, kaiming-normal (fan_out) patch
        embedding, unit LayerNorms, and torch's default Linear init for
        head1, which the reference creates after its init pass."""
        cfg = self.cfg

        def fill(t, draw):
            tmp = torch.empty(t.shape,
                              dtype=torch.promote_types(t.dtype, torch.float32))
            draw(tmp)
            t.copy_(tmp)

        def trunc(t, std):
            fill(t, lambda a: nn.init.trunc_normal_(
                a, std=std, a=-2.0, b=2.0, generator=generator))

        def linear(lin, std=0.01):
            trunc(lin.weight, std)
            if lin.bias is not None:
                lin.bias.zero_()

        fan_out = cfg.embed_dim * cfg.patch_size * cfg.patch_size
        fill(self.patch_embed.proj["weight"], lambda a: a.normal_(
            0.0, math.sqrt(2.0 / fan_out), generator=generator))
        self.patch_embed.proj["bias"].zero_()
        trunc(self.cls_token, 0.02)
        trunc(self.pos_embed, 0.02)
        if cfg.distilled:
            trunc(self.dist_token, 0.02)
            linear(self.head_dist)
        for ln in [self.norm] + [m for blk in self.blocks
                                 for m in (blk.norm1, blk.norm2)]:
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                linear(lin)
        if cfg.has_logits:
            linear(self.pre_logits.fc)
        linear(self.head)
        bound = 1.0 / math.sqrt(cfg.embed_dim)
        for t in (self.head1.weight, self.head1.bias):
            fill(t, lambda a: a.uniform_(-bound, bound, generator=generator))

    def embed_tokens(self, x, cfg: Optional[ViTCAMConfig] = None):
        """Patch embed, prefix tokens (cls, + dist when distilled), position
        embedding, under ``cfg`` (default ``self.cfg``).  x: [B, H, W, C] ->
        tokens [B, N, D]."""
        cfg = cfg or self.cfg
        b = x.shape[0]
        tokens = self.patch_embed(x, cfg)
        prefix = [self.cls_token]
        if cfg.distilled:
            prefix.append(self.dist_token)
        prefix = [t.to(cfg.dtype).expand(b, 1, cfg.embed_dim) for t in prefix]
        tokens = torch.cat(prefix + [tokens], dim=1)
        return tokens + self.pos_embed.to(cfg.dtype)

    @torch.inference_mode()
    def forward(self, x, *, need_headmean=False, need_blocks=False,
                need_perhead=False, need_rollout=False) -> ViTCAMOutput:
        """x: [B, H, W, C] images.  Returns ViTCAMOutput (eval semantics)."""
        with matmul_precision(self.cfg):
            return self._forward(x, False, None, need_headmean, need_blocks,
                                 need_perhead, need_rollout)

    def forward_train(self, x, *, rng: Optional[int] = None,
                      need_headmean=False, need_blocks=False,
                      need_perhead=False,
                      need_rollout=False) -> ViTCAMOutput:
        """The training forward, with gradients: the clamped softmax is
        neutralised (the backward differentiates the unclamped softmax), the
        int8 routes are off, distilled models return ``dist_logits`` beside
        unaveraged ``logits``, and ``cfg.remat`` recomputes each block in the
        backward.  ``rng`` (an integer seed, folded per layer and site) turns
        dropout and stochastic depth on at the config's ratios; None leaves
        them off.  ``attn_cls_rows`` and the bg mask carry no gradient."""
        with matmul_precision(self.cfg):
            return self._forward(x, True, rng, need_headmean, need_blocks,
                                 need_perhead, need_rollout)

    def _forward(self, x, train, rng, need_headmean, need_blocks,
                 need_perhead, need_rollout) -> ViTCAMOutput:
        cfg = self.cfg
        check_supported(cfg)
        if cfg.data_axis and not cfg.seq_axis:
            # data parallelism: the rows are this rank's share of the global
            # batch, and the batch-global mask norm reads the mesh
            current_mesh(cfg.data_axis, "data_axis")
        if cfg.seq_axis:
            if train:
                raise NotImplementedError(
                    "forward_train under cfg.seq_axis (sequence-parallel "
                    "training) is not ported yet (ROADMAP Queue 1 item 10, "
                    "its second half)")
            return self._forward_seq(x, need_headmean, need_blocks,
                                     need_perhead, need_rollout)
        if train and cfg.softmax_clamp:
            cfg = cfg.replace(softmax_clamp=False)
        attn_fn = attention_kernel if cfg.attn_impl == "kernel" \
            else _attention_eager
        tokens = self.embed_tokens(x, cfg)
        use_rng = train and rng is not None
        if use_rng:
            tokens = _dropout(tokens, cfg.drop_ratio, _fold(rng, _EMBED_SITE))
        # read only with dropout on: an export trace would read the tensor
        # on the host
        dpr = torch.linspace(0.0, cfg.drop_path_ratio, cfg.depth).tolist() \
            if use_rng else None
        b, n, dev = tokens.shape[0], cfg.seq_len, tokens.device
        bg = torch.zeros((b, n), dtype=cfg.dtype, device=dev)
        need_probs = "perhead" if need_perhead else (
            "headmean" if (need_headmean or need_rollout) else None)
        # the joint product accumulates across all layers: float32 even under
        # bf16 serving
        rollout_dtype = torch.float32 if cfg.dtype == torch.bfloat16 \
            else cfg.dtype
        want_post = (n > 512) if cfg.rollout_post is None else cfg.rollout_post
        rollout_post = (need_rollout and want_post and not train
                        and not (need_headmean or need_perhead))
        carry_rollout = need_rollout and not rollout_post
        # the kernel updates the joint itself unless the head-mean matrices
        # are collected too
        fuse_rollout = carry_rollout and not (need_headmean or need_perhead)
        joint = torch.eye(n, dtype=rollout_dtype, device=dev).expand(
            b, n, n).contiguous() if carry_rollout else None
        # fused LN -> int8 (serving): only where every consumer of the LN
        # output is an int8 GEMM with a static act_scale
        kernel_io = cfg.attn_impl == "kernel" and cfg.int8_attn_io

        def ln_q_attn(blk):
            return (cfg.ln_quant_fusion and not train and kernel_io
                    and _is_static(blk.attn.qkv, "out_scales")
                    and _is_static(blk.attn.proj))

        def ln_q_mlp(blk):
            return (cfg.ln_quant_fusion and not train and not cfg.mlp_fusion
                    and _is_static(blk.mlp.fc1) and _is_static(blk.mlp.fc2))

        # the whole-sub-block kernel: inference on the kernel path, and no
        # stacked probabilities wanted (it emits the rollout update, not the
        # head-mean matrices)
        use_block_kernel = (cfg.attn_impl == "kernel" and not train
                            and cfg.attn_block_fusion
                            and need_probs in (None, "headmean")
                            and (need_probs is None or fuse_rollout))

        def block(i, blk, tokens, bg, joint):
            rngs = {site: _fold(rng, i + 1, j)
                    for j, site in enumerate(_SITES)} if use_rng else None
            xn = ln_quant(tokens, blk.norm1.weight, blk.norm1.bias,
                          eps=cfg.ln_eps, inv_a=blk.attn.qkv.inv_act) \
                if ln_q_attn(blk) else \
                _layer_norm(tokens, blk.norm1.weight, blk.norm1.bias,
                            cfg.ln_eps)
            ap, dt = blk.attn, cfg.dtype
            if use_block_kernel and not isinstance(ap.qkv, QLinear) \
                    and not isinstance(ap.proj, QLinear):
                # the whole sub-block in one launch: its result replaces the
                # attention call and the residual add
                bqkv = ap.qkv.bias if ap.qkv.bias is not None else \
                    torch.zeros((3 * cfg.embed_dim,), dtype=dt, device=dev)
                res = attention_block_fused(
                    xn, tokens, ap.qkv.weight.to(dt), bqkv.to(dt),
                    ap.proj.weight.to(dt), ap.proj.bias.to(dt), bg,
                    joint if fuse_rollout else None, num_heads=cfg.num_heads,
                    scale=cfg.scale, mask_value=cfg.mask_value,
                    clamp_softmax=cfg.softmax_clamp)
                tokens, cls_row = res[0], res[1].to(dt)
                newj = res[2] if fuse_rollout else None
                hm = ph = None
            else:
                o, cls_row, hm, ph, newj = attn_fn(
                    ap, xn, bg, cfg, need_probs,
                    joint=joint if fuse_rollout else None,
                    hm_dtype=rollout_dtype if rollout_post else None,
                    train=train, rngs=rngs)
                if use_rng and cfg.drop_path_ratio > 0:
                    o = _drop_path(o, dpr[i], rngs["dp1"])
                tokens = tokens + o
            f1, f2 = blk.mlp.fc1, blk.mlp.fc2
            yn = ln_quant(tokens, blk.norm2.weight, blk.norm2.bias,
                          eps=cfg.ln_eps, inv_a=f1.inv_act) \
                if ln_q_mlp(blk) else \
                _layer_norm(tokens, blk.norm2.weight, blk.norm2.bias,
                            cfg.ln_eps)
            # serving-only fused MLP kernels (no backward): the int8 one where
            # both layers are static int8, the float one where both are
            # float; a partially quantized MLP takes the unfused chain
            use_mlp_kernel = cfg.mlp_fusion and not train
            if use_mlp_kernel and _is_static(f1) and _is_static(f2):
                ymlp = mlp_fused_int8(yn, f1, f2, gelu_approx=cfg.gelu_approx,
                                      out_dtype=dt)
            elif use_mlp_kernel and not isinstance(f1, QLinear) \
                    and not isinstance(f2, QLinear):
                ymlp = mlp_fused(yn, f1.weight.to(dt), f1.bias.to(dt),
                                 f2.weight.to(dt), f2.bias.to(dt),
                                 gelu_approx=cfg.gelu_approx)
            else:
                if _is_static(f1) and _is_static(f2) and not train:
                    # int8 serving: fc1's epilogue emits GELU(fc1)
                    # requantized to fc2's act_scale, so fc2 reads int8
                    hmid = qlinear_gelu_requant(yn, f1, f2.act_scale,
                                                gelu_approx=cfg.gelu_approx)
                else:
                    hmid = _gelu(_linear(yn, f1, cfg), cfg.gelu_approx)
                    if use_rng:
                        hmid = _dropout(hmid, cfg.drop_ratio, rngs["mlp1"])
                ymlp = _linear(hmid, f2, cfg)
            if use_rng:
                ymlp = _dropout(ymlp, cfg.drop_ratio, rngs["mlp2"])
                if cfg.drop_path_ratio > 0:
                    ymlp = _drop_path(ymlp, dpr[i], rngs["dp2"])
            tokens = tokens + ymlp
            # the cls row feeds thresholds and top-k indices only: no
            # gradient.  Flushed on every path: the eager softmax, the
            # kernels' float32 designs and the plain versions on the CPU keep
            # the denormal weights of masked keys, which would rank the
            # masked patches in the top-16 where JAX ties them at 0
            cls_row = _ftz(cls_row.detach())
            # this block's attention sets the mask of the next block
            if i >= cfg.mask_from:
                _, bg = _mask_from_cls_row(cls_row, cfg)
            if carry_rollout:
                if newj is not None:
                    joint = newj
                else:
                    pt = torch.promote_types(torch.float32, joint.dtype)
                    joint = torch.matmul(aug_normalize(hm).to(pt),
                                         joint.to(pt)).to(joint.dtype)
            return tokens, bg, joint, cls_row, hm, ph

        cls_rows, hms, phs, blocks_out = [], [], [], []
        for i, blk in enumerate(self.blocks):
            if train and cfg.remat:
                # keep only the block's inputs for the backward and recompute
                # its internals (qkv, the MLP hidden tensor) there
                tokens, bg, joint, cls_row, hm, ph = checkpoint(
                    block, i, blk, tokens, bg, joint, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                tokens, bg, joint, cls_row, hm, ph = block(i, blk, tokens, bg,
                                                           joint)
            cls_rows.append(cls_row)
            if need_headmean or need_perhead or rollout_post:
                hms.append(hm)
            if need_perhead:
                phs.append(ph)
            if need_blocks:
                blocks_out.append(tokens)

        rollout_row = None
        if carry_rollout:
            rollout_row = joint[:, 0, :]
        elif rollout_post:
            # row = ((e_cls A_L) A_{L-1}) ... A_1 with A_l = (hm_l + I) / 2
            chain_dt = torch.promote_types(torch.float32, rollout_dtype)
            r = torch.zeros((b, n), dtype=chain_dt, device=dev)
            r[:, 0] = 1.0
            for hm_l in reversed(hms):
                prod = torch.bmm(r[:, None, :], hm_l.to(chain_dt))[:, 0]
                r = 0.5 * (prod + r)
            rollout_row = r.to(rollout_dtype)

        collect = need_headmean or need_perhead
        return self._heads(
            cfg, tokens, torch.stack(cls_rows), rollout_row, train,
            attn_headmean=torch.stack(hms) if collect else None,
            attn_perhead=torch.stack(phs) if need_perhead else None,
            block_outputs=torch.stack(blocks_out) if need_blocks else None)

    def _heads(self, cfg, tokens, cls_rows, rollout_row, train, *,
               attn_headmean, attn_perhead, block_outputs) -> ViTCAMOutput:
        """What follows the blocks: the top-16 patch head, the final
        LayerNorm and the class heads, on complete tokens [B, N, C] and cls
        rows [depth, B, N]."""
        # top-K high-weight patch head, over the patch tokens
        mask14, _ = _mask_from_cls_row(cls_rows[-1], cfg)
        top_idx = _top_k(mask14, cfg.top_k_patches)
        patch_tokens = tokens[:, cfg.num_tokens:, :]
        top_embeds = torch.gather(
            patch_tokens, 1,
            top_idx[:, :, None].expand(-1, -1, cfg.embed_dim))
        head1_logits = _linear(top_embeds.mean(dim=1), self.head1, cfg)

        xf = _layer_norm(tokens, self.norm.weight, self.norm.bias, cfg.ln_eps)
        cls_feat = xf[:, 0]
        if cfg.has_logits:
            cls_feat = torch.tanh(_linear(cls_feat, self.pre_logits.fc, cfg))
        logits = _linear(cls_feat, self.head, cfg)
        dist_logits = None
        if cfg.distilled:
            dist_logits = _linear(xf[:, 1], self.head_dist, cfg)
            # train: the heads stay separate (the loss reads dist_logits so
            # head_dist trains); eval: their average
            if not train:
                logits = (logits + dist_logits) / 2.0
        return ViTCAMOutput(
            logits=logits,
            head1_logits=head1_logits,
            attn_cls_rows=cls_rows,
            top_patch_embeds=top_embeds,
            top_patch_idx=top_idx,
            head1_kernel=self.head1.weight.detach().t(),
            attn_headmean=attn_headmean,
            attn_perhead=attn_perhead,
            block_outputs=block_outputs,
            rollout_row=rollout_row,
            tokens_prenorm=tokens,
            dist_logits=dist_logits if train else None,
        )

    def _forward_seq(self, x, need_headmean, need_blocks, need_perhead,
                     need_rollout) -> ViTCAMOutput:
        """The eval forward on one rank of a sequence group (see the module
        docstring).  Every rank of the group passes the same ``x``; every
        output is complete and the same on every rank, as the unsharded
        forward's."""
        cfg = self.cfg
        mesh = current_mesh(cfg.seq_axis)
        if mesh.seq_size > 1 and any(
                isinstance(m, QLinear) and m.act_scale is None
                for m in self.blocks.modules()):
            # a dynamic scale is the absmax of the whole activation tensor;
            # a rank sees only its rows
            raise NotImplementedError(
                "int8 layers without static act scales (dynamic per-tensor "
                "quantization) under cfg.seq_axis: calibrate the scales "
                "(serving.apply_serving_mode)")
        # embedded alike on every rank, then cut to this rank's rows
        tokens = mesh.local_rows(self.embed_tokens(x, cfg)).contiguous()
        b, nq, dev = tokens.shape[0], tokens.shape[1], tokens.device
        n = cfg.seq_len
        bg = torch.zeros((b, n), dtype=cfg.dtype, device=dev)
        need_probs = "perhead" if need_perhead else (
            "headmean" if (need_headmean or need_rollout) else None)
        rollout_dtype = torch.float32 if cfg.dtype == torch.bfloat16 \
            else cfg.dtype
        want_post = (n > 512) if cfg.rollout_post is None else cfg.rollout_post
        rollout_post = (need_rollout and want_post
                        and not (need_headmean or need_perhead))
        carry_rollout = need_rollout and not rollout_post
        # this rank's rows of the identity, for (hm + I) and as J_0's rows
        eye_local = mesh.local_rows(
            torch.eye(n, dtype=rollout_dtype, device=dev), dim=0)
        joint = eye_local.expand(b, nq, n).contiguous() if carry_rollout \
            else None

        cls_rows, hms, phs, blocks_out = [], [], [], []
        for i, blk in enumerate(self.blocks):
            xn = _layer_norm(tokens, blk.norm1.weight, blk.norm1.bias,
                             cfg.ln_eps)
            o, cls_row, hm, ph = _attention_seq(
                blk.attn, xn, bg, cfg, need_probs, mesh,
                hm_dtype=rollout_dtype if rollout_post else None)
            tokens = tokens + o
            f1, f2 = blk.mlp.fc1, blk.mlp.fc2
            yn = _layer_norm(tokens, blk.norm2.weight, blk.norm2.bias,
                             cfg.ln_eps)
            if _is_static(f1) and _is_static(f2):
                hmid = qlinear_gelu_requant(yn, f1, f2.act_scale,
                                            gelu_approx=cfg.gelu_approx)
            else:
                hmid = _gelu(_linear(yn, f1, cfg), cfg.gelu_approx)
            tokens = tokens + _linear(hmid, f2, cfg)
            # the cls row is the same on every rank, and so is the mask
            if i >= cfg.mask_from:
                _, bg = _mask_from_cls_row(cls_row, cfg)
            if carry_rollout:
                # J' rows local = aug(hm) rows local @ all of J
                pt = torch.promote_types(torch.float32, joint.dtype)
                aug = hm + eye_local.to(hm.dtype)
                aug = aug / aug.sum(dim=-1, keepdim=True)
                full = mesh.all_gather(joint, dim=1)[:, :n]
                joint = torch.matmul(aug.to(pt), full.to(pt)).to(joint.dtype)
            cls_rows.append(cls_row)
            if need_headmean or need_perhead or rollout_post:
                hms.append(hm)
            if need_perhead:
                phs.append(ph)
            if need_blocks:
                blocks_out.append(tokens)

        rollout_row = None
        if carry_rollout:
            rollout_row = mesh.broadcast_from_seq0(joint[:, 0, :].contiguous())
        elif rollout_post:
            # the reversed chain: each rank adds r[its rows] . hm[its rows];
            # the padded rows of r are zero
            chain_dt = torch.promote_types(torch.float32, rollout_dtype)
            r = torch.zeros((b, n), dtype=chain_dt, device=dev)
            r[:, 0] = 1.0
            for hm_l in reversed(hms):
                part = torch.bmm(mesh.local_rows(r)[:, None, :],
                                 hm_l.to(chain_dt))[:, 0]
                r = 0.5 * (mesh.all_reduce_sum(part) + r)
            rollout_row = r.to(rollout_dtype)

        def rows(t, dim):
            """Local rows gathered into the complete tensor, padding cut."""
            return mesh.all_gather(t, dim=dim).narrow(dim, 0, n)

        collect = need_headmean or need_perhead
        return self._heads(
            cfg, rows(tokens, 1), torch.stack(cls_rows), rollout_row, False,
            attn_headmean=rows(torch.stack(hms), 2) if collect else None,
            attn_perhead=rows(torch.stack(phs), 3) if need_perhead else None,
            block_outputs=rows(torch.stack(blocks_out), 2) if need_blocks
            else None)
