"""Pseudo semantic-segmentation label generation (validate.py:123-262); the
port of vision_transformer_cam_tpu/cam/pseudo_seg.py.

The reference runs this at batch_size=1 with Python loops over classes,
features and patches.  Here the whole resolution-independent part is one
batched function on tensors (``pseudo_seg_device``, on the model's device):

  1. class gating: sigmoid(head1) >= cls_threshold (validate.py:132-134);
  2. feature->class: argmax over gated head1 weights (:135-143);
  3. feature->patch: argmax contribution over the 16 gathered patch
     embeddings (:145-148);
  4. patch->class via the torch.mode trick (:146-153), as a count histogram
     (smallest-of-most-frequent tie-break, exactly torch.mode; not
     ``torch.mode`` itself, which would need the per-image loop back), with
     the reference's arange-filler fallback 21+p for patches no feature maps
     to;
  5. cosine similarity maps of each top-16 patch vs all patches at grid
     resolution (:163-174);
  6. background rollout row over blocks [bg_blocks_from:] (:224-235).

Only the per-image bilinear upsample to the ORIGINAL image size and the
final thresholded composition (:177-257) run on the host, because VOC images
have per-image shapes; that part is vectorized numpy (or the native library
where it is built), and one device->host read per batch feeds it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vision_transformer_cam_tpu_torch.configs import (PseudoSegConfig,
                                                      ViTCAMConfig)
from vision_transformer_cam_tpu_torch.ops.rollout import bg_rollout_row


class PseudoSegDeviceOut(NamedTuple):
    patch_to_cls: torch.Tensor   # [B, K] int32: class id per top-K patch, or
    #                              the reference's filler 21+p fallback
    cos_maps: torch.Tensor       # [B, K, g, g] cosine similarity maps
    bg_row: torch.Tensor         # [B, g, g] rollout bg weights in [0, 1]


def _first_argmax(x, dim):
    """argmax that returns the FIRST maximum, as jnp.argmax and the
    reference's loops do (torch.argmax leaves the choice among ties open)."""
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    idx = torch.arange(size, device=x.device).reshape(shape)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, idx, size).amin(dim=dim)


def _patch_class_assignment(probs, head1_kernel_t, top_embeds, cls_threshold):
    """Steps 1-4 above.  probs [B,C]; head1_kernel_t [C,D] (torch layout:
    class-major); top_embeds [B,K,D]."""
    b, k, d = top_embeds.shape
    c = probs.shape[-1]
    predcls = probs >= cls_threshold                         # [B, C]
    # non-predicted class rows to -10 (validate.py:135-142)
    gated = torch.where(predcls[:, :, None], head1_kernel_t[None],
                        torch.full_like(head1_kernel_t[None], -10.0))
    cls_to_feat = _first_argmax(gated, 1)                    # [B, D] class/ft
    contrib = _first_argmax(top_embeds, 1)                   # [B, D] patch/ft
    # histogram: counts[b, p, cl] = #features assigned patch p with class cl
    flat = contrib * c + cls_to_feat                         # [B, D]
    counts = torch.zeros((b, k * c), dtype=torch.float32,
                         device=probs.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    counts = counts.reshape(b, k, c)
    # torch.mode tie-break = smallest of the most frequent values; class ids
    # always < the arange fillers, so: if any feature lands on the patch the
    # smallest argmax class wins, else the untouched filler column minimum
    # num_classes+1+p, 21+p for the reference's 20 classes (validate.py:146);
    # basing it on c keeps fillers collision-free when num_classes > 20.
    best = _first_argmax(counts, -1).to(torch.int32)         # [B, K]
    has_any = counts.sum(dim=-1) > 0
    filler = (c + 1) + torch.arange(k, dtype=torch.int32,
                                    device=probs.device)[None, :]
    return torch.where(has_any, best, filler)


@torch.inference_mode()
def pseudo_seg_device(out, cfg: ViTCAMConfig,
                      pcfg: PseudoSegConfig) -> PseudoSegDeviceOut:
    """The batched, resolution-independent device math, on ``out`` (a
    ``models.vit.ViTCAMOutput``)."""
    g = cfg.grid_size
    probs = torch.sigmoid(out.head1_logits)
    patch_to_cls = _patch_class_assignment(
        probs, out.head1_kernel.t().to(out.top_patch_embeds.dtype),
        out.top_patch_embeds, pcfg.cls_threshold)

    # cosine maps (validate.py:163-174): L2-normalize final-block patch
    # embeddings (pre final-norm) and the K gathered embeddings; torch
    # F.normalize clamps the norm at 1e-12 (validate.py:168-169): a zero-norm
    # row must yield 0.0 cosines, not NaN
    patch_embed = out.tokens_prenorm[:, cfg.num_tokens:, :]      # [B, P, D]
    pe = patch_embed / torch.linalg.vector_norm(
        patch_embed, dim=-1, keepdim=True).clamp_min(1e-12)
    he = out.top_patch_embeds / torch.linalg.vector_norm(
        out.top_patch_embeds, dim=-1, keepdim=True).clamp_min(1e-12)
    cos = torch.einsum("bkd,bpd->bkp", he, pe)                   # [B, K, P]
    cos_maps = cos.reshape(cos.shape[0], cos.shape[1], g, g)

    bg = bg_rollout_row(out.attn_cls_rows, pcfg.bg_blocks_from,
                        prefix_tokens=cfg.num_tokens)           # [B, P]
    bg_row = bg.reshape(bg.shape[0], g, g)
    return PseudoSegDeviceOut(patch_to_cls, cos_maps, bg_row)


def np_bilinear_resize(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """torch F.interpolate(mode='bilinear', align_corners=False) in numpy:
    half-pixel centers, edge clamp, no antialias.  x: [..., H, W]."""
    h, w = x.shape[-2:]
    oh, ow = size
    ys = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    # Separable two-pass form — BIT-IDENTICAL to the naive 4-gather form
    # (same lerp expressions in the same order: out = top + (bot-top)*wy
    # where top/bot are the W-lerped source rows) but ~3x cheaper: the W
    # pass runs once per SOURCE row (h of them) instead of once per output
    # row (oh of them, each source row redone oh/h times), and the H pass
    # gathers 2 full-size arrays instead of 4.  This is the hot op of the
    # BASELINE-config-#3 host pipeline .
    left = x[..., :, x0]
    right = x[..., :, x1]
    rows = left + (right - left) * wx                   # [..., h, ow]
    top = rows[..., y0, :]
    bot = rows[..., y1, :]
    return top + (bot - top) * wy[:, None]


def _narrow_seg(seg: np.ndarray) -> np.ndarray:
    # uint8 is the palette-PNG contract (VOC: ids <= 2*20+K+2); filler ids
    # from a num_classes large enough to overflow it would WRAP into
    # valid-looking foreground classes — keep int64 there instead
    return seg.astype(np.uint8) if seg.max(initial=0) < 256 \
        else seg.astype(np.int64)


def compose_pseudo_seg(patch_to_cls: np.ndarray, cos_maps: np.ndarray,
                       bg_row: np.ndarray, size: Tuple[int, int],
                       pcfg: PseudoSegConfig,
                       allow_native: bool = True) -> np.ndarray:
    """Per-image host composition (validate.py:177-257) at the original
    (h, w): upsample the K cosine maps + bg row, argmax/threshold, map patch
    ids to classes (+1 foreground offset), gate by fg and bg masks.

    Routes through the native fused kernel (native/vitcam_io.cc
    vitcam_compose_one — all-double, same lerp expression order, so outputs
    are bit-identical; tests/test_pseudo_seg.py pins both paths against the
    torch transliteration) when the library is available; the numpy below
    is the reference implementation and the fallback."""
    if allow_native:
        from vision_transformer_cam_tpu_torch.io import native_loader
        if native_loader.compose_available():
            return _narrow_seg(native_loader.compose_batch(
                np.asarray(cos_maps)[None], np.asarray(bg_row)[None],
                np.asarray(patch_to_cls)[None], [size],
                pcfg.fg_cos_threshold, pcfg.bg_rollout_threshold,
                num_threads=1)[0])
    cos_up = np_bilinear_resize(cos_maps.astype(np.float64), size)  # [K,h,w]
    winner = np.argmax(cos_up, axis=0)                              # [h, w]
    winner_v = np.max(cos_up, axis=0)
    fg = winner_v >= pcfg.fg_cos_threshold                          # :184-186
    bg_up = np_bilinear_resize(bg_row.astype(np.float64), size)
    bg = bg_up >= pcfg.bg_rollout_threshold                         # :244-246
    seg = patch_to_cls.astype(np.int64)[winner] + 1                 # :190-208
    seg = seg * fg * bg                                             # :248-257
    return _narrow_seg(seg)


def _to_host(dev: PseudoSegDeviceOut):
    """One device->host read for the three tensors, packed as one float
    array (float32, or float64 for a float64 model; bf16 has no numpy type,
    and the class ids are small integers that a float holds exactly)."""
    b, k, g, _ = dev.cos_maps.shape
    dt = torch.float64 if dev.cos_maps.dtype == torch.float64 \
        else torch.float32
    host = torch.cat([dev.cos_maps.to(dt).flatten(1),
                      dev.bg_row.to(dt).flatten(1),
                      dev.patch_to_cls.to(dt)], dim=1).cpu().numpy()
    n_cos, n_bg = k * g * g, g * g
    return (host[:, n_cos + n_bg:].astype(np.int32),
            host[:, :n_cos].reshape(b, k, g, g),
            host[:, n_cos:n_cos + n_bg].reshape(b, g, g))


def pseudo_seg_batch(out, cfg: ViTCAMConfig, pcfg: PseudoSegConfig,
                     sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Full pipeline for a batch: device math once, one read to the host,
    host composition per image at its own original size (native threaded
    kernel when available, numpy otherwise: the same bits either way)."""
    patch_to_cls, cos_maps, bg_row = _to_host(pseudo_seg_device(out, cfg,
                                                                pcfg))
    from vision_transformer_cam_tpu_torch.io import native_loader
    if native_loader.compose_available():
        return [_narrow_seg(s) for s in native_loader.compose_batch(
            cos_maps, bg_row, patch_to_cls, sizes,
            pcfg.fg_cos_threshold, pcfg.bg_rollout_threshold)]
    return [compose_pseudo_seg(patch_to_cls[i], cos_maps[i], bg_row[i],
                               sizes[i], pcfg, allow_native=False)
            for i in range(len(sizes))]
