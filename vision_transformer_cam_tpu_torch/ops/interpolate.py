"""Resize ops matching the JAX package's ops/interpolate.py, which matches
the reference's torch / torchvision semantics.

``jax.image.resize`` builds, per resized axis, a weight matrix from a kernel
sampled at half-pixel centres, renormalises each output sample's weights to
sum to 1 (so an edge sample uses only the taps that exist, where torch's
``F.interpolate`` repeats the border pixel) and contracts the axis with it.
``_weight_matrix`` is that construction, so the results agree with the JAX
package on every size, not only where the two libraries happen to meet:

* bilinear, antialias off: the triangle kernel; on upsampling this is
  ``F.interpolate(mode="bilinear", align_corners=False)``;
* bicubic: the Keys kernel with a = -0.5, antialiased when an axis shrinks
  (``jax.image.resize``'s default).  ``F.interpolate(mode="bicubic")`` uses
  a = -0.75 and repeats the border, so it is not used here.
"""

from __future__ import annotations

import torch


def _triangle(x):
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x):
    """Keys cubic kernel, a = -0.5, on x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_matrix(in_size: int, out_size: int, kernel, antialias: bool,
                   dtype, device):
    """[in_size, out_size] weights of one resized axis, computed in float64
    (sample positions of size ~in_size lose 1e-6 of a weight in float32) and
    cast to ``dtype``."""
    out_dtype, dtype = dtype, torch.float64
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=dtype,
                                   device=device)
    kernel_scale = torch.clamp_min(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=dtype,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(dtype).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(out_dtype)


def _resize_last2(x, size, kernel, antialias):
    h, w = x.shape[-2:]
    oh, ow = size
    if oh != h:
        wh = _weight_matrix(h, oh, kernel, antialias, x.dtype, x.device)
        x = torch.einsum("...hw,ho->...ow", x, wh)
    if ow != w:
        ww = _weight_matrix(w, ow, kernel, antialias, x.dtype, x.device)
        x = torch.einsum("...hw,wo->...ho", x, ww)
    return x


def bilinear_resize(x, size):
    """x: [..., H, W] -> [..., size[0], size[1]], align_corners=False."""
    return _resize_last2(x, size, _triangle, antialias=False)


def nearest_resize(x, size):
    """Nearest-neighbor resize (torchvision InterpolationMode.NEAREST):
    src = floor(dst * in / out), asymmetric, not half-pixel."""
    h, w = x.shape[-2:]
    oh, ow = size
    ri = torch.floor(torch.arange(oh, device=x.device) * (h / oh)).long()
    ci = torch.floor(torch.arange(ow, device=x.device) * (w / ow)).long()
    return x[..., ri[:, None], ci[None, :]]


def interpolate_pos_embed(pos_embed, old_grid, new_grid, num_tokens=1):
    """Bicubic pos-embed interpolation so 224-trained checkpoints load at
    other resolutions.  pos_embed: [1, num_tokens + old_grid^2, D]."""
    tok = pos_embed[:, :num_tokens]
    grid = pos_embed[:, num_tokens:]
    d = grid.shape[-1]
    grid = grid.reshape(old_grid, old_grid, d).permute(2, 0, 1)
    grid = _resize_last2(grid, (new_grid, new_grid), _keys_cubic,
                         antialias=True)
    grid = grid.permute(1, 2, 0).reshape(1, new_grid * new_grid, d)
    return torch.cat([tok, grid], dim=1)
