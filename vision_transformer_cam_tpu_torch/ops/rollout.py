"""Attention rollout (the port of vision_transformer_cam_tpu/ops/rollout.py).

Each head-mean attention row sums to 1, so every consumer of the
row-normalized (A + I) matrix that reads only the cls row needs nothing but
the per-layer head-mean cls row [B, N].  Only the full joint chain needs the
head-mean matrices, and its final cls row reduces to a reverse
vector-matrix chain.
"""

from __future__ import annotations

import torch


def aug_normalize(headmean):
    """(A + I) row-normalized.  headmean: [..., N, N]."""
    n = headmean.shape[-1]
    aug = headmean + torch.eye(n, dtype=headmean.dtype, device=headmean.device)
    return aug / aug.sum(dim=-1, keepdim=True)


def aug_cls_row(cls_row):
    """Row 0 of aug_normalize, computed from the cls row alone.  [..., N]."""
    aug0 = cls_row.clone()
    aug0[..., 0] += 1.0
    return aug0 / aug0.sum(dim=-1, keepdim=True)


def rollout_cls_row(headmean_stack):
    """Final joint-attention cls row without materializing the chain: a
    reverse chain of vector-matrix products, v <- (v / s_l) @ A_l + v / s_l,
    with s_l the row sums of (A_l + I).  [L, B, N, N] -> [B, N]."""
    _, b, n, _ = headmean_stack.shape
    v = torch.zeros((b, n), dtype=headmean_stack.dtype,
                    device=headmean_stack.device)
    v[:, 0] = 1.0
    for a in reversed(headmean_stack):
        u = v / (1.0 + a.sum(dim=-1))
        v = torch.einsum("bi,bij->bj", u, a) + u
    return v


def _prefix(row_len: int, grid_size: int, prefix_tokens) -> int:
    """Number of non-patch prefix tokens to drop before the grid reshape;
    None infers it from the row length (1 plain, 2 distilled)."""
    if prefix_tokens is None:
        prefix_tokens = row_len - grid_size * grid_size
    if prefix_tokens < 0 or prefix_tokens != row_len - grid_size * grid_size:
        raise ValueError(
            f"rollout row of length {row_len} does not hold a "
            f"{grid_size}x{grid_size} patch grid after {prefix_tokens} "
            "prefix tokens")
    return prefix_tokens


def cam_from_rollout_row(rollout_row, grid_size, prefix_tokens=None):
    """The model's rollout row to a max-normalized CAM grid.
    [B, N] -> [B, g, g]."""
    p = _prefix(rollout_row.shape[-1], grid_size, prefix_tokens)
    m = rollout_row[:, p:].reshape(rollout_row.shape[0], grid_size, grid_size)
    return m / m.amax(dim=(1, 2), keepdim=True)


def per_block_cams(cls_rows, grid_size, prefix_tokens=None):
    """Per-block aug cls rows, max-normalized per block.
    cls_rows: [L, B, N] -> [L, B, g, g]."""
    aug0 = aug_cls_row(cls_rows)
    p = _prefix(aug0.shape[-1], grid_size, prefix_tokens)
    m = aug0[..., p:]
    m = m.reshape(*m.shape[:-1], grid_size, grid_size)
    return m / m.amax(dim=(-1, -2), keepdim=True)
