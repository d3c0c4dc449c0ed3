"""ResNet (18/34-style basic blocks) for the classic CNN-CAM demo, for
PyTorch (the port of vision_transformer_cam_tpu/models/resnet.py).

The reference's standalone t.py hooks the last conv block of torchvision's
ResNet18 and dots it with the fc weight matrix (t.py:55-75).  Here the
forward returns the last conv features beside the logits, in the JAX
package's layout ``[B, h, w, C]``, so that the CAM code is the same.  Images
are NHWC, as there.

The layers follow the JAX module exactly: convolutions padded symmetrically
by (k - 1) // 2 (torch's own padding, not XLA's "SAME", which pads
asymmetrically at stride 2), a 3x3 / stride-2 max pool padded by 1, and
inference-style batch norms over folded running statistics (eps 1e-5) that
never run in train mode.  Weights carry across from a JAX parameter pytree
(``state_dict_from_jax``, ``from_jax``); the port's own init draws from an
explicit ``torch.Generator`` with the JAX package's scales.

The convolutions are plain ``F.conv2d`` (cuDNN on the card): the JAX module
runs them as XLA convolutions, not as a TPU kernel.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformer_cam_tpu_torch.cam.render import cam_norm
from vision_transformer_cam_tpu_torch.utils import resolve_device

STAGES_18 = (2, 2, 2, 2)
WIDTHS = (64, 128, 256, 512)


def conv(x, w, stride=1):
    """Convolution of NCHW ``x`` by OIHW ``w`` with torch's symmetric
    (k - 1) // 2 padding."""
    return F.conv2d(x, w, stride=stride,
                    padding=((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2))


class FoldedBatchNorm(nn.Module):
    """Inference-style batch norm over folded running statistics:
    (x - mean) * rsqrt(var + 1e-5) * scale + bias on the channels of NCHW x,
    in the JAX package's order of operations."""

    def __init__(self, c: int, **fk):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, **fk))
        self.bias = nn.Parameter(torch.zeros(c, **fk))
        self.register_buffer("mean", torch.zeros(c, **fk))
        self.register_buffer("var", torch.ones(c, **fk))

    def forward(self, x):
        inv = torch.rsqrt(self.var + 1e-5)[:, None, None]
        return (x - self.mean[:, None, None]) * inv * \
            self.scale[:, None, None] + self.bias[:, None, None]


def conv_weight(cin: int, cout: int, k: int, generator, **fk):
    """An OIHW kernel drawn as the JAX package draws its HWIO one:
    normal * sqrt(2 / fan_in)."""
    w = torch.randn((cout, cin, k, k), generator=generator,
                    dtype=torch.float64) * math.sqrt(2.0 / (k * k * cin))
    return nn.Parameter(w.to(**fk))


def seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, generator, **fk):
        super().__init__()
        self.stride = stride
        self.conv1 = conv_weight(cin, cout, 3, generator, **fk)
        self.bn1 = FoldedBatchNorm(cout, **fk)
        self.conv2 = conv_weight(cout, cout, 3, generator, **fk)
        self.bn2 = FoldedBatchNorm(cout, **fk)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Module()
            self.down.conv = conv_weight(cin, cout, 1, generator, **fk)
            self.down.bn = FoldedBatchNorm(cout, **fk)

    def forward(self, y):
        sc = y if self.down is None else \
            self.down.bn(conv(y, self.down.conv, self.stride))
        y2 = F.relu(self.bn1(conv(y, self.conv1, self.stride)))
        y2 = self.bn2(conv(y2, self.conv2))
        return F.relu(y2 + sc)


class ResNet(nn.Module):
    """``forward(x [B, H, W, 3])`` -> (logits [B, num_classes], features
    [B, h, w, 512]): the last conv activations the reference hooks
    (t.py:78-86).  Built on ``device``: the card by default
    (``utils.resolve_device``), the CPU only when asked."""

    def __init__(self, num_classes: int = 1000,
                 stages: Sequence[int] = STAGES_18, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        g = seeded(generator)
        self.stem = nn.Module()
        self.stem.conv = conv_weight(3, 64, 7, g, **fk)
        self.stem.bn = FoldedBatchNorm(64, **fk)
        self.stages = nn.ModuleList()
        cin = 64
        for si, (blocks, cout) in enumerate(zip(stages, WIDTHS)):
            stage = nn.ModuleList()
            for bi in range(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                stage.append(BasicBlock(cin, cout, stride, g, **fk))
                cin = cout
            self.stages.append(stage)
        self.fc = nn.Linear(cin, num_classes, **fk)
        with torch.no_grad():
            self.fc.weight.copy_(torch.randn(
                (num_classes, cin), generator=g, dtype=torch.float64) * 0.01)
            self.fc.bias.zero_()

    def forward(self, x):
        y = x.to(self.stem.conv.dtype).permute(0, 3, 1, 2)
        y = F.relu(self.stem.bn(conv(y, self.stem.conv, 2)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        for stage in self.stages:
            for blk in stage:
                y = blk(y)
        feats = y.permute(0, 2, 3, 1)                    # [B, h, w, 512]
        logits = self.fc(feats.mean(dim=(1, 2)))
        return logits, feats


def cam_weight(model: ResNet) -> np.ndarray:
    """[C, num_classes] CAM weight: the fc kernel (t.py:52's params[-2]), in
    the JAX layout; the same accessor as squeezenet's and densenet's, so that
    the demo CLI dispatches over architectures generically."""
    return model.fc.weight.detach().t().cpu().numpy()


def return_cam(features, fc_kernel, class_ids) -> np.ndarray:
    """t.py:55-75: CAM_c = normalize(sum_k w[k, c] * feature_k) -> uint8.

    features: [h, w, C]; fc_kernel: [C, num_classes]; class_ids: ints.
    Returns [len(ids), h, w] uint8, the JAX package's arithmetic in numpy."""
    feats = np.asarray(features).reshape(-1, features.shape[-1])  # [hw, C]
    cams = [cam_norm(
        (feats @ np.asarray(fc_kernel[:, c])).reshape(features.shape[:2]))
        for c in class_ids]
    return np.stack(cams)


def tensor(a) -> torch.Tensor:
    """A numpy or JAX array as a torch tensor of its own (a copy)."""
    return torch.from_numpy(np.array(a))


def hwio(w) -> torch.Tensor:
    """A JAX HWIO kernel as a torch OIHW tensor."""
    return tensor(w).permute(3, 2, 0, 1).contiguous()


def bn_state(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.{k}": tensor(p[k])
            for k in ("scale", "bias", "mean", "var")}


def state_dict_from_jax(params: Mapping) -> dict:
    """The JAX ResNet pytree (numpy or JAX arrays; HWIO kernels, a list of
    stages of block dicts) as this module's state dict."""
    sd = {"stem.conv": hwio(params["stem"]["conv"]),
          **bn_state("stem.bn", params["stem"]["bn"])}
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            pre = f"stages.{si}.{bi}"
            for i in (1, 2):
                sd[f"{pre}.conv{i}"] = hwio(blk[f"conv{i}"])
                sd.update(bn_state(f"{pre}.bn{i}", blk[f"bn{i}"]))
            if "down" in blk:
                sd[f"{pre}.down.conv"] = hwio(blk["down"]["conv"])
                sd.update(bn_state(f"{pre}.down.bn", blk["down"]["bn"]))
    sd["fc.weight"] = tensor(params["fc"]["kernel"]).t()
    sd["fc.bias"] = tensor(params["fc"]["bias"])
    return sd


def from_jax(params: Mapping, *, device=None, dtype=None) -> ResNet:
    """A ResNet holding the JAX pytree's weights, its depth and classes read
    from the pytree; ``dtype`` defaults to the pytree's."""
    kernel = np.asarray(params["fc"]["kernel"])
    model = ResNet(kernel.shape[1], [len(s) for s in params["stages"]],
                   device=device,
                   dtype=dtype or getattr(torch, str(kernel.dtype)))
    model.load_state_dict(state_dict_from_jax(params))
    return model
