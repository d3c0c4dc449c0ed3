"""DenseNet (161-style) for the classic CNN-CAM demo, for PyTorch (the port
of vision_transformer_cam_tpu/models/densenet.py).

The reference's standalone t.py offers torchvision's densenet161 as
model_id 3 (t.py:31-33), with the CAM hook on its ``features`` module (the
post-final-norm, pre-ReLU tensor) and the CAM weight from the classifier
Linear (t.py:52, params[-2]).  As the JAX module: BN -> ReLU -> conv
bottleneck dense layers (1x1 to 4k, then 3x3 to k channels, concatenated),
half-width 1x1 conv plus 2x2 average pool transitions, and a forward that
returns (logits, features), ``features`` post-``norm5`` and pre-ReLU as
``[B, h, w, C]``.  The constructor keeps the JAX ``init``'s parameters
(growth, blocks, init_features), so that tests run a tiny instance; the
default is the 161 plan (growth 48, blocks 6/12/36/24).  The batch norms are
ResNet's inference-style folded statistics.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformer_cam_tpu_torch.models.resnet import (
    FoldedBatchNorm, bn_state, conv, conv_weight, hwio, seeded, tensor)
from vision_transformer_cam_tpu_torch.utils import resolve_device

BLOCKS_161 = (6, 12, 36, 24)


class DenseNet(nn.Module):
    """``forward(x [B, H, W, 3])`` -> (logits [B, num_classes], features
    [B, h, w, C]).  Built on ``device``: the card by default
    (``utils.resolve_device``), the CPU only when asked."""

    def __init__(self, num_classes: int = 1000, growth: int = 48,
                 blocks: Sequence[int] = BLOCKS_161, init_features: int = 96,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        g = seeded(generator)
        self.stem = nn.Module()
        self.stem.conv = conv_weight(3, init_features, 7, g, **fk)
        self.stem.bn = FoldedBatchNorm(init_features, **fk)
        self.blocks = nn.ModuleList()
        self.transitions = nn.ModuleList()
        cin = init_features
        for bi, n_layers in enumerate(blocks):
            block = nn.ModuleList()
            for _ in range(n_layers):
                layer = nn.Module()
                layer.bn1 = FoldedBatchNorm(cin, **fk)
                layer.conv1 = conv_weight(cin, 4 * growth, 1, g, **fk)
                layer.bn2 = FoldedBatchNorm(4 * growth, **fk)
                layer.conv2 = conv_weight(4 * growth, growth, 3, g, **fk)
                block.append(layer)
                cin += growth
            self.blocks.append(block)
            if bi != len(blocks) - 1:
                t = nn.Module()
                t.bn = FoldedBatchNorm(cin, **fk)
                t.conv = conv_weight(cin, cin // 2, 1, g, **fk)
                self.transitions.append(t)
                cin //= 2
        self.norm5 = FoldedBatchNorm(cin, **fk)
        self.classifier = nn.Linear(cin, num_classes, **fk)
        with torch.no_grad():
            self.classifier.weight.copy_(torch.randn(
                (num_classes, cin), generator=g, dtype=torch.float64) * 0.01)
            self.classifier.bias.zero_()

    def forward(self, x):
        y = x.to(self.stem.conv.dtype).permute(0, 3, 1, 2)
        y = F.relu(self.stem.bn(conv(y, self.stem.conv, 2)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        for bi, block in enumerate(self.blocks):
            for layer in block:
                h = conv(F.relu(layer.bn1(y)), layer.conv1)
                h = conv(F.relu(layer.bn2(h)), layer.conv2)
                y = torch.cat([y, h], dim=1)
            if bi < len(self.transitions):
                t = self.transitions[bi]
                y = F.avg_pool2d(conv(F.relu(t.bn(y)), t.conv), 2, 2)
        feats = self.norm5(y)                             # hooked tensor
        logits = self.classifier(F.relu(feats).mean(dim=(2, 3)))
        return logits, feats.permute(0, 2, 3, 1)


def cam_weight(model: DenseNet) -> np.ndarray:
    """[C, num_classes] CAM weight: the classifier Linear kernel (t.py:52's
    params[-2]), in the JAX layout."""
    return model.classifier.weight.detach().t().cpu().numpy()


def state_dict_from_jax(params: Mapping) -> dict:
    """The JAX DenseNet pytree (HWIO kernels, lists of blocks of layer dicts
    and of transitions) as this module's state dict."""
    sd = {"stem.conv": hwio(params["stem"]["conv"]),
          **bn_state("stem.bn", params["stem"]["bn"]),
          **bn_state("norm5", params["norm5"]),
          "classifier.weight": tensor(
              params["classifier"]["kernel"]).t(),
          "classifier.bias": tensor(
              params["classifier"]["bias"])}
    for bi, block in enumerate(params["blocks"]):
        for li, layer in enumerate(block):
            pre = f"blocks.{bi}.{li}"
            for i in (1, 2):
                sd[f"{pre}.conv{i}"] = hwio(layer[f"conv{i}"])
                sd.update(bn_state(f"{pre}.bn{i}", layer[f"bn{i}"]))
    for ti, t in enumerate(params["transitions"]):
        sd[f"transitions.{ti}.conv"] = hwio(t["conv"])
        sd.update(bn_state(f"transitions.{ti}.bn", t["bn"]))
    return sd


def from_jax(params: Mapping, *, device=None, dtype=None) -> DenseNet:
    """A DenseNet holding the JAX pytree's weights; its classes, growth,
    blocks and initial features read from the pytree; ``dtype`` defaults to
    the pytree's."""
    kernel = np.asarray(params["classifier"]["kernel"])
    stem = np.asarray(params["stem"]["conv"])                 # HWIO
    growth = np.asarray(params["blocks"][0][0]["conv2"]).shape[-1]
    model = DenseNet(kernel.shape[1], growth,
                     [len(b) for b in params["blocks"]], stem.shape[-1],
                     device=device,
                     dtype=dtype or getattr(torch, str(kernel.dtype)))
    model.load_state_dict(state_dict_from_jax(params))
    return model
