"""SqueezeNet 1.1 for the classic CNN-CAM demo, for PyTorch (the port of
vision_transformer_cam_tpu/models/squeezenet.py).

The reference's standalone t.py offers torchvision's squeezenet1_1 as
model_id 1 (t.py:26-28), with the CAM hook on its ``features`` module and the
CAM weight taken from the 1x1 classifier conv (t.py:52, params[-2]).  The
forward returns (logits, features), ``features`` the post-fire9 tensor the
reference hooks, before the classifier conv, as ``[B, h, w, 512]``.

As the JAX module: the stem is a VALID 3x3 convolution at stride 2, each
fire concatenates [expand1x1, expand3x3], the 3x3 / stride-2 max pools run
in ceil mode (a last window that starts inside the input and hangs off its
bottom or right edge is kept: ``F.max_pool2d(..., ceil_mode=True)``, which
the JAX module builds from a -inf pad), and the classifier is a 1x1 conv,
ReLU, then the global mean.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformer_cam_tpu_torch.models.resnet import (
    conv, conv_weight, hwio, seeded, tensor)
from vision_transformer_cam_tpu_torch.utils import resolve_device

# (squeeze, expand) channel plan of v1.1 and the maxpool positions: fires
# 2-3 after the first pool, 4-5 after the second, 6-9 after the third.
FIRES = ((16, 64), (16, 64), (32, 128), (32, 128),
         (48, 192), (48, 192), (64, 256), (64, 256))
POOL_BEFORE = (0, 2, 4)  # fire indices preceded by a 3x3/s2 maxpool


def conv_bias(cin: int, cout: int, k: int, generator, **fk) -> nn.Module:
    """A convolution's kernel (OIHW, drawn as the JAX package draws its
    HWIO one) and its zero bias."""
    m = nn.Module()
    m.kernel = conv_weight(cin, cout, k, generator, **fk)
    m.bias = nn.Parameter(torch.zeros(cout, **fk))
    return m


def conv_b(x, p, stride=1):
    """NCHW ``x`` convolved by ``p.kernel`` ((k - 1) // 2 padding, which is
    "SAME" at stride 1 for these odd kernels) plus ``p.bias``."""
    return conv(x, p.kernel, stride) + p.bias[:, None, None]


class SqueezeNet(nn.Module):
    """``forward(x [B, H, W, 3])`` -> (logits [B, num_classes], features
    [B, h, w, 512]).  Built on ``device``: the card by default
    (``utils.resolve_device``), the CPU only when asked."""

    def __init__(self, num_classes: int = 1000, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        g = seeded(generator)
        self.stem = conv_bias(3, 64, 3, g, **fk)
        self.fires = nn.ModuleList()
        cin = 64
        for sq, ex in FIRES:
            fire = nn.Module()
            fire.squeeze = conv_bias(cin, sq, 1, g, **fk)
            fire.expand1 = conv_bias(sq, ex, 1, g, **fk)
            fire.expand3 = conv_bias(sq, ex, 3, g, **fk)
            self.fires.append(fire)
            cin = 2 * ex
        # the classifier is a 1x1 conv (t.py's params[-2] CAM weight source)
        self.classifier = conv_bias(cin, num_classes, 1, g, **fk)

    def forward(self, x):
        y = x.to(self.stem.kernel.dtype).permute(0, 3, 1, 2)
        y = F.relu(F.conv2d(y, self.stem.kernel, stride=2)
                   + self.stem.bias[:, None, None])         # VALID
        for i, fire in enumerate(self.fires):
            if i in POOL_BEFORE:
                y = F.max_pool2d(y, 3, 2, ceil_mode=True)
            s = F.relu(conv_b(y, fire.squeeze))
            y = torch.cat([F.relu(conv_b(s, fire.expand1)),
                           F.relu(conv_b(s, fire.expand3))], dim=1)
        # classifier: (eval-mode dropout) -> 1x1 conv -> relu -> global mean
        logits = F.relu(conv_b(y, self.classifier)).mean(dim=(2, 3))
        return logits, y.permute(0, 2, 3, 1)


def cam_weight(model: SqueezeNet) -> np.ndarray:
    """[C, num_classes] CAM weight: the squeezed 1x1 classifier conv kernel
    (t.py:52's np.squeeze(params[-2]))."""
    return model.classifier.kernel.detach()[:, :, 0, 0].t().cpu().numpy()


def conv_state(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.kernel": hwio(p["kernel"]),
            f"{prefix}.bias": tensor(p["bias"])}


def state_dict_from_jax(params: Mapping) -> dict:
    """The JAX SqueezeNet pytree (HWIO kernels, a list of fire dicts) as
    this module's state dict."""
    sd = {**conv_state("stem", params["stem"]),
          **conv_state("classifier", params["classifier"])}
    for i, fire in enumerate(params["fires"]):
        for name in ("squeeze", "expand1", "expand3"):
            sd.update(conv_state(f"fires.{i}.{name}", fire[name]))
    return sd


def from_jax(params: Mapping, *, device=None, dtype=None) -> SqueezeNet:
    """A SqueezeNet holding the JAX pytree's weights, its classes read from
    the pytree; ``dtype`` defaults to the pytree's."""
    kernel = np.asarray(params["classifier"]["kernel"])
    model = SqueezeNet(kernel.shape[-1], device=device,
                       dtype=dtype or getattr(torch, str(kernel.dtype)))
    model.load_state_dict(state_dict_from_jax(params))
    return model
