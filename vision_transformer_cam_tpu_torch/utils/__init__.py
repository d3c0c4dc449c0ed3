"""Small shared helpers of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means ``"cuda"``: the
    port runs on the card unless the caller asks for the CPU.  A CUDA device
    on a machine where ``torch.cuda.is_available()`` is false raises; nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the default) but "
            "torch.cuda.is_available() is false; pass device='cpu' to run on "
            "the CPU")
    return dev
