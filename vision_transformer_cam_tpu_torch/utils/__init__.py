"""Small shared helpers of the port."""

from __future__ import annotations

import random

import numpy as np
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


def check_cli_flags(argv, bool_flags, value_flags, prog="script"):
    """Strict argv validation for the hand-rolled script parsers (the
    measurement scripts and ``bench``): reject unknown or misspelled flags
    and value flags missing their value.  A typo'd flag that is silently
    ignored measures the wrong configuration and prints a line that looks
    legitimate.  ``argv[0]`` is the program name, as in ``sys.argv``."""
    bool_flags, value_flags = set(bool_flags), set(value_flags)
    i = 1
    while i < len(argv):
        tok = argv[i]
        if tok in value_flags:
            if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                raise SystemExit(f"{prog}: {tok} needs a value")
            i += 2
            continue
        if tok.startswith("--") and tok not in bool_flags:
            raise SystemExit(
                f"{prog}: unknown flag {tok}; known: "
                f"{' '.join(sorted(bool_flags | value_flags))}")
        i += 1


def same_seeds(seed: int) -> torch.Generator:
    """Determinism entry: seeds ``random``, numpy and torch (every device)
    and returns a CPU ``torch.Generator`` seeded alike, for the draws a
    caller wants kept apart from the global stream."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
