"""Checkpoint / resume.

The reference saves bare weights only, so its "resume" means fine-tuning
again.  Here a checkpoint is the full train state (parameters, optimizer
moments, step) in one ``torch.save`` file ``<ckpt_dir>/<tag>.pt``, so training
resumes exactly.

Under data parallelism every rank calls ``save`` (a ZeRO-1 optimizer
gathers its moments, a collective) and the main process writes; every rank
calls ``restore``, which waits at a barrier until the file is there.  A
model sharded over 'model' or 'stage' is saved in the one-rank layout (its
parameters and moments gathered over the inner group, as JAX's global arrays
are) and restored into whatever layout the template has, so a run saved on a
(2, 2) mesh resumes on one rank and back.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vision_transformer_cam_tpu_torch.parallel import mesh as meshlib
from vision_transformer_cam_tpu_torch.train.state import TrainState

_EXT = ".pt"


def save(ckpt_dir: str, tag: str, state: TrainState) -> str:
    """Save the full train state as <ckpt_dir>/<tag>.pt; returns the path."""
    path = os.path.abspath(os.path.join(ckpt_dir, tag + _EXT))
    optimizer = state.optimizer.state_dict()    # every rank: may gather
    model = meshlib.full_state_dict(state.model)
    if meshlib.is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"step": state.step, "model": model, "optimizer":
                    optimizer}, tmp)
        os.replace(tmp, path)   # a reader never sees a half-written file
    meshlib.barrier()
    return path


def restore(ckpt_dir: str, tag: str, template: TrainState) -> TrainState:
    """Load <ckpt_dir>/<tag>.pt into the template's model and optimizer (in
    place, on their devices) and return the state at the saved step."""
    meshlib.barrier()
    path = os.path.join(ckpt_dir, tag + _EXT)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    meshlib.load_full_state_dict(template.model, sd["model"])
    template.optimizer.load_state_dict(sd["optimizer"])
    return template._replace(step=int(sd["step"]))


def latest_tag(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint's tag, by mtime and not by name: within one run
    '...-cur_ep9-...' sorts after '...-cur_ep15-...' as a string."""
    if not os.path.isdir(ckpt_dir):
        return None
    files = [f for f in os.listdir(ckpt_dir) if f.endswith(_EXT)]
    if not files:
        return None
    newest = max(files,
                 key=lambda f: os.path.getmtime(os.path.join(ckpt_dir, f)))
    return newest.removesuffix(_EXT)
