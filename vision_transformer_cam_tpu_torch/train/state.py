"""Train state and optimizer: AdamW with optax's semantics, the reference's
timm ``create_optimizer`` weight-decay filter and its freeze logic (the port
of vision_transformer_cam_tpu/train/state.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from vision_transformer_cam_tpu_torch.configs import OptimConfig
from vision_transformer_cam_tpu_torch.train.schedule import (
    scaled_base_lr, timm_cosine_schedule)

_TRAINABLE_WHEN_FROZEN = ("head", "pre_logits")


def trainable_mask(model: torch.nn.Module,
                   freeze_backbone: bool) -> Dict[str, bool]:
    """{parameter name: trains}.  The reference freeze: every parameter whose
    name lacks 'head' / 'pre_logits' stops training.  The test is a substring
    match, so 'head1' (the top-16 patch head) and 'head_dist' (the distilled
    head) both stay trainable."""
    return {name: not freeze_backbone or any(
        t in part for part in name.split(".") for t in _TRAINABLE_WHEN_FROZEN)
        for name, _ in model.named_parameters()}


def weight_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: decays}.  timm ``create_optimizer`` with
    ``filter_bias_and_bn=True`` (the default) exempts every parameter with
    ndim <= 1, all biases and LayerNorm weights, from weight decay.  The
    reference model defines no ``no_weight_decay()``, so pos_embed and
    cls_token do decay."""
    return {name: p.dim() > 1 for name, p in model.named_parameters()}


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        clip: Optional[float]) -> List[torch.Tensor]:
    """optax's clip: unchanged while the global norm is below ``clip``, else
    (g / norm) * clip (``torch.nn.utils.clip_grad_norm_`` divides by
    norm + 1e-6 instead).  No host sync."""
    grads = list(grads)
    if clip is None:
        return grads
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    norm = torch.linalg.vector_norm(torch.stack(
        [n.to(acc) for n in torch._foreach_norm(grads)]))
    below = norm < clip
    div = torch.where(below, torch.ones_like(norm), norm)
    mul = torch.where(below, torch.ones_like(norm),
                      torch.full_like(norm, clip))
    return [(g / div.to(g.dtype)) * mul.to(g.dtype) for g in grads]


class Optimizer:
    """Gradient clipping, AdamW and the freeze mask with the semantics of the
    JAX package's optax chain:

      1. clip by global norm (``cfg.clip_grad``), the norm taken over every
         gradient, frozen parameters included;
      2. ``torch.optim.AdamW`` over the trainable parameters, which is
         optax's adamw (decoupled decay, eps outside the square root): the
         decay on the masked parameters only, lr = schedule(count) read
         before the count is raised;
      3. frozen parameters are not in the optimizer at all, so neither the
         update nor the decay moves them (optax also advances their moments,
         which no update reads).

    The moments (``mu``, ``nu``: one per trainable parameter) have the
    parameters' dtype (float32 masters keep float32 state) and live on their
    device.  ``update`` makes no host sync.
    """

    def __init__(self, model: torch.nn.Module, cfg: OptimConfig,
                 schedule: Callable[[int], float],
                 freeze_mask: Optional[Dict[str, bool]] = None):
        if cfg.opt != "adamw":
            raise NotImplementedError(f"opt={cfg.opt!r}: only adamw is "
                                      "implemented, as in the JAX package")
        self.cfg, self.schedule = cfg, schedule
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        decays = weight_decay_mask(model)
        self.trains = [True if freeze_mask is None else freeze_mask[n]
                       for n in self.names]
        trained = [(n, p) for (n, p), t in zip(named, self.trains) if t]
        groups = [{"params": [p for n, p in trained if decays[n] == d],
                   "weight_decay": cfg.weight_decay if d else 0.0}
                  for d in (True, False)]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0),
            betas=cfg.betas, eps=cfg.opt_eps, foreach=True)
        # the state AdamW would make at its first step, made now so that it
        # can be saved and loaded before one
        for _, p in trained:
            self.adamw.state[p] = {"step": torch.tensor(0.0),
                                   "exp_avg": torch.zeros_like(p),
                                   "exp_avg_sq": torch.zeros_like(p)}
        self.mu = [self.adamw.state[p]["exp_avg"] for _, p in trained]
        self.nu = [self.adamw.state[p]["exp_avg_sq"] for _, p in trained]
        self._trained_names = [n for n, _ in trained]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer step from ``grads`` (one per parameter, in
        ``named_parameters`` order)."""
        grads = clip_by_global_norm(grads, self.cfg.clip_grad)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        for p, g, t in zip(self.params, grads, self.trains):
            p.grad = g if t else None
        self.adamw.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self._trained_names, self.mu)),
                "nu": dict(zip(self._trained_names, self.nu))}

    def load_state_dict(self, sd: dict) -> None:
        """Load moments (tensors or numpy arrays by parameter name; those of
        frozen parameters are not needed) and the count, cast to each
        moment's dtype and device."""
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            missing = set(self._trained_names) - set(sd[key])
            if missing:
                raise KeyError(f"optimizer state lacks {key} of "
                               f"{sorted(missing)}")
            for name, t in zip(self._trained_names, own):
                v = torch.as_tensor(sd[key][name])
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"{key}[{name}] has shape "
                                     f"{tuple(v.shape)}, expected "
                                     f"{tuple(t.shape)}")
                t.copy_(v)
        self.count = int(sd["count"])
        for state in self.adamw.state.values():
            state["step"].fill_(self.count)


class TrainState(NamedTuple):
    """step: optimizer steps taken (a host integer); the model and the
    optimizer are updated in place by the train steps."""
    step: int
    model: torch.nn.Module
    optimizer: Optimizer


def make_optimizer(model: torch.nn.Module, cfg: OptimConfig,
                   global_batch_size: int, steps_per_epoch: int, *,
                   freeze_mask: Optional[Dict[str, bool]] = None):
    """AdamW + the timm-parity cosine schedule for ``model``'s parameters.
    Returns (optimizer, schedule)."""
    base_lr = scaled_base_lr(cfg, global_batch_size)
    schedule = timm_cosine_schedule(cfg, base_lr, steps_per_epoch)
    return Optimizer(model, cfg, schedule, freeze_mask), schedule


def create_train_state(model: torch.nn.Module,
                       optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
