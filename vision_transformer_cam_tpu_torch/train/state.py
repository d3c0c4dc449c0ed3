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

    ZeRO-1 (``zero1_mesh``: a mesh whose data axis spans several ranks; the
    port of JAX ``zero1_opt_pspecs`` / ``shard_opt_state``).  Layout: the
    trainable parameters, in ``named_parameters`` order, are laid end to end
    as one flat vector of E elements; data rank r owns elements [r c, (r+1)
    c) with c = ceil(E / dp), which is a contiguous slice (maybe empty) of
    the flattened view of each parameter it touches.  The rank keeps ``mu``
    and ``nu`` of its slices only (``self.mu`` / ``self.nu`` are the slices,
    1-D), and AdamW runs on standalone copies of those slices, refreshed
    from the parameters before every step (so that a restore or any other
    write into the model is what the step starts from), so each
    element sees the same arithmetic as in the unsharded optimizer (AdamW is
    elementwise); the clip runs before, on the full gradients every rank
    holds.  The fresh slices are then all-gathered over the data group and
    written into every rank's parameters, bit for bit.  ``state_dict``
    gathers the full moments (a collective: every rank calls it), so a
    checkpoint is the same file as one saved without ZeRO-1;
    ``load_state_dict`` takes such a file on any layout.  (JAX shards each
    moment along its first axis that divides by dp and replicates the rest;
    the flat ranges divide every parameter's elements evenly instead.)
    """

    def __init__(self, model: torch.nn.Module, cfg: OptimConfig,
                 schedule: Callable[[int], float],
                 freeze_mask: Optional[Dict[str, bool]] = None,
                 zero1_mesh=None):
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
        self._trained_names = [n for n, _ in trained]
        self._trained = [p for _, p in trained]
        self.zero1 = zero1_mesh if zero1_mesh is not None \
            and zero1_mesh.data_size > 1 else None
        if self.zero1 is not None:
            # [(index in trained, lo, hi)] of the owned flat slices, and the
            # standalone slices AdamW updates
            self._slices = self._own_slices()
            opt_params = [trained[i][1].detach().reshape(-1)[lo:hi].clone()
                          for i, lo, hi in self._slices]
            opt_decays = [decays[trained[i][0]] for i, _, _ in self._slices]
        else:
            opt_params = [p for _, p in trained]
            opt_decays = [decays[n] for n, _ in trained]
        groups = [{"params": [p for p, dec in zip(opt_params, opt_decays)
                              if dec == d],
                   "weight_decay": cfg.weight_decay if d else 0.0}
                  for d in (True, False)]
        self._opt_params = opt_params
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]] or [{"params": []}],
            lr=schedule(0), betas=cfg.betas, eps=cfg.opt_eps, foreach=True)
        # the state AdamW would make at its first step, made now so that it
        # can be saved and loaded before one
        for p in opt_params:
            self.adamw.state[p] = {"step": torch.tensor(0.0),
                                   "exp_avg": torch.zeros_like(p),
                                   "exp_avg_sq": torch.zeros_like(p)}
        self.mu = [self.adamw.state[p]["exp_avg"] for p in opt_params]
        self.nu = [self.adamw.state[p]["exp_avg_sq"] for p in opt_params]
        self.count = 0

    def _own_slices(self):
        mesh, sizes = self.zero1, [p.numel() for p in self._trained]
        if len({p.dtype for p in self._trained}) > 1:
            raise ValueError("ZeRO-1 lays the trainable parameters end to "
                             "end: they must share one dtype")
        total = sum(sizes)
        self._chunk = -(-total // mesh.data_size)
        lo_r = mesh.data_rank * self._chunk
        hi_r = min(lo_r + self._chunk, total)
        out, off = [], 0
        for i, n in enumerate(sizes):
            lo, hi = max(lo_r, off), min(hi_r, off + n)
            if lo < hi:
                out.append((i, lo - off, hi - off))
            off += n
        self._total = total
        return out

    def moment_elements(self) -> int:
        """Elements of ``mu`` this rank holds (``nu`` holds as many)."""
        return sum(t.numel() for t in self.mu)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer step from ``grads`` (one per parameter, in
        ``named_parameters`` order)."""
        grads = clip_by_global_norm(grads, self.cfg.clip_grad)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        if self.zero1 is not None:
            self._update_slices(
                [g for g, t in zip(grads, self.trains) if t])
            return
        for p, g, t in zip(self.params, grads, self.trains):
            p.grad = g if t else None
        self.adamw.step()
        for p in self.params:
            p.grad = None

    def _update_slices(self, grads):
        # the slices are read from the live parameters first: whatever wrote
        # them since the last step (a checkpoint restore, a broadcast) counts
        for (i, lo, hi), sp in zip(self._slices, self._opt_params):
            sp.copy_(self._trained[i].detach().reshape(-1)[lo:hi])
            sp.grad = grads[i].reshape(-1)[lo:hi]
        self.adamw.step()
        for sp in self._opt_params:
            sp.grad = None
        flat = self._gather([sp for sp in self._opt_params],
                            self._trained[0].dtype)
        off = 0
        for p in self._trained:
            p.copy_(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()

    def _gather(self, pieces, dtype):
        """The full flat vector from every rank's owned slices (``pieces``,
        in layout order): one all-gather of equal chunks, exact bits."""
        mesh = self.zero1
        dev = self._trained[0].device
        mine = torch.zeros(self._chunk, dtype=dtype, device=dev)
        if pieces:
            own = torch.cat([t.reshape(-1) for t in pieces])
            mine[:own.numel()] = own
        return mesh.data_all_gather(mine)[:self._total]

    def _full_moments(self):
        """{"mu": [...], "nu": [...]} full moment tensors, one per trained
        parameter (a collective under ZeRO-1)."""
        if self.zero1 is None:
            return {"mu": self.mu, "nu": self.nu}
        out = {}
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            flat = self._gather(own, self._trained[0].dtype)
            parts, off = [], 0
            for p in self._trained:
                parts.append(flat[off:off + p.numel()].view(p.shape))
                off += p.numel()
            out[key] = parts
        return out

    def state_dict(self) -> dict:
        full = self._full_moments()
        return {"count": self.count,
                "mu": dict(zip(self._trained_names, full["mu"])),
                "nu": dict(zip(self._trained_names, full["nu"]))}

    def load_state_dict(self, sd: dict) -> None:
        """Load moments (tensors or numpy arrays by parameter name; those of
        frozen parameters are not needed) and the count, cast to each
        moment's dtype and device.  Under ZeRO-1 each rank keeps its slices
        of the full moments."""
        for key, own in (("mu", self.mu), ("nu", self.nu)):
            missing = set(self._trained_names) - set(sd[key])
            if missing:
                raise KeyError(f"optimizer state lacks {key} of "
                               f"{sorted(missing)}")
            full = []
            for name, p in zip(self._trained_names, self._trained):
                v = torch.as_tensor(sd[key][name])
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{key}[{name}] has shape "
                                     f"{tuple(v.shape)}, expected "
                                     f"{tuple(p.shape)}")
                full.append(v)
            if self.zero1 is None:
                for t, v in zip(own, full):
                    t.copy_(v)
            else:
                for t, (i, lo, hi) in zip(own, self._slices):
                    t.copy_(full[i].reshape(-1)[lo:hi])
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
                   freeze_mask: Optional[Dict[str, bool]] = None,
                   zero1_mesh=None):
    """AdamW + the timm-parity cosine schedule for ``model``'s parameters
    (the moments sharded over the data group of ``zero1_mesh``: ZeRO-1).
    Returns (optimizer, schedule)."""
    base_lr = scaled_base_lr(cfg, global_batch_size)
    schedule = timm_cosine_schedule(cfg, base_lr, steps_per_epoch)
    return Optimizer(model, cfg, schedule, freeze_mask,
                     zero1_mesh=zero1_mesh), schedule


def create_train_state(model: torch.nn.Module,
                       optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
