"""Checkpoint interop.

The port's ``ViTCAM`` uses the reference's state-dict key names and layouts
(torch Linear [out, in], conv patch embed [D, C, p, p]), so a reference
``.pth`` state dict loads directly.  ``state_dict_from_jax_params`` maps the
JAX package's parameter pytree (as numpy arrays, blocks stacked on a leading
depth axis) onto those keys, with the same mapping as
vision_transformer_cam_tpu/io/weights.py: state_dict_from_pytree.

A tree quantized by the JAX ``ops.quant.quantize_params`` (nodes holding
``kernel_q``, ``scale``, optionally ``act_scale`` and ``out_scales``) maps
bit for bit onto the buffers of the port's ``QLinear`` (``weight_q`` [out,
in], ``weight_scale``, ``act_scale``, ``out_scales``, ``bias`` in float32),
and ``load_state_dict`` installs ``QLinear`` modules where a state dict
holds them, so both packages can serve the same int8 weights and scales.

``load_weights`` reads the containers the trainer meets: a reference ``.pth``
state dict (with the head-key surgery) or a checkpoint of the port's own
trainer.  ``optimizer_state_from_jax`` carries optax AdamW moments across, so
both packages can take the same step from the same state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

# Model-level keys the reference carries but never uses in the forward pass
# (its unused norm1 / norm2 modules); skipped on load.
_DEAD_PREFIXES = ("norm1.", "norm2.")

# the reference's head-key surgery when fine-tuning from a checkpoint, and
# from a pretrained one (whose pre_logits layer goes too)
DEFAULT_DEL_KEYS = ("head.weight", "head.bias")
PRETRAIN_DEL_KEYS = ("head.weight", "head.bias",
                     "pre_logits.fc.weight", "pre_logits.fc.bias")


def _t(w):  # JAX kernels are [in, out]; torch Linear stores [out, in]
    return np.ascontiguousarray(np.asarray(w).T)


def _quantized(pre, node, i=None):
    """The QLinear buffers of one quantized JAX node (layer ``i`` of a
    stacked block tree)."""
    def g(a):
        a = np.asarray(a)
        return a if i is None else a[i]

    sd = {pre + "weight_q": _t(g(node["kernel_q"])),
          pre + "weight_scale": g(node["scale"]).reshape(-1)}
    if node.get("bias") is not None:
        sd[pre + "bias"] = g(node["bias"]).astype(np.float32)
    for key in ("act_scale", "out_scales"):
        if key in node:
            sd[pre + key] = g(node[key]).astype(np.float32)
    return sd


def state_dict_from_jax_params(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts of numpy arrays) -> the port's
    state dict, values as CPU tensors of the arrays' dtype."""
    p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
    g = np.asarray
    pe = params["patch_embed"]
    if "kernel_q" in pe:
        sd = _quantized("patch_embed.proj.", pe)
    else:
        sd = {"patch_embed.proj.weight": g(pe["kernel"]).reshape(p, p, c, d)
              .transpose(3, 2, 0, 1),
              "patch_embed.proj.bias": g(pe["bias"])}
    sd.update({
        "cls_token": g(params["cls_token"]),
        "pos_embed": g(params["pos_embed"]),
        "norm.weight": g(params["norm"]["scale"]),
        "norm.bias": g(params["norm"]["bias"]),
        "head.weight": _t(params["head"]["kernel"]),
        "head.bias": g(params["head"]["bias"]),
        "head1.weight": _t(params["head1"]["kernel"]),
        "head1.bias": g(params["head1"]["bias"]),
    })
    if cfg.has_logits:
        sd["pre_logits.fc.weight"] = _t(params["pre_logits"]["kernel"])
        sd["pre_logits.fc.bias"] = g(params["pre_logits"]["bias"])
    if cfg.distilled:
        sd["dist_token"] = g(params["dist_token"])
        sd["head_dist.weight"] = _t(params["head_dist"]["kernel"])
        sd["head_dist.bias"] = g(params["head_dist"]["bias"])
    bp = params["blocks"]
    linears = (("attn.qkv", bp["attn"]["qkv"]), ("attn.proj", bp["attn"]["proj"]),
               ("mlp.fc1", bp["mlp"]["fc1"]), ("mlp.fc2", bp["mlp"]["fc2"]))
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        for name, ln in (("norm1", bp["ln1"]), ("norm2", bp["ln2"])):
            sd[pre + name + ".weight"] = g(ln["scale"])[i]
            sd[pre + name + ".bias"] = g(ln["bias"])[i]
        for name, lin in linears:
            if "kernel_q" in lin:
                sd.update(_quantized(pre + name + ".", lin, i))
                continue
            sd[pre + name + ".weight"] = _t(g(lin["kernel"])[i])
            if "bias" in lin:
                sd[pre + name + ".bias"] = g(lin["bias"])[i]
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def _install_quantized(model: torch.nn.Module, sd: Mapping) -> None:
    """Replace each module that ``sd`` holds as an int8 layer (a
    ``<name>.weight_q`` key) with a ``QLinear`` of the state dict's buffers
    (the values are loaded again, unchanged, by ``load_state_dict``)."""
    from vision_transformer_cam_tpu_torch.ops.quant import QLinear

    def tensor(k):
        v = sd.get(k)
        if v is None or isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.array(v, order="C"))

    dev = next(model.parameters()).device
    for key in [k for k in sd if k.endswith(".weight_q")]:
        name = key[:-len(".weight_q")]
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        if isinstance(getattr(parent, attr), QLinear):
            continue
        q = QLinear(*(tensor(f"{name}.{b}") for b in (
            "weight_q", "weight_scale", "bias", "act_scale", "out_scales")))
        setattr(parent, attr, q.to(dev))


def _resized_pos_embed(pos_embed, cfg):
    """A checkpoint trained at another resolution: the grid part of its
    pos_embed, bicubic-interpolated to the model's grid (in the checkpoint's
    dtype, float32 at least)."""
    from vision_transformer_cam_tpu_torch.ops.interpolate import (
        interpolate_pos_embed)
    old_grid = int(round((pos_embed.shape[1] - cfg.num_tokens) ** 0.5))
    dt = torch.promote_types(pos_embed.dtype, torch.float32)
    return interpolate_pos_embed(pos_embed.to(dt), old_grid, cfg.grid_size,
                                 num_tokens=cfg.num_tokens)


def load_state_dict(model: torch.nn.Module, sd: Mapping,
                    del_keys: Sequence[str] = ()) -> torch.nn.Module:
    """Load a reference-format state dict (numpy arrays or tensors) into
    ``model``, cast to each parameter's dtype and device.  The reference's
    dead model-level norm1/norm2 keys are skipped; keys in ``del_keys`` are
    dropped and keep the model's current values (the reference's head-key
    surgery).  A ``pos_embed`` of another grid size is bicubic-interpolated
    to the model's (``ops.interpolate.interpolate_pos_embed``).  Int8 layers in ``sd`` (``<name>.weight_q``) become
    ``QLinear`` modules first.  Any other missing or unexpected key
    raises."""
    _install_quantized(model, sd)
    own = model.state_dict()
    new = {}
    for k, v in sd.items():
        if k.startswith(_DEAD_PREFIXES) or k in del_keys:
            continue
        if k not in own:
            raise KeyError(f"unexpected checkpoint key {k}")
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, order="C"))
        if k == "pos_embed" and t.shape[1] != own[k].shape[1]:
            t = _resized_pos_embed(t, model.cfg)
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint key {k} has shape {tuple(t.shape)}, "
                             f"the model {tuple(own[k].shape)}")
        new[k] = t.to(dtype=own[k].dtype, device=own[k].device)
    missing = set(own) - set(new) - set(del_keys)
    if missing:
        raise KeyError(f"missing checkpoint keys {sorted(missing)}")
    model.load_state_dict(new, strict=False)
    return model


def load_weights(path: str, model: torch.nn.Module,
                 del_keys: Sequence[str] = ()) -> torch.nn.Module:
    """Load model weights from a file into ``model``: a checkpoint of the
    port's trainer (``train.checkpoint.save``: the ``model`` entry is loaded
    verbatim, optimizer moments and step are dropped) or a reference-format
    ``.pth`` state dict, where ``del_keys`` (the reference's head-key
    surgery) are dropped and keep the model's current values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), Mapping) and "optimizer" in sd:
        return load_state_dict(model, sd["model"])
    # a pretrained checkpoint may carry a pre_logits layer the model lacks
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own or k not in del_keys}
    return load_state_dict(model, sd, del_keys=del_keys)


def optimizer_state_from_jax(mu: Mapping, nu: Mapping, count: int,
                             cfg) -> dict:
    """optax AdamW moments (``ScaleByAdamState.mu`` / ``.nu``: trees shaped
    like the JAX parameters, as numpy arrays) and its step count -> the state
    dict of the port's ``train.state.Optimizer`` (``load_state_dict``)."""
    return {"count": int(count),
            "mu": state_dict_from_jax_params(mu, cfg),
            "nu": state_dict_from_jax_params(nu, cfg)}
