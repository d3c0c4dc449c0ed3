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
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

# Model-level keys the reference carries but never uses in the forward pass
# (its unused norm1 / norm2 modules); skipped on load.
_DEAD_PREFIXES = ("norm1.", "norm2.")

# the reference's head-key surgery when fine-tuning from a checkpoint
DEFAULT_DEL_KEYS = ("head.weight", "head.bias")


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


def load_state_dict(model: torch.nn.Module, sd: Mapping,
                    del_keys: Sequence[str] = ()) -> torch.nn.Module:
    """Load a reference-format state dict (numpy arrays or tensors) into
    ``model``, cast to each parameter's dtype and device.  The reference's
    dead model-level norm1/norm2 keys are skipped; keys in ``del_keys`` are
    dropped and keep the model's current values (the reference's head-key
    surgery).  Int8 layers in ``sd`` (``<name>.weight_q``) become
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
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint key {k} has shape {tuple(t.shape)}, "
                             f"the model {tuple(own[k].shape)}")
        new[k] = t.to(dtype=own[k].dtype, device=own[k].device)
    missing = set(own) - set(new) - set(del_keys)
    if missing:
        raise KeyError(f"missing checkpoint keys {sorted(missing)}")
    model.load_state_dict(new, strict=False)
    return model
