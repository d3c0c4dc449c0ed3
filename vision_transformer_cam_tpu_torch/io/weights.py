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

``jax_params_from_state_dict`` is the inverse mapping, and ``save_npz`` /
``load_npz`` read and write the JAX package's flat ``.npz`` container (the
pytree's paths joined by "/"), so float weights cross between the packages
both ways.  ``load_weights`` reads every container the port meets: a
reference ``.pth`` state dict (``load_pth``, with the head-key surgery), a
checkpoint of the port's own trainer, or a ``.npz`` of either package.  The
JAX trainer's orbax checkpoint directories need orbax, which the card's
machine lacks: they go through the JAX package's ``tools convert`` to a
``.npz`` first.  ``optimizer_state_from_jax`` carries optax AdamW moments
across, so both packages can take the same step from the same state.
``save_cnn_npz`` / ``load_cnn_npz`` hold the CNN-CAM demo's pytrees, whose
lists of stages, fires and blocks the flat layout keeps as path parts.
"""

from __future__ import annotations

import os
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


def _load_reference(model, sd, del_keys):
    # a pretrained checkpoint may carry a pre_logits layer the model lacks
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own or k not in del_keys}
    return load_state_dict(model, sd, del_keys=del_keys)


def load_pth(path: str, model: torch.nn.Module,
             del_keys: Sequence[str] = DEFAULT_DEL_KEYS) -> torch.nn.Module:
    """Load a reference-format ``.pth`` state dict (pretrained or fine-tuned)
    into ``model`` with the reference's head-key surgery: the keys in
    ``del_keys`` are dropped and keep the model's current values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _load_reference(model, sd, del_keys)


def load_weights(path: str, model: torch.nn.Module,
                 del_keys: Sequence[str] = ()) -> torch.nn.Module:
    """Load model weights from a file into ``model``: a ``.npz`` of either
    package (``save_npz``; loaded verbatim), a checkpoint of the port's
    trainer (``train.checkpoint.save``: the ``model`` entry is loaded
    verbatim, optimizer moments and step are dropped) or a reference-format
    ``.pth`` state dict (``load_pth``), where ``del_keys`` (the reference's
    head-key surgery) are dropped and keep the model's current values.  A
    directory (an orbax checkpoint of the JAX trainer) raises."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an orbax checkpoint of the JAX trainer; "
            "the port reads no orbax (the card's machine has none).  Convert "
            "it to .npz first, where orbax is installed, with the JAX "
            "package's cli/tools.py: convert --weights DIR --out FILE.npz")
    if path.endswith(".npz"):
        return load_state_dict(model, state_dict_from_jax_params(
            load_npz(path), model.cfg))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), Mapping) and "optimizer" in sd:
        return load_state_dict(model, sd["model"])
    return _load_reference(model, sd, del_keys)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def jax_params_from_state_dict(sd: Mapping, cfg) -> dict:
    """The inverse of ``state_dict_from_jax_params`` on float weights: a
    reference-named state dict (tensors or numpy arrays) -> the JAX
    package's parameter pytree as numpy arrays ([in, out] kernels, the
    blocks stacked on a leading depth axis), its keys in the order of the
    JAX ``vit.init`` tree, so that ``save_npz`` writes the archive the JAX
    package writes."""
    if any(k.endswith(".weight_q") for k in sd):
        raise ValueError("an int8 state dict (QLinear buffers) has no float "
                         "JAX parameter tree; convert the float weights")
    p, c, d = cfg.patch_size, cfg.in_chans, cfg.embed_dim
    g = {k: _np(v) for k, v in sd.items()}

    def lin(name):
        out = {"kernel": _t(g[name + ".weight"])}
        if name + ".bias" in g:
            out["bias"] = g[name + ".bias"]
        return out

    params = {
        "patch_embed": {"kernel": np.ascontiguousarray(
            g["patch_embed.proj.weight"].transpose(2, 3, 1, 0)
            .reshape(p * p * c, d)),
            "bias": g["patch_embed.proj.bias"]},
        "cls_token": g["cls_token"],
        "pos_embed": g["pos_embed"],
        "norm": {"scale": g["norm.weight"], "bias": g["norm.bias"]},
        "head1": lin("head1"),
    }
    if cfg.distilled:
        params["dist_token"] = g["dist_token"]
        params["head_dist"] = lin("head_dist")
    if cfg.has_logits:
        params["pre_logits"] = lin("pre_logits.fc")
    params["head"] = lin("head")

    def stack(name, convert):
        return np.stack([convert(g[f"blocks.{i}.{name}"])
                         for i in range(cfg.depth)])

    def blin(name):
        out = {"kernel": stack(name + ".weight", _t)}
        if f"blocks.0.{name}.bias" in g:
            out = {"bias": stack(name + ".bias", np.asarray), **out}
        return out

    def ln(name):
        return {"bias": stack(name + ".bias", np.asarray),
                "scale": stack(name + ".weight", np.asarray)}

    # the JAX tree stacks its blocks with jax.tree.map, which sorts the keys
    params["blocks"] = {
        "attn": {"proj": blin("attn.proj"), "qkv": blin("attn.qkv")},
        "ln1": ln("norm1"), "ln2": ln("norm2"),
        "mlp": {"fc1": blin("mlp.fc1"), "fc2": blin("mlp.fc2")}}
    return params


def save_npz(path: str, model_or_state_dict, cfg) -> None:
    """The JAX package's flat ``.npz`` of the weights of a ``ViTCAM`` or of
    a reference-named state dict: one array per pytree leaf, named by its
    path joined with "/"."""
    sd = model_or_state_dict.state_dict() \
        if isinstance(model_or_state_dict, torch.nn.Module) \
        else model_or_state_dict
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = np.asarray(node)

    rec(jax_params_from_state_dict(sd, cfg), ())
    np.savez(path, **flat)


def load_npz(path: str) -> dict:
    """A ``save_npz`` archive (of either package) as the nested pytree of
    numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for k in data.files:
            node = out
            parts = [p for p in k.split("/") if p]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
    return out


def save_cnn_npz(path: str, params: Mapping) -> None:
    """A CNN parameter pytree of the JAX package's layout (dicts and the
    lists ``stages``, ``fires``, ``blocks`` and ``transitions``) as a flat
    ``.npz`` of ``save_npz``'s kind: one array per leaf, named by its path
    joined with "/", a list position a path part (``stages/1/0/conv1``).
    The JAX package's ``save_npz`` descends into dicts only and pickles such
    lists, which its ``load_npz`` then refuses (ROADMAP, "Discrepancies
    already in the reference")."""
    flat = {}

    def rec(node, prefix):
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat["/".join(prefix)] = np.asarray(node)
            return
        for k, v in items:
            rec(v, prefix + (str(k),))

    rec(params, ())
    np.savez(path, **flat)


def load_cnn_npz(path: str):
    """A ``save_cnn_npz`` archive as the nested pytree of numpy arrays, with
    its lists rebuilt: a level whose keys are all 0..n-1 becomes a list.
    (``load_npz`` keeps every level a dict, so that no ViT archive reads
    differently.)"""
    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(load_npz(path))


def optimizer_state_from_jax(mu: Mapping, nu: Mapping, count: int,
                             cfg) -> dict:
    """optax AdamW moments (``ScaleByAdamState.mu`` / ``.nu``: trees shaped
    like the JAX parameters, as numpy arrays) and its step count -> the state
    dict of the port's ``train.state.Optimizer`` (``load_state_dict``)."""
    return {"count": int(count),
            "mu": state_dict_from_jax_params(mu, cfg),
            "nu": state_dict_from_jax_params(nu, cfg)}
