"""The port's checkpoint interop against the JAX package's."""

import numpy as np
import pytest
import torch

import jax

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.io import weights as jweights
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
KINDS = {"plain": {}, "distilled": dict(distilled=True),
         "has_logits": dict(representation_size=32)}


def _jax_params(kind, seed=0):
    jcfg = jcfgs.ViTCAMConfig(**TINY, **KINDS[kind])
    params = jvit.init(jcfg, jax.random.key(seed))
    return params, jcfg, tcfgs.ViTCAMConfig(**TINY, **KINDS[kind])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_state_dict_bit_identical_to_jax_export(kind):
    params, jcfg, tcfg = _jax_params(kind)
    want = jweights.state_dict_from_pytree(params, jcfg)
    got = tweights.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # ... and they are exactly the port model's parameter names and shapes
    own = ViTCAM(tcfg).state_dict()
    assert sorted(own) == sorted(got)
    assert all(tuple(own[k].shape) == tuple(got[k].shape) for k in own)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reference_state_dict_loads_and_round_trips(kind):
    """A reference-format numpy state dict (with the reference's dead
    model-level norm1/norm2 keys) loads bit for bit; the port's state dict
    converts back to the same JAX pytree."""
    params, jcfg, tcfg = _jax_params(kind, seed=1)
    sd = jweights.state_dict_from_pytree(params, jcfg)
    sd.update({"norm1.weight": np.ones(256, np.float32),
               "norm2.bias": np.zeros(32, np.float32)})
    model = tweights.load_state_dict(ViTCAM(tcfg), sd)
    own = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in own.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    back = jweights.pytree_from_state_dict(own, jcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_head_surgery_and_cast():
    params, jcfg, tcfg = _jax_params("plain", seed=2)
    sd = jweights.state_dict_from_pytree(params, jcfg)
    model = ViTCAM(tcfg.replace(param_dtype=torch.bfloat16,
                                dtype=torch.bfloat16))
    head_before = model.head.weight.detach().clone()
    tweights.load_state_dict(model, sd, del_keys=tweights.DEFAULT_DEL_KEYS)
    assert torch.equal(model.head.weight, head_before)   # kept, not loaded
    assert model.head1.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.head1.weight.detach().float().numpy(),
        torch.from_numpy(sd["head1.weight"]).to(torch.bfloat16).float().numpy())


def test_bad_state_dicts_raise():
    params, jcfg, tcfg = _jax_params("plain", seed=3)
    sd = jweights.state_dict_from_pytree(params, jcfg)
    model = ViTCAM(tcfg)
    with pytest.raises(KeyError):
        tweights.load_state_dict(model, {k: v for k, v in sd.items()
                                         if k != "head1.bias"})
    with pytest.raises(KeyError):
        tweights.load_state_dict(model, dict(sd, **{"extra.weight": sd[
            "head.bias"]}))
    with pytest.raises(ValueError):
        tweights.load_state_dict(model, dict(sd, **{"head.bias": sd[
            "head.bias"][:-1]}))


def test_init_is_seeded_with_the_reference_scheme():
    tcfg = tcfgs.ViTCAMConfig(**TINY)
    a = ViTCAM(tcfg, generator=torch.Generator().manual_seed(5)).state_dict()
    b = ViTCAM(tcfg, generator=torch.Generator().manual_seed(5)).state_dict()
    c = ViTCAM(tcfg, generator=torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"],
                           c["blocks.0.attn.qkv.weight"])
    # the reference's init scheme: truncated normals cut at +-2, zero biases,
    # unit LayerNorms, head1 uniform in +-1/sqrt(C)
    w = a["blocks.0.mlp.fc1.weight"]
    assert 0.008 < float(w.std()) < 0.012 and float(w.abs().max()) <= 2.0
    assert not a["blocks.0.mlp.fc1.bias"].any()
    assert torch.equal(a["norm.weight"], torch.ones(64))
    assert float(a["head1.weight"].abs().max()) <= 64 ** -0.5
