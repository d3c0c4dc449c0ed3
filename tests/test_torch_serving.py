"""The port's serving modes against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu import serving as jserving
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import rollout as troll

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=6, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4)


def test_bf16_config_matches_jax():
    t = tserving.serving_config(tcfgs.ViTCAMConfig(**TINY), "bf16")
    j = jserving.serving_config(jcfgs.ViTCAMConfig(**TINY), "bf16")
    for f in dataclasses.fields(j):
        if f.name in ("dtype", "param_dtype"):
            assert getattr(t, f.name) == torch.bfloat16
            assert getattr(j, f.name) == jnp.bfloat16
        elif f.name == "attn_impl":
            # JAX picks Pallas only on a TPU; the port always serves through
            # the kernel (its plain version on CPU tensors)
            assert (t.attn_impl, j.attn_impl) == ("kernel", "xla")
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_off_mode_is_identity():
    model = ViTCAM(tcfgs.ViTCAMConfig(**TINY))
    cfg = model.cfg
    assert tserving.apply_serving_mode(model, "off") is model
    assert model.cfg is cfg and model.head.weight.dtype == torch.float32


@pytest.mark.parametrize("mode", ["int8", "int8_hifi"])
def test_int8_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tserving.apply_serving_mode(ViTCAM(tcfgs.ViTCAMConfig(**TINY)), mode)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tserving.serving_config(tcfgs.ViTCAMConfig(**TINY), "fp8")


def test_bf16_serving_matches_jax_bf16():
    """Same float32 weights through both serving modes on CPU.  The qkv
    weights are scaled x10 so that the mask switches a token off in the last
    blocks.  JAX serves off-TPU through XLA (bf16 softmax, clamp after the
    symmetric pair mask); the port through the kernel's plain version
    (float32 softmax, clamp on the rank-1-masked logits).  The two clamp
    conventions agree while logits stay below 80, as they do here; what
    remains is bf16 rounding at different places: measured 3.0e-3 on the
    max-normalized CAM and 2.2e-3 on logits of magnitude ~0.25, so both are
    held to 1e-2."""
    jcfg, tcfg = jcfgs.ViTCAMConfig(**TINY), tcfgs.ViTCAMConfig(**TINY)
    params = jvit.init(jcfg, jax.random.key(1))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * 10.0
    model = ViTCAM(tcfg)
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    jparams, jc = jserving.apply_serving_mode(params, jcfg, "bf16")
    tserving.apply_serving_mode(model, "bf16")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())

    x = np.random.default_rng(5).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    want = jvit.forward(jparams, jnp.asarray(x), jc, need_rollout=True)
    before = tka.launches
    got = model(torch.from_numpy(x), need_rollout=True)
    assert tka.launches == before     # CPU tensors: the plain version ran
    assert got.logits.dtype == torch.bfloat16
    assert got.rollout_row.dtype == torch.float32   # f32 carry under bf16
    _, bg = jvit._mask_from_cls_row(want.attn_cls_rows[-1], jc)
    assert float(jnp.sum(bg)) > 0                   # the mask engaged
    cam_w = np.asarray(jroll.cam_from_rollout_row(want.rollout_row, 4))
    cam_g = troll.cam_from_rollout_row(got.rollout_row, 4).numpy()
    np.testing.assert_allclose(cam_g, cam_w.astype(np.float32), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got.logits.float().numpy(),
                               np.asarray(want.logits).astype(np.float32),
                               rtol=0, atol=1e-2)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)
