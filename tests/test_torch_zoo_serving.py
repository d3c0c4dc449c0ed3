"""The zoo's widest and longest shapes served by the port, against the JAX
package on the same weights.

Two small models carry the shapes that ViT-H/14 and ViT-L/16@512 give the
serving path: heads of width 80 (kernel 1's second compiled width), and
N = 1025 tokens (``rollout_post``, and the int8 tier's output-only route past
640 tokens).  Weights come from the JAX ``vit.init`` (the qkv weights
scaled, so that the background mask engages) and reach the port through
``io.weights.state_dict_from_jax_params``.  The eager port at float64
is held to the JAX XLA path at the 1e-10 class; the serving configs on the
port's kernel route (the kernels' plain versions on CPU tensors) to the JAX
serving config with ``attn_impl="pallas"`` forced (interpret mode here: off
the TPU JAX serves through XLA, which ignores the int8 attention options) at
the gates of ``tests/test_torch_serving.py``: the whole forward with the
serving knobs at float32 activations, and at bf16 the first block.  On the card the full-size
models are served by ``chip_smoke.zoo_path``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu import serving as jserving
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import quant as jquant
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    jax_params_from_state_dict, load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import rollout as troll
from vision_transformer_cam_tpu_torch.ops.quant import QLinear

# ViT-H/14's shape at a small size: patch 14, heads of width 80, the
# pre-logits layer; 36 patches (N = 37), the mask from block 1, top-4
WIDE = dict(img_size=84, patch_size=14, embed_dim=160, depth=3, num_heads=2,
            num_classes=20, mask_from=1, top_k_patches=4,
            representation_size=160)
# ViT-L/16@512's token count at a small width: N = 1025, weights of the 224
# model (N = 197) through the pos-embed interpolation
LONG = dict(img_size=512, patch_size=16, embed_dim=64, depth=2, num_heads=1,
            num_classes=20, mask_from=0, top_k_patches=4)
QKV_GAIN = 10.0
F64_TOL = 1e-10
# the serving gates of tests/test_torch_serving.py, by activation dtype
WHOLE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _np_tree(tree):
    """JAX arrays as numpy, bf16 widened to float32 (exactly)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _params(kind, dtype):
    """(JAX params, JAX cfg, port cfg) of the same float weights, the JAX
    ``vit.init`` with the qkv weights scaled by QKV_GAIN.  WIDE: at its own
    size.  LONG: the 224 model's, loaded into the port's 512 model through
    the pos-embed interpolation and carried back to JAX
    (``jax_params_from_state_dict``).  float64: the float32 values widened.
    Cached: the JAX init compiles per config; no caller changes the tree."""
    kw = WIDE if kind == "wide" else LONG
    tcfg = tcfgs.ViTCAMConfig(**kw, dtype=dtype, param_dtype=dtype)
    jcfg = jcfgs.ViTCAMConfig(**kw, dtype=JDT[dtype], param_dtype=JDT[dtype])
    if dtype == torch.float64:   # the float32 init's values, widened
        params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              _params(kind, torch.float32)[0])
        return jax.tree.map(jnp.asarray, params), jcfg, tcfg
    init_cfg = jcfg if kind == "wide" else jcfg.replace(img_size=224)
    params = jvit.init(init_cfg, jax.random.key(3))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * QKV_GAIN
    params = jax.tree.map(np.asarray, params)
    if kind == "long":
        model = ViTCAM(tcfg, device="cpu")
        load_state_dict(model, state_dict_from_jax_params(
            params, tcfg.replace(img_size=224)))
        assert params["pos_embed"].shape[1] == 197
        assert tuple(model.pos_embed.shape) == (1, 1025, 64)
        params = jax_params_from_state_dict(model.state_dict(), tcfg)
    return jax.tree.map(jnp.asarray, params), jcfg, tcfg


def _images(kind, b, seed):
    size = (WIDE if kind == "wide" else LONG)["img_size"]
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _cam_close(got, want, grid, tol):
    cam_g = troll.cam_from_rollout_row(got.rollout_row, grid).numpy()
    cam_w = np.asarray(jroll.cam_from_rollout_row(want.rollout_row, grid))
    np.testing.assert_allclose(cam_g, cam_w.astype(cam_g.dtype), rtol=0,
                               atol=tol)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)


@pytest.mark.parametrize("kind", ["wide", "long"])
def test_eager_matches_jax_forward_f64(kind):
    """The eager port at float64 against the JAX XLA path: every output at
    1e-10; the background mask engages; the top-k is a real choice."""
    params, jcfg, tcfg = _params(kind, torch.float64)
    model = ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    b = 2 if kind == "wide" else 1
    x = _images(kind, b, seed=5)
    want = jvit.forward(params, jnp.asarray(x), jcfg, need_rollout=True)
    got = model(torch.from_numpy(x).double(), need_rollout=True)
    for name in ("logits", "head1_logits", "attn_cls_rows", "tokens_prenorm",
                 "rollout_row", "top_patch_embeds", "head1_kernel"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64, name
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL, err_msg=name)
    assert [set(r) for r in got.top_patch_idx.tolist()] == \
        [set(r) for r in np.asarray(want.top_patch_idx).tolist()]
    assert got.rollout_row.shape == (b, jcfg.seq_len)
    _cam_close(got, want, jcfg.grid_size, F64_TOL)
    _, bg = jvit._mask_from_cls_row(want.attn_cls_rows[-1], jcfg)
    assert 0 < float(jnp.sum(bg)) < b * jcfg.num_patches   # mask engaged


def _serving_pair(kind, mode, dtype):
    """(JAX params, JAX serving cfg forced to Pallas, port model) serving the
    same weights in ``mode``, at bf16 or (``dtype`` float32) with the serving
    knobs at float32 activations; the int8 modes calibrated and quantized by
    JAX on the same seeded images, the quantized tree carried to the port."""
    params, jcfg, tcfg = _params(kind, torch.float32)
    calib = jnp.asarray(_images(kind, 2, seed=2))
    tc = tserving.serving_config(tcfg, mode)
    if dtype == "bfloat16":
        kw = {} if mode == "bf16" else dict(calib_images=calib)
        jq, jc = jserving.apply_serving_mode(params, jcfg, mode, **kw)
    else:
        jc = jserving.serving_config(jcfg, mode).replace(
            dtype=jnp.float32, param_dtype=jnp.float32)
        jq = params if mode == "bf16" else jquant.quantize_params(
            params, jquant.calibrate_act_scales(params, jc, calib))
        tc = tc.replace(dtype=torch.float32, param_dtype=torch.float32)
    jc = jc.replace(attn_impl="pallas")
    model = ViTCAM(tc, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(_np_tree(jq), tc))
    model.to(tc.param_dtype)
    return jq, jc, model


def _serve_both(kind, mode, dtype):
    """(port output, JAX output) of one seeded batch, with the port's
    config checked: the kernel route at the model's head width, the int8
    tier's attention route by N, no CUDA launch (the plain versions ran)."""
    jq, jc, model = _serving_pair(kind, mode, dtype)
    tc = model.cfg
    assert tc.attn_impl == "kernel" and tc.head_dim == (80 if kind == "wide"
                                                        else 64)
    if mode != "bf16":
        assert isinstance(model.blocks[0].attn.qkv, QLinear)
        assert isinstance(model.patch_embed.proj, QLinear)
    if mode == "int8":
        # past 640 tokens the int8 tier takes the output-only route
        assert (tc.int8_attn_io, tc.int8_attn_out) == (
            (False, True) if kind == "long" else (True, False))
    b = 2 if kind == "wide" else 1
    x = _images(kind, b, seed=6)
    want = jvit.forward(jq, jnp.asarray(x), jc, need_rollout=True)
    before = (tka.launches, tgemm.linear_int8_launches)
    got = model(torch.from_numpy(x), need_rollout=True)
    assert (tka.launches, tgemm.linear_int8_launches) == before
    _, bg = jvit._mask_from_cls_row(want.attn_cls_rows[-1], jc)
    assert float(jnp.sum(bg)) > 0                   # the mask engaged
    assert got.rollout_row.shape == (b, tc.seq_len)
    return got, want, jc


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_hifi"])
@pytest.mark.parametrize("kind", ["wide", "long"])
def test_serving_matches_jax_pallas_f32(kind, mode):
    """Each serving config, its knobs at float32 activations, through the
    port's kernel route against the JAX serving config on its Pallas kernels:
    logits, rollout row and CAM within 1e-5 (the float32 gate of
    tests/test_torch_serving.py; the int8 GEMMs agree bit for bit, the rest
    sums in other orders).  At N = 1025 the rollout is formed after the
    blocks (rollout_post) on both sides, and the int8 tier's attention is
    the output-only route."""
    got, want, jc = _serve_both(kind, mode, "float32")
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=WHOLE_TOL["float32"])
    np.testing.assert_allclose(got.rollout_row.numpy(),
                               np.asarray(want.rollout_row), rtol=0,
                               atol=WHOLE_TOL["float32"])
    _cam_close(got, want, jc.grid_size, WHOLE_TOL["float32"])


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_hifi"])
@pytest.mark.parametrize("kind", ["wide", "long"])
def test_serving_bf16_matches_jax_pallas_first_block(kind, mode):
    """The serving configs at bf16, as served: the first block's cls row (a
    kernel output, before any background decision) within the bf16 gate of
    tests/test_torch_serving.py (1e-2); logits finite and CAM finite with
    max 1.  Past the first block bf16 rounds at other places in torch and
    XLA, and where that moves a token across the background threshold the
    later blocks part: JAX's own XLA path stands as far from its Pallas path
    on these models (CAMs up to 0.67 apart at N = 1025), so the whole
    forward is held to JAX at float32 activations (above)."""
    got, want, jc = _serve_both(kind, mode, "bfloat16")
    assert got.logits.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.attn_cls_rows[0].float().numpy(),
        np.asarray(want.attn_cls_rows[0]).astype(np.float32), rtol=0,
        atol=WHOLE_TOL["bfloat16"])
    assert torch.isfinite(got.logits.float()).all()
    cam = troll.cam_from_rollout_row(got.rollout_row, jc.grid_size).numpy()
    assert np.all(np.isfinite(cam)) and np.all(cam.max((1, 2)) == 1.0)


def test_zoo_configs_take_kernel1():
    """The full-size zoo models this slice serves: ViT-H/14 has heads of
    width 80 (kernel 1's second compiled width, and the backward's since
    the zoo trains on the kernel path; the other kernels refuse it),
    ViT-L/16@512 has N = 1025 and its int8 tier the output-only route."""
    h = tserving.serving_config(
        tcfgs.vit_huge_patch14_224_in21k(num_classes=20), "int8")
    assert (h.depth, h.embed_dim, h.num_heads, h.head_dim, h.seq_len) == \
        (32, 1280, 16, 80, 257)
    assert h.representation_size == 1280 and h.int8_attn_io
    assert tka.check_head_width("fused", h.head_dim) == 80
    assert tka.check_head_width("backward", h.head_dim) == 80
    with pytest.raises(ValueError, match="head width 64, got 80"):
        tka.check_head_width("block", h.head_dim)
    lg = tserving.serving_config(tcfgs.vit_large_patch16_512(num_classes=20),
                                 "int8")
    assert (lg.depth, lg.embed_dim, lg.head_dim, lg.seq_len) == \
        (24, 1024, 64, 1025)
    assert lg.int8_attn_out and not lg.int8_attn_io
