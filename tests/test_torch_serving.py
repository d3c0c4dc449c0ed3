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
from vision_transformer_cam_tpu.ops import quant as jquant
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import profile_serving as tprof
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops.quant import QLinear
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
    model = ViTCAM(tcfgs.ViTCAMConfig(**TINY), device="cpu")
    cfg = model.cfg
    assert tserving.apply_serving_mode(model, "off") is model
    assert model.cfg is cfg and model.head.weight.dtype == torch.float32


@pytest.mark.parametrize("img_size", [32, 208])
@pytest.mark.parametrize("mode", ["off", "bf16", "int8", "int8_hifi"])
def test_serving_config_matches_jax(mode, img_size):
    """Field for field the JAX serving config, but for attn_impl; at
    img_size 208 (N = 677) "int8" takes the route past 640 tokens."""
    kw = dict(TINY, img_size=img_size)
    t = tserving.serving_config(tcfgs.ViTCAMConfig(**kw), mode)
    j = jserving.serving_config(jcfgs.ViTCAMConfig(**kw), mode)
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(tv).split(".")[-1] == jnp.dtype(jv).name
        elif f.name == "attn_impl":
            assert (tv, jv) == (("eager", "xla") if mode == "off"
                                else ("kernel", "xla"))
        else:
            assert tv == jv, f.name
    if mode == "int8":
        assert (t.int8_attn_io, t.int8_attn_out) == (
            (False, True) if img_size == 208 else (True, False))


@pytest.mark.parametrize("mode", ["int8", "int8_hifi"])
def test_int8_modes_need_calibration_images(mode):
    model = ViTCAM(tcfgs.ViTCAMConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="calib_images"):
        tserving.apply_serving_mode(model, mode)
    assert model.cfg.dtype == torch.float32     # left as it was


def test_serving_mode_help():
    text = tserving.serving_mode_help()
    assert "equivalent fidelity" in text and "higher-fidelity" not in text
    for mode in tserving.SERVING_MODES:
        assert mode in text


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
    model = ViTCAM(tcfg, device="cpu")
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


def _np_tree(tree):
    """JAX arrays as numpy, bf16 widened to float32 (exactly)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


KNOBS = {"unfused": {}, "fused": dict(ln_quant_fusion=True,
                                      int8_fused_gemm=True)}
# port vs JAX on the same int8 weights and scales, max abs deviation of the
# rollout row (float32 only), the CAM and the logits (magnitude ~0.25), by
# activation dtype.  float32: the int8 GEMMs agree bit for bit; LayerNorm,
# softmax and the float heads sum in other orders, so an activation next to
# a .5 boundary could quantize one step apart: held to 1e-5, the JAX kernel
# tests' float32 rollout tolerance (measured: logits 4.5e-8, rollout row
# 1.5e-8, CAM 2.4e-7).  bf16: bf16 rounds at other places on top of that
# (XLA against torch): held to the bf16 serving test's 1e-2 (measured:
# logits 4.9e-3, CAM 3.6e-3).
WHOLE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _int8_pair(mode, dtype, knobs):
    """(JAX params, JAX cfg forced to Pallas, port model) serving the same
    int8 weights and scales: JAX quantizes, the port takes its tree."""
    jcfg, tcfg = jcfgs.ViTCAMConfig(**TINY), tcfgs.ViTCAMConfig(**TINY)
    params = jvit.init(jcfg, jax.random.key(1))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * 10.0
    calib = np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    tc = tserving.serving_config(tcfg, mode)
    if dtype == "bfloat16":
        jq, jc = jserving.apply_serving_mode(params, jcfg, mode,
                                             calib_images=calib)
    else:   # the serving knobs at float32 activations
        jc = jserving.serving_config(jcfg, mode).replace(
            dtype=jnp.float32, param_dtype=jnp.float32)
        jq = jquant.quantize_params(params, jquant.calibrate_act_scales(
            params, jc, jnp.asarray(calib)))
        tc = tc.replace(dtype=torch.float32, param_dtype=torch.float32)
    # off the TPU JAX serves through XLA, which ignores the int8 attention
    # flags: force its Pallas path (interpret mode here)
    jc = jc.replace(attn_impl="pallas", **KNOBS[knobs])
    model = ViTCAM(tc.replace(**KNOBS[knobs]), device="cpu")
    load_state_dict(model, state_dict_from_jax_params(_np_tree(jq), tc))
    return jq, jc, model


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int8_hifi"])
def test_int8_serving_matches_jax(mode, dtype, knobs):
    jq, jc, model = _int8_pair(mode, dtype, knobs)
    assert isinstance(model.blocks[0].attn.qkv, QLinear)
    assert isinstance(model.patch_embed.proj, QLinear)
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    want = jvit.forward(jq, jnp.asarray(x), jc, need_rollout=True)
    before = (tka.launches, tgemm.linear_int8_launches,
              tgemm.ln_quant_launches)
    got = model(torch.from_numpy(x), need_rollout=True)
    # CPU tensors: the plain versions ran, no kernel
    assert (tka.launches, tgemm.linear_int8_launches,
            tgemm.ln_quant_launches) == before
    _, bg = jvit._mask_from_cls_row(want.attn_cls_rows[-1], jc)
    assert float(jnp.sum(bg)) > 0                   # the mask engaged
    tol = WHOLE_TOL[dtype]
    logits_w = np.asarray(want.logits).astype(np.float32)
    np.testing.assert_allclose(got.logits.float().numpy(), logits_w, rtol=0,
                               atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(got.rollout_row.numpy(),
                                   np.asarray(want.rollout_row), rtol=0,
                                   atol=tol)
    cam_w = np.asarray(jroll.cam_from_rollout_row(want.rollout_row, 4))
    cam_g = troll.cam_from_rollout_row(got.rollout_row, 4).numpy()
    np.testing.assert_allclose(cam_g, cam_w.astype(np.float32), rtol=0,
                               atol=tol)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)


def test_int8_attention_io_needs_per_head_scales():
    """Under int8 attention I/O the qkv layer must carry per-head [3, H]
    out_scales, what both packages' calibration records; per-tensor [3]
    scales raise rather than take a route no producer feeds."""
    cfg = tcfgs.ViTCAMConfig(**TINY)
    model = ViTCAM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    calib = np.random.default_rng(3).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    tserving.apply_serving_mode(model, "int8", calib_images=calib)
    assert model.cfg.attn_impl == "kernel" and model.cfg.int8_attn_io
    qkv = model.blocks[0].attn.qkv
    qkv.out_scales = qkv.out_scales.amax(dim=1)
    with pytest.raises(ValueError, match=r"per head \[3, 4\]"):
        model(torch.zeros((1, 32, 32, 3)), need_rollout=True)


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::masked_attention_kernel<signed char, 2>",
     "attention kernel"),
    ("void (anonymous namespace)::linear_int8_kernel<signed char, "
     "__nv_bfloat16>", "int8 GEMM kernel"),
    ("ln_quant_kernel", "ln_quant kernel"),
    ("void (anonymous namespace)::masked_attention_seq_tc_kernel<true, "
     "true>(...)", "sequence-parallel attention kernel"),
    ("void (anonymous namespace)::masked_attention_bwd_tc_dkv_kernel<false>"
     "(...)", "attention backward kernel"),
    ("nvjet_tst_128x192_64x4_2x1_v_bz_coopB_TNT", "float GEMMs (cuBLAS)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "float GEMMs (cuBLAS)"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel",
     "LayerNorm"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", tprof.OTHER),
])
def test_profile_kernel_groups(name, group):
    assert tprof.group_of(name) == group


def test_profile_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.main(["--modes", "int8"]) == 1
    assert capsys.readouterr().out == ""


def test_int8_serving_distilled_model():
    """A distilled (cls + dist) model through the port's int8 serving:
    calibration walks the two-token prefix, head_dist stays float, and the
    int8 forward keeps the float model's accuracy class (logits cosine >
    0.99, as the JAX package's own test)."""
    cfg = tcfgs.ViTCAMConfig(**TINY, distilled=True)
    ref = ViTCAM(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    model = ViTCAM(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(15)
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    tserving.apply_serving_mode(model, "int8", calib_images=calib)
    assert isinstance(model.head_dist, torch.nn.Linear)
    assert model.blocks[0].attn.qkv.out_scales.shape == (3, 4)
    want = ref(x, need_rollout=True)
    got = model(x, need_rollout=True)
    a, b = want.logits.ravel(), got.logits.float().ravel()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99
    assert torch.isfinite(got.rollout_row).all()
    assert got.rollout_row.shape == (2, 16 + 2)
