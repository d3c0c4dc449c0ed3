"""The port's int8 quantization, int8 GEMM and ln_quant against the JAX
package's.

Inputs are seeded numpy arrays handed to both sides.  The JAX Pallas
kernels (``linear_int8_fused``, ``ln_quant``) run in interpret mode; the
port's wrappers run their plain PyTorch versions on these CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu import serving as jserving
from vision_transformer_cam_tpu.kernels import gemm as jgemm
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import quant as jquant
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
from vision_transformer_cam_tpu_torch.ops import quant as tquant

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=6, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float64": jnp.float64}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float64": torch.float64}


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _calib(seed=1, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32)


def _pair(dtype="float32", seed=0):
    """JAX params and a port model on the same weights, both in ``dtype``."""
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=JDT[dtype], param_dtype=JDT[dtype])
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=TDT[dtype],
                              param_dtype=TDT[dtype])
    params = jvit.init(jcfg, jax.random.key(seed))
    model = ViTCAM(tcfg)
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model, tcfg


# ---------------------------------------------------------------------------
# 1. weights: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_identical(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)    # [in, out]
    w[:, 3] = 0.0                                           # amax floor 1e-8
    want = jquant.quantize_weight(jnp.asarray(w, JDT[dtype]))
    wq, scale = tquant.quantize_weight(
        torch.from_numpy(np.ascontiguousarray(w.T)).to(TDT[dtype]))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(want["kernel_q"]).T)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(want["scale"]).reshape(-1))


@pytest.mark.parametrize("static", [True, False])
def test_quantize_params_bit_identical_and_carried_across(static):
    """The port's quantize_params on the bf16-cast weights gives JAX's int8
    weights and scales bit for bit, patch embed included; the JAX quantized
    tree carried across (state_dict_from_jax_params + load_state_dict)
    gives the same buffers, and the port's state dict round-trips."""
    params, jcfg, model, _ = _pair()
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    model.to(torch.bfloat16)
    jscales = jquant.calibrate_act_scales(
        jb, jcfg.replace(dtype=jnp.bfloat16), jnp.asarray(_calib())) \
        if static else None
    jq = jquant.quantize_params(jb, act_scales=jscales)
    tscales = None
    if static:
        tscales = {"patch_embed": jscales["patch_embed"],
                   "blocks": {k: torch.from_numpy(np.array(v))
                              for k, v in jscales["blocks"].items()}}
    tquant.quantize_params(model, act_scales=tscales)
    got = model.state_dict()
    tcfg = model.cfg
    want = state_dict_from_jax_params(_tree_np(jq), tcfg)
    qkeys = [k for k in want if k.endswith(
        ("weight_q", "weight_scale", "act_scale", "out_scales"))]
    assert "patch_embed.proj.weight_q" in qkeys
    assert len([k for k in qkeys if k.endswith("weight_q")]) == \
        1 + 4 * TINY["depth"]
    assert ("blocks.0.attn.qkv.out_scales" in qkeys) == static
    assert sorted(got) == sorted(want)
    for k in want:
        # the int8 buffers in their own dtypes; the float rest (bf16 here,
        # float32 numpy on the JAX side) compared as values
        g, w = got[k], want[k]
        if k not in qkeys:
            w = w.to(g.dtype)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=k)
    # the carried-across tree loads into a fresh float model as QLinear
    fresh = ViTCAM(tcfg.replace(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16))
    load_state_dict(fresh, want)
    assert isinstance(fresh.blocks[0].attn.qkv, tquant.QLinear)
    back = fresh.state_dict()
    assert sorted(back) == sorted(got)
    for k in got:
        assert torch.equal(back[k], got[k]), k
    q = fresh.blocks[2].mlp.fc1
    if static:
        assert torch.equal(q.inv_act, 1.0 / q.act_scale)
        assert torch.equal(tquant.combined_scale(q), q.comb_scale)


# ---------------------------------------------------------------------------
# 2. calibration
# ---------------------------------------------------------------------------

def _port_scales(model, cfg, images):
    s = tquant.calibrate_act_scales(model, cfg, images)
    return s["patch_embed"], {k: _np(v) for k, v in s["blocks"].items()}


def test_calibration_matches_jax_float64():
    """float64 activations on both sides: every act scale and the
    [depth, 3, H] qkv output scales within rtol 1e-6, for sums taken in
    another order (measured: equal; both round the float64 absmax to
    float32 at the end)."""
    params, jcfg, model, tcfg = _pair("float64")
    x = _calib().astype(np.float64)
    want = jquant.calibrate_act_scales(params, jcfg, jnp.asarray(x))
    patch, blocks = _port_scales(model, tcfg, x)
    np.testing.assert_allclose(patch, want["patch_embed"], rtol=1e-6)
    assert blocks["qkv_out"].shape == (TINY["depth"], 3, TINY["num_heads"])
    for k, v in want["blocks"].items():
        assert blocks[k].dtype == np.float32, k
        np.testing.assert_allclose(blocks[k], np.asarray(v), rtol=1e-6,
                                   err_msg=k)


def test_calibration_matches_jax_bf16_serving():
    """The bf16 serving config (bf16 weights, clamp, tanh GELU): bf16
    rounds at other places in the two frameworks (XLA's bf16 dot and
    softmax against torch's), so the scales agree within rtol 2e-2
    (measured 7.4e-3, on the qkv output scales); the patch-embed scale
    reads only the bf16-cast images and is exact."""
    params, jcfg, model, tcfg = _pair()
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    jc = jserving.serving_config(jcfg, "int8")
    want = jquant.calibrate_act_scales(jb, jc, jnp.asarray(_calib()))
    model.to(torch.bfloat16)
    patch, blocks = _port_scales(
        model, tserving.serving_config(tcfg, "int8"), _calib())
    assert patch == want["patch_embed"]
    for k, v in want["blocks"].items():
        np.testing.assert_allclose(blocks[k], np.asarray(v), rtol=2e-2,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# 3. the int8 GEMM's plain version against the JAX functions
# ---------------------------------------------------------------------------

def _gemm_case(seed, k=72, n=48, m=(3, 11), bias=True, x_dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(m + (k,)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    act = np.float32(np.abs(x).max() / 127.0)
    jq = dict(jquant.quantize_weight(jnp.asarray(w)), bias=None if b is None
              else jnp.asarray(b))
    tq = tquant.QLinear.from_float(torch.from_numpy(np.ascontiguousarray(w.T)),
                                   None if b is None else torch.from_numpy(b))
    jx = jnp.asarray(x, JDT[x_dtype])
    tx = torch.from_numpy(x).to(TDT[x_dtype])
    return jx, tx, jq, tq, act


def _with_act(jq, tq, act):
    jq = dict(jq, act_scale=jnp.asarray(act, jnp.float32))
    tq = tquant.QLinear(tq.weight_q, tq.weight_scale, tq.bias,
                        torch.tensor(act))
    return jq, tq


def _int8_close(got, want, frac=0.0):
    """int8 equal, or within one step on at most ``frac`` of elements."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= (1 if frac else 0), d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


# float outputs: both sides run the same rounded float32 operations on the
# exact integer dot; held to 1e-6 relative (measured: equal)
F_RTOL = 1e-6


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["static", "dynamic", "int8_input"])
def test_qlinear_matches_jax(kind, x_dtype):
    jx, tx, jq, tq, act = _gemm_case(1, x_dtype=x_dtype)
    if kind != "dynamic":
        jq, tq = _with_act(jq, tq, act)
    if kind == "int8_input":
        xq = np.clip(np.round(np.asarray(jx, np.float32) / act), -127, 127
                     ).astype(np.int8)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
    want = np.asarray(jquant.qlinear(jx, jq, jq["bias"],
                                     out_dtype=jnp.float32))
    got = tquant.qlinear(tx, tq, out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (3, 11, 48)
    np.testing.assert_allclose(got, want, rtol=F_RTOL, atol=0)


def test_qlinear_int8_input_needs_static_scale():
    _, _, _, tq, _ = _gemm_case(2)
    with pytest.raises(ValueError, match="static act_scale"):
        tquant.qlinear(torch.zeros((2, 72), dtype=torch.int8), tq)


@pytest.mark.parametrize("x_int8", [False, True])
@pytest.mark.parametrize("groups", [3, 12])
def test_qlinear_requant_matches_jax(groups, x_int8):
    """Groups 3 (q|k|v thirds) and 3H (H = 4 heads of 4 columns)."""
    jx, tx, jq, tq, act = _gemm_case(3)
    jq, tq = _with_act(jq, tq, act)
    if x_int8:
        xq = np.clip(np.round(np.asarray(jx) / act), -127, 127).astype(np.int8)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
    osc = np.random.default_rng(4).uniform(0.02, 0.05, groups).astype(
        np.float32)
    want = np.asarray(jquant.qlinear_requant(jx, jq, jnp.asarray(osc),
                                             groups=groups))
    got = tquant.qlinear_requant(tx, tq, torch.from_numpy(osc),
                                 groups=groups).numpy()
    assert got.dtype == np.int8 and np.abs(got).max() > 60
    _int8_close(got, want)


@pytest.mark.parametrize("approx", [True, False])
def test_qlinear_gelu_requant_matches_jax(approx):
    """int8 outputs within one step on <= 0.1 % (tanh and erfc differ in
    the last ulp between the libraries; measured: equal)."""
    jx, tx, jq, tq, act = _gemm_case(5, m=(8, 33))
    jq, tq = _with_act(jq, tq, act)
    want = np.asarray(jquant.qlinear_gelu_requant(
        jx, jq, jnp.float32(0.02), gelu_approx=approx))
    got = tquant.qlinear_gelu_requant(tx, tq, torch.tensor(0.02),
                                      gelu_approx=approx).numpy()
    _int8_close(got, want, frac=1e-3)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_linear_int8_fused_matches_jax_interpret(x_dtype, bias):
    """Within 1e-6 of the output's magnitude: XLA's CPU backend contracts
    acc * cs + b into one FMA inside the interpreted kernel, where the port
    (plain version and CUDA kernel alike) rounds the product first, so a
    few outputs differ by one float32 ulp of acc * cs (measured 6.0e-8 on
    outputs of magnitude ~3)."""
    jx, tx, jq, tq, act = _gemm_case(6, bias=bias, x_dtype=x_dtype)
    jq, tq = _with_act(jq, tq, act)
    want = np.asarray(jgemm.linear_int8_fused(
        jx, jq["kernel_q"], jquant.combined_scale(jq), jq["bias"],
        1.0 / jq["act_scale"], out_dtype=jnp.float32, interpret=True))
    got = tquant.linear_int8_fused(tx, tq, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F_RTOL * np.abs(want).max())


def test_linear_int8_checks_and_counts():
    _, tx, jq, tq, act = _gemm_case(7)
    before = tgemm.linear_int8_launches
    with pytest.raises(ValueError, match="groups"):
        tquant.qlinear_requant(tx, tq, torch.ones(5), groups=5)
    with pytest.raises(TypeError, match="fused route"):
        tgemm.linear_int8(tx.to(torch.int8), tq.weight_q, tq.weight_scale,
                          None, torch.tensor(1.0), route="fused")
    with pytest.raises(ValueError):
        tgemm.linear_int8(tx[..., :-1], tq.weight_q, tq.weight_scale, None,
                          torch.tensor(1.0), route="qlinear")
    with pytest.raises(ValueError):
        tgemm.linear_int8(tx.to("meta"), tq.weight_q, tq.weight_scale, None,
                          torch.tensor(1.0), route="qlinear")
    tquant.qlinear(tx, tq)                       # dynamic, CPU plain version
    assert tgemm.linear_int8_launches == before


# ---------------------------------------------------------------------------
# 4. ln_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 64), (5, 72)])
def test_ln_quant_matches_jax_interpret(shape, x_dtype):
    """int8 equal, or within one step on <= 0.1 % (the row statistics sum
    in another order; measured: equal)."""
    rng = np.random.default_rng(8)
    c = shape[-1]
    x = (3.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    inv = np.float32(127.0 / 2.5)
    want = np.asarray(jgemm.ln_quant(
        jnp.asarray(x, JDT[x_dtype]), jnp.asarray(g), jnp.asarray(b),
        eps=1e-6, inv_a=jnp.float32(inv), interpret=True))
    before = tgemm.ln_quant_launches
    got = tgemm.ln_quant(torch.from_numpy(x).to(TDT[x_dtype]),
                         torch.from_numpy(g), torch.from_numpy(b), eps=1e-6,
                         inv_a=torch.tensor(inv)).numpy()
    assert tgemm.ln_quant_launches == before
    assert got.dtype == np.int8 and got.shape == shape
    assert 0.0 < (np.abs(got) == 127).mean() < 0.05
    _int8_close(got, want, frac=1e-3)
