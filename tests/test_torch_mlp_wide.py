"""The fused MLP at the zoo's wide widths, against the JAX package.

ViT-L (C = 1024, HID = 4096) and ViT-H/14 (C = 1280, HID = 5120) are the
widths past one column group of the CUDA kernels (``kernels/csrc/
mlp_fused_wgmma.cuh``, ``mlp_fused.cu``).  Here on the CPU the wrappers run
their plain versions, held to the JAX TPU kernels in Pallas interpret mode
on the same seeded inputs (37 rows: one block of 32 and a ragged tail),
then the whole forward of a depth-2 model at each width with ``mlp_fusion``
on, against JAX ``vit.forward`` with ``attn_impl="pallas"`` on the same
weights.  The CUDA kernels at these widths are held to their plain versions
on the card by ``tests/test_torch_mlp_wide_cuda.py`` and ``chip_smoke.py``.
"""

import functools

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
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import quant as tquant
from vision_transformer_cam_tpu_torch.ops import rollout as troll

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WIDTHS = {"vit_l": (1024, 4096), "vit_h": (1280, 5120)}
ROWS = 37
# the tolerances of tests/test_torch_fusions.py:
# test_mlp_fused_matches_jax_interpret (float32 1e-5, bf16 1e-2) and
# test_mlp_fused_int8_matches_jax_interpret (1e-5 at float32 output)
MLP_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
INT8_TOL = 1e-5


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _mlp_case(c, hid, seed):
    """x ~ N(0, 1); weights ~ N(0, 1 / fan_in) in the JAX layout [in, out]
    (outputs of magnitude ~1, as a trained layer's); biases ~ 0.01 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hid)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.01 * rng.standard_normal(hid)).astype(np.float32)
    w2 = (rng.standard_normal((hid, c)) / np.sqrt(hid)).astype(np.float32)
    b2 = (0.01 * rng.standard_normal(c)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wide_mlp_fused_matches_jax_interpret(width, dtype, gelu_approx):
    c, hid = WIDTHS[width]
    x, w1, b1, w2, b2 = _mlp_case(c, hid, seed=21)
    want = jgemm.mlp_fused(*(jnp.asarray(a, JDT[dtype])
                             for a in (x, w1, b1, w2, b2)),
                           gelu_approx=gelu_approx, block_m=32,
                           interpret=True)
    before = tgemm.mlp_fused_launches
    got = tgemm.mlp_fused(_t(x, dtype), _t(w1.T, dtype), _t(b1, dtype),
                          _t(w2.T, dtype), _t(b2, dtype),
                          gelu_approx=gelu_approx)
    assert tgemm.mlp_fused_launches == before      # CPU: the plain version
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=MLP_TOL[dtype])


def _hidden_before_rounding(x, t1, t2, gelu_approx):
    """The port's fc1 output on the int8 grid before rounding,
    gelu(acc1 * cs1 + b1) * inv_a2 in float32 (the plain version's steps)."""
    xq = torch.clamp(torch.round(x.float() * t1.inv_act), -127, 127)
    acc1 = (xq.double() @ t1.weight_q.double().t()).float()
    y = acc1 * t1.comb_scale + t1.bias
    return (tgemm._gelu_f32(y, gelu_approx) * t2.inv_act).numpy()


def _flips_explain(got, want, t2, pre, atol):
    """Rows of ``got`` further than ``atol`` from ``want`` are explained by
    the hidden tensor: each differs by exactly one int8 step at one hidden
    unit (the row moves by +-w2q[:, j] * cs2), a unit whose value before
    rounding sits within 1e-4 of a .5 boundary (a last-ulp difference of
    the float steps before it rounds it the other way), and with that step
    the row agrees within ``atol``.  Returns the number of such rows."""
    d = want - got
    rows = np.where((np.abs(d) > atol).any(axis=1))[0]
    w2q = t2.weight_q.numpy().astype(np.int64)          # [C, HID]
    cs2 = t2.comb_scale.numpy().astype(np.float64)
    for r in rows:
        k = np.rint(d[r] / cs2).astype(np.int64)
        units = [(j, s) for s in (1, -1)
                 for j in np.where((w2q == s * k[:, None]).all(axis=0))[0]]
        assert units, f"row {r} is off by more than one hidden step"
        j, sign = units[0]
        frac = pre[r, j] - np.floor(pre[r, j])
        assert abs(frac - 0.5) < 1e-4, (r, j, pre[r, j])
        np.testing.assert_allclose(got[r] + sign * w2q[:, j] * cs2, want[r],
                                   rtol=0, atol=atol)
    return len(rows)


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wide_mlp_fused_int8_matches_jax_interpret(width, gelu_approx):
    """bf16 x, as the int8 serving path passes it, float32 out: both sides
    run the same rounded float32 operations on exact integer sums, within
    1e-5.  Both GELUs are float32 formulas whose last ulp XLA and torch may
    round apart (XLA may also contract acc * cs + b into one FMA); where
    that lands on a .5 boundary of the hidden int8 grid one hidden value
    quantizes one step apart and its output row moves by w2q[:, j] * cs2.
    Among the 37 x 5120 hidden values of ViT-H/14's width this happens
    about once; such a row must be exactly that step (``_flips_explain``)."""
    c, hid = WIDTHS[width]
    x, w1, b1, w2, b2 = _mlp_case(c, hid, seed=22)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    layers = []
    for w, b, a in ((w1, b1, 4.5 / 127), (w2, b2, 6.0 / 127)):
        jq = dict(jquant.quantize_weight(jnp.asarray(w)),
                  bias=jnp.asarray(b), act_scale=jnp.float32(a))
        tq = tquant.QLinear.from_float(_t(w.T), _t(b), torch.tensor(a))
        layers.append((jq, tq))
    (j1, t1), (j2, t2) = layers
    want = jgemm.mlp_fused_int8(
        jnp.asarray(x, jnp.bfloat16), j1["kernel_q"],
        jquant.combined_scale(j1), j1["bias"], j2["kernel_q"],
        jquant.combined_scale(j2), j2["bias"], 1.0 / j1["act_scale"],
        1.0 / j2["act_scale"], gelu_approx=gelu_approx, block_m=32,
        out_dtype=jnp.float32, interpret=True)
    before = tgemm.mlp_fused_int8_launches
    got = tquant.mlp_fused_int8(_t(x, "bfloat16"), t1, t2,
                                gelu_approx=gelu_approx,
                                out_dtype=torch.float32)
    assert tgemm.mlp_fused_int8_launches == before
    assert got.dtype == torch.float32 and got.shape == x.shape
    # the hidden tensor is not all clipped: the test sees real int8 values
    hq = tgemm.linear_int8(_t(x, "bfloat16"), t1.weight_q, t1.comb_scale,
                           t1.bias, t1.inv_act, route="fused",
                           epilogue="gelu", out_scales=t2.inv_act.reshape(1))
    assert 20 < int(hq.abs().max()) and float((hq.abs() == 127).float()
                                              .mean()) < 0.05
    pre = _hidden_before_rounding(_t(x, "bfloat16"), t1, t2, gelu_approx)
    flipped = _flips_explain(got.numpy(), np.asarray(want), t2, pre,
                             INT8_TOL)
    assert flipped <= 2


# ---------------------------------------------------------------------------
# the whole forward at the wide widths, mlp_fusion on
# ---------------------------------------------------------------------------

# ViT-H/14's widths (C 1280, 16 heads of 80, HID 5120, patch 14) and ViT-L's
# (C 1024, 16 heads of 64, HID 4096, patch 16) at depth 2 on a 4 x 4 patch
# grid (N = 17), the mask from block 1
MODELS = {
    "vit_h": dict(img_size=56, patch_size=14, embed_dim=1280, depth=2,
                  num_heads=16, num_classes=20, mask_from=1, top_k_patches=4),
    "vit_l": dict(img_size=64, patch_size=16, embed_dim=1024, depth=2,
                  num_heads=16, num_classes=20, mask_from=1, top_k_patches=4),
}
QKV_GAIN = 10.0
BATCH = 2
INT8_KNOBS = dict(int8_fused_gemm=True, ln_quant_fusion=True)


@functools.lru_cache(maxsize=None)
def _params(width):
    """The JAX ``vit.init`` float32 weights, the qkv weights scaled so that
    the background mask engages (numpy; cached: no caller changes them)."""
    jcfg = jcfgs.ViTCAMConfig(**MODELS[width])
    params = jvit.init(jcfg, jax.random.key(4))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * QKV_GAIN
    return jax.tree.map(np.asarray, params)


def _np_tree(tree):
    """JAX arrays as numpy, bf16 widened to float32 (exactly)."""
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _images(width, b, seed):
    size = MODELS[width]["img_size"]
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _pair(width, mode):
    """(JAX params, JAX cfg on its Pallas path, port model on its kernel
    path) with ``mlp_fusion`` on, serving the same weights: "f32" float32;
    "bf16" the bf16 serving mode; "int8" the int8 serving mode with the int8
    knobs at float32 activations, calibrated and quantized by JAX on the same
    seeded images, the quantized tree carried to the port."""
    params = jax.tree.map(jnp.asarray, _params(width))
    jcfg = jcfgs.ViTCAMConfig(**MODELS[width])
    tcfg = tcfgs.ViTCAMConfig(**MODELS[width])
    if mode == "f32":
        jq, jc, tc = params, jcfg, tcfg.replace(attn_impl="kernel")
    elif mode == "bf16":
        jq, jc = jserving.apply_serving_mode(params, jcfg, "bf16")
        tc = tserving.serving_config(tcfg, "bf16")
    else:
        calib = jnp.asarray(_images(width, 2, seed=2))
        jc = jserving.serving_config(jcfg, "int8").replace(
            dtype=jnp.float32, param_dtype=jnp.float32)
        jq = jquant.quantize_params(params, jquant.calibrate_act_scales(
            params, jc, calib))
        jc = jc.replace(**INT8_KNOBS)
        tc = tserving.serving_config(tcfg, "int8").replace(
            dtype=torch.float32, param_dtype=torch.float32, **INT8_KNOBS)
    jc = jc.replace(attn_impl="pallas", mlp_fusion=True)
    tc = tc.replace(mlp_fusion=True)
    model = tvit.ViTCAM(tc, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(_np_tree(jq), tc))
    model.to(tc.param_dtype)
    return jq, jc, model


class _Calls:
    """Counts the calls the model makes to the fused MLP wrappers."""

    def __init__(self, monkeypatch):
        self.n = {}
        for name in ("mlp_fused", "mlp_fused_int8"):
            monkeypatch.setattr(tvit, name, self._wrap(name,
                                                       getattr(tvit, name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return counted


def _cam(out, grid, torch_side):
    if torch_side:
        return troll.cam_from_rollout_row(out.rollout_row, grid).float() \
            .numpy()
    return np.asarray(jroll.cam_from_rollout_row(out.rollout_row, grid)) \
        .astype(np.float32)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("width", sorted(MODELS))
def test_wide_fused_forward_matches_jax_pallas(monkeypatch, width, mode):
    """The forward with ``mlp_fusion`` at the wide widths: every block's MLP
    through the fused wrapper (the plain version here), against JAX's fused
    MLP kernel on its Pallas path.  Tolerances: float32 those of
    ``test_fused_forward_matches_jax_pallas_f32`` (logits and pre-norm tokens
    2e-4, cls rows and rollout row 1e-5); int8 at float32 activations that
    of ``test_int8_fused_forward_matches_jax`` (1e-5: logits, rollout row,
    CAM)."""
    jq, jc, model = _pair(width, mode)
    x = _images(width, BATCH, seed=13)
    want = jvit.forward(jq, jnp.asarray(x), jc, need_rollout=True)
    calls = _Calls(monkeypatch)
    before = (tgemm.mlp_fused_launches, tgemm.mlp_fused_int8_launches)
    got = model(torch.from_numpy(x), need_rollout=True)
    assert (tgemm.mlp_fused_launches, tgemm.mlp_fused_int8_launches) == \
        before
    depth = MODELS[width]["depth"]
    assert calls.n == {"mlp_fused_int8" if mode == "int8" else "mlp_fused":
                       depth}
    _, bg = jvit._mask_from_cls_row(want.attn_cls_rows[-1], jc)
    assert 0 < float(jnp.sum(bg)) < bg.size           # the mask engaged
    if mode == "f32":
        tols = dict(logits=2e-4, attn_cls_rows=1e-5, tokens_prenorm=2e-4,
                    rollout_row=1e-5)
    else:
        tols = dict(logits=1e-5, rollout_row=1e-5)
    for name, tol in tols.items():
        np.testing.assert_allclose(
            getattr(got, name).float().numpy(),
            np.asarray(getattr(want, name)).astype(np.float32), rtol=0,
            atol=tol, err_msg=name)
    cam_g = _cam(got, jc.grid_size, True)
    np.testing.assert_allclose(cam_g, _cam(want, jc.grid_size, False),
                               rtol=0, atol=1e-5)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)


@pytest.mark.parametrize("width", sorted(MODELS))
def test_wide_fused_forward_bf16(monkeypatch, width):
    """The bf16 serving mode with ``mlp_fusion``.  At these widths bf16
    rounds at other places in torch and XLA by more than the bf16 gate of
    1e-2 on the whole forward whatever the MLP route: the port's unfused
    bf16 logits stand 0.020-0.021 from JAX's, JAX's own Pallas and XLA paths
    0.014-0.035 apart.  So, as ``tests/test_torch_zoo_serving.py`` holds the
    zoo's bf16 configs: the first block's cls row (before any background
    decision) against JAX's within 1e-2; and the fused forward against the
    port's unfused bf16 forward (logits, CAM) within 1e-2, the difference the
    fused MLP's roundings make.  The fused kernel itself is held to JAX's at
    bf16 above."""
    jq, jc, model = _pair(width, "bf16")
    x = _images(width, BATCH, seed=13)
    want = jvit.forward(jq, jnp.asarray(x), jc, need_rollout=True)
    calls = _Calls(monkeypatch)
    got = model(torch.from_numpy(x), need_rollout=True)
    assert calls.n == {"mlp_fused": MODELS[width]["depth"]}
    assert got.logits.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.attn_cls_rows[0].float().numpy(),
        np.asarray(want.attn_cls_rows[0]).astype(np.float32), rtol=0,
        atol=1e-2)
    model.cfg = model.cfg.replace(mlp_fusion=False)
    base = model(torch.from_numpy(x), need_rollout=True)
    np.testing.assert_allclose(got.logits.float().numpy(),
                               base.logits.float().numpy(), rtol=0, atol=1e-2)
    cam_g = _cam(got, jc.grid_size, True)
    np.testing.assert_allclose(cam_g, _cam(base, jc.grid_size, True), rtol=0,
                               atol=1e-2)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)
