"""The port's ViT-CAM forward against the JAX package's, on the same weights.

Parameters come from the JAX ``vit.init`` on the tiny config and reach the
port through ``io.weights.state_dict_from_jax_params``; images are seeded
numpy.  The qkv weights are scaled up so that attention is far from uniform
and the background mask really switches tokens off (random-init attention is
near uniform and would leave every token foreground).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import rollout as troll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=6, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4)
QKV_GAIN = 20.0
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}


def _pair(dtype=torch.float64, seed=0, jax_impl="xla", **kw):
    """(JAX params, JAX cfg, port model) on the same weights."""
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=dtype, param_dtype=dtype, **kw)
    jkw = dict(kw, attn_impl=jax_impl) if "attn_impl" in kw else kw
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=JDT[dtype], param_dtype=JDT[dtype],
                              **jkw)
    params = jvit.init(jcfg, jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * QKV_GAIN
    np_params = jax.tree.map(np.asarray, params)
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(np_params, tcfg))
    return params, jcfg, model


def _images(b=3, seed=7):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3))


def _top_sets(idx):
    return [set(r) for r in np.asarray(idx).tolist()]


# float64 on both sides: the eager port and the JAX XLA path do the same math
# in another order, so they agree to rounding (the JAX goldens' 1e-10 class
# against the reference).
F64_TOL = 1e-10
CASES = {
    "batch_global": {},
    "per_sample": dict(per_sample_mask_norm=True),
    "distilled": dict(distilled=True),
    "has_logits": dict(representation_size=32),
    "rollout_post": dict(rollout_post=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_matches_jax_forward_f64(case):
    params, jcfg, model = _pair(**CASES[case])
    x = _images()
    want = jvit.forward(params, jnp.asarray(x), jcfg, need_rollout=True)
    got = model(torch.from_numpy(x), need_rollout=True)
    for name in ("logits", "head1_logits", "attn_cls_rows", "tokens_prenorm",
                 "rollout_row", "top_patch_embeds", "head1_kernel"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64, name
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL, err_msg=name)
    # lax.top_k and torch.topk may order ties differently: compare sets
    assert _top_sets(got.top_patch_idx) == _top_sets(want.top_patch_idx)
    g = jcfg.grid_size
    np.testing.assert_allclose(
        troll.cam_from_rollout_row(got.rollout_row, g).numpy(),
        np.asarray(jroll.cam_from_rollout_row(want.rollout_row, g)),
        rtol=0, atol=F64_TOL)
    if case == "batch_global":
        # the mask really engaged: some, not all, patches went background
        _, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1],
                                        model.cfg)
        assert 0 < float(bg.sum()) < bg.shape[0] * jcfg.num_patches


def test_eager_collected_outputs_match_jax_f64():
    params, jcfg, model = _pair(per_sample_mask_norm=True)
    x = _images(b=2, seed=11)
    kw = dict(need_headmean=True, need_perhead=True, need_blocks=True,
              need_rollout=True)
    want = jvit.forward(params, jnp.asarray(x), jcfg, **kw)
    got = model(torch.from_numpy(x), **kw)
    for name in ("attn_headmean", "attn_perhead", "block_outputs",
                 "rollout_row", "logits"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL, err_msg=name)


# float32, port kernel path (its plain version on CPU) vs JAX Pallas in
# interpret mode: the JAX kernel tests' own tolerances for this pair
# (tests/test_kernels.py): rollout row 1e-5, logits 2e-4.
@pytest.mark.parametrize("variant", ["rollout", "headmean", "plain"])
def test_kernel_path_matches_jax_pallas_f32(variant):
    kw = dict(attn_impl="kernel", per_sample_mask_norm=True)
    if variant == "headmean":
        kw["rollout_post"] = True     # the post-loop chain reads head means
    params, jcfg, model = _pair(dtype=torch.float32, seed=1,
                                jax_impl="pallas", **kw)
    x = _images(b=2, seed=13).astype(np.float32)
    need_rollout = variant != "plain"
    want = jvit.forward(params, jnp.asarray(x), jcfg,
                        need_rollout=need_rollout)
    got = model(torch.from_numpy(x), need_rollout=need_rollout)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=2e-4)
    # the top-K patch set is defined only where the K-th and (K+1)-th patch
    # weights are apart: fully masked patches tie at float32 underflow
    # (~1e-44), where any order is right
    k = jcfg.top_k_patches
    m14, _ = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    srt = -np.sort(-m14.numpy(), axis=-1)
    clear = srt[:, k - 1] - srt[:, k] > 1e-4
    assert clear.any()
    assert [s for s, c in zip(_top_sets(got.top_patch_idx), clear) if c] == \
        [s for s, c in zip(_top_sets(want.top_patch_idx), clear) if c]
    np.testing.assert_allclose(got.head1_logits.numpy()[clear],
                               np.asarray(want.head1_logits)[clear], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got.attn_cls_rows.numpy(),
                               np.asarray(want.attn_cls_rows), rtol=0,
                               atol=1e-5)
    if need_rollout:
        np.testing.assert_allclose(got.rollout_row.numpy(),
                                   np.asarray(want.rollout_row), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("fn", ["aug_normalize", "aug_cls_row",
                                "rollout_cls_row", "cam_from_rollout_row",
                                "per_block_cams"])
def test_rollout_ops_match_jax(fn):
    rng = np.random.default_rng(3)
    hm = rng.random((4, 2, 17, 17))
    hm /= hm.sum(-1, keepdims=True)             # rows of a head mean sum to 1
    arg = {"aug_normalize": hm, "rollout_cls_row": hm,
           "aug_cls_row": hm[:, :, 0],
           "per_block_cams": hm[:, :, 0],
           "cam_from_rollout_row": hm[0, :, 0]}[fn]
    extra = (4,) if fn in ("cam_from_rollout_row", "per_block_cams") else ()
    got = getattr(troll, fn)(torch.from_numpy(arg), *extra).numpy()
    want = np.asarray(getattr(jroll, fn)(jnp.asarray(arg), *extra))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_rollout_prefix_must_fit_the_grid():
    row = torch.rand(2, 18)
    with pytest.raises(ValueError):
        troll.cam_from_rollout_row(row, 4, prefix_tokens=1)
    assert troll.cam_from_rollout_row(row, 4).shape == (2, 4, 4)


def test_config_mirrors_jax_config():
    jf = [f.name for f in dataclasses.fields(jcfgs.ViTCAMConfig)]
    tf = [f.name for f in dataclasses.fields(tcfgs.ViTCAMConfig)]
    assert tf == jf
    j, t = jcfgs.ViTCAMConfig(), tcfgs.ViTCAMConfig()
    for name in jf:
        if name in ("dtype", "param_dtype"):
            assert getattr(t, name) == torch.float32
        elif name == "attn_impl":
            assert (j.attn_impl, t.attn_impl) == ("xla", "eager")
        else:
            assert getattr(t, name) == getattr(j, name), name
    assert sorted(tcfgs.MODEL_ZOO) == sorted(jcfgs.MODEL_ZOO)
    props = ("grid_size", "num_patches", "num_tokens", "seq_len", "head_dim",
             "scale", "mlp_hidden", "has_logits")
    for name in jcfgs.MODEL_ZOO:
        jc, tc = jcfgs.MODEL_ZOO[name](), tcfgs.MODEL_ZOO[name]()
        for p in props + ("embed_dim", "depth", "num_heads",
                          "representation_size", "num_classes"):
            assert getattr(tc, p) == getattr(jc, p), (name, p)
    assert tcfgs.resolve_model("vit_base") is \
        tcfgs.vit_base_patch16_224_in21k
    with pytest.raises(SystemExit):
        tcfgs.resolve_model("vit_typo")


@pytest.mark.parametrize("knob", [dict(attn_q_block=64),
                                  dict(matmul_precision="bfloat16")])
def test_unported_knobs_raise(knob):
    """A query tile or a matmul precision the card has no mode for is
    refused by name.  No tuning knob is left unported (``data_axis`` is
    data parallelism, ported: tests/test_torch_data_parallel_cli.py)."""
    with pytest.raises((NotImplementedError, ValueError)) as err:
        tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY, **knob), device="cpu")
    assert list(knob)[0] in str(err.value)
    assert tvit._UNPORTED == {}


@pytest.mark.parametrize("q_block", [16, 32])
def test_attn_q_block_reaches_the_kernel_wrapper(monkeypatch, q_block):
    """cfg.attn_q_block is handed to masked_attention_fused on every layer
    and changes no result on the CPU (the plain version has no tiles)."""
    cfg = tcfgs.ViTCAMConfig(**TINY, attn_impl="kernel")
    model = tvit.ViTCAM(cfg, device="cpu")
    x = torch.from_numpy(_images().astype(np.float32))
    want = model(x, need_rollout=True)
    seen = []
    real = tvit.masked_attention_fused

    def spy(*args, **kw):
        seen.append(kw.get("q_block"))
        return real(*args, **kw)
    monkeypatch.setattr(tvit, "masked_attention_fused", spy)
    model.cfg = cfg.replace(attn_q_block=q_block)
    got = model(x, need_rollout=True)
    assert seen == [q_block] * cfg.depth
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got.rollout_row, want.rollout_row)


@pytest.mark.parametrize("bad", [dict(attn_q_block=24),
                                 dict(attn_block_b=-1)])
def test_bad_tile_knobs_raise(bad):
    with pytest.raises(ValueError, match=list(bad)[0]):
        tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY, **bad), device="cpu")


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_attn_block_b_changes_nothing(impl):
    """Images per TPU kernel program: no counterpart on the card; any value
    is taken and the outputs are bit-identical."""
    cfg = tcfgs.ViTCAMConfig(**TINY, attn_impl=impl)
    model = tvit.ViTCAM(cfg, device="cpu")
    x = torch.from_numpy(_images().astype(np.float32))
    want = model(x, need_rollout=True)
    model.cfg = cfg.replace(attn_block_b=4)
    got = model(x, need_rollout=True)
    for name in ("logits", "head1_logits", "attn_cls_rows", "rollout_row"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("value,mode", [(None, "highest"),
                                        ("highest", "highest"),
                                        ("float32", "highest"),
                                        ("high", "high"),
                                        ("tensorfloat32", "high")])
def test_matmul_precision_is_set_around_the_forward_and_restored(
        monkeypatch, value, mode):
    cfg = tcfgs.ViTCAMConfig(**TINY, attn_impl="kernel")
    model = tvit.ViTCAM(cfg, device="cpu")
    x = torch.from_numpy(_images().astype(np.float32))
    want = model(x, need_rollout=True)
    seen = []
    real = tvit.masked_attention_fused

    def spy(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args, **kw)
    monkeypatch.setattr(tvit, "masked_attention_fused", spy)
    before = torch.get_float32_matmul_precision()
    model.cfg = cfg.replace(matmul_precision=value)
    got = model(x, need_rollout=True)
    assert seen == [mode] * cfg.depth
    assert torch.get_float32_matmul_precision() == before
    # on the CPU the float32 GEMMs are full float32 in either mode
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got.rollout_row, want.rollout_row)


def test_matmul_precision_high_trains_on_the_eager_path_only():
    """The backward kernel's products are full float32: the kernel path
    refuses to train at "high" and names the eager path (no hidden
    reroute)."""
    x = torch.from_numpy(_images().astype(np.float32))
    cfg = tcfgs.ViTCAMConfig(**TINY, matmul_precision="high")
    with pytest.raises(ValueError, match="attn_impl='eager'"):
        tvit.ViTCAM(cfg.replace(attn_impl="kernel"),
                    device="cpu").forward_train(x)
    before = torch.get_float32_matmul_precision()
    out = tvit.ViTCAM(cfg, device="cpu").forward_train(x)
    assert torch.isfinite(out.logits).all()
    assert torch.get_float32_matmul_precision() == before


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax, optax, orbax
    or the JAX package (the GPU machine has none of them), and no source
    names a module of the JAX package."""
    pkg = os.path.join(REPO, "vision_transformer_cam_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'orbax', "
            "'vision_transformer_cam_tpu')]\n"
            "assert not bad, bad\n"
            "print(len(" f"{sorted(mods)!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(mods) >= 40
    for name in ("train.step", "train.loop", "train.state", "train.schedule",
                 "train.checkpoint", "cli.train", "data.loader", "data.voc12",
                 "data.transforms", "ops.losses", "utils.metrics",
                 "parallel", "parallel.mesh", "parallel.worker", "cam",
                 "cam.pseudo_seg", "cam.render", "cli.validate",
                 "io.native_loader", "data.palette", "ops.interpolate",
                 "bench", "utils.profiling", "scripts", "scripts.microbench",
                 "scripts.attn_variants", "scripts.qblock_sweep",
                 "scripts.quality_eval", "scripts.seg_diagnose",
                 "scripts.precision_ladder", "profile_serving",
                 "cli.predict", "cli.tools", "data.generic",
                 "scripts.e2e_bench", "examples", "examples.quickstart",
                 "kernels.ops", "cli.export", "examples.serve_artifact",
                 "scripts.w80_variants", "scripts.dryrun_multichip"):
        assert "vision_transformer_cam_tpu_torch." + name in mods
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "vision_transformer_cam_tpu." not in src, f
                assert "import jax" not in src and "import optax" not in src \
                    and "import orbax" not in src, f
