"""The port's pseudo-segmentation, palette, metrics and native-loader copies
against the JAX package's, on seeded inputs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.cam import pseudo_seg as jps
from vision_transformer_cam_tpu.cam import render as jrender
from vision_transformer_cam_tpu.data import palette as jpal
from vision_transformer_cam_tpu.data import voc12 as jvoc
from vision_transformer_cam_tpu.io import native_loader as jnative
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import rollout as jroll
from vision_transformer_cam_tpu.utils import metrics as jmetrics
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.cam import pseudo_seg as tps
from vision_transformer_cam_tpu_torch.cam import render as trender
from vision_transformer_cam_tpu_torch.data import palette as tpal
from vision_transformer_cam_tpu_torch.data import voc12 as tvoc
from vision_transformer_cam_tpu_torch.io import native_loader as tnative
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import rollout as troll
from vision_transformer_cam_tpu_torch.utils import metrics as tmetrics

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=7, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4,
            per_sample_mask_norm=True)


def _outputs(distilled=False, seed=0):
    """The two packages' float64 forward outputs on the same weights, with a
    head1 bias that puts some classes past the 0.9 gate."""
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=jnp.float64,
                              param_dtype=jnp.float64, distilled=distilled)
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.float64,
                              param_dtype=torch.float64, distilled=distilled)
    params = jvit.init(jcfg, jax.random.key(seed))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 20.0
    bias = np.full((20,), -3.0)
    bias[[2, 7, 11]] = 4.0
    params["head1"]["bias"] = jnp.asarray(bias)
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    x = np.random.default_rng(seed + 1).standard_normal((3, 32, 32, 3))
    return (jvit.forward(params, jnp.asarray(x), jcfg), jcfg,
            model(torch.from_numpy(x)), tcfg)


@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "dist"])
def test_pseudo_seg_device_matches_jax_f64(distilled):
    jout, jcfg, tout, tcfg = _outputs(distilled)
    want = jps.pseudo_seg_device(jout, jcfg, jcfgs.PseudoSegConfig())
    got = tps.pseudo_seg_device(tout, tcfg, tcfgs.PseudoSegConfig())
    np.testing.assert_array_equal(got.patch_to_cls.numpy(),
                                  np.asarray(want.patch_to_cls))
    assert got.patch_to_cls.dtype == torch.int32
    # classes and fillers both occur
    assert (got.patch_to_cls < 20).any()
    np.testing.assert_allclose(got.cos_maps.numpy(),
                               np.asarray(want.cos_maps), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.bg_row.numpy(), np.asarray(want.bg_row),
                               rtol=0, atol=1e-10)


def test_patch_class_assignment_ties_and_fillers():
    """First-maximum ties and the arange fillers, as the JAX function."""
    rng = np.random.default_rng(5)
    probs = rng.random((4, 6))
    probs[0] = 0.0                               # no class predicted
    kernel_t = np.round(rng.standard_normal((6, 12)), 1)   # many ties
    embeds = np.round(rng.standard_normal((4, 5, 12)), 0)
    want = jps._patch_class_assignment(jnp.asarray(probs),
                                       jnp.asarray(kernel_t),
                                       jnp.asarray(embeds), 0.5)
    got = tps._patch_class_assignment(torch.from_numpy(probs),
                                      torch.from_numpy(kernel_t),
                                      torch.from_numpy(embeds), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zero_norm_rows_give_zero_cosines():
    jout, jcfg, tout, tcfg = _outputs()
    tout = tout._replace(tokens_prenorm=torch.zeros_like(tout.tokens_prenorm))
    got = tps.pseudo_seg_device(tout, tcfg, tcfgs.PseudoSegConfig())
    assert torch.isfinite(got.cos_maps).all() and not got.cos_maps.any()


@pytest.mark.parametrize("size", [(40, 52), (33, 17)])
def test_compose_and_resize_identical_to_jax_package(size):
    rng = np.random.default_rng(6)
    cos = rng.uniform(-1, 1, (4, 4, 4))
    bg = rng.random((4, 4))
    p2c = np.array([3, 22, 7, 24], np.int32)
    np.testing.assert_array_equal(tps.np_bilinear_resize(cos, size),
                                  jps.np_bilinear_resize(cos, size))
    for native in (False, True):
        got = tps.compose_pseudo_seg(p2c, cos, bg, size,
                                     tcfgs.PseudoSegConfig(),
                                     allow_native=native)
        want = jps.compose_pseudo_seg(p2c, cos, bg, size,
                                      jcfgs.PseudoSegConfig(),
                                      allow_native=native)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    big = tps.compose_pseudo_seg(p2c + 400, np.ones_like(cos),
                                 np.ones_like(bg), size,
                                 tcfgs.PseudoSegConfig(), allow_native=False)
    assert big.dtype == np.int64            # no uint8 wrap of large ids


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_pseudo_seg_batch_identical_to_jax_package(dtype):
    """The whole batch pipeline: uint8-identical maps from the same device
    outputs (float32 and bf16: the JAX side is fed the port's outputs, so
    what is compared is everything after the forward)."""
    _, jcfg, tout, tcfg = _outputs()
    tout = tvit.ViTCAMOutput(*[t.to(dtype) if t is not None
                               and t.is_floating_point() else t
                               for t in tout])
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}[dtype]
    jout = jvit.ViTCAMOutput(**{
        k: None if v is None else jnp.asarray(
            v.to(torch.float64).numpy(), jdt if v.is_floating_point()
            else jnp.int32)
        for k, v in tout._asdict().items()})
    sizes = [(40, 52), (33, 17), (32, 32)]
    got = tps.pseudo_seg_batch(tout, tcfg, tcfgs.PseudoSegConfig(), sizes)
    want = jps.pseudo_seg_batch(jout, jcfg, jcfgs.PseudoSegConfig(), sizes)
    for g, w, size in zip(got, want, sizes):
        assert g.shape == size and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_pseudo_seg_config_mirrors_jax():
    import dataclasses
    j, t = jcfgs.PseudoSegConfig(), tcfgs.PseudoSegConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_bg_rollout_row_matches_jax():
    rows = np.random.default_rng(7).random((7, 3, 17))
    rows /= rows.sum(-1, keepdims=True)
    got = troll.bg_rollout_row(torch.from_numpy(rows), 5).numpy()
    want = np.asarray(jroll.bg_rollout_row(jnp.asarray(rows), 5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="from_block"):
        troll.bg_rollout_row(torch.from_numpy(rows), 7)
    with pytest.raises(ValueError, match="square"):
        troll.bg_rollout_row(torch.from_numpy(rows), 5, prefix_tokens=2)


def test_confusion_matrix_and_metrics_match_jax_package():
    rng = np.random.default_rng(8)
    got, want = tmetrics.ConfusionMatrix(20), jmetrics.ConfusionMatrix(20)
    with pytest.raises(ValueError):
        got.compute()
    for _ in range(3):
        a = rng.integers(0, 21, 500)
        a[::17] = 255                         # VOC ignore label
        b = rng.integers(0, 26, 500)          # fillers past the classes
        got.update(a, b)
        want.update(a, b)
    np.testing.assert_array_equal(got.mat, want.mat)
    for g, w in zip(got.compute(), want.compute()):
        np.testing.assert_array_equal(g, w)
    assert got.get_mIOU() == want.get_mIOU() and str(got) == str(want)
    y = (rng.random((5, 20)) < 0.3).astype(np.float32)
    p = rng.random((5, 20))
    assert tmetrics.compute_mAP(y, p) == jmetrics.compute_mAP(y, p)
    assert tmetrics.f1_multihot(y[0], p[0] > 0.5) == \
        jmetrics.f1_multihot(y[0], p[0] > 0.5)
    np.testing.assert_array_equal(
        tmetrics.topk_multihot(p, y.sum(1), 20),
        jmetrics.topk_multihot(p, y.sum(1), 20))


def test_palette_bytes_match_jax_package(tmp_path):
    np.testing.assert_array_equal(tpal.color_map(), jpal.color_map())
    assert tpal.voc_palette_flat() == jpal.voc_palette_flat()
    labels = np.random.default_rng(9).integers(0, 25, (30, 41)).astype(
        np.uint8)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    tpal.save_indexed_png(a, labels)
    jpal.save_indexed_png(b, labels)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tpal.palette_from_png(a) == jpal.palette_from_png(b)
    tpal.save_indexed_png_batch([a], [labels])
    jpal.save_indexed_png_batch([b], [labels])
    assert open(a, "rb").read() == open(b, "rb").read()
    tpal.save_palette_json(str(tmp_path / "p.json"))
    assert tpal.load_palette_json(str(tmp_path / "p.json")) == \
        jpal.load_palette_json(str(tmp_path / "p.json")) == \
        tpal.voc_palette_flat()
    with pytest.raises(ValueError, match="255"):
        tpal.save_indexed_png(a, np.full((2, 2), 300))


def test_native_loader_answers_false_without_the_library(monkeypatch):
    """Where the library is neither built nor buildable every *_available()
    answers false and nothing raises."""
    builds = []
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_unavailable", False)
    monkeypatch.setattr(tnative, "_build", lambda: builds.append(1) and False)
    monkeypatch.setattr(tnative, "_SO_PATH", "/nonexistent/libvitcam_io.so")
    assert not tnative.available()
    assert not tnative.compose_available()
    assert not tnative.artifacts_available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.decode_batch([b""])
    assert len(builds) == 1        # the failed build is not tried again
    # and the numpy composition runs
    seg = tps.compose_pseudo_seg(np.array([1, 2], np.int32),
                                 np.ones((2, 2, 2)), np.ones((2, 2)), (5, 6),
                                 tcfgs.PseudoSegConfig())
    assert seg.shape == (5, 6)


def test_native_loader_copy_agrees_with_jax_package():
    assert tnative.available() == jnative.available()
    assert tnative.compose_available() == jnative.compose_available()
    assert tnative.artifacts_available() == jnative.artifacts_available()
    assert tnative._SO_PATH == jnative._SO_PATH


def test_render_copy_matches_jax_package(tmp_path):
    import PIL.Image
    rng = np.random.default_rng(10)
    cam = rng.random((4, 4))
    img = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    np.testing.assert_array_equal(trender.cam_norm(cam), jrender.cam_norm(cam))
    np.testing.assert_array_equal(trender.overlay_cam(cam, img),
                                  jrender.overlay_cam(cam, img))
    np.testing.assert_array_equal(trender.jet_lut_rgb(), jrender.jet_lut_rgb())
    src = str(tmp_path / "src.jpg")
    PIL.Image.fromarray(img).save(src)
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    trender.render_rollout_overlays(cam[None], [src], [a])
    jrender.render_rollout_overlays(cam[None], [src], [b])
    assert open(a, "rb").read() == open(b, "rb").read()


def test_sbd_conversion_matches_jax_package(tmp_path):
    from scipy.io import savemat
    rng = np.random.default_rng(11)
    mats = tmp_path / "cls"
    mats.mkdir()
    for name in ("2008_000001", "2008_000002"):
        seg = rng.integers(0, 21, (20, 31)).astype(np.uint8)
        savemat(str(mats / f"{name}.mat"),
                {"GTcls": {"Segmentation": seg, "Boundaries": np.zeros(1),
                           "CategoriesPresent": np.unique(seg)}})
    path = str(mats / "2008_000001.mat")
    np.testing.assert_array_equal(tvoc.read_sbd_segmentation(path),
                                  jvoc.read_sbd_segmentation(path))
    assert tvoc.convert_sbd(str(mats), str(tmp_path / "t")) == \
        jvoc.convert_sbd(str(mats), str(tmp_path / "j")) == 2
    for f in sorted(os.listdir(tmp_path / "j")):
        assert open(tmp_path / "t" / f, "rb").read() == \
            open(tmp_path / "j" / f, "rb").read()
    assert tvoc.convert_sbd(str(mats), str(tmp_path / "t2"),
                            ids=["2008_000002"]) == 1
    savemat(str(mats / "bad.mat"), {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="GTcls"):
        tvoc.read_sbd_segmentation(str(mats / "bad.mat"))
