"""The port's CNN-CAM demo against the JAX package's, on the CPU.

Each CNN (ResNet at one block a stage, SqueezeNet 1.1, a tiny DenseNet)
carries the JAX ``init`` weights across (``from_jax``) and matches the JAX
``apply`` at float64 within 1e-10 in logits and features; SqueezeNet at a
66x66 input, where its ceil-mode pools give another grid than floor mode
would.  ``return_cam`` equals the JAX one bit for bit on the same features.
The demo CLI runs every arch on the CPU, with and without ``--labels_json``,
from a seeded init and from a list-layout ``.npz`` (``io.weights.
save_cnn_npz``), which reads back into the in-memory pytree.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import PIL.Image

from vision_transformer_cam_tpu_torch.cli import cnn_cam_demo as tdemo
from vision_transformer_cam_tpu_torch.io import weights as twio
from vision_transformer_cam_tpu_torch.models import (densenet, resnet,
                                                     squeezenet)

try:
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu.models import densenet as jdense
    from vision_transformer_cam_tpu.models import resnet as jres
    from vision_transformer_cam_tpu.models import squeezenet as jsq
except ImportError:
    jax = None

pytestmark = pytest.mark.skipif(jax is None, reason="needs jax")

# arch: (the JAX module, the port's, init kwargs, input side, features grid)
TINY = {
    "resnet18": ("jres", resnet, dict(stages=(1, 1, 1, 1)), 64, 2),
    # 66 -> stem 32 -> pools 16, 8, 4 in ceil mode (15, 7, 3 in floor mode)
    "squeezenet1_1": ("jsq", squeezenet, {}, 66, 4),
    "densenet161": ("jdense", densenet,
                    dict(growth=8, blocks=(2, 2), init_features=16), 64, 8),
}
CLASSES = 7


def _jax_params(arch, dtype):
    jmod = globals()[TINY[arch][0]]
    return jmod, jmod.init(jax.random.key(0), num_classes=CLASSES,
                           dtype=dtype, **TINY[arch][2])


def _images(side, b=2, seed=3):
    return np.random.default_rng(seed).standard_normal((b, side, side, 3))


@pytest.mark.parametrize("arch", sorted(TINY))
def test_cnn_matches_jax_apply_f64(arch):
    jmod, params = _jax_params(arch, jnp.float64)
    side, grid = TINY[arch][3], TINY[arch][4]
    x = _images(side)
    want_logits, want_feats = jmod.apply(params, jnp.asarray(x))
    model = TINY[arch][1].from_jax(params, device="cpu")
    assert next(model.parameters()).dtype == torch.float64
    logits, feats = model(torch.from_numpy(x))
    assert tuple(feats.shape[1:3]) == (grid, grid)
    assert tuple(logits.shape) == (2, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=1e-10)
    np.testing.assert_allclose(feats.detach().numpy(),
                               np.asarray(want_feats), rtol=0, atol=1e-10)
    assert np.abs(np.asarray(want_feats)).max() > 1e-3   # not all zero


def test_squeezenet_pools_in_ceil_mode_at_66():
    """At 66 pixels the stem gives 32 rows, which a ceil-mode pool takes to
    16 and a floor-mode one to 15: the grid above tells the modes apart."""
    y = torch.zeros(1, 1, 32, 32)
    assert F.max_pool2d(y, 3, 2, ceil_mode=True).shape[-1] == 16
    assert F.max_pool2d(y, 3, 2).shape[-1] == 15


@pytest.mark.parametrize("arch", sorted(TINY))
def test_return_cam_matches_jax_bit_for_bit(arch):
    jmod, params = _jax_params(arch, jnp.float64)
    _, feats = jmod.apply(params, jnp.asarray(_images(TINY[arch][3])))
    feats = np.asarray(feats[0])
    model = TINY[arch][1].from_jax(params, device="cpu")
    kernel = TINY[arch][1].cam_weight(model)
    np.testing.assert_array_equal(kernel, np.asarray(jmod.cam_weight(params)))
    ids = [3, 0, 6]
    got = resnet.return_cam(feats, kernel, ids)
    want = jres.return_cam(feats, np.asarray(jmod.cam_weight(params)), ids)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(b).dtype == np.asarray(a).dtype


@pytest.mark.parametrize("arch", sorted(TINY))
def test_cnn_npz_round_trip(arch, tmp_path):
    """save_cnn_npz writes list positions as path parts (stages/1/0/conv1);
    load_cnn_npz rebuilds the lists and equals the in-memory pytree, which
    load_npz (the ViT reader) leaves as dicts."""
    _, params = _jax_params(arch, jnp.float32)
    path = str(tmp_path / "w.npz")
    twio.save_cnn_npz(path, params)
    with np.load(path) as data:
        assert not any(data[k].dtype == object for k in data.files)
    back = twio.load_cnn_npz(path)
    _tree_equal(params, back)
    key = {"resnet18": "stages", "squeezenet1_1": "fires",
           "densenet161": "blocks"}[arch]
    assert isinstance(twio.load_npz(path)[key], dict)
    a = TINY[arch][1].from_jax(back, device="cpu").state_dict()
    b = TINY[arch][1].from_jax(params, device="cpu").state_dict()
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("img") / "2007_000032.jpg")
    rng = np.random.default_rng(9)
    PIL.Image.fromarray(rng.integers(0, 256, (150, 200, 3), dtype=np.uint8)
                        ).save(path)
    return path


@pytest.mark.parametrize("arch", sorted(TINY))
def test_demo_runs_on_the_cpu_at_full_width(arch, image, tmp_path, capsys):
    """The demo at the arch's full width, seeded init, with class names."""
    labels = str(tmp_path / "labels.json")
    with open(labels, "w") as f:
        json.dump([f"class {i}" for i in range(1000)], f)
    out = str(tmp_path / "out")
    res = tdemo.main(["--image", image, "--arch", arch, "--labels_json",
                      labels, "--topk", "3", "--out", out, "--device",
                      "cpu"])
    assert sorted(res) == ["cams", "names", "probs", "top"]
    assert res["probs"].shape == (1000,) and len(res["top"]) == 3
    np.testing.assert_allclose(res["probs"].sum(), 1.0, rtol=1e-5)
    assert res["cams"].dtype == np.uint8 and res["cams"].shape[0] == 3
    assert res["names"][int(res["top"][0])] == f"class {res['top'][0]}"
    printed = capsys.readouterr().out
    assert f"-> class {res['top'][0]}" in printed
    assert sorted(os.listdir(out)) == sorted(
        f"2007_000032_cam_top{r}_cls{int(c)}.jpg"
        for r, c in enumerate(res["top"]))


@pytest.mark.parametrize("arch", sorted(TINY))
def test_demo_reads_a_list_layout_npz(arch, image, tmp_path, capsys):
    """--weights of a tiny instance, no labels: the top classes and their
    probabilities those of the JAX apply on the same preprocessed image (at
    float32, within 1e-5), each CAM within one step of the JAX one."""
    from vision_transformer_cam_tpu_torch.data.transforms import (
        preprocess_array)
    jmod, params = _jax_params(arch, jnp.float32)
    path = str(tmp_path / "w.npz")
    twio.save_cnn_npz(path, params)
    out = str(tmp_path / "out")
    res = tdemo.main(["--image", image, "--arch", arch, "--weights", path,
                      "--out", out, "--device", "cpu"])
    assert res["names"] is None and len(res["top"]) == 5
    assert "top classes:" in capsys.readouterr().out
    assert len(os.listdir(out)) == 5
    x = preprocess_array(np.asarray(PIL.Image.open(image).convert("RGB")),
                         224, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    logits, feats = jmod.apply(params, jnp.asarray(x[None]))
    probs = np.asarray(jax.nn.softmax(logits[0]))
    np.testing.assert_allclose(res["probs"], probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res["top"], np.argsort(-probs)[:5])
    want = jres.return_cam(np.asarray(feats[0]),
                           np.asarray(jmod.cam_weight(params)), res["top"])
    assert np.abs(res["cams"].astype(int) - want.astype(int)).max() <= 1


def test_cnn_modules_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (resnet.ResNet, squeezenet.SqueezeNet, densenet.DenseNet):
        with pytest.raises(RuntimeError, match="is_available"):
            cls(5)
    with pytest.raises(RuntimeError, match="is_available"):
        tdemo.main(["--image", "x.jpg"])
