"""The port's predict CLI against the JAX package's, on the CPU: one faked
image, one weights file for both, the same zoo entry in both packages.

The arrays agree at float64 within 1e-10 (the eager port against JAX "xla",
as tests/test_torch_vit.py pins the forward) and at float32 within 1e-5;
``logits`` only where both load every weight (a .npz: a reference .pth drops
``head.*``, and each package keeps its own random head).  The printed lines
are equal, ``render_grid`` writes the same JPEG bytes from the same arrays,
and at float64 the two CLIs write byte-identical grids.  The test marked
``cuda`` runs on a GPU machine without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_predict.py
"""

import os

import numpy as np
import pytest
import torch

import PIL.Image

from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import predict as tpcli
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax

    from vision_transformer_cam_tpu import configs as jconfigs
    from vision_transformer_cam_tpu.cli import predict as jpcli
    from vision_transformer_cam_tpu.io import weights as jwio
    from vision_transformer_cam_tpu.models import vit as jvit
except ImportError:
    jax = None

NAME = "2007_000032"
ZOO = "tinypred"
ARRAYS = ("per_block_cams", "rollout_cam", "token_sim", "probs_head1")
# float32: the forward differs by float32 rounding in another summation
# order; the cosine similarities of unit-normalized token vectors carry it
# through a sum over C, so token_sim gets a tolerance of its own
TOL = {"float64": dict(cam=1e-10, sim=1e-10, logits=1e-10),
       "float32": dict(cam=1e-5, sim=1e-5, logits=1e-5)}


def _factory(pkg, dtype):
    def factory(num_classes=20, has_logits=False):
        kw = {}
        if dtype == "float64":
            kw = (dict(dtype=torch.float64, param_dtype=torch.float64)
                  if pkg is configs else
                  dict(dtype=jax.numpy.float64, param_dtype=jax.numpy.float64))
        return pkg.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                depth=4, num_heads=4,
                                num_classes=num_classes, mask_from=1,
                                top_k_patches=4, **kw)
    return factory


@pytest.fixture()
def tree(tmp_path):
    """One faked VOC image with its annotation."""
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "Annotations"):
        (tmp_path / d).mkdir()
    arr = rng.integers(0, 256, size=(41, 53, 3), dtype=np.uint8)
    PIL.Image.fromarray(arr).save(tmp_path / "JPEGImages" / f"{NAME}.jpg")
    (tmp_path / "Annotations" / f"{NAME}.xml").write_text(
        "<annotation><object><name>dog</name></object>"
        "<object><name>cat</name></object></annotation>")
    return tmp_path


def _weights(tmp_path, dtype):
    """A JAX ``vit.init`` tree with the qkv gain of the validate fixtures
    (10: the mask engages on some patches), as .npz and as .pth."""
    jcfg = _factory(jconfigs, dtype)()
    params = jvit.init(jcfg, jax.random.key(0))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 10.0
    npz, pth = str(tmp_path / "w.npz"), str(tmp_path / "w.pth")
    jwio.save_npz(npz, params)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jwio.state_dict_from_pytree(params, jcfg).items()}, pth)
    return {"npz": npz, "pth": pth}


def _zoos(monkeypatch, dtype):
    monkeypatch.setitem(configs.MODEL_ZOO, ZOO, _factory(configs, dtype))
    monkeypatch.setitem(jconfigs.MODEL_ZOO, ZOO, _factory(jconfigs, dtype))


def _argv(tree, weights, out, *extra):
    return ["--model_name", ZOO, "--img_name", NAME, "--dataset_path",
            str(tree), "--weights", weights, "--out", str(out), *extra]


def _run(cli, argv, capsys):
    arts = cli.main(argv)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith(("GT labels:", "pred:"))]
    return arts, lines


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("container", ["npz", "pth"])
def test_predict_cli_matches_jax_cli(tree, tmp_path, monkeypatch, capsys,
                                     dtype, container):
    _zoos(monkeypatch, dtype)
    weights = _weights(tmp_path, dtype)[container]
    want, jlines = _run(jpcli, _argv(tree, weights, tmp_path / "j"), capsys)
    got, tlines = _run(tpcli, _argv(tree, weights, tmp_path / "t", "--device",
                                    "cpu"), capsys)
    tol = TOL[dtype]
    assert set(got) == set(want)
    for name in ARRAYS + ("logits",):
        if name == "logits" and container == "pth":
            continue        # each package keeps its own random head
        assert got[name].shape == np.asarray(want[name]).shape, name
        atol = tol["sim"] if name == "token_sim" else (
            tol["logits"] if name == "logits" else tol["cam"])
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)
    assert got["per_block_cams"].shape == (4, 4, 4)
    assert (got["per_block_cams"] < 1).any()        # not all flat
    assert tlines == jlines and len(tlines) == 2
    assert tlines[0] == "GT labels: cat dog"
    grid = f"{NAME}_cam_grid.jpg"
    tbytes = (tmp_path / "t" / grid).read_bytes()
    if dtype == "float64":
        assert tbytes == (tmp_path / "j" / grid).read_bytes()
    # render_grid fed the same arrays writes the same bytes in both packages
    ori = np.asarray(PIL.Image.open(tree / "JPEGImages" / f"{NAME}.jpg")
                     .convert("RGB"))[..., ::-1]
    for cli, sub in ((jpcli, "rj"), (tpcli, "rt")):
        os.makedirs(tmp_path / sub)
        cli.render_grid(got, ori, tlines[0], tlines[1][len("pred: "):],
                        str(tmp_path / sub / grid))
    assert (tmp_path / "rt" / grid).read_bytes() == \
        (tmp_path / "rj" / grid).read_bytes()


def test_predict_image_on_the_kernel_path_equals_eager_on_the_cpu(tree,
                                                                 tmp_path):
    """attn_impl="kernel" on CPU tensors runs the kernel's plain version:
    the arrays agree with the eager path's (float32)."""
    cfg = _factory(configs, "float32")().replace(per_sample_mask_norm=True)
    x = np.random.default_rng(1).standard_normal((32, 32, 3)).astype(
        np.float32)
    ori = np.zeros((41, 53, 3), np.uint8)
    model = ViTCAM(cfg, device="cpu")
    eager = tpcli.predict_image(model, x, ori)
    model.cfg = cfg.replace(attn_impl="kernel")
    kernel = tpcli.predict_image(model, x, ori)
    for name in ARRAYS + ("logits",):
        np.testing.assert_allclose(kernel[name], eager[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_predict_cli_no_figure_and_image_path(tree, tmp_path, monkeypatch,
                                              capsys):
    """--no_figure writes no grid; a path as --img_name is read as is, and
    an image without annotation prints '(unknown)'."""
    _zoos(monkeypatch, "float32")
    img = tmp_path / "loose.png"
    PIL.Image.open(tree / "JPEGImages" / f"{NAME}.jpg").save(img)
    arts, lines = _run(tpcli, ["--model_name", ZOO, "--img_name", str(img),
                               "--dataset_path", str(tree), "--out",
                               str(tmp_path / "o"), "--no_figure",
                               "--device", "cpu"], capsys)
    assert lines[0] == "GT labels: (unknown)"
    assert os.listdir(tmp_path / "o") == []
    assert arts["rollout_cam"].shape == (4, 4)


def test_predict_cli_runs_on_the_card_by_default(tree, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a machine with a card runs the CLI there")
    _zoos(monkeypatch, "float32")
    with pytest.raises(RuntimeError, match="cuda"):
        tpcli.main(["--model_name", ZOO, "--img_name", NAME, "--dataset_path",
                    str(tree), "--out", str(tmp_path / "o")])


def test_predict_cli_has_the_jax_cli_surface():
    def surface(parser):
        return {a.dest: (a.default, a.type, a.required)
                for a in parser._actions if a.dest != "help"}
    got, want = surface(tpcli.build_parser()), surface(jpcli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][0] == "cuda"
    actions = {a.dest: a for a in tpcli.build_parser()._actions}
    assert actions["attn_impl"].choices == ["auto", "eager", "kernel"]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_predict_kernel_path_on_the_card_matches_eager(tree, tmp_path,
                                                       monkeypatch, capsys):
    """On the card at head width 64: the kernel path launches the attention
    kernel once a layer, and its arrays agree with the eager path's within
    the float32 kernel-vs-eager gates."""
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def factory(num_classes=20, has_logits=False):
        return configs.ViTCAMConfig(img_size=64, patch_size=8, embed_dim=128,
                                    depth=4, num_heads=2,
                                    num_classes=num_classes, mask_from=1,
                                    top_k_patches=4)
    monkeypatch.setitem(configs.MODEL_ZOO, ZOO, factory)
    argv = ["--model_name", ZOO, "--img_name", NAME, "--dataset_path",
            str(tree), "--out", str(tmp_path / "o"), "--no_figure"]
    ka.launches = 0
    kernel = tpcli.main(argv + ["--attn_impl", "kernel"])
    assert ka.launches == 4
    eager = tpcli.main(argv + ["--attn_impl", "eager"])
    assert ka.launches == 4
    for name, atol in (("per_block_cams", 1e-5), ("rollout_cam", 1e-5),
                       ("probs_head1", 2e-4), ("token_sim", 1e-4)):
        np.testing.assert_allclose(kernel[name], eager[name], rtol=0,
                                   atol=atol, err_msg=name)
