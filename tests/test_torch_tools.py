"""The port's offline tools CLI and its weights I/O against the JAX
package's, on the CPU: the same inputs give the same files from both CLIs,
and float weights cross between the packages bit for bit both ways
(``io.weights``: ``save_npz`` / ``load_npz`` / ``load_weights`` /
``jax_params_from_state_dict``)."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import PIL.Image

import jax

from vision_transformer_cam_tpu import configs as jconfigs
from vision_transformer_cam_tpu.cli import tools as jtools
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import tools as ttools
from vision_transformer_cam_tpu_torch.io import weights as twio
from vision_transformer_cam_tpu_torch.models.vit import ViTCAM

NAMES = ["2007_000032", "2007_000123", "2008_000006", "2008_000045"]
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)


def _both(tmp_path, argv_of):
    """Run one subcommand through both CLIs; argv_of(out_dir) -> argv."""
    for cli, sub in ((jtools, "j"), (ttools, "t")):
        os.makedirs(tmp_path / sub, exist_ok=True)
        cli.main(argv_of(tmp_path / sub))
    return tmp_path / "j", tmp_path / "t"


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.fixture()
def voc_tree(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "voc"
    for d in ("JPEGImages", "SegmentationClass", "Annotations"):
        (root / d).mkdir(parents=True)
    cats = ["dog", "cat", "person", "car"]
    for i, n in enumerate(NAMES):
        seg = rng.integers(0, 21, size=(30, 40)).astype(np.uint8)
        PIL.Image.fromarray(seg, mode="P").save(
            root / "SegmentationClass" / f"{n}.png")
        (root / "Annotations" / f"{n}.xml").write_text(
            "<annotation>" + "".join(
                f"<object><name>{c}</name></object>"
                for c in (cats[i], cats[(i + 1) % 4])) + "</annotation>")
    (root / "train.txt").write_text("".join(
        f"/JPEGImages/{n}.jpg /SegmentationClass/{n}.png\n"
        for n in NAMES[:3]))
    (root / "val.txt").write_text(
        f"/JPEGImages/{NAMES[3]}.jpg /SegmentationClass/{NAMES[3]}.png\n")
    return root


def test_make_cls_labels_equal_arrays(voc_tree, tmp_path):
    j, t = _both(tmp_path, lambda out: [
        "make_cls_labels", "--train_list", str(voc_tree / "train.txt"),
        "--val_list", str(voc_tree / "val.txt"), "--voc12_root",
        str(voc_tree), "--out", str(out / "cls_labels.npy")])
    want = np.load(j / "cls_labels.npy", allow_pickle=True).item()
    got = np.load(t / "cls_labels.npy", allow_pickle=True).item()
    assert list(got) == list(want) == NAMES
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("aug", ["none", "dir", "list"])
def test_make_splits_byte_identical(tmp_path, aug):
    root = tmp_path / "voc"
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "ImageSets" / "Segmentation" / "train.txt").write_text(
        "2007_000001\n2007_000002\n")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(
        "2007_000003\n")
    extra = []
    if aug == "dir":
        (root / "SegmentationClassAug").mkdir()
        for i in ("2007_000001", "2007_000002", "2008_000009"):
            (root / "SegmentationClassAug" / f"{i}.png").write_bytes(b"")
    elif aug == "list":
        lst = tmp_path / "sbd.txt"
        lst.write_text("2007_000002\n2008_000123\n/JPEGImages/2008_000456.jpg"
                       " /SegmentationClassAug/2008_000456.png\n")
        extra = ["--aug_list", str(lst)]
    j, t = _both(tmp_path, lambda out: [
        "make_splits", "--voc12_root", str(root), "--out_dir",
        str(out / "splits"), *extra])
    _same_files(j / "splits", t / "splits")
    assert len(os.listdir(t / "splits")) == (2 if aug == "none" else 4)


@pytest.mark.parametrize("sub", ["make_class_indices", "palette_builtin",
                                 "palette_png"])
def test_json_tools_byte_identical(voc_tree, tmp_path, sub):
    png = str(voc_tree / "SegmentationClass" / f"{NAMES[0]}.png")
    argv = {"make_class_indices": lambda out: [
                "make_class_indices", "--out", str(out / "f.json")],
            "palette_builtin": lambda out: [
                "get_palette", "--out", str(out / "f.json")],
            "palette_png": lambda out: [
                "get_palette", "--png", png, "--out", str(out / "f.json")]}
    j, t = _both(tmp_path, argv[sub])
    assert (t / "f.json").read_bytes() == (j / "f.json").read_bytes()
    assert json.loads((t / "f.json").read_text())


def test_convert_sbd_byte_identical(tmp_path):
    """Synthesized SBD .mat files (the GTcls struct scipy.io.savemat
    round-trips) -> the same VOC-palette PNGs, all of them and a listed
    subset."""
    pytest.importorskip("scipy.io")
    from scipy.io import savemat
    mat_dir = tmp_path / "cls"
    mat_dir.mkdir()
    r = np.random.RandomState(0)
    for name in ("2008_000123", "2008_000456", "2009_000001"):
        seg = r.randint(0, 21, size=(37, 45)).astype(np.uint8)
        savemat(str(mat_dir / f"{name}.mat"),
                {"GTcls": {"Segmentation": seg,
                           "CategoriesPresent": np.unique(seg)[None]}})
    j, t = _both(tmp_path, lambda out: [
        "convert_sbd", "--mat_dir", str(mat_dir), "--voc12_root", str(out)])
    _same_files(j / "SegmentationClassAug", t / "SegmentationClassAug")
    assert len(os.listdir(t / "SegmentationClassAug")) == 3
    lst = tmp_path / "ids.txt"
    lst.write_text("2008_000123\n")
    j, t = _both(tmp_path, lambda out: [
        "convert_sbd", "--mat_dir", str(mat_dir), "--out_dir",
        str(out / "only"), "--id_list", str(lst)])
    _same_files(j / "only", t / "only")
    with pytest.raises(SystemExit):
        ttools.main(["convert_sbd", "--mat_dir", str(mat_dir)])


def test_flops_same_lines_and_dicts(capsys):
    for argv in ([], ["--dim", "768", "--num_heads", "12", "--seq_len", "197",
                      "--batch", "64"]):
        jtools.main(["flops", *argv])
        want = capsys.readouterr().out
        ttools.main(["flops", *argv])
        assert capsys.readouterr().out == want and "GFLOPs" in want
    for shape in ((512, 8, 1024, 32), (768, 12, 197, 64), (1024, 16, 577, 1),
                  (64, 1, 17, 3)):
        assert ttools.attention_flops(*shape) == jtools.attention_flops(*shape)


def test_tools_cli_has_the_jax_cli_surface():
    def surface(parser):
        subs = next(a for a in parser._actions
                    if a.dest == "cmd").choices
        return {name: {a.dest: (a.default, a.type, a.required)
                       for a in sp._actions if a.dest not in ("help", "fn")}
                for name, sp in subs.items()}
    assert surface(ttools.build_parser()) == surface(jtools.build_parser())


# ---------------------------------------------------------------------------
# weights I/O and tools convert
# ---------------------------------------------------------------------------

def _jax_tree(kind, seed=0):
    if kind == "vit_b16":
        jcfg = jconfigs.vit_base_patch16_224_in21k(num_classes=20,
                                                   has_logits=False)
        tcfg = configs.vit_base_patch16_224_in21k(num_classes=20,
                                                  has_logits=False)
    else:
        jcfg = jconfigs.ViTCAMConfig(**TINY, **CFG_KINDS[kind])
        tcfg = configs.ViTCAMConfig(**TINY, **CFG_KINDS[kind])
    return jvit.init(jcfg, jax.random.key(seed)), jcfg, tcfg


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


CFG_KINDS = {"plain": {}, "has_logits": dict(representation_size=48),
             "distilled": dict(distilled=True),
             "no_qkv_bias": dict(qkv_bias=False)}


@pytest.mark.parametrize("kind", list(CFG_KINDS) + ["vit_b16"])
def test_npz_crosses_both_ways_bit_for_bit(tmp_path, kind):
    params, jcfg, tcfg = _jax_tree(kind)
    jnpz = str(tmp_path / "j.npz")
    jwio.save_npz(jnpz, params)
    # JAX .npz -> port: the state dict of the same tree, bit for bit
    model = ViTCAM(tcfg, device="cpu")
    twio.load_weights(jnpz, model)
    want = twio.state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                           tcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # port .npz -> JAX load_npz: the JAX tree, every key, shape and dtype
    tnpz = str(tmp_path / "t.npz")
    twio.save_npz(tnpz, model, tcfg)
    back = _flat(jwio.load_npz(tnpz))
    orig = _flat(params)
    assert list(back) == list(orig)
    for k, v in orig.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # .npz -> model -> .npz: the same archive content, entry by entry
    assert _entries(tnpz) == _entries(jnpz)
    # and the port's own reader gives the numpy tree back
    assert list(_flat(twio.load_npz(tnpz))) == list(orig)
    # a state dict saves like its model
    sd_npz = str(tmp_path / "sd.npz")
    twio.save_npz(sd_npz, model.state_dict(), tcfg)
    assert _entries(sd_npz) == _entries(tnpz)


def test_load_pth_surgery_and_refusals(tmp_path):
    params, jcfg, tcfg = _jax_tree("plain")
    pth = str(tmp_path / "w.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jwio.state_dict_from_pytree(params, jcfg).items()}, pth)
    model = ViTCAM(tcfg, device="cpu")
    head = model.head.weight.detach().clone()
    twio.load_pth(pth, model)         # default: the head keys dropped
    assert torch.equal(model.head.weight, head)
    assert torch.equal(model.head1.weight, torch.from_numpy(
        np.ascontiguousarray(np.asarray(params["head1"]["kernel"]).T)))
    twio.load_weights(pth, model)     # default: nothing dropped
    assert not torch.equal(model.head.weight, head)
    with pytest.raises(ValueError, match="orbax"):
        twio.load_weights(str(tmp_path), model)
    model.cfg = tcfg
    from vision_transformer_cam_tpu_torch.ops.quant import quantize_params
    with pytest.raises(ValueError, match="int8"):
        twio.save_npz(str(tmp_path / "q.npz"),
                      quantize_params(ViTCAM(tcfg, device="cpu")), tcfg)


def _pth_tensors(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_convert_gives_the_jax_clis_files(tmp_path, monkeypatch):
    """JAX .npz -> port .pth equals JAX .npz -> JAX .pth, bit for bit; port
    .pth -> port .npz equals the JAX .npz; a checkpoint of the port's
    trainer converts too."""
    monkeypatch.setitem(configs.MODEL_ZOO, "tinyconv",
                        lambda num_classes=20, has_logits=False:
                        configs.ViTCAMConfig(**TINY))
    monkeypatch.setitem(jconfigs.MODEL_ZOO, "tinyconv",
                        lambda num_classes=20, has_logits=False:
                        jconfigs.ViTCAMConfig(**TINY))
    params, _, tcfg = _jax_tree("plain", seed=3)
    jnpz = str(tmp_path / "src.npz")
    jwio.save_npz(jnpz, params)
    zoo = ["--model_name", "tinyconv"]
    jtools.main(["convert", "--weights", jnpz, "--out",
                 str(tmp_path / "j.pth"), *zoo])
    ttools.main(["convert", "--weights", jnpz, "--out",
                 str(tmp_path / "t.pth"), *zoo])
    want, got = _pth_tensors(tmp_path / "j.pth"), _pth_tensors(
        tmp_path / "t.pth")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    ttools.main(["convert", "--weights", str(tmp_path / "t.pth"), "--out",
                 str(tmp_path / "t.npz"), *zoo])
    jtools.main(["convert", "--weights", jnpz, "--out",
                 str(tmp_path / "j.npz"), *zoo])
    a = _flat(jwio.load_npz(str(tmp_path / "j.npz")))
    b = _flat(jwio.load_npz(str(tmp_path / "t.npz")))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # a checkpoint of the port's trainer: its model entry converts
    from vision_transformer_cam_tpu_torch.train import checkpoint as ckptlib
    from vision_transformer_cam_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    model = ViTCAM(tcfg, device="cpu")
    twio.load_weights(jnpz, model)
    opt, _ = make_optimizer(model, configs.OptimConfig(), 4, 1)
    ckpt = ckptlib.save(str(tmp_path / "ck"), "final",
                        create_train_state(model, opt))
    ttools.main(["convert", "--weights", ckpt, "--out",
                 str(tmp_path / "ck.npz"), *zoo])
    assert _entries(str(tmp_path / "ck.npz")) == _entries(jnpz)
    with pytest.raises(SystemExit):
        ttools.main(["convert", "--weights", jnpz, "--out",
                     str(tmp_path / "x.bin"), *zoo])
