"""The port's data copies, fit, train CLI and validate CLI on a synthetic VOC
tree with a tiny model, on the CPU (``--device cpu`` / ``device="cpu"``).
The fixtures follow tests/test_cli.py's."""

import os

import numpy as np
import pytest
import torch

import PIL.Image

from vision_transformer_cam_tpu import configs as jconfigs
from vision_transformer_cam_tpu.cli import train as jcli
from vision_transformer_cam_tpu.cli import validate as jvcli
from vision_transformer_cam_tpu.data import loader as jloader
from vision_transformer_cam_tpu.data import voc12 as jvoc
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import train as tcli
from vision_transformer_cam_tpu_torch.cli import validate as tvcli
from vision_transformer_cam_tpu_torch.data import loader as tloader
from vision_transformer_cam_tpu_torch.data import voc12 as tvoc
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import loop as tloop

NAMES = ["2007_000032", "2007_000123", "2008_000006", "2008_000045"]


def _tiny_factory(num_classes=20, has_logits=False):
    return configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                depth=3, num_heads=4,
                                num_classes=num_classes, mask_from=1,
                                top_k_patches=4)


@pytest.fixture()
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(configs.MODEL_ZOO, "tiny", _tiny_factory)
    return "tiny"


@pytest.fixture()
def voc_tree(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "SegmentationClass").mkdir()
    (tmp_path / "Annotations").mkdir()
    cats = ["dog", "cat", "person", "car"]
    for i, n in enumerate(NAMES):
        arr = rng.integers(0, 256, size=(40 + 3 * i, 52 - 2 * i, 3),
                           dtype=np.uint8)
        PIL.Image.fromarray(arr).save(tmp_path / "JPEGImages" / f"{n}.jpg")
        seg = rng.integers(0, 21, size=arr.shape[:2]).astype(np.uint8)
        PIL.Image.fromarray(seg, mode="P").save(
            tmp_path / "SegmentationClass" / f"{n}.png")
        (tmp_path / "Annotations" / f"{n}.xml").write_text(
            "<annotation>" + "".join(
                f"<object><name>{c}</name></object>"
                for c in (cats[i], cats[(i + 1) % 4])) + "</annotation>")
    split = "\n".join(f"/JPEGImages/{n}.jpg /SegmentationClass/{n}.png"
                      for n in NAMES)
    (tmp_path / "split.txt").write_text(split + "\n")
    return tmp_path


def _cli_args(voc_tree, zoo, *extra):
    split = str(voc_tree / "split.txt")
    return ["--model_name", zoo, "--dataset_path", str(voc_tree),
            "--train_img_name_path", split, "--val_img_name_path", split,
            "--batch_size", "2", "--epochs", "2", "--warmup_epochs", "1",
            "--ckpt_dir", str(voc_tree / "weights"),
            "--log_dir", str(voc_tree), *extra]


@pytest.mark.parametrize("seg", [False, True])
def test_dataset_copy_matches_jax_package(voc_tree, seg):
    split = str(voc_tree / "split.txt")
    kw = dict(seg_label_flag=seg, img_size=32)
    got = tvoc.VOC12Dataset(split, str(voc_tree), **kw)
    want = jvoc.VOC12Dataset(split, str(voc_tree), **kw)
    assert len(got) == len(want) == 4
    assert tvoc.CAT_LIST == jvoc.CAT_LIST
    for i in range(4):
        a, b = got[i], want[i]
        assert set(a) == set(b) and a["name"] == b["name"] == NAMES[i]
        for k in set(a) - {"name"}:
            np.testing.assert_array_equal(a[k], b[k])
        assert got.image_path(i) == want.image_path(i)
    out = str(voc_tree / "cls_labels.npy")
    d = tvoc.make_cls_labels(split, split, str(voc_tree), out)
    assert set(d) == set(NAMES)
    cached = tvoc.VOC12Dataset(split, str(voc_tree), cls_labels_path=out)
    np.testing.assert_array_equal(cached.meta(1)["label"], got.meta(1)["label"])


@pytest.mark.parametrize("procs", [1, 3])
def test_loader_copy_matches_jax_package(voc_tree, procs):
    """Same batches and shuffling as the JAX package's loader.  Over several
    processes each takes its rows of every batch of the JAX loader at the
    global batch (the port's ranks stand for the devices of JAX's one-host
    data mesh, which split each global batch), a partial last batch padded
    with its own last sample and marked is_pad."""
    split = str(voc_tree / "split.txt")
    ds = tvoc.VOC12Dataset(split, str(voc_tree), img_size=32)
    kw = dict(shuffle=True, drop_last=False, seed=3, num_threads=2)
    want = jloader.BatchLoader(ds, 2 * procs, **kw)
    want.set_epoch(1)
    want = list(want)
    ranks = []
    for index in range(procs):
        got = tloader.BatchLoader(ds, 2, process_index=index,
                                  process_count=procs, **kw)
        got.set_epoch(1)
        assert len(got) == len(want)
        ranks.append(list(got))
    for b, w in enumerate(want):
        parts = [r[b] for r in ranks]
        assert all(("is_pad" in p) == (procs > 1) for p in parts)
        names = [n for p in parts for n in p["name"]]
        pad = np.concatenate([p["is_pad"] for p in parts]) if procs > 1 \
            else np.zeros(len(names), bool)
        assert [n for n, x in zip(names, pad) if not x] == w["name"]
        assert all(n == w["name"][-1] for n, x in zip(names, pad) if x)
        for k in set(w) - {"name"}:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts])[~pad], w[k])


def test_device_prefetch_moves_image_and_label(voc_tree):
    ds = tvoc.VOC12Dataset(str(voc_tree / "split.txt"), str(voc_tree),
                           img_size=32)
    loader = tloader.BatchLoader(ds, 3, shuffle=False, drop_last=False)
    batches = list(tloader.device_prefetch(loader, "cpu"))
    assert [b["image"].shape[0] for b in batches] == [3, 1]
    assert all(isinstance(b[k], torch.Tensor) and b[k].dtype == torch.float32
               for b in batches for k in ("image", "label"))
    assert batches[0]["name"] == NAMES[:3]
    # native_decode: the C++ pipeline where the library builds, PIL where
    # not; the same batches as the JAX package's loader either way
    got = list(tloader.BatchLoader(ds, 2, shuffle=False, native_decode=True))
    want = list(jloader.BatchLoader(ds, 2, shuffle=False, native_decode=True))
    for a, b in zip(got, want, strict=True):
        assert a["name"] == b["name"]
        np.testing.assert_array_equal(a["image"], b["image"])


def test_fit_one_epoch_then_resume(voc_tree, tmp_path):
    split = str(voc_tree / "split.txt")
    data = configs.DataConfig(voc12_root=str(voc_tree),
                              img_name_list_path=split, img_size=32)
    ckpt_dir = str(tmp_path / "ckpt")
    train_cfg = configs.TrainConfig(
        optim=configs.OptimConfig(epochs=3, warmup_epochs=1), batch_size=2,
        ckpt_dir=ckpt_dir, log_every=1)
    state = tloop.fit(_tiny_factory(), train_cfg, data, data, epochs=1,
                      log_dir=str(tmp_path), device="cpu")
    assert state.step == state.optimizer.count == 2      # 4 images / batch 2
    tags = sorted(f for f in os.listdir(ckpt_dir))
    assert len(tags) == 2 and tags[0].endswith("-cur_ep0-bestloss.pt") \
        and tags[1].endswith("-cur_ep0-final.pt")
    logs = [f for f in os.listdir(tmp_path) if f.startswith("train_log_")]
    assert len(logs) == 1
    line = (tmp_path / logs[0]).read_text()
    assert line.startswith("[epoch 0] loss ") and "mAP_196" in line \
        and "lr " in line
    assert next(state.model.parameters()).device.type == "cpu"

    resumed = tloop.fit(_tiny_factory(), train_cfg, data, data, epochs=1,
                        log_dir=str(tmp_path), resume=True, device="cpu")
    assert resumed.step == 4
    assert tckpt.latest_tag(ckpt_dir).endswith("-final")


def test_train_cli_two_epochs_on_cpu(voc_tree, tiny_zoo, monkeypatch):
    monkeypatch.chdir(voc_tree)
    state = tcli.main(_cli_args(voc_tree, tiny_zoo, "--device", "cpu",
                                "--freeze_layers", "--clip_grad", "1.0",
                                "--grad_accum", "2"))
    assert state.step == 4
    assert not any(state.optimizer.trains[i]
                   for i, n in enumerate(state.optimizer.names)
                   if n.startswith("blocks."))
    final = [f for f in os.listdir(voc_tree / "weights")
             if f.endswith("-cur_ep1-final.pt")]
    assert len(final) == 1
    # fine-tune again from that checkpoint's weights
    again = tcli.main(_cli_args(
        voc_tree, tiny_zoo, "--device", "cpu", "--weights",
        str(voc_tree / "weights" / final[0])))
    assert again.step == 4


def test_train_cli_runs_on_the_card_by_default(voc_tree, tiny_zoo):
    if torch.cuda.is_available():
        pytest.skip("a machine with a card runs the CLI there")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(_cli_args(voc_tree, tiny_zoo))


@pytest.mark.parametrize("flags,shape,axes,err", [
    (("--mesh_shape", "1,2"), (1, 2), ("data", "model"), "needs 2 rank"),
    (("--pipeline", "2"), (-1, 2), ("data", "stage"), "does not divide"),
    (("--seq_parallel", "2"), (-1, 2), ("data", "seq"), "needs 2 rank"),
    (("--mesh_shape", "2,1"), (2, 1), ("data", "model"), "needs 2 rank"),
    (("--mesh_shape", "2,2"), (2, 2), ("data", "model"), "needs 4 rank"),
    (("--pp_microbatches", "2"), (-1,), ("data",), None)])
def test_train_cli_refuses_unported_options(voc_tree, tiny_zoo, flags,
                                            shape, axes, err, monkeypatch):
    """Tensor parallelism (``--mesh_shape d,m``), the pipeline
    (``--pipeline S``, which also sets the per-sample mask norm) and
    sequence parallelism (``--seq_parallel N``, which sets the seq and data
    axes of the config) build the JAX CLI's meshes, which one process
    refuses where they need more ranks, as ``--mesh_shape 2`` does;
    ``--pp_microbatches`` without ``--pipeline`` is taken and unused, as in
    JAX.  The multi-rank runs: tests/test_torch_data_parallel_cli.py and
    tests/test_torch_seq_train.py."""
    argv = _cli_args(voc_tree, tiny_zoo, "--device", "cpu", *flags)
    seen, fit = {}, tcli.looplib.fit
    monkeypatch.setattr(tcli.looplib, "fit",
                        lambda m, t, *a, **k: seen.update(model=m, train=t))
    tcli.main(argv)
    monkeypatch.setattr(tcli.looplib, "fit", fit)
    train = seen["train"]
    assert (tuple(train.mesh_shape), tuple(train.mesh_axes)) == (shape, axes)
    assert seen["model"].per_sample_mask_norm == ("--pipeline" in flags)
    seq = "--seq_parallel" in flags
    assert (seen["model"].seq_axis, seen["model"].data_axis) == \
        (("seq", "data") if seq else (None, None))
    tcli.looplib.check_supported(train)
    if err:
        with pytest.raises(ValueError, match=err):
            tcli.main(argv)


def test_train_cli_has_the_jax_cli_surface():
    def surface(parser):
        return {a.dest: (a.default, a.type, a.required)
                for a in parser._actions if a.dest != "help"}
    got, want = surface(tcli.build_parser()), surface(jcli.build_parser())
    assert set(got) == set(want)
    for dest, spec in want.items():
        if dest != "device":        # honoured here: the card by default
            assert got[dest] == spec, dest
    assert got["device"][0] == "cuda"


# ---------------------------------------------------------------------------
# the validate / pseudo-seg entry point
# ---------------------------------------------------------------------------

def _val_factory(kind):
    def factory(num_classes=20, has_logits=False):
        cfgs = jconfigs if kind == "jax" else configs
        return cfgs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                 depth=7, num_heads=4,
                                 num_classes=num_classes, mask_from=2,
                                 top_k_patches=4)
    return factory


@pytest.fixture()
def val_zoo(monkeypatch, tmp_path):
    """A tiny model in both zoos and one weights file for both CLIs, made
    from a JAX ``vit.init`` tree (their random initialisations differ), with
    a qkv gain that makes the mask engage on some patches (a larger one
    masks all but a few, and the top-K patches then tie at float32
    underflow, where any order is right) and a head1 bias that puts some
    classes past the pseudo-seg gate."""
    import jax
    monkeypatch.setitem(configs.MODEL_ZOO, "tinyval", _val_factory("torch"))
    monkeypatch.setitem(jconfigs.MODEL_ZOO, "tinyval", _val_factory("jax"))
    jcfg = _val_factory("jax")()
    params = jvit.init(jcfg, jax.random.key(0))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 10.0
    bias = np.full((20,), -3.0, np.float32)
    bias[[7, 11, 14]] = 4.0
    params["head1"]["bias"] = jax.numpy.asarray(bias)
    path = str(tmp_path / "tinyval.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jwio.state_dict_from_pytree(params, jcfg).items()}, path)
    return "tinyval", path


def _val_args(voc_tree, zoo, weights, seg_dir, *extra):
    return ["--model_name", zoo, "--weights", weights,
            "--dataset_path", str(voc_tree),
            "--val_img_name_path", str(voc_tree / "split.txt"),
            "--batch_size", "3", "--seg_pred_dir", str(seg_dir), *extra]


def _png_bytes(seg_dir):
    return {n: open(os.path.join(seg_dir, f"{n}.png"), "rb").read()
            for n in NAMES}


@pytest.mark.parametrize("extra", [(), ("--batch_global_mask_norm",)],
                         ids=["per_sample", "batch_global"])
def test_validate_cli_matches_jax_cli(voc_tree, tmp_path, val_zoo,
                                      monkeypatch, extra):
    """Byte-identical pseudo-seg PNGs and equal mAP / mIoU from both CLIs on
    the same tree and weights (float32, eager / XLA attention)."""
    monkeypatch.chdir(tmp_path)
    zoo, weights = val_zoo
    want = jvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "j",
                                *extra))
    got = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t",
                               "--device", "cpu", *extra))
    assert _png_bytes(tmp_path / "t") == _png_bytes(tmp_path / "j")
    segs = [np.asarray(PIL.Image.open(tmp_path / "t" / f"{n}.png"))
            for n in NAMES]
    assert any((s > 0).any() for s in segs)        # not all background
    assert got["n_images"] == want["n_images"] == 4
    for key in ("mAP", "mIoU", "global_acc"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    logs = [f for f in os.listdir(tmp_path) if f.startswith("validating_log")]
    assert logs


def test_validate_cli_seq_parallel_one_rank_equals_without(voc_tree, tmp_path,
                                                           val_zoo,
                                                           monkeypatch,
                                                           capsys):
    monkeypatch.chdir(tmp_path)
    zoo, weights = val_zoo
    base = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "a",
                                "--device", "cpu", "--attn_impl", "kernel"))
    sp = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "b",
                              "--device", "cpu", "--attn_impl", "kernel",
                              "--seq_parallel", "1"))
    assert "sequence parallelism: mesh {'data': 1, 'seq': 1}" in \
        capsys.readouterr().out
    assert _png_bytes(tmp_path / "a") == _png_bytes(tmp_path / "b")
    for key in ("mAP", "mIoU", "global_acc", "n_images"):
        assert sp[key] == base[key], key
    # and the JAX CLI with --seq_parallel on its 8-device mesh agrees (its
    # XLA path: see tests/test_torch_seq.py on its kernel path at N = 17)
    want = jvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "j",
                                "--seq_parallel", "4", "--batch_size", "2"))
    assert _png_bytes(tmp_path / "j") == _png_bytes(tmp_path / "a")
    assert sp["mIoU"] == pytest.approx(want["mIoU"], abs=1e-9)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_validate_cli_serving_modes(voc_tree, tmp_path, val_zoo, monkeypatch,
                                    mode):
    """--serving on the CPU: both CLIs resolve the attention path by device
    (eager / XLA here), cast to bf16, calibrate int8 on the split's first
    images; the PNGs are written and the segmentation scores agree within
    bf16 noise (the mAP of four images ranks twenty near-equal random-weight
    logits, which bf16 reorders: it is only held to its range)."""
    monkeypatch.chdir(tmp_path)
    zoo, weights = val_zoo
    want = jvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "j",
                                "--serving", mode))
    got = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t",
                               "--device", "cpu", "--serving", mode,
                               "--seq_parallel", "1"))
    assert set(_png_bytes(tmp_path / "t")) == set(NAMES)
    assert got["n_images"] == 4
    assert 0.0 <= got["mAP"] <= 1.0 and 0.0 <= want["mAP"] <= 1.0
    assert got["mIoU"] == pytest.approx(want["mIoU"], abs=2.0)
    assert got["global_acc"] == pytest.approx(want["global_acc"], abs=0.05)


def test_validate_cli_exports_rollout_cams(voc_tree, tmp_path, val_zoo,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    zoo, weights = val_zoo
    cams = tmp_path / "cams"
    tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t", "--device",
                         "cpu", "--ori_cam_path", str(cams), "--limit", "3"))
    assert sorted(os.listdir(cams)) == [f"{n}_rollout_cam.jpg"
                                        for n in NAMES[:3]]
    for f in os.listdir(cams):
        assert PIL.Image.open(cams / f).size[0] > 0


def test_validate_cli_native_decode_and_palette_json(voc_tree, tmp_path,
                                                     val_zoo, monkeypatch):
    monkeypatch.chdir(tmp_path)
    zoo, weights = val_zoo
    from vision_transformer_cam_tpu_torch.data.palette import (
        save_palette_json)
    save_palette_json(str(tmp_path / "palette.json"))
    res = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t",
                               "--device", "cpu", "--native_decode",
                               "--palette_json",
                               str(tmp_path / "palette.json")))
    assert res["n_images"] == 4 and np.isfinite(res["mIoU"])
    im = PIL.Image.open(tmp_path / "t" / f"{NAMES[0]}.png")
    assert im.getpalette()[:6] == [0, 0, 0, 128, 0, 0]


def test_validate_cli_device_and_unported_options(voc_tree, tmp_path,
                                                  val_zoo, monkeypatch):
    zoo, weights = val_zoo
    # --data_parallel on one process: the one-rank data mesh, the same run
    monkeypatch.chdir(tmp_path)
    dp = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "d",
                              "--device", "cpu", "--data_parallel"))
    one = tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "o",
                               "--device", "cpu"))
    assert {k: dp[k] for k in ("mAP", "mIoU", "n_images")} == \
        {k: one[k] for k in ("mAP", "mIoU", "n_images")}
    assert _png_bytes(tmp_path / "d") == _png_bytes(tmp_path / "o")
    with pytest.raises(ValueError, match="does not divide"):
        tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t",
                             "--device", "cpu", "--seq_parallel", "2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tvcli.main(_val_args(voc_tree, zoo, weights, tmp_path / "t"))


def test_validate_cli_has_the_jax_cli_surface():
    def surface(parser):
        return {a.dest: (a.default, a.type, a.required)
                for a in parser._actions if a.dest != "help"}
    got, want = surface(tvcli.build_parser()), surface(jvcli.build_parser())
    assert set(got) == set(want)
    for dest, spec in want.items():
        if dest != "device":        # honoured here: the card by default
            assert got[dest] == spec, dest
    assert got["device"][0] == "cuda"
    actions = {a.dest: a for a in tvcli.build_parser()._actions}
    assert actions["attn_impl"].choices == ["auto", "eager", "kernel"]
    # the help says what the code does: the kernel path is kept
    assert "kernel" in actions["seq_parallel"].help
    assert "overridden" not in actions["seq_parallel"].help
