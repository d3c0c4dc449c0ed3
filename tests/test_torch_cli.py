"""The port's data copies, fit and train CLI on a synthetic VOC tree with a
tiny model, on the CPU (``--device cpu`` / ``device="cpu"``).  The fixtures
follow tests/test_cli.py's."""

import os

import numpy as np
import pytest
import torch

import PIL.Image

from vision_transformer_cam_tpu.cli import train as jcli
from vision_transformer_cam_tpu.data import loader as jloader
from vision_transformer_cam_tpu.data import voc12 as jvoc
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import train as tcli
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
    """Same batches, shuffling, striping and pad marks as the JAX package's
    loader."""
    split = str(voc_tree / "split.txt")
    ds = tvoc.VOC12Dataset(split, str(voc_tree), img_size=32)
    for index in range(procs):
        kw = dict(shuffle=True, drop_last=False, seed=3, num_threads=2,
                  process_index=index, process_count=procs)
        got, want = tloader.BatchLoader(ds, 2, **kw), \
            jloader.BatchLoader(ds, 2, **kw)
        got.set_epoch(1)
        want.set_epoch(1)
        assert len(got) == len(want)
        for a, b in zip(got, want, strict=True):
            assert a["name"] == b["name"]
            assert set(a) == set(b) and ("is_pad" in a) == (procs > 1)
            for k in set(a) - {"name"}:
                np.testing.assert_array_equal(a[k], b[k])


def test_device_prefetch_moves_image_and_label(voc_tree):
    ds = tvoc.VOC12Dataset(str(voc_tree / "split.txt"), str(voc_tree),
                           img_size=32)
    loader = tloader.BatchLoader(ds, 3, shuffle=False, drop_last=False)
    batches = list(tloader.device_prefetch(loader, "cpu"))
    assert [b["image"].shape[0] for b in batches] == [3, 1]
    assert all(isinstance(b[k], torch.Tensor) and b[k].dtype == torch.float32
               for b in batches for k in ("image", "label"))
    assert batches[0]["name"] == NAMES[:3]
    with pytest.raises(NotImplementedError, match="native_decode"):
        tloader.BatchLoader(ds, 2, native_decode=True)


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


@pytest.mark.parametrize("flags", [("--zero1",), ("--pipeline", "2"),
                                   ("--seq_parallel", "2"),
                                   ("--mesh_shape", "2"),
                                   ("--mesh_shape", "2,2"),
                                   ("--native_decode",)])
def test_train_cli_refuses_unported_options(voc_tree, tiny_zoo, flags):
    with pytest.raises(NotImplementedError):
        tcli.main(_cli_args(voc_tree, tiny_zoo, "--device", "cpu", *flags))


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
