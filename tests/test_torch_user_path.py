"""The user path around the model, on the CPU, against the JAX package: the
generic path-list dataset, the e2e_bench tree and a small e2e_bench run, the
quickstart end to end at --device cpu, and the sequence-parallel spawner's
device rule.  The tests marked ``cuda`` run on a GPU machine without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_user_path.py
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import PIL.Image

from vision_transformer_cam_tpu_torch.data.generic import (PathListDataset,
                                                           collate_fn)
from vision_transformer_cam_tpu_torch.examples import quickstart as tqs
from vision_transformer_cam_tpu_torch.scripts import e2e_bench as te2e

REPO = pathlib.Path(__file__).resolve().parents[1]

try:  # the GPU machine has no jax: there only the cuda-marked tests run
    import jax  # noqa: F401

    from vision_transformer_cam_tpu.data import generic as jgeneric
except ImportError:
    jgeneric = None


def _load_root(rel, name):
    """A file of the repo root (the JAX package's scripts and examples) as
    a module under a private name."""
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("labels", [True, False])
def test_generic_dataset_matches_jax_package(tmp_path, labels):
    rng = np.random.default_rng(0)
    paths = []
    for i, (ext, mode) in enumerate((("png", "RGB"), ("jpg", "RGB"),
                                     ("png", "L"))):
        p = tmp_path / f"img{i}.{ext}"
        arr = rng.integers(0, 255, (30 + i, 40 - i, 3), dtype=np.uint8)
        PIL.Image.fromarray(arr).convert(mode).save(p)
        paths.append(str(p))
    cls = [4, 0, 19] if labels else None
    got = PathListDataset(paths, cls, img_size=32)
    want = jgeneric.PathListDataset(paths, cls, img_size=32)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert set(a) == set(b) and a["name"] == b["name"] == paths[i]
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["image"].shape == (32, 32, 3)
        np.testing.assert_array_equal(a["image"], b["image"])
        if labels:
            assert type(a["label"]) is type(b["label"])
            assert a["label"] == b["label"] == cls[i]
    a = collate_fn([got[i] for i in range(3)])
    b = jgeneric.collate_fn([want[i] for i in range(3)])
    assert set(a) == set(b) and a["name"] == b["name"]
    for k in set(a) - {"name"}:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_e2e_bench_build_tree_byte_identical(tmp_path):
    jax_e2e = _load_root("scripts/e2e_bench.py", "jax_e2e_bench")
    jax_e2e.build_tree(str(tmp_path / "j"), 5, 64, 48, seed=3)
    te2e.build_tree(str(tmp_path / "t"), 5, 64, 48, seed=3)
    got, want = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert set(got) == set(want) and len(got) == 5 + 5 + 2
    for k in want:
        if k == "cls_labels.npy":     # a pickled dict: compare the contents
            a = np.load(tmp_path / "t" / k, allow_pickle=True).item()
            b = np.load(tmp_path / "j" / k, allow_pickle=True).item()
            assert list(a) == list(b)
            assert all(np.array_equal(a[n], b[n]) for n in b)
        else:
            assert got[k] == want[k], k


def test_e2e_bench_small_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    import json
    monkeypatch.chdir(tmp_path)      # validate writes its log here
    line = te2e.main(["--n", "4", "--batch", "2", "--img", "64x48",
                      "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "value", "unit", "wall_s_total",
                         "img_per_s_incl_compile", "n_images", "serving",
                         "batch", "seg_pngs", "cam_files", "mAP", "mIoU"}
    assert line["metric"] == "e2e_cam_export_img_per_s_warm"
    assert line["seg_pngs"] == line["cam_files"] == line["n_images"] == 4
    for k in ("value", "mAP", "mIoU"):
        assert np.isfinite(line[k]), k
    assert line["value"] > 0 and line["serving"] == "int8"
    with pytest.raises(SystemExit):
        te2e.main(["--n", "4", "--bogus"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            te2e.main(["--n", "4"])


def test_quickstart_synthetic_voc_byte_identical(tmp_path):
    jqs = _load_root("examples/quickstart.py", "jax_quickstart")
    names = (["2007_000000", "2007_000001", "2007_000002"], ["2008_000000"])
    jqs.make_synthetic_voc(str(tmp_path / "j"), *names)
    tqs.make_synthetic_voc(str(tmp_path / "t"), *names)
    got, want = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert got == want and len(got) == 4 * 3 + 2


def test_quickstart_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)      # validate writes its log here
    rc = tqs.main(["--workdir", str(tmp_path / "qs"), "--epochs", "1",
                   "--n_train", "8", "--n_val", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    for step in range(1, 7):
        assert f"[{step}/6]" in out
    # step 6: the int8 artifact, its --check, and the val images served
    assert "check OK: artifact == live fn" in out
    assert "wrote 2 CAM overlays" in out
    qs = tmp_path / "qs"
    assert sorted(os.listdir(qs / "seg_parity")) == \
        sorted(os.listdir(qs / "seg_int8")) == \
        ["2008_000000.png", "2008_000001.png"]
    assert sorted(os.listdir(qs / "served_cams")) == \
        ["2008_000000_cam.jpg", "2008_000001_cam.jpg"]
    meta = json.loads((qs / "tiny_demo_int8.pt2.json").read_text())
    assert (meta["serving"], meta["batch"], meta["platforms"]) == \
        ("int8", 2, ["cpu"])
    assert os.listdir(qs / "predict_cam") == ["2008_000000_cam_grid.jpg"]
    assert any("final" in f for f in os.listdir(qs / "weights"))
    # the JAX quickstart's tiny config: heads of 16, kernel 1's and the
    # backward's narrowest compiled width
    assert tqs.tiny_demo().head_dim == 16


def test_run_forward_runs_on_the_card_unless_asked(monkeypatch):
    """Without a device run_forward resolves "cuda", and without a card it
    raises before it spawns a rank."""
    from vision_transformer_cam_tpu_torch import configs
    from vision_transformer_cam_tpu_torch.parallel import worker

    def no_spawn(*a, **kw):
        raise AssertionError("a rank was spawned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(worker.mp, "spawn", no_spawn)
    cfg = configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                               depth=2, num_heads=4)
    with pytest.raises(RuntimeError, match="cuda"):
        worker.run_forward(cfg, {}, torch.zeros(1, 32, 32, 3), world=2,
                           n_seq=2)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_e2e_bench_on_the_card_launches_the_int8_kernels(tmp_path,
                                                         monkeypatch):
    """ViT-B/16 int8 through the validate CLI on the card: 12 attention and
    49 int8 GEMM launches per forward (the calibration forward launches
    none), every PNG and overlay written."""
    monkeypatch.chdir(tmp_path)
    from vision_transformer_cam_tpu_torch.kernels import attention as ka
    from vision_transformer_cam_tpu_torch.kernels import gemm
    ka.launches = gemm.linear_int8_launches = 0
    line = te2e.main(["--n", "8", "--batch", "4", "--img", "96x80"])
    assert ka.launches == 2 * 12 and gemm.linear_int8_launches == 2 * 49
    assert line["seg_pngs"] == line["cam_files"] == 8
    assert all(np.isfinite(line[k]) for k in ("value", "mAP", "mIoU"))
