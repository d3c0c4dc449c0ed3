"""The port's data-parallel entry points in spawned gloo ranks on the CPU:
the data-group collectives, the batch-sharded forward (alone and in the data
groups of the sequence-parallel grid, held against JAX on a (2, 2) mesh),
``cli.train --mesh_shape 2`` (``train.loop.fit``) and ``evaluate``, and
``cli.validate --data_parallel``, each against the one-rank run.  The ranks
run ``tests/_dp_ranks.py`` through ``parallel.worker.launch`` (a stand-in
for ``torchrun``), which has a time limit of its own."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import PIL.Image
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import _dp_ranks
from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.cli import export as xcli
from vision_transformer_cam_tpu_torch.cli import train as tcli
from vision_transformer_cam_tpu_torch.cli import validate as vcli
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.train import loop as tloop

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
NAMES = [f"2008_{i:06d}" for i in range(5)]
ZOO, ZOO_KW = "tinydp", dict(dtype="float64", depth=6, mask_from=1)
TIMEOUT = 150


def _pair(gain=10.0, **kw):
    """(JAX params, JAX cfg, port state dict, port cfg), float64."""
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.float64,
                              param_dtype=torch.float64, **kw)
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=jnp.float64,
                              param_dtype=jnp.float64, attn_impl="xla", **kw)
    params = jvit.init(jcfg, jax.random.key(2))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * gain
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return params, jcfg, sd, tcfg


def _images(b, seed=5):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3))


def test_data_group_collectives_in_processes():
    """Sum, mean and max travel in float32 at least (float64 stays), the
    all-gather in rank order and bit for bit (bf16 too), broadcast from the
    named rank; the reference helpers name the process group."""
    res = launch(_dp_ranks.collectives, world=2, timeout=TIMEOUT)
    xs = [r["x"] for r in res]
    bfs = [x.to(torch.bfloat16) for x in xs]
    for r, out in enumerate(res):
        assert (out["rank"], out["rank_fn"], out["world"], out["main"]) == \
            (r, r, 2, r == 0)
        assert torch.equal(out["sum"], xs[0] + xs[1])
        assert torch.equal(out["reduce_value"], xs[0] + xs[1])
        assert torch.equal(out["mean"], (xs[0] + xs[1]) / 2)
        assert torch.equal(out["max"], torch.maximum(xs[0], xs[1]))
        assert torch.equal(out["gather"], torch.cat(xs))
        assert torch.equal(out["gather_bf16"], torch.cat(bfs, dim=1))
        assert out["max_bf16"].dtype == torch.bfloat16 and torch.equal(
            out["max_bf16"], torch.maximum(bfs[0], bfs[1]))
        assert out["sum_bf16"].dtype == torch.float32 and torch.equal(
            out["sum_bf16"], bfs[0].float() + bfs[1].float())
        assert torch.equal(out["bcast"], xs[1])
        assert out["transport"] == "gloo"
    assert [r["slice"] for r in res] == [(0, 3), (3, 7)]


@pytest.mark.parametrize("norm", ["batch_global", "per_sample"])
def test_step0_data_groups_of_the_seq_grid_share_the_global_max(norm):
    """Four gloo ranks on the (data 2, seq 2) grid, each data group on its
    two rows of a global batch of four, against JAX on a (2, 2) mesh of the
    virtual CPU devices: under the batch-global norm every data group
    divides by the global batch's max, as JAX's ``jnp.max`` over the
    sharded batch does (the rank-local max gives another mask on this
    fixture).  The eager path at float64 against JAX "xla"."""
    per_sample = norm == "per_sample"
    params, jcfg, sd, tcfg = _pair(per_sample_mask_norm=per_sample)
    x = _images(4, seed=6)
    outs = launch(_dp_ranks.seq_forward,
                  (tcfg, sd, torch.from_numpy(x), 2, dict(attn_impl="eager")),
                  world=4, timeout=TIMEOUT)
    mesh = jmesh.make_mesh((2, 2), ("data", "seq"),
                           devices=jax.devices()[:4])
    x_s = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    with jax.set_mesh(mesh):
        want = jvit.apply(params, x_s, jcfg.replace(
            data_axis="data", seq_axis="seq"), need_rollout=True)
        jax.block_until_ready(want.logits)
    for rank, out in enumerate(outs):
        rows = slice(2 * (rank // 2), 2 * (rank // 2) + 2)
        for name in ("logits", "rollout_row", "head1_logits",
                     "top_patch_idx"):
            w = np.asarray(getattr(want, name))[rows]
            np.testing.assert_allclose(out[name].numpy(), w, rtol=0,
                                       atol=1e-10, err_msg=(rank, name))
        w = np.asarray(want.attn_cls_rows)[:, rows]
        np.testing.assert_allclose(out["attn_cls_rows"].numpy(), w, rtol=0,
                                   atol=1e-10)
    # the fixture: a data group's own max changes a mask that sets the next
    # block's attention
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, sd)
    rows = model(torch.from_numpy(x)).attn_cls_rows
    flips = 0
    for cls in rows[tcfg.mask_from:-1]:
        _, bg = tvit._mask_from_cls_row(cls, tcfg)
        for g in (slice(0, 2), slice(2, 4)):
            _, bg_group = tvit._mask_from_cls_row(cls[g], tcfg)
            flips += int((bg_group != bg[g]).sum())
    assert (flips > 0) == (not per_sample)


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["batch_global", "per_sample"])
def test_batch_sharded_cam_extraction_matches_one_rank(per_sample):
    """The data-parallel forward (the ('data',) mesh and cfg.data_axis) on
    two ranks, each on its half of the batch, equals the one-rank forward's
    rows, kernel path (plain versions here)."""
    _, _, sd, tcfg = _pair(per_sample_mask_norm=per_sample)
    x = torch.from_numpy(_images(6, seed=8))
    outs = launch(_dp_ranks.dp_forward,
                  (tcfg.replace(attn_impl="kernel"), sd, x), world=2,
                  timeout=TIMEOUT)
    model = tvit.ViTCAM(tcfg.replace(attn_impl="kernel"), device="cpu")
    load_state_dict(model, sd)
    want = model(x, need_rollout=True)
    for rank, out in enumerate(outs):
        rows = slice(3 * rank, 3 * rank + 3)
        for name in ("logits", "rollout_row", "head1_logits",
                     "attn_cls_rows"):
            w = getattr(want, name)
            w = w[:, rows] if name == "attn_cls_rows" else w[rows]
            np.testing.assert_allclose(out[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-12, err_msg=(rank, name))
        assert out["transport"] == "gloo"


def test_data_axis_needs_a_mesh():
    _, _, sd, tcfg = _pair()
    model = tvit.ViTCAM(tcfg.replace(data_axis="data"), device="cpu")
    x = torch.zeros(2, 32, 32, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="data_axis"):
        model(x)
    with tmesh.set_mesh(tmesh.make_mesh((-1,), ("data",))):
        assert torch.isfinite(model(x).logits).all()


# ---------------------------------------------------------------------------
# the CLIs on a faked VOC tree
# ---------------------------------------------------------------------------

@pytest.fixture()
def tree(tmp_path):
    """Five images of differing sizes with segmentation PNGs and
    annotations, a split of all five and one of the first four."""
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "SegmentationClass", "Annotations"):
        (tmp_path / d).mkdir()
    cats = ["dog", "cat", "person", "car", "bird"]
    for i, n in enumerate(NAMES):
        arr = np.kron(rng.integers(0, 256, size=(5 + i, 6, 3),
                                   dtype=np.uint8),
                      np.ones((8, 8, 1), np.uint8))
        PIL.Image.fromarray(arr).save(tmp_path / "JPEGImages" / f"{n}.jpg")
        seg = rng.integers(0, 21, size=arr.shape[:2]).astype(np.uint8)
        PIL.Image.fromarray(seg, mode="P").save(
            tmp_path / "SegmentationClass" / f"{n}.png")
        (tmp_path / "Annotations" / f"{n}.xml").write_text(
            "<annotation>" + "".join(
                f"<object><name>{c}</name></object>"
                for c in (cats[i], cats[(i + 2) % 5])) + "</annotation>")
    for name, names in (("split5.txt", NAMES), ("split4.txt", NAMES[:4])):
        (tmp_path / name).write_text("".join(
            f"/JPEGImages/{n}.jpg /SegmentationClass/{n}.png\n"
            for n in names))
    return tmp_path


@pytest.fixture()
def weights(tree, monkeypatch):
    """The float64 tiny model in the zoo, and its JAX-initialised weights
    (qkv gain 10) as a .pth both CLIs read."""
    monkeypatch.setitem(tcfgs.MODEL_ZOO, ZOO, _dp_ranks.tiny_factory(**ZOO_KW))
    jcfg = jcfgs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                              depth=6, num_heads=4, num_classes=20,
                              mask_from=1, top_k_patches=4)
    params = jvit.init(jcfg, jax.random.key(1))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 10.0
    bias = np.full((20,), -3.0, np.float32)
    bias[[7, 11, 14]] = 4.0
    params["head1"]["bias"] = jnp.asarray(bias)
    path = str(tree / "w.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jwio.state_dict_from_pytree(params, jcfg).items()}, path)
    return path


def _train_args(tree, weights, out, *extra):
    split = str(tree / "split4.txt")
    return ["--model_name", ZOO, "--weights", weights, "--dataset_path",
            str(tree), "--train_img_name_path", split,
            "--val_img_name_path", str(tree / "split5.txt"),
            "--batch_size", "4", "--epochs", "2", "--warmup_epochs", "0",
            "--lr", "1e-3", "--clip_grad", "0.5", "--device", "cpu",
            "--ckpt_dir", str(out / "w"), "--log_dir", str(out), *extra]


@pytest.mark.parametrize("extra", [(), ("--zero1",), ("--grad_accum", "2"),
                                   ("--zero1", "--grad_accum", "2")],
                         ids=["dp", "zero1", "accum2", "zero1_accum2"])
def test_train_cli_two_ranks_match_one_rank(tree, weights, tmp_path, extra,
                                            monkeypatch):
    """``cli.train --mesh_shape 2`` on two ranks (a global batch of 4, two
    rows a rank, two epochs, and the val split of five, whose last batch is
    padded) against the one-rank run of the same flags: every parameter at
    1e-10 (float64), the same logged losses and mAPs, and one log and one
    set of checkpoints, the main process's."""
    # no TensorBoard scalars in either run (see _dp_ranks.no_tensorboard)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one = tmp_path / "one"
    state = tcli.main(_train_args(tree, weights, one, *extra))
    two = tmp_path / "two"
    res = launch(_dp_ranks.train_cli,
                 (ZOO, ZOO_KW, _train_args(tree, weights, two, "--mesh_shape",
                                           "2", *extra)),
                 world=2, timeout=TIMEOUT)
    want = state.model.state_dict()
    for r in res:
        assert r["step"] == state.step == 2
        assert max(float((r["params"][k] - v).abs().max())
                   for k, v in want.items()) <= 1e-10
    logs = {d: [f for f in os.listdir(d) if f.startswith("train_log_")]
            for d in (one, two)}
    assert len(logs[one]) == len(logs[two]) == 1
    lines = [(d / logs[d][0]).read_text().splitlines() for d in (one, two)]
    for a, b in zip(*lines, strict=True):
        # loss, f1, mAP_196, mAP_16 printed to 4-6 places; lr
        fa, fb = a.split(), b.split()
        np.testing.assert_allclose([float(v) for v in fa[3:10:2]],
                                   [float(v) for v in fb[3:10:2]],
                                   rtol=0, atol=2e-6)
        assert fa[11] == fb[11]
    assert sorted(os.listdir(one / "w"))[-1].endswith("-cur_ep1-final.pt")
    assert len(os.listdir(two / "w")) == len(os.listdir(one / "w"))


def test_zero1_resume_on_two_ranks_matches_one_rank(tree, weights, tmp_path,
                                                    monkeypatch):
    """``cli.train --mesh_shape 2 --zero1`` for an epoch, then ``--resume``
    for one more epoch on two ranks, against the one-rank run of the same
    two commands: the resumed ranks step from the checkpoint's weights and
    moments (not from the weights the model held when the optimizer was
    built), every parameter at 1e-10 (float64)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one, two = tmp_path / "one", tmp_path / "two"
    flags = ("--zero1", "--epochs", "1")
    tcli.main(_train_args(tree, weights, one, *flags))
    state = tcli.main(_train_args(tree, weights, one, *flags, "--resume"))
    for extra in ((), ("--resume",)):
        res = launch(_dp_ranks.train_cli,
                     (ZOO, ZOO_KW, _train_args(tree, weights, two, *flags,
                                               "--mesh_shape", "2", *extra)),
                     world=2, timeout=TIMEOUT)
    want = state.model.state_dict()
    for r in res:
        assert r["step"] == state.step == 2
        assert max(float((r["params"][k] - v).abs().max())
                   for k, v in want.items()) <= 1e-10


def _same_logs(a, b):
    """The train logs of two runs: one file each, the same losses, f1 and
    mAPs (printed to 4-6 places) and learning rates."""
    logs = {d: [f for f in os.listdir(d) if f.startswith("train_log_")]
            for d in (a, b)}
    assert len(logs[a]) == len(logs[b]) == 1
    lines = [(d / logs[d][0]).read_text().splitlines() for d in (a, b)]
    for la, lb in zip(*lines, strict=True):
        fa, fb = la.split(), lb.split()
        np.testing.assert_allclose([float(v) for v in fa[3:10:2]],
                                   [float(v) for v in fb[3:10:2]],
                                   rtol=0, atol=2e-6)
        assert fa[11] == fb[11]


@pytest.mark.parametrize("flags,one_flags,world", [
    (("--mesh_shape", "2,2"), (), 4),
    (("--mesh_shape", "1,2", "--grad_accum", "2"), ("--grad_accum", "2"), 2),
    (("--pipeline", "2"), ("--pipeline", "1"), 2)],
    ids=["tp_2x2", "tp_1x2_accum2", "pipeline_2"])
def test_train_cli_tp_and_pipeline_ranks_match_one_rank(
        tree, weights, tmp_path, flags, one_flags, world, monkeypatch):
    """``cli.train --mesh_shape 2,2`` on four ranks (tensor parallelism over
    two, a global batch of 4, two rows a data rank) and ``--pipeline 2`` on
    two (two stages, two microbatches) against the one-rank run of the same
    flags (for the pipeline ``--pipeline 1``, the one-rank run with the
    per-sample norm ``--pipeline`` sets): every parameter at 1e-10 (float64,
    gathered to the one-rank layout), the same logged losses and mAPs, one
    log and one set of checkpoints."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one, many = tmp_path / "one", tmp_path / "many"
    state = tcli.main(_train_args(tree, weights, one, *one_flags))
    res = launch(_dp_ranks.train_cli,
                 (ZOO, ZOO_KW, _train_args(tree, weights, many, *flags)),
                 world=world, timeout=TIMEOUT)
    want = state.model.state_dict()
    for r in res:
        assert r["step"] == state.step == 2
        assert set(r["params"]) == set(want)
        assert max(float((r["params"][k] - v).abs().max())
                   for k, v in want.items()) <= 1e-10
    _same_logs(one, many)
    assert len(os.listdir(many / "w")) == len(os.listdir(one / "w"))


def test_tp_checkpoint_resumes_on_one_rank(tree, weights, tmp_path,
                                           monkeypatch):
    """An epoch of ``cli.train --mesh_shape 2,2`` on four ranks, then
    ``--resume`` for one more epoch on one rank, against the one-rank run of
    the same two commands: the checkpoint holds the one-rank layout, every
    parameter at 1e-10 (float64)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one, tp = tmp_path / "one", tmp_path / "tp"
    flags = ("--epochs", "1")
    tcli.main(_train_args(tree, weights, one, *flags))
    want = tcli.main(_train_args(tree, weights, one, *flags, "--resume"))
    launch(_dp_ranks.train_cli,
           (ZOO, ZOO_KW, _train_args(tree, weights, tp, *flags,
                                     "--mesh_shape", "2,2")),
           world=4, timeout=TIMEOUT)
    got = tcli.main(_train_args(tree, weights, tp, *flags, "--resume"))
    assert got.step == want.step == 2
    assert max(float((got.model.state_dict()[k] - v).abs().max())
               for k, v in want.model.state_dict().items()) <= 1e-10


def test_evaluate_two_ranks_match_one_rank(tree, weights):
    """evaluate under DP: the same mAP and sample count on both ranks, equal
    to the one-rank evaluate (five images, global batch 4, the last batch
    padded)."""
    args = (ZOO, ZOO_KW, weights, str(tree / "split5.txt"), str(tree), 4)
    res = launch(_dp_ranks.evaluate_split, args, world=2, timeout=TIMEOUT)
    want = _dp_ranks.evaluate_split(*args)
    assert want["n_samples"] == 5
    for r in res:
        assert r == want


def _val_args(tree, weights, seg_dir, *extra):
    return ["--model_name", ZOO, "--weights", weights, "--dataset_path",
            str(tree), "--val_img_name_path", str(tree / "split5.txt"),
            "--batch_size", "4", "--seg_pred_dir", str(seg_dir),
            "--device", "cpu", *extra]


def _pngs(seg_dir):
    return {n: (seg_dir / f"{n}.png").read_bytes() for n in NAMES}


@pytest.mark.parametrize("extra", [(), ("--batch_global_mask_norm",),
                                   ("--attn_impl", "kernel", "--serving",
                                    "int8")],
                         ids=["per_sample", "batch_global", "int8_kernel"])
def test_validate_cli_data_parallel_matches_one_rank(tree, weights, tmp_path,
                                                     extra):
    """``cli.validate --data_parallel`` on two ranks: each writes the PNGs
    of its images, byte for byte those of the one-rank run, and every score
    is the one-rank run's (five images, a global batch of 4: the last batch
    is padded on the second rank)."""
    want = vcli.main(_val_args(tree, weights, tmp_path / "one", *extra))
    res = launch(_dp_ranks.validate_cli,
                 (ZOO, ZOO_KW, _val_args(tree, weights, tmp_path / "two",
                                         "--data_parallel", *extra)),
                 world=2, timeout=TIMEOUT, cwd=str(tmp_path))
    assert _pngs(tmp_path / "two") == _pngs(tmp_path / "one")
    assert want["n_images"] == 5
    for r in res:
        for k in ("mAP", "mIoU", "global_acc", "n_images"):
            assert r[k] == want[k], k


def test_validate_cli_seq_grid_data_groups_match_one_rank(tree, weights,
                                                          tmp_path):
    """The data groups of the seq grid through the CLI: ``cli.validate
    --seq_parallel 2`` on four ranks, the (data 2, seq 2) grid, under the
    batch-global norm.  Each data
    group runs its two rows of every global batch of 4 (the last batch of
    one image padded on the second group) and the mask max is taken over
    both groups, so the PNGs are byte for byte those of the one-rank run
    and the scores its scores (float64; the sequence split moves only the
    last bits of the probabilities).  The writers are sequence-rank 0."""
    extra = ("--batch_global_mask_norm", "--attn_impl", "eager")
    want = vcli.main(_val_args(tree, weights, tmp_path / "one", *extra))
    res = launch(_dp_ranks.validate_cli,
                 (ZOO, ZOO_KW, _val_args(tree, weights, tmp_path / "four",
                                         "--seq_parallel", "2", *extra)),
                 world=4, timeout=TIMEOUT, cwd=str(tmp_path))
    assert _pngs(tmp_path / "four") == _pngs(tmp_path / "one")
    assert want["n_images"] == 5
    assert [bool(r) for r in res] == [True, False, True, False]
    for r in res[::2]:
        assert r["n_images"] == 5
        for k in ("mAP", "mIoU", "global_acc"):
            assert abs(r[k] - want[k]) <= 1e-12, k


# ---------------------------------------------------------------------------
# the layouts item 10 took, and what stays refused (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", [dict(mesh_shape=(-1, 2),
                                       mesh_axes=("data", "model")),
                                  dict(mesh_shape=(-1, 2),
                                       mesh_axes=("data", "seq")),
                                  dict(pipeline=2), dict(pp_microbatches=4)])
def test_trainer_still_refuses_tp_pipeline_and_seq(knob):
    """The trainer takes a ('data', 'model') mesh, a ('data', 'seq') mesh
    and ``pp_microbatches`` (unused without a pipeline, as in JAX);
    ``pipeline`` wants its ('data', 'stage') mesh; ``fit`` refuses a
    ('data', 'seq') mesh for a config without the seq axis."""
    cfg = tcfgs.TrainConfig(**knob)
    if knob.get("mesh_axes") == ("data", "seq"):
        tloop.check_supported(cfg)
        with pytest.raises(ValueError, match="cfg.seq_axis"):
            tloop.fit(tcfgs.ViTCAMConfig(**TINY), cfg, tcfgs.DataConfig(),
                      tcfgs.DataConfig(), device="cpu")
    elif knob.get("pipeline"):
        with pytest.raises(ValueError, match="'stage'"):
            tloop.check_supported(cfg)
        tloop.check_supported(dataclasses.replace(
            cfg, mesh_shape=(-1, 2), mesh_axes=("data", "stage")))
    else:
        tloop.check_supported(cfg)
    tloop.check_supported(tcfgs.TrainConfig(mesh_shape=(2,), zero1=True))


@pytest.mark.parametrize("flags,err", [(("--seq_parallel", "2"),
                                        "needs 2 rank"),
                                       (("--mesh_shape", "2,2"),
                                        "needs 4 rank"),
                                       (("--pipeline", "2"),
                                        "does not divide")])
def test_train_cli_still_refuses_item_10_second_half(tree, weights, tmp_path,
                                                     flags, err):
    """``--seq_parallel 2``, ``--mesh_shape 2,2`` and ``--pipeline 2`` are
    taken, and one process refuses their two-, four- and two-rank meshes,
    as ``--mesh_shape 2`` (the runs on their ranks: below and
    tests/test_torch_seq_train.py); ``--seq_parallel`` with ``--pipeline``
    is refused with JAX's text."""
    with pytest.raises(ValueError, match=err):
        tcli.main(_train_args(tree, weights, tmp_path, *flags))
    with pytest.raises(SystemExit, match="distinct mesh layouts"):
        tcli.main(_train_args(tree, weights, tmp_path, "--seq_parallel",
                              "2", "--pipeline", "2"))


def test_export_still_refuses_data_parallel(tmp_path, monkeypatch):
    """Without a process group ``--data_parallel`` exports the plain
    artifact (``nr_devices`` 1); one process exports ``--seq_parallel 1``
    (the one-rank grid) and refuses ``--seq_parallel 2``, whose sequence
    axis its one rank cannot hold (the sequence-sharded artifact on four
    ranks: tests/test_torch_export_seq.py)."""
    monkeypatch.setitem(tcfgs.MODEL_ZOO, ZOO, _dp_ranks.tiny_factory(
        dtype="float32", depth=2))
    out = tmp_path / "a.pt2"
    argv = ["--device", "cpu", "--model_name", ZOO, "--serving", "bf16",
            "--batch", "2", "--out", str(out), "--data_parallel"]
    assert xcli.main(argv + ["--check"]) == str(out)
    meta = json.loads((tmp_path / "a.pt2.json").read_text())
    assert (meta["nr_devices"], meta["batch"]) == (1, 2)
    assert xcli.main(argv + ["--seq_parallel", "1", "--check"]) == str(out)
    meta = json.loads((tmp_path / "a.pt2.json").read_text())
    assert (meta["nr_devices"], meta["seq_parallel"]) == (1, 1)
    with pytest.raises(SystemExit, match="does not divide the 1 rank"):
        xcli.main(argv + ["--seq_parallel", "2"])
