"""The port's sequence-sharded serving artifact (``cli.export --seq_parallel
2``) and the batch-global mask norm in the ``--data_parallel`` artifact, on
the CPU: four gloo ranks (``parallel.worker.launch`` running
``tests/_dp_ranks.export_seq``), each export and each serving run in a
process group of its own, as a launcher starts one process a rank for each
CLI run.

The tiny depth-4 ViT has N = 17 tokens, an uneven split over two sequence
ranks (9 and 8 rows, padded to 18).  On the (2, 2) ('data', 'seq') grid the
artifact is exported in ``off``, bf16 and int8 with ``--check`` (every rank
its own program, bit for bit against its live function), served by
``examples.serve_artifact``, and its gathered outputs are held to the JAX
package's ``--seq_parallel 2`` artifact of the same weights and calibration
(its one program over the 8 virtual CPU devices, tests/conftest.py; its
CPU default, the XLA attention, never its Pallas path at an uneven split)
at tests/test_torch_export.py's tolerances.  ``--data_parallel --serving
off`` on the four ranks takes the mask norm's max over the whole batch and
equals the one-rank artifact bit for bit.  A process that makes its groups
in another order than the exporter refuses the programs.  The ranks are
spawned once, by the module's fixture.
"""

import json
import re

import _dp_ranks

import numpy as np
import pytest
import torch

import PIL.Image
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vision_transformer_cam_tpu import configs as jconfigs
from vision_transformer_cam_tpu.cli import export as jecli
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import export as ecli
from vision_transformer_cam_tpu_torch.examples import serve_artifact as tsa
from vision_transformer_cam_tpu_torch.kernels import ops as kops
from vision_transformer_cam_tpu_torch.parallel.worker import launch

ZOO = "tinyexportseq"
DEPTH = 4
ZOO_KW = dict(dtype="float32", depth=DEPTH, mask_from=1)
BATCH, WORLD, SP, N_JPEGS = 16, 4, 2, 20
MODES = ("off", "bf16", "int8")
# tests/test_torch_export.py: float32 "off" the kernel-path classes, the
# bf16 serving modes the bf16 class
TOL = {"off": dict(cam=1e-5, logits=2e-4),
       **{m: dict(cam=1e-2, logits=1e-2) for m in ("bf16", "int8")}}


def _jax_factory(num_classes=20, has_logits=False):
    return jconfigs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                 depth=DEPTH, num_heads=4,
                                 num_classes=num_classes, mask_from=1,
                                 top_k_patches=4)


@pytest.fixture()
def zoos(monkeypatch):
    monkeypatch.setitem(configs.MODEL_ZOO, ZOO, _dp_ranks.tiny_factory(
        **ZOO_KW))
    monkeypatch.setitem(jconfigs.MODEL_ZOO, ZOO, _jax_factory)


def _argv(out, mode, assets, *extra):
    return ["--model_name", ZOO, "--serving", mode, "--batch", str(BATCH),
            "--out", str(out), "--weights", assets["npz"], "--calib_npy",
            assets["calib"], *extra]


def _port(out, mode, assets, *extra):
    return _argv(out, mode, assets, "--device", "cpu", "--attn_impl",
                 "kernel", *extra)


def _x(seed=9):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The weights (a JAX ``vit.init`` tree, qkv gain 10 so that the mask
    engages), the calibration batch, 20 JPEGs (two calls of 16, the second
    padded), and what the four ranks gave back: what each export printed
    (the three seq artifacts and the data-parallel ``off`` artifact with
    ``--check``, a batch off the data axis), what ``serve_artifact`` of the
    ``off`` seq artifact printed, each artifact's outputs on ``_x()``
    gathered over the data group, and the text of the refusal under
    another group order."""
    d = tmp_path_factory.mktemp("export_seq")
    params = jvit.init(_jax_factory(), jax.random.key(0))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 10.0
    assets = {"npz": str(d / "w.npz"), "calib": str(d / "calib.npy"),
              "dir": d}
    jwio.save_npz(assets["npz"], params)
    np.save(assets["calib"], np.random.default_rng(11).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    jpegs = d / "jpegs"
    jpegs.mkdir()
    rng = np.random.default_rng(4)
    for i in range(N_JPEGS):
        arr = np.kron(rng.integers(0, 256, (4 + i % 3, 5, 3), np.uint8),
                      np.ones((8, 8, 1), np.uint8))
        PIL.Image.fromarray(arr).save(jpegs / f"im_{i:02d}.jpg")
    argvs = [_port(d / f"{m}.pt2", m, assets, "--seq_parallel", str(SP),
                   "--check") for m in MODES]
    argvs.append(_port(d / "dp_off.pt2", "off", assets, "--data_parallel",
                       "--check"))
    argvs.append(_port(d / "odd.pt2", "bf16", assets, "--seq_parallel",
                       str(SP), "--batch", "5"))
    serve = ["--artifact", str(d / "off.pt2"), "--images", str(jpegs),
             "--out", str(d / "served"), "--threshold", "0.5"]
    run = {m: str(d / f"{m}.pt2.json") for m in (*MODES, "dp_off")}
    ranks = launch(_dp_ranks.export_seq,
                   (ZOO, ZOO_KW, str(d), argvs, serve,
                    torch.from_numpy(_x()), run, str(d / "off.pt2.json")),
                   world=WORLD, timeout=240)
    return assets, ranks


def _meta(assets, name):
    return json.loads((assets["dir"] / f"{name}.pt2.json").read_text())


@pytest.mark.parametrize("mode", MODES)
def test_seq_check_is_bit_for_bit_on_every_rank(sp, mode):
    """Every rank exports its own program at the data rank's 8 rows and
    ``--check`` holds it to the rank's live function bit for bit; the
    sidecar names the four programs and each rank's groups: the sequence
    group of its data group, and under ``off`` the data group of its
    sequence index too."""
    assets, ranks = sp
    i = MODES.index(mode)
    for r, (printed, _, _) in enumerate(ranks):
        assert f"rank {r}'s program: batch {BATCH // 2} on the (2, 2) " \
            "('data', 'seq') grid" in printed[i]
        assert f"bit-identical) on rank {r}'s rows" in printed[i]
    meta = _meta(assets, mode)
    assert (meta["nr_devices"], meta["seq_parallel"], meta["batch"]) == \
        (WORLD, SP, BATCH)
    assert meta["programs"] == [f"{mode}.pt2"] + [
        f"{mode}.rank{r}.pt2" for r in range(1, WORLD)]
    for r, groups in enumerate(meta["process_groups"]):
        seq = [r // SP * SP + s for s in range(SP)]
        data = [d * SP + r % SP for d in range(WORLD // SP)]
        want = [seq, data] if mode == "off" else [seq]
        assert sorted(g["ranks"] for g in groups.values()) == sorted(want)
        assert {g["backend"] for g in groups.values()} == {"gloo"}
        assert (assets["dir"] / meta["programs"][r]).exists()


@pytest.mark.parametrize("mode", MODES)
def test_seq_graph_holds_one_seq_op_a_layer_and_the_collectives(sp, mode):
    """A rank's program, exported with ``--attn_impl kernel``, holds the
    sequence-parallel kernel as one ``vitcam`` op a layer (with the head
    mean: the CAM's rollout) and no other attention op, and its collectives
    as ``_c10d_functional`` nodes: the K | V and key-mask all-gathers, the
    cls-row broadcast and, under ``off``, the mask norm's all-reduce."""
    assets, _ = sp
    meta = _meta(assets, mode)
    # rank 0: rows 0-8 of both data groups' first; rank 3: rows 9-16 and
    # the padded row of the second's
    for r in (0, WORLD - 1):
        ep = torch.export.load(str(assets["dir"] / meta["programs"][r]))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets.count(
            "vitcam.masked_attention_seq_local_hm.default") == DEPTH
        assert not [t for t in targets if t.startswith("vitcam.masked_"
                                                       "attention_fused")]
        names = kops.program_groups(ep)
        ops = set().union(*names.values())
        assert {"all_gather_into_tensor", "broadcast"} <= ops
        assert ("all_reduce" in ops) == (mode == "off")
        assert sorted(names) == sorted(meta["process_groups"][r])
        assert targets.count("_c10d_functional.wait_tensor.default") == sum(
            t.startswith("_c10d_functional.") and "wait" not in t
            for t in targets)


def test_seq_sidecar_keys_equal_the_jax_sidecar(sp, zoos, tmp_path):
    """The sidecar keeps the JAX keys, with ``seq_parallel`` 2, the global
    batch and ``nr_devices`` the four ranks (JAX's: its mesh's devices),
    plus the programs and groups by rank."""
    assets, _ = sp
    t = _meta(assets, "bf16")
    jecli.main(_argv(tmp_path / "j.jaxex", "bf16", assets, "--seq_parallel",
                     str(SP)))
    j = json.loads((tmp_path / "j.jaxex.json").read_text())
    assert set(t) == set(j) | {"matmul_precision", "programs",
                               "process_groups"}
    assert (j["nr_devices"], j["seq_parallel"]) == (len(jax.devices()), SP)
    for key in ("model_name", "serving", "batch", "img_size", "num_classes",
                "with_cam", "calibration", "input", "mean", "std", "outputs",
                "seq_parallel"):
        assert t[key] == j[key], key


@pytest.mark.parametrize("mode", MODES)
def test_seq_artifact_matches_the_jax_seq_artifact(sp, zoos, tmp_path, mode):
    """The four ranks' programs on ``_x()`` (each data group its 8 rows,
    gathered) against the JAX ``--seq_parallel 2`` artifact on the (4, 2)
    mesh of the 8 virtual devices: logits and CAMs within
    tests/test_torch_export.py's class of the mode; every CAM's max 1."""
    assets, ranks = sp
    got = [t.float().numpy() for t in ranks[0][1][mode]]
    for _, outputs, _ in ranks[1:]:
        for a, b in zip(outputs[mode], ranks[0][1][mode]):
            assert torch.equal(a, b)
    jout = tmp_path / "j.jaxex"
    jecli.main(_argv(jout, mode, assets, "--seq_parallel", str(SP)))
    mesh = Mesh(np.array(jax.devices()).reshape(-1, SP), ("data", "seq"))
    xs = jax.device_put(jnp.asarray(_x()), NamedSharding(mesh, P("data")))
    want = [np.asarray(w.astype(jnp.float32)) for w in
            jax.export.deserialize(jout.read_bytes()).call(xs)]
    for name, i in (("logits", 0), ("cam", 2)):
        assert got[i].shape == want[i].shape, name
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=TOL[mode][name], err_msg=name)
    assert np.all(got[2].max(axis=(1, 2)) == 1.0)


def test_dp_batch_global_norm_equals_the_one_rank_artifact(sp, zoos,
                                                           tmp_path):
    """``--data_parallel --serving off`` on four ranks: one program at 4
    rows, which takes the mask norm's max over the ranks (an all-reduce over
    the world group inside it), ``--check`` bit for bit on each rank; the
    gathered outputs equal the one-rank artifact's at the global batch 16
    bit for bit.  (The CPU's float32 GEMM rounds a product of 1 or 2 rows
    otherwise than one of 3 or more, whatever the collective: the heads'
    [B, C] GEMMs need 3 rows a rank for the bits to compare.)"""
    assets, ranks = sp
    for r, (printed, _, _) in enumerate(ranks):
        assert f"bit-identical) on rank {r}'s rows" in printed[3]
    assert f"batch {BATCH // WORLD} a rank of {WORLD}" in ranks[0][0][3]
    meta = _meta(assets, "dp_off")
    assert meta["programs"] == ["dp_off.pt2"] * WORLD
    assert meta["process_groups"] == [
        {"0": {"ranks": list(range(WORLD)), "backend": "gloo"}}] * WORLD
    one = tmp_path / "one.pt2"
    ecli.main(_port(one, "off", assets))
    alone = kops.load_program(str(one), "cpu").module()(
        torch.from_numpy(_x()))
    for g, a in zip(ranks[0][1]["dp_off"], alone):
        assert torch.equal(g, a)


def _classes(text):
    """{image: [(class, printed probability)]} of serve_artifact's lines."""
    return {ln.split(":")[0].strip(): [
        (int(c), float(p)) for c, p in re.findall(r"(\d+):([\d.]+)",
                                                  ln.split(":", 1)[1])]
        for ln in text.splitlines() if ln.startswith("  im_")}


def test_seq_serve_artifact_on_four_ranks(sp, zoos, tmp_path, capsys):
    """``serve_artifact`` of the ``off`` seq artifact on its four ranks,
    the grid rebuilt from the sidecar: rank 0 writes the 20 overlays and
    prints, for each JPEG, the classes the one-rank ``off`` artifact at
    batch 16 prints (probabilities printed to two places); the other ranks
    print nothing."""
    assets, ranks = sp
    served = ranks[0][0][-1]
    assert "nr_devices=4 seq_parallel=2" in served
    assert all(printed[-1] == "" for printed, _, _ in ranks[1:])
    overlays = sorted(p.name for p in (assets["dir"] / "served").iterdir())
    assert overlays == [f"im_{i:02d}_cam.jpg" for i in range(N_JPEGS)]
    one = tmp_path / "one.pt2"
    ecli.main(_port(one, "off", assets))
    capsys.readouterr()
    tsa.main(["--artifact", str(one), "--images",
              str(assets["dir"] / "jpegs"), "--out", str(tmp_path / "s1"),
              "--threshold", "0.5"])
    got, want = _classes(served), _classes(capsys.readouterr().out)
    assert sorted(got) == sorted(want) and len(want) == N_JPEGS
    for name in want:
        assert [c for c, _ in got[name]] == [c for c, _ in want[name]]
        np.testing.assert_allclose([p for _, p in got[name]],
                                   [p for _, p in want[name]], atol=0.0101)


def test_programs_refuse_another_group_order(sp):
    """A process that made the grid's groups in another order (the data
    groups first) gives the names the programs hold to other groups:
    ``load_program`` raises on every rank, where a name resolves to other
    ranks (ranks 0 and 3) or to no group this rank holds (ranks 1 and
    2)."""
    _, ranks = sp
    refused = [r[2] for r in ranks]
    assert all(t is not None for t in refused)
    for r in (0, 3):
        assert "was exported as" in refused[r]
        assert "make the process grid as the exporter made it" in refused[r]
    for r in (1, 2):
        assert "which this process does not hold" in refused[r]


def test_seq_export_refuses_a_batch_off_the_data_axis(sp):
    """``--batch 5`` on the (2, 2) grid: JAX's text on every rank, and no
    program written."""
    assets, ranks = sp
    for printed, _, _ in ranks:
        assert printed[4] == ("SystemExit: --batch 5 must be a multiple of "
                              "the mesh's 2-way batch axis")
    assert not list(assets["dir"].glob("odd*"))
