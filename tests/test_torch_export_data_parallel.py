"""The port's batch-sharded serving artifact (``cli.export
--data_parallel``) on the CPU: two gloo ranks (``parallel.worker.launch``
running ``tests/_dp_ranks.export_cli``) export a tiny ViT in bf16 and int8
at the global batch 16 with ``--check`` and serve the int8 artifact with
``examples.serve_artifact``; the artifact's outputs are held to the JAX package's ``--data_parallel``
artifact of the same weights and calibration (its one program over the 8
virtual CPU devices, tests/conftest.py) at tests/test_torch_export.py's
tolerances, and to the port's one-rank artifact at batch 16 (bit for
bit).  The ranks
are spawned once, by the module's fixture.
"""

import json

import _dp_ranks

import numpy as np
import pytest
import torch

import PIL.Image
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vision_transformer_cam_tpu import configs as jconfigs
from vision_transformer_cam_tpu.cli import export as jecli
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cli import export as ecli
from vision_transformer_cam_tpu_torch.examples import serve_artifact as tsa
from vision_transformer_cam_tpu_torch.kernels import ops as kops
from vision_transformer_cam_tpu_torch.parallel.worker import launch

ZOO = "tinyexportdp"
ZOO_KW = dict(dtype="float32", depth=4, mask_from=1)
BATCH, WORLD, N_JPEGS = 16, 2, 20
MODES = ("bf16", "int8")
# tests/test_torch_export.py: the bf16 serving modes against JAX, the bf16
# class
TOL = 1e-2


def _jax_factory(num_classes=20, has_logits=False):
    return jconfigs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                 depth=4, num_heads=4,
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


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The weights (a JAX ``vit.init`` tree, qkv gain 10 so that the mask
    engages), the calibration batch, 20 JPEGs (two calls of 16, the second
    padded), and what every rank printed: the two exports with ``--check``
    and ``serve_artifact`` of the int8 artifact."""
    d = tmp_path_factory.mktemp("export_dp")
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
    argvs = [_port(d / f"{m}.pt2", m, assets, "--data_parallel", "--check")
             for m in MODES]
    serve = ["--artifact", str(d / "int8.pt2"), "--images", str(jpegs),
             "--out", str(d / "served2"), "--threshold", "0.5"]
    printed = launch(_dp_ranks.export_cli, (ZOO, ZOO_KW, argvs, serve),
                     world=WORLD, timeout=150)
    return assets, printed


def _x(seed=9):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, 32, 32, 3)).astype(np.float32)


def _served(path, x):
    """The artifact at ``path`` as its ranks serve it: each its block of
    rows of ``x``, joined in rank order."""
    program = kops.load_program(str(path), "cpu").module()
    local = BATCH // WORLD
    outs = [program(torch.from_numpy(x[r * local:(r + 1) * local]))
            for r in range(WORLD)]
    return [torch.cat(parts).float().numpy() for parts in zip(*outs)]


@pytest.mark.parametrize("mode", MODES)
def test_dp_check_is_bit_for_bit_on_each_ranks_rows(dp, mode):
    """Rank 0 writes the program at the local batch 8 and the sidecar;
    every rank's ``--check`` holds the loaded artifact to its live function
    bit for bit on its rows."""
    assets, printed = dp
    i = MODES.index(mode)
    for r in range(WORLD):
        assert f"bit-identical) on rank {r}'s rows" in printed[r][i]
        assert ("exported" in printed[r][i]) == (r == 0)
    assert f"batch {BATCH // WORLD} a rank of {WORLD}" in printed[0][i]
    program = kops.load_program(str(assets["dir"] / f"{mode}.pt2"), "cpu")
    spec = program.graph_signature.user_inputs
    shape = [n.meta["val"].shape for n in program.graph.nodes
             if n.name in spec]
    assert [tuple(s) for s in shape] == [(BATCH // WORLD, 32, 32, 3)]


def test_dp_sidecar_keys_equal_the_jax_sidecar(dp, zoos, tmp_path):
    """The sidecar keeps the JAX keys, with the global batch and
    ``nr_devices`` the two ranks (JAX's is its mesh's device count)."""
    assets, _ = dp
    t = json.loads((assets["dir"] / "bf16.pt2.json").read_text())
    jout = tmp_path / "j.jaxex"
    jecli.main(_argv(jout, "bf16", assets, "--data_parallel"))
    j = json.loads((tmp_path / "j.jaxex.json").read_text())
    assert set(t) == set(j) | {"matmul_precision", "programs",
                               "process_groups"}
    assert (t["nr_devices"], t["batch"]) == (WORLD, BATCH)
    assert t["programs"] == ["bf16.pt2"] * WORLD
    assert (j["nr_devices"], j["batch"]) == (len(jax.devices()), BATCH)
    for key in ("model_name", "serving", "img_size", "num_classes",
                "with_cam", "calibration", "input", "mean", "std", "outputs",
                "seq_parallel"):
        assert t[key] == j[key], key


@pytest.mark.parametrize("mode", MODES)
def test_dp_artifact_matches_the_jax_dp_artifact(dp, zoos, tmp_path, mode):
    """The two ranks' outputs against the JAX ``--data_parallel`` artifact
    (its Pallas kernels in interpret mode) on the same 16 images: logits and
    CAMs within the bf16 class of tests/test_torch_export.py; and the
    port's one-rank artifact at batch 16 bit for bit."""
    assets, _ = dp
    x = _x()
    got = _served(assets["dir"] / f"{mode}.pt2", x)
    jout = tmp_path / "j.jaxex"
    jecli.main(_argv(jout, mode, assets, "--attn_impl", "pallas",
                     "--data_parallel"))
    mesh = jmesh.make_mesh((-1,), ("data",), devices=jax.devices())
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    want = [np.asarray(w.astype(jnp.float32)) for w in
            jax.export.deserialize(jout.read_bytes()).call(xs)]
    for name, i in (("logits", 0), ("cam", 2)):
        assert got[i].shape == want[i].shape, name
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=TOL,
                                   err_msg=name)
    assert np.all(got[2].max(axis=(1, 2)) == 1.0)
    one = tmp_path / "one.pt2"
    ecli.main(_port(one, mode, assets))
    alone = [o.float().numpy() for o in kops.load_program(
        str(one), "cpu").module()(torch.from_numpy(x))]
    # the plain versions compute each image alone: the same bits at 8 and 16
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g, a)


def test_dp_serve_artifact_on_two_ranks(dp, zoos, tmp_path, capsys):
    """``serve_artifact`` of the int8 artifact on its two ranks: rank 0
    writes the 20 overlays and prints the classes the one-rank artifact at
    batch 16 prints for the same JPEGs; rank 1 prints nothing."""
    assets, printed = dp
    served = printed[0][-1]
    assert "nr_devices=2" in served and printed[1][-1] == ""
    overlays = sorted(p.name for p in (assets["dir"] / "served2").iterdir())
    assert overlays == [f"im_{i:02d}_cam.jpg" for i in range(N_JPEGS)]
    one = tmp_path / "one.pt2"
    ecli.main(_port(one, "int8", assets))
    capsys.readouterr()
    tsa.main(["--artifact", str(one), "--images",
              str(assets["dir"] / "jpegs"), "--out", str(tmp_path / "s1"),
              "--threshold", "0.5"])

    def lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("  im_")]
    want = lines(capsys.readouterr().out)
    assert lines(served) == want and len(want) == N_JPEGS


def test_dp_export_on_one_rank_is_the_plain_artifact(dp, zoos, tmp_path):
    """Without a process group ``--data_parallel`` is the plain artifact:
    ``nr_devices`` 1, the global batch, the same outputs as the export
    without the flag (``--serving off`` included: one rank holds the whole
    batch)."""
    assets, _ = dp
    x = torch.from_numpy(_x(3))
    outs = {}
    for name, extra in (("dp", ("--data_parallel", "--check")),
                        ("plain", ())):
        out = tmp_path / f"{name}.pt2"
        ecli.main(_port(out, "off", assets, *extra))
        meta = json.loads((tmp_path / f"{name}.pt2.json").read_text())
        assert (meta["nr_devices"], meta["batch"]) == (1, BATCH)
        outs[name] = kops.load_program(str(out), "cpu").module()(x)
    for a, b in zip(outs["dp"], outs["plain"]):
        assert torch.equal(a, b)
