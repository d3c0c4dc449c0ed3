"""The port's serving artifact on the CPU: the ``vitcam`` custom ops
(``kernels/ops.py``, the sequence-parallel kernel's too) against their fake
implementations, the exported graph (the kernels as ops, no plain version
inlined), ``cli.export --check`` in the four serving modes, the port's
artifact against the JAX package's artifact of the same weights and
calibration, ``serve_artifact`` against the live CAMs and against the JAX
script, and the refusals.

A tiny ViT is registered in both zoos (as tests/test_torch_predict.py
does).  The exports run with ``--attn_impl kernel`` on the CPU, where every
op runs its kernel's plain version; the JAX ones with ``--attn_impl pallas``
(interpret mode).  The card-only test of the same CLI is
tests/test_torch_export_cuda.py.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import PIL.Image

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jconfigs
from vision_transformer_cam_tpu import serving as jserving
from vision_transformer_cam_tpu.cli import export as jecli
from vision_transformer_cam_tpu.io import weights as jwio
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.cam.render import _imwrite, overlay_cam
from vision_transformer_cam_tpu_torch.cli import export as ecli
from vision_transformer_cam_tpu_torch.data.transforms import (
    load_and_preprocess)
from vision_transformer_cam_tpu_torch.examples import serve_artifact as tsa
from vision_transformer_cam_tpu_torch.kernels import attention as ka
from vision_transformer_cam_tpu_torch.kernels import gemm
from vision_transformer_cam_tpu_torch.kernels import ops as kops

REPO = pathlib.Path(__file__).resolve().parents[1]
ZOO = "tinyexport"
DEPTH, HEADS = 4, 4
MODES = ("off", "bf16", "int8", "int8_hifi")
# port artifact vs JAX artifact, max abs deviation (tests/test_torch_vit.py,
# tests/test_torch_serving.py): float32 "off" the kernel-path classes (CAM
# 1e-5, logits 2e-4), the bf16 serving modes the bf16 class 1e-2
TOL = {"off": dict(cam=1e-5, logits=2e-4, head1=2e-4),
       **{m: dict(cam=1e-2, logits=1e-2, head1=1e-2)
          for m in ("bf16", "int8", "int8_hifi")}}


def _factory(pkg):
    def factory(num_classes=20, has_logits=False):
        return pkg.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                                depth=DEPTH, num_heads=HEADS,
                                num_classes=num_classes, mask_from=1,
                                top_k_patches=4)
    return factory


@pytest.fixture()
def zoos(monkeypatch):
    monkeypatch.setitem(configs.MODEL_ZOO, ZOO, _factory(configs))
    monkeypatch.setitem(jconfigs.MODEL_ZOO, ZOO, _factory(jconfigs))
    return ZOO


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """One weights file for both packages (a JAX ``vit.init`` tree with the
    qkv gain 10 of the validate fixtures, so that the mask engages) and one
    calibration batch."""
    d = tmp_path_factory.mktemp("export_assets")
    params = jvit.init(_factory(jconfigs)(), jax.random.key(0))
    params["blocks"]["attn"]["qkv"]["kernel"] = \
        params["blocks"]["attn"]["qkv"]["kernel"] * 10.0
    npz, calib = str(d / "w.npz"), str(d / "calib.npy")
    jwio.save_npz(npz, params)
    np.save(calib, np.random.default_rng(11).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    return {"npz": npz, "calib": calib}


def _argv(out, mode, assets=None, *extra):
    argv = ["--model_name", ZOO, "--serving", mode, "--batch", "2",
            "--out", str(out)]
    if assets:
        argv += ["--weights", assets["npz"], "--calib_npy", assets["calib"]]
    return argv + list(extra)


def _port_argv(out, mode, assets=None):
    return _argv(out, mode, assets, "--device", "cpu", "--attn_impl",
                 "kernel")


# ---------------------------------------------------------------------------
# (a) the ops against their fake implementations
# ---------------------------------------------------------------------------

def _qkv(kind, b=2, n=9, heads=2, dh=16, seed=0):
    """(qkv, scales) for kernel 1: float32 / bf16 without scales, int8_io
    (int8 qkv, per-head scales), int8_out (bf16 qkv, [1 / s_out])."""
    rng = np.random.default_rng(seed)
    c3 = 3 * heads * dh
    if kind == "int8_io":
        qkv = torch.from_numpy(rng.integers(-127, 128, size=(b, n, c3))
                               .astype(np.int8))
        scales = torch.from_numpy(rng.uniform(0.01, 0.03, 3 * heads + 1)
                                  .astype(np.float32))
        return qkv, scales
    qkv = torch.from_numpy(rng.standard_normal((b, n, c3)).astype(
        np.float32))
    if kind == "float32":
        return qkv, None
    qkv = qkv.to(torch.bfloat16)
    return qkv, (torch.tensor([20.0]) if kind == "int8_out" else None)


def _attention_cases():
    for kind in ("float32", "bfloat16", "int8_io", "int8_out"):
        for variant in ("plain", "headmean", "rollout"):
            yield kind, variant


@pytest.mark.parametrize("kind,variant", list(_attention_cases()))
def test_opcheck_attention(kind, variant):
    _opcheck_attention(kind, variant, dh=16)


@pytest.mark.parametrize("kind,variant", list(_attention_cases()))
def test_opcheck_attention_head_width_80(kind, variant):
    """The same at kernel 1's second compiled head width (ViT-H/14's)."""
    _opcheck_attention(kind, variant, dh=80)


def _opcheck_attention(kind, variant, dh):
    qkv, scales = _qkv(kind, dh=dh)
    b, n = qkv.shape[:2]
    bg = torch.zeros((b, n))
    bg[:, 5:] = 1.0
    common = (2, 0.25, -100.0)
    if variant == "plain":
        args = (qkv, bg, scales, *common, True, torch.bfloat16, 0)
        torch.library.opcheck(kops._attention, args)
        return
    joint = torch.eye(n).expand(b, n, n).contiguous() \
        if variant == "rollout" else None
    hm_dtype = torch.float32 if kind == "bfloat16" else None
    args = (qkv, bg, joint, scales, *common, variant == "headmean", True,
            hm_dtype, torch.bfloat16, 0)
    torch.library.opcheck(kops._attention_stats, args)


@pytest.mark.parametrize("with_hm", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 80])
def test_opcheck_attention_seq(dh, dtype, with_hm):
    """The sequence-parallel kernel's ops at ViT-B's and ViT-H/14's head
    widths: one rank's 5 query rows against the 10 gathered keys of a token
    axis of 9 (the last key padded), with the head mean (in float32 under
    bf16) and without."""
    rng = np.random.default_rng(dh)
    b, nq, np_, heads = 2, 5, 10, 2
    q, kv = (torch.from_numpy(rng.standard_normal((b, n, k * heads * dh))
                              .astype(np.float32)).to(dtype)
             for n, k in ((nq, 1), (np_, 2)))
    bg_k = torch.zeros((b, np_))
    bg_k[:, 4:] = 1.0
    common = (heads, dh ** -0.5, -100.0, True)
    if with_hm:
        hm_dtype = torch.float32 if dtype == torch.bfloat16 else None
        torch.library.opcheck(kops._seq_hm, (q, kv, bg_k[:, :nq], bg_k,
                                             *common, hm_dtype, 9))
    else:
        torch.library.opcheck(kops._seq, (q, kv, bg_k[:, :nq], bg_k,
                                          *common, 9))


def _gemm_operands(x_dtype, seed=1, m=6, k=32, n=24):
    rng = np.random.default_rng(seed)
    if x_dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    else:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(x_dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    cs = torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, wq, cs, bias


def _gemm_cases():
    for route in gemm.ROUTES:
        for epilogue in gemm.EPILOGUES:
            for x_dtype in (torch.float32, torch.bfloat16, torch.int8):
                if route == "fused" and x_dtype == torch.int8:
                    continue
                yield route, epilogue, x_dtype


@pytest.mark.parametrize("route,epilogue,x_dtype", list(_gemm_cases()))
def test_opcheck_linear_int8(route, epilogue, x_dtype):
    x, wq, cs, bias = _gemm_operands(x_dtype)
    a = torch.tensor(0.02 if route == "qlinear" else 50.0)
    out_scales = {"float": None, "requant": torch.tensor([0.05, 0.06, 0.07]),
                  "gelu": torch.tensor([0.04])}[epilogue]
    groups = 3 if epilogue == "requant" else 1
    torch.library.opcheck(kops._linear_int8, (
        x, wq, cs, bias, a, route, epilogue, out_scales, groups, True,
        torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_ln_quant(dtype):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 5, 32)).astype(np.float32)).to(dtype)
    torch.library.opcheck(kops._ln_quant, (x, torch.ones(32), torch.zeros(32),
                                           1e-6, torch.tensor(30.0)))


def _mlp_operands(dtype, c=32, hid=64, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(0.1 * rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return t(2, 5, c), t(hid, c), t(hid), t(c, hid), t(c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_mlp_fused(dtype):
    torch.library.opcheck(kops._mlp_fused, (*_mlp_operands(dtype), True))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("biases", [True, False])
def test_opcheck_mlp_fused_int8(out_dtype, biases):
    rng = np.random.default_rng(4)
    c, hid = 32, 64
    x = torch.from_numpy(rng.standard_normal((2, 5, c)).astype(np.float32))
    w1q = torch.from_numpy(rng.integers(-127, 128, (hid, c)).astype(np.int8))
    w2q = torch.from_numpy(rng.integers(-127, 128, (c, hid)).astype(np.int8))
    cs1, cs2 = torch.full((hid,), 1e-4), torch.full((c,), 1e-4)
    b1, b2 = (torch.zeros(hid), torch.zeros(c)) if biases else (None, None)
    torch.library.opcheck(kops._mlp_fused_int8, (
        x, w1q, cs1, b1, w2q, cs2, b2, torch.tensor(40.0), torch.tensor(30.0),
        True, out_dtype))


@pytest.mark.parametrize("rollout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_attention_block(dtype, rollout):
    rng = np.random.default_rng(5)
    b, n, heads, dh = 2, 9, 2, 16
    c = heads * dh

    def t(*shape):
        return torch.from_numpy(0.3 * rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    args = (t(b, n, c), t(b, n, c), t(3 * c, c), t(3 * c), t(c, c), t(c),
            torch.zeros((b, n)))
    if rollout:
        joint = torch.eye(n).expand(b, n, n).contiguous()
        torch.library.opcheck(kops._block_rollout,
                              (*args, joint, heads, 0.25, -100.0, True))
    else:
        torch.library.opcheck(kops._block, (*args, heads, 0.25, -100.0, True))


# ---------------------------------------------------------------------------
# (b) the exported graph holds the kernels as ops
# ---------------------------------------------------------------------------

# what the plain versions compute and no other part of the serving graph
# does: the softmax's exp, the attention and int8 products, the int8 roundings
PLAIN_OPS = ("aten.exp.default", "aten._softmax.default",
             "aten.softmax.int", "aten.matmul.default", "aten.bmm.default",
             "aten.mm.default", "aten.round.default")


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_hifi"])
def test_exported_graph_holds_the_kernel_ops(zoos, tmp_path, mode):
    args = ecli.build_parser().parse_args(
        _port_argv(tmp_path / "a.pt2", mode))
    fn, cfg, _ = ecli.build_fn(args)
    with torch.no_grad():
        ep = torch.export.export(fn, (torch.zeros((2, 32, 32, 3)),),
                                 strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    int8 = mode != "bf16"
    assert targets.count("vitcam.masked_attention_fused_stats.default") == \
        DEPTH
    assert targets.count("vitcam.linear_int8.default") == \
        (1 + 4 * DEPTH if int8 else 0)
    assert not [t for t in targets if t in PLAIN_OPS]
    assert not [n for n in ep.graph.nodes if any(
        getattr(v, "dtype", None) == torch.float64 for v in (
            n.meta.get("val") if isinstance(n.meta.get("val"), (tuple, list))
            else [n.meta.get("val")]))]


# ---------------------------------------------------------------------------
# (c) the --check round trip and the sidecar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_export_check_roundtrip(zoos, tmp_path, capsys, mode):
    out = tmp_path / "tiny.pt2"
    before = (ka.launches, gemm.linear_int8_launches)
    assert ecli.main(_port_argv(out, mode) + ["--check"]) == str(out)
    assert "bit-identical" in capsys.readouterr().out
    assert (ka.launches, gemm.linear_int8_launches) == before  # CPU: plain
    meta = json.loads((tmp_path / "tiny.pt2.json").read_text())
    assert (meta["serving"], meta["batch"], meta["platforms"],
            meta["nr_devices"], meta["matmul_precision"]) == \
        (mode, 2, ["cpu"], 1, "highest")
    assert (meta["calibration"] is None) == (not mode.startswith("int8"))


def test_sidecar_keys_equal_the_jax_sidecar(zoos, tmp_path):
    ecli.main(_port_argv(tmp_path / "t.pt2", "int8"))
    jecli.main(_argv(tmp_path / "j.jaxex", "int8"))
    t = json.loads((tmp_path / "t.pt2.json").read_text())
    j = json.loads((tmp_path / "j.jaxex.json").read_text())
    assert set(t) == set(j) | {"matmul_precision"}
    for key in ("model_name", "serving", "batch", "img_size", "num_classes",
                "with_cam", "calibration", "input", "mean", "std", "outputs",
                "nr_devices", "seq_parallel", "scoped_vmem_kib"):
        assert t[key] == j[key], key


def test_no_cam_exports_two_outputs(zoos, tmp_path, capsys):
    out = tmp_path / "nocam.pt2"
    ecli.main(_port_argv(out, "bf16") + ["--no-cam", "--check"])
    assert "(2 outputs, bit-identical)" in capsys.readouterr().out
    assert json.loads((tmp_path / "nocam.pt2.json").read_text())[
        "outputs"] == "(logits, head1_logits)"


# ---------------------------------------------------------------------------
# (d) the port's artifact against the JAX artifact
# ---------------------------------------------------------------------------

def _top_k_sets(tout, mode, assets, x):
    """The top-k patch sets of both packages' live forwards, and JAX's
    normalized last-layer patch weights (mask14) that rank them."""
    args = ecli.build_parser().parse_args(_port_argv(tout, mode, assets))
    fn, _, _ = ecli.build_fn(args)
    with torch.no_grad():
        got = fn.model._forward(torch.from_numpy(x), False, None, False,
                                False, False, True).top_patch_idx.numpy()
    jcfg = _factory(jconfigs)().replace(representation_size=None)
    params = jwio.load_weights(assets["npz"], jcfg, del_keys=())
    calib = np.load(assets["calib"]) if mode.startswith("int8") else None
    params, jcfg = jserving.apply_serving_mode(params, jcfg, mode,
                                               calib_images=calib)
    jcfg = jcfg.replace(attn_impl="pallas")
    out = jvit.forward(params, jnp.asarray(x), jcfg, need_rollout=True)
    mask14, _ = jvit._mask_from_cls_row(out.attn_cls_rows[-1], jcfg)
    return got, np.asarray(out.top_patch_idx), \
        np.asarray(mask14.astype(jnp.float32))


@pytest.mark.parametrize("mode", MODES)
def test_artifact_matches_the_jax_artifact(zoos, tmp_path, assets, mode):
    """logits and the CAM within TOL on every image.  head1 averages the
    top-k patches: where bf16 rounding in other places reorders two patches
    that tie in JAX's own ranking (within the bf16 class, 1e-2 of mask14),
    the top-k sets differ and head1 is compared on the other images only;
    every other difference of the sets fails."""
    tout, jout = tmp_path / "t.pt2", tmp_path / "j.jaxex"
    ecli.main(_port_argv(tout, mode, assets) + ["--check"])
    jecli.main(_argv(jout, mode, assets, "--attn_impl", "pallas"))
    x = np.random.default_rng(9).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    got = [g.float().numpy() for g in
           torch.export.load(str(tout)).module()(torch.from_numpy(x))]
    want = [np.asarray(w.astype(jnp.float32)) for w in
            jax.export.deserialize(jout.read_bytes()).call(jnp.asarray(x))]
    tol = TOL[mode]
    for name, g, w in zip(("logits", "head1", "cam"), got, want):
        assert g.shape == w.shape, name
    for name, i in (("logits", 0), ("cam", 2)):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=tol[name],
                                   err_msg=name)
    assert np.all(got[2].max(axis=(1, 2)) == 1.0)
    t_idx, j_idx, mask14 = _top_k_sets(tout, mode, assets, x)
    same = [set(a) == set(b) for a, b in zip(t_idx.tolist(),
                                             j_idx.tolist())]
    if mode == "off":
        assert all(same)
    for i, ok in enumerate(same):
        if ok:
            np.testing.assert_allclose(got[1][i], want[1][i], rtol=0,
                                       atol=tol["head1"], err_msg="head1")
            continue
        kth = np.sort(mask14[i])[::-1][len(j_idx[i]) - 1]
        swapped = sorted(set(t_idx[i]) ^ set(j_idx[i]))
        assert np.all(np.abs(mask14[i][swapped] - kth) <= 1e-2), \
            (i, swapped, mask14[i][swapped], kth)
    assert any(same)


# ---------------------------------------------------------------------------
# (e) serving from the artifact
# ---------------------------------------------------------------------------

def _jpegs(root, n=5, size=40):
    rng = np.random.default_rng(6)
    root.mkdir()
    for i in range(n):
        arr = rng.integers(0, 256, size=(size + 3 * i, size, 3),
                           dtype=np.uint8)
        PIL.Image.fromarray(arr).save(root / f"im{i}.jpg")
    return sorted(str(p) for p in root.glob("*.jpg"))


def _load_root(rel, name):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(text):
    return [line for line in text.splitlines() if line.startswith("  im")]


def test_serve_artifact_writes_the_live_overlays(zoos, tmp_path, assets,
                                                 capsys):
    """5 images at batch 2 (a padded tail): every overlay byte-identical to
    ``cam/render.overlay_cam`` of the live function's CAM."""
    out = tmp_path / "a.pt2"
    argv = _port_argv(out, "int8", assets)
    ecli.main(argv)
    paths = _jpegs(tmp_path / "jpegs")
    assert tsa.main(["--artifact", str(out), "--images",
                     str(tmp_path / "jpegs"), "--out",
                     str(tmp_path / "served")]) == 0
    assert len(_printed(capsys.readouterr().out)) == len(paths)
    fn, _, _ = ecli.build_fn(ecli.build_parser().parse_args(argv))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for lo in range(0, len(paths), 2):
        chunk = paths[lo:lo + 2]
        x = np.zeros((2, 32, 32, 3), np.float32)
        for i, p in enumerate(chunk):
            x[i] = load_and_preprocess(p, 32, mean, std)
        with torch.no_grad():
            cam = fn(torch.from_numpy(x))[2].float().numpy().astype(
                np.float64)
        for i, p in enumerate(chunk):
            name = os.path.splitext(os.path.basename(p))[0]
            want = tmp_path / f"want_{name}.jpg"
            bgr = np.asarray(PIL.Image.open(p).convert("RGB"))[..., ::-1]
            _imwrite(str(want), overlay_cam(cam[i], bgr))
            assert (tmp_path / "served" / f"{name}_cam.jpg").read_bytes() == \
                want.read_bytes(), name


def test_serve_artifact_prints_the_jax_scripts_classes(zoos, tmp_path,
                                                       assets, capsys):
    """The paired float32 "off" artifacts of the same weights: the port's
    script prints the JAX script's class lines (threshold 0.5, so that
    classes are printed)."""
    tout, jout = tmp_path / "t.pt2", tmp_path / "j.jaxex"
    ecli.main(_port_argv(tout, "off", assets))
    jecli.main(_argv(jout, "off", assets, "--attn_impl", "pallas"))
    _jpegs(tmp_path / "jpegs")
    capsys.readouterr()
    jsa = _load_root("examples/serve_artifact.py", "jax_serve_artifact")
    common = ["--images", str(tmp_path / "jpegs"), "--threshold", "0.5"]
    jsa.main(["--artifact", str(jout), "--out", str(tmp_path / "js")]
             + common)
    want = _printed(capsys.readouterr().out)
    tsa.main(["--artifact", str(tout), "--out", str(tmp_path / "ts")]
             + common)
    got = _printed(capsys.readouterr().out)
    assert got == want and len(got) == 5
    assert any(":" in line and "none" not in line for line in got)


# ---------------------------------------------------------------------------
# (f) refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,match", [
    (["--data_parallel", "--platform", "cuda"], "--platform cuda"),
    (["--seq_parallel", "2"], "does not divide the 1 rank"),
    (["--platform", "cuda"], "--platform cuda"),
])
def test_export_refuses(zoos, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        ecli.main(_port_argv(tmp_path / "a.pt2", "bf16") + extra)
    assert not (tmp_path / "a.pt2").exists()


def test_export_refuses_a_weights_directory(zoos, tmp_path):
    with pytest.raises(ValueError, match="directory"):
        ecli.main(_port_argv(tmp_path / "a.pt2", "bf16")
                  + ["--weights", str(tmp_path)])


def test_export_runs_on_the_card_unless_asked(zoos, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ecli.main(_argv(tmp_path / "a.pt2", "bf16"))


@pytest.mark.parametrize("meta,match", [
    ({"platforms": ["cuda"]}, "has none"),
    ({"nr_devices": 2}, "2 devices"),
    ({"with_cam": False}, "no-cam"),
])
def test_serve_artifact_refuses(tmp_path, monkeypatch, meta, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    art = tmp_path / "a.pt2"
    sidecar = {"platforms": ["cpu"], "nr_devices": 1, "with_cam": True,
               "batch": 2, "img_size": 32, **meta}
    (tmp_path / "a.pt2.json").write_text(json.dumps(sidecar))
    with pytest.raises(SystemExit, match=match):
        tsa.main(["--artifact", str(art), "--images", str(tmp_path)])
