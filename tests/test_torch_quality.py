"""The quality protocol on trained weights (the port's
``scripts.quality_eval``, ``scripts.seg_diagnose`` and
``scripts.precision_ladder``) against the TPU package's scripts of the same
names, on the CPU.

The JAX scripts are loaded from ``scripts/`` with importlib.  Both sides'
``configs.resolve_model`` is monkeypatched to a tiny ViT (img 32, patch 8,
C = 32, depth 6, 2 heads, top-k 8: N = 17, the mask feedback engaging from
block 4).  The same JAX ``vit.init`` is carried across with
``io.weights.state_dict_from_jax_params``; JAX's kernel paths run their
Pallas kernels in interpret mode, the port's kernel wrappers their plain
versions.  The tests marked ``cuda`` hold the card against the CPU; they
run on a GPU machine without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_quality.py
"""

import ast
import importlib.util
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.scripts import precision_ladder as tpl
from vision_transformer_cam_tpu_torch.scripts import quality_eval as tqe
from vision_transformer_cam_tpu_torch.scripts import seg_diagnose as tsd

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=6, num_heads=2,
            top_k_patches=8)
# attention far from uniform: on make_batch images the bg mask engages from
# block 4 (at 10 it never engages; at 20 and past most patches are masked)
QKV_GAIN = 14.0


def _load_jax_script(name):
    """The TPU package's scripts/<name>.py as a module (under a private
    name: ``seg_diagnose`` imports ``quality_eval`` by its plain name)."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


try:  # the GPU machine has no jax: there only the cuda-marked tests run
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu import configs as jcfgs
    from vision_transformer_cam_tpu.models import vit as jvit
    jqe = _load_jax_script("quality_eval")
except ImportError:
    jax = None


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")


def _jtiny(num_classes=20, **_):
    return jcfgs.ViTCAMConfig(num_classes=num_classes, **TINY)


def _ttiny(num_classes=20, **_):
    return tcfgs.ViTCAMConfig(num_classes=num_classes, **TINY)


@pytest.fixture
def tiny(needs_jax, monkeypatch):
    monkeypatch.setattr(jcfgs, "resolve_model", lambda name: _jtiny)
    monkeypatch.setattr(tcfgs, "resolve_model", lambda name: _ttiny)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(seed=0, gain=QKV_GAIN):
    """The JAX init of the tiny model (float32), qkv scaled by ``gain``."""
    params = jvit.init(_jtiny().replace(representation_size=None),
                       jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * gain
    return params


def _port_model(params, cfg):
    net = tqe.ViTCAM(cfg, device="cpu")
    tweights.load_state_dict(
        net, tweights.state_dict_from_jax_params(_np_tree(params), cfg))
    return net


# ---------------------------------------------------------------------------
# the data generator and the host metrics
# ---------------------------------------------------------------------------

def test_module_constants_equal(needs_jax):
    for name in ("NUM_CLASSES", "CLASS_COLOR", "CLASS_FREQ", "N_PRIM",
                 "PRIM_COLOR", "PRIM_FREQ", "PAIRS"):
        np.testing.assert_array_equal(np.asarray(getattr(tqe, name)),
                                      np.asarray(getattr(jqe, name)))


@pytest.mark.parametrize("seed", [0, 1234, 9999])
@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(pairs=True),
                                dict(max_objects=3, size_lo=4, size_hi=2)],
                         ids=["single", "pairs", "three-objects"])
def test_make_batch_bit_for_bit(needs_jax, seed, with_seg, kw):
    got = tqe.make_batch(seed, 6, img=48, with_seg=with_seg, **kw)
    want = jqe.make_batch(seed, 6, img=48, with_seg=with_seg, **kw)
    assert len(got) == len(want) == (3 if with_seg else 2)
    for g, w in zip(got[:2], want[:2]):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if with_seg:
        assert got[2].dtype == np.uint8
        np.testing.assert_array_equal(got[2], want[2])


def _margin_inputs(seed, flip=0.02):
    """A truth row and a mode row whose cls rows differ a little, so that
    some mask decisions and top-16 sets flip."""
    rng = np.random.default_rng(seed)
    L, B, N, K = 6, 5, 17, 8
    rows_t = rng.dirichlet(np.ones(N) * 0.5, size=(L, B)).astype(np.float32)
    rows_m = np.abs(rows_t + rng.normal(0, flip, rows_t.shape)) \
        .astype(np.float32)
    rows_m /= rows_m.sum(-1, keepdims=True)

    def topi(rows):
        m = jqe._mask_stack(rows, 1)[-1]
        return np.argsort(-m, axis=-1, kind="stable")[:, :K]
    truth = {"cls_rows": rows_t, "topi": topi(rows_t)}
    row = {"cls_rows": rows_m, "topi": topi(rows_m)}
    return truth, row


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_stack_and_tie_margins(needs_jax, seed):
    truth, row = _margin_inputs(seed)
    np.testing.assert_allclose(tqe._mask_stack(truth["cls_rows"], 1),
                               jqe._mask_stack(truth["cls_rows"], 1),
                               rtol=0, atol=1e-12)
    cfg = _ttiny()
    got = tqe.tie_margins(dict(row), truth, cfg)
    want = jqe.tie_margins(dict(row), truth, _jtiny())
    assert got["mask_flip_frac"] > 0
    for k in ("mask_flip_frac", "tie_dist_mask", "tie_dist_top16"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the fine-tune
# ---------------------------------------------------------------------------

# 3 steps at batch 4, bf16 compute over float32 masters, JAX's Pallas
# kernels in interpret mode against the port's plain versions: the two round
# bf16 activations after sums in other orders, an ulp (2^-8 relative) apart
# at places.  Measured on the CPU: the printed losses 2.6e-4 apart at step 0
# (same weights) and 2.2e-3 at step 2 (another batch); trained leaves 6.0e-6
# apart.  AdamW's first updates are about lr in size whatever the gradient's,
# so a flipped sign where a gradient is near 0 moves a leaf by up to 2 lr a
# step: 6.4e-6 over the three steps (lr = 5e-4 * 4 / 512 after warm-up from
# 1e-6).  The bounds: 5e-3 on the losses, 1e-5 on the leaves (a wrong
# learning rate or schedule moves them by far more).
FT_TOL = {"loss": 5e-3, "param": 1e-5}


def _losses(text):
    return [float(m) for m in re.findall(r"loss (\S+)", text)]


def test_finetune_freeze_parity(tiny, capsys):
    steps, batch, freeze = 3, 4, 4
    jcfg = jqe.configs.resolve_model("tiny")(num_classes=20).replace(
        representation_size=None)
    init = jvit.init(jcfg.replace(param_dtype=jnp.float32),
                     jax.random.key(0))
    jparams = jqe.finetune(steps, batch, "tiny", seed=0, freeze_below=freeze)
    jlosses = _losses(capsys.readouterr().out)
    tcfg = tqe.train_config("tiny")
    sd0 = tweights.state_dict_from_jax_params(_np_tree(init), tcfg)
    history = []
    net = tqe.finetune(steps, batch, "tiny", seed=0, freeze_below=freeze,
                       device="cpu", init_state=sd0, history=history)
    capsys.readouterr()
    assert [h[0] for h in history] == [0, 2]
    tlosses = [h[1] for h in history]
    assert len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=0,
                               atol=FT_TOL["loss"])

    want = tweights.state_dict_from_jax_params(_np_tree(jparams), tcfg)
    got = net.state_dict()
    moved_t = {k for k in got if not torch.equal(got[k], sd0[k])}
    moved_j = {k for k in want if not torch.equal(want[k], sd0[k])}
    assert moved_t == moved_j
    frozen = {k for k in got if k.startswith(tuple(
        f"blocks.{i}." for i in range(freeze)))}
    assert frozen and not frozen & moved_t
    assert {k for k in got if k.startswith("blocks.5.")} <= moved_t
    for k in frozen:     # bit for bit the init, on both sides
        assert torch.equal(got[k], sd0[k]) and torch.equal(want[k], sd0[k])
    worst = max(float((got[k] - want[k]).abs().max()) for k in got)
    assert worst <= FT_TOL["param"], worst


def test_freeze_mask_names_the_blocks():
    net = tqe.ViTCAM(_ttiny(), device="cpu")
    mask = tqe.freeze_mask(net, 4)
    assert set(mask) == {n for n, _ in net.named_parameters()}
    for name, trains in mask.items():
        in_frozen = re.match(r"blocks\.[0-3]\.", name) is not None
        assert trains == (not in_frozen), name


# ---------------------------------------------------------------------------
# eval_mode: every row of main
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_rows():
    """JAX and port rows (truth, sabotaged, bf16, int8_hifi, int8, r2) on
    one set of carried weights and make_batch images, as the two mains build
    them."""
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")
    import copy
    from vision_transformer_cam_tpu.ops.quant import (calibrate_act_scales,
                                                      quantize_params)
    params = _jax_params()
    jbase = _jtiny().replace(representation_size=None)
    images, labels, seg_gt = jqe.make_batch(9999, 12, img=32, with_seg=True)
    timages, tlabels, tseg = tqe.make_batch(9999, 12, img=32, with_seg=True)
    np.testing.assert_array_equal(tseg, seg_gt)
    broken = jcfgs.PseudoSegConfig(bg_rollout_threshold=0.5)
    tbroken = tcfgs.PseudoSegConfig(bg_rollout_threshold=0.5)

    f32 = jbase.replace(dtype=jnp.float32, param_dtype=jnp.float32,
                        matmul_precision="highest", per_sample_mask_norm=True)
    jt = jqe.eval_mode("truth", params, f32, images, labels, seg_gt=seg_gt)
    jrows = {"truth": jt,
             "sabotaged": jqe.eval_mode("bad", params, f32, images, labels,
                                        seg_gt=seg_gt, pcfg=broken)}
    bf = jbase.replace(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                       attn_impl="pallas", gelu_approx=True,
                       softmax_clamp=True, per_sample_mask_norm=True)
    pbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    jrows["bf16"] = jqe.eval_mode("bf16", pbf, bf, images, labels, jt,
                                  seg_gt)
    calib, _ = jqe.make_batch(777, 16, img=32)
    pq = quantize_params(pbf, act_scales=calibrate_act_scales(pbf, bf, calib))
    jrows["int8_hifi"] = jqe.eval_mode("hifi", pq,
                                       bf.replace(int8_attn_out=True),
                                       images, labels, jt, seg_gt)
    jrows["int8"] = jqe.eval_mode("int8", pq, bf.replace(int8_attn_io=True),
                                  images, labels, jt, seg_gt)
    pq_t = copy.deepcopy(pq)
    qkv = pq_t["blocks"]["attn"]["qkv"]
    qkv["out_scales"] = jnp.max(qkv["out_scales"], axis=2)
    jrows["r2"] = jqe.eval_mode("r2", pq_t, bf.replace(int8_attn_io=True),
                                images, labels, jt, seg_gt)

    tbase = _ttiny().replace(representation_size=None)
    m32 = _port_model(params, tqe.truth_config(tbase))
    tt = tqe.eval_mode("truth", m32, timages, tlabels, seg_gt=tseg)
    trows = {"truth": tt,
             "sabotaged": tqe.eval_mode("bad", m32, timages, tlabels,
                                        seg_gt=tseg, pcfg=tbroken)}
    bfc = tqe.bf16_config(tbase)
    mbf = tqe.with_config(m32, bfc)
    trows["bf16"] = tqe.eval_mode("bf16", mbf, timages, tlabels, tt, tseg)
    tcalib, _ = tqe.make_batch(777, 16, img=32)
    hifi, int8, r2 = tqe.int8_models(mbf, bfc, tcalib)
    for name, m in (("int8_hifi", hifi), ("int8", int8), ("r2", r2)):
        trows[name] = tqe.eval_mode(name, m, timages, tlabels, tt, tseg)
    return jrows, trows, m32


def test_eval_truth_row_matches(eval_rows):
    jrows, trows, _ = eval_rows
    for name in ("truth", "sabotaged"):
        j, t = jrows[name], trows[name]
        for k in ("mAP_196patch", "mAP_16patch", "miou"):
            assert t[k] == j[k], (name, k, t[k], j[k])
        np.testing.assert_allclose(t["cam"], j["cam"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(t["cls_rows"], j["cls_rows"], rtol=0,
                                   atol=1e-5)
        for a, b in zip(t["topi"], j["topi"]):
            assert set(a.tolist()) == set(np.asarray(b).tolist())
        np.testing.assert_array_equal(t["seg"], j["seg"])
    # the mask engages on these weights (blocks >= mask_from)
    masked = tqe._mask_stack(trows["truth"]["cls_rows"], 1)[4:] < 0.25
    assert masked.mean() > 0.05


def test_truth_flushes_denormals_as_jax(eval_rows):
    """XLA flushes float32 denormals to zero, on the TPU and on the CPU
    alike: the cls row of a patch the feedback masked (its logit s - 100,
    exp(-100) a denormal) is exactly 0.  The port's float32 eager truth
    must read 0 at the same places, and hold no denormal."""
    jrows, trows, _ = eval_rows
    tiny = np.finfo(np.float32).tiny
    for name in ("truth", "sabotaged"):
        j, t = np.asarray(jrows[name]["cls_rows"]), trows[name]["cls_rows"]
        assert (j == 0).any(), name      # the flush bites on these weights
        np.testing.assert_array_equal(t == 0, j == 0)
        assert not ((t != 0) & (np.abs(t) < tiny)).any(), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_breaks_ties_as_jax(needs_jax, seed):
    """jax.lax.top_k puts the lower index first among equal values; the
    port's top-16 selection too, so that patches tied at 0 (masked) are
    chosen alike on every device."""
    from vision_transformer_cam_tpu_torch.models.vit import _top_k
    rng = np.random.default_rng(seed)
    x = rng.random((8, 49)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0.0
    x[:, 5] = x[:, 9]
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 16)[1])
    np.testing.assert_array_equal(_top_k(torch.from_numpy(x), 16).numpy(),
                                  want)


@pytest.mark.parametrize("mode", ["bf16", "int8_hifi", "int8", "r2"])
def test_eval_serving_rows_match(eval_rows, mode):
    """bf16 / int8 class of tests/test_torch_serving.py: CAM <= 1e-2 against
    JAX's row (JAX on its Pallas path, which the int8 flags need); every key
    of the JAX row present and finite where JAX's is."""
    jrows, trows, _ = eval_rows
    j, t = jrows[mode], trows[mode]
    assert set(t) == set(j)
    np.testing.assert_allclose(t["cam"], j["cam"], rtol=0, atol=1e-2)
    assert abs(t["mAP_196patch"] - j["mAP_196patch"]) <= 2e-2
    for k in ("cam_max_dev", "cam_mean_dev", "cam_p999", "top16_overlap",
              "seg_match", "mask_flip_frac"):
        assert np.isfinite(t[k]), k


def test_r2_scales_are_the_per_tensor_max(eval_rows):
    _, _, m32 = eval_rows
    bfc = tqe.bf16_config(m32.cfg)
    calib, _ = tqe.make_batch(777, 16, img=32)
    _, int8, r2 = tqe.int8_models(tqe.with_config(m32, bfc), bfc, calib)
    for b8, b2 in zip(int8.blocks, r2.blocks):
        osc = b8.attn.qkv.out_scales
        assert tuple(b2.attn.qkv.out_scales.shape) == tuple(osc.shape)
        torch.testing.assert_close(
            b2.attn.qkv.out_scales,
            osc.amax(dim=1, keepdim=True).expand_as(osc), rtol=0, atol=0)
        assert torch.equal(b2.attn.qkv.weight_q, b8.attn.qkv.weight_q)


def test_main_runs_every_row_on_the_cpu(tiny, tmp_path, monkeypatch, capsys):
    """main: fine-tune, save, load again, the rows in order with the table;
    the second run reads the saved weights and gives the same numbers."""
    path = str(tmp_path / "q" / "tiny.pt")
    argv = ["--steps", "2", "--batch", "4", "--eval", "8", "--freeze", "4",
            "--sabotage", "--params", path, "--device", "cpu"]
    first = tqe.main(argv)
    out = capsys.readouterr().out
    assert os.path.exists(path) and "saved fine-tuned params" in out
    assert [r["mode"] for r in first["rows"]] == [
        "f32 exact (truth)", "bf16+kernel+tanh+clamp (serving)",
        "int8_hifi (W8A8, float attn, int8-OUT)",
        "int8 + attn I/O per-head (default)",
        "int8 + attn I/O per-tensor (r2)"]
    assert first["sabotaged"] is not None and "sabotaged bg gate" in out
    assert len(first["history"]) == 2
    second = tqe.main(argv)
    assert "loaded fine-tuned params" in capsys.readouterr().out
    for a, b in zip(first["rows"], second["rows"]):
        np.testing.assert_array_equal(a["cam"], b["cam"])
    with pytest.raises(SystemExit):
        tqe.main(["--stepz", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the sabotage power test, on the port's generator and pseudo-seg chain
# ---------------------------------------------------------------------------

def test_sabotage_power_of_bg_gate():
    """A copy of tests/test_pseudo_seg.py's power test on the port: a
    fabricated localizing output whose statistics mirror a trained model
    (cos maps saturated, the bg rollout values high on GT-fg patches), the
    port's make_batch and pseudo_seg_batch.  The truth gate gives a high
    mIoU, the sabotaged one (0.05 -> 0.5) degrades it, no gate craters
    it."""
    from vision_transformer_cam_tpu_torch.cam.pseudo_seg import \
        pseudo_seg_batch
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAMOutput
    from vision_transformer_cam_tpu_torch.utils.metrics import ConfusionMatrix

    NC, B, IMG = 20, 24, 64
    cfg = tcfgs.ViTCAMConfig(img_size=IMG, patch_size=8, embed_dim=18,
                             num_classes=NC, depth=6, num_heads=1,
                             top_k_patches=8)
    g, P, N = cfg.grid_size, cfg.grid_size ** 2, cfg.seq_len
    K, D = cfg.top_k_patches, cfg.embed_dim
    r = np.random.RandomState(0)
    _, labels, segs = tqe.make_batch(1234, B, img=IMG, with_seg=True)
    labels = labels.numpy()
    px = IMG // g
    fg_patch = (segs.reshape(B, g, px, g, px) > 0).mean(
        axis=(2, 4)).reshape(B, P) > 0.5

    cls_rows = np.full((cfg.depth, B, N), 1.0 / N, np.float32)
    head1_logits = np.full((B, NC), -5.0, np.float32)
    tokens = np.zeros((B, N, D), np.float32)
    top_embeds = np.zeros((B, K, D), np.float32)
    top_idx = np.zeros((B, K), np.int64)
    kernel_t = np.zeros((NC, D), np.float32)
    for b in range(B):
        c = int(np.argmax(labels[b]))
        head1_logits[b, c] = 5.0       # sigmoid 0.993 >= cls_threshold 0.9
        kernel_t[c, :] = 1.0           # every feature -> the predicted class
        v = np.full(P, 0.005, np.float64)
        v[fg_patch[b]] = r.uniform(0.10, 1.0, int(fg_patch[b].sum()))
        cls_rows[5:, b, 1:] = v[None, :]   # bg_blocks_from=5 reads these
        tokens[b, 1:, D - 2] = 1.0         # winner_v ~0.92 everywhere
        top_idx[b] = np.argsort(-v)[:K]
        for k in range(K):
            top_embeds[b, k, 2 * k:2 * k + 2] = 0.3
            top_embeds[b, k, D - 2] = 1.0
    t = torch.from_numpy
    out = ViTCAMOutput(
        logits=t(head1_logits), head1_logits=t(head1_logits),
        attn_cls_rows=t(cls_rows), top_patch_embeds=t(top_embeds),
        top_patch_idx=t(top_idx), head1_kernel=t(kernel_t.T.copy()),
        tokens_prenorm=t(tokens))

    def miou(pcfg):
        preds = pseudo_seg_batch(out, cfg, pcfg, [(IMG, IMG)] * B)
        preds = np.stack(preds).astype(np.int64)
        preds[preds > NC] = 0
        cm = ConfusionMatrix(NC)
        cm.update(segs.reshape(-1).astype(np.int64), preds.reshape(-1))
        _, _, iou = cm.compute()
        return float(np.nanmean(np.asarray(iou)) * 100)

    good = miou(tcfgs.PseudoSegConfig())
    bad = miou(tcfgs.PseudoSegConfig(bg_rollout_threshold=0.5))
    off = miou(tcfgs.PseudoSegConfig(bg_rollout_threshold=0.0))
    assert good >= 50, f"truth mIoU {good}: the gate should localize"
    assert bad <= 0.8 * good, f"sabotage {bad} vs truth {good}: no power"
    assert off <= good / 5, f"gate-off {off} vs truth {good}"


# ---------------------------------------------------------------------------
# seg_diagnose
# ---------------------------------------------------------------------------

def _parse_diag(text):
    """The numbers of the JAX script's printed lines."""
    res = {"masked_frac": [tuple(float(x) for x in m) for m in re.findall(
        r"masked-frac mean (\S+) med (\S+) max (\S+)", text)]}
    for key, label in (("gt_fg", "GT fg fraction"),
                       ("fg_pass", "fg gate pass fraction"),
                       ("bg_pass", "bg gate pass fraction"),
                       ("fg_iou", "fg-gate-vs-GT-fg IoU"),
                       ("bg_iou", "bg-gate-vs-GT-fg IoU"),
                       ("nonzero", "final nonzero fraction"),
                       ("end_fg_iou", "final fg-mask IoU"),
                       ("filler", "top-16 filler fraction"),
                       ("cls_acc", "top-16 class accuracy @center")):
        res[key] = float(re.search(re.escape(label) + r"\s+(\S+)",
                                   text).group(1))
    m = re.search(r"winner_v mean on GT-fg (\S+) / on GT-bg (\S+);", text)
    res["winner_v_fg"], res["winner_v_bg"] = float(m.group(1)), \
        float(m.group(2))
    m = re.search(r"bg_up mean on GT-fg (\S+) / on GT-bg (\S+);", text)
    res["bgup_fg"], res["bgup_bg"] = float(m.group(1)), float(m.group(2))
    res["per_class_iou"] = [float(x) for x in re.findall(
        r"'(\S+?)'", re.search(r"per-class IoU: (.*)", text).group(1))]
    res["miou"] = float(re.search(r"\nmIoU (\S+)", text).group(1))
    return res


def test_seg_diagnose_matches_the_jax_script(tiny, monkeypatch, capsys,
                                             tmp_path):
    params = _jax_params()
    jsd = _load_jax_script("seg_diagnose")
    monkeypatch.setattr(jsd, "finetune", lambda *a, **k: params)
    real_savez = np.savez
    monkeypatch.setattr(np, "savez", lambda path, **kw: real_savez(
        tmp_path / "jax_segdiag.npz", **kw))
    monkeypatch.setattr(sys, "argv", ["seg_diagnose.py", "--eval", "12",
                                      "--model", "tiny"])
    jsd.main()
    want = _parse_diag(capsys.readouterr().out)
    monkeypatch.setattr(np, "savez", real_savez)

    net = _port_model(params, tqe.train_config("tiny"))
    monkeypatch.setattr(tsd, "finetune", lambda *a, **k: net)
    monkeypatch.setattr(tsd, "NPZ", str(tmp_path / "segdiag.npz"))
    got = tsd.main(["--eval", "12", "--model", "tiny", "--device", "cpu"])
    printed = _parse_diag(capsys.readouterr().out)
    assert os.path.exists(tmp_path / "segdiag.npz")
    assert len(got["masked_frac"]) == len(want["masked_frac"]) == 6
    assert max(m[0] for m in got["masked_frac"][4:]) > 0
    for key, w in want.items():
        # the printed lines against the JAX script's; the returned numbers
        # against the printed ones, which carry 2 to 4 decimals
        np.testing.assert_allclose(np.asarray(printed[key], np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=2e-3, err_msg=key)
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(printed[key], np.float64),
                                   rtol=0, atol=5e-3, err_msg=key)


# ---------------------------------------------------------------------------
# precision_ladder
# ---------------------------------------------------------------------------

@pytest.fixture
def ladder_inputs(tiny, monkeypatch, tmp_path):
    """JAX's ladder init and images (vit.init key 0, normal key 1), carried
    into the port's ``_state_images``; the reference cache in tmp_path."""
    jpl = _load_jax_script("precision_ladder")
    jcfg = jpl._build("tiny", "xla", "highest")
    params, images = jpl._params_images(jcfg, 2)
    sd = tweights.state_dict_from_jax_params(_np_tree(params), _ttiny())
    timages = torch.from_numpy(np.asarray(images))
    monkeypatch.setattr(tpl, "_state_images",
                        lambda cfg, batch: (dict(sd), timages.clone()))
    monkeypatch.setattr(tpl, "BUILD", str(tmp_path))
    return jpl, jcfg, params, images


def test_ladder_highest_eager_row_matches_jax(ladder_inputs, monkeypatch):
    jpl, jcfg, params, images = ladder_inputs
    jcam, jlogits = jpl._cam_fn(jcfg)(params, images)
    monkeypatch.setattr(tpl, "reference", lambda *a, **k: (
        np.asarray(jcam, np.float64), np.asarray(jlogits, np.float64)))
    rows = tpl.main(["--model", "tiny", "--precisions", "highest",
                     "--impls", "eager,kernel", "--dev-batch", "2",
                     "--ref", "f32", "--hybrid", "--batch", "2",
                     "--device", "cpu"])
    assert [(r["impl"], r["precision"]) for r in rows] == [
        ("eager", "highest"), ("kernel", "highest"),
        ("eager+int8gemm", "highest"), ("kernel+int8gemm", "highest")]
    for r in rows[:2]:
        assert r["cam_max_dev_vs_f32"] <= 1e-5, r
        assert r["logits_max_dev"] <= 2e-4, r
    for r in rows:
        assert r["img_per_s"] > 0 and np.isfinite(r["cam_mean_dev"])


def test_ladder_f64_reference_matches_jax(ladder_inputs):
    jpl, jcfg, params, images = ladder_inputs
    cfg64 = jcfg.replace(attn_impl="xla", matmul_precision=None,
                         dtype=jnp.float64, param_dtype=jnp.float64)
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    jcam, jlogits = jpl._cam_fn(cfg64)(p64, jnp.asarray(images, jnp.float64))
    cam, logits = tpl.reference("tiny", 2, None, "f64")
    assert cam.dtype == np.float64
    np.testing.assert_allclose(cam, np.asarray(jcam), rtol=0, atol=1e-10)
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0,
                               atol=1e-10)


def test_ladder_caches_its_reference(ladder_inputs, tmp_path):
    rows = tpl.main(["--model", "tiny", "--precisions", "default,high",
                     "--impls", "eager", "--dev-batch", "2", "--ref", "f32",
                     "--no-throughput", "--device", "cpu"])
    assert (tmp_path / "ladder_ref_f32_tiny_2_mf-1.npz").exists()
    # on the CPU every rung is the reference's own float32 arithmetic
    for r in rows:
        assert r["cam_max_dev_vs_f32"] <= 1e-6 and "img_per_s" not in r
    cam, logits = tpl.reference("tiny", 2, None, "f32")
    cached = np.load(tmp_path / "ladder_ref_f32_tiny_2_mf-1.npz")
    np.testing.assert_array_equal(cached["cam"], cam)
    np.testing.assert_array_equal(cached["logits"], logits)


# ---------------------------------------------------------------------------
# flag surfaces
# ---------------------------------------------------------------------------

def _check_cli_flags(path):
    """bool_flags + value_flags of the check_cli_flags call in a script."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "check_cli_flags":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("bool_flags", "value_flags")}
            return set(kw["bool_flags"]) | set(kw["value_flags"])
    raise AssertionError(f"no check_cli_flags call in {path}")


def _argparse_flags(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"}


def test_flag_surfaces_are_the_jax_scripts_plus_device():
    for name, mod in (("quality_eval", tqe), ("seg_diagnose", tsd)):
        want = _check_cli_flags(REPO / "scripts" / f"{name}.py")
        assert set(mod._BOOL) | set(mod._VALUE) == want | {"--device"}, name
    # --_ref_out only runs the TPU script's float64 reference in a
    # subprocess; the port computes it in-process
    want = _argparse_flags(REPO / "scripts" / "precision_ladder.py")
    assert _argparse_flags(tpl.__file__) == \
        want - {"--_ref_out"} | {"--device"}


@pytest.mark.parametrize("mod", [tqe, tsd, tpl])
def test_scripts_run_on_the_card_unless_asked(mod, monkeypatch):
    """No --device means the card; without one the entry point raises and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        if mod is tpl:
            mod.main(["--no-throughput", "--dev-batch", "1"])
        else:
            mod.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# card-only
# ---------------------------------------------------------------------------

def _card_tiny(num_classes=20, **_):
    """The tiny ViT at head width 64, the width the CUDA kernels take."""
    return tcfgs.ViTCAMConfig(num_classes=num_classes,
                              **dict(TINY, embed_dim=128))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_eval_mode_on_the_card_matches_the_cpu(monkeypatch):
    monkeypatch.setattr(tcfgs, "resolve_model", lambda name: _card_tiny)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net = tqe.ViTCAM(tqe.truth_config(_card_tiny()), device="cpu",
                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.blocks[0].attn.qkv.weight.mul_(QKV_GAIN)
    images, labels, seg = tqe.make_batch(9999, 12, img=32, with_seg=True)
    cpu = tqe.eval_mode("truth", net, images, labels, seg_gt=seg)
    card = tqe.eval_mode("truth", tqe.with_config(net, net.cfg).cuda(),
                         images.cuda(), labels, seg_gt=seg)
    np.testing.assert_allclose(card["cam"], cpu["cam"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(card["cls_rows"], cpu["cls_rows"], rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_finetune_freeze_on_the_card(monkeypatch):
    monkeypatch.setattr(tcfgs, "resolve_model", lambda name: _card_tiny)
    init = tqe.ViTCAM(tqe.train_config("tiny"), device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    net = tqe.finetune(3, 4, "tiny", seed=0, freeze_below=4)
    got = {k: v.cpu() for k, v in net.state_dict().items()}
    for k, v in got.items():
        frozen = re.match(r"blocks\.[0-3]\.", k) is not None
        assert torch.equal(v, init[k]) == frozen, k
