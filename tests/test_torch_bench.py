"""The port's measurement entry points (``bench``, ``scripts.microbench``,
``scripts.qblock_sweep``, ``scripts.block_ablation``) on the CPU: the bench
config against the JAX package's root ``bench.py`` flag by flag, and every
mode and variant run at a tiny size (``--device cpu``: the kernels' plain
versions); the block kernel's ablation, which runs only on the card, by the
cuts it makes in the kernel's source."""

import dataclasses
import json
import os
import sys

import pytest
import torch

import jax.numpy as jnp

from vision_transformer_cam_tpu_torch import bench as tbench
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.scripts import (block_ablation,
                                                      microbench, qblock_sweep)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the JAX package's root bench.py)

JDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
IMPL = {"pallas": "kernel", "xla": "eager"}
# every flag set of tests/test_quant.py::test_bench_default_matches_serving_
# api, and each single flag of the JAX bench's surface (its --q-block takes
# any row count; the card's tile is 16 or 32)
FLAG_SETS = [[], ["--int8-hifi"], ["--model", "vit_large_patch16_512"]] + \
    [[f] for f in sorted(jbench._FLAGS)] + \
    [["--block-b", "4"], ["--q-block", "32"], ["--batch", "64"],
     ["--model", "vit_large_patch16_384"], ["--precision", "high"],
     ["--accum", "2"], ["--bf16", "--mlp-fusion", "--rollout-post"],
     ["--int8", "--no-int8-attn", "--ln-quant", "--int8-fused"]]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or
                         "default")
def test_build_cfg_equals_the_jax_bench_field_for_field(flags):
    want, want_int8 = jbench.build_cfg(["bench.py"] + flags)
    got, got_int8 = tbench.build_cfg(["bench.py"] + flags)
    assert got_int8 == want_int8
    for f in dataclasses.fields(tcfgs.ViTCAMConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("dtype", "param_dtype"):
            w = JDT[w]
        elif f.name == "attn_impl":
            w = IMPL[w]
        assert g == w, (f.name, g, w)


def test_eager_is_the_ports_name_for_xla():
    assert tbench.build_cfg(["bench.py", "--eager"]) == \
        tbench.build_cfg(["bench.py", "--xla"])
    assert tbench.build_cfg(["bench.py", "--eager"])[0].attn_impl == "eager"


@pytest.mark.parametrize("flags,mode,model", [
    ([], "int8", "vit_base_patch16_224_in21k"),
    (["--int8-hifi"], "int8_hifi", "vit_base_patch16_224_in21k"),
    (["--model", "vit_large_patch16_512"], "int8", "vit_large_patch16_512")])
def test_bench_default_matches_serving_api(flags, mode, model):
    """With no ablation flag the bench config is the product serving config,
    including the route past 640 tokens."""
    base = tcfgs.resolve_model(model)(num_classes=20).replace(
        representation_size=None)
    cfg, use_int8 = tbench.build_cfg(["bench.py"] + flags)
    assert use_int8 and cfg == tserving.serving_config(base, mode)
    assert cfg.int8_attn_out == (mode == "int8_hifi" or base.seq_len > 640)


@pytest.mark.parametrize("argv,msg", [
    (["--bf61"], "unknown flag '--bf61'"),
    (["--batch"], "--batch needs a value"),
    (["--model", "--f32"], "--model needs a value"),
    (["--dispatch-chunks", "2"], "--dispatch-chunks"),
    (["--dispatch-chunks"], "--dispatch-chunks needs a value")])
def test_check_flags_refuses(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        tbench._check_flags(["bench.py"] + argv)
    with pytest.raises(SystemExit, match=msg):
        tbench.main(argv + ["--device", "cpu"])


def test_check_flags_messages_equal_the_jax_ones():
    for argv in (["bench.py", "--bf61"], ["bench.py", "--batch", "--latency"]):
        with pytest.raises(SystemExit) as want:
            jbench._check_flags(argv)
        with pytest.raises(SystemExit) as got:
            tbench._check_flags(argv)
        # the port knows two flags more (--eager, --device)
        assert str(got.value).split(" (known")[0] == \
            str(want.value).split(" (known")[0]


def _tiny(num_classes=20, **kw):
    return tcfgs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=32,
                              depth=2, num_heads=2, num_classes=num_classes,
                              mask_from=0, top_k_patches=4)


@pytest.fixture
def tiny_zoo(monkeypatch):
    """The zoo has no tiny model: every name resolves to a 2-layer, C = 32
    config for the run."""
    monkeypatch.setattr(tcfgs, "resolve_model", lambda name: _tiny)


MODES = {
    "default": ([], "torch_tiny_cam_extraction_throughput",
                "images/sec/cpu"),
    "bf16": (["--bf16"], "torch_tiny_cam_extraction_throughput",
             "images/sec/cpu"),
    "f32": (["--f32", "--precision", "high"],
            "torch_tiny_cam_extraction_throughput", "images/sec/cpu"),
    "int8_hifi": (["--int8-hifi"], "torch_tiny_cam_extraction_throughput",
                  "images/sec/cpu"),
    "int8_dynamic": (["--int8-dynamic", "--ln-quant", "--int8-fused"],
                     "torch_tiny_cam_extraction_throughput",
                     "images/sec/cpu"),
    "eager": (["--bf16", "--xla"], "torch_tiny_cam_extraction_throughput",
              "images/sec/cpu"),
    "mlp_fusion": (["--mlp-fusion", "--q-block", "16"],
                   "torch_tiny_cam_extraction_throughput", "images/sec/cpu"),
    "no_cam": (["--no-cam"], "torch_tiny_multilabel_inference_throughput",
               "images/sec/cpu"),
    "latency": (["--latency"], "torch_tiny_cam_extraction_p50_latency",
                "ms/image (cpu, batch 1)"),
    "train": (["--train"], "torch_tiny_train_step_throughput",
              "images/sec/cpu"),
    "train_mixed": (["--train", "--mixed"],
                    "torch_tiny_train_step_throughput_mixed",
                    "images/sec/cpu"),
    "train_accum": (["--train", "--mixed", "--accum", "2", "--eager"],
                    "torch_tiny_train_step_throughput_mixed_accum2",
                    "images/sec/cpu"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_main_prints_one_json_line(tiny_zoo, capsys, mode):
    flags, metric, unit = MODES[mode]
    line = tbench.main(flags + ["--model", "tiny", "--batch", "2",
                                "--device", "cpu"], chunk=2, iters=2)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == {"metric", "value", "unit", "device"}
    assert "vs_baseline" not in line
    assert line["metric"] == metric and line["unit"] == unit
    assert line["device"] == "cpu" and line["value"] > 0


def test_default_model_keeps_the_jax_metric_stem(monkeypatch, capsys):
    """Without --model the metric reads vit_b16, with torch_ in front."""
    monkeypatch.setattr(tcfgs, "resolve_model", lambda name: _tiny)
    monkeypatch.setattr(tcfgs, "vit_base_patch16_224_in21k",
                        lambda num_classes=20, has_logits=True: _tiny())
    line = tbench.main(["--bf16", "--batch", "2", "--device", "cpu"],
                       chunk=1, iters=1)
    assert line["metric"] == "torch_vit_b16_cam_extraction_throughput"
    line = tbench.main(["--train", "--batch", "2", "--device", "cpu"],
                       chunk=1, iters=1)
    assert line["metric"] == "torch_vit_b16_train_step_throughput"


def test_window_defaults_are_the_jax_benchs(tiny_zoo, monkeypatch):
    """(10, 3) for throughput, (10, 15) with --latency, (5, 3) with --train,
    after two warm-up dispatches."""
    from vision_transformer_cam_tpu_torch.models import vit as tvit
    from vision_transformer_cam_tpu_torch.train import step as tstep
    calls = {"fwd": 0, "step": 0}
    real_fwd, real_step = tvit.ViTCAM.forward, tstep.train_step

    def fwd(self, *a, **kw):
        calls["fwd"] += 1
        return real_fwd(self, *a, **kw)

    def step(*a, **kw):
        calls["step"] += 1
        return real_step(*a, **kw)
    monkeypatch.setattr(tvit.ViTCAM, "forward", fwd)
    monkeypatch.setattr(tstep, "train_step", step)
    base = ["--model", "tiny", "--batch", "1", "--device", "cpu", "--bf16"]
    tbench.main(base)
    assert calls["fwd"] == 2 + 10 * 3
    calls["fwd"] = 0
    tbench.main(base + ["--latency"])
    assert calls["fwd"] == 2 + 10 * 15
    tbench.main(base + ["--train"])
    assert calls["step"] == 2 + 5 * 3


@pytest.mark.parametrize("variant", microbench.VARIANTS)
def test_microbench_variant_prints_its_line(tiny_zoo, capsys, variant):
    line = microbench.main([variant, "--batch", "2", "--device", "cpu"],
                           n=17, c=32, heads=2, hid=64, chunk=1, iters=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [line]
    head = {"mlp": "mlp(bf16 fused)", "mlp-int8": "mlp-int8(fused)",
            "qkv-int8": "qkv-int8(fused)"}.get(variant, variant)
    assert line.startswith(head + ": ")
    if variant != "io":
        assert "not a device time" in line


def test_microbench_unknown_variant_is_a_system_exit():
    with pytest.raises(SystemExit, match="unknown variant atn"):
        microbench.main(["atn", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown flag --bath"):
        microbench.main(["attn", "--bath", "2"])


@pytest.mark.parametrize("flags", [[], ["--bf16"], ["--bf16", "--post"],
                                   ["--f32"], ["--f32", "--no-clamp"],
                                   ["--bf16", "--block-b", "4"]])
def test_qblock_sweep_prints_a_line_per_candidate(capsys, flags):
    res = qblock_sweep.main(["--batch", "2", "--seq", "17", "--heads", "2",
                             "--dh", "16", "--device", "cpu"] + flags, reps=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert list(res) == [16, 32] and all(v > 0 for v in res.values())
    assert [ln.split()[0] for ln in out] == ["qb=", "qb="]
    assert all("ms/layer" in ln for ln in out)


def test_qblock_sweep_candidates_bwd_and_failures(capsys):
    base = ["--batch", "2", "--seq", "17", "--heads", "2", "--dh", "16",
            "--device", "cpu"]
    # a digit after a value flag is its value; 24 is no tile height: FAIL
    # with the wrapper's own message, and the sweep goes on
    res = qblock_sweep.main(base + ["--bf16", "24", "16"], reps=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert res[24] is None and res[16] > 0
    assert "FAIL ValueError: q_block must be 0 (auto) or one of" in out[0]
    res = qblock_sweep.main(base + ["--bf16", "--bwd"], reps=1)
    assert res["bwd"] > 0
    assert "bwd dtype=bfloat16" in capsys.readouterr().out
    res = qblock_sweep.main(base + ["--bwd"], reps=1)   # int8: no backward
    assert res["bwd"] is None and "FAIL" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown flag --sq"):
        qblock_sweep.main(base + ["--sq", "3"])


@pytest.mark.parametrize("variant", list(block_ablation.VARIANTS))
def test_block_ablation_cuts_match_the_kernel_source(variant):
    """Each variant of the block kernel's ablation cuts its parts out of the
    current attention_block.cu: every cut's text occurs there once (the
    script refuses a source it no longer matches) and changes it."""
    src = (_build.CSRC / block_ablation.SOURCE).read_text()
    cuts = block_ablation.VARIANTS[variant]
    got = block_ablation.cut_source(src, cuts)
    assert (got == src) == (not cuts)
    for cut in cuts:
        old, new = block_ablation.CUTS[cut]
        assert src.count(old) == 1 and got.count(new) >= 1
    with pytest.raises(ValueError, match="update CUTS"):
        block_ablation.cut_source(src.replace(
            block_ablation.CUTS["core"][0], ""), ("core",))


def test_block_ablation_runs_on_the_card_only():
    with pytest.raises(SystemExit, match="unknown flag --bacth"):
        block_ablation.main(["--bacth", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            block_ablation.main(["--batch", "2"])
