"""The port's profiling utilities and CLI helpers against the JAX package's:
``utils.profiling`` (``model_flops``, ``StepTimer``, ``trace``, the timers)
and ``utils`` (``check_cli_flags``, ``same_seeds``)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.utils import profiling as jprof
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    same_seeds)
from vision_transformer_cam_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("with_cam", [False, True])
@pytest.mark.parametrize("name", sorted(tcfgs.MODEL_ZOO))
def test_model_flops_equal_the_jax_count(name, with_cam):
    """Pure arithmetic on the config: every entry equal on every zoo model."""
    want = jprof.model_flops(jcfgs.MODEL_ZOO[name](num_classes=20), batch=3,
                             with_cam=with_cam)
    got = tprof.model_flops(tcfgs.MODEL_ZOO[name](num_classes=20), batch=3,
                            with_cam=with_cam)
    assert got == want
    assert (got["rollout"] > 0) == with_cam


def test_model_flops_vitb():
    cfg = tcfgs.vit_base_patch16_224_in21k(num_classes=20, has_logits=False)
    r = tprof.model_flops(cfg, batch=1, with_cam=False)
    # ViT-B/16 @224 is ~17.6 GMACs/image
    assert 16.0 < r["gmacs_per_image"] < 19.0
    assert r["gflops_per_image"] == pytest.approx(2 * r["gmacs_per_image"])
    assert tprof.model_flops(cfg, batch=4)["total"] > 4 * r["total"]


@pytest.mark.parametrize("result", ["tensor", "tuple", "dict", "none"])
def test_step_timer(result):
    t = tprof.StepTimer()
    x = torch.ones((64, 64))
    res = {"tensor": x @ x, "tuple": (None, x @ x), "dict": {"a": x @ x},
           "none": None}[result]
    assert np.isnan(t.best)
    t.start()
    dt = t.stop(res)
    t.start()
    t.stop(res)
    assert dt > 0 and t.best > 0 and len(t.times) == 2
    assert t.mean == pytest.approx(sum(t.times) / 2)
    assert t.images_per_sec(128) == pytest.approx(128 / t.best)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        x = torch.ones((32, 32))
        (x @ x).sum().item()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


def test_timeit_counts_its_calls_on_the_cpu():
    calls = []
    ms = tprof.timeit(lambda a: calls.append(a), 7, chunk=3, iters=2,
                      device="cpu")
    assert ms >= 0 and calls == [7] * (2 + 3 * 2)
    assert tprof.card_line("cpu") == "cpu"


def test_check_cli_flags_strict():
    """The cases of the JAX package's test of the same name."""
    check_cli_flags(["prog", "--seed", "1", "--f32", "256", "384"],
                    bool_flags=("--f32",), value_flags=("--seed",))
    with pytest.raises(SystemExit, match="unknown flag --sed"):
        check_cli_flags(["prog", "--sed", "1"],
                        bool_flags=(), value_flags=("--seed",))
    with pytest.raises(SystemExit, match="--seed needs a value"):
        check_cli_flags(["prog", "--seed", "--f32"],
                        bool_flags=("--f32",), value_flags=("--seed",))
    with pytest.raises(SystemExit, match="needs a value"):
        check_cli_flags(["prog", "--seed"],
                        bool_flags=(), value_flags=("--seed",))


@pytest.mark.parametrize("argv,msg", [
    (["prog", "--sed", "1"], "prog: unknown flag --sed; known: --f32 --seed"),
    (["prog", "--seed"], "prog: --seed needs a value")])
def test_check_cli_flags_messages_equal_the_jax_ones(argv, msg):
    from vision_transformer_cam_tpu.utils import check_cli_flags as jcheck
    for check in (check_cli_flags, jcheck):
        with pytest.raises(SystemExit) as err:
            check(argv, bool_flags=("--f32",), value_flags=("--seed",),
                  prog="prog")
        assert str(err.value) == msg


def test_same_seeds_twice_gives_the_same_draws():
    draws = []
    for _ in range(2):
        gen = same_seeds(5)
        draws.append((random.random(), float(np.random.rand()),
                      torch.rand(3), torch.rand(3, generator=gen)))
    assert draws[0][:2] == draws[1][:2]
    assert torch.equal(draws[0][2], draws[1][2])
    assert torch.equal(draws[0][3], draws[1][3])
    assert isinstance(same_seeds(6), torch.Generator)
    assert not torch.equal(torch.rand(3), draws[0][2])
