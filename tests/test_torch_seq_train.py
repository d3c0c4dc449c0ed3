"""The port's sequence-parallel training against the JAX package's, on the
CPU.

Gloo ranks (``parallel.worker.launch``, which has a time limit of its own,
running ``tests/_dp_ranks.train_runs``) train a tiny float64 model (N = 17
tokens, padded to 18 on two seq ranks and to 20 on four) from JAX
``vit.init`` weights (qkv gain 10, so that the mask engages) on the
('data', 'seq') grids (1, 2), (2, 2) and (1, 4); JAX runs ``train_step`` /
``train_step_accum`` on the same ('data', 'seq') mesh of the 8 virtual CPU
devices (tests/conftest.py) and unsharded, on its XLA attention.  The
port's eager path is held to it at 1e-10: the loss, f1, the loss parts and
every parameter after the update.  Dropout is held to the one-rank port
(the port's RNG is not JAX's).  Each grid's ranks are spawned once, by the
module's fixture; then ``cli.train --seq_parallel`` against one rank, with a
``--resume`` each way.
"""

import contextlib
import functools
import os
import sys

import _dp_ranks

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu.train import state as jstate
from vision_transformer_cam_tpu.train import step as jstep
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.cli import train as tcli
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
SEQ = dict(data_axis="data", seq_axis="seq", attn_impl="eager")
GAIN = 10.0
B, SPE = 8, 100
OPT = dict(lr=1e-3, warmup_epochs=0, epochs=10, linear_lr_scaling=False,
           clip_grad=0.5)
TOL = 1e-10
DROP = dict(drop_ratio=0.1, attn_drop_ratio=0.2, drop_path_ratio=0.3)
# run name: (config fields, accumulation steps, dropout seed)
NORMS = {"global_remat": (dict(remat=True), 1, None),
         "global_plain": (dict(remat=False), 1, None),
         "sample_remat": (dict(remat=True, per_sample_mask_norm=True), 1,
                          None),
         "sample_plain": (dict(remat=False, per_sample_mask_norm=True), 1,
                          None)}
GRIDS = {  # grid: the runs on it
    (1, 2): {**NORMS, "dropout": (dict(DROP), 1, 5),
             "dropout_plain": (dict(DROP, remat=False), 1, 5)},
    (2, 2): {"global_remat": NORMS["global_remat"],
             "sample_plain": NORMS["sample_plain"],
             "accum2": (dict(remat=True), 2, None),
             "zero1": (dict(remat=True), 1, None)},
    (1, 4): {"global_remat": NORMS["global_remat"],
             "sample_plain": NORMS["sample_plain"],
             "dropout": (dict(DROP), 1, 5)}}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    """(port config without the seq axes, JAX config on "xla"), float64."""
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.float64,
                              param_dtype=torch.float64, **kw)
    kw.pop("attn_impl", None)
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=jnp.float64,
                              param_dtype=jnp.float64, attn_impl="xla", **kw)
    return tcfg, jcfg


@functools.lru_cache(maxsize=None)
def _params():
    _, jcfg = _cfgs()
    params = jvit.init(jcfg, jax.random.key(3))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * GAIN
    return params


def _state_dict():
    return tweights.state_dict_from_jax_params(_np_tree(_params()),
                                               _cfgs()[0])


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 32, 32, 3))
    y = (rng.random((B, 20)) < 0.15).astype(np.float64)
    y[np.arange(B), rng.integers(0, 20, B)] = 1.0
    return x, y


BATCH = _batch(7)


@functools.lru_cache(maxsize=None)
def _jax_tx():
    return jstate.make_optimizer(jcfgs.OptimConfig(**OPT), B, SPE)[0]


@functools.lru_cache(maxsize=None)
def _jax_step(name, grid=None):
    """JAX params and metrics after one step of run ``name`` (no dropout),
    on the ('data', 'seq') mesh ``grid`` or unsharded."""
    over, accum, _ = {**NORMS, **GRIDS[(2, 2)]}[name]
    _, jcfg = _cfgs(**over)
    tx = _jax_tx()
    params = jax.tree.map(jnp.copy, _params())
    xs, ys = (jnp.asarray(a) for a in BATCH)
    ctx = contextlib.nullcontext()
    if grid:
        mesh = jmesh.make_mesh(grid, ("data", "seq"),
                               devices=jax.devices()[:grid[0] * grid[1]])
        params = jax.device_put(params, NamedSharding(mesh, P()))
        sh = NamedSharding(mesh, P("data"))
        xs, ys = jax.device_put(xs, sh), jax.device_put(ys, sh)
        jcfg = jcfg.replace(data_axis="data", seq_axis="seq")
        ctx = mesh
    state = jstate.create_train_state(params, tx)
    with ctx:
        if accum == 1:
            state, m = jstep.train_step(state, xs, ys, jax.random.key(1),
                                        jcfg, tx)
        else:
            state, m = jstep.train_step_accum(
                state, xs, ys, jax.random.key(1), jcfg, tx, accum,
                data_axis="data" if grid else None)
        jax.block_until_ready(state.params)
    return _np_tree(state.params), {k: float(v) for k, v in m.items()}


def _max_dev(state, want):
    assert set(state) == set(want)
    return max(float((state[k].double() - torch.as_tensor(want[k]).double())
                     .abs().max()) for k in want)


def _jax_dev(state, jparams):
    return _max_dev(state, tweights.state_dict_from_jax_params(
        jparams, _cfgs()[0]))


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """{grid: every rank's results of the grid's runs}, one spawn a grid."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    base, _ = _cfgs()
    batches = [tuple(torch.from_numpy(a) for a in BATCH)]
    out = {}
    for grid, runs in GRIDS.items():
        spec = {name: (dict(over, **SEQ),
                       dict(accum_steps=acc, steps=1, rng=rng,
                            zero1=name == "zero1"),
                       name == "zero1" and grid == (2, 2))
                for name, (over, acc, rng) in runs.items()}
        out[grid] = launch(
            _dp_ranks.train_runs,
            (base, _state_dict(), batches, spec, tcfgs.OptimConfig(**OPT), B,
             SPE, str(ckpt), grid, None, "seq"),
            world=grid[0] * grid[1], timeout=150)
    return out, ckpt


def _one_rank(over, rng=None, accum=1):
    """The one-rank port's parameters and metrics after one step."""
    tcfg, _ = _cfgs(**over, attn_impl="eager")
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict())
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tstate.create_train_state(model, opt)
    x, y = (torch.from_numpy(a) for a in BATCH)
    if accum > 1:
        state, m = tstep.train_step_accum(state, x, y, rng,
                                          accum_steps=accum)
    else:
        state, m = tstep.train_step(state, x, y, rng)
    return model.state_dict(), {k: float(v) for k, v in m.items()}


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k


@pytest.mark.parametrize("grid,name", [
    (grid, name) for grid in GRIDS for name in NORMS if name in GRIDS[grid]],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_seq_step_matches_jax_unsharded(seq, grid, name):
    """Both mask norms, remat on and off: every rank's metrics and the
    parameters after the step against JAX ``train_step`` unsharded."""
    res, _ = seq
    jparams, jm = _jax_step(name)
    for r in res[grid]:
        _close_metrics(r[name]["metrics"][0], jm)
    assert _jax_dev(res[grid][0][name]["state"], jparams) <= TOL


@pytest.mark.parametrize("grid", list(GRIDS), ids=lambda g: f"{g[0]}x{g[1]}")
def test_seq_step_matches_jax_on_the_same_mesh(seq, grid):
    """The batch-global norm with remat against JAX ``train_step`` on the
    same ('data', 'seq') mesh (GSPMD's token-sharded step)."""
    res, _ = seq
    jparams, jm = _jax_step("global_remat", grid)
    for r in res[grid]:
        _close_metrics(r["global_remat"]["metrics"][0], jm)
    assert _jax_dev(res[grid][0]["global_remat"]["state"], jparams) <= TOL


def test_seq_accum2_matches_jax_train_step_accum(seq):
    """Two microbatches on the (2, 2) grid against JAX
    ``train_step_accum(..., data_axis='data')`` on the (2, 2) mesh and
    unsharded."""
    res, _ = seq
    for grid in ((2, 2), None):
        jparams, jm = _jax_step("accum2", grid)
        for r in res[(2, 2)]:
            _close_metrics(r["accum2"]["metrics"][0], jm)
        assert _jax_dev(res[(2, 2)][0]["accum2"]["state"], jparams) <= TOL
    assert any(not torch.equal(res[(2, 2)][0]["global_remat"]["state"][k], v)
               for k, v in res[(2, 2)][0]["accum2"]["state"].items())


def test_seq_zero1_is_the_unsharded_moment_step_bit_for_bit(seq):
    """ZeRO-1 on the (2, 2) grid shards the moments over the data axis
    only: the seq ranks of a data group hold the same slices, and the step
    is the unsharded-moment step's bit for bit."""
    res, ckpt = seq
    ranks = res[(2, 2)]
    for r in ranks:
        assert r["zero1"]["digests"] == r["global_remat"]["digests"]
    for k, v in ranks[0]["global_remat"]["state"].items():
        assert torch.equal(ranks[0]["zero1"]["state"][k], v), k
    total = ranks[0]["global_remat"]["moment_elements"]
    shards = [r["zero1"]["moment_elements"] for r in ranks]
    assert shards[0] == shards[1] and shards[2] == shards[3]
    assert shards[0] + shards[2] == total
    # the checkpoint is in the one-rank layout and resumes on one rank
    tcfg, _ = _cfgs(attn_impl="eager")
    model = tvit.ViTCAM(tcfg, device="cpu")
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tckpt.restore(str(ckpt), "zero1",
                          tstate.create_train_state(model, opt))
    assert state.step == 1
    assert _max_dev(model.state_dict(), ranks[0]["zero1"]["state"]) == 0.0


@pytest.mark.parametrize("grid,name", [((1, 2), "dropout"),
                                       ((1, 2), "dropout_plain"),
                                       ((1, 4), "dropout")])
def test_seq_dropout_matches_the_one_rank_port(seq, grid, name):
    """Dropout at the embedding and the six block sites and stochastic
    depth at nonzero ratios: the sharded masks are the one-rank masks' rows,
    so the step is the one-rank port's (whose RNG is not JAX's)."""
    res, _ = seq
    over, _, rng = GRIDS[grid][name]
    want, wm = _one_rank(over, rng=rng)
    for r in res[grid]:
        _close_metrics(r[name]["metrics"][0], wm)
    assert _max_dev(res[grid][0][name]["state"], want) <= TOL
    # the masks moved the step
    plain, _ = _one_rank({k: v for k, v in over.items()
                          if k not in DROP})
    assert _max_dev(want, plain) > 1e-6


def test_seq_ranks_agree_bit_for_bit(seq):
    """Every rank of every grid holds the same parameters after every run,
    and no kernel launched (the eager path)."""
    res, _ = seq
    for grid, ranks in res.items():
        for name in GRIDS[grid]:
            assert all(r[name]["digests"] == ranks[0][name]["digests"]
                       for r in ranks), (grid, name)
            assert all(r[name]["metrics"] == ranks[0][name]["metrics"]
                       for r in ranks), (grid, name)
            assert all(not sum(st.values()) for r in ranks
                       for st in r[name]["launches"])
        assert ranks[0]["transport"] == "gloo"


def test_gather_rows_and_the_row_shards_of_a_dropout_mask():
    """One rank: ``gather_rows`` cuts the padding and hands the gradient
    back; the row shard of a dropout mask on each of two ranks is the
    one-rank mask's rows (the second rank's last row is padding)."""
    mesh = tmesh.SeqMesh(inner_size=1)
    t = torch.arange(12.0).reshape(1, 6, 2).requires_grad_()
    g = tmesh.gather_rows(t, mesh, 1, 5)
    assert g.shape == (1, 5, 2)
    g.sum().backward()
    assert t.grad[0, :5].eq(1).all() and t.grad[0, 5].eq(0).all()
    x = torch.ones((2, 9, 3), dtype=torch.float64)
    full = tvit._dropout(torch.ones((2, 17, 3), dtype=torch.float64), 0.5,
                         11)
    for r in range(2):
        two = tmesh.SeqMesh(inner_size=2, inner_rank=r)
        got = tvit._dropout(x, 0.5, 11, tvit._rows_of(two, 17, x))
        want = two.local_rows(full)
        n_real = 9 if r == 0 else 8
        assert torch.equal(got[:, :n_real], want[:, :n_real])


def test_kernel_path_under_seq_training_raises():
    """The sequence-parallel kernel has no backward: training a seq config
    on the kernel path raises and names the eager path, in the model and in
    ``fit``; evaluation keeps the kernel."""
    tcfg, _ = _cfgs(data_axis="data", seq_axis="seq", attn_impl="kernel")
    model = tvit.ViTCAM(tcfg, device="cpu")
    x = torch.zeros((1, 32, 32, 3), dtype=torch.float64)
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        with pytest.raises(ValueError, match="attn_impl='eager'"):
            model.forward_train(x)
        assert torch.isfinite(model(x).logits).all()
    with pytest.raises(ValueError, match="attn_impl='eager'"):
        from vision_transformer_cam_tpu_torch.train import loop as tloop
        tloop.fit(tcfg, tcfgs.TrainConfig(mesh_shape=(-1, 1),
                                          mesh_axes=("data", "seq")),
                  tcfgs.DataConfig(), tcfgs.DataConfig(), device="cpu")


# ---------------------------------------------------------------------------
# cli.train --seq_parallel on the faked VOC tree of
# tests/test_torch_data_parallel_cli.py
# ---------------------------------------------------------------------------

from test_torch_data_parallel_cli import (  # noqa: E402
    TIMEOUT, ZOO, ZOO_KW, _same_logs, _train_args, tree, weights)


def _params_dev(got, want):
    assert set(got) == set(want)
    return max(float((got[k] - v).abs().max()) for k, v in want.items())


@pytest.mark.parametrize("flags,world", [
    (("--seq_parallel", "2"), 2),
    (("--seq_parallel", "2"), 4),
    (("--seq_parallel", "2", "--zero1", "--grad_accum", "2"), 4)],
    ids=["sp2", "dp2_sp2", "dp2_sp2_zero1_accum2"])
def test_train_cli_seq_parallel_matches_one_rank(tree, weights, tmp_path,
                                                 flags, world, monkeypatch):
    """``cli.train --seq_parallel 2`` on two ranks (the (1, 2) grid) and on
    four (the (2, 2) grid: two rows a data group of a global batch of 4)
    against the one-rank run of the other flags: every parameter at 1e-10
    (float64), the same logged losses and mAPs, one log and one set of
    checkpoints, the main process's."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    one, many = tmp_path / "one", tmp_path / "many"
    one_flags = flags[2:]   # what stays without the seq axis
    state = tcli.main(_train_args(tree, weights, one, *one_flags))
    res = launch(_dp_ranks.train_cli,
                 (ZOO, ZOO_KW, _train_args(tree, weights, many, *flags)),
                 world=world, timeout=TIMEOUT)
    want = state.model.state_dict()
    for r in res:
        assert r["step"] == state.step == 2
        assert _params_dev(r["params"], want) <= TOL
    _same_logs(one, many)
    assert len(os.listdir(many / "w")) == len(os.listdir(one / "w"))


def test_train_cli_seq_parallel_resumes_both_ways(tree, weights, tmp_path,
                                                  monkeypatch):
    """An epoch on two seq ranks resumed for a second on one rank, and an
    epoch on one rank resumed on two seq ranks, against the one-rank run of
    the same two commands: the checkpoints hold the one-rank layout, every
    parameter at 1e-10 (float64)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    flags, sp = ("--epochs", "1"), ("--seq_parallel", "2")
    one, a, b = tmp_path / "one", tmp_path / "a", tmp_path / "b"
    tcli.main(_train_args(tree, weights, one, *flags))
    want = tcli.main(_train_args(tree, weights, one, *flags, "--resume"))
    launch(_dp_ranks.train_cli,
           (ZOO, ZOO_KW, _train_args(tree, weights, a, *flags, *sp)),
           world=2, timeout=TIMEOUT)
    got = tcli.main(_train_args(tree, weights, a, *flags, "--resume"))
    assert got.step == want.step == 2
    assert _params_dev(got.model.state_dict(),
                       want.model.state_dict()) <= TOL
    tcli.main(_train_args(tree, weights, b, *flags))
    res = launch(_dp_ranks.train_cli,
                 (ZOO, ZOO_KW, _train_args(tree, weights, b, *flags, *sp,
                                           "--resume")),
                 world=2, timeout=TIMEOUT)
    for r in res:
        assert r["step"] == 2
        assert _params_dev(r["params"], want.model.state_dict()) <= TOL
