"""The port's data-parallel training against the JAX package's, on the CPU.

Two gloo ranks (``parallel.worker.launch``, which has a time limit of its
own, running ``tests/_dp_ranks.train_runs``) train a tiny float64 model
from JAX ``vit.init`` weights (qkv gain 10, so that the mask engages) on
their rows of seeded global batches;
JAX runs ``train_step`` / ``train_step_accum`` on a (2,) 'data' mesh of the
8 virtual CPU devices (tests/conftest.py) and unsharded.  The port's
"eager" and "kernel" paths are held to JAX "xla" (its Pallas path forms S
in float32 whatever the inputs).  All ranks are spawned once, by the
module's fixture, and every test reads their results.
"""

import contextlib
import functools

import _dp_ranks

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu.train import state as jstate
from vision_transformer_cam_tpu.train import step as jstep
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.data.loader import BatchLoader
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.scripts import dryrun_multichip
from vision_transformer_cam_tpu_torch.scripts.dryrun_multichip import (
    param_digest)
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
GAIN = 10.0
B, DP, SPE = 8, 2, 100
OPT = dict(lr=1e-3, warmup_epochs=0, epochs=10, linear_lr_scaling=False,
           clip_grad=0.5)
TOL = 1e-10
# run name: (port config fields, accumulation steps); every run takes one
# step on batch 0 from the same weights
RUNS = {"global_eager": (dict(attn_impl="eager"), 1),
        "global_kernel": (dict(attn_impl="kernel"), 1),
        "sample_eager": (dict(attn_impl="eager",
                              per_sample_mask_norm=True), 1),
        "accum2": (dict(attn_impl="eager"), 2)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.float64,
                              param_dtype=torch.float64, **kw)
    jkw = {k: v for k, v in kw.items() if k != "attn_impl"}
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=jnp.float64,
                              param_dtype=jnp.float64, attn_impl="xla", **jkw)
    return tcfg, jcfg


@functools.lru_cache(maxsize=None)
def _params():
    _, jcfg = _cfgs()
    params = jvit.init(jcfg, jax.random.key(0))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * GAIN
    return params


def _state_dict(cfg):
    return tweights.state_dict_from_jax_params(_np_tree(_params()), cfg)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 32, 32, 3))
    y = (rng.random((B, 20)) < 0.15).astype(np.float64)
    y[np.arange(B), rng.integers(0, 20, B)] = 1.0
    return x, y


BATCHES = [_batch(3), _batch(4)]


@functools.lru_cache(maxsize=None)
def _jax_tx():
    return jstate.make_optimizer(jcfgs.OptimConfig(**OPT), B, SPE)[0]


def _jax_step(jcfg, x, y, mesh_n=0, accum=1, params=None):
    """JAX params and metrics after one step, on a (mesh_n,) 'data' mesh or
    unsharded (mesh_n 0)."""
    tx = _jax_tx()
    params = jax.tree.map(jnp.copy, params if params is not None
                          else _params())
    xs, ys = jnp.asarray(x), jnp.asarray(y)
    ctx = contextlib.nullcontext()
    if mesh_n:
        mesh = jmesh.make_mesh((mesh_n,), ("data",),
                               devices=jax.devices()[:mesh_n])
        params = jmesh.shard_params(mesh, params)
        sh = jmesh.data_sharding(mesh)
        xs, ys = jax.device_put(xs, sh), jax.device_put(ys, sh)
        ctx = mesh
    state = jstate.create_train_state(params, tx)
    with ctx:
        if accum == 1:
            state, m = jstep.train_step(state, xs, ys, jax.random.key(1),
                                        jcfg, tx)
        else:
            state, m = jstep.train_step_accum(
                state, xs, ys, jax.random.key(1), jcfg, tx, accum,
                data_axis="data" if mesh_n else None)
        jax.block_until_ready(state.params)
    return _np_tree(state.params), {k: float(v) for k, v in m.items()}


def _max_dev(state, jparams, cfg):
    want = tweights.state_dict_from_jax_params(jparams, cfg)
    assert set(state) == set(want)
    return max(float((state[k].double() - want[k].double()).abs().max())
               for k in want)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every rank's results of every run (one spawn for the module)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    base, _ = _cfgs()
    batches = [tuple(torch.from_numpy(a) for a in b) for b in BATCHES]
    eager = RUNS["global_eager"][0]
    runs = {name: (over, dict(accum_steps=acc, steps=1), False)
            for name, (over, acc) in RUNS.items()}
    runs.update(zero1=(eager, dict(zero1=True, steps=1), True),
                dp_ckpt=(eager, dict(steps=1), True),
                dp_two=(eager, dict(steps=2), False))
    res = launch(_dp_ranks.train_runs,
                 (base, _state_dict(base), batches, runs,
                  tcfgs.OptimConfig(**OPT), B, SPE, str(ckpt)),
                 world=DP, timeout=150)
    return res, ckpt


@pytest.mark.parametrize("name", ["global_eager", "global_kernel",
                                  "sample_eager"])
def test_dp_train_step_matches_jax_mesh_and_unsharded(dp, name):
    """Loss, f1, the loss parts and every parameter after the update, on
    both ranks, against JAX on the (2,) mesh and unsharded, at 1e-10."""
    res, _ = dp
    over, _ = RUNS[name]
    tcfg, jcfg = _cfgs(**over)
    x, y = BATCHES[0]
    for mesh_n in (DP, 0):
        jparams, jm = _jax_step(jcfg, x, y, mesh_n=mesh_n)
        for rank in range(DP):
            got = res[rank][name]["metrics"][0]
            assert set(got) == set(jm)
            for k in jm:
                assert abs(got[k] - jm[k]) <= TOL, (mesh_n, rank, k)
        assert _max_dev(res[0][name]["state"], jparams, tcfg) <= TOL


def test_fixture_is_sensitive_to_the_global_max():
    """On each rank's rows the rank-local max gives another bg indicator
    than the global batch's max: a step that normalized per rank would
    differ from JAX's."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict(tcfg))
    out = model(torch.from_numpy(BATCHES[0][0]))
    half = B // DP
    differs = 0
    for rows in out.attn_cls_rows[:-1]:
        _, bg_global = tvit._mask_from_cls_row(rows, tcfg)
        for r in range(DP):
            _, bg_local = tvit._mask_from_cls_row(
                rows[r * half:(r + 1) * half], tcfg)
            differs += int(not torch.equal(
                bg_local, bg_global[r * half:(r + 1) * half]))
        assert 0 < float(bg_global[:, 1:].sum()) < bg_global[:, 1:].numel()
    assert differs > 0


def test_dp_accum2_matches_jax_train_step_accum(dp):
    """Two microbatches under DP (each rank its stripe of each) against JAX
    ``train_step_accum(..., data_axis='data')`` on the (2,) mesh and JAX
    unsharded: the microbatches, and so the batch-global mask max, are
    JAX's."""
    res, _ = dp
    tcfg, jcfg = _cfgs(**RUNS["accum2"][0])
    x, y = BATCHES[0]
    for mesh_n in (DP, 0):
        jparams, jm = _jax_step(jcfg, x, y, mesh_n=mesh_n, accum=2)
        for rank in range(DP):
            got = res[rank]["accum2"]["metrics"][0]
            for k in jm:
                assert abs(got[k] - jm[k]) <= TOL, (mesh_n, rank, k)
        assert _max_dev(res[0]["accum2"]["state"], jparams, tcfg) <= TOL
    # and not the full-batch step: the per-microbatch max moves the mask
    full = res[0]["global_eager"]["state"]
    assert any(not torch.equal(full[k], v)
               for k, v in res[0]["accum2"]["state"].items())


def test_zero1_matches_dp_and_shards_the_moments(dp):
    """ZeRO-1 takes the step of the unsharded DP optimizer bit for bit, and
    each rank holds its half of the AdamW moments."""
    res, _ = dp
    want, got = res[0]["global_eager"], res[0]["zero1"]
    assert got["digests"] == want["digests"]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    total = want["moment_elements"]
    shards = [res[r]["zero1"]["moment_elements"] for r in range(DP)]
    assert sum(shards) == total and max(shards) == -(-total // DP)
    assert res[0]["zero1"]["moment_bytes"] * DP >= \
        res[0]["global_eager"]["moment_bytes"]
    assert res[0]["zero1"]["moment_bytes"] < \
        res[0]["global_eager"]["moment_bytes"]


def test_ranks_agree_bit_for_bit(dp):
    """Every rank applies the same all-reduced update: the parameters'
    digests and the metrics are equal on both ranks after every step."""
    res, _ = dp
    for name in list(RUNS) + ["zero1", "dp_ckpt", "dp_two"]:
        assert res[0][name]["digests"] == res[1][name]["digests"], name
        assert res[0][name]["metrics"] == res[1][name]["metrics"], name
    assert res[0]["transport"] == "gloo"


def test_zero1_checkpoint_is_the_dp_checkpoint_and_resumes_on_one_rank(dp):
    """The ZeRO-1 checkpoint gathers the full moments: the file holds what
    the unsharded DP run's holds.  Restored on one rank, its next step on
    the second batch is the 2-rank run's second step."""
    res, ckpt = dp
    z = torch.load(ckpt / "zero1.pt", weights_only=True)
    d = torch.load(ckpt / "dp_ckpt.pt", weights_only=True)
    assert z["step"] == d["step"] == 1
    assert z["optimizer"]["count"] == d["optimizer"]["count"] == 1
    for key in ("mu", "nu"):
        assert set(z["optimizer"][key]) == set(d["optimizer"][key])
        for n, v in d["optimizer"][key].items():
            assert torch.equal(z["optimizer"][key][n], v), (key, n)
    for n, v in d["model"].items():
        assert torch.equal(z["model"][n], v), n

    tcfg, _ = _cfgs(**RUNS["global_eager"][0])
    model = tvit.ViTCAM(tcfg, device="cpu")
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tckpt.restore(str(ckpt), "zero1",
                          tstate.create_train_state(model, opt))
    assert state.step == 1 and opt.count == 1
    x, y = (torch.from_numpy(a) for a in BATCHES[1])
    state, m = tstep.train_step(state, x, y)
    want = res[0]["dp_two"]
    assert abs(float(m["loss"]) - want["metrics"][1]["loss"]) <= TOL
    sd = model.state_dict()
    assert max(float((sd[k] - v).abs().max())
               for k, v in want["state"].items()) <= TOL


def test_local_batch_rows_are_jax_microbatch_stripes():
    """Microbatch k of a global batch of 8 over 2 ranks and 2 microbatches
    is rows [4k, 4k + 4), rank r its stripe [4k + 2r, 4k + 2r + 2)."""
    assert tmesh.local_batch_rows(8, 2, 0, 2) == [0, 1, 4, 5]
    assert tmesh.local_batch_rows(8, 2, 1, 2) == [2, 3, 6, 7]
    assert tmesh.local_batch_rows(8, 2, 1) == [4, 5, 6, 7]
    assert tmesh.local_batch_rows(6, 3, 2) == [4, 5]
    with pytest.raises(ValueError, match="divisible"):
        tmesh.local_batch_rows(6, 2, 0, 2)
    x = torch.arange(8.0)[:, None]
    assert tmesh.shard_batch(None, x) is x
    one = tmesh.SeqMesh(data_size=2, data_rank=1, axis_names=("data",))
    assert tmesh.shard_batch(one, x, 2)[:, 0].tolist() == [2, 3, 6, 7]
    assert tmesh.shard_batch(one, {"a": x.numpy()})["a"][:, 0].tolist() \
        == [4, 5, 6, 7]


class _Rows:
    """A dataset of n items whose image is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"name": str(i), "image": np.full((1,), float(i)),
                "label": np.zeros(2)}


@pytest.mark.parametrize("n,drop_last,accum", [(13, True, 1), (13, False, 1),
                                               (16, True, 2), (7, False, 1)])
def test_global_batch_loader_splits_the_one_process_batches(n, drop_last,
                                                            accum):
    """The ranks' batches of the global layout, put together in the step's
    order, are the one-process loader's batches; a partial last batch is
    padded with its own last sample, marked is_pad."""
    kw = dict(shuffle=True, seed=5, drop_last=drop_last, num_threads=1)
    one = list(BatchLoader(_Rows(n), 4, **kw))
    ranks = [list(BatchLoader(_Rows(n), 4 // DP, process_index=r,
                              process_count=DP, microbatches=accum, **kw))
             for r in range(DP)]
    assert all(len(r) == len(one) for r in ranks)
    for b, want in enumerate(one):
        parts = [ranks[r][b] for r in range(DP)]
        imgs = [p["image"][:, 0] for p in parts]
        mbl = len(imgs[0]) // accum
        order = np.concatenate([imgs[r][k * mbl:(k + 1) * mbl]
                                for k in range(accum) for r in range(DP)])
        pad = np.concatenate([parts[r]["is_pad"][k * mbl:(k + 1) * mbl]
                              for k in range(accum) for r in range(DP)])
        got = want["image"][:, 0]
        np.testing.assert_array_equal(order[~pad], got)
        assert (order[pad] == got[-1]).all()
        assert len(parts[0]["image"]) == len(parts[1]["image"])


def test_dp_refuses_model_and_stage_axes():
    """The 'model' and 'stage' axes build their grids (rank r at (r // m,
    r % m)); one process refuses a two-rank grid of them, as a ('data',)
    mesh of two."""
    for axes in (("data", "model"), ("data", "stage")):
        mesh = tmesh.make_mesh((1, 1), axes)
        assert mesh.axis_names == axes
        assert mesh.shape == {"data": 1, axes[1]: 1}
        assert (mesh.inner_size, mesh.inner_rank) == (1, 0)
        with pytest.raises(ValueError, match="needs 2 rank"):
            tmesh.make_mesh((1, 2), axes)
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_mesh((-1, 2), axes)
    with pytest.raises(ValueError, match="needs 2 rank"):
        tmesh.make_mesh((2,), ("data",))
    mesh = tmesh.make_mesh((-1,), ("data",))
    assert mesh.shape == {"data": 1, "seq": 1}
    assert mesh.axis_names == ("data",)
    assert tmesh.ambient_mesh() is None
    with tmesh.set_mesh(mesh):
        assert tmesh.ambient_mesh() is None      # one rank: nothing to reduce
    assert (tmesh.get_world_size(), tmesh.get_rank(),
            tmesh.is_main_process()) == (1, 0, True)
    assert tmesh.process_local_slice(10, 6) == (0, 6)
    t = torch.ones(3)
    assert tmesh.reduce_value(t) is t


def test_param_digest_sees_one_bit():
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    before = param_digest(model)
    with torch.no_grad():
        w = model.head.weight.view(-1)
        w[0] = torch.nextafter(w[0], torch.tensor(1.0, dtype=w.dtype))
    assert param_digest(model) != before


def test_dryrun_multichip_on_the_cpu(capsys):
    """The dry run's four blocks on two gloo ranks: DP step, accumulation,
    ZeRO-1 and batch-sharded CAM extraction, each against one rank; and its
    sequence-parallel block on the (1, 2) grid (N = 17 over two ranks): the
    CAMs on both attention paths and the step against one rank."""
    out = dryrun_multichip.main(["--device", "cpu", "--world", "2",
                                 "--timeout", "150"])
    assert out["ok"] and out["zero1_bit_equal"]
    assert out["sp_loss_dev"] <= dryrun_multichip.TOL["loss"]
    assert out["sp_delta_dev"] <= dryrun_multichip.TOL["delta"][0]
    for impl in ("eager", "kernel"):
        assert out[f"sp_cam_{impl}_dev"] <= dryrun_multichip.TOL["cam"][0]
    assert out["dp_delta_dev"] <= dryrun_multichip.TOL["delta"][0]
    assert sum(out["zero1_moment_elements"]) == out["dp_moment_elements"]
    assert '"ok": true' in capsys.readouterr().out
