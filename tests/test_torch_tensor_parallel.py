"""The port's tensor parallelism (the 'model' mesh axis) against the JAX
package's, on the CPU.

The JAX dry run's tiny model at float64 (C 64 in 4 heads, hidden 256, depth
6, mask from block 2; JAX ``vit.init`` weights with qkv gain 10, so that
the mask engages) is trained and run by gloo ranks (``parallel.worker.
launch`` running ``tests/_dp_ranks.train_runs``) on ('data', 'model') grids
of (1, 2), (2, 2) and (1, 4) ranks, the model cut by
``parallel.shard_params`` (at (1, 4) one head a rank); JAX runs
``train_step`` / ``train_step_accum`` / ``vit.apply`` on the same mesh of
the 8 virtual CPU devices (tests/conftest.py) and unsharded.  The port's
eager and kernel paths (the kernels' plain versions here) are held to JAX
"xla" at 1e-10.  Each layout's ranks are spawned once, by the module's
fixture, and every test reads their results.
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
from vision_transformer_cam_tpu_torch import serving
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep

# the JAX dry run's tiny config (__graft_entry__.dryrun_multichip)
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=6, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4)
GAIN = 10.0
B, SPE = 8, 100
OPT = dict(lr=1e-3, warmup_epochs=0, epochs=10, linear_lr_scaling=False,
           clip_grad=0.5)
TOL = 1e-10
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
DROP = dict(drop_ratio=0.1, attn_drop_ratio=0.1)
IMPLS = ("eager", "kernel")


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


def _state_dict(cfg=None):
    return tweights.state_dict_from_jax_params(_np_tree(_params()),
                                               cfg or _cfgs()[0])


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 32, 32, 3))
    y = (rng.random((B, 20)) < 0.15).astype(np.float64)
    y[np.arange(B), rng.integers(0, 20, B)] = 1.0
    return x, y


BATCHES = [_batch(3), _batch(4)]


def _torch_batches():
    return [tuple(torch.from_numpy(a) for a in b) for b in BATCHES]


@functools.lru_cache(maxsize=None)
def _jax_tx():
    return jstate.make_optimizer(jcfgs.OptimConfig(**OPT), B, SPE)[0]


@functools.lru_cache(maxsize=None)
def _jax_step(shape=None, accum=1):
    """JAX params and metrics after one step on batch 0, on a ('data',
    'model') mesh of ``shape`` (the parameters placed by JAX
    ``shard_params``) or unsharded (None)."""
    _, jcfg = _cfgs()
    x, y = BATCHES[0]
    tx = _jax_tx()
    params = jax.tree.map(jnp.copy, _params())
    xs, ys = jnp.asarray(x), jnp.asarray(y)
    ctx = contextlib.nullcontext()
    if shape:
        mesh = jmesh.make_mesh(shape, ("data", "model"),
                               devices=jax.devices()[:shape[0] * shape[1]])
        params = jmesh.shard_params(mesh, params, model_axis="model")
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
                data_axis="data" if shape else None)
        jax.block_until_ready(state.params)
    return _np_tree(state.params), {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _jax_forward(perhead=False):
    _, jcfg = _cfgs()
    out = jvit.apply(_params(), jnp.asarray(BATCHES[1][0]), jcfg,
                     need_rollout=True, need_perhead=perhead)
    keys = ("logits", "head1_logits", "rollout_row", "attn_cls_rows",
            "top_patch_idx") + (("attn_headmean", "attn_perhead")
                                if perhead else ())
    return {k: np.asarray(getattr(out, k)) for k in keys}


def _max_dev(state, jparams):
    want = tweights.state_dict_from_jax_params(jparams, _cfgs()[0])
    assert set(state) == set(want)
    return max(float((state[k].double() - want[k].double()).abs().max())
               for k in want)


def _one_rank_steps(steps=1, rng=None, over=None, ckpt=None):
    """The port on one rank: ``steps`` steps on the batches in turn."""
    tcfg, _ = _cfgs(**(over or {}))
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict(tcfg))
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tstate.create_train_state(model, opt)
    metrics = []
    for i, (x, y) in enumerate(_torch_batches()[:steps]):
        state, m = tstep.train_step(state, x, y, rng)
        metrics.append({k: float(v) for k, v in m.items()})
        if ckpt is not None and i == 0:
            tckpt.save(str(ckpt), "one_rank", state)
    return model.state_dict(), metrics


def _spawn(layout, ckpt):
    d, m = LAYOUTS[layout]
    base, _ = _cfgs()
    batches = _torch_batches()
    eager = dict(attn_impl="eager")
    runs = {impl: (dict(attn_impl=impl), dict(steps=1), False)
            for impl in IMPLS}
    if d == 1:
        runs["dropout"] = (dict(eager, **DROP), dict(steps=1, rng=11), False)
    if layout == "2x2":
        _one_rank_steps(ckpt=ckpt)     # the checkpoint the ranks resume from
        runs.update(
            accum2=(eager, dict(accum_steps=2, steps=1), False),
            zero1=(eager, dict(zero1=True, steps=1), True),
            tp_ckpt=(eager, dict(steps=1), True),
            tp_two=(eager, dict(steps=2), False),
            resumed=(eager, dict(steps=1, restore=(str(ckpt), "one_rank"),
                                 batches=batches[1:]), False))
    fwd_x = torch.from_numpy(BATCHES[1][0])
    forwards = {f"fwd_{impl}": (dict(attn_impl=impl), fwd_x,
                                dict(need_rollout=True)) for impl in IMPLS}
    forwards["fwd_perhead"] = (eager, fwd_x, dict(need_rollout=True,
                                                  need_perhead=True))
    forwards["fwd_headmean"] = (dict(attn_impl="kernel"), fwd_x,
                                dict(need_rollout=True, need_headmean=True))
    return launch(_dp_ranks.train_runs,
                  (base, _state_dict(base), batches, runs,
                   tcfgs.OptimConfig(**OPT), B, SPE, str(ckpt), (d, m),
                   forwards),
                  world=d * m, timeout=150)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every rank's results of every run of a layout, spawned on first
    use."""
    cache = {}

    def get(layout):
        if layout not in cache:
            ckpt = tmp_path_factory.mktemp(f"ckpt{layout}")
            cache[layout] = (_spawn(layout, ckpt), ckpt)
        return cache[layout]
    return get


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_train_step_matches_jax_mesh_and_unsharded(tp, layout, impl):
    """Loss, f1, the loss parts and every parameter after the update, on
    every rank, against JAX ``train_step`` on the same ('data', 'model')
    mesh and unsharded, at 1e-10 (the clip engages: its norm sums the
    parts' squares over the model group)."""
    res, _ = tp(layout)
    for shape in (LAYOUTS[layout], None):
        jparams, jm = _jax_step(shape)
        for r in res:
            got = r[impl]["metrics"][0]
            assert set(got) == set(jm)
            for k in jm:
                assert abs(got[k] - jm[k]) <= TOL, (shape, k)
            assert _max_dev(r[impl]["state"], jparams) <= TOL


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_ranks_agree_bit_for_bit(tp, layout):
    """The leaves every rank holds whole are bit for bit equal on every rank
    after the step, the parts on every rank of a data group, and so are the
    metrics; the kernels ran at num_heads / m heads a rank."""
    res, _ = tp(layout)
    d, m = LAYOUTS[layout]
    assert [(r["data_rank"], r["model_rank"]) for r in res] == \
        [(i // m, i % m) for i in range(d * m)]
    names = [n for n in res[0] if isinstance(res[0][n], dict)
             and "digests" in res[0][n]]
    assert "eager" in names
    for name in names:
        for i, r in enumerate(res):
            assert r[name]["whole_digests"] == res[0][name]["whole_digests"]
            assert r[name]["digests"] == res[i % m][name]["digests"]
            assert r[name]["metrics"] == res[0][name]["metrics"], name
        assert res[0][name]["digests"] != res[1][name]["digests"]
    # the wrappers' plain versions here: no launch counted, the local heads
    assert res[0]["kernel"]["heads"] == [[TINY["num_heads"] // m]]
    assert res[0]["transport"] == "gloo"


def test_tp_accum2_matches_jax_train_step_accum(tp):
    """Two microbatches on the (2, 2) grid (each data rank its stripe of
    each) against JAX ``train_step_accum(..., data_axis='data')`` on the
    (2, 2) mesh and unsharded."""
    res, _ = tp("2x2")
    for shape in ((2, 2), None):
        jparams, jm = _jax_step(shape, accum=2)
        for r in res:
            got = r["accum2"]["metrics"][0]
            for k in jm:
                assert abs(got[k] - jm[k]) <= TOL, (shape, k)
        assert _max_dev(res[0]["accum2"]["state"], jparams) <= TOL


def test_tp_zero1_matches_the_tp_step_bit_for_bit(tp):
    """ZeRO-1 over (2, 2): the tensor-parallel step's parameters bit for
    bit, each rank holding half of its model part's AdamW moments."""
    res, _ = tp("2x2")
    for r in res:
        assert r["zero1"]["digests"] == r["eager"]["digests"]
        assert 2 * r["zero1"]["moment_elements"] == \
            r["eager"]["moment_elements"]
    want = res[0]["eager"]["state"]
    for k, v in want.items():
        assert torch.equal(res[0]["zero1"]["state"][k], v), k
    # a rank's model part holds half of the block GEMMs' moments
    full = sum(v.numel() for k, v in want.items())
    assert res[0]["eager"]["moment_elements"] < full


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_forward_matches_jax(tp, layout, impl):
    """The forward with ``need_rollout`` on the model-sharded parameters:
    the cls rows, the rollout row and the logits of the data group's rows
    at 1e-10 against JAX ``vit.apply``, the top-16 (here top-4) as index
    sets; every rank of a model group returns the same."""
    res, _ = tp(layout)
    d, m = LAYOUTS[layout]
    want = _jax_forward()
    name = f"fwd_{impl}"
    got = {k: torch.cat([res[i * m][name][k] for i in range(d)],
                        dim=1 if k == "attn_cls_rows" else 0)
           for k in want}
    for k in ("logits", "head1_logits", "rollout_row", "attn_cls_rows"):
        w = torch.from_numpy(np.array(want[k]))
        assert float((got[k] - w).abs().max()) <= TOL, k
    assert [set(r) for r in got["top_patch_idx"].tolist()] == \
        [set(r) for r in want["top_patch_idx"].tolist()]
    for i, r in enumerate(res):
        for k in want:
            assert torch.equal(r[name][k], res[i - i % m][name][k]), k
    # the mask engaged: some patch of every image is background
    _, bg = tvit._mask_from_cls_row(got["attn_cls_rows"][-2],
                                    _cfgs()[0])
    assert 0 < float(bg.sum()) < bg.numel()


def test_tp_forward_collects_the_head_means_and_the_heads(tp):
    """``need_perhead`` (eager) and ``need_headmean`` (the kernel's
    head-mean variant) under tensor parallelism on (1, 2): the per-head
    probabilities of both ranks' heads joined in head order and the head
    means over all heads, with the rollout carried beside them, against JAX
    ``vit.apply(need_perhead=True)`` at 1e-10."""
    res, _ = tp("1x2")
    want = _jax_forward(perhead=True)
    for name, keys in (("fwd_perhead", ("attn_perhead", "attn_headmean")),
                       ("fwd_headmean", ("attn_headmean",))):
        for r in res:
            got = r[name]
            for k in keys + ("rollout_row", "logits"):
                assert float((got[k] - torch.from_numpy(
                    np.array(want[k]))).abs().max()) <= TOL, (name, k)
    assert tuple(res[0]["fwd_perhead"]["attn_perhead"].shape[1:3]) == \
        (B, TINY["num_heads"])


@pytest.mark.parametrize("layout", ["1x2", "1x4"])
def test_tp_dropout_is_the_one_rank_dropout(tp, layout):
    """With dropout on, a rank draws the full-width masks and keeps its
    heads' and hidden units' parts: the step is the one-rank port's step
    with the same seed, at 1e-10."""
    res, _ = tp(layout)
    want, metrics = _one_rank_steps(rng=11, over=dict(DROP,
                                                      attn_impl="eager"))
    no_drop, _ = _one_rank_steps()
    for r in res:
        for k, v in metrics[0].items():
            assert abs(r["dropout"]["metrics"][0][k] - v) <= TOL, k
        assert max(float((r["dropout"]["state"][k] - v).abs().max())
                   for k, v in want.items()) <= TOL
    assert max(float((no_drop[k] - v).abs().max())
               for k, v in want.items()) > 1e-6


def test_tp_checkpoint_is_the_one_rank_checkpoint_and_resumes(tp, tmp_path):
    """A (2, 2) checkpoint holds the one-rank layout: its parameters, AdamW
    moments and count are the one-rank run's at 1e-10.  Restored on one
    rank, its next step is the (2, 2) run's second step; and the one-rank
    checkpoint restored on the (2, 2) grid takes the one-rank run's second
    step."""
    res, ckpt = tp("2x2")
    got = torch.load(ckpt / "tp_ckpt.pt", weights_only=True)
    want = torch.load(ckpt / "one_rank.pt", weights_only=True)
    assert got["step"] == want["step"] == 1
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 1
    for key in ("mu", "nu"):
        assert set(got["optimizer"][key]) == set(want["optimizer"][key])
        for n, v in want["optimizer"][key].items():
            assert float((got["optimizer"][key][n] - v).abs().max()) <= TOL
    assert set(got["model"]) == set(want["model"])
    for n, v in want["model"].items():
        assert tuple(got["model"][n].shape) == tuple(v.shape)
        assert float((got["model"][n] - v).abs().max()) <= TOL, n
    # the zero1 checkpoint is the same file
    z = torch.load(ckpt / "zero1.pt", weights_only=True)
    for key in ("mu", "nu"):
        for n, v in got["optimizer"][key].items():
            assert torch.equal(z["optimizer"][key][n], v), n

    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tckpt.restore(str(ckpt), "tp_ckpt",
                          tstate.create_train_state(model, opt))
    assert state.step == 1 and opt.count == 1
    x, y = _torch_batches()[1]
    state, m = tstep.train_step(state, x, y)
    two = res[0]["tp_two"]
    assert abs(float(m["loss"]) - two["metrics"][1]["loss"]) <= TOL
    assert max(float((model.state_dict()[k] - v).abs().max())
               for k, v in two["state"].items()) <= TOL

    one_two, metrics = _one_rank_steps(steps=2)
    for r in res:
        assert abs(r["resumed"]["metrics"][0]["loss"]
                   - metrics[1]["loss"]) <= TOL
    assert max(float((res[0]["resumed"]["state"][k] - v).abs().max())
               for k, v in one_two.items()) <= TOL


def test_param_pspecs_shard_the_jax_leaves():
    """The port's layout shards the leaves JAX ``param_pspecs`` shards, the
    same dimension of each (the port's weights are the transposes): qkv and
    fc1 weight and bias on their outputs, the proj and fc2 weights on their
    inputs; nothing without a model axis."""
    tcfg, jcfg = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    specs = tmesh.param_pspecs(model, "model")
    jspecs = jmesh.param_pspecs(_params(), "model")
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda s: isinstance(s, jax.sharding
                                                  .PartitionSpec))[0]:
        keys = [getattr(p, "key", None) for p in path]
        if "model" not in tuple(spec):
            continue
        assert keys[0] == "blocks"
        layer, leaf = ".".join(keys[1:-1]), keys[-1]
        dim = tuple(spec).index("model") - 1       # past the stacked depth
        if leaf == "kernel":
            leaf, dim = "weight", 1 - dim          # [in, out] -> [out, in]
        for i in range(tcfg.depth):
            want[f"blocks.{i}.{layer}.{leaf}"] = dim
    got = {n: s.index("model") for n, s in specs.items() if s}
    assert got == want and len(got) == 6 * tcfg.depth
    assert not any(tmesh.param_pspecs(model, None).values())


def test_shard_params_cuts_each_of_q_k_v_per_head():
    """Rank 1 of a model group of 2 holds heads 2 and 3 of each of q, k and
    v (rows 32-63 of each 64-row run of the qkv weight), the second half of
    fc1 and of the proj and fc2 inputs; ``Layout.gather`` of the parts of
    both ranks is the whole (``_join`` / ``_part`` round trip)."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict())
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    parts = []
    for j in range(2):
        mesh = tmesh.SeqMesh(data_size=1, inner_size=2, inner_rank=j,
                             axis_names=("data", "model"))
        m = tvit.ViTCAM(tcfg, device="cpu")
        m.load_state_dict(whole)
        tmesh.shard_params(mesh, m, "model")
        parts.append(m.state_dict())
    w = whole["blocks.0.attn.qkv.weight"]
    assert torch.equal(parts[1]["blocks.0.attn.qkv.weight"], torch.cat(
        [w[32:64], w[96:128], w[160:192]]))
    assert torch.equal(parts[1]["blocks.0.mlp.fc1.bias"],
                       whole["blocks.0.mlp.fc1.bias"][128:])
    assert torch.equal(parts[1]["blocks.0.attn.proj.weight"],
                       whole["blocks.0.attn.proj.weight"][:, 32:])
    assert torch.equal(parts[0]["blocks.0.mlp.fc2.bias"],
                       whole["blocks.0.mlp.fc2.bias"])
    assert isinstance(m.blocks[0].attn.qkv, tmesh.ShardedLinear)
    layout = m.layout
    for name, (dim, groups) in layout.specs.items():
        joined = tmesh._join([p[name] for p in parts], dim, groups)
        assert torch.equal(joined, whole[name]), name
        assert torch.equal(layout.part(whole)[name], parts[1][name])
    assert layout.is_part("blocks.3.mlp.fc2.weight")
    assert not layout.is_part("blocks.3.mlp.fc2.bias")


def test_shard_params_refusals():
    """Uneven cuts raise, as JAX's ``device_put`` refuses them; an int8
    model, the fused knobs and int8 serving under the model axis raise with
    the Queue 3 message; a sharded model outside a mesh with its axis
    raises; a model axis of one rank changes nothing."""
    tcfg, _ = _cfgs()
    three = tmesh.SeqMesh(data_size=1, inner_size=3, axis_names=("data",
                                                               "model"))
    with pytest.raises(ValueError, match="num_heads 4 is not a multiple"):
        tmesh.shard_params(three, tvit.ViTCAM(tcfg, device="cpu"))
    one = tmesh.SeqMesh(data_size=2, inner_size=1, axis_names=("data",
                                                            "model"))
    model = tvit.ViTCAM(tcfg, device="cpu")
    assert tmesh.shard_params(one, model) is model
    assert getattr(model, "layout", None) is None
    two = tmesh.SeqMesh(data_size=1, inner_size=2, axis_names=("data",
                                                            "model"))
    model = tmesh.shard_params(two, tvit.ViTCAM(tcfg, device="cpu"))
    x = torch.from_numpy(BATCHES[0][0][:2])
    with pytest.raises(ValueError, match="sharded over 'model'"):
        model(x)
    for knob in tvit._TP_REFUSED:
        model.cfg = tcfg.replace(**{knob: True})
        with pytest.raises(ValueError, match="Queue 3"):
            model(x)
    model.cfg = tcfg
    with pytest.raises(NotImplementedError, match="Queue 3"):
        serving.apply_serving_mode(model, "int8", calib_images=x)
    q = tvit.ViTCAM(tcfg.replace(dtype=torch.float32,
                                 param_dtype=torch.float32), device="cpu")
    serving.apply_serving_mode(q, "int8", calib_images=x.float())
    with pytest.raises(NotImplementedError, match="int8"):
        tmesh.shard_params(two, q)


def test_clip_engages_on_the_fixture():
    """The fixture's gradient norm is past ``clip_grad``: the steps above
    hold the clip's sum of squared norms over the model group."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict())
    x, y = _torch_batches()[0]
    _, _, _, grads = tstep._grads(model, x, y, None)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads])))
    assert norm > OPT["clip_grad"] * 1.5
