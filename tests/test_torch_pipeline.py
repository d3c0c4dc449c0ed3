"""The port's pipeline over depth (``parallel.pipeline``, the 'stage' mesh
axis) against the JAX package's, on the CPU.

The JAX dry run's tiny model at float64 with the per-sample mask norm (JAX
``vit.init`` weights, qkv gain 10, so that the mask engages) on the eager
path, as JAX runs its XLA path here.  Gloo ranks (``parallel.worker.
launch`` running ``tests/_dp_ranks.pipeline_runs``) on ('data', 'stage')
grids of (1, 2) and (2, 2) ranks run ``pipeline_forward`` at 1, 2 and 4
microbatches and one ``pipeline_train_step``; JAX runs its
``pipeline_forward`` and ``pipeline_train_step`` on the same mesh of the 8
virtual CPU devices, and ``vit.apply`` unsharded.  Each layout's ranks are
spawned once, by the module's fixture."""

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
from vision_transformer_cam_tpu.parallel import pipeline as jpp
from vision_transformer_cam_tpu.train import state as jstate
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel import pipeline as tpp
from vision_transformer_cam_tpu_torch.parallel.worker import launch
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import loop as tloop
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=6, num_heads=4,
            num_classes=20, mask_from=2, top_k_patches=4,
            per_sample_mask_norm=True)
GAIN = 10.0
B, SPE = 8, 100
OPT = dict(lr=1e-3, warmup_epochs=0, epochs=10, linear_lr_scaling=False,
           clip_grad=0.5)
TOL = 1e-10
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}
MICRO = (2, 1, 4)          # the train step takes the first
FIELDS = ("logits", "head1_logits", "rollout_row", "attn_cls_rows")


def _cfgs():
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.float64,
                              param_dtype=torch.float64, attn_impl="eager")
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=jnp.float64,
                              param_dtype=jnp.float64, attn_impl="xla")
    return tcfg, jcfg


@functools.lru_cache(maxsize=None)
def _params():
    params = jvit.init(_cfgs()[1], jax.random.key(3))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * GAIN
    return params


def _state_dict():
    return tweights.state_dict_from_jax_params(
        jax.tree.map(np.asarray, _params()), _cfgs()[0])


def _batch():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 32, 32, 3))
    y = (rng.random((B, 20)) < 0.15).astype(np.float64)
    y[np.arange(B), rng.integers(0, 20, B)] = 1.0
    return x, y


X, Y = _batch()


def _jmesh(layout):
    d, s = LAYOUTS[layout]
    return jmesh.make_mesh((d, s), ("data", "stage"),
                           devices=jax.devices()[:d * s])


@functools.lru_cache(maxsize=None)
def _jax_pipeline(layout, m):
    d, _ = LAYOUTS[layout]
    out = jpp.pipeline_forward(_params(), jnp.asarray(X), _cfgs()[1],
                               _jmesh(layout), data_axis="data" if d > 1
                               else None, microbatches=m, need_rollout=True)
    return {k: np.asarray(getattr(out, k)) for k in FIELDS + (
        "top_patch_idx",)}


@functools.lru_cache(maxsize=None)
def _jax_apply():
    out = jvit.apply(_params(), jnp.asarray(X), _cfgs()[1],
                     need_rollout=True)
    return {k: np.asarray(getattr(out, k)) for k in FIELDS + (
        "top_patch_idx",)}


@functools.lru_cache(maxsize=None)
def _jax_tx():
    return jstate.make_optimizer(jcfgs.OptimConfig(**OPT), B, SPE)[0]


@functools.lru_cache(maxsize=None)
def _jax_train(layout):
    d, _ = LAYOUTS[layout]
    mesh = _jmesh(layout)
    tx = _jax_tx()
    params = jpp.stage_shard_params(mesh, jax.tree.map(jnp.copy, _params()))
    state = jstate.create_train_state(params, tx)
    state, m = jpp.pipeline_train_step(
        state, jnp.asarray(X), jnp.asarray(Y), _cfgs()[1], tx, mesh,
        data_axis="data" if d > 1 else None, microbatches=MICRO[0])
    return jax.tree.map(np.asarray, state.params), \
        {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    """Every rank's results of a layout, spawned on first use."""
    cache = {}

    def get(layout):
        if layout not in cache:
            d, s = LAYOUTS[layout]
            ckpt = tmp_path_factory.mktemp(f"pp{layout}")
            cache[layout] = (launch(
                _dp_ranks.pipeline_runs,
                (_cfgs()[0], _state_dict(), torch.from_numpy(X),
                 torch.from_numpy(Y), (d, s), MICRO,
                 tcfgs.OptimConfig(**OPT), B, SPE, str(ckpt)),
                world=d * s, timeout=150), ckpt)
        return cache[layout]
    return get


def _rows(layout, rank, m):
    d, s = LAYOUTS[layout]
    return tmesh.local_batch_rows(B, d, rank // s, m)


@pytest.mark.parametrize("m", MICRO)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_forward_matches_jax(pp, layout, m):
    """Every rank's outputs (its rows of ``shard_batch(mesh, x, M)``)
    against JAX ``pipeline_forward`` on the same mesh and JAX ``vit.apply``
    with the per-sample norm, at 1e-10; the top-16 (here top-4) as index
    sets."""
    res, _ = pp(layout)
    for want in (_jax_pipeline(layout, m), _jax_apply()):
        for rank, r in enumerate(res):
            rows = _rows(layout, rank, m)
            got = r[f"fwd{m}"]
            for k in FIELDS:
                w = torch.from_numpy(np.array(want[k]))
                w = w[:, rows] if k == "attn_cls_rows" else w[rows]
                assert float((got[k] - w).abs().max()) <= TOL, k
            assert [set(t) for t in got["top_patch_idx"].tolist()] == \
                [set(t) for t in want["top_patch_idx"][rows].tolist()]


def test_pipeline_fixture_engages_the_mask():
    cls_rows = torch.from_numpy(np.array(_jax_apply()["attn_cls_rows"]))
    _, bg = tvit._mask_from_cls_row(cls_rows[-2], _cfgs()[0])
    assert 0 < float(bg.sum()) < bg.numel()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_train_step_matches_jax(pp, layout):
    """One ``pipeline_train_step`` (2 microbatches, the clip engaged)
    against JAX ``pipeline_train_step`` on the same mesh: loss, parts and
    every parameter at 1e-10 on every rank; each stage holds its three of
    the six blocks."""
    res, _ = pp(layout)
    jparams, jm = _jax_train(layout)
    want = tweights.state_dict_from_jax_params(jparams, _cfgs()[0])
    d, s = LAYOUTS[layout]
    for rank, r in enumerate(res):
        for k in jm:
            assert abs(r["metrics"][k] - jm[k]) <= TOL, k
        assert r["blocks"] == list(range(3 * (rank % s), 3 * (rank % s) + 3))
        assert set(r["state"]) == set(want)
        assert max(float((r["state"][k] - v).abs().max())
                   for k, v in want.items()) <= TOL
        assert r["metrics"] == res[0]["metrics"]
    # and the one-rank train_step of the port, with its f1
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict())
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state, m = tstep.train_step(tstate.create_train_state(model, opt),
                                torch.from_numpy(X), torch.from_numpy(Y))
    assert abs(float(m["f1"]) - res[0]["metrics"]["f1"]) <= TOL
    assert max(float((model.state_dict()[k] - v).abs().max())
               for k, v in res[0]["state"].items()) <= TOL


def test_pipeline_checkpoint_resumes_on_one_rank(pp):
    """The pipeline's checkpoint holds every block (gathered from the
    stages) and its moments; it restores into a one-rank model."""
    res, ckpt = pp("1x2")
    sd = torch.load(ckpt / "pipeline.pt", weights_only=True)
    assert set(sd["model"]) == set(res[0]["state"])
    assert set(sd["optimizer"]["mu"]) == set(res[0]["state"])
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    state = tckpt.restore(str(ckpt), "pipeline",
                          tstate.create_train_state(model, opt))
    assert state.step == 1 and opt.count == 1
    for k, v in res[0]["state"].items():
        assert torch.equal(model.state_dict()[k], v), k


def _mesh(stages, rank=0):
    return tmesh.SeqMesh(data_size=1, inner_size=stages, inner_rank=rank,
                         axis_names=("data", "stage"))


def test_pipeline_requires_per_sample_mask_norm():
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    x = torch.from_numpy(X)
    with pytest.raises(ValueError, match="per_sample_mask_norm"):
        tpp.pipeline_forward(model, x, tcfg.replace(
            per_sample_mask_norm=False), _mesh(1))


@pytest.mark.parametrize("knob", [dict(attn_impl="kernel"),
                                  dict(mlp_fusion=True),
                                  dict(attn_block_fusion=True)])
def test_pipeline_refuses_the_kernel_knobs(knob):
    """JAX refuses its Pallas knobs here and runs XLA; the port refuses the
    kernel path and the fused knobs and runs the eager blocks."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="eager block path"):
        tpp.pipeline_forward(model, torch.from_numpy(X),
                             tcfg.replace(**knob), _mesh(1))


def test_pipeline_shape_guards():
    """Depth 6 over 4 stages, a batch of 8 over 3 microbatches, a mesh
    without a stage axis and a model that is not stage-sharded in the train
    step are refused; a stage-sharded model refuses the plain forward."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    x = torch.from_numpy(X)
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        tpp.pipeline_forward(model, x, tcfg, _mesh(4))
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        tpp.stage_shard_params(_mesh(4), model)
    with pytest.raises(ValueError, match="not divisible by 3 micro"):
        tpp.pipeline_forward(model, x, tcfg, _mesh(1), microbatches=3)
    with pytest.raises(ValueError, match="'stage'"):
        tpp.pipeline_forward(model, x, tcfg, tmesh.make_mesh())
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), B, SPE)
    with pytest.raises(ValueError, match="stage-sharded"):
        tpp.pipeline_train_step(tstate.create_train_state(model, opt), x,
                                torch.from_numpy(Y), _mesh(1))
    tpp.stage_shard_params(_mesh(2, rank=1), model)
    assert [b is None for b in model.blocks] == [True] * 3 + [False] * 3
    with pytest.raises(ValueError, match="pipeline_forward"):
        model(x)


def test_one_stage_pipeline_is_the_one_rank_forward():
    """A pipeline of one stage in one process is the plain eager forward
    with the per-sample norm, at every microbatch count."""
    tcfg, _ = _cfgs()
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(model, _state_dict())
    x = torch.from_numpy(X)
    want = model(x, need_rollout=True)
    for m in (1, 8):
        got = tpp.pipeline_forward(model, x, tcfg, _mesh(1), microbatches=m,
                                   need_rollout=True)
        for k in FIELDS:
            assert float((getattr(got, k) - getattr(want, k)).abs().max()) \
                <= TOL, k


@pytest.mark.parametrize("bad", [dict(grad_accum=2), dict(zero1=True),
                                 dict(drop="drop_ratio"),
                                 dict(drop="drop_path_ratio")])
def test_fit_pipeline_guards(bad, tmp_path):
    """JAX's guards in ``fit``: no accumulation or ZeRO-1 with the pipeline,
    and zero drop ratios (a pipeline of one stage, so that one process
    reaches them)."""
    tcfg, _ = _cfgs()
    drop = bad.pop("drop", None)
    if drop:
        tcfg = tcfg.replace(**{drop: 0.1})
    train_cfg = tcfgs.TrainConfig(mesh_shape=(-1, 1),
                                  mesh_axes=("data", "stage"), pipeline=1,
                                  batch_size=4, **bad)
    data = tcfgs.DataConfig(img_name_list_path=str(tmp_path / "none.txt"),
                            voc12_root=str(tmp_path))
    with pytest.raises(ValueError, match="pipeline|--grad_accum"):
        tloop.fit(tcfg, train_cfg, data, data, device="cpu")
