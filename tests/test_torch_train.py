"""The port's training slice against the JAX package's, on the CPU.

Same parameters (JAX ``vit.init`` carried across by
``state_dict_from_jax_params``), same seeded numpy images and labels, then
JAX ``train_step`` / ``train_step_accum`` (``attn_impl`` "xla" and "pallas")
against the port's (``"eager"`` and ``"kernel"``, whose wrappers run their
plain versions on CPU tensors).  Dropout ratios stay at their default zero in
the parity tests: the two frameworks cannot draw the same masks.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.ops import losses as jlosses
from vision_transformer_cam_tpu.train import schedule as jsched
from vision_transformer_cam_tpu.train import state as jstate
from vision_transformer_cam_tpu.train import step as jstep
from vision_transformer_cam_tpu.utils import metrics as jmetrics
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io import weights as tweights
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import losses as tlosses
from vision_transformer_cam_tpu_torch.train import checkpoint as tckpt
from vision_transformer_cam_tpu_torch.train import loop as tloop
from vision_transformer_cam_tpu_torch.train import schedule as tsched
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep
from vision_transformer_cam_tpu_torch.utils import metrics as tmetrics
from vision_transformer_cam_tpu_torch.utils import resolve_device

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
QKV_GAIN = 20.0    # attention far from uniform, so the bg mask engages
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}
IMPL = {"eager": "xla", "kernel": "pallas"}
OPT = dict(lr=1e-3, warmup_epochs=1, epochs=10, linear_lr_scaling=False)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(dtype=torch.float64, seed=0, gain=QKV_GAIN, impl="eager",
          jax_impl=None, **kw):
    """(JAX params, JAX cfg, port model) on the same weights."""
    tcfg = tcfgs.ViTCAMConfig(**TINY, dtype=dtype, param_dtype=dtype,
                              attn_impl=impl, **kw)
    jcfg = jcfgs.ViTCAMConfig(**TINY, dtype=JDT[dtype],
                              param_dtype=JDT[dtype],
                              attn_impl=jax_impl or IMPL[impl], **kw)
    params = jvit.init(jcfg, jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * gain
    model = tvit.ViTCAM(tcfg, device="cpu")
    tweights.load_state_dict(
        model, tweights.state_dict_from_jax_params(_np_tree(params), tcfg))
    return params, jcfg, model


def _batch(b=4, seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 32, 32, 3)).astype(dtype)
    y = (rng.random((b, 20)) < 0.15).astype(dtype)
    y[np.arange(b), rng.integers(0, 20, b)] = 1.0
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_tx(steps_per_epoch=2, batch=4, **opt):
    """One optax chain per hyperparameter set, so that jit compiles each
    train step once."""
    return jstate.make_optimizer(jcfgs.OptimConfig(**opt), batch,
                                 steps_per_epoch)[0]


def _states(params, model, steps_per_epoch=2, batch=4, freeze=False, **opt):
    tx = _jax_tx(steps_per_epoch, batch, **opt)
    if freeze:
        tx = jstate.make_optimizer(
            jcfgs.OptimConfig(**opt), batch, steps_per_epoch,
            freeze_mask=jstate.trainable_mask(params, True))[0]
    js = jstate.create_train_state(jax.tree.map(jnp.copy, params), tx)
    optimizer, _ = tstate.make_optimizer(
        model, tcfgs.OptimConfig(**opt), batch, steps_per_epoch,
        freeze_mask=tstate.trainable_mask(model, True) if freeze else None)
    return js, tx, tstate.create_train_state(model, optimizer)


def _param_dev(model, jparams):
    want = tweights.state_dict_from_jax_params(_np_tree(jparams), model.cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    return max(float((got[k].double() - want[k].double()).abs().max())
               for k in want)


def _jax_grads(params, x, y, jcfg):
    (loss, _), grads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(y), jcfg, None)
    return float(loss), tweights.state_dict_from_jax_params(
        _np_tree(grads), tcfgs.ViTCAMConfig(**TINY,
                                            distilled=jcfg.distilled))


def _torch_grads(model, x, y, rng=None):
    loss, _ = tstep.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y),
                            rng)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(
        (n for n, _ in model.named_parameters()), grads))


# ---------------------------------------------------------------------------
# losses, schedule, masks, configs, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["multilabel_soft_margin_loss",
                                "dual_head_loss"])
def test_losses_match_jax(fn):
    rng = np.random.default_rng(0)
    a, b = 4 * rng.standard_normal((2, 6, 20))
    y = (rng.random((6, 20)) < 0.2).astype(np.float64)
    if fn == "dual_head_loss":
        got, gp = tlosses.dual_head_loss(*map(torch.from_numpy, (a, b, y)))
        want, wp = jlosses.dual_head_loss(*map(jnp.asarray, (a, b, y)))
        for k in ("loss_cls", "loss_head1"):
            assert abs(float(gp[k]) - float(wp[k])) <= 1e-12
    else:
        got = tlosses.multilabel_soft_margin_loss(torch.from_numpy(a),
                                                  torch.from_numpy(y))
        want = jlosses.multilabel_soft_margin_loss(jnp.asarray(a),
                                                   jnp.asarray(y))
    assert abs(float(got) - float(want)) <= 1e-12
    # bf16 logits: the loss is computed in float32
    lb = tlosses.multilabel_soft_margin_loss(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(y).bfloat16())
    assert lb.dtype == torch.float32


@pytest.mark.parametrize("epoch", range(21))
def test_schedule_matches_jax_at_epoch_boundary(epoch):
    """A 20-epoch run with 3 steps per epoch, warm-up 5: the last step of
    the epoch before, the boundary and the step after it; piecewise constant
    within an epoch, the cosine over the full ``epochs``."""
    oc = dict(lr=5e-4, epochs=20, warmup_epochs=5)
    base = tsched.scaled_base_lr(tcfgs.OptimConfig(**oc), 64)
    assert base == jsched.scaled_base_lr(jcfgs.OptimConfig(**oc), 64) \
        == 5e-4 * 64 / 512
    got = tsched.timm_cosine_schedule(tcfgs.OptimConfig(**oc), base, 3)
    want = jsched.timm_cosine_schedule(jcfgs.OptimConfig(**oc), base, 3)
    for step in (3 * epoch - 1, 3 * epoch, 3 * epoch + 1, 3 * epoch + 2):
        if step >= 0:
            assert got(step) == pytest.approx(float(want(step)), rel=1e-12,
                                              abs=0)
    assert got(3 * epoch) == got(3 * epoch + 2)
    if epoch == 5:       # warmup_prefix=False: already below base at epoch 5
        assert got(15) < base
    if epoch == 20:
        assert got(60) == pytest.approx(1e-5)


@pytest.mark.parametrize("kind", ["decay", "frozen", "unfrozen"])
@pytest.mark.parametrize("variant", ["plain", "distilled", "has_logits"])
def test_masks_match_jax_by_name(kind, variant):
    kw = {"plain": {}, "distilled": dict(distilled=True),
          "has_logits": dict(representation_size=32)}[variant]
    params, _, model = _pair(gain=1.0, **kw)
    if kind == "decay":
        got = tstate.weight_decay_mask(model)
        jmask = jstate.weight_decay_mask(params)
    else:
        got = tstate.trainable_mask(model, kind == "frozen")
        jmask = jstate.trainable_mask(params, kind == "frozen")
    # the JAX mask as arrays shaped like its parameters, through the key map
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m)),
                             jmask, params)
    want = tweights.state_dict_from_jax_params(as_arrays, model.cfg)
    assert set(got) == set(want)
    for name, flag in got.items():
        assert bool(want[name].flatten()[0]) == flag, name
    if kind == "frozen":
        on = {n.split(".")[0] for n, f in got.items() if f}
        assert {"head", "head1"} <= on <= {"head", "head1", "head_dist",
                                            "pre_logits"}
    if kind == "decay":
        assert got["cls_token"] and got["pos_embed"] \
            and not got["norm.weight"] and not got["blocks.0.attn.qkv.bias"]


@pytest.mark.parametrize("name", ["OptimConfig", "TrainConfig", "DataConfig"])
def test_train_configs_mirror_jax(name):
    j, t = getattr(jcfgs, name)(), getattr(tcfgs, name)()
    jf = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == jf
    for f in jf:
        if f == "optim":
            continue
        assert getattr(t, f) == getattr(j, f), f


def test_topk_and_f1_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((7, 20))          # no ties
    labels = (rng.random((7, 20)) < 0.2).astype(np.float64)
    labels[0] = 0.0                                # k = 0: nothing predicted
    got = tstep.topk_by_label_count(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    want = jstep.topk_by_label_count(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum(-1).tolist() == labels.sum(-1).tolist()
    f1 = tstep.f1_micro(got, torch.from_numpy(labels))
    assert float(f1) == pytest.approx(float(jstep.f1_micro(
        want, jnp.asarray(labels))), abs=1e-12)
    # ties are pinned: the lower class index wins
    tie = tstep.topk_by_label_count(torch.zeros(1, 4),
                                    torch.tensor([[1.0, 0.0, 1.0, 0.0]]))
    assert tie.tolist() == [[1.0, 1.0, 0.0, 0.0]]


def test_compute_map_matches_jax_copy():
    rng = np.random.default_rng(2)
    y = (rng.random((9, 20)) < 0.2).astype(np.float32)
    p = rng.random((9, 20)).astype(np.float32)
    p[:, 3] = p[:, 4]                              # tied scores
    assert tmetrics.compute_mAP(y, p) == jmetrics.compute_mAP(y, p)


# ---------------------------------------------------------------------------
# one step, whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_train_steps_match_jax_f64(impl):
    """float64: loss, every gradient and every updated parameter of step 1
    at 1e-9, then steps 2 and 3 (moments, the schedule's second epoch), then
    step 4 from optax moments carried across into a fresh port optimizer.

    Both port paths are held against JAX's "xla" path: the Pallas kernel
    forms S in float32 whatever its inputs, so JAX "pallas" at float64 is
    right to float32 rounding only (it is compared at float32 below)."""
    params, jcfg, model = _pair(impl=impl, jax_impl="xla")
    x, y = _batch()
    opt = dict(OPT, clip_grad=0.5)
    jl, jg = _jax_grads(params, x, y, jcfg)
    tl, tg = _torch_grads(model, x, y)
    assert abs(jl - tl) <= 1e-9
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=0,
                                   atol=1e-9, err_msg=name)
    # the mask engaged: the test is not about uniform attention
    out = model(torch.from_numpy(x))
    _, bg = tvit._mask_from_cls_row(out.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel()

    js, tx, ts = _states(params, model, **opt)
    key = jax.random.key(1)
    for step in range(3):
        js, jm = jstep.train_step(js, jnp.asarray(x), jnp.asarray(y), key,
                                  jcfg, tx)
        ts, tm = tstep.train_step(ts, torch.from_numpy(x),
                                  torch.from_numpy(y))
        assert ts.step == int(js.step) == step + 1
        for k in ("loss", "f1", "loss_cls", "loss_head1"):
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-9, (step, k)
        # Adam turns reassociation noise in near-zero gradients into a
        # step-sized change, so later steps get a looser bound
        assert _param_dev(model, js.params) <= (1e-9 if step == 0 else 1e-7)

    # step 4 from carried-across optax moments
    adam = [s for s in jax.tree.leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(adam) == 1
    fresh = tvit.ViTCAM(model.cfg, device="cpu")
    tweights.load_state_dict(fresh, tweights.state_dict_from_jax_params(
        _np_tree(js.params), model.cfg))
    optimizer, _ = tstate.make_optimizer(fresh, tcfgs.OptimConfig(**opt), 4, 2)
    optimizer.load_state_dict(tweights.optimizer_state_from_jax(
        _np_tree(adam[0].mu), _np_tree(adam[0].nu), int(adam[0].count),
        model.cfg))
    fs = tstate.TrainState(int(js.step), fresh, optimizer)
    js, jm = jstep.train_step(js, jnp.asarray(x), jnp.asarray(y), key, jcfg,
                              tx)
    fs, fm = tstep.train_step(fs, torch.from_numpy(x), torch.from_numpy(y))
    assert fs.step == 4 and optimizer.count == 4
    assert abs(float(jm["loss"]) - float(fm["loss"])) <= 1e-9
    assert _param_dev(fresh, js.params) <= 1e-9


@pytest.mark.parametrize("impl,jax_impl", [("eager", "xla"),
                                           ("kernel", "pallas"),
                                           ("kernel", "xla")])
def test_train_step_matches_jax_f32(impl, jax_impl):
    """float32: gradients at atol 2e-5, the JAX package's own tolerance
    between its Pallas and XLA training paths (tests/test_kernels.py), at
    its setting (plain init: at random init a float32 rounding flips no
    mask).  Updated parameters within 2 lr: where a gradient is near zero
    Adam's first step is +-lr with the sign of the noise."""
    params, jcfg, model = _pair(dtype=torch.float32, gain=1.0, impl=impl,
                                jax_impl=jax_impl, seed=3)
    x, y = _batch(seed=17, dtype=np.float32)
    jl, jg = _jax_grads(params, x, y, jcfg)
    tl, tg = _torch_grads(model, x, y)
    assert abs(jl - tl) <= 1e-5
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    opt = dict(OPT, warmup_epochs=0)
    js, tx, ts = _states(params, model, **opt)
    js, jm = jstep.train_step(js, jnp.asarray(x), jnp.asarray(y),
                              jax.random.key(1), jcfg, tx)
    ts, tm = tstep.train_step(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    assert _param_dev(model, js.params) <= 2 * OPT["lr"] + 1e-6


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_train_step_accum_matches_full_batch_and_jax(impl):
    """2 microbatches == the full batch (the JAX test's setting: plain init,
    where the batch-global mask norm does not change the mask), and == JAX's
    train_step_accum, float64."""
    x, y = _batch(b=8, seed=11)
    opt = dict(OPT, warmup_epochs=0)
    runs = {}
    for accum in (1, 2):
        params, jcfg, model = _pair(gain=1.0, impl=impl, jax_impl="xla",
                                    seed=2)
        _, _, ts = _states(params, model, steps_per_epoch=1, batch=8, **opt)
        xs, ys = torch.from_numpy(x), torch.from_numpy(y)
        if accum == 1:
            ts, m = tstep.train_step(ts, xs, ys)
        else:
            ts, m = tstep.train_step_accum(ts, xs, ys, accum_steps=accum)
        runs[accum] = (model, m)
    assert float(runs[1][1]["loss"]) == pytest.approx(
        float(runs[2][1]["loss"]), rel=1e-12)
    assert float(runs[1][1]["f1"]) == float(runs[2][1]["f1"])
    a, b = runs[1][0].state_dict(), runs[2][0].state_dict()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)
    js, tx, _ = _states(params, runs[1][0], steps_per_epoch=1, batch=8, **opt)
    js, jm = jstep.train_step_accum(js, jnp.asarray(x), jnp.asarray(y),
                                    jax.random.key(1), jcfg, tx, 2)
    assert abs(float(jm["loss"]) - float(runs[2][1]["loss"])) <= 1e-9
    assert _param_dev(runs[2][0], js.params) <= 1e-7
    with pytest.raises(ValueError, match="not divisible"):
        tstep.train_step_accum(ts, xs, ys, accum_steps=3)


def test_accum_sums_in_float32_under_bf16():
    """All-bf16 parameters: microbatch gradients are summed in float32 and
    rounded once after the mean."""
    cfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16)
    model = tvit.ViTCAM(cfg, device="cpu")
    seen = []
    optimizer, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), 4, 2)
    update = optimizer.update
    optimizer.update = lambda grads: (seen.extend(grads), update(grads))
    x, y = _batch(dtype=np.float32)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    ts = tstate.create_train_state(model, optimizer)
    before = [p.detach().clone() for p in model.parameters()]
    tstep.train_step_accum(ts, xs, ys, accum_steps=2)
    assert all(g.dtype == torch.bfloat16 for g in seen)
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        loss, _ = tstep.loss_fn(model, xs[sl], ys[sl], None)
        halves.append(torch.autograd.grad(loss, list(model.parameters())))
    for g, a, b in zip(seen, *halves):
        want = ((a.float() + b.float()) * 0.5).to(torch.bfloat16)
        assert torch.equal(g, want)


def test_freeze_with_clip_matches_jax():
    """freeze_backbone with clip_grad: the clip's norm counts the frozen
    parameters' gradients (it comes before the freeze mask), only the heads
    move, and weight decay does not shrink a frozen weight."""
    params, jcfg, model = _pair(impl="kernel", jax_impl="xla")
    x, y = _batch()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, tg = _torch_grads(model, x, y)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in tg.values())))
    heads = float(torch.sqrt(sum((g ** 2).sum() for n, g in tg.items()
                                 if n.startswith("head"))))
    # a threshold that the clip passes only when it counts the frozen
    # parameters' gradients
    clip = round(0.5 * (heads + total), 3)
    assert heads < clip < total
    opt = dict(OPT, warmup_epochs=0, clip_grad=clip, weight_decay=0.5)
    js, tx, ts = _states(params, model, freeze=True, **opt)
    for _ in range(2):
        js, _ = jstep.train_step(js, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.key(1), jcfg, tx)
        ts, _ = tstep.train_step(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert _param_dev(model, js.params) <= 1e-9
    after = model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved == {"head.weight", "head.bias", "head1.weight", "head1.bias"}


def test_mixed_precision_keeps_float32_masters_and_bf16_activations():
    cfg = tcfgs.ViTCAMConfig(**TINY, dtype=torch.bfloat16,
                             param_dtype=torch.float32, attn_impl="kernel")
    model = tvit.ViTCAM(cfg, device="cpu")
    optimizer, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), 4, 2)
    x, y = _batch(dtype=np.float32)
    out = model.forward_train(torch.from_numpy(x))
    assert out.tokens_prenorm.dtype == out.logits.dtype == torch.bfloat16
    loss, _ = tstep.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y),
                            None)
    assert loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)
    ts = tstate.create_train_state(model, optimizer)
    ts, m = tstep.train_step(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in optimizer.mu + optimizer.nu)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_remat_on_and_off_give_equal_gradients_with_dropout(impl):
    """Non-zero ratios at all sites: the recompute redraws the same masks,
    so the gradients are equal; another seed gives other masks, no seed
    none."""
    kw = dict(drop_ratio=0.2, attn_drop_ratio=0.1, drop_path_ratio=0.3)
    x, y = _batch()
    grads = {}
    for remat in (True, False):
        _, _, model = _pair(impl=impl, jax_impl="xla", remat=remat, **kw)
        grads[remat] = _torch_grads(model, x, y, rng=5)
    assert grads[True][0] == grads[False][0]
    for name, g in grads[True][1].items():
        np.testing.assert_allclose(g.numpy(), grads[False][1][name].numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert _torch_grads(model, x, y, rng=5)[0] == grads[False][0]
    assert _torch_grads(model, x, y, rng=6)[0] != grads[False][0]
    # rng None: dropout off, the loss of the zero-ratio model
    _, _, plain = _pair(impl=impl, jax_impl="xla")
    assert _torch_grads(model, x, y)[0] == pytest.approx(
        _torch_grads(plain, x, y)[0], abs=1e-12)


def test_dropout_masks_keep_the_expected_share():
    x = torch.ones(64, 200)
    kept = tvit._dropout(x, 0.25, 11)
    assert kept.unique().tolist() == [0.0, float(torch.tensor(1.0) / 0.75)]
    assert abs(float((kept > 0).float().mean()) - 0.75) < 0.02
    assert torch.equal(kept, tvit._dropout(x, 0.25, 11))
    path = tvit._drop_path(torch.ones(400, 3, 2), 0.5, 7)
    rows = path.reshape(400, -1)
    assert torch.all((rows == 0).all(1) | (rows == 2.0).all(1))
    assert tvit._dropout(x, 0.0, 11) is x and tvit._dropout(x, 0.5, None) is x


def test_clamp_is_neutralised_under_train():
    """softmax_clamp with logits past 80: the eval forward clamps, the
    training forward does not (its backward differentiates the unclamped
    softmax)."""
    _, _, model = _pair(impl="kernel", jax_impl="xla", gain=400.0,
                        softmax_clamp=True)
    _, _, plain = _pair(impl="kernel", jax_impl="xla", gain=400.0)
    x = torch.from_numpy(_batch()[0])
    train_out = model.forward_train(x)
    assert torch.equal(train_out.logits, plain.forward_train(x).logits)
    assert not torch.equal(model(x).logits, plain(x).logits)


def test_distilled_head_trains_and_matches_jax():
    params, jcfg, model = _pair(distilled=True)
    x, y = _batch()
    out = model.forward_train(torch.from_numpy(x))
    want = jvit.forward(params, jnp.asarray(x), jcfg, train=True)
    np.testing.assert_allclose(out.dist_logits.detach().numpy(),
                               np.asarray(want.dist_logits), atol=1e-10)
    np.testing.assert_allclose(out.logits.detach().numpy(),
                               np.asarray(want.logits), atol=1e-10)
    assert model(torch.from_numpy(x)).dist_logits is None
    jl, jg = _jax_grads(params, x, y, jcfg)
    tl, tg = _torch_grads(model, x, y)
    assert abs(jl - tl) <= 1e-9
    assert float(tg["head_dist.weight"].abs().max()) > 0
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=0,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("need", ["plain", "rollout", "headmean", "dropout"])
def test_training_attention_routing(need, monkeypatch):
    """attn_impl="kernel" under train: the plain call goes through
    fused_attention_diff; a call that needs the rollout joint, the head mean
    or attention / projection dropout goes to the eager path."""
    calls = []
    real = tvit.fused_attention_diff
    monkeypatch.setattr(tvit, "fused_attention_diff",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    kw = dict(attn_drop_ratio=0.1) if need == "dropout" else {}
    _, jcfg, model = _pair(impl="kernel", jax_impl="xla", **kw)
    x = _batch()[0]
    flags = {"rollout": dict(need_rollout=True),
             "headmean": dict(need_headmean=True)}.get(need, {})
    out = model.forward_train(torch.from_numpy(x),
                              rng=3 if need == "dropout" else None, **flags)
    assert len(calls) == (TINY["depth"] if need == "plain" else 0)
    assert out.logits.requires_grad
    assert not out.attn_cls_rows.requires_grad
    if need == "rollout":
        assert out.rollout_row.shape == (4, 17)
        eager = model.forward(torch.from_numpy(x), need_rollout=True)
        np.testing.assert_allclose(out.rollout_row.detach().numpy(),
                                   eager.rollout_row.numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# loop, checkpoint, device default, refused knobs
# ---------------------------------------------------------------------------

class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_evaluate_handles_partial_tail_batch_and_pad_rows():
    _, _, model = _pair(dtype=torch.float32, gain=1.0)
    x, y = _batch(b=7, seed=4, dtype=np.float32)
    whole = tloop.evaluate(model, _ListLoader([{"image": x, "label": y}]))
    split = tloop.evaluate(model, _ListLoader(
        [{"image": x[:4], "label": y[:4]}, {"image": x[4:], "label": y[4:]}]))
    assert whole["n_samples"] == split["n_samples"] == 7
    # per-sample mask norm would make these equal exactly; batch-global
    # normalisation couples a batch's samples, so only the count is pinned
    assert 0.0 <= split["mAP_196patch"] <= 1.0
    pad = np.array([False, False, True])
    padded = tloop.evaluate(model, _ListLoader(
        [{"image": x[:4], "label": y[:4]},
         {"image": x[4:], "label": y[4:], "is_pad": pad}]))
    assert padded["n_samples"] == 6
    probs = tstep.eval_step(model, torch.from_numpy(x))
    want = jmetrics.compute_mAP(y, probs["probs_cls"].numpy())
    assert whole["mAP_196patch"] == pytest.approx(float(np.mean(want)))


def test_train_one_epoch_steps_and_means():
    _, _, model = _pair(dtype=torch.float32, gain=1.0, impl="kernel",
                        jax_impl="xla")
    optimizer, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), 4, 3)
    ts = tstate.create_train_state(model, optimizer)
    batches = [dict(zip(("image", "label"), _batch(seed=s, dtype=np.float32)))
               for s in (1, 2, 3)]
    ts, means = tloop.train_one_epoch(ts, _ListLoader(batches), 0, 0,
                                      log_every=0)
    assert ts.step == optimizer.count == 3
    assert set(means) == {"loss", "f1", "loss_cls", "loss_head1"}
    assert means["loss"] == pytest.approx(means["loss_cls"]
                                          + means["loss_head1"], rel=1e-5)
    ts, means2 = tloop.train_one_epoch(ts, _ListLoader(batches), 0, 1,
                                       log_every=0, grad_accum=2)
    assert ts.step == 6 and np.isfinite(means2["loss"])


def test_non_finite_loss_aborts():
    _, _, model = _pair(dtype=torch.float32, gain=1.0)
    optimizer, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), 4, 1)
    ts = tstate.create_train_state(model, optimizer)
    x, y = _batch(dtype=np.float32)
    x[0, 0, 0, 0] = np.nan
    with pytest.raises(SystemExit):
        tloop.train_one_epoch(ts, _ListLoader([{"image": x, "label": y}]),
                              None, 0)


def test_checkpoint_roundtrip_and_latest_tag(tmp_path):
    _, _, model = _pair(dtype=torch.float32, gain=1.0)
    opt = tcfgs.OptimConfig(**OPT)
    optimizer, _ = tstate.make_optimizer(model, opt, 4, 2)
    ts = tstate.create_train_state(model, optimizer)
    x, y = (torch.from_numpy(a) for a in _batch(dtype=np.float32))
    ts, _ = tstep.train_step(ts, x, y)
    assert tckpt.latest_tag(str(tmp_path / "none")) is None
    assert tckpt.latest_tag(str(tmp_path)) is None
    tckpt.save(str(tmp_path), "run-cur_ep9-bestloss", ts)
    old = os.path.join(str(tmp_path), "run-cur_ep9-bestloss.pt")
    os.utime(old, (1, 1))
    ts, _ = tstep.train_step(ts, x, y)
    tckpt.save(str(tmp_path), "run-cur_ep15-final", ts)
    # newest by mtime: "ep9" sorts after "ep15" as a string
    assert tckpt.latest_tag(str(tmp_path)) == "run-cur_ep15-final"

    fresh = tvit.ViTCAM(model.cfg, device="cpu",
                        generator=torch.Generator().manual_seed(9))
    fopt, _ = tstate.make_optimizer(fresh, opt, 4, 2)
    fs = tckpt.restore(str(tmp_path), "run-cur_ep15-final",
                       tstate.create_train_state(fresh, fopt))
    assert fs.step == 2 and fopt.count == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    for a, b in zip(optimizer.mu + optimizer.nu, fopt.mu + fopt.nu):
        assert torch.equal(a, b)
    # the resumed run takes the same third step
    ts, m1 = tstep.train_step(ts, x, y)
    fs, m2 = tstep.train_step(fs, x, y)
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    # a checkpoint is also a weights container
    other = tvit.ViTCAM(model.cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    tweights.load_weights(old, other)
    assert not torch.equal(other.head.weight, model.head.weight)


def test_load_weights_pretrain_head_surgery(tmp_path):
    """A reference-format pretrained .pth: head and pre_logits keys are
    dropped, the model keeps its own heads."""
    cfg = tcfgs.ViTCAMConfig(**TINY)
    src = tvit.ViTCAM(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    sd["head.weight"] = torch.zeros(1000, 64)        # another task's head
    sd["head.bias"] = torch.zeros(1000)
    sd["pre_logits.fc.weight"] = torch.zeros(64, 64)
    sd["pre_logits.fc.bias"] = torch.zeros(64)
    path = str(tmp_path / "pretrained.pth")
    torch.save(sd, path)
    model = tvit.ViTCAM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(2))
    head = model.head.weight.detach().clone()
    tweights.load_weights(path, model, del_keys=tweights.PRETRAIN_DEL_KEYS)
    assert torch.equal(model.head.weight, head)
    assert torch.equal(model.blocks[0].attn.qkv.weight,
                       src.blocks[0].attn.qkv.weight)
    with pytest.raises((KeyError, ValueError)):
        tweights.load_weights(path, model)
    assert tweights.PRETRAIN_DEL_KEYS == \
        __import__("vision_transformer_cam_tpu.io.weights",
                   fromlist=["x"]).PRETRAIN_DEL_KEYS


@pytest.mark.parametrize("knob", [dict(mesh_shape=(-1, 2),
                                       mesh_axes=("data", "seq")),
                                  dict(pipeline=2),
                                  dict(pp_microbatches=4),
                                  dict(mesh_shape=(1, 2),
                                       mesh_axes=("data", "model")),
                                  dict(mesh_shape=(-1, 2),
                                       mesh_axes=("data", "model"))])
def test_unported_train_knobs_raise(knob):
    """Tensor-parallel, pipeline and sequence-parallel training stay
    refused; the ('data',) mesh and ZeRO-1 are ported."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tloop.check_supported(tcfgs.TrainConfig(**knob))
    with pytest.raises(NotImplementedError):
        tloop.fit(tcfgs.ViTCAMConfig(**TINY), tcfgs.TrainConfig(**knob),
                  tcfgs.DataConfig(), tcfgs.DataConfig(), device="cpu")
    tloop.check_supported(tcfgs.TrainConfig(mesh_shape=(1,)))
    tloop.check_supported(tcfgs.TrainConfig(mesh_shape=(2,), zero1=True))


@pytest.mark.parametrize("entry", ["resolve_device", "ViTCAM", "fit"])
def test_default_device_is_the_card_and_never_the_cpu(entry):
    """Without a device argument the entry points run on the card; where
    there is none they raise (and never move to the CPU on their own)."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "resolve_device":
            resolve_device(None)
        elif entry == "ViTCAM":
            tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY))
        else:
            tloop.fit(tcfgs.ViTCAMConfig(**TINY), tcfgs.TrainConfig(),
                      tcfgs.DataConfig(), tcfgs.DataConfig())
    assert resolve_device("cpu").type == "cpu"


def test_only_adamw_is_implemented():
    model = tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY), device="cpu")
    with pytest.raises(NotImplementedError):
        tstate.make_optimizer(model, tcfgs.OptimConfig(opt="sgd"), 4, 1)


def test_kernel_bwd_limit_is_stated():
    """The CUDA backward's N limits follow from the shared memory of its
    float32 designs, per head width dh (floats of the 227 KB a block may
    use): one block per head keeps dK and dV beside two [32, N] tiles; the
    two-kernel design's dQ kernel keeps two [QB, N] tiles of 32 query rows,
    or 16 past them.  The bf16 tensor-core design's dQ kernel grows by one
    float a key (two stages of K and V slabs beside the key mask), so it
    takes every N that the float32 designs take."""
    pad = lambda n: (n + 3) // 4 * 4                          # noqa: E731
    ceil64 = lambda n: (n + 63) // 64 * 64                    # noqa: E731
    one = lambda n, dh: ((2 * dh + 64) * pad(n) + n + 64 * dh  # noqa: E731
                         + 64 * (dh + 4) + 32)
    two = lambda n, dh, qb: (2 * qb * pad(n) + n + 2 * qb * dh  # noqa: E731
                             + 64 * (dh + 4) + qb)
    assert all(one(n, 64) == 192 * pad(n) + n + 8480 for n in (37, 256))
    assert all(two(n, 64, 32) == 64 * pad(n) + n + 8480 for n in (37, 760))
    assert tka.BWD_HEAD_DIMS == (64, 80)
    rows32 = {64: 760, 80: 732}
    for dh in tka.BWD_HEAD_DIMS:
        for floats, n in ((lambda n: one(n, dh), tka.BWD_ONE_BLOCK_MAX_N[dh]),
                          (lambda n: two(n, dh, 32), rows32[dh]),
                          (lambda n: two(n, dh, 16), tka.BWD_MAX_N[dh])):
            assert floats(n) * 4 <= 232448 < floats(n + 1) * 4
        pitch = 64 if dh == 64 else dh + 8      # bf16 elements a staged row
        tc = 4 * 64 * pitch * 2 + 4 * ceil64(tka.BWD_MAX_N[dh])
        assert tc <= 232448
    assert tka.BWD_ONE_BLOCK_MAX_N == {64: 256, 80: 208}
    assert min(tka.BWD_MAX_N.values()) >= 1025  # ViT-L/16@512's N
    assert tka.BWD_MAX_N[64] >= 640     # the TPU kernel's longest sequence