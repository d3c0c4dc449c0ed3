"""The zoo's widest and longest shapes trained by the port, against the JAX
package on the same weights and batches.

Two small models carry the shapes that ViT-H/14 and ViT-L/16@512 give the
training path (``tests/test_torch_zoo_serving.py``'s WIDE and LONG): heads
of width 80, the attention backward's second compiled width, and N = 1025
tokens, past the 760 rows of the backward's earlier limit and the 640 past
which the JAX package trains through XLA.  The backward's plain version
(what the wrapper runs on CPU tensors, and what the CUDA kernel is held
against on the card) is compared with the TPU kernel in Pallas interpret
mode and with the ``jax.vjp`` of the plain attention core; ``train_step`` on
the port's kernel route (the plain versions on CPU tensors) with JAX
``train_step``.  The CUDA kernels themselves run only on the card
(``test_cuda_bwd_zoo_shapes_match_plain_version``, marked ``cuda``):

    python -m pytest --noconftest -m cuda tests/test_torch_zoo_training.py
"""

import functools

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io.weights import (
    jax_params_from_state_dict, load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.train import state as tstate
from vision_transformer_cam_tpu_torch.train import step as tstep

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu import configs as jcfgs
    from vision_transformer_cam_tpu.kernels import attention as jka
    from vision_transformer_cam_tpu.models import vit as jvit
    from vision_transformer_cam_tpu.train import state as jstate
    from vision_transformer_cam_tpu.train import step as jstep
except ImportError:
    jax = jnp = jcfgs = jka = jvit = jstate = jstep = None

# ViT-H/14's shape at a small size (tests/test_torch_zoo_serving.py): patch
# 14, two heads of width 80, N = 37, the mask from block 1
WIDE = dict(img_size=84, patch_size=14, embed_dim=160, depth=3, num_heads=2,
            num_classes=20, mask_from=1, top_k_patches=4,
            representation_size=160)
# ViT-L/16@512's token count at a small width: N = 1025, the 224 model's
# weights (N = 197) through the pos-embed interpolation
LONG = dict(img_size=512, patch_size=16, embed_dim=64, depth=2, num_heads=1,
            num_classes=20, mask_from=0, top_k_patches=4)
QKV_GAIN = 10.0   # attention far from uniform, so the bg mask engages
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32} if jnp \
    else {}
OPT = dict(lr=1e-3, warmup_epochs=0, epochs=10, linear_lr_scaling=False)
# (B, H, N, dh) of the backward's cases: width 80 at the WIDE shape, and
# N = 1025 at LONG's width 64 (and width 80, the widest head at that N)
BWD_SHAPES = {"wide_dh80": (2, 2, 37, 80), "long_dh64": (1, 1, 1025, 64),
              "long_dh80": (1, 1, 1025, 80)}
TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}
# float32: the JAX kernel test's own tolerance for its backward
# (tests/test_kernels.py); bf16: both round Pb, dSb and d_qkv to bf16
# (tests/test_torch_attention_bwd.py)
KERNEL_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _need_jax():
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")


def _bwd_inputs(shape, seed=51):
    b, h, n, dh = BWD_SHAPES[shape]
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * h * dh))
    bg = (rng.random((b, n)) < 0.3).astype(np.float64)
    bg[:, 0] = 0.0
    d_out = rng.standard_normal((b, n, h * dh))
    return qkv, bg, d_out, h, dh ** -0.5


def _ref(qkv, bg, d_out, h, scale, dtype, clamp):
    dt = TDT[dtype]
    return tka.masked_attention_bwd_ref(
        torch.from_numpy(qkv).to(dt), torch.from_numpy(bg).to(dt),
        torch.from_numpy(d_out).to(dt), num_heads=h, scale=scale,
        clamp_softmax=clamp).double().numpy()


def _core_f64(qkv, bg, h, scale, mask_value=-100.0):
    """``_xla_attention_core`` (the JAX route past 640 rows, and off the TPU
    at every N) with every product in the inputs' dtype: the JAX one forms S
    in float32 whatever its inputs, so its vjp is right to float32 rounding
    only."""
    b, n, c3 = qkv.shape
    r = qkv.reshape(b, n, 3, h, c3 // 3 // h).transpose(2, 0, 3, 1, 4)
    s = jnp.einsum("bhqd,bhkd->bhqk", r[0], r[1]) * scale
    pair = jnp.minimum(bg[:, :, None] + bg[:, None, :], 1.0)
    p = jax.nn.softmax(s + (mask_value * pair)[:, None], axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", p, r[2])
    return out.transpose(0, 2, 1, 3).reshape(b, n, c3 // 3)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("dtype", sorted(KERNEL_TOL))
def test_bwd_ref_matches_jax_kernel_at_head_width_80(dtype, clamp):
    """The plain version at head width 80 against the TPU backward kernel
    (it takes the head width as a parameter) in interpret mode."""
    _need_jax()
    qkv, bg, d_out, h, scale = _bwd_inputs("wide_dh80")
    jdt = getattr(jnp, dtype)
    want = jka.masked_attention_bwd(
        jnp.asarray(qkv, jdt), jnp.asarray(bg, jnp.float32),
        jnp.asarray(d_out, jdt), num_heads=h, scale=scale,
        clamp_softmax=clamp, interpret=True)
    got = _ref(qkv, bg, d_out, h, scale, dtype, clamp)
    assert got.shape == qkv.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=KERNEL_TOL[dtype])


# the vjp of the plain core, which is the JAX training backward past 640
# rows: float64 against the float64 core (the same math in another order);
# float32 against the JAX package's own core at the JAX kernel test's
# tolerance.  The core has no clamp: no logit of these inputs reaches 80,
# where min(S, 80) without the row-max subtract is the same softmax.
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("dtype,atol", [("float64", 1e-10),
                                        ("float32", 2e-4)])
@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_bwd_ref_matches_jax_vjp_at_zoo_shapes(shape, dtype, atol, clamp):
    _need_jax()
    qkv, bg, d_out, h, scale = _bwd_inputs(shape)
    jdt = getattr(jnp, dtype)
    jbg = jnp.asarray(bg, jdt)
    if dtype == "float64":
        _, vjp = jax.vjp(lambda q: _core_f64(q, jbg, h, scale),
                         jnp.asarray(qkv, jdt))
        (want,) = vjp(jnp.asarray(d_out, jdt))
    else:
        _, vjp = jax.vjp(lambda q: jka._xla_attention_core(
            q, jbg, h, scale, -100.0), jnp.asarray(qkv, jdt))
        (want,) = vjp((jnp.asarray(d_out, jdt),
                       jnp.zeros(bg.shape, jdt)))
    got = _ref(qkv, bg, d_out, h, scale, dtype, clamp)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=atol)
    assert np.abs(got).max() > 0.1                 # not all rounded to 0


@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_fused_attention_diff_takes_the_zoo_shapes(shape):
    """On CPU tensors fused_attention_diff trains every zoo shape through the
    plain versions: its gradient equals the plain backward's bit for bit,
    and the CUDA limits (widths 64 and 80, N <= BWD_MAX_N) admit them."""
    qkv, bg, d_out, h, scale = _bwd_inputs(shape, seed=8)
    b, n, c3 = qkv.shape
    dh = c3 // 3 // h
    assert tka.bwd_design(torch.bfloat16, n, dh) == "tensor-core"
    assert tka.bwd_design(torch.float32, n, dh) == (
        "one-block" if n <= tka.BWD_ONE_BLOCK_MAX_N[dh] else "two-kernel")
    leaf = torch.from_numpy(qkv).float().requires_grad_(True)
    bgt, dot = torch.from_numpy(bg).float(), torch.from_numpy(d_out).float()
    out, cls_row = tka.fused_attention_diff(leaf, bgt, num_heads=h,
                                            scale=scale)
    got, = torch.autograd.grad(out, leaf, dot)
    want = tka.masked_attention_bwd(leaf.detach(), bgt, dot, num_heads=h,
                                    scale=scale)
    assert torch.equal(got, want) and not cls_row.requires_grad


# ---------------------------------------------------------------------------
# train_step at the two zoo shapes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _init(kind):
    """The JAX float32 init of a shape (qkv weights scaled by QKV_GAIN) as
    numpy; LONG: the 224 model's weights through the port's pos-embed
    interpolation, carried back to JAX."""
    kw = WIDE if kind == "wide" else LONG
    jcfg = jcfgs.ViTCAMConfig(**kw, dtype=jnp.float32,
                              param_dtype=jnp.float32)
    init_cfg = jcfg if kind == "wide" else jcfg.replace(img_size=224)
    params = jvit.init(init_cfg, jax.random.key(3))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * QKV_GAIN
    params = jax.tree.map(np.asarray, params)
    if kind == "long":
        tcfg = tcfgs.ViTCAMConfig(**kw)
        model = tvit.ViTCAM(tcfg, device="cpu")
        load_state_dict(model, state_dict_from_jax_params(
            params, tcfg.replace(img_size=224)))
        assert params["pos_embed"].shape[1] == 197
        params = jax_params_from_state_dict(model.state_dict(), tcfg)
    return params


def _pair(kind, dtype, jax_impl):
    """(JAX params, JAX cfg, port model on the kernel route) of one shape
    on the same weights, at ``dtype`` (float64: the float32 values
    widened)."""
    kw = WIDE if kind == "wide" else LONG
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(
        a, np.float64 if dtype == torch.float64 else np.float32)),
        _init(kind))
    jcfg = jcfgs.ViTCAMConfig(**kw, dtype=JDT[dtype], param_dtype=JDT[dtype],
                              attn_impl=jax_impl)
    tcfg = tcfgs.ViTCAMConfig(**kw, dtype=dtype, param_dtype=dtype,
                              attn_impl="kernel")
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model


def _batch(kind, b, dtype, seed=3):
    size = (WIDE if kind == "wide" else LONG)["img_size"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(dtype)
    y = (rng.random((b, 20)) < 0.15).astype(dtype)
    y[np.arange(b), rng.integers(0, 20, b)] = 1.0
    return x, y


def _param_dev(model, jparams):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jparams),
                                      model.cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    return max(float((got[k].double() - want[k].double()).abs().max())
               for k in want)


def _both_steps(kind, dtype, jax_impl, b):
    """Loss, gradients and one train_step of both packages from the same
    state.  Returns (JAX loss, port loss, JAX grads, port grads, JAX
    metrics, port metrics, JAX params after, port model after)."""
    params, jcfg, model = _pair(kind, dtype, jax_impl)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    x, y = _batch(kind, b, npdt)
    # the background mask engages: the step is not about uniform attention
    out = model(torch.from_numpy(x))
    _, bg = tvit._mask_from_cls_row(out.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel()
    (jl, _), jg = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(y), jcfg, None)
    jg = state_dict_from_jax_params(jax.tree.map(np.asarray, jg), model.cfg)
    loss, _ = tstep.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y),
                            None)
    tg = dict(zip((n for n, _ in model.named_parameters()),
                  torch.autograd.grad(loss, list(model.parameters()))))
    tx, _ = jstate.make_optimizer(jcfgs.OptimConfig(**OPT), b, 2)
    js = jstate.create_train_state(jax.tree.map(jnp.copy, params), tx)
    js, jm = jstep.train_step(js, jnp.asarray(x), jnp.asarray(y),
                              jax.random.key(1), jcfg, tx)
    opt, _ = tstate.make_optimizer(model, tcfgs.OptimConfig(**OPT), b, 2)
    ts = tstate.create_train_state(model, opt)
    ts, tm = tstep.train_step(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert ts.step == int(js.step) == 1
    return (float(jl), float(loss.detach()), jg, tg, jm, tm, js.params,
            model)


@pytest.mark.parametrize("kind", ["wide", "long"])
def test_train_step_matches_jax_f64(kind):
    """float64, the port's kernel route against JAX "xla": loss, every
    gradient and every updated parameter of one step at 1e-9 (the JAX Pallas
    path forms S in float32 whatever its inputs; it is compared at float32
    below)."""
    _need_jax()
    jl, tl, jg, tg, jm, tm, jp, model = _both_steps(kind, torch.float64,
                                                    "xla", 2)
    assert abs(jl - tl) <= 1e-9
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=0,
                                   atol=1e-9, err_msg=name)
    for k in ("loss", "f1", "loss_cls", "loss_head1"):
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-9, k
    assert _param_dev(model, jp) <= 1e-9


@pytest.mark.parametrize("kind", ["wide", "long"])
def test_train_step_matches_jax_pallas_f32(kind):
    """float32, the port's kernel route against JAX "pallas" (its Pallas
    forward in interpret mode, the vjp of its plain core backward): the
    loss within 1e-5, gradients at atol 2e-5 (the JAX package's own
    tolerance between its Pallas and XLA training paths), updated
    parameters within 2 lr (where a gradient is near zero Adam's first step
    is +-lr with the sign of the noise)."""
    _need_jax()
    jl, tl, jg, tg, jm, tm, jp, model = _both_steps(kind, torch.float32,
                                                    "pallas", 2)
    assert abs(jl - tl) <= 1e-5
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    assert _param_dev(model, jp) <= 2 * OPT["lr"] + 1e-6


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_bwd_zoo_shapes_match_plain_version():
    """The backward kernel at head width 80 (N = 37 and 257, every design
    the wrapper picks) and at N = 1025 (widths 64 and 80) against its plain
    version on the card (float32: evaluated in float64), bf16 and float32,
    30 % background and none, clamp off and on, at chip_smoke.py's
    tolerances; a second launch gives the
    same bits; fused_attention_diff's gradient is the kernel's; one past
    each width's limit and width 48 are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 2 ** -6)}
    for b, n, heads, dh in ((3, 37, 16, 80), (2, 257, 16, 80),
                            (1, 1025, 4, 64), (1, 1025, 4, 80)):
        kw = dict(num_heads=heads, scale=dh ** -0.5)
        for dtype, (atol, rtol) in tol.items():
            qkv = torch.randn((b, n, 3 * heads * dh), generator=g,
                              device="cuda").to(dtype)
            d_out = torch.randn((b, n, heads * dh), generator=g,
                                device="cuda").to(dtype)
            bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3) \
                .float()
            bg[:, 0] = 0.0
            for bg_ in (bg, torch.zeros_like(bg)):
                for clamp in (False, True):
                    before = dict(tka.bwd_width_launches)
                    got = tka.masked_attention_bwd(qkv, bg_, d_out,
                                                   clamp_softmax=clamp, **kw)
                    assert tka.bwd_width_launches[dh] == before[dh] + 1
                    # float32: the plain version in float64 on the same
                    # values (its float32 cuBLAS products round further from
                    # the exact result than the kernel at head width 80)
                    wide = (lambda t: t.double()) if dtype == torch.float32 \
                        else (lambda t: t)
                    want = tka.masked_attention_bwd_ref(
                        wide(qkv), wide(bg_), wide(d_out),
                        clamp_softmax=clamp, **kw)
                    err = (got.float() - want.float()).abs()
                    assert float((err - atol - rtol * want.float().abs()
                                  ).max()) <= 0, (b, n, dh, dtype, clamp)
                    assert torch.equal(got, tka.masked_attention_bwd(
                        qkv, bg_, d_out, clamp_softmax=clamp, **kw))
            leaf = qkv.clone().requires_grad_(True)
            out, _ = tka.fused_attention_diff(leaf, bg, **kw)
            auto, = torch.autograd.grad(out, leaf, d_out)
            assert torch.equal(auto, tka.masked_attention_bwd(qkv, bg, d_out,
                                                              **kw))
    for dh in tka.BWD_HEAD_DIMS:
        n = tka.BWD_MAX_N[dh] + 1
        qkv = torch.zeros((1, n, 3 * dh), device="cuda", requires_grad=True)
        bg = torch.zeros((1, n), device="cuda")
        with pytest.raises(ValueError, match="attn_impl='eager'"):
            tka.fused_attention_diff(qkv, bg, num_heads=1, scale=0.1)
        with pytest.raises(ValueError, match="N <="):
            tka.masked_attention_bwd(qkv.detach(), bg,
                                     torch.zeros((1, n, dh), device="cuda"),
                                     num_heads=1, scale=0.1)
    qkv = torch.zeros((1, 37, 3 * 48), device="cuda")
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, got 48"):
        tka.masked_attention_bwd(qkv, torch.zeros((1, 37), device="cuda"),
                                 torch.zeros((1, 37, 48), device="cuda"),
                                 num_heads=1, scale=0.1)
