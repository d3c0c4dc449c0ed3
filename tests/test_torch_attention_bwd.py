"""The port's fused attention backward against the JAX package's.

``masked_attention_bwd_ref`` (what the wrapper runs on CPU tensors, and what
the CUDA kernel is held against on the card) is compared with the TPU kernel
``masked_attention_bwd`` run in Pallas interpret mode and with the ``jax.vjp``
of the plain attention core, on the same seeded numpy inputs;
``fused_attention_diff`` is gradchecked and held against the JAX custom_vjp of
the same name.  The CUDA kernel itself runs only on the card
(``test_cuda_bwd_kernel_matches_plain_version``, marked ``cuda``):

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bwd.py
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu.kernels import attention as jka
except ImportError:
    jax = jnp = jka = None

# (B, H, N, dh): the JAX kernel test's shape, and one at the CUDA kernel's
# head width
SHAPES = {"h4_dh16": (2, 4, 37, 16), "h2_dh64": (2, 2, 37, 64)}
TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


def _inputs(shape, seed=51):
    b, h, n, dh = SHAPES[shape]
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


def _need_jax():
    if jka is None:
        pytest.skip("needs jax (the JAX reference)")


# float32: the JAX kernel test's own tolerance for its backward
# (tests/test_kernels.py); bf16: both round Pb, dSb and d_qkv to bf16 (values
# reach about 2, a bf16 ulp there is 1.6e-2)
KERNEL_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("dtype", sorted(KERNEL_TOL))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_ref_matches_jax_kernel(shape, dtype, clamp):
    _need_jax()
    qkv, bg, d_out, h, scale = _inputs(shape)
    jdt = getattr(jnp, dtype)
    want = jka.masked_attention_bwd(
        jnp.asarray(qkv, jdt), jnp.asarray(bg, jnp.float32),
        jnp.asarray(d_out, jdt), num_heads=h, scale=scale,
        clamp_softmax=clamp, interpret=True)
    got = _ref(qkv, bg, d_out, h, scale, dtype, clamp)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=KERNEL_TOL[dtype])


def _core_f64(qkv, bg, h, scale, mask_value=-100.0):
    """``_xla_attention_core`` with every product in the inputs' dtype: the
    JAX one forms S in float32 whatever its inputs, so its vjp is right to
    float32 rounding only."""
    b, n, c3 = qkv.shape
    r = qkv.reshape(b, n, 3, h, c3 // 3 // h).transpose(2, 0, 3, 1, 4)
    s = jnp.einsum("bhqd,bhkd->bhqk", r[0], r[1]) * scale
    pair = jnp.minimum(bg[:, :, None] + bg[:, None, :], 1.0)
    p = jax.nn.softmax(s + (mask_value * pair)[:, None], axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", p, r[2])
    return out.transpose(0, 2, 1, 3).reshape(b, n, c3 // 3)


# the vjp of the plain core.  float64 against the float64 core: the same
# math in another order.  float32 against the JAX package's own core at the
# JAX kernel test's tolerance.  The core has no clamp: with these inputs no
# logit reaches 80, where min(S, 80) without the row-max subtract is the same
# softmax.
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("dtype,atol", [("float64", 1e-10),
                                        ("float32", 2e-4)])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_ref_matches_jax_vjp(shape, dtype, atol, clamp):
    _need_jax()
    qkv, bg, d_out, h, scale = _inputs(shape)
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


@pytest.mark.parametrize("clamp", [False, True])
def test_fused_attention_diff_gradcheck(clamp):
    """float64 gradcheck on the CPU route (both plain versions); the cls row
    is not differentiable and bg gets no gradient."""
    rng = np.random.default_rng(3)
    b, h, n, dh = 2, 2, 7, 4
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * dh))) \
        .requires_grad_(True)
    bg = torch.from_numpy((rng.random((b, n)) < 0.3).astype(np.float64))
    bg[:, 0] = 0.0
    bg.requires_grad_(True)

    def out_of(x):
        return tka.fused_attention_diff(x, bg, num_heads=h, scale=0.5,
                                        clamp_softmax=clamp)[0]
    assert torch.autograd.gradcheck(out_of, (qkv,), atol=1e-8)
    out, cls_row = tka.fused_attention_diff(qkv, bg, num_heads=h, scale=0.5,
                                            clamp_softmax=clamp)
    assert out.requires_grad and not cls_row.requires_grad
    d_qkv, d_bg = torch.autograd.grad(out.sum(), (qkv, bg),
                                      allow_unused=True)
    assert d_bg is None and d_qkv.shape == qkv.shape
    want_out, want_cls = tka.masked_attention_fused_ref(
        qkv.detach(), bg.detach(), num_heads=h, scale=0.5,
        clamp_softmax=clamp)
    assert torch.equal(out.detach(), want_out)
    assert torch.equal(cls_row, want_cls)


def test_fused_attention_diff_matches_jax_custom_vjp():
    """Gradient of a scalar of the attention output through the port's
    Function and through the JAX custom_vjp (Pallas forward in interpret
    mode, vjp of the plain core backward), float32."""
    _need_jax()
    qkv, bg, d_out, h, scale = _inputs("h4_dh16", seed=7)
    w = jnp.asarray(d_out, jnp.float32)

    def jloss(q):
        out, _ = jka.fused_attention_diff(q, jnp.asarray(bg, jnp.float32), h,
                                          scale, -100.0)
        return jnp.sum(out * w)
    want = jax.grad(jloss)(jnp.asarray(qkv, jnp.float32))
    leaf = torch.from_numpy(qkv).float().requires_grad_(True)
    out, _ = tka.fused_attention_diff(leaf, torch.from_numpy(bg).float(),
                                      num_heads=h, scale=scale)
    got, = torch.autograd.grad((out * torch.from_numpy(d_out).float()).sum(),
                               leaf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_forward_wrapper_refuses_gradient_tracking_off_the_function():
    """The CPU route of the plain forward is plain torch and differentiable;
    the CUDA route raises on a tensor that requires a gradient, so training
    code must go through ``fused_attention_diff`` (checked on the card by
    the cuda test)."""
    qkv = torch.randn(1, 5, 3 * 2 * 4, requires_grad=True)
    out, cls_row = tka.fused_attention_diff(qkv, torch.zeros(1, 5),
                                            num_heads=2, scale=0.5)
    assert out.grad_fn is not None and cls_row.grad_fn is None


@pytest.mark.parametrize("bad", ["d_out_shape", "bg_shape", "heads"])
def test_bwd_shape_checks(bad):
    qkv, bg, d_out = torch.randn(2, 5, 24), torch.zeros(2, 5), \
        torch.randn(2, 5, 8)
    heads = 2
    if bad == "d_out_shape":
        d_out = d_out[:, :4]
    elif bad == "bg_shape":
        bg = bg[:, :4]
    else:
        heads = 5
    with pytest.raises(ValueError):
        tka.masked_attention_bwd(qkv, bg, d_out, num_heads=heads, scale=0.5)


@pytest.mark.cuda
def test_cuda_bwd_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(num_heads=12, scale=0.125)
    for dtype, (atol, rtol) in ((torch.float32, (1e-4, 1e-4)),
                                (torch.bfloat16, (5e-3, 2 ** -6))):
        for n in (197, 37, 577):
            qkv = torch.randn((4, n, 3 * 768), generator=g,
                              device="cuda").to(dtype)
            d_out = torch.randn((4, n, 768), generator=g,
                                device="cuda").to(dtype)
            bg = (torch.rand((4, n), generator=g, device="cuda") < 0.3) \
                .float()
            bg[:, 0] = 0.0
            # 30 % background, then none and all (the mask off both ways)
            for bg_ in (bg, torch.zeros_like(bg), torch.ones_like(bg)):
                before = tka.bwd_launches
                got = tka.masked_attention_bwd(qkv, bg_, d_out, **kw)
                assert tka.bwd_launches == before + 1
                want = tka.masked_attention_bwd_ref(qkv, bg_, d_out, **kw)
                err = (got.float() - want.float()).abs()
                assert float((err - atol - rtol * want.float().abs()
                              ).max()) <= 0
                # every design sums in a fixed order: the same bits again
                assert torch.equal(
                    got, tka.masked_attention_bwd(qkv, bg_, d_out, **kw))
            got = tka.masked_attention_bwd(qkv, bg, d_out, **kw)
            leaf = qkv.clone().requires_grad_(True)
            out, _ = tka.fused_attention_diff(leaf, bg, **kw)
            auto, = torch.autograd.grad(out, leaf, d_out)
            assert torch.equal(auto, got)
            with pytest.raises(ValueError):
                tka.masked_attention_fused(leaf, bg, **kw)
    # past the limit the wrappers raise: no other route on the card
    n = tka.BWD_MAX_N[64] + 1
    qkv = torch.zeros((1, n, 3 * 768), device="cuda", requires_grad=True)
    bg = torch.zeros((1, n), device="cuda")
    with pytest.raises(ValueError, match="N <="):
        tka.fused_attention_diff(qkv, bg, **kw)
    with pytest.raises(ValueError, match="N <="):
        tka.masked_attention_bwd(qkv.detach(), bg,
                                 torch.zeros((1, n, 768), device="cuda"),
                                 **kw)
