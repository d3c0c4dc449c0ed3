"""The port's fused masked attention against the JAX TPU kernel.

The port's plain PyTorch version (what the wrapper runs on CPU tensors) is
held against vision_transformer_cam_tpu's ``masked_attention_fused`` run in
Pallas interpret mode, on packed qkv from the same seeded numpy inputs.  The
CUDA kernel itself is held against the plain version on the card
(``test_cuda_kernel_matches_plain_version``, marked ``cuda``), which runs on
a GPU machine without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax.numpy as jnp

    from vision_transformer_cam_tpu.kernels import attention as jka
except ImportError:
    jnp = jka = None

# float32 on both sides.  The two sum S, the softmax row and P.V in
# different orders; these are the JAX kernel tests' own f32 tolerances
# (tests/test_kernels.py): out 1e-5, cls row 1e-6, head mean / rollout 1e-6.
TOL = {"out": 1e-5, "cls": 1e-6, "third": 1e-6}
HEADS, DH, SCALE = 4, 16, 0.25


def _inputs(b, n, seed, hot=40.0):
    """Packed qkv [B, N, 3C] (heads contiguous inside q|k|v), random bg with
    the cls column 0, a row-stochastic joint; query rows 1-2 are scaled so
    their logits reach past the serving clamp at 80."""
    rng = np.random.default_rng(seed)
    c = HEADS * DH
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= hot
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return qkv, bg, joint


def _jax(qkv, bg, joint, variant, clamp):
    if jka is None:
        pytest.skip("needs jax (the JAX reference)")
    res = jka.masked_attention_fused(
        jnp.asarray(qkv), jnp.asarray(bg),
        jnp.asarray(joint) if variant == "rollout" else None,
        num_heads=HEADS, scale=SCALE, with_headmean=variant == "headmean",
        clamp_softmax=clamp, interpret=True)
    return [np.asarray(r) for r in res]


def _torch(fn, qkv, bg, joint, variant, clamp):
    res = fn(torch.from_numpy(qkv), torch.from_numpy(bg),
             torch.from_numpy(joint) if variant == "rollout" else None,
             num_heads=HEADS, scale=SCALE,
             with_headmean=variant == "headmean", clamp_softmax=clamp)
    return [r.numpy() for r in res]


@pytest.mark.parametrize("shape", [(2, 37), (3, 17)])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
def test_plain_version_matches_jax_kernel(variant, clamp, shape):
    qkv, bg, joint = _inputs(*shape, seed=shape[1] + 3 * clamp)
    if clamp:
        # the inputs really exercise the clamp: some logits exceed 80
        c = HEADS * DH
        s = np.einsum("bqd,bkd->bqk", qkv[:, 1:3, :DH],
                      qkv[:, :, c:c + DH]) * SCALE
        assert s.max() > 80.0
    want = _jax(qkv, bg, joint, variant, clamp)
    got = _torch(tka.masked_attention_fused_ref, qkv, bg, joint, variant,
                 clamp)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    for name, g, w in zip(("out", "cls", "third"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[name], err_msg=name)
    # cls rows are probability vectors; the head mean's row 0 is the cls row
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-5)
    if variant == "headmean":
        np.testing.assert_allclose(got[2][:, 0], got[1], atol=1e-6)


def _int8_inputs(b, n, seed, per_head):
    """int8 qkv with per-head or per-tensor (q, k, v) scales and the output
    scale; head 0's q scale makes some logits pass the clamp at 80."""
    rng = np.random.default_rng(seed)
    qkv = rng.integers(-127, 128, (b, n, 3 * HEADS * DH)).astype(np.int8)
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    if per_head:
        sc = rng.uniform(0.01, 0.03, 3 * HEADS).astype(np.float32)
        sc[0] = 0.5
    else:
        sc = np.array([0.011, 0.017, 0.023], np.float32)
    return qkv, bg, joint, np.concatenate([sc, [20.0]]).astype(np.float32)


def _run_both(qkv, bg, joint, scales, variant, clamp):
    if jka is None:
        pytest.skip("needs jax (the JAX reference)")
    kw = dict(num_heads=HEADS, scale=SCALE, clamp_softmax=clamp,
              with_headmean=variant == "headmean")
    j = joint if variant == "rollout" else None
    want = jka.masked_attention_fused(
        jnp.asarray(qkv), jnp.asarray(bg), None if j is None else
        jnp.asarray(j), jnp.asarray(scales), float_dtype=jnp.float32,
        interpret=True, **kw)
    got = tka.masked_attention_fused_ref(
        torch.from_numpy(qkv), torch.from_numpy(bg),
        None if j is None else torch.from_numpy(j), torch.from_numpy(scales),
        float_dtype=torch.float32, **kw)
    return [r.numpy() for r in got], [np.asarray(r) for r in want]


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
@pytest.mark.parametrize("option", ["int8_io_per_head", "int8_io_per_tensor",
                                    "int8_out"])
def test_plain_version_int8_options_match_jax_kernel(option, variant, clamp):
    """int8_io (int8 qkv, per-head [3H+1] or per-tensor [4] scales) and
    int8_out (float qkv, scales [1/s_out]) against the JAX kernel in
    interpret mode, float_dtype float32, N = 37.  The int8 output within
    one step on at most 1 % of the elements (the two sum P.V in another
    order before rounding; measured: equal); cls row, head mean and J' at
    1e-6 as the float variants (measured <= 4.2e-7).  int8_out leaves the
    probabilities float: its inputs are the float test's."""
    if option == "int8_out":
        qkv, bg, joint = _inputs(2, 37, seed=37 + 3 * clamp)
        scales = np.array([20.0], np.float32)
    else:
        qkv, bg, joint, scales = _int8_inputs(
            2, 37, seed=23 + clamp, per_head=option.endswith("head"))
    got, want = _run_both(qkv, bg, joint, scales, variant, clamp)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    assert got[0].dtype == want[0].dtype == np.int8
    d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    assert np.abs(got[0]).max() > 30               # not all rounded to 0
    for name, g, w in zip(("cls", "third"), got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[name], err_msg=name)


def test_int8_scales_are_checked():
    qkv, bg, _, scales = _int8_inputs(1, 9, seed=3, per_head=True)
    q, b = torch.from_numpy(qkv), torch.from_numpy(bg)
    kw = dict(num_heads=HEADS, scale=SCALE)
    with pytest.raises(ValueError, match="scales"):
        tka.masked_attention_fused(q, b, **kw)
    with pytest.raises(ValueError, match="per-head"):
        tka.masked_attention_fused(q, b, None, torch.ones(5), **kw)
    with pytest.raises(ValueError, match="int8-out"):
        tka.masked_attention_fused(q.float(), b, None, torch.ones(4), **kw)
    out, cls_row = tka.masked_attention_fused(
        q, b, None, torch.from_numpy(scales), float_dtype=torch.bfloat16, **kw)
    assert out.dtype == torch.int8 and cls_row.dtype == torch.bfloat16


def test_cpu_tensors_run_the_plain_version():
    qkv, bg, joint = _inputs(2, 37, seed=1)
    before = tka.launches
    for variant in ("plain", "headmean", "rollout"):
        got = _torch(tka.masked_attention_fused, qkv, bg, joint, variant, True)
        want = _torch(tka.masked_attention_fused_ref, qkv, bg, joint, variant,
                      True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tka.launches == before   # only CUDA launches count


def test_headmean_dtype_and_bf16_outputs():
    qkv, bg, _ = _inputs(2, 17, seed=2)
    q = torch.from_numpy(qkv).to(torch.bfloat16)
    out, cls_row, hm = tka.masked_attention_fused(
        q, torch.from_numpy(bg), num_heads=HEADS, scale=SCALE,
        with_headmean=True, hm_dtype=torch.float32)
    assert out.dtype == cls_row.dtype == torch.bfloat16
    assert hm.dtype == torch.float32 and hm.shape == (2, 17, 17)


def test_bad_shapes_raise():
    qkv, bg, joint = _inputs(2, 17, seed=4)
    q, b, j = (torch.from_numpy(a) for a in (qkv, bg, joint))
    kw = dict(num_heads=HEADS, scale=SCALE)
    with pytest.raises(ValueError):
        tka.masked_attention_fused(q[..., :-1], b, **kw)
    with pytest.raises(ValueError):
        tka.masked_attention_fused(q, b[:, :-1], **kw)
    with pytest.raises(ValueError):
        tka.masked_attention_fused(q, b, j[:, :-1], **kw)
    with pytest.raises(ValueError):
        tka.masked_attention_fused(q.to("meta"), b.to("meta"), **kw)


@pytest.mark.parametrize("q_block", [0, 16, 32])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
def test_q_block_leaves_the_plain_version_unaffected(variant, q_block):
    """q_block is the CUDA kernel's tile height: on CPU tensors the wrapper
    takes 0, 16 and 32 and the results are the plain version's."""
    qkv, bg, joint = _inputs(2, 37, seed=5)
    want = _torch(tka.masked_attention_fused_ref, qkv, bg, joint, variant,
                  True)
    got = tka.masked_attention_fused(
        torch.from_numpy(qkv), torch.from_numpy(bg),
        torch.from_numpy(joint) if variant == "rollout" else None,
        num_heads=HEADS, scale=SCALE, with_headmean=variant == "headmean",
        clamp_softmax=True, q_block=q_block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("q_block", [24, 8, 64, -16])
def test_q_block_other_than_16_or_32_is_refused(q_block):
    qkv, bg, _ = _inputs(1, 9, seed=6)
    with pytest.raises(ValueError, match=r"q_block.*\(16, 32\)"):
        tka.masked_attention_fused(torch.from_numpy(qkv),
                                   torch.from_numpy(bg), num_heads=HEADS,
                                   scale=SCALE, q_block=q_block)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["headmean", "rollout"])
def test_cuda_kernel_q_block_16_equals_32_and_reaches_n_1025(variant):
    """Both tile heights give the same float32 out bit for bit (the joint
    within 1e-6); past N = 780 only 16 rows fit and the auto choice takes
    them, a forced 32 raises with the bytes it needs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for n in (197, 1025):
        qkv = torch.randn((2, n, 3 * 768), generator=g, device="cuda")
        bg = (torch.rand((2, n), generator=g, device="cuda") < 0.3).float()
        bg[:, 0] = 0.0
        joint = torch.softmax(torch.randn((2, n, n), generator=g,
                                          device="cuda"), dim=-1)
        kw = dict(num_heads=12, scale=0.125, clamp_softmax=True,
                  with_headmean=variant == "headmean")
        j = joint if variant == "rollout" else None
        r16 = tka.masked_attention_fused(qkv, bg, j, q_block=16, **kw)
        if n == 197:
            r32 = tka.masked_attention_fused(qkv, bg, j, q_block=32, **kw)
            assert torch.equal(r16[0], r32[0]) and torch.equal(r16[1], r32[1])
            torch.testing.assert_close(r16[2], r32[2], rtol=0, atol=1e-6)
        else:
            auto = tka.masked_attention_fused(qkv, bg, j, **kw)
            assert all(torch.equal(a, b) for a, b in zip(r16, auto))
            want = tka.masked_attention_fused_ref(qkv, bg, j, **kw)
            for a, w in zip(r16, want):
                torch.testing.assert_close(a, w, atol=5e-5, rtol=1e-4)
            with pytest.raises(RuntimeError, match="shared memory"):
                tka.masked_attention_fused(qkv, bg, j, q_block=32, **kw)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card, at
    ViT-B widths (12 heads of 64) and a ragged N.  Tolerances as in
    chip_smoke.py: f32 sums in another order (hot rows put logits ~1e2
    through exp, hence rtol 1e-4); bf16 outputs within 2 bf16 ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (atol, rtol) in ((torch.float32, (5e-5, 1e-4)),
                                (torch.bfloat16, (1e-2, 2 ** -6))):
        for n in (197, 37):
            qkv = torch.randn((4, n, 3 * 768), generator=g, device="cuda")
            qkv[:, 1:4, :768] *= 40.0
            qkv = qkv.to(dtype)
            bg = (torch.rand((4, n), generator=g, device="cuda") < 0.3).float()
            bg[:, 0] = 0.0
            joint = torch.softmax(torch.randn((4, n, n), generator=g,
                                              device="cuda"), dim=-1)
            for variant in ("plain", "headmean", "rollout"):
                for clamp in (False, True):
                    kw = dict(num_heads=12, scale=0.125, clamp_softmax=clamp,
                              with_headmean=variant == "headmean")
                    j = joint if variant == "rollout" else None
                    before = tka.launches
                    got = tka.masked_attention_fused(qkv, bg, j, **kw)
                    assert tka.launches == before + 1
                    want = tka.masked_attention_fused_ref(qkv, bg, j, **kw)
                    for a, w in zip(got, want):
                        torch.testing.assert_close(
                            a.float(), w.float(), atol=atol, rtol=rtol)
