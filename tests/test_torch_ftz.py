"""The denormal flush of the tensor-core kernels, held to the JAX package.

The tensor-core designs of the fused attention forward (bf16 and int8 qkv),
of the sequence-parallel kernel, of the attention backward and of the
attention block kernel's core flush exponentials and probabilities below
2^-126 (the float32 denormals) to zero: a masked logit is s - 100, and
exp(-100) is a denormal, on whose slow path exp would run.  The TPU flushes
them too.  Here the plain versions run with every exponential below 2^-126
set to zero, and must stay within the parity tolerances of the unflushed
plain versions against the JAX kernels (Pallas interpret mode, float32, on
the CPU): ``tests/test_torch_attention.py``'s (out 1e-5, cls row, head mean
and rollout 1e-6; an int8 out within one step on at most 1 %),
``tests/test_torch_seq.py``'s (out 1e-5, row0 and the head mean 1e-6),
``tests/test_torch_attention_bwd.py``'s (2e-4) and
``tests/test_torch_fusions.py``'s (tokens 2e-4, cls row and rollout 1e-5).
The inputs make the flush bite: a background of all but the cls token, and
hot query rows whose logits pass the clamp at 80.

The wrappers' design rules (which design and scratch each dtype and length
gets) are tested here too: they decide what runs on the card.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_transformer_cam_tpu.kernels import attention as jattn
from vision_transformer_cam_tpu_torch import configs
from vision_transformer_cam_tpu_torch.kernels import attention as tattn
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.scripts import attn_variants as tav

TINY_F32 = 2.0 ** -126     # the smallest normal float32
SCALE8, SCALE64 = 8 ** -0.5, 64 ** -0.5


@pytest.fixture
def flushed_exp(monkeypatch):
    """torch.exp with results below 2^-126 set to zero, for the duration of
    a test; ``flushed_exp.count`` counts the values it flushed."""
    exp = torch.exp

    def flushed(x, *a, **kw):
        e = exp(x, *a, **kw)
        tiny = (e > 0) & (e < TINY_F32)
        flushed.count += int(tiny.sum())
        return torch.where(tiny, torch.zeros_like(e), e)
    flushed.count = 0
    monkeypatch.setattr(torch, "exp", flushed)
    return flushed


def _inputs(b, n, c, seed, bg_kind):
    """qkv [B, N, 3C] float32 with hot query rows 1-2 (logits past the clamp)
    and a background: all but the cls token, or 30 % of the tokens."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
    share = 1.1 if bg_kind == "all_but_cls" else 0.3
    bg = (rng.random((b, n)) < share).astype(np.float32)
    bg[:, 0] = 0.0
    return qkv, bg


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
@pytest.mark.parametrize("hm", [False, True], ids=["plain", "headmean"])
@pytest.mark.parametrize("sp", [1, 4])
def test_flushed_seq_ref_matches_jax_kernel(flushed_exp, sp, hm, clamp,
                                            bg_kind):
    """The flushed sequence-parallel plain version against JAX
    _masked_attention_seq_local on every rank's shard of N = 17 (padded to
    20 at four ranks), float32, H = 4, dh = 8."""
    heads, n = 4, 17
    qkv, bg = _inputs(2, n, heads * 8, 70 + sp, bg_kind)
    c, nq = heads * 8, -(-n // sp)
    pad = nq * sp - n
    qkv_p = np.pad(qkv, ((0, 0), (0, pad), (0, 0)))
    bg_p = np.pad(bg, ((0, 0), (0, pad)))
    kv = qkv_p[:, :, c:]
    kw = dict(num_heads=heads, scale=SCALE8, with_headmean=hm,
              clamp_softmax=clamp, n_real=n)
    for r in range(sp):
        q, bg_q = qkv_p[:, r * nq:(r + 1) * nq, :c], bg_p[:, r * nq:(r + 1) * nq]
        want = jattn._masked_attention_seq_local(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bg_q),
            jnp.asarray(bg_p), interpret=True,
            hm_dtype=jnp.float32 if hm else None, **kw)
        got = tattn.masked_attention_seq_local_ref(
            torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(bg_q),
            torch.from_numpy(bg_p), hm_dtype=torch.float32 if hm else None,
            **kw)
        for g, w, tol in zip(got, want, (1e-5, 1e-6, 1e-6)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    assert flushed_exp.count > 0    # the flush did bite


def _fused_inputs(option, clamp, bg_kind):
    """Kernel 1's inputs at B=2, N=37, four heads of 16: the float test's
    background-heavy, hot-row qkv (``float``, and ``int8_out`` with the
    output scale 1/s_out = 20), or int8 qkv with per-head scales whose head
    0 q scale passes the clamp (``int8_io``); a row-stochastic joint."""
    heads, n = 4, 37
    qkv, bg = _inputs(2, n, heads * 16, 60 + clamp, bg_kind)
    rng = np.random.default_rng(61 + clamp)
    j = rng.standard_normal((2, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    scales = None
    if option == "int8_out":
        scales = np.array([20.0], np.float32)
    elif option == "int8_io":
        qkv = rng.integers(-127, 128, qkv.shape).astype(np.int8)
        sc = rng.uniform(0.01, 0.03, 3 * heads).astype(np.float32)
        sc[0] = 0.5
        scales = np.concatenate([sc, [20.0]]).astype(np.float32)
    return qkv, bg, joint, scales


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("option", ["float", "int8_io", "int8_out"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
def test_flushed_fused_ref_matches_jax_kernel(flushed_exp, variant, clamp,
                                              option, bg_kind):
    """The flushed plain version of kernel 1 (masked_attention_fused_ref)
    against JAX masked_attention_fused in interpret mode, float32
    (float_dtype float32 under int8_io), B=2, N=37, H=4, dh=16: plain, head
    mean and rollout, clamp and row max, float qkv, int8_io and int8_out.
    Float outputs at tests/test_torch_attention.py's tolerances, an int8
    output within one step on at most 1 % of its elements."""
    qkv, bg, joint, scales = _fused_inputs(option, clamp, bg_kind)
    kw = dict(num_heads=4, scale=0.25, clamp_softmax=clamp,
              with_headmean=variant == "headmean")
    j = joint if variant == "rollout" else None
    jkw = dict(kw, float_dtype=jnp.float32) if option == "int8_io" else kw
    want = jattn.masked_attention_fused(
        jnp.asarray(qkv), jnp.asarray(bg), None if j is None else
        jnp.asarray(j), None if scales is None else jnp.asarray(scales),
        interpret=True, **jkw)
    got = tattn.masked_attention_fused_ref(
        torch.from_numpy(qkv), torch.from_numpy(bg),
        None if j is None else torch.from_numpy(j),
        None if scales is None else torch.from_numpy(scales),
        float_dtype=torch.float32, **kw)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    for name, g, w in zip(("out", "cls", "third"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-2, name
            assert np.abs(g).max() > 30, name     # not all rounded to 0
            continue
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 if name == "out" else 1e-6,
                                   err_msg=name)
    assert flushed_exp.count > 0    # the flush did bite


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
def test_flushed_bwd_ref_matches_jax_kernel(flushed_exp, clamp, bg_kind):
    """The flushed backward plain version against JAX masked_attention_bwd
    in interpret mode, float32, B=2, N=37, two heads of width 64 (the
    tensor-core kernel's width)."""
    heads, n, c = 2, 37, 128
    qkv, bg = _inputs(2, n, c, 90, bg_kind)
    d_out = np.random.default_rng(91).standard_normal((2, n, c)) \
        .astype(np.float32)
    want = jattn.masked_attention_bwd(
        jnp.asarray(qkv), jnp.asarray(bg), jnp.asarray(d_out),
        num_heads=heads, scale=SCALE64, clamp_softmax=clamp, interpret=True)
    got = tattn.masked_attention_bwd_ref(
        torch.from_numpy(qkv), torch.from_numpy(bg), torch.from_numpy(d_out),
        num_heads=heads, scale=SCALE64, clamp_softmax=clamp)
    assert got.shape == qkv.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    assert flushed_exp.count > 0


def _block_inputs(seed, bg_kind):
    """The block kernel's operands at tests/test_torch_fusions.py's shape
    (B=3, N=37, C=64, four heads of 16): xn and tokens ~ N(0, 1) with hot
    rows 1-2 of xn (x2), weights in the JAX layout [in, out] ~ N(0, 1/64)
    with the q and k columns x6 (logits pass the clamp at 80), biases ~ 0.1
    N(0, 1), a background (all but the cls token, or 30 %) and a
    row-stochastic joint."""
    rng = np.random.default_rng(seed)
    c = 64
    xn = rng.standard_normal((3, 37, c)).astype(np.float32)
    xn[:, 1:3] *= 2.0
    tok = rng.standard_normal((3, 37, c)).astype(np.float32)
    wqkv = (rng.standard_normal((c, 3 * c)) / 8.0).astype(np.float32)
    wqkv[:, :2 * c] *= 6.0
    bqkv = (0.1 * rng.standard_normal(3 * c)).astype(np.float32)
    wproj = (rng.standard_normal((c, c)) / 8.0).astype(np.float32)
    bproj = (0.1 * rng.standard_normal(c)).astype(np.float32)
    share = 1.1 if bg_kind == "all_but_cls" else 0.3
    bg = (rng.random((3, 37)) < share).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((3, 37, 37))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return (xn, tok, wqkv, bqkv, wproj, bproj), bg, joint


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
@pytest.mark.parametrize("with_joint", [False, True],
                         ids=["no_joint", "joint"])
def test_flushed_block_plain_matches_jax_kernel(flushed_exp, with_joint,
                                                clamp, bg_kind):
    """The flushed plain version of the block kernel
    (attention_block_fused_plain) against JAX attention_block_fused in
    interpret mode, float32, B=3, N=37, four heads of 16, at
    tests/test_torch_fusions.py's tolerances: tokens 2e-4, cls row and the
    rollout update 1e-5."""
    ops, bg, joint = _block_inputs(80 + 2 * with_joint + clamp, bg_kind)
    kw = dict(num_heads=4, scale=0.25, clamp_softmax=clamp)
    want = jattn.attention_block_fused(
        *(jnp.asarray(a) for a in ops), jnp.asarray(bg),
        jnp.asarray(joint) if with_joint else None, interpret=True, **kw)
    xn, tok, wqkv, bqkv, wproj, bproj = (torch.from_numpy(a) for a in ops)
    got = tattn.attention_block_fused_plain(
        xn, tok, wqkv.t().contiguous(), bqkv, wproj.t().contiguous(), bproj,
        torch.from_numpy(bg), torch.from_numpy(joint) if with_joint else None,
        **kw)
    assert len(got) == len(want) == 2 + with_joint
    for name, g, w, tol in zip(("tokens", "cls", "joint"), got, want,
                               (2e-4, 1e-5, 1e-5)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
    assert flushed_exp.count > 0    # the flush did bite


@pytest.mark.parametrize("dtype,design", [
    (torch.bfloat16, "tensor-core"),
    (torch.float32, "fma"),
])
def test_block_design_rule(dtype, design):
    """At the cluster design's shapes (ViT-B/16's) bf16 takes the block
    kernel's tensor-core core (the bf16 fused serving path's), float32 its
    FMA core; past them both take the streamed design; nothing else has a
    CUDA design."""
    assert tattn.block_design(dtype, 197, 768) == design
    assert tattn.block_design(dtype, 1025, 1024) == "streamed"
    assert set(tattn.BLOCK_DESIGNS) == {"tensor-core", "fma", "streamed"}
    assert tattn._block_bf16_design == "tensor-core"
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tattn.block_design(torch.float16, 197, 768)


@pytest.mark.parametrize("dtype,n,dh,design", [
    (torch.bfloat16, 37, 64, "tensor-core"),
    (torch.bfloat16, 197, 64, "tensor-core"),
    (torch.bfloat16, 577, 64, "tensor-core"),
    (torch.bfloat16, 760, 64, "tensor-core"),
    (torch.bfloat16, 1025, 64, "tensor-core"),
    (torch.float32, 37, 64, "one-block"),
    (torch.float32, 256, 64, "one-block"),
    (torch.float32, 257, 64, "two-kernel"),
    (torch.float32, 760, 64, "two-kernel"),
    (torch.float32, 1025, 64, "two-kernel"),
    (torch.bfloat16, 257, 80, "tensor-core"),
    (torch.bfloat16, 1025, 80, "tensor-core"),
    (torch.float32, 208, 80, "one-block"),
    (torch.float32, 209, 80, "two-kernel"),
    (torch.float32, 257, 80, "two-kernel"),
    (torch.float32, 1025, 80, "two-kernel"),
    (torch.bfloat16, 65, 16, "tensor-core"),
    (torch.bfloat16, 1704, 16, "tensor-core"),
    (torch.float32, 572, 16, "one-block"),
    (torch.float32, 573, 16, "two-kernel"),
    (torch.float32, 416, 32, "one-block"),
    (torch.float32, 417, 32, "two-kernel"),
    (torch.float32, 360, 40, "one-block"),
    (torch.float32, 361, 40, "two-kernel"),
])
def test_bwd_design_rule(dtype, n, dh, design):
    """bf16 takes the tensor-core design at every N <= BWD_MAX_N (1564 at
    head width 64, 1520 at 80, 1636 to 1704 at 40 to 16); float32 keeps the
    one-block design up to 256 (208 at 80, 360 to 572 at 40 to 16) and the
    two-kernel design past it.  Every design but the
    one-block one passes a [B, H, N, 3] float32 scratch of row statistics
    from its first kernel to its second.  Other widths raise."""
    assert tattn.BWD_ONE_BLOCK_MAX_N == {16: 572, 32: 416, 40: 360,
                                         64: 256, 80: 208}
    assert tattn.BWD_MAX_N == {16: 1704, 32: 1656, 40: 1636, 64: 1564,
                               80: 1520}
    assert tattn.bwd_design(dtype, n, dh) == design
    shape = tattn.bwd_scratch_shape(design, 4, 12, n)
    assert shape == (None if design == "one-block" else (4, 12, n, 3))
    with pytest.raises(ValueError, match="N <="):
        tattn.bwd_design(dtype, tattn.BWD_MAX_N[dh] + 1, dh)
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, got 48"):
        tattn.bwd_design(dtype, n, 48)


def test_seq_design_rule():
    """bf16 takes the sequence-parallel kernel's tensor-core design, float32
    its FMA design; both take Np <= SEQ_MAX_NP[dh] (N = 1025 over 8 ranks)
    at every head width."""
    assert tattn.seq_design(torch.bfloat16) == "tensor-core"
    assert tattn.seq_design(torch.float32) == "fma"
    assert set(tattn.SEQ_DESIGNS) == {"tensor-core", "fma"}
    assert min(tattn.SEQ_MAX_NP.values()) >= -(-1025 // 8) * 8


@pytest.mark.parametrize("dtype,design", [
    (torch.bfloat16, "tensor-core"),
    (torch.int8, "tensor-core"),
    (torch.float32, "fma"),
])
def test_fwd_design_rule(dtype, design):
    """bf16 and int8 qkv take the fused forward's tensor-core design (the
    serving and training paths'), float32 its FMA design; nothing else has
    a CUDA design."""
    assert tattn.fwd_design(dtype) == design
    assert set(tattn.FWD_DESIGNS) == {"tensor-core", "fma"}
    assert tattn._fwd_bf16_design == "tensor-core"
    with pytest.raises(TypeError, match="bfloat16, float32 or int8"):
        tattn.fwd_design(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_int8_gemm_design_rule(dtype):
    """Every x dtype of linear_int8 (the float routes quantize in the
    kernel, int8 x streams in) takes the tensor-core design."""
    assert tgemm.int8_gemm_design(dtype) == "tensor-core"
    assert set(tgemm.INT8_GEMM_DESIGNS) == {"tensor-core", "dp4a"}
    with pytest.raises(TypeError, match="float32, bfloat16 or int8"):
        tgemm.int8_gemm_design(torch.float16)


def test_no_config_field_reaches_the_design_switches():
    """The private design switches of the kernels are set nowhere in the
    port but where they are defined, and no config field names a design:
    the earlier designs are reachable only by setting the switches by
    hand, as chip_smoke.py does to time them side by side."""
    fields = {f.name for f in dataclasses.fields(configs.ViTCAMConfig)}
    assert not any("design" in f for f in fields), fields
    pkg = pathlib.Path(tattn.__file__).resolve().parents[1]
    switch = re.compile(r"_(fwd|seq|bwd|block|v1|variants)_bf16_design\s*=|"
                        r"_int8_gemm_design\s*=|"
                        r"_mlp_(bf16|int8)_design\s*=")
    setters = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                     if switch.search(p.read_text()))
    assert setters == ["kernels/attention.py", "kernels/gemm.py",
                       "scripts/attn_variants.py"], setters


@pytest.mark.parametrize("dtype,n,design", [
    (torch.bfloat16, 17, "tensor-core"),
    (torch.bfloat16, 197, "tensor-core"),
    (torch.bfloat16, 781, "tensor-core"),
    (torch.bfloat16, 1536, "tensor-core"),
    (torch.float32, 197, "fma"),
    (torch.float32, 1536, "fma"),
])
def test_v1_design_rule(dtype, n, design):
    """The split-tensor kernel: bf16 takes its tensor-core design at every
    N <= V1_MAX_N[64] (the FMA design's range, head mean or not), float32
    its FMA design; past V1_MAX_N and for other dtypes the rule raises."""
    assert tattn.V1_MAX_N[64] == 1536
    assert tattn.v1_design(dtype, n) == design
    assert set(tattn.V1_DESIGNS) == {"tensor-core", "fma"}
    assert tattn._v1_bf16_design == "tensor-core"
    with pytest.raises(ValueError, match="N <= 1536"):
        tattn.v1_design(dtype, tattn.V1_MAX_N[64] + 1)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        tattn.v1_design(torch.float16, n)


@pytest.mark.parametrize("variant", list(tav._VARIANTS))
@pytest.mark.parametrize("dtype,n", [
    (torch.bfloat16, 37), (torch.bfloat16, 197), (torch.bfloat16, 736),
    (torch.bfloat16, 780), (torch.float32, 197), (torch.float32, 900),
])
def test_variants_design_rule(dtype, n, variant):
    """The ablation kernels: bf16 takes the tensor-core design up to
    VARIANTS_TC_MAX_N (headbatch HEADBATCH_TC_MAX_N) and raises past it, no
    design taken in its place; float32 always takes the FMA design, whose
    launch checks its own shared memory."""
    assert (tav.VARIANTS_TC_MAX_N, tav.HEADBATCH_TC_MAX_N) == (780, 736)
    assert set(tav.VARIANT_DESIGNS) == {"tensor-core", "fma"}
    assert tav._variants_bf16_design == "tensor-core"
    limit = tav.HEADBATCH_TC_MAX_N if variant == "headbatch" \
        else tav.VARIANTS_TC_MAX_N
    if dtype == torch.float32:
        assert tav.variants_design(dtype, variant, n) == "fma"
    elif n <= limit:
        assert tav.variants_design(dtype, variant, n) == "tensor-core"
    else:
        with pytest.raises(ValueError, match=f"N <= {limit}"):
            tav.variants_design(dtype, variant, n)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match=f"N <= {limit}"):
            tav.variants_design(dtype, variant, limit + 1)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tav.variants_design(torch.float16, variant, n)
    with pytest.raises(SystemExit, match="unknown variant"):
        tav.variants_design(dtype, "ful", n)


@pytest.mark.parametrize("fuse_rollout", [False, True])
def test_kernel_path_flushes_the_cls_rows(fuse_rollout):
    """The forward flushes the cls rows the kernel path returns, as the eager
    path and JAX do: the float32 plain version (and the float32 FMA design
    on the card) keeps the denormal weights of masked keys, which ranked the
    masked patches in the top-16 on trained weights where the eager path
    ties them at 0 (the float32 predict gate of chip_smoke.user_path)."""
    from vision_transformer_cam_tpu_torch.models.vit import ViTCAM
    cfg = configs.ViTCAMConfig(img_size=32, patch_size=8, embed_dim=64,
                               depth=4, num_heads=4, mask_from=1,
                               top_k_patches=8, per_sample_mask_norm=True)
    model = ViTCAM(cfg, device="cpu")
    with torch.no_grad():
        for blk in model.blocks:
            blk.attn.qkv.weight.mul_(20.0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    outs = {}
    for impl in ("eager", "kernel"):
        model.cfg = cfg.replace(attn_impl=impl)
        outs[impl] = model(x, need_rollout=fuse_rollout)
    rows = outs["kernel"].attn_cls_rows
    assert (rows == 0).any()                   # the mask engaged
    assert not ((rows > 0) & (rows < TINY_F32)).any()
    np.testing.assert_allclose(rows.numpy(),
                               outs["eager"].attn_cls_rows.numpy(),
                               rtol=0, atol=1e-6)
    assert torch.equal(outs["kernel"].top_patch_idx,
                       outs["eager"].top_patch_idx)
