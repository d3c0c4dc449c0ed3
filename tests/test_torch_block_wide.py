"""The attention block kernel at the zoo's wide and long shapes: N past 256
and past the JAX kernel's 512-row query tile, C = 1024, head width 80.

The port's ``attention_block_fused`` (its plain version on CPU tensors) is
held against the JAX TPU kernel run in Pallas interpret mode on the same
seeded numpy inputs; a depth-2 model at head width 80 and N = 257 with
``attn_block_fusion`` against JAX ``vit.forward`` on its Pallas path; the
routing between the kernel's two CUDA designs and its shared-memory formula
(no CUDA needed); and both block ops under ``torch.library.opcheck``.  The
CUDA kernels themselves are held against their plain versions on the card by
``tests/test_torch_block_wide_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.kernels import ops as kops
from vision_transformer_cam_tpu_torch.models import vit as tvit

try:  # the GPU machine has no jax
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu import configs as jcfgs
    from vision_transformer_cam_tpu.io.weights import pytree_from_state_dict
    from vision_transformer_cam_tpu.kernels import attention as jka
    from vision_transformer_cam_tpu.models import vit as jvit
    JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
except ImportError:
    jax = None

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")


def _case(b, n, heads, dh, seed, hot):
    """xn, tokens, the weights in the JAX layout [in, out] (~ N(0, 1 / C);
    with ``hot`` the q and k columns scaled by 5, so that logits reach the
    serving clamp at 80), biases, a bg with the cls column 0 and a
    row-stochastic joint."""
    c = heads * dh
    rng = np.random.default_rng(seed)
    xn = rng.standard_normal((b, n, c)).astype(np.float32)
    tok = rng.standard_normal((b, n, c)).astype(np.float32)
    wqkv = (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    if hot:
        wqkv[:, :2 * c] *= 5.0
    bqkv = (0.1 * rng.standard_normal(3 * c)).astype(np.float32)
    wproj = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    bproj = (0.1 * rng.standard_normal(c)).astype(np.float32)
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return (xn, tok, wqkv, bqkv, wproj, bproj), bg, joint


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


# tests/test_torch_fusions.py's BLOCK_TOL: float32 tokens 2e-4, cls row and
# joint 1e-5 (the JAX package's kernel-vs-XLA tolerances); bf16 5e-2, 1e-2,
# 1e-3 (both round qkv, P, the attention output and the result to bf16, at
# other places in XLA's dots)
BLOCK_TOL = {"float32": (2e-4, 1e-5, 1e-5), "bfloat16": (5e-2, 1e-2, 1e-3)}
# (B, N, heads, head width): past the cluster design's 256 rows, past the
# JAX kernel's 512-row query tile, ViT-H/14's head width at its N, and
# ViT-L's C = 1024 in 16 heads
WIDE = [(1, 300, 2, 64), (1, 520, 2, 64), (1, 257, 2, 80), (1, 37, 16, 64)]


@pytest.mark.parametrize("with_joint", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE, ids=lambda s: "N%d_%dx%d" % s[1:])
def test_block_matches_jax_interpret(needs_jax, shape, dtype, with_joint):
    """float32 with hot q and k (logits past the clamp), bf16 with logits of
    order 1 (a hot head would magnify an ulp of bf16 qkv that the two sum
    into other sides of a rounding boundary, as chip_smoke.py's block cases
    note); the clamp on in every other case."""
    b, n, heads, dh = shape
    clamp = (WIDE.index(shape) + with_joint) % 2 == 1
    ops, bg, joint = _case(b, n, heads, dh, seed=n + heads,
                           hot=dtype == "float32")
    kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=clamp)
    want = jka.attention_block_fused(
        *(jnp.asarray(a, JDT[dtype]) for a in ops), jnp.asarray(bg),
        jnp.asarray(joint) if with_joint else None, interpret=True, **kw)
    xn, tok, wqkv, bqkv, wproj, bproj = ops
    before = tka.block_launches
    got = tka.attention_block_fused(
        _t(xn, dtype), _t(tok, dtype), _t(wqkv.T, dtype), _t(bqkv, dtype),
        _t(wproj.T, dtype), _t(bproj, dtype), _t(bg),
        _t(joint) if with_joint else None, **kw)
    assert tka.block_launches == before             # CPU: the plain version
    assert len(got) == len(want) == 2 + with_joint
    for g, w, tol in zip(got, want, BLOCK_TOL[dtype]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=tol)


def _zoo_shapes():
    for name, factory in sorted(tcfgs.MODEL_ZOO.items()):
        cfg = factory(num_classes=20)
        yield name, cfg.seq_len, cfg.embed_dim, cfg.head_dim


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_routing_takes_the_zoo(dtype):
    """Every zoo model routes to a design at its (N, C, head width), with the
    rollout and without; the shapes the cluster design took before (ViT-B:
    C = 768, N <= 256, width 64) keep it, bf16 ViT-L/16 and ViT-L/32 join
    it, and the rest run the streamed design at the row tile its layout
    allows."""
    cluster = "fma" if dtype == torch.float32 else "tensor-core"
    routes = {}
    for name, n, c, dh in _zoo_shapes():
        for rollout in (True, False):
            design = tka.block_design(dtype, n, c, dh, rollout)
            need = tka.block_smem_bytes(
                design, dtype, n, c, dh, rollout,
                tka.block_rows(dtype, n, c, dh, rollout))
            assert need <= tka.BLOCK_SMEM_LIMIT, (name, rollout)
            routes[(name, rollout)] = design
            if c == 768:
                assert design == cluster, name
    for rollout in (True, False):
        assert routes[("vit_huge_patch14_224_in21k", rollout)] == "streamed"
        assert routes[("vit_large_patch16_384", rollout)] == "streamed"
        assert routes[("vit_large_patch16_512", rollout)] == "streamed"
        assert routes[("vit_large_patch32_224_in21k", rollout)] == cluster
    if dtype == torch.bfloat16:
        assert routes[("vit_large_patch16_224", True)] == "tensor-core"
    else:   # its FMA layout at C = 1024 does not fit with the head mean
        assert routes[("vit_large_patch16_224", True)] == "streamed"
    # the row tile: 32 where it fits, 16 at ViT-L/16@512 with the rollout
    assert tka.block_rows(dtype, 1025, 1024, 64, True) == 16
    assert tka.block_rows(torch.bfloat16, 257, 1280, 80, True) == 32
    # the present shapes: the cluster design, as before
    for n in (17, 37, 197, 256):
        assert tka.block_design(dtype, n, 768) == cluster
    assert tka.BLOCK_DESIGNS == {"fma": 0, "tensor-core": 1, "streamed": 2}


def test_block_smem_formula():
    """The Python mirror of the CUDA layouts at the shapes PERF.md cites
    (the cluster design's tensor-core layout at ViT-B/16 is 210,304 bytes,
    as the kernel's header says; ViT-L/16's 226,688 still fits) and the
    limits derived from it."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tka.block_smem_bytes("tensor-core", bf, 197, 768) == 210304
    assert tka.block_smem_bytes("tensor-core", bf, 197, 1024) == 226688
    assert tka.block_smem_bytes("tensor-core", bf, 50, 1024) == 164096
    assert tka.block_smem_bytes("fma", f32, 197, 1024) == 238912
    assert tka.block_smem_bytes("streamed", bf, 1025, 1024, 64, True,
                                16) == 177152
    assert tka.block_smem_bytes("streamed", bf, 257, 1280, 80, True,
                                32) == 214912
    assert tka.block_smem_bytes("streamed", f32, 1025, 1024, 64, True,
                                16) == 223136
    # rollout only adds the head mean; 32 rows never take less than 16
    for dtype in (bf, f32):
        for n, c, dh in ((257, 1280, 80), (577, 1024, 64), (1025, 1024, 64)):
            a, b = (tka.block_smem_bytes("streamed", dtype, n, c, dh, r, 16)
                    for r in (False, True))
            assert a < b
            assert tka.block_smem_bytes("streamed", dtype, n, c, dh, True,
                                        32) > b
    assert tka.BLOCK_MAX_N == {bf: 1376, f32: 944}
    assert tka.BLOCK_MAX_C == {bf: 2752, f32: 1152}
    assert tka.BLOCK_MAX_N[f32] >= 257 and tka.BLOCK_MAX_C[f32] >= 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_refuses_past_its_limits(dtype):
    """Past the limits the rule raises and names the bytes; it never
    reroutes.  Other head widths raise naming the compiled ones."""
    n = tka.BLOCK_MAX_N[dtype] + 1
    need = tka.block_smem_bytes("streamed", dtype, n, 1280, 80, True, 16)
    assert need > tka.BLOCK_SMEM_LIMIT
    with pytest.raises(ValueError, match=f"needs {need} bytes"):
        tka.block_design(dtype, n, 1280, 80)
    c = tka.BLOCK_MAX_C[dtype] + 64
    with pytest.raises(ValueError, match="attn_block_fusion"):
        tka.block_design(dtype, 1025, c, 64)
    assert tka.block_design(dtype, n, 1280, 80, rollout=False) == "streamed"
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, "
                                         "got 48"):
        tka.block_design(dtype, 197, 480, 48)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tka.block_design(torch.float16, 197, 768)


_W80 = dict(img_size=256, patch_size=16, embed_dim=160, depth=2, num_heads=2,
            num_classes=20, mask_from=1, top_k_patches=4,
            per_sample_mask_norm=True, attn_block_fusion=True)


@pytest.mark.parametrize("need_rollout", [True, False])
def test_width80_model_matches_jax_pallas(needs_jax, monkeypatch,
                                          need_rollout):
    """A depth-2 model at head width 80 and N = 257 with attn_block_fusion
    (the block wrapper on every layer) against JAX vit.forward on its
    Pallas path with the same float32 weights, at the fused-forward
    tolerances of tests/test_torch_fusions.py: logits and tokens 2e-4, cls
    rows and rollout row 1e-5."""
    jcfg = jcfgs.ViTCAMConfig(**_W80, attn_impl="pallas")
    tcfg = tcfgs.ViTCAMConfig(**_W80, attn_impl="kernel")
    assert (tcfg.seq_len, tcfg.head_dim) == (257, 80)
    # the port's seeded init, the qkv weights scaled so that the mask
    # switches tokens off, handed to JAX in its layout
    model = tvit.ViTCAM(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for blk in model.blocks:
            blk.attn.qkv.weight.mul_(20.0)
    params = pytree_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    x = np.random.default_rng(14).standard_normal((1, 256, 256, 3)).astype(
        np.float32)
    want = jvit.forward(params, jnp.asarray(x), jcfg,
                        need_rollout=need_rollout)
    calls = []
    real = tvit.attention_block_fused
    monkeypatch.setattr(tvit, "attention_block_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = model(torch.from_numpy(x), need_rollout=need_rollout)
    assert len(calls) == _W80["depth"]
    _, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel()          # the mask engaged
    for name, tol in (("logits", 2e-4), ("attn_cls_rows", 1e-5),
                      ("tokens_prenorm", 2e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=tol, err_msg=name)
    if need_rollout:
        np.testing.assert_allclose(got.rollout_row.numpy(),
                                   np.asarray(want.rollout_row), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("rollout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_block_width80(dtype, rollout):
    """Both block ops at N = 257 and head width 80 (ViT-H/14's), as
    tests/test_torch_export.py checks them at a tiny width."""
    rng = np.random.default_rng(6)
    b, n, heads, dh = 1, 257, 2, 80
    c = heads * dh

    def t(*shape):
        return torch.from_numpy(0.3 * rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    args = (t(b, n, c), t(b, n, c), t(3 * c, c), t(3 * c), t(c, c), t(c),
            torch.zeros((b, n)))
    if rollout:
        joint = torch.eye(n).expand(b, n, n).contiguous()
        torch.library.opcheck(kops._block_rollout,
                              (*args, joint, heads, dh ** -0.5, -100.0, True))
    else:
        torch.library.opcheck(kops._block, (*args, heads, dh ** -0.5, -100.0,
                                            True))
