"""The port's fused serving paths (``mlp_fusion``, ``attn_block_fusion``)
against the JAX package's.

Each kernel's plain PyTorch version (what its wrapper runs on CPU tensors) is
held against the JAX TPU kernel of the same name run in Pallas interpret mode,
on the same seeded numpy inputs; then the whole forward at a tiny config with
the fusions on, against JAX ``vit.forward`` with ``attn_impl="pallas"``; then
the routing rules.  The CUDA kernels themselves are held against their plain
versions on the card (the tests marked ``cuda``), which run on a GPU machine
without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_fusions.py
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.ops import quant as tquant

try:  # the GPU machine has no jax: there only the cuda-marked tests run
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu import configs as jcfgs
    from vision_transformer_cam_tpu import serving as jserving
    from vision_transformer_cam_tpu.kernels import attention as jka
    from vision_transformer_cam_tpu.kernels import gemm as jgemm
    from vision_transformer_cam_tpu.models import vit as jvit
    from vision_transformer_cam_tpu.ops import quant as jquant
    from vision_transformer_cam_tpu.ops import rollout as jroll
    from vision_transformer_cam_tpu_torch.io.weights import (
        load_state_dict, state_dict_from_jax_params)
    from vision_transformer_cam_tpu_torch.ops import rollout as troll
    JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
except ImportError:
    jax = None

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
C, HID = 64, 128
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])


def _f32(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# 1. mlp_fused
# ---------------------------------------------------------------------------

def _mlp_case(seed, lead=(3, 37)):
    """x and the weights in the JAX layout [in, out]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (C,)).astype(np.float32)
    w1 = (0.1 * rng.standard_normal((C, HID))).astype(np.float32)
    b1 = (0.01 * rng.standard_normal(HID)).astype(np.float32)
    w2 = (0.1 * rng.standard_normal((HID, C))).astype(np.float32)
    b2 = (0.01 * rng.standard_normal(C)).astype(np.float32)
    return x, w1, b1, w2, b2


# float32: the two sum in another order; the tolerance of the JAX kernel's
# own test (tests/test_gemm_kernels.py).  bf16: both round the hidden tensor
# and the output to bf16, XLA's bf16 dot and torch's float32 one at other
# places: 1e-2 on outputs of magnitude ~1.
MLP_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu_approx", [False, True])
def test_mlp_fused_matches_jax_interpret(needs_jax, gelu_approx, dtype):
    x, w1, b1, w2, b2 = _mlp_case(9)
    want = jgemm.mlp_fused(*(jnp.asarray(a, JDT[dtype])
                             for a in (x, w1, b1, w2, b2)),
                           gelu_approx=gelu_approx, block_m=32,
                           interpret=True)
    before = tgemm.mlp_fused_launches
    got = tgemm.mlp_fused(_t(x, dtype), _t(w1.T, dtype), _t(b1, dtype),
                          _t(w2.T, dtype), _t(b2, dtype),
                          gelu_approx=gelu_approx)
    assert tgemm.mlp_fused_launches == before      # CPU: the plain version
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=MLP_TOL[dtype])


def test_mlp_fused_checks():
    x, w1, b1, w2, b2 = (_t(a) for a in _mlp_case(1))
    with pytest.raises(ValueError, match="do not chain"):
        tgemm.mlp_fused(x, w1, b1, w2, b2)          # JAX layout, not torch's
    with pytest.raises(ValueError, match="b1 must be"):
        tgemm.mlp_fused(x, w1.t(), b2, w2.t(), b2)
    with pytest.raises(ValueError, match="both biases"):
        tgemm.mlp_fused(x, w1.t(), None, w2.t(), b2)
    with pytest.raises(ValueError, match="no kernel for device"):
        tgemm.mlp_fused(*(a.to("meta") for a in (x, w1.t(), b1, w2.t(), b2)))


# ---------------------------------------------------------------------------
# 2. mlp_fused_int8
# ---------------------------------------------------------------------------

def _mlp_int8_case(seed, lead=(2, 50)):
    """x, the JAX quantized layers and the port's ``QLinear`` twins with
    static act scales 0.05 and 0.03 (as the JAX kernel's own test)."""
    x, w1, b1, w2, b2 = _mlp_case(seed, lead)
    layers = []
    for w, b, a in ((w1, b1, 0.05), (w2, b2, 0.03)):
        jq = dict(jquant.quantize_weight(jnp.asarray(w)),
                  bias=jnp.asarray(b), act_scale=jnp.float32(a))
        tq = tquant.QLinear.from_float(_t(w.T), _t(b), torch.tensor(a))
        layers.append((jq, tq))
    return x, layers


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu_approx", [False, True])
def test_mlp_fused_int8_matches_jax_interpret(needs_jax, gelu_approx,
                                              x_dtype):
    """float32 output within 1e-5: both sides run the same rounded float32
    operations on exact integer sums (XLA may contract acc * cs + b into one
    FMA)."""
    x, ((j1, t1), (j2, t2)) = _mlp_int8_case(3)
    want = jgemm.mlp_fused_int8(
        jnp.asarray(x, JDT[x_dtype]), j1["kernel_q"],
        jquant.combined_scale(j1), j1["bias"], j2["kernel_q"],
        jquant.combined_scale(j2), j2["bias"], 1.0 / j1["act_scale"],
        1.0 / j2["act_scale"], gelu_approx=gelu_approx, block_m=32,
        out_dtype=jnp.float32, interpret=True)
    before = tgemm.mlp_fused_int8_launches
    got = tquant.mlp_fused_int8(_t(x, x_dtype), t1, t2,
                                gelu_approx=gelu_approx,
                                out_dtype=torch.float32)
    assert tgemm.mlp_fused_int8_launches == before
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_mlp_fused_int8_equals_unfused_chain(out_dtype):
    """The plain version equals, bit for bit, the port's chain of two int8
    GEMM launches on the fused route (fc1 with the GELU-requant epilogue,
    then fc2 on the int8 hidden tensor), whatever the bias."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((5, 21, C)).astype(np.float32))
    lay = []
    for (n, k), a in (((HID, C), 0.05), ((C, HID), 0.03)):
        lay.append(tquant.QLinear.from_float(
            _t(0.1 * rng.standard_normal((n, k)).astype(np.float32)),
            _t(0.01 * rng.standard_normal(n).astype(np.float32)),
            torch.tensor(a)))
    f1, f2 = lay
    got = tquant.mlp_fused_int8(x, f1, f2, out_dtype=TDT[out_dtype])
    hq = tgemm.linear_int8(x, f1.weight_q, f1.comb_scale, f1.bias, f1.inv_act,
                           route="fused", epilogue="gelu",
                           out_scales=f2.inv_act.reshape(1))
    assert hq.dtype == torch.int8 and int(hq.abs().max()) > 20
    want = tgemm.linear_int8(hq.float(), f2.weight_q, f2.comb_scale, f2.bias,
                             torch.ones(()), route="fused",
                             out_dtype=TDT[out_dtype])
    assert torch.equal(got, want)


def test_mlp_fused_int8_close_to_qlinear_chain():
    """Against the chain the model runs with ``mlp_fusion`` off
    (``qlinear_gelu_requant`` then ``qlinear``), which divides where the
    fused route multiplies by the inverse and applies ``(acc * sx) * ws``
    where the fused route uses the combined scale.  A hidden value next to a
    .5 boundary may then quantize one step apart, which moves its output row
    by at most ``max|w2| * act_scale2``: so all but 2 % of the outputs agree
    to 1e-5 (the JAX package's tolerance for its kernel against its qlinear
    chain), and none is further off than two such steps."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 50, C)).astype(np.float32))
    w2 = 0.1 * rng.standard_normal((C, HID)).astype(np.float32)
    t1 = tquant.QLinear.from_float(
        _t(0.1 * rng.standard_normal((HID, C)).astype(np.float32)),
        _t(0.01 * rng.standard_normal(HID).astype(np.float32)),
        torch.tensor(0.05))
    t2 = tquant.QLinear.from_float(
        _t(w2), _t(0.01 * rng.standard_normal(C).astype(np.float32)),
        torch.tensor(0.03))
    got = tquant.mlp_fused_int8(x, t1, t2, out_dtype=torch.float32)
    hq = tquant.qlinear_gelu_requant(x, t1, t2.act_scale)
    want = tquant.qlinear(hq, t2, out_dtype=torch.float32)
    err = (got - want).abs()
    assert float((err > 1e-5).float().mean()) <= 0.02
    assert float(err.max()) <= 2 * float(np.abs(w2).max()) * 0.03 + 1e-5


def test_mlp_fused_int8_checks():
    rng = np.random.default_rng(5)
    f1 = tquant.QLinear.from_float(_t(rng.standard_normal((HID, C))),
                                   None, torch.tensor(0.05))
    f2 = tquant.QLinear.from_float(_t(rng.standard_normal((C, HID))),
                                   None, torch.tensor(0.03))
    x = _t(rng.standard_normal((7, C)).astype(np.float32))
    out = tquant.mlp_fused_int8(x, f1, f2)            # bias-free layers
    assert out.dtype == torch.bfloat16 and out.shape == (7, C)
    args = (f1.weight_q, f1.comb_scale, None, f2.weight_q, f2.comb_scale,
            None, f1.inv_act, f2.inv_act)
    with pytest.raises(TypeError, match="int8"):
        tgemm.mlp_fused_int8(x, f1.weight_q.float(), *args[1:])
    with pytest.raises(ValueError, match="cs1 must be"):
        tgemm.mlp_fused_int8(x, args[0], f2.comb_scale, *args[2:])
    with pytest.raises(ValueError, match="no kernel for device"):
        tgemm.mlp_fused_int8(x.to("meta"), *args)


# the design each (C, HID) takes at bf16 and int8: the wgmma design where C
# and HID are multiples of 64, the mma design elsewhere; ViT-L's and ViT-H's
# widths in two column groups; no kernel past the wgmma design's widest C
# (1280 at bf16, 2688 at int8), where float32 keeps the FMA design
MLP_ROUTES = {(768, 3072): "wgmma", (64, 256): "wgmma", (72, 200): "mma",
              (66, 150): "mma", (1024, 4096): "wgmma", (1280, 5120): "wgmma",
              (2752, 11008): None}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("shape", list(MLP_ROUTES))
def test_mlp_design_routes_by_shape(shape, dtype):
    """``mlp_design`` is the one rule the two wrappers route by: float32
    keeps the FMA design (TF32 would change the numbers), bf16 and int8 take
    the wgmma design where the TMA boxes and wgmma tiles fit, and a width
    whose block would not fit in shared memory has no kernel (it raises,
    naming the bytes).  The private switches turn "wgmma" into "mma" only."""
    c, hid = shape
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8}[dtype]
    want = MLP_ROUTES[shape]
    if want is None and dt != torch.float32:
        with pytest.raises(ValueError, match=r"needs \d+ bytes of shared"):
            tgemm.mlp_design(c, hid, dt)
        return
    if dt == torch.float32:
        want = "fma"
    assert tgemm.mlp_design(c, hid, dt) == want
    switch = "_mlp_int8_design" if dt == torch.int8 else "_mlp_bf16_design"
    assert getattr(tgemm, switch) == "wgmma"
    saved = getattr(tgemm, switch)
    setattr(tgemm, switch, "mma")
    try:
        assert tgemm.mlp_design(c, hid, dt) == ("mma" if want == "wgmma"
                                                else want)
    finally:
        setattr(tgemm, switch, saved)
    assert set(tgemm.MLP_DESIGNS) == {"wgmma", "mma", "fma"}


def test_mlp_design_limits_follow_shared_memory():
    """The widths each design takes follow from the shared memory a block
    needs (``mlp_smem_bytes``, the CUDA sources' formulas): at C = 768 the
    figures the kernels state (their occupancy reading), the wgmma ring
    shrinking to 3 / 2 stages (bf16) and 6 / 5 (int8) at C = 1024 / 1280,
    and past the widest C a raise that names the bytes."""
    sm = tgemm.mlp_smem_bytes
    assert tgemm.MLP_SMEM_LIMIT == 232448
    assert (sm(768, "wgmma", torch.bfloat16), sm(768, "wgmma", torch.int8),
            sm(768, "mma", torch.bfloat16), sm(768, "mma", torch.int8)) == \
        (214088, 205928, 189952, 197632)
    stage = 24576 + 16
    assert sm(1024, "wgmma", torch.bfloat16) == 1024 + 16 * 8192 + 16384 + 8 \
        + 3 * stage
    assert sm(1280, "wgmma", torch.bfloat16) == 1024 + 20 * 8192 + 16384 + 8 \
        + 2 * stage
    assert sm(1024, "wgmma", torch.int8) == 1024 + 8 * 8192 + 8192 + 8 \
        + 6 * stage
    assert sm(1280, "wgmma", torch.int8) == 1024 + 10 * 8192 + 8192 + 8 \
        + 5 * stage
    # the float kernels of mlp_fused.cu do not grow past one column group
    assert sm(768, "fma", torch.float32) == sm(5120, "fma", torch.float32)
    assert tgemm.MLP_MAX_C == {("wgmma", torch.bfloat16): 1280,
                               ("wgmma", torch.int8): 2688,
                               ("mma", torch.int8): 1856}
    with pytest.raises(ValueError, match="C=1344 needs 238632 bytes"):
        tgemm.mlp_design(1344, 5376, torch.bfloat16)
    assert tgemm.mlp_design(1344, 5376, torch.int8) == "wgmma"
    assert tgemm.mlp_design(1344, 5376, torch.float32) == "fma"
    saved = tgemm._mlp_int8_design
    tgemm._mlp_int8_design = "mma"
    try:
        with pytest.raises(ValueError, match="mma design at int8 takes C "
                           "<= 1856"):
            tgemm.mlp_design(1920, 7680, torch.int8)
    finally:
        tgemm._mlp_int8_design = saved


def test_mlp_design_rejects_other_types():
    with pytest.raises(TypeError, match="bfloat16, float32 or int8"):
        tgemm.mlp_design(768, 3072, torch.float16)


# ---------------------------------------------------------------------------
# 3. attention_block_fused
# ---------------------------------------------------------------------------

HEADS = 4


def _block_case(b, n, seed, gain=6.0):
    """xn, tokens, the weights in the JAX layout [in, out] (the q columns
    scaled so that logits pass the serving clamp at 80), biases, a bg with
    the cls column 0 and a row-stochastic joint."""
    rng = np.random.default_rng(seed)
    xn = rng.standard_normal((b, n, C)).astype(np.float32)
    tok = rng.standard_normal((b, n, C)).astype(np.float32)
    wqkv = (rng.standard_normal((C, 3 * C)) / 8.0).astype(np.float32)
    wqkv[:, :2 * C] *= gain
    bqkv = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    wproj = (rng.standard_normal((C, C)) / 8.0).astype(np.float32)
    bproj = (0.1 * rng.standard_normal(C)).astype(np.float32)
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return (xn, tok, wqkv, bqkv, wproj, bproj), bg, joint


# float32: the two sum the GEMMs, S, the softmax row and P.V in another order.
# cls row and joint 1e-5, tokens (sums of 64 products of magnitude ~1 behind
# logits up to the clamp) 2e-4: the JAX package's kernel-vs-XLA tolerances for
# the rollout row and the logits.  bf16: both round qkv, P, the attention
# output and the result to bf16, at other places in XLA's dots: 5e-2 on
# tokens of magnitude ~3, 1e-2 on the cls row, 1e-3 on the joint.
BLOCK_TOL = {"float32": (2e-4, 1e-5, 1e-5), "bfloat16": (5e-2, 1e-2, 1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("with_joint", [False, True])
def test_attention_block_fused_matches_jax_interpret(needs_jax, with_joint,
                                                     clamp, dtype):
    ops, bg, joint = _block_case(3, 37, seed=11)
    kw = dict(num_heads=HEADS, scale=0.25, clamp_softmax=clamp)
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
    assert got[0].dtype == got[1].dtype == TDT[dtype]
    if dtype == "float32" and clamp:
        # the clamp engaged: without it this row's logits pass 80
        q = (xn @ wqkv + bqkv)[..., :C].reshape(3, 37, HEADS, 16)
        k = (xn @ wqkv + bqkv)[..., C:2 * C].reshape(3, 37, HEADS, 16)
        assert np.einsum("bqhd,bkhd->bhqk", q, k).max() * 0.25 > 80.0
    for g, w, tol in zip(got, want, BLOCK_TOL[dtype]):
        assert g.shape == w.shape
        np.testing.assert_allclose(_f32(g), np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=tol)
    if with_joint:
        assert got[2].dtype == torch.float32


def test_attention_block_fused_checks():
    ops, bg, joint = _block_case(2, 9, seed=12)
    xn, tok, wqkv, bqkv, wproj, bproj = (_t(a) for a in ops)
    kw = dict(num_heads=HEADS, scale=0.25)
    good = (xn, tok, wqkv.t(), bqkv, wproj.t(), bproj, _t(bg))
    assert len(tka.attention_block_fused(*good, **kw)) == 2
    with pytest.raises(ValueError, match="wqkv must be"):
        tka.attention_block_fused(xn, tok, wqkv, *good[3:], **kw)
    with pytest.raises(ValueError, match="joint must be"):
        tka.attention_block_fused(*good, _t(joint)[:, :-1], **kw)
    with pytest.raises(ValueError, match="divisible"):
        tka.attention_block_fused(*good, num_heads=5, scale=0.25)
    with pytest.raises(ValueError, match="no kernel for device"):
        tka.attention_block_fused(*(a.to("meta") for a in good), **kw)
    # the cluster design's range (8 blocks of 32 rows) and the limits at the
    # zoo's extremes, past which the streamed design raises too
    assert tka.BLOCK_MAX_CLUSTER * tka.BLOCK_ROWS == 256
    assert tka.BLOCK_MAX_N == {torch.bfloat16: 1376, torch.float32: 944}


# ---------------------------------------------------------------------------
# 4. the whole forward with the fusions on
# ---------------------------------------------------------------------------

KNOBS = {"mlp_fusion": dict(mlp_fusion=True),
         "attn_block_fusion": dict(attn_block_fusion=True),
         "both": dict(mlp_fusion=True, attn_block_fusion=True)}


def _float_pair(knobs, seed=1):
    """(JAX params, JAX cfg on its Pallas path, port model on its kernel
    path) on the same float32 weights, the qkv weights scaled so that the
    mask switches tokens off."""
    kw = dict(per_sample_mask_norm=True, **knobs)
    jcfg = jcfgs.ViTCAMConfig(**TINY, attn_impl="pallas", **kw)
    tcfg = tcfgs.ViTCAMConfig(**TINY, attn_impl="kernel", **kw)
    params = jvit.init(jcfg, jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * 20.0
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model


class _Calls:
    """Counts the calls the model makes to the fused kernels' wrappers."""

    def __init__(self, monkeypatch):
        self.n = {}
        for name in ("attention_block_fused", "mlp_fused", "mlp_fused_int8",
                     "masked_attention_fused", "fused_attention_diff"):
            monkeypatch.setattr(tvit, name, self._wrap(name,
                                                       getattr(tvit, name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*a, **kw)
        return counted


@pytest.mark.parametrize("need_rollout", [True, False])
@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_fused_forward_matches_jax_pallas_f32(needs_jax, monkeypatch, knobs,
                                              need_rollout):
    """Tolerances of the kernel-path test (tests/test_torch_vit.py): logits
    2e-4, cls rows and rollout row 1e-5."""
    params, jcfg, model = _float_pair(KNOBS[knobs])
    x = np.random.default_rng(13).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = jvit.forward(params, jnp.asarray(x), jcfg,
                        need_rollout=need_rollout)
    calls = _Calls(monkeypatch)
    got = model(torch.from_numpy(x), need_rollout=need_rollout)
    d = TINY["depth"]
    block, mlp = "attn_block_fusion" in KNOBS[knobs], \
        "mlp_fusion" in KNOBS[knobs]
    assert calls.n == {k: d for k, on in (
        ("attention_block_fused", block), ("masked_attention_fused",
                                           not block), ("mlp_fused", mlp))
        if on}
    _, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel()          # the mask engaged
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.attn_cls_rows.numpy(),
                               np.asarray(want.attn_cls_rows), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.tokens_prenorm.numpy(),
                               np.asarray(want.tokens_prenorm), rtol=0,
                               atol=2e-4)
    if need_rollout:
        np.testing.assert_allclose(got.rollout_row.numpy(),
                                   np.asarray(want.rollout_row), rtol=0,
                                   atol=1e-5)
    else:
        assert got.rollout_row is None


# the int8 tolerances of tests/test_torch_serving.py: the int8 GEMMs agree bit
# for bit, LayerNorm, softmax and the float heads sum in other orders (1e-5 at
# float32 activations); bf16 rounds at other places on top (1e-2)
INT8_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_fused_forward_matches_jax(needs_jax, monkeypatch, dtype):
    """int8 serving with ``int8_fused_gemm``, ``ln_quant_fusion`` and
    ``mlp_fusion`` (and ``attn_block_fusion``, which the quantized qkv layer
    falls through on both sides) on the same int8 weights and scales."""
    knobs = dict(int8_fused_gemm=True, ln_quant_fusion=True, mlp_fusion=True,
                 attn_block_fusion=True)
    jcfg, tcfg = jcfgs.ViTCAMConfig(**TINY), tcfgs.ViTCAMConfig(**TINY)
    params = jvit.init(jcfg, jax.random.key(1))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * 10.0
    calib = np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    tc = tserving.serving_config(tcfg, "int8")
    if dtype == "bfloat16":
        jq, jc = jserving.apply_serving_mode(params, jcfg, "int8",
                                             calib_images=calib)
    else:
        jc = jserving.serving_config(jcfg, "int8").replace(
            dtype=jnp.float32, param_dtype=jnp.float32)
        jq = jquant.quantize_params(params, jquant.calibrate_act_scales(
            params, jc, jnp.asarray(calib)))
        tc = tc.replace(dtype=torch.float32, param_dtype=torch.float32)
    jc = jc.replace(attn_impl="pallas", **knobs)
    model = tvit.ViTCAM(tc.replace(**knobs), device="cpu")
    load_state_dict(model, state_dict_from_jax_params(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), jq), tc))
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    want = jvit.forward(jq, jnp.asarray(x), jc, need_rollout=True)
    calls = _Calls(monkeypatch)
    got = model(torch.from_numpy(x), need_rollout=True)
    d = TINY["depth"]
    assert calls.n == {"mlp_fused_int8": d, "masked_attention_fused": d}
    tol = INT8_TOL[dtype]
    np.testing.assert_allclose(got.logits.float().numpy(),
                               np.asarray(want.logits).astype(np.float32),
                               rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(got.rollout_row.numpy(),
                                   np.asarray(want.rollout_row), rtol=0,
                                   atol=tol)
    cam_w = np.asarray(jroll.cam_from_rollout_row(want.rollout_row, 4))
    cam_g = troll.cam_from_rollout_row(got.rollout_row, 4).numpy()
    np.testing.assert_allclose(cam_g, cam_w.astype(np.float32), rtol=0,
                               atol=tol)
    assert np.all(np.isfinite(cam_g)) and np.all(cam_g.max((1, 2)) == 1.0)


# ---------------------------------------------------------------------------
# 5. routing
# ---------------------------------------------------------------------------

FUSED = dict(mlp_fusion=True, attn_block_fusion=True)


def _model(**kw):
    cfg = tcfgs.ViTCAMConfig(**TINY, attn_impl="kernel", **kw)
    return tvit.ViTCAM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))


def _x(b=2, seed=6):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, 32, 32, 3)).astype(np.float32))


def test_fused_knobs_build_and_run():
    """Both knobs are ported: the model builds, and its fused forward equals
    the unfused one to float32 rounding."""
    x = _x()
    base = _model()(x, need_rollout=True)
    got = _model(**FUSED)(x, need_rollout=True)
    torch.testing.assert_close(got.logits, base.logits, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.rollout_row, base.rollout_row, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("rng", [None, 5])
def test_training_ignores_the_fusion_knobs(monkeypatch, rng):
    """The fused kernels have no backward: the training forward never
    reaches them, with or without dropout, and its gradients are those of
    the unfused model."""
    x = _x()
    fused, plain = _model(**FUSED), _model()
    calls = _Calls(monkeypatch)
    out = fused.forward_train(x, rng=rng)
    assert calls.n == {"fused_attention_diff": TINY["depth"]}
    want = plain.forward_train(x, rng=rng)
    torch.testing.assert_close(out.logits, want.logits, atol=0, rtol=0)
    g1 = torch.autograd.grad(out.logits.sum(), fused.blocks[0].mlp.fc1.weight)
    g2 = torch.autograd.grad(want.logits.sum(), plain.blocks[0].mlp.fc1.weight)
    torch.testing.assert_close(g1[0], g2[0], atol=0, rtol=0)


def _int8_model(**kw):
    model = _model()
    calib = np.random.default_rng(7).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    tserving.apply_serving_mode(model, "int8", calib_images=calib)
    model.cfg = model.cfg.replace(**kw)
    return model


def test_quantized_qkv_falls_through_the_block_kernel(monkeypatch):
    model = _int8_model(attn_block_fusion=True)
    want = model(_x(), need_rollout=True)
    calls = _Calls(monkeypatch)
    got = model(_x(), need_rollout=True)
    assert calls.n == {"masked_attention_fused": TINY["depth"]}
    model.cfg = model.cfg.replace(attn_block_fusion=False)
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(model(_x(), need_rollout=True).logits, want.logits)


def test_partially_quantized_mlp_takes_the_unfused_chain(monkeypatch):
    """fc2 of block 1 back to a float layer: that block's MLP runs the
    unfused chain (int8 fc1, float fc2), the others the fused int8 kernel."""
    model = _int8_model(mlp_fusion=True)
    ref = _model()
    lin = torch.nn.Linear(TINY["embed_dim"] * 4, TINY["embed_dim"])
    lin.load_state_dict(ref.blocks[1].mlp.fc2.state_dict())
    model.blocks[1].mlp.fc2 = lin.to(torch.bfloat16)
    calls = _Calls(monkeypatch)
    out = model(_x(), need_rollout=True)
    assert calls.n == {"mlp_fused_int8": TINY["depth"] - 1,
                       "masked_attention_fused": TINY["depth"]}
    assert torch.isfinite(out.logits.float()).all()
    # a layer without a static scale does not take the int8 kernel either
    model = _int8_model(mlp_fusion=True)
    model.blocks[0].mlp.fc1.act_scale = None
    calls.n.clear()
    model(_x(), need_rollout=True)
    assert calls.n["mlp_fused_int8"] == TINY["depth"] - 1


@pytest.mark.parametrize("kw, block_calls", [
    (dict(need_rollout=True), TINY["depth"]),
    (dict(), TINY["depth"]),
    (dict(need_headmean=True), 0),
    (dict(need_headmean=True, need_rollout=True), 0),
    (dict(need_perhead=True), 0),
])
def test_block_kernel_routing_by_outputs(monkeypatch, kw, block_calls):
    """The block kernel emits the rollout update, not the head-mean
    matrices: a caller that collects those leaves it."""
    model = _model(attn_block_fusion=True)
    want = _model()(_x(), **kw)
    calls = _Calls(monkeypatch)
    got = model(_x(), **kw)
    assert calls.n.get("attention_block_fused", 0) == block_calls
    torch.testing.assert_close(got.logits, want.logits, atol=1e-5, rtol=0)
    if "need_headmean" in kw:
        assert got.attn_headmean.shape == (TINY["depth"], 2, 17, 17)


def test_block_kernel_needs_the_kernel_path_and_rollout_post_leaves_it(
        monkeypatch):
    calls = _Calls(monkeypatch)
    model = _model(attn_block_fusion=True)
    model.cfg = model.cfg.replace(attn_impl="eager")
    model(_x(), need_rollout=True)
    assert "attention_block_fused" not in calls.n
    # rollout_post collects the head means for its chain after the loop
    model.cfg = model.cfg.replace(attn_impl="kernel", rollout_post=True)
    calls.n.clear()
    model(_x(), need_rollout=True)
    assert calls.n == {"masked_attention_fused": TINY["depth"]}


def test_block_kernel_without_qkv_bias():
    """A missing qkv bias goes to the kernel as zeros."""
    x = _x()
    base = _model(qkv_bias=False)(x, need_rollout=True)
    got = _model(qkv_bias=False, attn_block_fusion=True)(x, need_rollout=True)
    torch.testing.assert_close(got.logits, base.logits, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# 6. the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, gain=1.0, dtype=torch.float32):
    return (gain * torch.randn(shape, generator=g, device="cuda")).to(dtype)


@pytest.mark.cuda
def test_cuda_mlp_fused_matches_plain_version(card):
    """Tolerances as in chip_smoke.py: float32 sums in another order; bf16
    outputs within 2 bf16 ulps."""
    for dtype, (atol, rtol) in ((torch.float32, (5e-5, 1e-4)),
                                (torch.bfloat16, (1e-2, 2 ** -6))):
        for m, c, hid in ((2 * 197, 768, 3072), (111, 66, 150)):
            ops = (_rnd(card, m, c, dtype=dtype),
                   _rnd(card, hid, c, gain=c ** -0.5, dtype=dtype),
                   _rnd(card, hid, gain=0.1, dtype=dtype),
                   _rnd(card, c, hid, gain=hid ** -0.5, dtype=dtype),
                   _rnd(card, c, gain=0.1, dtype=dtype))
            for approx in (True, False):
                before = tgemm.mlp_fused_launches
                got = tgemm.mlp_fused(*ops, gelu_approx=approx)
                assert tgemm.mlp_fused_launches == before + 1
                want = tgemm.mlp_fused_plain(*ops, gelu_approx=approx)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_mlp_fused_int8_matches_plain_version(card):
    """Bit for bit at float32 output: the same rounded float32 operations
    on exact integer sums."""
    for m, c, hid in ((2 * 197, 768, 3072), (111, 66, 150)):
        x = _rnd(card, m, c, dtype=torch.bfloat16)
        lay = [tquant.QLinear.from_float(
            _rnd(card, n, k, gain=k ** -0.5), _rnd(card, n, gain=0.1),
            torch.tensor(a)) for (n, k), a in (((hid, c), 4.5 / 127),
                                               ((c, hid), 6.0 / 127))]
        for approx in (True, False):
            before = tgemm.mlp_fused_int8_launches
            got = tquant.mlp_fused_int8(x, *lay, gelu_approx=approx,
                                        out_dtype=torch.float32)
            assert tgemm.mlp_fused_int8_launches == before + 1
            want = tgemm.mlp_fused_int8_plain(
                x, lay[0].weight_q, lay[0].comb_scale, lay[0].bias,
                lay[1].weight_q, lay[1].comb_scale, lay[1].bias,
                lay[0].inv_act, lay[1].inv_act, gelu_approx=approx,
                out_dtype=torch.float32)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_attention_block_matches_plain_version(card):
    """At ViT-B widths (12 heads of 64) and a ragged N; tolerances as in
    chip_smoke.py (float32 with two hot heads; bf16 on logits of order 1)."""
    for dtype, (atol, rtol) in ((torch.float32, (5e-5, 1e-4)),
                                (torch.bfloat16, (1e-2, 2 ** -6))):
        for n in (197, 37):
            c = 768
            wqkv = _rnd(card, 3 * c, c, gain=c ** -0.5)
            if dtype == torch.float32:
                wqkv[:128] *= 40.0
            ops = [t.to(dtype) for t in (
                _rnd(card, 2, n, c), _rnd(card, 2, n, c), wqkv,
                _rnd(card, 3 * c, gain=0.1), _rnd(card, c, c, gain=c ** -0.5),
                _rnd(card, c, gain=0.1))]
            bg = (torch.rand((2, n), generator=card, device="cuda")
                  < 0.3).float()
            bg[:, 0] = 0.0
            joint = torch.softmax(_rnd(card, 2, n, n), dim=-1)
            for j in (joint, None):
                for clamp in (False, True):
                    kw = dict(num_heads=12, scale=0.125, clamp_softmax=clamp)
                    before = tka.block_launches
                    got = tka.attention_block_fused(*ops, bg, j, **kw)
                    assert tka.block_launches == before + 1
                    want = tka.attention_block_fused_plain(*ops, bg, j, **kw)
                    for a, w in zip(got, want):
                        torch.testing.assert_close(a.float(), w.float(),
                                                   atol=atol, rtol=rtol)
    with pytest.raises(ValueError, match="N <= 256"):
        tka.attention_block_fused(
            *(t[:, :1].expand(2, 257, c).contiguous() if t.dim() == 3 else t
              for t in ops), torch.zeros((2, 257), device="cuda"), **kw)
