"""The tensor-core designs of the int8 GEMM, of the fused attention forward,
of the attention block kernel's core, of the fused MLP kernels, of the
split-tensor attention kernel and of the ablation kernels, on the card.

``linear_int8`` runs mma.sync.m16n8k32 (s8) for every route; the fused
attention forward runs its tensor-core design for bf16 and int8 qkv, the
attention block kernel its tensor-core core for bf16, the fused MLP kernels
their wgmma design for bf16 and int8.  Each is held against its plain
version and against the design it replaced (the ``__dp4a`` GEMM, the FMA
attention, the FMA block core, the mma.sync MLP, the FMA split-tensor and
ablation kernels), which stay compiled behind the private switches
``kernels.gemm._int8_gemm_design``, ``kernels.attention._fwd_bf16_design``,
``_block_bf16_design``, ``_v1_bf16_design``, ``kernels.gemm._mlp_bf16_design``
/ ``_mlp_int8_design`` and ``scripts.attn_variants._variants_bf16_design``;
the ablation kernels' ``full`` is kernel 1's bf16 rollout variant bit for
bit.  The
tests need a CUDA GPU (the kernels have no CPU mode) and skip here; on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_tensor_core_cuda.py

Tolerances as in chip_smoke.py: float GEMM outputs 1e-6 relative (float32)
or one bf16 ulp, int8 outputs one step on at most 0.1 % of the elements;
attention out 1e-2 + 2^-6 relative (bf16), probabilities 1e-5 + 2^-6, the
float32 rollout update 1e-6 + 1e-4.
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm
from vision_transformer_cam_tpu_torch.scripts import attn_variants as tav

GEMM_SHAPES = {"patch": (768, 768), "qkv": (768, 2304), "proj": (768, 768),
               "fc1": (768, 3072), "fc2": (3072, 768), "ragged": (200, 72)}
TOL_OUT, TOL_PROB, TOL_JOINT = (1e-2, 2 ** -6), (1e-5, 2 ** -6), (1e-6, 1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


def _with(module, name, value, fn, *args, **kw):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn(*args, **kw)
    finally:
        setattr(module, name, saved)


def _int8_close(got, want, frac=1e-3):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= frac


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _gemm_cases(shape, n):
    """(route, x kind, epilogue, extra) for every prologue and epilogue."""
    cases = [("fused", "x", "float", {}), ("qlinear", "x", "float", {}),
             ("qlinear", "xq", "float", {}),
             ("fused", "x", "gelu", {"gelu_approx": True}),
             ("fused", "x", "requant", {"groups": 3})]
    for x_kind in ("x", "xq"):
        for groups in (3, 36):
            if n % groups == 0:
                cases.append(("qlinear", x_kind, "requant",
                              {"groups": groups}))
        for approx in (True, False):
            cases.append(("qlinear", x_kind, "gelu", {"gelu_approx": approx}))
    if shape == "ragged":
        cases += [("fused", "x32", "float", {}),
                  ("qlinear", "x32", "float", {"nobias": True})]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_cuda_int8_gemm_tensor_core_matches_plain_and_dp4a(shape):
    """Every route and epilogue at the five ViT-B GEMM shapes (M = 8 * 197)
    and a ragged one (M = 111, K = 200, N = 72): the tensor-core design
    against the plain version, and bit for bit against the dp4a design (both
    run one epilogue on the exact int32 dot)."""
    _card()
    k, n = GEMM_SHAPES[shape]
    m = 111 if shape == "ragged" else 8 * 197
    g = torch.Generator(device="cuda").manual_seed(k + n)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                       dtype=torch.int8)
    ws = 1e-3 * (1 + torch.rand((n,), generator=g, device="cuda"))
    act = x.float().abs().amax() / 127.0
    bias = torch.randn((n,), generator=g, device="cuda")
    xs = {"x": x, "x32": x.float(),
          "xq": torch.clamp(torch.round(x.float() / act), -127, 127)
          .to(torch.int8)}
    for route, x_kind, epi, extra in _gemm_cases(shape, n):
        kw = dict(route=route, epilogue=epi)
        if epi == "float":
            kw["out_dtype"] = torch.float32 if x_kind == "x32" \
                else torch.bfloat16
        elif epi == "requant":
            kw["groups"] = extra["groups"]
            kw["out_scales"] = 0.1 + 0.1 * torch.rand(
                (extra["groups"],), generator=g, device="cuda")
        else:
            kw["gelu_approx"] = extra["gelu_approx"]
            kw["out_scales"] = torch.full((1,), 0.1, device="cuda")
        if epi != "float" and route == "fused":
            kw["out_scales"] = 1.0 / kw["out_scales"]
        args = (xs[x_kind], wq, ws * act if route == "fused" else ws,
                None if extra.get("nobias") else bias,
                1.0 / act if route == "fused" else act)
        before = tgemm.linear_int8_launches
        got = tgemm.linear_int8(*args, **kw)
        assert tgemm.linear_int8_launches == before + 1
        want = tgemm.linear_int8_ref(*args, **kw)
        old = _with(tgemm, "_int8_gemm_design", "dp4a", tgemm.linear_int8,
                    *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, old), (route, x_kind, epi)
        if epi == "float":
            rtol = 1e-6 if kw["out_dtype"] == torch.float32 else 2 ** -8
            _close(got, want, (0.0, rtol))
        else:
            _int8_close(got, want)


def _attention_inputs(b, n, heads, option, seed):
    """Packed qkv with hot query rows (logits past the clamp at 80), 30 %
    background (cls column never), a row-stochastic float32 joint, and for
    int8 options their scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * 64
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    if option == "int8_io":
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g,
                            device="cuda", dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand((3 * heads,), generator=g,
                                      device="cuda")
        sc[0] = 0.3
        return qkv, bg, joint, torch.cat([sc, torch.tensor([20.0],
                                                           device="cuda")])
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    scales = torch.tensor([20.0], device="cuda") if option == "int8_out" \
        else None
    return qkv.to(torch.bfloat16).contiguous(), bg.to(torch.bfloat16), joint, \
        scales


def _attention_cases(n, q_block):
    for option in ("bf16", "int8_io", "int8_out"):
        for variant in ("plain", "headmean", "rollout"):
            for clamp in (False, True):
                refused = q_block == 32 and n > 780 and variant != "plain"
                yield option, variant, clamp, refused


def _run(fn, qkv, bg, joint, scales, variant, clamp, q_block=None):
    kw = dict(num_heads=12, scale=0.125, clamp_softmax=clamp,
              with_headmean=variant == "headmean")
    if q_block is not None:
        kw["q_block"] = q_block
    return fn(qkv, bg, joint if variant == "rollout" else None, scales, **kw)


def _hold(got, want, int8_out, variant, k=1):
    """got against want at k times the tolerances (k = 2 between two
    designs, each held to the plain version at k = 1)."""
    tols = (None if int8_out else TOL_OUT, TOL_PROB,
            TOL_JOINT if variant == "rollout" else TOL_PROB)
    for a, w, tol in zip(got, want, tols):
        if tol is None:
            _int8_close(a, w, k * 1e-3)
        else:
            _close(a, w, (k * tol[0], k * tol[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("q_block", [16, 32])
@pytest.mark.parametrize("n", [197, 577, 1025])
def test_cuda_attention_tensor_core_matches_plain_version(n, q_block):
    """Every variant (plain, head mean, rollout; clamp and row max) on bf16
    qkv, int8_out and int8_io at B=2 and 12 heads of 64, with q_block 16 and
    32 (one or two m16 tiles a block): the tensor-core design against the
    plain version; a second launch gives the same bits.  q_block 32 past
    N = 780 with the head mean or the rollout is refused."""
    _card()
    for option, variant, clamp, refused in _attention_cases(n, q_block):
        qkv, bg, joint, scales = _attention_inputs(2, n, 12, option,
                                                   seed=n + q_block)
        if refused:
            with pytest.raises(RuntimeError, match="shared memory"):
                _run(tka.masked_attention_fused, qkv, bg, joint, scales,
                     variant, clamp, q_block)
            continue
        before = tka.launches
        got = _run(tka.masked_attention_fused, qkv, bg, joint, scales,
                   variant, clamp, q_block)
        assert tka.launches == before + 1
        again = _run(tka.masked_attention_fused, qkv, bg, joint, scales,
                     variant, clamp, q_block)
        want = _run(tka.masked_attention_fused_ref, qkv, bg, joint, scales,
                    variant, clamp)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _hold(got, want, scales is not None, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [197, 577])
def test_cuda_attention_tensor_core_matches_fma_design(n):
    """On the same inputs the tensor-core design against the FMA design it
    replaced (held to each other at twice the tolerances each meets against
    the plain version), and q_block 16 against 32 in the tensor-core
    design: out and cls row bit for bit, the head mean too, the rollout
    update to 1e-6."""
    _card()
    for option, variant, clamp, _ in _attention_cases(n, 16):
        qkv, bg, joint, scales = _attention_inputs(2, n, 12, option, seed=n)
        new = _run(tka.masked_attention_fused, qkv, bg, joint, scales,
                   variant, clamp, 16)
        wide = _run(tka.masked_attention_fused, qkv, bg, joint, scales,
                    variant, clamp, 32)
        old = _with(tka, "_fwd_bf16_design", "fma", _run,
                    tka.masked_attention_fused, qkv, bg, joint, scales,
                    variant, clamp)
        torch.cuda.synchronize()
        _hold(new, old, scales is not None, variant, k=2)
        assert torch.equal(new[0], wide[0]) and torch.equal(new[1], wide[1])
        if variant == "headmean":
            assert torch.equal(new[2], wide[2])
        elif variant == "rollout":
            _close(new[2], wide[2], (1e-6, 0.0))


def _block_operands(b, n, seed):
    """bf16 operands of attention_block_fused at ViT-B widths (12 heads of
    64): xn and tokens ~ N(0, 1), weights ~ N(0, 1 / C) in the torch layout
    (logits of order 1, as chip_smoke.py's bf16 cases), biases ~ 0.1 N(0, 1),
    30 % background (cls column never) and a row-stochastic float32 joint."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = 768

    def rnd(*shape, gain=1.0):
        return gain * torch.randn(shape, generator=g, device="cuda")
    ops = tuple(t.to(torch.bfloat16).contiguous() for t in (
        rnd(b, n, c), rnd(b, n, c), rnd(3 * c, c, gain=c ** -0.5),
        rnd(3 * c, gain=0.1), rnd(c, c, gain=c ** -0.5), rnd(c, gain=0.1)))
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(rnd(b, n, n), dim=-1)
    return ops, bg.to(torch.bfloat16), joint


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 37, 197, 256])
def test_cuda_attention_block_tensor_core_matches_plain_and_fma(n):
    """The block kernel's tensor-core design at clusters of 1, 2, 7 and 8
    blocks (N = 17, 37, 197, 256), B=2: with and without the joint, clamp
    and row max, 30 % background and none; one launch each, and a second
    launch gives the same bits.  Against the plain version: out and cls row
    at chip_smoke.py's bf16 tolerances, the rollout update at the bf16
    probability tolerance (the kernel forms qkv itself, summing in another
    order than the plain version before both round it to bf16, and an ulp
    of qkv moves P by ~1e-3 relative: at N = 197 the update reads 3.8e-6
    from the plain version in both designs, past TOL_JOINT).  Against the
    FMA design, which runs the same qkv GEMM: the rollout update at
    TOL_JOINT (3.7e-9 apart on an NVIDIA H100), out and cls row at twice
    the bf16 tolerances."""
    _card()
    assert tka.block_design(torch.bfloat16, n, 768) == "tensor-core"
    ops, bg, joint = _block_operands(2, n, seed=n)
    for bg_ in (bg, torch.zeros_like(bg)):
        for j in (joint, None):
            for clamp in (False, True):
                kw = dict(num_heads=12, scale=0.125, clamp_softmax=clamp)
                before = tka.block_launches
                got = tka.attention_block_fused(*ops, bg_, j, **kw)
                assert tka.block_launches == before + 1
                again = tka.attention_block_fused(*ops, bg_, j, **kw)
                want = tka.attention_block_fused_plain(*ops, bg_, j, **kw)
                old = _with(tka, "_block_bf16_design", "fma",
                            tka.attention_block_fused, *ops, bg_, j, **kw)
                torch.cuda.synchronize()
                assert len(got) == len(want) == len(old) == 2 + (j is not None)
                assert all(torch.equal(a, b) for a, b in zip(got, again))
                for a, w, tol in zip(got, want, (TOL_OUT, TOL_PROB,
                                                 TOL_PROB)):
                    _close(a, w, tol)
                for a, o, tol in zip(got, old, ((2e-2, 2 ** -5),
                                                (2e-5, 2 ** -5), TOL_JOINT)):
                    _close(a, o, tol)


def _mlp_operands(m, c, hid, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, gain=1.0):
        return (gain * torch.randn(shape, generator=g, device="cuda")).to(
            torch.bfloat16)
    return (rnd(m, c), rnd(hid, c, gain=c ** -0.5), rnd(hid, gain=0.1),
            rnd(c, hid, gain=hid ** -0.5), rnd(c, gain=0.1))


def _mlp_int8_operands(m, c, hid, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, c), generator=g, device="cuda").to(torch.bfloat16)

    def layer(n, k, act):
        wq = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                           dtype=torch.int8)
        ws = 1e-3 * (1 + torch.rand((n,), generator=g, device="cuda"))
        return wq, ws * act, torch.randn((n,), generator=g, device="cuda")
    act1 = x.float().abs().amax() / 127.0
    act2 = torch.tensor(6.0 / 127.0, device="cuda")
    w1q, cs1, b1 = layer(hid, c, act1)
    w2q, cs2, b2 = layer(c, hid, act2)
    return x, w1q, cs1, b1, w2q, cs2, b2, 1.0 / act1, 1.0 / act2


def _mlp_old(fn, *args, **kw):
    """``fn`` with both fused MLP wrappers on the mma design."""
    return _with(tgemm, "_mlp_bf16_design", "mma", _with, tgemm,
                 "_mlp_int8_design", "mma", fn, *args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8 * 197, 8 * 197 + 37])
def test_cuda_mlp_wgmma_matches_plain_and_mma(m):
    """The fused MLP kernels' wgmma design at the ViT-B widths (C = 768,
    HID = 3072), M = 8 * 197 and with a tail of 37 rows past a multiple of
    64, both GELUs.  mlp_fused (bf16): against its plain version at
    chip_smoke.py's TOL_MLP for bf16 (1e-2 + 2^-6 relative: both round the
    hidden tensor and the output to bf16, and sum in another order), and
    against the mma design at the same tolerance.  mlp_fused_int8 (bf16 x,
    float32 and bf16 out): bit for bit the mma design and the chain of two
    fused-route linear_int8 launches (exact int32 sums, the same rounded
    float steps), within 1e-6 relative (float32 out) or one bf16 ulp of its
    plain version.  One launch each, and a second launch gives the same
    bits."""
    _card()
    c, hid = 768, 3072
    assert tgemm.mlp_design(c, hid, torch.bfloat16) == "wgmma"
    assert tgemm.mlp_design(c, hid, torch.int8) == "wgmma"
    ops = _mlp_operands(m, c, hid, seed=m)
    for approx in (True, False):
        before = tgemm.mlp_fused_launches
        got = tgemm.mlp_fused(*ops, gelu_approx=approx)
        assert tgemm.mlp_fused_launches == before + 1
        again = tgemm.mlp_fused(*ops, gelu_approx=approx)
        want = tgemm.mlp_fused_plain(*ops, gelu_approx=approx)
        old = _mlp_old(tgemm.mlp_fused, *ops, gelu_approx=approx)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close(got, want, (1e-2, 2 ** -6))
        _close(got, old, (1e-2, 2 ** -6))
    ops = _mlp_int8_operands(m, c, hid, seed=m + 1)
    x, w1q, cs1, b1, w2q, cs2, b2, inv1, inv2 = ops
    one = torch.ones((), device="cuda")
    for out_dtype in (torch.float32, torch.bfloat16):
        for approx in (True, False):
            kw = dict(gelu_approx=approx, out_dtype=out_dtype)
            before = tgemm.mlp_fused_int8_launches
            got = tgemm.mlp_fused_int8(*ops, **kw)
            assert tgemm.mlp_fused_int8_launches == before + 1
            again = tgemm.mlp_fused_int8(*ops, **kw)
            old = _mlp_old(tgemm.mlp_fused_int8, *ops, **kw)
            hq = tgemm.linear_int8(x, w1q, cs1, b1, inv1, route="fused",
                                   epilogue="gelu", out_scales=inv2.reshape(1),
                                   gelu_approx=approx)
            chain = tgemm.linear_int8(hq.float(), w2q, cs2, b2, one,
                                      route="fused", out_dtype=out_dtype)
            want = tgemm.mlp_fused_int8_plain(*ops, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert torch.equal(got, old)
            assert torch.equal(got, chain)
            _close(got, want, (0.0, 1e-6 if out_dtype == torch.float32
                               else 2 ** -8))


def _v1_inputs(b, n, seed, bg_share):
    """bf16 split q, k, v [B, 12, N, 64] with hot query rows 1-3 (logits of
    order 1e2) and a background share (1.1: every token)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, 12, n, 64), generator=g, device="cuda")
               for _ in range(3))
    q[:, :, 1:4] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < bg_share).float()
    return tuple(x.to(torch.bfloat16).contiguous() for x in (q, k, v)), bg


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 197, 577, 1536])
def test_cuda_v1_tensor_core_matches_plain_and_fma(n):
    """The split-tensor kernel's tensor-core design (bf16, every N <= 1536),
    B=2, 12 heads of 64, with and without the head mean, 30 % background and
    all: one launch each, a second launch gives the same bits; against the
    plain version at chip_smoke.py's bf16 tolerances, and against the FMA
    design it replaced at twice them."""
    _card()
    assert tka.v1_design(torch.bfloat16, n) == "tensor-core"
    for share in (0.3, 1.1):
        (q, k, v), bg = _v1_inputs(2, n, seed=n, bg_share=share)
        for hm in (False, True):
            kw = dict(scale=0.125, with_headmean=hm)
            before = tka.v1_launches
            got = tka.masked_attention(q, k, v, bg, **kw)
            assert tka.v1_launches == before + 1
            again = tka.masked_attention(q, k, v, bg, **kw)
            want = tka.masked_attention_ref(q, k, v, bg, **kw)
            old = _with(tka, "_v1_bf16_design", "fma", tka.masked_attention,
                        q, k, v, bg, **kw)
            torch.cuda.synchronize()
            assert len(got) == len(want) == len(old) == 2 + hm
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            for a, w, o, tol in zip(got, want, old,
                                    (TOL_OUT, TOL_PROB, TOL_PROB)):
                _close(a, w, tol)
                _close(a, o, (2 * tol[0], 2 * tol[1]))


def _variant_inputs(b, n, seed):
    """bf16 packed qkv with q and k of mean 0.5 (noexp's row sums away from
    0), 30 % background (cls column never) and a row-stochastic joint."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * 768), generator=g, device="cuda")
    qkv[:, :, :2 * 768] += 0.5
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    return qkv.to(torch.bfloat16).contiguous(), bg, joint


def _hold_variant(got, want, variant, k=1):
    """chip_smoke.py's gates for the ablation kernels at k times the
    tolerances: an int8 P V out past the tolerance on at most 0.1 % of its
    elements (a rounding flip of P moves a term by a step of V)."""
    rtol = max(2 ** -6, 1e-3) if variant == "noexp" else 2 ** -6
    tols = ((1e-2, rtol), (1e-5, rtol), (1e-6, max(1e-4, rtol)))
    for i, (a, w, tol) in enumerate(zip(got, want, tols)):
        tol = (k * tol[0], k * tol[1])
        if i == 0 and variant in ("int8pv", "int8both"):
            a, w = a.float(), w.float()
            assert torch.isfinite(a).all()
            over = (a - w).abs() > tol[0] + tol[1] * w.abs()
            assert float(over.float().mean()) <= k * 1e-3
            continue
        _close(a, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(tav._VARIANTS))
def test_cuda_variants_tensor_core_matches_plain_and_fma(variant):
    """Each ablation kernel's tensor-core design, 12 heads of 64, B=2 at
    N = 197, 37, 577 and the design's limit (780, headbatch 736): one launch
    each, a second launch gives the same bits; against run_ref at
    chip_smoke.py's gates, and against the FMA design it replaced (N = 197
    and 37, where that takes the shape) at twice them."""
    _card()
    limit = tav.HEADBATCH_TC_MAX_N if variant == "headbatch" \
        else tav.VARIANTS_TC_MAX_N
    for n in (197, 37, 577, limit):
        qkv, bg, joint = _variant_inputs(2, n, seed=n)
        assert tav.variants_design(torch.bfloat16, variant, n) == "tensor-core"
        before = tav.launches[variant]
        got = tav.run(qkv, bg, joint, variant)
        assert tav.launches[variant] == before + 1
        again = tav.run(qkv, bg, joint, variant)
        want = tav.run_ref(qkv, bg, joint, variant)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _hold_variant(got, want, variant)
        if n < 577:
            old = _with(tav, "_variants_bf16_design", "fma", tav.run, qkv, bg,
                        joint, variant)
            torch.cuda.synchronize()
            _hold_variant(got, old, variant, k=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 37, 197, 577])
def test_cuda_variants_full_is_kernel1_rollout_bit_for_bit(n):
    """The tensor-core ``full`` is kernel 1's bf16 rollout variant (clamp on,
    mask -100, one m16 tile a block) stage for stage: out, cls row and the
    rollout update equal bit for bit on the same inputs, B=3, 12 heads."""
    _card()
    qkv, bg, joint = _variant_inputs(3, n, seed=100 + n)
    full = tav.run(qkv, bg, joint, "full")
    k1 = tka.masked_attention_fused(qkv, bg, joint, num_heads=12,
                                    scale=tav.SCALE, clamp_softmax=True)
    torch.cuda.synchronize()
    assert len(full) == len(k1) == 3
    for a, b in zip(full, k1):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _w80_inputs(b, n, option, seed, heads=16):
    """The inputs of _attention_inputs at ViT-H/14's heads (16 of width 80):
    bf16, int8_io (per-head scales), int8_io_tensor (per-tensor) or
    int8_out."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * 80
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    if option.startswith("int8_io"):
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g,
                            device="cuda", dtype=torch.int8)
        if option == "int8_io_tensor":
            return qkv, bg, joint, torch.tensor([0.3, 0.02, 0.02, 20.0],
                                                device="cuda")
        sc = 0.01 + 0.02 * torch.rand((3 * heads,), generator=g,
                                      device="cuda")
        sc[0] = 0.3
        return qkv, bg, joint, torch.cat([sc, torch.tensor([20.0],
                                                           device="cuda")])
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    scales = torch.tensor([20.0], device="cuda") if option == "int8_out" \
        else None
    return qkv.to(torch.bfloat16).contiguous(), bg.to(torch.bfloat16), joint, \
        scales


def _run80(fn, qkv, bg, joint, scales, variant, clamp, **kw):
    return fn(qkv, bg, joint if variant == "rollout" else None, scales,
              num_heads=16, scale=80 ** -0.5, clamp_softmax=clamp,
              with_headmean=variant == "headmean", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 257])
def test_cuda_attention_head_width_80_matches_plain_version(n):
    """Kernel 1 at head width 80 (ViT-H/14) in its tensor-core design, every
    variant on bf16, int8_io (per-head and per-tensor scales) and int8_out
    qkv at B=2 and 16 heads: against the plain version, a second launch
    bit for bit, q_block 32 (two m16 tiles) bit for bit q_block 16 on out
    and cls row, and the FMA design within twice the tolerances."""
    _card()
    for option in ("bf16", "int8_io", "int8_io_tensor", "int8_out"):
        qkv, bg, joint, scales = _w80_inputs(2, n, option, seed=n)
        for variant in ("plain", "headmean", "rollout"):
            for clamp in (False, True):
                before = tka.launches
                got = _run80(tka.masked_attention_fused, qkv, bg, joint,
                             scales, variant, clamp)
                assert tka.launches == before + 1
                again = _run80(tka.masked_attention_fused, qkv, bg, joint,
                               scales, variant, clamp)
                wide = _run80(tka.masked_attention_fused, qkv, bg, joint,
                              scales, variant, clamp, q_block=32)
                old = _with(tka, "_fwd_bf16_design", "fma", _run80,
                            tka.masked_attention_fused, qkv, bg, joint,
                            scales, variant, clamp)
                want = _run80(tka.masked_attention_fused_ref, qkv, bg, joint,
                              scales, variant, clamp)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again))
                assert torch.equal(got[0], wide[0])
                assert torch.equal(got[1], wide[1])
                _hold(got, want, scales is not None, variant)
                _hold(got, old, scales is not None, variant, k=2)


@pytest.mark.cuda
def test_cuda_attention_refuses_other_head_widths():
    """Head width 48 is refused by kernel 1 and by the backward kernel, each
    naming its compiled widths (16, 32, 40, 64 and 80 for both)."""
    _card()
    qkv = torch.zeros((1, 9, 3 * 4 * 48), device="cuda", dtype=torch.bfloat16)
    bg = torch.zeros((1, 9), device="cuda")
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, got 48"):
        tka.masked_attention_fused(qkv, bg, num_heads=4, scale=0.1)
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, got 48"):
        tka.masked_attention_bwd(qkv, bg, qkv[..., :192].contiguous(),
                                 num_heads=4, scale=0.1)
