"""Kernel 1 and the attention backward at head widths 16, 32 and 40 on the
card, against their plain versions.

The shapes are the JAX kernel tests' fuzz set (tests/test_kernel_fuzz.py, B
= 2) and the JAX quickstart's N = 65 with 4 heads of 16.  Kernel 1 runs every
dtype and int8 option (bf16, float32, int8_io with per-head and per-tensor
scales, int8_out), variant and clamp in every design that takes the dtype
(the tensor-core design twice, for identical bits); the backward both
dtypes in every design that takes the shape.  The gates are chip_smoke.py's
(TOL, TOL_BWD).  The kernels have no CPU mode: the tests skip without a
CUDA GPU; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_head_width_cuda.py
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

SHAPES = [(2, 130, 4, 32), (2, 147, 3, 40), (2, 513, 2, 32),
          (2, 1025, 2, 32), (2, 65, 4, 16)]
TOL = {(torch.float32, "out"): (5e-5, 1e-4),
       (torch.float32, "prob"): (1e-6, 1e-4),
       (torch.bfloat16, "out"): (1e-2, 2 ** -6),
       (torch.bfloat16, "prob"): (1e-5, 2 ** -6)}
TOL_JOINT = (1e-6, 1e-4)
TOL_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 2 ** -6)}
KINDS = [(torch.bfloat16, None), (torch.float32, None),
         (torch.int8, "per_head"), (torch.int8, "per_tensor"),
         (torch.bfloat16, "int8_out")]


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


def _close(got, want, tol):
    if tol is None:     # int8: one step on at most 0.1 % of the elements
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
        return
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _inputs(b, n, heads, dh, dtype, opt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(torch.randn((b, n, n), generator=g, device="cuda"),
                          dim=-1)
    if dtype == torch.int8:
        qkv = torch.randint(-127, 128, (b, n, 3 * c), generator=g,
                            device="cuda", dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand((3 * heads,), generator=g,
                                      device="cuda")
        sc[0] = 0.3
        out = torch.tensor([20.0], device="cuda")
        scales = torch.cat([sc, out]) if opt == "per_head" else \
            torch.tensor([0.3, 0.02, 0.02, 20.0], device="cuda")
        return qkv, bg, joint, scales
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    scales = torch.tensor([20.0], device="cuda") if opt == "int8_out" \
        else None
    return qkv.to(dtype).contiguous(), bg, joint, scales


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel1_matches_plain_version_at_new_widths(shape):
    _card()
    b, n, heads, dh = shape
    for dtype, opt in KINDS:
        qkv, bg, joint, scales = _inputs(b, n, heads, dh, dtype, opt, n)
        fdt = torch.bfloat16 if dtype == torch.int8 else dtype
        for variant in ("plain", "headmean", "rollout"):
            for clamp in (False, True):
                kw = dict(num_heads=heads, scale=dh ** -0.5,
                          clamp_softmax=clamp,
                          with_headmean=variant == "headmean")
                j = joint if variant == "rollout" else None
                want = tka.masked_attention_fused_ref(qkv, bg, j, scales,
                                                      **kw)
                tols = [None if scales is not None else TOL[(fdt, "out")],
                        TOL[(fdt, "prob")],
                        TOL_JOINT if j is not None else TOL[(fdt, "prob")]]
                designs = ["fma"] if dtype == torch.float32 else \
                    ["tensor-core", "fma"]
                for design in designs:
                    before = tka.width_launches[dh]
                    got = _with(tka, "_fwd_bf16_design", design,
                                tka.masked_attention_fused, qkv, bg, j,
                                scales, **kw)
                    assert tka.width_launches[dh] == before + 1
                    assert len(got) == len(want)
                    for g_, w_, tol in zip(got, want, tols):
                        _close(g_, w_, tol)
                    if design == "tensor-core":
                        again = tka.masked_attention_fused(qkv, bg, j,
                                                           scales, **kw)
                        assert all(torch.equal(x, y)
                                   for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_plain_version_at_new_widths(shape):
    _card()
    b, n, heads, dh = shape
    for dtype in (torch.bfloat16, torch.float32):
        qkv, bg, _, _ = _inputs(b, n, heads, dh, dtype, None, 100 + n)
        g = torch.Generator(device="cuda").manual_seed(n)
        d_out = torch.randn((b, n, heads * dh), generator=g,
                            device="cuda").to(dtype)
        # float32 against the plain version evaluated in float64
        ref = [t.double() if dtype == torch.float32 else t
               for t in (qkv, bg, d_out)]
        designs = ["tensor-core", "two-kernel"] if dtype == torch.bfloat16 \
            else ["two-kernel"]
        if n <= tka.BWD_ONE_BLOCK_MAX_N[dh]:
            designs.append("one-block")
        for clamp in (False, True):
            kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=clamp)
            want = tka.masked_attention_bwd_ref(*ref, **kw)
            for design in designs:
                if dtype == torch.bfloat16:
                    got = _with(tka, "_bwd_bf16_design", design,
                                tka.masked_attention_bwd, qkv, bg, d_out,
                                **kw)
                else:
                    limits = {w: tka.BWD_MAX_N[w] if design == "one-block"
                              else 0 for w in tka.BWD_HEAD_DIMS}
                    got = _with(tka, "BWD_ONE_BLOCK_MAX_N", limits,
                                tka.masked_attention_bwd, qkv, bg, d_out,
                                **kw)
                _close(got, want, TOL_BWD[dtype])
                if design == "tensor-core":
                    assert torch.equal(got, tka.masked_attention_bwd(
                        qkv, bg, d_out, **kw))


@pytest.mark.cuda
def test_new_widths_train_through_fused_attention_diff():
    """fused_attention_diff at head width 16 (the JAX quickstart's) launches
    kernel 1 and the backward at that width, and its gradient is the plain
    backward's within TOL_BWD."""
    _card()
    qkv, bg, _, _ = _inputs(2, 65, 4, 16, torch.bfloat16, None, 7)
    leaf = qkv.clone().requires_grad_(True)
    f0, b0 = tka.width_launches[16], tka.bwd_width_launches[16]
    out, _ = tka.fused_attention_diff(leaf, bg, num_heads=4, scale=0.25)
    d_out = torch.randn_like(out)
    grad, = torch.autograd.grad(out, leaf, d_out)
    assert (tka.width_launches[16], tka.bwd_width_launches[16]) == \
        (f0 + 1, b0 + 1)
    _close(grad, tka.masked_attention_bwd_ref(qkv, bg, d_out, num_heads=4,
                                              scale=0.25),
           TOL_BWD[torch.bfloat16])
