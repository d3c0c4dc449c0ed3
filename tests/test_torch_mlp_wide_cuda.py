"""The fused MLP kernels at the zoo's wide widths, on the card.

ViT-L (C = 1024, HID = 4096) and ViT-H/14 (C = 1280, HID = 5120) run in two
column groups: the wgmma design's instances at 256 and 320 output columns a
consumer warpgroup (``kernels/csrc/mlp_fused_wgmma_wide.cu``) for bf16 and
int8, and the column-group grid of ``kernels/csrc/mlp_fused.cu`` for
float32 and the mma design.  Each is held against its plain version; int8
also bit for bit against the mma design and the chain of two fused-route
``linear_int8`` launches.  The shared-memory formulas ``kernels.gemm``
routes by are held to the ones the CUDA sources state.  The tests need a
CUDA GPU (the kernels have no CPU mode) and skip here; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_mlp_wide_cuda.py

Tolerances as in chip_smoke.py (``TOL_MLP``): float32 5e-5 + 1e-4
relative, bf16 1e-2 + 2^-6 relative; int8 1e-6 relative (float32 out) or
one bf16 ulp of the plain version.
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import gemm as tgemm

# (M, C, HID): ragged rows past a multiple of 64 at ViT-L/16@512's and
# ViT-H/14's token counts
SHAPES = {"vit_l": (2 * 1025 + 37, 1024, 4096),
          "vit_h": (8 * 257 + 37, 1280, 5120)}
TOL_MLP = {torch.float32: (5e-5, 1e-4), torch.bfloat16: (1e-2, 2 ** -6)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


def _with(name, value, fn, *args, **kw):
    saved = getattr(tgemm, name)
    setattr(tgemm, name, value)
    try:
        return fn(*args, **kw)
    finally:
        setattr(tgemm, name, saved)


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _mlp_operands(m, c, hid, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, gain=1.0):
        return (gain * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(SHAPES))
def test_cuda_wide_mlp_fused_matches_plain(width):
    """mlp_fused at the wide widths, both GELUs: bf16 in the wgmma design
    (two column groups; one launch, a second gives the same bits) and in the
    mma design, float32 in the FMA design, each against the plain version."""
    _card()
    m, c, hid = SHAPES[width]
    assert tgemm.mlp_design(c, hid, torch.bfloat16) == "wgmma"
    assert tgemm.mlp_design(c, hid, torch.float32) == "fma"
    for dtype in (torch.bfloat16, torch.float32):
        ops = _mlp_operands(m, c, hid, dtype, seed=c)
        for approx in (True, False):
            want = tgemm.mlp_fused_plain(*ops, gelu_approx=approx)
            before = tgemm.mlp_fused_launches
            got = tgemm.mlp_fused(*ops, gelu_approx=approx)
            assert tgemm.mlp_fused_launches == before + 1
            torch.cuda.synchronize()
            _close(got, want, TOL_MLP[dtype])
            if dtype == torch.bfloat16:
                assert torch.equal(got, tgemm.mlp_fused(
                    *ops, gelu_approx=approx))
                old = _with("_mlp_bf16_design", "mma", tgemm.mlp_fused,
                            *ops, gelu_approx=approx)
                torch.cuda.synchronize()
                _close(old, want, TOL_MLP[dtype])
                _close(got, old, TOL_MLP[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(SHAPES))
def test_cuda_wide_mlp_fused_int8_matches_chain(width):
    """mlp_fused_int8 at the wide widths (bf16 x; float32 and bf16 out; both
    GELUs): the wgmma design bit for bit the mma design and the chain of two
    fused-route linear_int8 launches, and within 1e-6 relative (float32) or
    one bf16 ulp of its plain version."""
    _card()
    m, c, hid = SHAPES[width]
    assert tgemm.mlp_design(c, hid, torch.int8) == "wgmma"
    ops = _mlp_int8_operands(m, c, hid, seed=c + 1)
    x, w1q, cs1, b1, w2q, cs2, b2, inv1, inv2 = ops
    one = torch.ones((), device="cuda")
    for out_dtype in (torch.float32, torch.bfloat16):
        for approx in (True, False):
            kw = dict(gelu_approx=approx, out_dtype=out_dtype)
            before = tgemm.mlp_fused_int8_launches
            got = tgemm.mlp_fused_int8(*ops, **kw)
            assert tgemm.mlp_fused_int8_launches == before + 1
            again = tgemm.mlp_fused_int8(*ops, **kw)
            old = _with("_mlp_int8_design", "mma", tgemm.mlp_fused_int8,
                        *ops, **kw)
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


@pytest.mark.cuda
def test_cuda_int8_wgmma_at_c_1536():
    """int8 at C = 1536 (past the bf16 limit): the wgmma design's 384-column
    instance in two groups, bit for bit the chain of two linear_int8
    launches."""
    _card()
    m, c, hid = 8 * 197 + 37, 1536, 256
    ops = _mlp_int8_operands(m, c, hid, seed=7)
    x, w1q, cs1, b1, w2q, cs2, b2, inv1, inv2 = ops
    got = tgemm.mlp_fused_int8(*ops, out_dtype=torch.float32)
    hq = tgemm.linear_int8(x, w1q, cs1, b1, inv1, route="fused",
                           epilogue="gelu", out_scales=inv2.reshape(1))
    chain = tgemm.linear_int8(hq.float(), w2q, cs2, b2,
                              torch.ones((), device="cuda"), route="fused",
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, chain)


@pytest.mark.cuda
def test_cuda_shared_memory_formulas_match_the_kernels():
    """``kernels.gemm.mlp_smem_bytes`` (what ``mlp_design`` routes and
    refuses by) equals the bytes the CUDA sources compute, at every C the
    routes reach; the wgmma ring and column groups at the zoo widths; and a
    bf16 call past C = 1280 raises before any launch, naming the bytes."""
    _card()
    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    for c in range(64, 2753, 64):
        for dt in (torch.bfloat16, torch.int8):
            assert lib.vitcam_mlp_wgmma_smem_bytes(c, kinds[dt]) == \
                tgemm.mlp_smem_bytes(c, "wgmma", dt), (c, dt)
        for dt, design in ((torch.float32, "fma"), (torch.bfloat16, "mma"),
                           (torch.int8, "mma")):
            assert lib.vitcam_mlp_fused_smem_bytes(c, kinds[dt]) == \
                tgemm.mlp_smem_bytes(c, design, dt), (c, dt)
    assert [lib.vitcam_mlp_wgmma_ring_stages(c, k) for c in (768, 1024, 1280)
            for k in (1, 2)] == [4, 6, 3, 6, 2, 5]
    assert [lib.vitcam_mlp_wgmma_group_cols(c) for c in (768, 1024, 1280)] \
        == [384, 256, 320]
    m, c, hid = 111, 1344, 256
    ops = _mlp_operands(m, c, hid, torch.bfloat16, seed=3)
    before = tgemm.mlp_fused_launches
    with pytest.raises(ValueError, match="C=1344 needs 238632 bytes"):
        tgemm.mlp_fused(*ops)
    assert tgemm.mlp_fused_launches == before
