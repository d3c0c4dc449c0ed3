"""The attention block kernel at the zoo's wide and long shapes, on the card.

The streamed design (``kernels/csrc/attention_block_streamed.cuh``: K and V
of every head to a scratch, then one block a tile of query rows across all
heads) at ViT-H/14's N = 257 C = 1280 (16 heads of 80), ViT-L/16@384's N =
577, ViT-L/16@512's N = 1025 and, in float32, ViT-L/16's N = 197 at C =
1024, against its plain version; the cluster design at the shapes it took
before, routed there and launched twice for identical bits (its bits
against an earlier tree: ``chip_smoke.block_bits``); the shared-memory
formulas ``kernels.attention`` routes by, held to the ones the CUDA sources
state; and the refusal past the limits.  The tests need a CUDA GPU (the
kernels have no CPU mode) and skip here; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_block_wide_cuda.py

Tolerances as in chip_smoke.py (``TOL``, ``TOL_JOINT``): float32 out 5e-5 +
1e-4 relative, cls row 1e-6 + 1e-4 relative; bf16 out 1e-2 + 2^-6
relative, cls row 1e-5 + 2^-6 relative; the joint 1e-6 + 1e-4 relative.
"""

import ctypes

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

TOL = {torch.float32: ((5e-5, 1e-4), (1e-6, 1e-4)),
       torch.bfloat16: ((1e-2, 2 ** -6), (1e-5, 2 ** -6))}
TOL_JOINT = (1e-6, 1e-4)
# (B, N, heads, head width) of the zoo's shapes past the cluster design
ZOO = [(2, 257, 16, 80), (2, 577, 16, 64), (2, 1025, 16, 64),
       (2, 197, 16, 64)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _operands(b, n, heads, dh, dtype, seed):
    """chip_smoke.block_operands: weights ~ N(0, 1 / C), float32 with the q
    rows of two heads scaled by 40 (logits past the clamp), bf16 with
    logits of order 1; 30 % background, a row-stochastic joint."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh

    def rnd(*shape, gain=1.0):
        return gain * torch.randn(shape, generator=g, device="cuda")
    ops = (rnd(b, n, c), rnd(b, n, c), rnd(3 * c, c, gain=c ** -0.5),
           rnd(3 * c, gain=0.1), rnd(c, c, gain=c ** -0.5), rnd(c, gain=0.1))
    if dtype == torch.float32:
        ops[2][:2 * dh] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(rnd(b, n, n), dim=-1)
    return tuple(t.to(dtype).contiguous() for t in ops), bg, joint


def _variants(ops, bg, joint, heads, dh):
    for bg_ in (bg, torch.zeros_like(bg)):
        for j in (joint, None):
            for clamp in (False, True):
                yield bg_, j, dict(num_heads=heads, scale=dh ** -0.5,
                                   clamp_softmax=clamp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ZOO, ids=lambda s: "N%d_%dx%d" % s[1:])
def test_cuda_block_streamed_matches_plain(shape, dtype):
    _card()
    b, n, heads, dh = shape
    ops, bg, joint = _operands(b, n, heads, dh, dtype, seed=n)
    for bg_, j, kw in _variants(ops, bg, joint, heads, dh):
        design = tka.block_design(dtype, n, heads * dh, dh, j is not None)
        if design != "streamed":   # ViT-L/16: the cluster design where
            assert n == 197           # its layout fits
        before = dict(tka.block_streamed_launches)
        got = tka.attention_block_fused(*ops, bg_, j, **kw)
        again = tka.attention_block_fused(*ops, bg_, j, **kw)
        want = tka.attention_block_fused_plain(*ops, bg_, j, **kw)
        torch.cuda.synchronize()
        ran = tka.block_streamed_launches[dh] - before[dh]
        assert ran == (2 if design == "streamed" else 0)
        assert len(got) == len(want) == 2 + (j is not None)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for x, w, tol in zip(got, want, TOL[dtype] + (TOL_JOINT,)):
            assert x.dtype == w.dtype
            _close(x, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [17, 37, 197, 256])
def test_cuda_block_present_shapes_keep_the_cluster_design(n, dtype):
    """ViT-B's shapes (C = 768, 12 heads of 64) run the cluster design as
    before: no streamed launch, identical bits on a second launch."""
    _card()
    ops, bg, joint = _operands(2, n, 12, 64, dtype, seed=40 + n)
    for bg_, j, kw in _variants(ops, bg, joint, 12, 64):
        assert tka.block_design(dtype, n, 768, 64, j is not None) == (
            "fma" if dtype == torch.float32 else "tensor-core")
        before = dict(tka.block_streamed_launches)
        got = tka.attention_block_fused(*ops, bg_, j, **kw)
        again = tka.attention_block_fused(*ops, bg_, j, **kw)
        want = tka.attention_block_fused_plain(*ops, bg_, j, **kw)
        torch.cuda.synchronize()
        assert tka.block_streamed_launches == before
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        for x, w, tol in zip(got, want, TOL[dtype] + (TOL_JOINT,)):
            _close(x, w, tol)


@pytest.mark.cuda
def test_cuda_block_smem_formula_matches_kernel():
    """kernels.attention.block_smem_bytes against the bytes the CUDA sources
    compute (vitcam_attention_block_smem_bytes,
    vitcam_attention_block_streamed_smem_bytes) and the bytes each zoo
    instance is launched with (its occupancy entry)."""
    _card()
    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    for dtype in (torch.bfloat16, torch.float32):
        code = tka._DTYPE_CODES[dtype]
        for n in (17, 197, 256, 257, 577, 1025, 1376):
            for heads, dh in ((12, 64), (16, 64), (16, 80), (2, 80)):
                for r in (0, 1):
                    for qb in (16, 32):
                        assert lib.vitcam_attention_block_streamed_smem_bytes(
                            n, heads, dh, r, code, qb) == tka.block_smem_bytes(
                            "streamed", dtype, n, heads * dh, dh, bool(r), qb)
                    if dh != 64:
                        continue
                    for design in ("fma",) + (
                            ("tensor-core",) if code == 1 else ()):
                        assert lib.vitcam_attention_block_smem_bytes(
                            n, heads, r, code, tka.BLOCK_DESIGNS[design]) == \
                            tka.block_smem_bytes(design, dtype, n, heads * dh,
                                                 dh, bool(r))
        for _, n, heads, dh in ZOO:
            if tka.block_design(dtype, n, heads * dh, dh) != "streamed":
                continue
            qb = tka.block_rows(dtype, n, heads * dh, dh)
            info = (ctypes.c_int * 4)()
            assert lib.vitcam_attention_block_streamed_occupancy(
                n, heads, dh, 1, 1, code, qb, info) == 0
            assert info[0] >= 1 and info[2] == 0
            assert info[3] == tka.block_smem_bytes("streamed", dtype, n,
                                                   heads * dh, dh, True, qb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_block_refuses_past_its_limits(dtype):
    """Past the limits the CUDA wrapper raises naming the bytes and
    launches nothing; other head widths raise naming the compiled ones."""
    _card()
    n = tka.BLOCK_MAX_N[dtype] + 1
    ops, bg, joint = _operands(1, n, 16, 80, dtype, seed=3)
    before = tka.block_launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tka.attention_block_fused(*ops, bg, joint, num_heads=16,
                                  scale=80 ** -0.5)
    ops, bg, joint = _operands(1, 37, 12, 48, dtype, seed=4)
    with pytest.raises(ValueError, match="head widths 16, 32, 40, 64, 80, "
                                         "got 48"):
        tka.attention_block_fused(*ops, bg, joint, num_heads=12,
                                  scale=48 ** -0.5)
    assert tka.block_launches == before
