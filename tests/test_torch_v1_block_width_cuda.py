"""The split-tensor attention kernel (v1) at head widths 16, 32, 40 and 80 and
the attention block kernel's streamed design at 16, 32 and 40, on the card,
against their plain versions.

v1 at the JAX kernel tests' shapes and ViT-H/14's, both dtypes and every
design, with the head mean and without (the tensor-core design launched
twice for identical bits); at width 40 with q, k and v the heads of buffers
whose next elements are NaN (the out-of-bounds case: a 48-column read of the
last row of the last slab would reach them); each width at ``V1_MAX_N`` and
one key past it.  The block kernel at the width models' shapes, both dtypes,
every background, joint and clamp; at width 40 after a launch that poisons
the shared memory (the streamed design at C = 1280 on NaN inputs leaves its
q / output tile, which spans the width-40 tile's pad columns at the same
offsets, NaN on every SM); its op under ``torch.library.opcheck`` on CUDA
tensors; both kernels' shared-memory formulas against the CUDA sources'.
The gates are chip_smoke.py's (TOL).  The kernels have no CPU mode: the
tests skip without a CUDA GPU; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_v1_block_width_cuda.py
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

TOL = {(torch.float32, "out"): (5e-5, 1e-4),
       (torch.float32, "prob"): (1e-6, 1e-4),
       (torch.bfloat16, "out"): (1e-2, 2 ** -6),
       (torch.bfloat16, "prob"): (1e-5, 2 ** -6)}
TOL_JOINT = (1e-6, 1e-4)
# v1: (B, N, heads, head width)
V1_SHAPES = [(2, 37, 4, 16), (2, 65, 4, 16), (2, 130, 4, 32),
             (2, 1025, 2, 32), (2, 147, 3, 40), (3, 37, 3, 40),
             (2, 257, 16, 80), (3, 37, 4, 80)]
# the block kernel: (B, N, heads, head width) of the width models
BLOCK_SHAPES = [(2, 65, 4, 16), (2, 197, 4, 32), (2, 197, 3, 40),
                (3, 37, 3, 40)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _v1_inputs(b, n, heads, dh, dtype, seed):
    """q, k, v [B, H, N, dh] with hot query rows 1-3 and 30 % background."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, heads, n, dh), generator=g, device="cuda")
               for _ in range(3))
    q[:, :, 1:4] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    return tuple(t.to(dtype).contiguous() for t in (q, k, v)), bg


def _v1_designs(dtype):
    return ("tensor-core", "fma") if dtype == torch.bfloat16 else ("fma",)


def _v1_call(design, *args, **kw):
    saved = tka._v1_bf16_design
    tka._v1_bf16_design = design
    try:
        return tka.masked_attention(*args, **kw)
    finally:
        tka._v1_bf16_design = saved


def _v1_held(got, want, dtype):
    for g, w, kind in zip(got, want, ("out", "prob", "prob")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, TOL[(dtype, kind)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", V1_SHAPES,
                         ids=lambda s: "B%d_N%d_%dx%d" % s)
def test_cuda_v1_widths_match_plain(shape, dtype):
    _card()
    b, n, heads, dh = shape
    (q, k, v), bg = _v1_inputs(b, n, heads, dh, dtype, seed=n + dh)
    for hm in (False, True):
        kw = dict(scale=dh ** -0.5, with_headmean=hm)
        want = tka.masked_attention_ref(q, k, v, bg, **kw)
        for design in _v1_designs(dtype):
            before = dict(tka.v1_width_launches)
            got = _v1_call(design, q, k, v, bg, **kw)
            again = _v1_call(design, q, k, v, bg, **kw)
            torch.cuda.synchronize()
            assert tka.v1_width_launches[dh] == before[dh] + 2
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            _v1_held(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_v1_width40_reads_nothing_past_the_tensors(dtype):
    """q, k and v [B, H, N, 40] each the head of a buffer whose next
    elements are NaN: the last row of the last slab ends where the NaN
    begin, so a kernel that read 48 columns there (its k16 steps) would
    carry NaN into S; both designs stay finite and held to the plain
    version."""
    _card()
    (q, k, v), bg = _v1_inputs(2, 37, 3, 40, dtype, seed=5)
    ends = []
    for t in (q, k, v):
        buf = torch.full((t.numel() + 64,), float("nan"), dtype=dtype,
                         device="cuda")
        buf[:t.numel()] = t.reshape(-1)
        ends.append(buf[:t.numel()].view(t.shape))
    kw = dict(scale=40 ** -0.5, with_headmean=True)
    want = tka.masked_attention_ref(q, k, v, bg, **kw)
    for design in _v1_designs(dtype):
        got = _v1_call(design, *ends, bg, **kw)
        torch.cuda.synchronize()
        _v1_held(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80])
def test_cuda_v1_runs_to_its_limit_and_refuses_past_it(dh):
    _card()
    n = tka.V1_MAX_N[dh]
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), bg = _v1_inputs(1, n + 1, 1, dh, dtype, seed=dh)
        got = tka.masked_attention(q[:, :, :n].contiguous(),
                                   k[:, :, :n].contiguous(),
                                   v[:, :, :n].contiguous(), bg[:, :n],
                                   scale=0.125, with_headmean=True)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in got)
        before = tka.v1_launches
        with pytest.raises(ValueError, match=rf"N <= {n} .* bytes"):
            tka.masked_attention(q, k, v, bg, scale=0.125)
        assert tka.v1_launches == before


def _block_operands(b, n, heads, dh, dtype, seed, nan=False):
    """chip_smoke.block_operands: weights ~ N(0, 1 / C), float32 with the q
    rows of two heads scaled by 40 (logits past the clamp), bf16 with
    logits of order 1; 30 % background, a row-stochastic joint.  With
    ``nan`` xn is NaN throughout."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * dh

    def rnd(*shape, gain=1.0):
        return gain * torch.randn(shape, generator=g, device="cuda")
    ops = (rnd(b, n, c), rnd(b, n, c), rnd(3 * c, c, gain=c ** -0.5),
           rnd(3 * c, gain=0.1), rnd(c, c, gain=c ** -0.5), rnd(c, gain=0.1))
    if dtype == torch.float32:
        ops[2][:2 * dh] *= 40.0
    if nan:
        ops[0].fill_(float("nan"))
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    joint = torch.softmax(rnd(b, n, n), dim=-1)
    return tuple(t.to(dtype).contiguous() for t in ops), bg, joint


def _block_variants(bg, joint, heads, dh):
    for bg_ in (bg, torch.zeros_like(bg)):
        for j in (joint, None):
            for clamp in (False, True):
                yield bg_, j, dict(num_heads=heads, scale=dh ** -0.5,
                                   clamp_softmax=clamp)


def _block_held(got, want, dtype, joint_tol=TOL_JOINT):
    assert len(got) == len(want)
    for x, w, tol in zip(got, want, (TOL[(dtype, "out")],
                                     TOL[(dtype, "prob")], joint_tol)):
        assert x.dtype == w.dtype and x.shape == w.shape
        _close(x, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BLOCK_SHAPES,
                         ids=lambda s: "B%d_N%d_%dx%d" % s)
def test_cuda_block_widths_match_plain(shape, dtype):
    """The streamed design (the only one at these widths), launched twice
    for identical bits, one streamed launch a call at the width."""
    _card()
    b, n, heads, dh = shape
    ops, bg, joint = _block_operands(b, n, heads, dh, dtype, seed=n + dh)
    for bg_, j, kw in _block_variants(bg, joint, heads, dh):
        assert tka.block_design(dtype, n, heads * dh, dh, j is not None) \
            == "streamed"
        before = dict(tka.block_streamed_launches)
        got = tka.attention_block_fused(*ops, bg_, j, **kw)
        again = tka.attention_block_fused(*ops, bg_, j, **kw)
        want = tka.attention_block_fused_plain(*ops, bg_, j, **kw)
        torch.cuda.synchronize()
        assert tka.block_streamed_launches[dh] == before[dh] + 2
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        _block_held(got, want, dtype)


def streamed_call(lib, ops, bg, joint, kv, heads, dh, first=True,
                  entry=None):
    """One call of the streamed design's C entry at q_block 32, clamp on,
    by ctypes: ``first`` the whole entry (K and V into ``kv``, then the
    attention launch), else the attention launch alone through ``entry``
    (the width unit's ``vitcam_attention_block_streamed_w<dh>``, of ``lib``
    or of another build) on the ``kv`` an earlier call wrote.  Returns (out,
    cls row[, J'])."""
    import ctypes
    xn = ops[0]
    b, n, c = xn.shape
    out, cls = torch.empty_like(xn), torch.empty((b, n), dtype=xn.dtype,
                                                  device=xn.device)
    newj = None if joint is None else torch.empty_like(joint)
    ptrs = [t.data_ptr() for t in ops] + [
        bg.data_ptr(), None if joint is None else joint.data_ptr(),
        kv.data_ptr(), out.data_ptr(), cls.data_ptr(),
        None if newj is None else newj.data_ptr()]
    tail = [ctypes.c_float(dh ** -0.5), ctypes.c_float(-100.0),
            tka._DTYPE_CODES[xn.dtype], 1, 32,
            torch.cuda.current_stream().cuda_stream]
    if first:
        err = lib.vitcam_attention_block_streamed(*ptrs, b, n, heads, dh,
                                                  *tail)
    else:
        entry = entry or getattr(lib, f"vitcam_attention_block_streamed_w{dh}")
        entry.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
            ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        err = entry(*ptrs, b, n, heads, *tail)
    assert err == 0, err
    return (out, cls) + (() if newj is None else (newj,))


@pytest.mark.cuda
@pytest.mark.parametrize("with_joint", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_block_width40_after_a_launch_that_poisons_shared_memory(
        dtype, with_joint):
    """The width-40 block kernel (C = 120: the proj GEMM reads the [QB, C +
    pad] tile's pad columns as A columns 120..127, and the last head's last
    k16 step of QK^T reaches them) launched right after one that poisons
    the shared memory: the streamed design at C = 1280 (16 heads of 80) on
    NaN inputs, whose q / output tile, NaN throughout, spans the width-40
    tile's pad at the same offsets on every SM (144 blocks, one an SM, on
    132 SMs).  The wrapper's own call runs the K / V launch in between (its
    GEMM staging overwrites those bytes with finite values), so the width-40
    attention launch is made alone, through its width unit's C entry, on
    the K / V scratch of a whole call before: its outputs must equal that
    call's bit for bit and stay finite.  A kernel that left its pad as it
    found it returns NaN here."""
    _card()
    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    poison, bgp, _ = _block_operands(16, 257, 16, 80, dtype, seed=1,
                                     nan=True)
    ops, bg, joint = _block_operands(64, 197, 3, 40, dtype, seed=2)
    joint = joint if with_joint else None
    assert tka.block_rows(dtype, 197, 120, 40, with_joint) == 32
    kv = torch.empty((64, 2, 3, 197, 40), dtype=dtype, device="cuda")
    whole = streamed_call(lib, ops, bg, joint, kv, 3, 40)
    bad = tka.attention_block_fused(*poison, bgp, None, num_heads=16,
                                    scale=80 ** -0.5, clamp_softmax=True)
    got = streamed_call(lib, ops, bg, joint, kv, 3, 40, first=False)
    torch.cuda.synchronize()
    assert not torch.isfinite(bad[0]).any()         # the poison was NaN
    assert all(torch.equal(x, y) for x, y in zip(got, whole))
    want = tka.attention_block_fused_plain(
        *ops, bg, joint, num_heads=3, scale=40 ** -0.5, clamp_softmax=True)
    # over 64 images the bf16 rollout update reads up to ~2e-6 from the plain
    # version (chip_smoke.BLOCK_WIDTH_CASES): held at the bf16 probability
    # tolerance, as chip_smoke.py's width checks hold it at B = 64
    _block_held(got, want, dtype, TOL_JOINT if dtype == torch.float32
                else TOL[(dtype, "prob")])


@pytest.mark.cuda
@pytest.mark.parametrize("rollout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_opcheck_block_width40(dtype, rollout):
    """Both block ops on CUDA tensors at head width 40 (C = 120, N = 65), as
    tests/test_torch_export.py checks them on the CPU: the fake's shapes and
    dtypes against the kernel's outputs."""
    _card()
    from vision_transformer_cam_tpu_torch.kernels import ops as kops
    b, n, heads, dh = 2, 65, 3, 40
    c = heads * dh
    g = torch.Generator(device="cuda").manual_seed(6)

    def t(*shape):
        return (0.3 * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)
    args = (t(b, n, c), t(b, n, c), t(3 * c, c), t(3 * c), t(c, c), t(c),
            torch.zeros((b, n), device="cuda"))
    if rollout:
        joint = torch.eye(n, device="cuda").expand(b, n, n).contiguous()
        torch.library.opcheck(kops._block_rollout,
                              (*args, joint, heads, dh ** -0.5, -100.0, True))
    else:
        torch.library.opcheck(kops._block, (*args, heads, dh ** -0.5, -100.0,
                                            True))


@pytest.mark.cuda
def test_cuda_smem_formulas_match_the_kernels():
    """kernels.attention.v1_smem_bytes and block_smem_bytes against the
    bytes the CUDA sources compute at every compiled width
    (vitcam_masked_attention_v1_smem_bytes,
    vitcam_attention_block_streamed_smem_bytes)."""
    _card()
    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    for dh in (16, 32, 40, 64, 80):
        for n in (17, 37, 65, 130, 197, 257, 780, 1025, tka.V1_MAX_N[dh]):
            for hm in (0, 1):
                for design, dtype in (("tensor-core", torch.bfloat16),
                                      ("fma", torch.float32)):
                    assert lib.vitcam_masked_attention_v1_smem_bytes(
                        n, hm, tka.V1_DESIGNS[design], dh) == \
                        tka.v1_smem_bytes(design, dtype, n, dh, bool(hm))
        for dtype in (torch.bfloat16, torch.float32):
            code = tka._DTYPE_CODES[dtype]
            for n in (17, 65, 197, 256, 577):
                for heads in (1, 3, 4, 16):
                    for r in (0, 1):
                        for qb in (16, 32):
                            assert \
                                lib.vitcam_attention_block_streamed_smem_bytes(
                                    n, heads, dh, r, code, qb) == \
                                tka.block_smem_bytes("streamed", dtype, n,
                                                     heads * dh, dh, bool(r),
                                                     qb)
    assert lib.vitcam_masked_attention_v1_smem_bytes(197, 1, 1, 48) == 0
