"""The split-tensor attention kernel (v1) and the attention block kernel at
the head widths the JAX package's kernels and tests take beside 64: v1 at
16, 32, 40 and 80, the block kernel at 16, 32 and 40 (80: tests/
test_torch_block_wide.py), against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
each JAX call is shared by the cases it answers (a module-scoped fixture a
width and shape: the three backgrounds are three image pairs of one batch,
and the call with the head mean also answers the cases without it).  The
port runs the kernels' plain versions (CPU tensors).  The CUDA kernels' own
checks at these widths are in tests/test_torch_v1_block_width_cuda.py and
chip_smoke.py.  Also here, needing no CUDA: the widths both wrappers take
and refuse, v1's per-width limits on N against the shared-memory formulas of
csrc/masked_attention_v1.cuh written out again, and the block kernel's
routing at the new widths.
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.models import vit as tvit

try:  # the GPU machine has no jax
    import jax
    import jax.numpy as jnp

    from vision_transformer_cam_tpu import configs as jcfgs
    from vision_transformer_cam_tpu.kernels import attention as jka
    from vision_transformer_cam_tpu.models import vit as jvit
    from vision_transformer_cam_tpu_torch.io.weights import (
        load_state_dict, state_dict_from_jax_params)
    JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
except ImportError:
    jax = None

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BG_KINDS = ("none", "30%", "all")


def _needs_jax():
    if jax is None:
        pytest.skip("needs jax (the JAX reference)")


# ---------------------------------------------------------------------------
# 1. the split-tensor kernel (v1)
# ---------------------------------------------------------------------------

V1_WIDTHS = (16, 32, 40, 80)
# (B per background kind, heads, N): the JAX kernel test's N = 37, and N =
# 130, past the JAX kernel's padding of N to 128
V1_SHAPES = ((2, 4, 37), (2, 2, 130))
# tests/test_torch_attention_v1.py's: float32 out 1e-5, cls row and head
# mean 1e-6; bf16 1e-2 / 1e-3 (both emit them in bf16)
V1_TOL = {"float32": {"out": 1e-5, "cls": 1e-6, "hm": 1e-6},
          "bfloat16": {"out": 1e-2, "cls": 1e-3, "hm": 1e-3}}


def _v1_inputs(dh, shape, seed):
    """q, k, v [3 B, H, N, dh] with a few hot rows and bg [3 B, N]: image
    pairs 0-1 without background, 2-3 with 30 %, 4-5 all background."""
    b, h, n = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((3 * b, h, n, dh)).astype(np.float32)
               for _ in range(3))
    q[:, :, 1:3] *= 8.0
    share = np.repeat([0.0, 0.3, 1.1], b)[:, None]
    bg = (rng.random((3 * b, n)) < share).astype(np.float32)
    return q, k, v, bg


@pytest.fixture(scope="module", params=[
    (dh, shape, dtype) for dh in V1_WIDTHS for shape in V1_SHAPES
    for dtype in ("float32", "bfloat16")],
    ids=lambda p: "dh%d-N%d-%s" % (p[0], p[1][2], p[2]))
def v1_jax(request):
    """(dh, shape, dtype, inputs, the JAX kernel's out, cls row and head
    mean as float32 numpy), one interpret call for every case of the
    width, shape and dtype."""
    _needs_jax()
    dh, shape, dtype = request.param
    q, k, v, bg = _v1_inputs(dh, shape, seed=dh + shape[2])
    res = jka.masked_attention(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), jnp.asarray(bg),
        scale=dh ** -0.5, with_headmean=True, interpret=True)
    want = [np.asarray(r.astype(jnp.float32)) for r in res]
    return dh, shape, dtype, (q, k, v, bg), want


@pytest.mark.parametrize("bg_kind", BG_KINDS)
@pytest.mark.parametrize("hm", [False, True])
def test_v1_plain_version_matches_jax_kernel(v1_jax, hm, bg_kind):
    dh, (b, _, _), dtype, inputs, want = v1_jax
    rows = slice(b * BG_KINDS.index(bg_kind), b * (BG_KINDS.index(bg_kind)
                                                   + 1))
    q, k, v, bg = (torch.from_numpy(a[rows]) for a in inputs)
    got = tka.masked_attention(*(t.to(TDT[dtype]) for t in (q, k, v)), bg,
                               scale=dh ** -0.5, with_headmean=hm)
    assert len(got) == 2 + hm
    for name, g, w in zip(("out", "cls", "hm"), got, want):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w[rows].shape
        np.testing.assert_allclose(g.float().numpy(), w[rows], rtol=0,
                                   atol=V1_TOL[dtype][name], err_msg=name)
    assert np.isfinite(got[0].float().numpy()).all()   # all background too


# ---------------------------------------------------------------------------
# 2. the block kernel
# ---------------------------------------------------------------------------

# (heads, head width): C = 128 in 4 heads of 32 and C = 120 in 3 of 40, the
# JAX kernel tests' fuzz widths
BLOCK_WIDTHS = ((4, 32), (3, 40))
BLOCK_NS = (37, 65)
# tests/test_torch_block_wide.py's BLOCK_TOL: float32 tokens 2e-4, cls row
# and joint 1e-5; bf16 5e-2, 1e-2, 1e-3
BLOCK_TOL = {"float32": (2e-4, 1e-5, 1e-5), "bfloat16": (5e-2, 1e-2, 1e-3)}
# (dtype, joint, clamp, N): every joint and clamp combination in float32 at
# both N; bf16 as the serving path runs the kernel (the rollout carried, the
# clamp on) at N = 65
BLOCK_KINDS = [("float32", j, cl, n) for n in BLOCK_NS for j in (False, True)
               for cl in (False, True)] + [("bfloat16", True, True, 65)]


def _block_case(b, n, heads, dh, seed, hot):
    """xn, tokens, the weights in the JAX layout [in, out] (~ N(0, 1 / C);
    with ``hot`` the q and k columns scaled by 5, so that logits reach the
    clamp), biases, a bg with the cls column 0 and a row-stochastic joint."""
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


@pytest.mark.parametrize("dtype,with_joint,clamp,n", BLOCK_KINDS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("heads,dh", BLOCK_WIDTHS)
def test_block_matches_jax_interpret(heads, dh, dtype, with_joint, clamp,
                                     n):
    """float32 with hot q and k (logits past the clamp), bf16 with logits of
    order 1, as tests/test_torch_block_wide.py holds widths 64 and 80."""
    _needs_jax()
    ops, bg, joint = _block_case(2, n, heads, dh, seed=n + dh,
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


_MODEL = dict(img_size=32, patch_size=8, depth=2, num_classes=20,
              mask_from=1, top_k_patches=4, per_sample_mask_norm=True,
              attn_block_fusion=True)


@pytest.mark.parametrize("heads,dh", BLOCK_WIDTHS)
def test_block_fused_model_matches_jax_pallas(monkeypatch, heads, dh):
    """A depth-2 model at 32 x 32 (patch 8, N = 17) with attn_block_fusion
    at head width 32 and 40 against JAX vit.apply on its Pallas path with
    the fusion on, on the same float32 weights (the qkv weights scaled so
    that the mask switches tokens off), at the JAX test's tolerances
    (tests/test_kernels.py: test_block_fusion_v3_matches_v2): logits 2e-4,
    rollout row and cls rows 1e-5."""
    _needs_jax()
    fields = dict(_MODEL, embed_dim=heads * dh, num_heads=heads)
    jcfg = jcfgs.ViTCAMConfig(**fields, attn_impl="pallas")
    tcfg = tcfgs.ViTCAMConfig(**fields, attn_impl="kernel")
    assert tcfg.head_dim == dh
    params = jvit.init(jcfg, jax.random.key(dh))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * 20.0
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), tcfg))
    x = np.random.default_rng(dh).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = jvit.apply(params, jnp.asarray(x), jcfg, need_rollout=True)
    calls = []
    real = tvit.attention_block_fused
    monkeypatch.setattr(tvit, "attention_block_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = model(torch.from_numpy(x), need_rollout=True)
    assert len(calls) == fields["depth"]
    _, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel()          # the mask engaged
    for name, tol in (("logits", 2e-4), ("attn_cls_rows", 1e-5),
                      ("rollout_row", 1e-5)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# 3. widths, limits and routing (no CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["v1", "block"])
@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80, 24, 48])
def test_head_widths_taken_and_refused(kernel, dh):
    if dh in (24, 48):
        with pytest.raises(ValueError, match=r"compiled for head widths 16, "
                                             rf"32, 40, 64, 80, got {dh}$"):
            tka.check_head_width(kernel, dh)
    else:
        assert tka.check_head_width(kernel, dh) == dh


def _v1_fma_bytes(n, dh, qb):
    """csrc/masked_attention_v1.cuh: smem_bytes, with the head mean."""
    ns = -(-n // 4) * 4
    return 4 * (qb * dh + 64 * (dh + 4) + 2 * qb * ns + ns + n + qb)


def _v1_tc_bytes(n, dh):
    """csrc/masked_attention_v1.cuh: tc_smem_bytes, with the head mean: the
    rings of 8 warps (two stages of a 16-key K and V chunk in bf16 rows of
    the tile pitch, or the warp's [16, width + 8] f32 O tile), the keys' bg,
    the cls sums, the row statistics, the rows' bg, the [16, ceil32(N) + 8]
    head mean and, past or below width 64, the [16, pitch] bf16 Q tile."""
    w = -(-dh // 16) * 16
    pitch = 64 if dh == 64 else (w if (w // 8) % 2 else w + 8)
    ring = max(4 * 16 * pitch * 2, 16 * (w + 8) * 4)
    nk, hs = -(-n // 16) * 16, -(-n // 32) * 32 + 8
    q_tile = 0 if dh == 64 else 16 * pitch * 2
    return 8 * ring + 4 * (2 * nk + 256 + 16 + 16 * hs) + q_tile


@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80])
def test_v1_limits_follow_shared_memory(dh):
    """V1_MAX_N[dh] is the largest multiple of 16 at which both designs'
    layouts with the head mean fit 232,448 bytes (the FMA design at 16
    query rows there); width 64 keeps 1536; past it the rule raises naming
    the bytes, at it both dtypes route."""
    limit = 232448

    def fits(n):
        return (_v1_tc_bytes(n, dh) <= limit
                and min(_v1_fma_bytes(n, dh, qb) for qb in (16, 32))
                <= limit)
    n_max = tka.V1_MAX_N[dh]
    assert n_max % 16 == 0 and fits(n_max) and not fits(n_max + 16)
    assert tka.V1_MAX_N[64] == 1536
    for n in (17, 197, n_max - 3, n_max):
        assert tka.v1_smem_bytes("tensor-core", torch.bfloat16, n, dh) == \
            _v1_tc_bytes(n, dh)
        qb = 32 if _v1_fma_bytes(n, dh, 32) <= limit else 16
        assert tka.v1_smem_bytes("fma", torch.float32, n, dh) == \
            _v1_fma_bytes(n, dh, qb)
    assert tka.v1_design(torch.bfloat16, n_max, dh) == "tensor-core"
    assert tka.v1_design(torch.float32, n_max, dh) == "fma"
    with pytest.raises(ValueError, match=rf"N <= {n_max} at head width {dh}"
                                         r".* needs \d+ bytes"):
        tka.v1_design(torch.bfloat16, n_max + 1, dh)
    with pytest.raises(ValueError, match="compiled for head widths"):
        tka.v1_design(torch.float32, 197, 48)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,dh", [(4, 16), (4, 32), (3, 40)])
def test_block_routes_the_new_widths_to_the_streamed_design(dtype, heads,
                                                            dh):
    """At 16, 32 and 40 the cluster design (width 64 only) never runs: every
    N <= 256 with the rollout and without goes to the streamed design at the
    row tile its layout fits, which the Python mirror of the CUDA layout
    puts within the 232,448 bytes."""
    c = heads * dh
    for n in range(1, 257):
        for rollout in (True, False):
            assert tka.block_design(dtype, n, c, dh, rollout) == "streamed"
    for n in (17, 65, 197, 256):
        qb = tka.block_rows(dtype, n, c, dh)
        need = tka.block_smem_bytes("streamed", dtype, n, c, dh, True, qb)
        assert qb == 32 and need <= tka.BLOCK_SMEM_LIMIT
    # the bf16 layout at C = 120, N = 197 (32 rows), term by term: the [32,
    # C + 8] q / output tile, the [32, 232] head mean, the key-mask and cls
    # rows, the warps' row statistics, 1 - bg_q and the row sums, then the
    # larger of 8 rings of 2 (K, V) stages of [16, 56] bf16 and the GEMM
    # staging
    if dtype == torch.bfloat16 and dh == 40:
        ring = max(4 * 16 * 56 * 2, 2 * 16 * 56 * 4)
        want = (32 * 128 * 2 + 32 * 232 * 4 + 2 * 208 * 4 + 8 * 32 * 2 * 4
                + 2 * 32 * 4 + max(8 * ring, 2 * (32 + 384) * 40 * 2))
        assert tka.block_smem_bytes("streamed", dtype, 197, 120, 40, True,
                                    32) == want
