"""The sequence-parallel attention at the head widths kernel 1 takes beside
64 (80: ViT-H/14; 16: the JAX quickstart's tiny ViT; 32 and 40: the JAX
kernel tests' fuzz widths), against the JAX package on the CPU.

The JAX side runs as tests/test_torch_seq.py runs it: the Pallas kernel in
interpret mode, and the 8-virtual-device CPU mesh for the sharded calls.  The
port runs the kernel's plain version (CPU tensors); the CUDA kernel's own
checks at these widths are in tests/test_torch_seq_width_cuda.py and
chip_smoke.py.  Also here: the widths the wrapper takes and refuses, and its
per-width limits on the padded token axis against the shared-memory
formulas of csrc/masked_attention_seq.cuh, written out again.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu.kernels import attention as jattn
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tattn
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
HEADS = 2
WIDTHS = (80, 40, 32, 16)


def _qkv_bg(n, dh, dtype, seed, b=2):
    """Seeded qkv [B, N, 3C] with hot query rows (logits past the clamp at
    80) and a background of 40 % (cls never background).  The values lie on
    a grid of 1/8, so that every dot product of Q K^T is exact in float32
    whatever the order of its sums: the hot rows' logits reach |S| ~ 128,
    where one float32 ulp of S (1.5e-5) moves P, and so out, by more than
    the float32 gate, and at widths 40 and 80 the two sides' orders of sums
    part by that much.  The two sides then differ in exp, the softmax sums
    and P V only."""
    rng = np.random.default_rng(seed)
    c = HEADS * dh
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
    qkv = np.round(qkv * 8.0) / 8.0
    bg = (rng.random((b, n)) < 0.4).astype(np.float32)
    bg[:, 0] = 0.0
    if dtype == torch.bfloat16:     # values both sides can hold exactly
        qkv = torch.from_numpy(qkv).to(dtype).float().numpy()
    return qkv, bg


def _shards(qkv, bg, sp):
    """Per rank (q, bg_q) of the zero-padded token axis, kv and bg_k."""
    b, n, c3 = qkv.shape
    c, nq = c3 // 3, -(-n // sp)
    pad = nq * sp - n
    qkv_p = np.pad(qkv, ((0, 0), (0, pad), (0, 0)))
    bg_p = np.pad(bg, ((0, 0), (0, pad)))
    return [(qkv_p[:, r * nq:(r + 1) * nq, :c], bg_p[:, r * nq:(r + 1) * nq])
            for r in range(sp)], qkv_p[:, :, c:], bg_p


def _tol(dtype):
    # tests/test_torch_seq.py's: float32 out 1e-5, row0 and hm 1e-6; bf16
    # 1e-2 on all
    return (1e-5, 1e-6) if dtype == torch.float32 else (1e-2, 1e-2)


# (width, N, ranks): every width at both lengths and group sizes; the clamp
# and the head mean alternate over the cases, so that each width meets all
# four combinations
SHARD_CASES = [(dh, n, sp) for dh in WIDTHS for n in (17, 37)
               for sp in (1, 2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,n,sp", SHARD_CASES,
                         ids=[f"w{dh}_N{n}_sp{sp}"
                              for dh, n, sp in SHARD_CASES])
def test_seq_local_ref_matches_jax_kernel_at_width(dh, n, sp, dtype):
    """masked_attention_seq_local_ref == JAX _masked_attention_seq_local in
    interpret mode on every rank's shard, 2 heads of width dh."""
    i = SHARD_CASES.index((dh, n, sp)) + (dtype == torch.bfloat16)
    hm, clamp = bool(i % 2), bool(i // 2 % 2)
    qkv, bg = _qkv_bg(n, dh, dtype, seed=100 * dh + 10 * n + sp)
    shards, kv, bg_k = _shards(qkv, bg, sp)
    tol_out, tol_p = _tol(dtype)
    kw = dict(num_heads=HEADS, scale=dh ** -0.5, with_headmean=hm,
              clamp_softmax=clamp, n_real=n)
    for q, bg_q in shards:
        want = jattn._masked_attention_seq_local(
            jnp.asarray(q, JDT[dtype]), jnp.asarray(kv, JDT[dtype]),
            jnp.asarray(bg_q), jnp.asarray(bg_k), interpret=True,
            hm_dtype=jnp.float32 if hm else None, **kw)
        got = tattn.masked_attention_seq_local(
            torch.from_numpy(q).to(dtype), torch.from_numpy(kv).to(dtype),
            torch.from_numpy(bg_q), torch.from_numpy(bg_k),
            hm_dtype=torch.float32 if hm else None, **kw)
        assert len(got) == len(want) == (3 if hm else 2)
        for g, w, tol in zip(got, want, (tol_out, tol_p, tol_p)):
            g = g.float().numpy()
            w = np.asarray(w.astype(jnp.float32))
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_stitched_shards_match_jax_seq_at_width_80(dtype):
    """The results of all 4 shards at width 80, stitched, == JAX
    masked_attention_seq under the (2, 4) mesh."""
    b, sp, n, dh = 4, 4, 17, 80
    qkv, bg = _qkv_bg(n, dh, dtype, seed=n, b=b)
    shards, kv, bg_k = _shards(qkv, bg, sp)
    kw = dict(num_heads=HEADS, scale=dh ** -0.5, with_headmean=True,
              clamp_softmax=True)
    got = [tattn.masked_attention_seq_local(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kv).to(dtype),
        torch.from_numpy(bg_q), torch.from_numpy(bg_k), n_real=n, **kw)
        for q, bg_q in shards]
    out = torch.cat([g[0] for g in got], dim=1)[:, :n].float().numpy()
    cls_row = got[0][1][:, :n].float().numpy()
    hm = torch.cat([g[2] for g in got], dim=1)[:, :n, :n].float().numpy()
    mesh = jmesh.make_mesh((2, 4), ("data", "seq"))
    with jax.set_mesh(mesh):
        want = jax.jit(functools.partial(
            jattn.masked_attention_seq, interpret=True, seq_axis="seq",
            data_axis="data", **kw))(
            jax.device_put(jnp.asarray(qkv, JDT[dtype]),
                           NamedSharding(mesh, P("data"))),
            jax.device_put(jnp.asarray(bg), NamedSharding(mesh, P("data"))))
        jax.block_until_ready(want)
    tol_out, tol_p = _tol(dtype)
    for g, w, tol in ((out, want[0], tol_out), (cls_row, want[1], tol_p),
                      (hm, want[2], tol_p)):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


# A depth-2 ViT with 2 heads of 80 at N = 17, the qkv kernels scaled so that
# the background mask engages
WIDE = dict(img_size=32, patch_size=8, embed_dim=160, depth=2, num_heads=2,
            num_classes=20, mask_from=1, top_k_patches=4)
WIDE_GAIN = 14.0


def _wide_pair(seed=1):
    """(JAX params, JAX cfg, port model) on the same float32 weights."""
    tcfg = tcfgs.ViTCAMConfig(**WIDE, per_sample_mask_norm=True)
    jcfg = jcfgs.ViTCAMConfig(**WIDE, per_sample_mask_norm=True)
    params = jvit.init(jcfg, jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * WIDE_GAIN
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, sd)
    return params, jcfg, model


@pytest.mark.parametrize("post", [False, True],
                         ids=["rollout_carry", "rollout_post"])
def test_seq_forward_kernel_at_width_80_matches_jax_pallas(post):
    """attn_impl="kernel" under seq_axis at head width 80 == JAX "pallas"
    (the seq kernel in interpret mode, shard_mapped over the token axis of
    the (2, 4) ('data', 'seq') mesh: N = 17 padded to 20) at float32, with
    the mask engaged:
    rollout row and cls rows within 1e-5, logits within 2e-4, the top-K
    patches as index sets where the K-th and (K+1)-th weights are apart."""
    params, jcfg, model = _wide_pair()
    assert model.cfg.head_dim == 80 and model.cfg.seq_len == 17
    x = np.random.default_rng(5).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    mesh = jmesh.make_mesh((2, 4), ("data", "seq"))
    with jax.set_mesh(mesh):
        want = jvit.apply(params, jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P("data"))), jcfg.replace(
            attn_impl="pallas", data_axis="data", seq_axis="seq",
            rollout_post=post), need_rollout=True)
        jax.block_until_ready(want.logits)
    model.cfg = tmesh.apply_seq_parallel(model.cfg.replace(
        attn_impl="kernel", rollout_post=post))
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(torch.from_numpy(x), need_rollout=True)
    for name, atol in (("rollout_row", 1e-5), ("attn_cls_rows", 1e-5),
                       ("logits", 2e-4)):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    k = jcfg.top_k_patches
    m14, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    assert 0 < float(bg.sum()) < bg.numel() - bg.shape[0]   # mask engaged
    srt = -np.sort(-m14.numpy(), axis=-1)
    clear = srt[:, k - 1] - srt[:, k] > 1e-4
    assert clear.any()
    sets = [[set(r) for r in np.asarray(t).tolist()]
            for t in (got.top_patch_idx, want.top_patch_idx)]
    assert [s for s, c in zip(sets[0], clear) if c] == \
        [s for s, c in zip(sets[1], clear) if c]


@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80])
def test_seq_kernel_takes_kernel1_widths(dh):
    assert tattn.SEQ_HEAD_DIMS == tattn.FWD_HEAD_DIMS == (16, 32, 40, 64, 80)
    assert tattn.check_head_width("seq", dh) == dh
    assert tattn.seq_width_launches.keys() == set(tattn.SEQ_HEAD_DIMS)


@pytest.mark.parametrize("dh", [24, 48])
def test_seq_kernel_refuses_other_widths(dh):
    with pytest.raises(ValueError, match=r"sequence-parallel attention "
                                         r"kernel is compiled for head widths "
                                         rf"16, 32, 40, 64, 80, got {dh}$"):
        tattn.check_head_width("seq", dh)


SMEM_LIMIT = 232448     # the opt-in shared memory a block of sm_90 may hold


def _fma_bytes(np_, dh, hm, qb):
    """smem_bytes of csrc/masked_attention_seq.cuh, written out."""
    ns = (np_ + 3) // 4 * 4
    floats = qb * dh + 64 * (dh + 4) + qb * ns + (qb * ns if hm else 0) \
        + ns + np_ + 2 * qb
    return 4 * floats


def _tc_bytes(np_, dh, hm):
    """tc_smem_bytes of csrc/masked_attention_seq.cuh, written out: the
    rings of attention_tc.cuh (tc_ring_bytes at one m16 tile), the float
    rows, the head mean and, past width 64, the Q tile."""
    width = (dh + 15) // 16 * 16
    if dh == 64:
        pitch = 64
    elif (width * 2 // 16) % 2:
        pitch = width
    else:
        pitch = width + 8
    ring = max(4 * 16 * pitch * 2, 16 * (width + 8) * 4)
    nk = (np_ + 15) // 16 * 16
    floats = 2 * nk + 8 * 16 * 2 + 2 * 16
    if hm:
        floats += 16 * ((np_ + 31) // 32 * 32 + 8)
    return 8 * ring + 4 * floats + (0 if dh == 64 else 16 * pitch * 2)


@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80])
def test_seq_smem_formula_and_limits(dh):
    """seq_smem_bytes == the C formulas at every width, and the per-width
    limit is the last Np both designs take with the head mean: at least
    N = 1025 over 8 ranks (1032), 1548 at 64."""
    for np_ in (17, 257, 258, 580, 1032, 1512, 1548, 1700):
        for hm in (False, True):
            qb = 32 if _fma_bytes(np_, dh, hm, 32) <= SMEM_LIMIT else 16
            assert tattn.seq_smem_bytes(np_, dh, hm, "fma") == \
                _fma_bytes(np_, dh, hm, qb)
            assert tattn.seq_smem_bytes(np_, dh, hm, "tensor-core") == \
                _tc_bytes(np_, dh, hm)
    limit = tattn.SEQ_MAX_NP[dh]
    assert limit >= 1032
    for np_, fits in ((limit, True), (limit + 1, False)):
        assert (max(_fma_bytes(np_, dh, True, 16), _tc_bytes(np_, dh, True))
                <= SMEM_LIMIT) == fits
    want = {16: 1660, 32: 1624, 40: 1604, 64: 1548, 80: 1512}
    assert limit == want[dh]
    # ViT-H/14 on one rank: two tensor-core blocks an SM (1 KB each kept by
    # the card) with the head mean
    if dh == 80:
        assert 2 * (_tc_bytes(257, 80, True) + 1024) <= 233472
