"""The port's sequence-parallel attention and forward against the JAX
package's, on the CPU.

The JAX side runs as its own tests run it (tests/test_gspmd.py): the Pallas
kernel in interpret mode and the 8-virtual-device CPU mesh (2 data x 4 seq).
The port runs the kernel's plain version (CPU tensors).  Most cases run the
port at one rank in-process, or shard by shard by hand; a few spawn 2 and 4
gloo ranks through ``parallel.worker.run_forward``, which has a time limit
of its own.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vision_transformer_cam_tpu import configs as jcfgs
from vision_transformer_cam_tpu import serving as jserving
from vision_transformer_cam_tpu.kernels import attention as jattn
from vision_transformer_cam_tpu.models import vit as jvit
from vision_transformer_cam_tpu.parallel import mesh as jmesh
from vision_transformer_cam_tpu_torch import configs as tcfgs
from vision_transformer_cam_tpu_torch import serving as tserving
from vision_transformer_cam_tpu_torch.io.weights import (
    load_state_dict, state_dict_from_jax_params)
from vision_transformer_cam_tpu_torch.kernels import attention as tattn
from vision_transformer_cam_tpu_torch.models import vit as tvit
from vision_transformer_cam_tpu_torch.parallel import mesh as tmesh
from vision_transformer_cam_tpu_torch.parallel.worker import run_forward

# the TINY size of tests/test_gspmd.py: N = 17
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4,
            num_classes=20, mask_from=1, top_k_patches=4)
QKV_GAIN = 20.0
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}
H, DH = 4, 8
SCALE = DH ** -0.5


def _sp_mesh(shape=(2, 4)):
    return jmesh.make_mesh(shape, ("data", "seq"))


def _qkv_bg(n, dtype, seed, b=2):
    """Seeded qkv [B, N, 3C] with hot query rows (logits past the clamp at
    80) and a non-trivial background (cls never background)."""
    rng = np.random.default_rng(seed)
    c = H * DH
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
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
    kv = qkv_p[:, :, c:]
    return [(qkv_p[:, r * nq:(r + 1) * nq, :c], bg_p[:, r * nq:(r + 1) * nq])
            for r in range(sp)], kv, bg_p


def _tol(dtype):
    # float32: out 1e-5, row0 and hm 1e-6; bf16: 1e-2 on all
    return (1e-5, 1e-6) if dtype == torch.float32 else (1e-2, 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
@pytest.mark.parametrize("hm", [False, True], ids=["plain", "headmean"])
@pytest.mark.parametrize("n", [17, 18])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_seq_local_ref_matches_jax_kernel(sp, n, hm, clamp, dtype):
    """masked_attention_seq_local_ref == JAX _masked_attention_seq_local in
    interpret mode on every rank's shard (N = 17 and 18 pad to 20 at 4)."""
    qkv, bg = _qkv_bg(n, dtype, seed=10 * n + sp)
    shards, kv, bg_k = _shards(qkv, bg, sp)
    tol_out, tol_p = _tol(dtype)
    kw = dict(num_heads=H, scale=SCALE, with_headmean=hm,
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
@pytest.mark.parametrize("n", [17, 18])
def test_stitched_shards_match_jax_seq_and_fused_ref(n, dtype):
    """The results of all 4 shards, stitched, == JAX masked_attention_seq
    under the (2, 4) mesh and == the port's masked_attention_fused_ref."""
    b, sp = 4, 4
    qkv, bg = _qkv_bg(n, dtype, seed=n, b=b)
    shards, kv, bg_k = _shards(qkv, bg, sp)
    kw = dict(num_heads=H, scale=SCALE, with_headmean=True,
              clamp_softmax=True)
    got = [tattn.masked_attention_seq_local(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kv).to(dtype),
        torch.from_numpy(bg_q), torch.from_numpy(bg_k), n_real=n, **kw)
        for q, bg_q in shards]
    out = torch.cat([g[0] for g in got], dim=1)[:, :n].float().numpy()
    cls_row = got[0][1][:, :n].float().numpy()
    hm = torch.cat([g[2] for g in got], dim=1)[:, :n, :n].float().numpy()

    mesh = _sp_mesh()
    with jax.set_mesh(mesh):
        want = jax.jit(functools.partial(
            jattn.masked_attention_seq, interpret=True, seq_axis="seq",
            data_axis="data", **kw))(
            jax.device_put(jnp.asarray(qkv, JDT[dtype]),
                           NamedSharding(mesh, P("data"))),
            jax.device_put(jnp.asarray(bg), NamedSharding(mesh, P("data"))))
        jax.block_until_ready(want)
    ref = tattn.masked_attention_fused_ref(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(bg), **kw)
    tol_out, tol_p = _tol(dtype)
    for g, w, r, tol in zip((out, cls_row, hm), want, ref,
                            (tol_out, tol_p, tol_p)):
        np.testing.assert_allclose(g, np.asarray(w.astype(jnp.float32)),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(g, r.float().numpy(), rtol=0, atol=tol)


def test_masked_attention_seq_one_rank_cuts_padding():
    """group=None is a group of one rank: no collective, outputs at N."""
    qkv, bg = _qkv_bg(17, torch.float32, seed=3)
    out, cls_row, hm = tattn.masked_attention_seq(
        torch.from_numpy(qkv), torch.from_numpy(bg), group=None, n_real=17,
        num_heads=H, scale=SCALE, with_headmean=True)
    ref = tattn.masked_attention_fused_ref(
        torch.from_numpy(qkv), torch.from_numpy(bg), num_heads=H, scale=SCALE,
        with_headmean=True)
    assert cls_row.shape == (2, 17) and hm.shape == (2, 17, 17)
    for g, r in zip((out, cls_row, hm), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6)


def test_seq_wrapper_checks_its_arguments():
    q = torch.zeros(1, 5, 32)
    kv = torch.zeros(1, 8, 64)
    ok = dict(num_heads=H, scale=SCALE)
    with pytest.raises(ValueError, match="kv"):
        tattn.masked_attention_seq_local(q, kv[:, :4], torch.zeros(1, 5),
                                         torch.zeros(1, 4), **ok)
    with pytest.raises(ValueError, match="bg_q"):
        tattn.masked_attention_seq_local(q, kv, torch.zeros(1, 8),
                                         torch.zeros(1, 8), **ok)
    with pytest.raises(ValueError, match="n_real"):
        tattn.masked_attention_seq_local(q, kv, torch.zeros(1, 5),
                                         torch.zeros(1, 8), n_real=9, **ok)
    assert min(tattn.SEQ_MAX_NP.values()) >= 1032


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

# The JAX package's kernel path under seq_axis goes wrong inside the model
# (not in masked_attention_seq alone) once the background mask engages AND
# the token count does not divide the sequence group: on the CPU mesh its
# layers after the first masked one leave its own unsharded forward by 0.1
# to 0.5 (ROADMAP "Discrepancies already in the reference").  Its XLA path
# under the same mesh is right, and so is its kernel path where N divides.
# So the kernel path is held to JAX under the mesh in two cases that the
# discrepancy does not reach: N = 17 with plain initial weights (the JAX
# package's own test), and N = 10 over 2 token shards with the qkv gain that
# makes the mask engage; at N = 17 with the gain it is held to the JAX
# package's unsharded kernel path.
N10 = dict(TINY, img_size=24)


def _pair(dtype, seed=0, gain=QKV_GAIN, size=TINY, **kw):
    """(JAX params, JAX cfg, port model, state dict) on the same weights."""
    tcfg = tcfgs.ViTCAMConfig(**size, dtype=dtype, param_dtype=dtype, **kw)
    jcfg = jcfgs.ViTCAMConfig(**size, dtype=JDT[dtype],
                              param_dtype=JDT[dtype], **kw)
    params = jvit.init(jcfg, jax.random.key(seed))
    qkv = params["blocks"]["attn"]["qkv"]
    qkv["kernel"] = qkv["kernel"] * gain
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    model = tvit.ViTCAM(tcfg, device="cpu")
    load_state_dict(model, sd)
    return params, jcfg, model, sd


def _images(b=4, seed=5, dtype=np.float64, size=32):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(dtype)


def _jax_sp(params, x, jcfg_sp, shape=(2, 4), **fwd):
    mesh = _sp_mesh(shape)
    x_s = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    with jax.set_mesh(mesh):
        out = jvit.apply(params, x_s, jcfg_sp, **fwd)
        jax.block_until_ready(out.logits)
    return out


def _top_sets(idx):
    return [set(r) for r in np.asarray(idx).tolist()]


def _assert_out(got, want, atol, names=("logits", "rollout_row",
                                        "attn_cls_rows", "tokens_prenorm",
                                        "head1_logits")):
    for name in names:
        g = getattr(got, name) if not isinstance(got, dict) else got[name]
        w = getattr(want, name)
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w.astype(jnp.float32)) if w.dtype == jnp.bfloat16 \
            else np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("post", [False, True],
                         ids=["rollout_carry", "rollout_post"])
def test_seq_forward_eager_matches_jax_xla_f64(post):
    """attn_impl="eager" under seq_axis == JAX "xla" under cfg_sp on the
    (2, 4) mesh, at float64."""
    params, jcfg, model, _ = _pair(torch.float64, per_sample_mask_norm=True)
    x = _images()
    want = _jax_sp(params, x, jcfg.replace(data_axis="data", seq_axis="seq",
                                           rollout_post=post),
                   need_rollout=True)
    model.cfg = tmesh.apply_seq_parallel(model.cfg.replace(rollout_post=post))
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(torch.from_numpy(x), need_rollout=True)
    _assert_out(got, want, 1e-10)
    assert _top_sets(got.top_patch_idx) == _top_sets(want.top_patch_idx)


KERNEL_CASES = {"N17_sp4_plain_init": (TINY, 1.0, (2, 4)),
                "N10_sp2_masked": (N10, QKV_GAIN, (4, 2))}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
@pytest.mark.parametrize("post", [False, True],
                         ids=["rollout_carry", "rollout_post"])
def test_seq_forward_kernel_matches_jax_pallas_f32(post, case):
    """attn_impl="kernel" under seq_axis == JAX "pallas" (the seq kernel in
    interpret mode, shard_mapped over the token shards), at float32."""
    size, gain, shape = KERNEL_CASES[case]
    params, jcfg, model, _ = _pair(torch.float32, seed=1, gain=gain,
                                   size=size, per_sample_mask_norm=True)
    x = _images(dtype=np.float32, size=size["img_size"])
    want = _jax_sp(params, x, jcfg.replace(
        attn_impl="pallas", data_axis="data", seq_axis="seq",
        rollout_post=post), shape=shape, need_rollout=True)
    model.cfg = tmesh.apply_seq_parallel(model.cfg.replace(
        attn_impl="kernel", rollout_post=post))
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(torch.from_numpy(x), need_rollout=True)
    _assert_out(got, want, 1e-5, names=("logits", "rollout_row",
                                        "attn_cls_rows"))
    # the top-K set is defined only where the K-th and (K+1)-th weights are
    # apart (fully masked patches tie at float32 underflow)
    k = jcfg.top_k_patches
    m14, _ = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
    srt = -np.sort(-m14.numpy(), axis=-1)
    clear = srt[:, k - 1] - srt[:, k] > 1e-4
    assert clear.any() or gain != 1.0     # 9 patches, most masked, all tie
    assert [s for s, c in zip(_top_sets(got.top_patch_idx), clear) if c] == \
        [s for s, c in zip(_top_sets(want.top_patch_idx), clear) if c]
    if gain != 1.0:     # the mask really engaged
        _, bg = tvit._mask_from_cls_row(got.attn_cls_rows[-1], model.cfg)
        assert 0 < float(bg.sum()) < bg.numel() - bg.shape[0]


def test_seq_forward_kernel_masked_n17_matches_jax_unsharded_pallas():
    """N = 17 with the mask engaged: the port under seq_axis == the JAX
    package's unsharded kernel path, which its own path under the mesh
    leaves here (see the note above KERNEL_CASES)."""
    params, jcfg, model, _ = _pair(torch.float32, seed=1,
                                   per_sample_mask_norm=True)
    x = _images(dtype=np.float32)
    want = jvit.apply(params, jnp.asarray(x),
                      jcfg.replace(attn_impl="pallas"), need_rollout=True)
    model.cfg = tmesh.apply_seq_parallel(model.cfg.replace(
        attn_impl="kernel"))
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(torch.from_numpy(x), need_rollout=True)
    _assert_out(got, want, 1e-5, names=("logits", "rollout_row",
                                        "attn_cls_rows"))
    sp = _jax_sp(params, x, jcfg.replace(attn_impl="pallas", data_axis="data",
                                         seq_axis="seq"), need_rollout=True)
    # the discrepancy this test steps around is still there
    assert float(jnp.abs(sp.attn_cls_rows - want.attn_cls_rows).max()) > 1e-2


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_hifi"])
def test_seq_forward_serving_modes_match_jax(mode):
    """Serving modes composed with apply_seq_parallel, as the validate CLIs
    compose them: bf16 and int8 GEMMs (plain qlinear), float attention core.
    JAX runs attn_impl="pallas" (the serving kernel path) under the (4, 2)
    mesh at N = 10 (see the note above KERNEL_CASES)."""
    # a gentler gain than the float cases': bf16 rounds logits of the full
    # gain's size by more than the tolerance
    params, jcfg, model, _ = _pair(torch.float32, seed=2, size=N10, gain=6.0)
    x = _images(dtype=np.float32, size=24)
    jp, jc = jserving.apply_serving_mode(params, jcfg, mode,
                                         calib_images=jnp.asarray(x))
    jc = jmesh.apply_seq_parallel(jc.replace(attn_impl="pallas"))
    want = _jax_sp(jp, x, jc, shape=(4, 2), need_rollout=True)
    sd = state_dict_from_jax_params(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), jp), model.cfg)
    model.to(torch.bfloat16)
    load_state_dict(model, sd)
    model.cfg = tmesh.apply_seq_parallel(
        tserving.serving_config(model.cfg, mode))
    assert model.cfg.attn_impl == "kernel" and not model.cfg.int8_attn_io
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(torch.from_numpy(x), need_rollout=True)
    assert got.logits.dtype == torch.bfloat16
    _assert_out(got, want, 1e-2, names=("logits", "rollout_row",
                                        "attn_cls_rows"))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("fwd", [dict(need_rollout=True),
                                 dict(need_headmean=True, need_blocks=True,
                                      need_rollout=True),
                                 dict(need_perhead=True)],
                         ids=["rollout", "headmean_blocks", "perhead"])
def test_seq_forward_one_rank_equals_unsharded(impl, fwd):
    """Under a one-rank mesh the sequence-parallel forward is the unsharded
    forward, output for output."""
    _, _, model, _ = _pair(torch.float64 if impl == "eager"
                           else torch.float32, seed=3, attn_impl=impl)
    x = torch.from_numpy(_images(b=2)).to(model.cfg.dtype)
    want = model(x, **fwd)
    base = model.cfg
    model.cfg = tmesh.apply_seq_parallel(base)
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        got = model(x, **fwd)
    model.cfg = base
    for name in tvit.ViTCAMOutput._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None and name != "top_patch_idx":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


# (ranks, sequence-group size, attention path, rollout_post, serving mode):
# real gloo process groups, each run with a time limit of its own
SPAWN = [(2, 2, "kernel", False, "off"), (4, 4, "kernel", True, "off"),
         (4, 4, "eager", False, "off"), (4, 2, "kernel", False, "off"),
         (2, 2, "kernel", True, "int8")]


@pytest.mark.parametrize("world,n_seq,impl,post,mode", SPAWN,
                         ids=[f"{w}ranks_sp{s}_{i}_{'post' if p else 'carry'}"
                              f"_{m}" for w, s, i, p, m in SPAWN])
def test_seq_forward_in_processes_matches_jax_and_unsharded(world, n_seq, impl,
                                                            post, mode):
    """2 and 4 gloo ranks (N = 17 pads to 18 and 20): every rank returns the
    complete outputs, equal to the port's own unsharded forward and to JAX:
    the eager path to JAX "xla" under cfg_sp on the (2, 4) mesh, the kernel
    path to the JAX package's unsharded "pallas" forward."""
    f64 = impl == "eager"
    dtype = torch.float64 if f64 else torch.float32
    params, jcfg, model, sd = _pair(dtype, seed=4, per_sample_mask_norm=True,
                                    gain=QKV_GAIN if mode == "off" else 6.0)
    x = _images(b=2, dtype=np.float64 if f64 else np.float32)
    over = dict(attn_impl=impl, rollout_post=post)
    outs = run_forward(model.cfg, sd, torch.from_numpy(x), world=world,
                       n_seq=n_seq, device="cpu", serving_mode=mode,
                       overrides=over,
                       fwd_kw=dict(need_rollout=True), timeout=150)
    assert len(outs) == world
    names = ("logits", "rollout_row", "attn_cls_rows", "tokens_prenorm")
    for o in outs[1:]:      # complete and alike on every rank
        for name in names:
            np.testing.assert_allclose(o[name].float().numpy(),
                                       outs[0][name].float().numpy(),
                                       rtol=0, atol=1e-6 if not f64 else 1e-12)
    tserving.apply_serving_mode(model, mode,
                                calib_images=torch.from_numpy(x))
    model.cfg = model.cfg.replace(**over)
    own = model(torch.from_numpy(x), need_rollout=True)
    tol = 1e-10 if f64 else (1e-5 if mode == "off" else 1e-2)
    for name in names[:3]:
        np.testing.assert_allclose(outs[0][name].float().numpy(),
                                   getattr(own, name).float().numpy(),
                                   rtol=0, atol=tol, err_msg=name)
    if mode != "off":
        return
    if impl == "eager":
        x4 = np.concatenate([x, x])      # the (2, 4) mesh wants batch % 2
        want = _jax_sp(params, x4, jcfg.replace(
            data_axis="data", seq_axis="seq", rollout_post=post),
            need_rollout=True)
    else:       # masked, N = 17: see the note above KERNEL_CASES
        want = jvit.apply(params, jnp.asarray(x), jcfg.replace(
            attn_impl="pallas", rollout_post=post), need_rollout=True)
    for name in names[:3]:
        w = np.asarray(getattr(want, name))
        w = w[:, :2] if name == "attn_cls_rows" else w[:2]
        np.testing.assert_allclose(outs[0][name].numpy(), w, rtol=0,
                                   atol=tol, err_msg=name)


def test_run_forward_enforces_its_time_limit():
    _, _, model, sd = _pair(torch.float32)
    with pytest.raises(TimeoutError):
        run_forward(model.cfg, sd, torch.zeros(1, 32, 32, 3), world=2,
                    n_seq=2, device="cpu", timeout=0.0)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

FUSION_KNOBS = ("attn_block_fusion", "mlp_fusion", "ln_quant_fusion",
                "int8_fused_gemm", "int8_attn_io", "int8_attn_out")


@pytest.mark.parametrize("knob", FUSION_KNOBS)
def test_fusion_knobs_raise_under_seq_axis(knob):
    cfg = tcfgs.ViTCAMConfig(**TINY, seq_axis="seq", data_axis="data",
                             attn_impl="kernel", **{knob: True})
    with pytest.raises(ValueError, match="seq_axis"):
        tvit.ViTCAM(cfg, device="cpu")
    jc = jcfgs.ViTCAMConfig(**TINY, seq_axis="seq", attn_impl="pallas",
                            **{knob: True})
    with pytest.raises(ValueError, match="seq_axis"):
        jvit.forward(jvit.init(jc.replace(seq_axis=None), jax.random.key(0)),
                     jnp.zeros((1, 32, 32, 3)), jc)


def test_data_axis_alone_and_training_still_raise():
    """cfg.data_axis alone (data parallelism) needs an ambient mesh, as
    seq_axis does; sequence-parallel training runs on the eager path, and
    the kernel path refuses it (the seq kernel has no backward)."""
    alone = tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY, data_axis="data"),
                        device="cpu")
    with pytest.raises(ValueError, match="data_axis"):
        alone(torch.zeros(1, 32, 32, 3))
    model = tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY, data_axis="data",
                                           seq_axis="seq"), device="cpu")
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="mesh"):   # no ambient mesh
        model(x)
    with tmesh.set_mesh(tmesh.seq_parallel_mesh(1)):
        out = model.forward_train(x)
        out.logits.sum().backward()
        assert model.pos_embed.grad is not None
        model.cfg = model.cfg.replace(attn_impl="kernel")
        with pytest.raises(ValueError, match="training"):
            model.forward_train(x)


def test_dynamic_int8_scales_raise_on_a_sharded_token_axis():
    from vision_transformer_cam_tpu_torch.ops.quant import quantize_params
    model = tvit.ViTCAM(tcfgs.ViTCAMConfig(**TINY, data_axis="data",
                                           seq_axis="seq"), device="cpu")
    quantize_params(model)                     # no act scales: dynamic
    x = torch.zeros(1, 32, 32, 3)
    with tmesh.set_mesh(tmesh.SeqMesh(inner_size=1)):
        assert torch.isfinite(model(x).logits).all()
    with tmesh.set_mesh(tmesh.SeqMesh(inner_size=2)):
        with pytest.raises(NotImplementedError, match="static act scales"):
            model(x)


@pytest.mark.parametrize("mode", ["off", "bf16", "int8", "int8_hifi"])
def test_apply_seq_parallel_equals_jax(mode, capsys):
    """Field for field the JAX apply_seq_parallel, on each serving config
    with every fusion knob switched on first."""
    jc = jserving.serving_config(jcfgs.ViTCAMConfig(**TINY), mode).replace(
        attn_impl="pallas", mlp_fusion=True, attn_block_fusion=True,
        ln_quant_fusion=True, int8_fused_gemm=True)
    tc = tserving.serving_config(tcfgs.ViTCAMConfig(**TINY), mode).replace(
        attn_impl="kernel", mlp_fusion=True, attn_block_fusion=True,
        ln_quant_fusion=True, int8_fused_gemm=True)
    js = jmesh.apply_seq_parallel(jc)
    j_note = capsys.readouterr().out
    ts = tmesh.apply_seq_parallel(tc)
    t_note = capsys.readouterr().out
    assert j_note.split("fusions:")[1] == t_note.split("fusions:")[1]
    for f in dataclasses.fields(jcfgs.ViTCAMConfig):
        j, t = getattr(js, f.name), getattr(ts, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert JDT[t] == j
        elif f.name == "attn_impl":
            assert (j, t) == ("pallas", "kernel")     # the kernel path is kept
        else:
            assert j == t, f.name
    assert (ts.seq_axis, ts.data_axis) == ("seq", "data")


def test_seq_parallel_mesh_shapes():
    mesh = tmesh.seq_parallel_mesh(1)
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.inner_group is None
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.seq_parallel_mesh(2)        # a world of one rank
    t = torch.arange(10.0).reshape(2, 5)
    four = tmesh.SeqMesh(inner_size=4, inner_rank=3)
    np.testing.assert_array_equal(four.local_rows(t).numpy(),
                                  [[0.0, 0.0], [0.0, 0.0]])
    np.testing.assert_array_equal(
        tmesh.SeqMesh(inner_size=4, inner_rank=2).local_rows(t).numpy(),
        [[4.0, 0.0], [9.0, 0.0]])


def test_profile_serving_knows_the_seq_kernel_and_serves_through_it():
    from vision_transformer_cam_tpu_torch import profile_serving as tprof
    name = ("void (anonymous namespace)::masked_attention_seq_kernel<"
            "__nv_bfloat16, 32, true, true>(...)")
    assert tprof.group_of(name) == "sequence-parallel attention kernel"
    assert tprof.group_of("void (anonymous namespace)::masked_attention_"
                          "kernel<float, 1, true>") == "attention kernel"
    _, _, model, _ = _pair(torch.float32)
    x = torch.from_numpy(_images(b=2, dtype=np.float32))
    base = model.cfg
    tprof.forward_fn(model, "bf16", x, seq_parallel=1)()
    assert model.cfg.seq_axis == "seq" and model.cfg.attn_impl == "kernel"
    model.cfg = base
