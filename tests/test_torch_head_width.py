"""Kernel 1 at head width 80 (ViT-H/14's) against the JAX TPU kernel.

The port's plain version of ``masked_attention_fused`` (what the wrapper
runs on CPU tensors) is held against vision_transformer_cam_tpu's kernel in
Pallas interpret mode at dh = 80, on packed qkv from the same seeded numpy
inputs, at the tolerances of ``tests/test_torch_attention.py``.  The CUDA
kernel at dh = 80 is held against the plain version on the card
(``tests/test_torch_tensor_core_cuda.py``, marked ``cuda``).  Which head
widths each CUDA kernel takes, and that ``scripts.w80_variants`` still
edits the current kernel source, are checked here without CUDA.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_transformer_cam_tpu.kernels import attention as jka
from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.scripts import w80_variants

# float32 on both sides: the JAX kernel tests' own f32 tolerances, as in
# tests/test_torch_attention.py, on every query row but the two hot ones.
# Those (rows 1-2, logits of order 1e2) carry the float32 rounding of S into
# exp, and S sums 80 products here against 16 there: the hot rows' out read
# 2.7e-5 and their head mean 2.8e-6 at N = 37, every other row within 7e-7.
# The hot rows are held to the float32 tolerances chip_smoke.py gives the
# kernel against its plain version for that reason (atol, rtol).
TOL = {"out": 1e-5, "cls": 1e-6, "third": 1e-6}
HOT_TOL = {"out": (5e-5, 1e-4), "third": (1e-6, 1e-4)}
DH = 80
SCALE = DH ** -0.5
SHAPES = [(2, 37, 2), (1, 257, 2)]   # (B, N, heads)


def _inputs(b, n, heads, seed):
    """Packed qkv [B, N, 3C] of heads of width 80, random bg (cls column 0),
    a row-stochastic joint; query rows 1-2 scaled past the clamp at 80."""
    rng = np.random.default_rng(seed)
    c = heads * DH
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return qkv, bg, joint


def _int8_inputs(b, n, heads, seed, per_head):
    """int8 qkv with per-head or per-tensor (q, k, v) scales and the output
    scale; head 0's q scale makes some logits pass the clamp at 80."""
    rng = np.random.default_rng(seed)
    qkv = rng.integers(-127, 128, (b, n, 3 * heads * DH)).astype(np.int8)
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    if per_head:
        sc = rng.uniform(0.01, 0.03, 3 * heads).astype(np.float32)
        sc[0] = 0.5
    else:
        sc = np.array([0.011, 0.017, 0.023], np.float32)
    return qkv, bg, joint, np.concatenate([sc, [20.0]]).astype(np.float32)


def _close(name, got, want):
    """got against want at TOL[name]; rows 1-2 (the hot query rows) of out,
    the head mean and J' at HOT_TOL[name]."""
    if name == "cls":
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[name],
                                   err_msg=name)
        return
    cold = np.ones(got.shape[1], bool)
    cold[1:3] = False
    np.testing.assert_allclose(got[:, cold], want[:, cold], rtol=0,
                               atol=TOL[name], err_msg=name)
    atol, rtol = HOT_TOL[name]
    np.testing.assert_allclose(got[:, ~cold], want[:, ~cold], rtol=rtol,
                               atol=atol, err_msg=name + " hot rows")


def _both(qkv, bg, joint, scales, heads, variant, clamp):
    """(port plain version, JAX kernel in interpret mode) outputs as numpy,
    float_dtype float32."""
    kw = dict(num_heads=heads, scale=SCALE, clamp_softmax=clamp,
              with_headmean=variant == "headmean")
    j = joint if variant == "rollout" else None
    extra = {} if scales is None else dict(float_dtype=jnp.float32)
    want = jka.masked_attention_fused(
        jnp.asarray(qkv), jnp.asarray(bg), None if j is None else
        jnp.asarray(j), None if scales is None else jnp.asarray(scales),
        interpret=True, **extra, **kw)
    got = tka.masked_attention_fused(
        torch.from_numpy(qkv), torch.from_numpy(bg),
        None if j is None else torch.from_numpy(j),
        None if scales is None else torch.from_numpy(scales),
        float_dtype=torch.float32, **kw)
    return [r.numpy() for r in got], [np.asarray(r) for r in want]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
def test_plain_version_matches_jax_kernel_at_head_width_80(variant, clamp,
                                                           shape):
    b, n, heads = shape
    qkv, bg, joint = _inputs(b, n, heads, seed=n + 3 * clamp)
    if clamp:
        # the inputs really exercise the clamp: some logits exceed 80
        c = heads * DH
        s = np.einsum("bqd,bkd->bqk", qkv[:, 1:3, :DH],
                      qkv[:, :, c:c + DH]) * SCALE
        assert s.max() > 80.0
    before = tka.launches
    got, want = _both(qkv, bg, joint, None, heads, variant, clamp)
    assert tka.launches == before     # CPU tensors: the plain version ran
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    assert got[0].shape == (b, n, heads * DH)
    for name, g, w in zip(("out", "cls", "third"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _close(name, g, w)
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
@pytest.mark.parametrize("option", ["int8_io_per_head", "int8_io_per_tensor",
                                    "int8_out"])
def test_plain_version_int8_options_match_jax_kernel_at_head_width_80(
        option, variant, clamp):
    """int8_io (per-head [3H+1] and per-tensor [4] scales) and int8_out at
    dh = 80, B=2 N=37, 2 heads: the int8 output within one step on at most
    1 % of the elements, cls row, head mean and J' at 1e-6 (the tolerances
    of tests/test_torch_attention.py; the hot rows as ``_close`` says).
    The int32 dot of 80 int8 products stays exact in both."""
    if option == "int8_out":
        qkv, bg, joint = _inputs(2, 37, 2, seed=41 + 3 * clamp)
        scales = np.array([20.0], np.float32)
    else:
        qkv, bg, joint, scales = _int8_inputs(
            2, 37, 2, seed=29 + clamp, per_head=option.endswith("head"))
    got, want = _both(qkv, bg, joint, scales, 2, variant, clamp)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    assert got[0].dtype == want[0].dtype == np.int8
    d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    assert np.abs(got[0]).max() > 30               # not all rounded to 0
    for name, g, w in zip(("cls", "third"), got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32, name
        _close(name, g, w)


@pytest.mark.parametrize("dh", [64, 80])
def test_kernel1_takes_its_compiled_widths(dh):
    assert tka.FWD_HEAD_DIMS == (64, 80)
    assert tka.check_head_width("fused", dh) == dh


@pytest.mark.parametrize("dh", [48, 16, 96])
def test_kernel1_refuses_other_widths_naming_its_set(dh):
    with pytest.raises(ValueError, match=r"head widths 64, 80, got "
                                         rf"{dh}$"):
        tka.check_head_width("fused", dh)


@pytest.mark.parametrize("kernel", ["backward", "block", "seq", "v1",
                                    "variants"])
def test_other_kernels_refuse_head_width_80(kernel):
    assert tka.check_head_width(kernel, 64) == 64
    with pytest.raises(ValueError, match=r"head width 64, got 80$"):
        tka.check_head_width(kernel, 80)


@pytest.mark.parametrize("variant", sorted(w80_variants.EDITS))
def test_w80_variants_edit_the_current_kernel_source(variant):
    """scripts.w80_variants builds each launch bound of kernel 1's width-80
    instances from the current masked_attention.cuh: an edit's text occurs
    there once (the script refuses a source it no longer matches)."""
    src = (_build.CSRC / w80_variants.SOURCE).read_text()
    got = w80_variants.edit_source(src, variant)
    edit = w80_variants.EDITS[variant]
    assert (got == src) == (edit is None)
    if edit is not None:
        assert src.count(edit[0]) == 1 and got.count(edit[1]) == 1
        with pytest.raises(ValueError, match="update EDITS"):
            w80_variants.edit_source(src.replace(edit[0], ""), variant)


def test_w80_variants_runs_on_the_card_only():
    with pytest.raises(SystemExit, match="unknown flag --bacth"):
        w80_variants.main(["--bacth", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            w80_variants.main(["--batch", "2"])
