"""Kernel 1 at head width 80 (ViT-H/14's), and kernel 1 and the backward
at head widths 16, 32 and 40 (the JAX quickstart's tiny ViT and the JAX
kernel tests' fuzz widths), against the JAX TPU kernels.

The port's plain versions of ``masked_attention_fused`` and
``masked_attention_bwd`` (what the wrappers run on CPU tensors) are held
against vision_transformer_cam_tpu's kernels in Pallas interpret mode, on
packed qkv from the same seeded numpy inputs, at the tolerances of
``tests/test_torch_attention.py`` and ``tests/test_torch_zoo_training.py``:
at dh = 80, and at the fuzz set's shapes (tests/test_kernel_fuzz.py) and the
quickstart's N = 65 with 4 heads of 16.  The CUDA kernels are held against
the plain versions on the card (``tests/test_torch_tensor_core_cuda.py`` at
80, ``tests/test_torch_head_width_cuda.py`` at 16, 32 and 40, marked
``cuda``).  Which head widths each CUDA kernel takes, and that
``scripts.w80_variants`` still edits the current kernel source, are checked
here without CUDA.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_transformer_cam_tpu.kernels import attention as jka
from vision_transformer_cam_tpu_torch.kernels import _build
from vision_transformer_cam_tpu_torch.kernels import attention as tka
from vision_transformer_cam_tpu_torch.scripts import w80_variants, width_units

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
# (B, N, heads, head width): the JAX fuzz set's shapes at widths 32 and 40
# and the JAX quickstart's N = 65 with 4 heads of 16
WIDTH_SHAPES = [(2, 130, 4, 32), (2, 147, 3, 40), (2, 513, 2, 32),
                (2, 1025, 2, 32), (2, 65, 4, 16)]
NEW_WIDTHS = (16, 32, 40)


def _inputs(b, n, heads, seed, dh=DH):
    """Packed qkv [B, N, 3C] of heads of width ``dh``, random bg (cls column
    0), a row-stochastic joint; query rows 1-2 scaled past the clamp at
    80."""
    rng = np.random.default_rng(seed)
    c = heads * dh
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
    bg = (rng.random((b, n)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((b, n, n))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return qkv, bg, joint


def _int8_inputs(b, n, heads, seed, per_head, dh=DH):
    """int8 qkv with per-head or per-tensor (q, k, v) scales and the output
    scale; head 0's q scale makes some logits pass the clamp at 80."""
    rng = np.random.default_rng(seed)
    qkv = rng.integers(-127, 128, (b, n, 3 * heads * dh)).astype(np.int8)
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
    float_dtype float32, at the scale 1 / sqrt(head width)."""
    dh = qkv.shape[-1] // 3 // heads
    kw = dict(num_heads=heads, scale=dh ** -0.5, clamp_softmax=clamp,
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
    _check_int8_option(option, variant, clamp, DH)


def _check_int8_option(option, variant, clamp, dh):
    if option == "int8_out":
        qkv, bg, joint = _inputs(2, 37, 2, seed=41 + 3 * clamp, dh=dh)
        scales = np.array([20.0], np.float32)
    else:
        qkv, bg, joint, scales = _int8_inputs(
            2, 37, 2, seed=29 + clamp, per_head=option.endswith("head"),
            dh=dh)
    got, want = _both(qkv, bg, joint, scales, 2, variant, clamp)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    assert got[0].dtype == want[0].dtype == np.int8
    d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    assert np.abs(got[0]).max() > 30               # not all rounded to 0
    for name, g, w in zip(("cls", "third"), got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32, name
        _close(name, g, w)


@pytest.mark.parametrize("shape", WIDTH_SHAPES)
@pytest.mark.parametrize("variant", ["plain", "headmean", "rollout"])
def test_plain_version_matches_jax_kernel_at_head_widths_16_32_40(variant,
                                                                  shape):
    """Kernel 1's plain version against the JAX kernel at the new widths:
    the plain variant without the clamp (the training forward), the head
    mean and the rollout with it (the serving paths'), at the width-80
    test's tolerances."""
    b, n, heads, dh = shape
    clamp = variant != "plain"
    qkv, bg, joint = _inputs(b, n, heads, seed=n + dh, dh=dh)
    got, want = _both(qkv, bg, joint, None, heads, variant, clamp)
    assert len(got) == len(want) == (2 if variant == "plain" else 3)
    assert got[0].shape == (b, n, heads * dh)
    for name, g, w in zip(("out", "cls", "third"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _close(name, g, w)


@pytest.mark.parametrize("dh,option", [(16, "int8_io_per_head"),
                                       (32, "int8_io_per_tensor"),
                                       (40, "int8_out")])
def test_plain_version_int8_options_match_jax_kernel_at_new_widths(dh,
                                                                   option):
    """Each int8 option once at a new width (rollout, clamp on), as the
    width-80 test holds them; at 40 the int32 dot of 40 products is exact in
    both."""
    _check_int8_option(option, "rollout", True, dh)


@pytest.mark.parametrize("shape", WIDTH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_version_matches_jax_kernel_at_head_widths_16_32_40(dtype,
                                                                      shape):
    """The backward's plain version against the JAX backward kernel (it takes
    the head width as a parameter) in interpret mode, at the tolerances of
    tests/test_torch_zoo_training.py (float32 2e-4, bf16 2e-2)."""
    b, n, heads, dh = shape
    rng = np.random.default_rng(n + dh)
    c = heads * dh
    qkv = rng.standard_normal((b, n, 3 * c))
    bg = (rng.random((b, n)) < 0.3).astype(np.float64)
    bg[:, 0] = 0.0
    d_out = rng.standard_normal((b, n, c))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jka.masked_attention_bwd(
        jnp.asarray(qkv, jdt), jnp.asarray(bg, jnp.float32),
        jnp.asarray(d_out, jdt), num_heads=heads, scale=dh ** -0.5,
        interpret=True)
    before = tka.bwd_launches
    got = tka.masked_attention_bwd(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(bg).to(tdt),
        torch.from_numpy(d_out).to(tdt), num_heads=heads, scale=dh ** -0.5)
    assert tka.bwd_launches == before     # CPU tensors: the plain version
    assert got.shape == qkv.shape == want.shape and got.dtype == tdt
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=0,
                               atol={"float32": 2e-4, "bfloat16": 2e-2}[dtype])
    assert np.abs(np.asarray(want, np.float64)).max() > 0.1


@pytest.mark.parametrize("dh", [64, 80, 16, 32, 40])
def test_kernel1_takes_its_compiled_widths(dh):
    assert tka.FWD_HEAD_DIMS == (16, 32, 40, 64, 80)
    assert tka.check_head_width("fused", dh) == dh


@pytest.mark.parametrize("dh", [48, 24, 96])
def test_kernel1_refuses_other_widths_naming_its_set(dh):
    with pytest.raises(ValueError, match=r"head widths 16, 32, 40, 64, 80, "
                                         rf"got {dh}$"):
        tka.check_head_width("fused", dh)


@pytest.mark.parametrize("kernel", ["backward", "block", "seq", "v1",
                                    "variants"])
def test_other_kernels_refuse_head_width_80(kernel):
    assert tka.check_head_width(kernel, 64) == 64
    if kernel == "backward":
        # compiled for 64 and 80 (BWD_HEAD_DIMS) since ViT-H/14 trains on
        # the kernel path, and for 16, 32 and 40 as kernel 1; other widths
        # are still refused
        assert tka.BWD_HEAD_DIMS == (16, 32, 40, 64, 80)
        assert tka.check_head_width(kernel, 80) == 80
        with pytest.raises(ValueError, match=r"head widths 16, 32, 40, 64, "
                                             r"80, got 48$"):
            tka.check_head_width(kernel, 48)
        return
    if kernel in ("seq", "block", "v1"):
        # compiled for kernel 1's widths (SEQ_HEAD_DIMS, BLOCK_HEAD_DIMS,
        # V1_HEAD_DIMS): the seq kernel since ViT-H/14 serves under sequence
        # parallelism, the block kernel's streamed design and the
        # split-tensor kernel at every width the JAX kernels take; other
        # widths are still refused
        widths = {"seq": tka.SEQ_HEAD_DIMS, "block": tka.BLOCK_HEAD_DIMS,
                  "v1": tka.V1_HEAD_DIMS}[kernel]
        assert widths == (16, 32, 40, 64, 80)
        assert tka.check_head_width(kernel, 80) == 80
        with pytest.raises(ValueError, match=r"head widths 16, 32, 40, 64, "
                                             r"80, got 48$"):
            tka.check_head_width(kernel, 48)
        return
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


def test_width_units_merge_the_current_sources(tmp_path):
    """scripts.width_units' other layout holds, in one unit a kernel, the
    entry points of the three width units of the current sources, their
    header included once; the sources' own layout is untouched."""
    merged = width_units.layout(_build.CSRC, tmp_path / "m", merged=True)
    for stem, header in width_units.HEADERS.items():
        text = (merged / f"{stem}_w16_32_40.cu").read_text()
        assert text.count(f'#include "{header}"') == 1
        for w in width_units.WIDTHS:
            assert not (merged / f"{stem}_w{w}.cu").exists()
            assert f"_w{w}(" in text and f"<{w}>(" in text
    plain = width_units.layout(_build.CSRC, tmp_path / "p", merged=False)
    assert sorted(p.name for p in plain.glob("*.cu")) == \
        sorted(p.name for p in _build.CSRC.glob("*.cu"))
    with pytest.raises(SystemExit, match="unknown flag --fast"):
        width_units.main(["--fast"])
