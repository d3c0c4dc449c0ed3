"""The port's split-tensor masked attention (``masked_attention``, the v1
kernel) against the JAX TPU kernel.

The port's plain PyTorch version (what the wrapper runs on CPU tensors) is
held against vision_transformer_cam_tpu's ``masked_attention`` run in Pallas
interpret mode, on q, k, v from the same seeded numpy inputs, and against the
port's fused kernel's plain version without the clamp (the pair mask and the
rank-1 mask agree after the softmax).  The CUDA kernel itself is held against
the plain version on the card (marked ``cuda``), which runs on a GPU machine
without jax as

    python -m pytest --noconftest -m cuda tests/test_torch_attention_v1.py
"""

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax.numpy as jnp

    from vision_transformer_cam_tpu.kernels import attention as jka
except ImportError:
    jnp = jka = None

# float32 on both sides: the two sum S, the softmax row and P.V in different
# orders; the JAX kernel tests' own tolerances (tests/test_kernels.py).  bf16:
# both round P and the outputs to bf16, at other places of the sums.
TOL = {np.float32: {"out": 1e-5, "cls": 1e-6, "hm": 1e-6},
       "bf16": {"out": 1e-2, "cls": 1e-3, "hm": 1e-3}}
DH, SCALE = 16, 0.25


def _inputs(b, h, n, seed, bg_kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, DH)).astype(np.float32)
               for _ in range(3))
    q[:, :, 1:3] *= 8.0                      # a few hot rows
    share = {"none": 0.0, "30%": 0.3, "all": 1.1}[bg_kind]
    bg = (rng.random((b, n)) < share).astype(np.float32)
    return q, k, v, bg


def _jax(q, k, v, bg, hm, dtype=None):
    if jka is None:
        pytest.skip("needs jax (the JAX reference)")
    dt = dtype or jnp.float32
    res = jka.masked_attention(
        jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        jnp.asarray(bg), scale=SCALE, with_headmean=hm, interpret=True)
    return [np.asarray(r.astype(jnp.float32)) for r in res]


def _torch(fn, q, k, v, bg, hm, dtype=torch.float32):
    res = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
             torch.from_numpy(bg), scale=SCALE, with_headmean=hm)
    return res


@pytest.mark.parametrize("bg_kind", ["none", "30%", "all"])
@pytest.mark.parametrize("hm", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 17), (2, 3, 37)])
def test_plain_version_matches_jax_kernel_f32(shape, hm, bg_kind):
    b, h, n = shape
    q, k, v, bg = _inputs(b, h, n, seed=n + h, bg_kind=bg_kind)
    want = _jax(q, k, v, bg, hm)
    got = _torch(tka.masked_attention_ref, q, k, v, bg, hm)
    assert len(got) == len(want) == (3 if hm else 2)
    for name, g, w in zip(("out", "cls", "hm"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL[np.float32][name], err_msg=name)
    np.testing.assert_allclose(got[1].numpy().sum(-1), 1.0, atol=1e-5)
    assert np.isfinite(got[0].numpy()).all()      # all-background: no NaN
    if hm:
        np.testing.assert_allclose(got[2][:, 0].numpy(), got[1].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("bg_kind", ["none", "30%", "all"])
@pytest.mark.parametrize("hm", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 17), (2, 3, 37)])
def test_plain_version_matches_jax_kernel_bf16(shape, hm, bg_kind):
    """bf16 q, k, v: out within 1e-2, the probabilities within 1e-3 (both
    emit them in bf16, 2^-8 relative)."""
    b, h, n = shape
    q, k, v, bg = _inputs(b, h, n, seed=3 * n + h, bg_kind=bg_kind)
    want = _jax(q, k, v, bg, hm, dtype=None if jnp is None else jnp.bfloat16)
    got = _torch(tka.masked_attention_ref, q, k, v, bg, hm, torch.bfloat16)
    for name, g, w in zip(("out", "cls", "hm"), got, want):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=TOL["bf16"][name], err_msg=name)


@pytest.mark.parametrize("bg_kind", ["none", "30%", "all"])
@pytest.mark.parametrize("n", [17, 37])
def test_pair_mask_agrees_with_the_fused_kernels_rank1_mask(n, bg_kind):
    """Without the clamp the v1 pair mask and the fused kernel's rank-1 mask
    give the same P: a background query row is shifted by mask_value as a
    whole, which the softmax removes."""
    b, h = 2, 3
    q, k, v, bg = _inputs(b, h, n, seed=5 * n, bg_kind=bg_kind)
    got = _torch(tka.masked_attention_ref, q, k, v, bg, True)
    qkv = torch.from_numpy(np.stack([q, k, v])).permute(1, 3, 0, 2, 4) \
        .reshape(b, n, 3 * h * DH)
    want = tka.masked_attention_fused_ref(
        qkv, torch.from_numpy(bg), num_heads=h, scale=SCALE,
        with_headmean=True, clamp_softmax=False)
    out = got[0].permute(0, 2, 1, 3).reshape(b, n, h * DH)
    torch.testing.assert_close(out, want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)


def test_cpu_tensors_run_the_plain_version():
    q, k, v, bg = _inputs(2, 2, 17, seed=1, bg_kind="30%")
    before = tka.v1_launches
    for hm in (False, True):
        got = _torch(tka.masked_attention, q, k, v, bg, hm)
        want = _torch(tka.masked_attention_ref, q, k, v, bg, hm)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tka.v1_launches == before   # only CUDA launches count


def test_bad_shapes_and_devices_raise():
    q, k, v, bg = (torch.from_numpy(a)
                   for a in _inputs(2, 2, 17, seed=2, bg_kind="30%"))
    with pytest.raises(ValueError):
        tka.masked_attention(q, k[:, :, :-1], v, bg, scale=SCALE)
    with pytest.raises(ValueError):
        tka.masked_attention(q, k, v, bg[:, :-1], scale=SCALE)
    with pytest.raises(ValueError):
        tka.masked_attention(q.reshape(4, 17, DH), k, v, bg, scale=SCALE)
    with pytest.raises(ValueError):
        tka.masked_attention(*(t.to("meta") for t in (q, k, v, bg)),
                             scale=SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("hm", [False, True])
@pytest.mark.parametrize("n", [197, 37, 1025])
def test_cuda_kernel_matches_plain_version(n, hm):
    """The hand-written kernel against its plain version on the card, 12
    heads of 64; tolerances as in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    for dtype, (atol, rtol) in ((torch.float32, (5e-5, 1e-4)),
                                (torch.bfloat16, (1e-2, 2 ** -6))):
        q, k, v = (torch.randn((2, 12, n, 64), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        bg = (torch.rand((2, n), generator=g, device="cuda") < 0.3).float()
        before = tka.v1_launches
        got = tka.masked_attention(q, k, v, bg, scale=0.125, with_headmean=hm)
        assert tka.v1_launches == before + 1
        want = tka.masked_attention_ref(q, k, v, bg, scale=0.125,
                                        with_headmean=hm)
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=atol,
                                       rtol=rtol)
