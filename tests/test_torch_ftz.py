"""The denormal flush of the tensor-core kernels, held to the JAX package.

The bf16 tensor-core designs of the sequence-parallel kernel and of the
attention backward flush exponentials and probabilities below 2^-126 (the
float32 denormals) to zero: a masked logit is s - 100, and exp(-100) is a
denormal, on whose slow path exp would run.  The TPU flushes them too.  Here
the plain versions run with every exponential below 2^-126 set to zero, and
must stay within the parity tolerances of the unflushed plain versions
against the JAX kernels (Pallas interpret mode, float32, on the CPU):
``tests/test_torch_seq.py``'s (out 1e-5, row0 and the head mean 1e-6) and
``tests/test_torch_attention_bwd.py``'s (2e-4).  The inputs make the flush
bite: a background of all but the cls token, and hot query rows whose logits
pass the clamp at 80.

The wrappers' design rule (which design and scratch each dtype and length
gets) is tested here too: it decides what runs on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vision_transformer_cam_tpu.kernels import attention as jattn
from vision_transformer_cam_tpu_torch.kernels import attention as tattn

TINY_F32 = 2.0 ** -126     # the smallest normal float32
SCALE8, SCALE64 = 8 ** -0.5, 64 ** -0.5


@pytest.fixture
def flushed_exp(monkeypatch):
    """torch.exp with results below 2^-126 set to zero, for the duration of
    a test; ``flushed_exp.count`` counts the values it flushed."""
    exp = torch.exp

    def flushed(x, *a, **kw):
        e = exp(x, *a, **kw)
        tiny = (e > 0) & (e < TINY_F32)
        flushed.count += int(tiny.sum())
        return torch.where(tiny, torch.zeros_like(e), e)
    flushed.count = 0
    monkeypatch.setattr(torch, "exp", flushed)
    return flushed


def _inputs(b, n, c, seed, bg_kind):
    """qkv [B, N, 3C] float32 with hot query rows 1-2 (logits past the clamp)
    and a background: all but the cls token, or 30 % of the tokens."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[:, 1:3, :c] *= 40.0
    share = 1.1 if bg_kind == "all_but_cls" else 0.3
    bg = (rng.random((b, n)) < share).astype(np.float32)
    bg[:, 0] = 0.0
    return qkv, bg


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
@pytest.mark.parametrize("hm", [False, True], ids=["plain", "headmean"])
@pytest.mark.parametrize("sp", [1, 4])
def test_flushed_seq_ref_matches_jax_kernel(flushed_exp, sp, hm, clamp,
                                            bg_kind):
    """The flushed sequence-parallel plain version against JAX
    _masked_attention_seq_local on every rank's shard of N = 17 (padded to
    20 at four ranks), float32, H = 4, dh = 8."""
    heads, n = 4, 17
    qkv, bg = _inputs(2, n, heads * 8, 70 + sp, bg_kind)
    c, nq = heads * 8, -(-n // sp)
    pad = nq * sp - n
    qkv_p = np.pad(qkv, ((0, 0), (0, pad), (0, 0)))
    bg_p = np.pad(bg, ((0, 0), (0, pad)))
    kv = qkv_p[:, :, c:]
    kw = dict(num_heads=heads, scale=SCALE8, with_headmean=hm,
              clamp_softmax=clamp, n_real=n)
    for r in range(sp):
        q, bg_q = qkv_p[:, r * nq:(r + 1) * nq, :c], bg_p[:, r * nq:(r + 1) * nq]
        want = jattn._masked_attention_seq_local(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bg_q),
            jnp.asarray(bg_p), interpret=True,
            hm_dtype=jnp.float32 if hm else None, **kw)
        got = tattn.masked_attention_seq_local_ref(
            torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(bg_q),
            torch.from_numpy(bg_p), hm_dtype=torch.float32 if hm else None,
            **kw)
        for g, w, tol in zip(got, want, (1e-5, 1e-6, 1e-6)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    assert flushed_exp.count > 0    # the flush did bite


@pytest.mark.parametrize("bg_kind", ["all_but_cls", "30%"])
@pytest.mark.parametrize("clamp", [False, True], ids=["rowmax", "clamp"])
def test_flushed_bwd_ref_matches_jax_kernel(flushed_exp, clamp, bg_kind):
    """The flushed backward plain version against JAX masked_attention_bwd
    in interpret mode, float32, B=2, N=37, two heads of width 64 (the
    tensor-core kernel's width)."""
    heads, n, c = 2, 37, 128
    qkv, bg = _inputs(2, n, c, 90, bg_kind)
    d_out = np.random.default_rng(91).standard_normal((2, n, c)) \
        .astype(np.float32)
    want = jattn.masked_attention_bwd(
        jnp.asarray(qkv), jnp.asarray(bg), jnp.asarray(d_out),
        num_heads=heads, scale=SCALE64, clamp_softmax=clamp, interpret=True)
    got = tattn.masked_attention_bwd_ref(
        torch.from_numpy(qkv), torch.from_numpy(bg), torch.from_numpy(d_out),
        num_heads=heads, scale=SCALE64, clamp_softmax=clamp)
    assert got.shape == qkv.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    assert flushed_exp.count > 0


@pytest.mark.parametrize("dtype,n,design", [
    (torch.bfloat16, 37, "tensor-core"),
    (torch.bfloat16, 197, "tensor-core"),
    (torch.bfloat16, 577, "tensor-core"),
    (torch.bfloat16, 760, "tensor-core"),
    (torch.float32, 37, "one-block"),
    (torch.float32, 256, "one-block"),
    (torch.float32, 257, "two-kernel"),
    (torch.float32, 760, "two-kernel"),
])
def test_bwd_design_rule(dtype, n, design):
    """bf16 takes the tensor-core design at every N <= 760; float32 keeps
    the one-block design up to 256 and the two-kernel design past it.  Every
    design but the one-block one passes a [B, H, N, 3] float32 scratch of row
    statistics from its first kernel to its second."""
    assert tattn.BWD_ONE_BLOCK_MAX_N == 256 and tattn.BWD_MAX_N == 760
    assert tattn.bwd_design(dtype, n) == design
    shape = tattn.bwd_scratch_shape(design, 4, 12, n)
    assert shape == (None if design == "one-block" else (4, 12, n, 3))
    with pytest.raises(ValueError, match="N <="):
        tattn.bwd_design(dtype, tattn.BWD_MAX_N + 1)


def test_seq_design_rule():
    """bf16 takes the sequence-parallel kernel's tensor-core design, float32
    its FMA design; both take Np <= SEQ_MAX_NP (N = 1025 over 8 ranks)."""
    assert tattn.seq_design(torch.bfloat16) == "tensor-core"
    assert tattn.seq_design(torch.float32) == "fma"
    assert set(tattn.SEQ_DESIGNS) == {"tensor-core", "fma"}
    assert tattn.SEQ_MAX_NP >= -(-1025 // 8) * 8
