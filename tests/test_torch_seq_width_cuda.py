"""The sequence-parallel attention kernel at head widths 80, 16, 32 and 40 on
the card, against its plain version.

Each width at two shapes (ViT-H/14's N = 257 over two ranks and N = 1025 over
eight at 16 heads of 80; the JAX kernel tests' fuzz shapes and the JAX
quickstart's N = 65 at the narrow widths), every rank's shard, float32 (the
FMA design) and bf16 (the tensor-core design, launched twice for identical
bits), with the float32 head mean and clamp, and without either; then each
width at its longest padded token axis (``SEQ_MAX_NP``) and one key
past it, which the wrapper refuses naming the bytes.  The gates are
chip_smoke.py's (TOL).  The kernel has no CPU mode: the tests skip without a
CUDA GPU; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_width_cuda.py
"""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tka

TOL = {(torch.float32, "out"): (5e-5, 1e-4),
       (torch.float32, "prob"): (1e-6, 1e-4),
       (torch.bfloat16, "out"): (1e-2, 2 ** -6),
       (torch.bfloat16, "prob"): (1e-5, 2 ** -6)}
# (head width, B, N, heads, ranks)
SHAPES = [(80, 2, 257, 16, 2), (80, 2, 1025, 16, 8),
          (16, 2, 65, 4, 2), (16, 2, 37, 4, 4),
          (32, 2, 130, 4, 2), (32, 2, 1025, 2, 8),
          (40, 2, 147, 3, 2), (40, 2, 37, 3, 1)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")


def _close(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().sub(atol + rtol * want.abs()).max()) <= 0


def _shards(b, n, heads, dh, dtype, sp, seed):
    """Every rank's (q, bg_q) of a seeded qkv with hot query rows 1-3
    (logits past the clamp) and 30 % background, zero-padded to sp ranks,
    and the gathered K | V and bg."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c, nq = heads * dh, -(-n // sp)
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda")
    qkv[:, 1:4, :c] *= 40.0
    bg = (torch.rand((b, n), generator=g, device="cuda") < 0.3).float()
    bg[:, 0] = 0.0
    pad = nq * sp - n
    qkv = torch.nn.functional.pad(qkv, (0, 0, 0, pad)).to(dtype)
    bg = torch.nn.functional.pad(bg, (0, pad))
    return ([(qkv[:, r * nq:(r + 1) * nq, :c].contiguous(),
              bg[:, r * nq:(r + 1) * nq].contiguous()) for r in range(sp)],
            qkv[:, :, c:].contiguous(), bg)


@pytest.mark.cuda
@pytest.mark.parametrize("hm", [True, False], ids=["hm_clamp", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh,b,n,heads,sp", SHAPES,
                         ids=[f"w{s[0]}_N{s[2]}_sp{s[4]}" for s in SHAPES])
def test_seq_kernel_at_width_matches_plain_version(dh, b, n, heads, sp, dtype,
                                                   hm):
    _card()
    shards, kv, bg_k = _shards(b, n, heads, dh, dtype, sp, seed=n + dh)
    kw = dict(num_heads=heads, scale=dh ** -0.5, n_real=n,
              with_headmean=hm, clamp_softmax=hm,
              hm_dtype=torch.float32 if hm else None)
    tols = [TOL[(dtype, "out")], TOL[(dtype, "prob")],
            TOL[(torch.float32, "prob")]]
    before = dict(tka.seq_width_launches)
    for q, bg_q in shards:
        got = tka.masked_attention_seq_local(q, kv, bg_q, bg_k, **kw)
        want = tka.masked_attention_seq_local_ref(q, kv, bg_q, bg_k, **kw)
        assert len(got) == len(want) == (3 if hm else 2)
        for g_, w_, tol in zip(got, want, tols):
            _close(g_, w_, tol)
        if dtype == torch.bfloat16:   # a fixed order of sums
            again = tka.masked_attention_seq_local(q, kv, bg_q, bg_k, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
    per = 2 if dtype == torch.bfloat16 else 1
    assert tka.seq_width_launches == {**before, dh: before[dh] + per * sp}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 32, 40, 64, 80])
def test_seq_kernel_at_its_limit_and_past_it(dh, dtype):
    """At Np = SEQ_MAX_NP[dh] (16 query rows, 2 heads, the head
    mean) the kernel runs and agrees; one key more is refused, naming the
    bytes."""
    _card()
    limit = tka.SEQ_MAX_NP[dh]
    shards, kv, bg_k = _shards(1, limit, 2, dh, dtype, 1, seed=dh)
    q, bg_q = (t[:, :16].contiguous() for t in shards[0])
    kw = dict(num_heads=2, scale=dh ** -0.5, n_real=limit,
              with_headmean=True, clamp_softmax=True, hm_dtype=torch.float32)
    got = tka.masked_attention_seq_local(q, kv, bg_q, bg_k, **kw)
    want = tka.masked_attention_seq_local_ref(q, kv, bg_q, bg_k, **kw)
    for g_, w_, tol in zip(got, want, [TOL[(dtype, "out")],
                                       TOL[(dtype, "prob")],
                                       TOL[(torch.float32, "prob")]]):
        _close(g_, w_, tol)
    kv1 = torch.nn.functional.pad(kv, (0, 0, 0, 1))
    bg1 = torch.nn.functional.pad(bg_k, (0, 1))
    need = max(tka.seq_smem_bytes(limit + 1, dh, True, d)
               for d in tka.SEQ_DESIGNS)
    with pytest.raises(ValueError, match=rf"Np <= {limit} at head width {dh}"
                                         rf", got {limit + 1}: .* {need} "
                                         "bytes of shared memory"):
        tka.masked_attention_seq_local(q, kv1, bg_q, bg1,
                                       **dict(kw, n_real=limit + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [24, 48])
def test_seq_kernel_refuses_other_widths_on_the_card(dh):
    _card()
    q = torch.zeros((1, 16, 2 * dh), dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros((1, 16, 4 * dh), dtype=torch.bfloat16, device="cuda")
    bg = torch.zeros((1, 16), device="cuda")
    with pytest.raises(ValueError, match=r"head widths 16, 32, 40, 64, 80, "
                                         rf"got {dh}$"):
        tka.masked_attention_seq_local(q, kv, bg, bg, num_heads=2,
                                       scale=dh ** -0.5)
