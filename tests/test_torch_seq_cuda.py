"""The sequence-parallel attention kernel against its plain version on the
card (``pytest --noconftest -m cuda tests/test_torch_seq_cuda.py``: this file
imports no jax, the machine with the card has none).  Skips where there is
no card: the CUDA kernel has no interpret mode.  bf16 runs the tensor-core
design, float32 the FMA design."""

import pytest
import torch

from vision_transformer_cam_tpu_torch.kernels import attention as tattn


@pytest.mark.cuda
@pytest.mark.parametrize("bg_kind", ["30%", "none", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,sp", [(197, 4), (577, 2), (1025, 8)])
def test_seq_kernel_matches_plain_version_on_the_card(n, sp, dtype, bg_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    heads = 16
    g = torch.Generator(device="cuda").manual_seed(n)
    qkv = torch.randn((2, n, 3 * heads * 64), generator=g, device="cuda")
    share = {"30%": 0.3, "none": 0.0, "all": 1.1}[bg_kind]
    bg = (torch.rand((2, n), generator=g, device="cuda") < share).float()
    if bg_kind == "30%":
        bg[:, 0] = 0
    nq = -(-n // sp)
    pad = nq * sp - n
    qkv_p = torch.nn.functional.pad(qkv, (0, 0, 0, pad)).to(dtype)
    bg_p = torch.nn.functional.pad(bg, (0, pad))
    c = heads * 64
    kv = qkv_p[:, :, c:].contiguous()
    kw = dict(num_heads=heads, scale=0.125, with_headmean=True,
              clamp_softmax=True, hm_dtype=torch.float32, n_real=n)
    before = tattn.seq_launches
    for r in range(sp):
        q = qkv_p[:, r * nq:(r + 1) * nq, :c].contiguous()
        bg_q = bg_p[:, r * nq:(r + 1) * nq].contiguous()
        got = tattn.masked_attention_seq_local(q, kv, bg_q, bg_p, **kw)
        want = tattn.masked_attention_seq_local_ref(q, kv, bg_q, bg_p, **kw)
        atol = 5e-5 if dtype == torch.float32 else 1e-2
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.float(), w_.float(), atol=atol,
                                       rtol=2 ** -6)
        # a fixed order of sums: a second launch gives the same bits
        again = tattn.masked_attention_seq_local(q, kv, bg_q, bg_p, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert tattn.seq_launches == before + 2 * sp
