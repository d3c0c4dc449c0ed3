"""The port's attention-kernel ablations (``scripts.attn_variants``) against
the JAX TPU kernels of scripts/attn_variants.py.

The JAX script fixes its shape in module globals and has no interpret switch:
it is loaded here under another module name, its globals are set to a small
shape, and ``pallas_call`` is replaced by its interpret-mode form for the
test.  The port's plain PyTorch versions (``run_ref``, what ``run`` runs on
CPU tensors) are held against it for all eight variants.  The CUDA kernels are
held against ``run_ref`` on the card (marked ``cuda``):

    python -m pytest --noconftest -m cuda tests/test_torch_attn_variants.py
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from vision_transformer_cam_tpu_torch.scripts import attn_variants as tav

try:  # the GPU machine has no jax: there only the cuda-marked test runs
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
except ImportError:
    jnp = pl = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, C, H, DH, SCALE = 2, 17, 32, 2, 16, 0.25
INT8 = ("int8qk", "int8pv", "int8both")


@pytest.fixture
def jav(monkeypatch):
    """The JAX script at the small shape, its kernels in interpret mode."""
    if pl is None:
        pytest.skip("needs jax (the JAX reference)")
    spec = importlib.util.spec_from_file_location(
        "jax_attn_variants_small",
        os.path.join(REPO, "scripts", "attn_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.N, mod.C, mod.H, mod.DH, mod.SCALE = B, N, C, H, DH, SCALE
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


def _inputs(seed):
    """q and k of mean 0.5, so that noexp's row sums stay away from 0."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    qkv[:, :, :2 * C] += 0.5
    bg = (rng.random((B, N)) < 0.3).astype(np.float32)
    bg[:, 0] = 0.0
    j = rng.standard_normal((B, N, N))
    joint = (np.exp(j) / np.exp(j).sum(-1, keepdims=True)).astype(np.float32)
    return qkv, bg, joint


def _both(jav, variant, dtype, seed):
    qkv, bg, joint = _inputs(seed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jav.run(jnp.asarray(qkv, jdt), jnp.asarray(bg)[:, None, :],
                   jnp.asarray(joint), variant=variant)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[1] = want[1][:, 0]
    got = tav.run_ref(torch.from_numpy(qkv).to(dtype), torch.from_numpy(bg),
                      torch.from_numpy(joint), variant, num_heads=H,
                      scale=SCALE)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[2].dtype == torch.float32
    return [g.float().numpy() for g in got], want


@pytest.mark.parametrize("variant", tav._VARIANTS)
def test_plain_version_matches_jax_kernel_f32(jav, variant):
    """float32: out 1e-5, cls row 1e-6, J' 1e-6 (the two sum in other
    orders); noexp relative 1e-4, its row sums of logits make outputs of
    order 1e2 possible."""
    got, want = _both(jav, variant, torch.float32, seed=11)
    for name, g, w, atol in zip(("out", "cls", "joint"), got, want,
                                (1e-5, 1e-6, 1e-6)):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        rtol = 1e-4 if variant == "noexp" else 0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", tav._VARIANTS)
def test_plain_version_matches_jax_kernel_bf16(jav, variant):
    """bf16 qkv: out and cls row are emitted in bf16 by both (1e-2, 1e-3;
    noexp relative 2^-6 besides); J' is float32 from a float32 head mean."""
    got, want = _both(jav, variant, torch.bfloat16, seed=12)
    rtol = 2 ** -6 if variant == "noexp" else 0
    for name, g, w, atol in zip(("out", "cls", "joint"), got, want,
                                (1e-2, 1e-3, 1e-3)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def test_int8_operands_equal_the_jax_formulas_bit_for_bit():
    """The per-row (q, k) and per-column (v) dynamic int8 operands and their
    scales, as the TPU kernel forms them with jnp."""
    if jnp is None:
        pytest.skip("needs jax (the JAX reference)")
    qkv, _, _ = _inputs(13)
    x = qkv[0, :, :DH]
    for axis in (-1, 0):
        a = jnp.max(jnp.abs(jnp.asarray(x)), axis=axis, keepdims=True) / 127.0
        xi = jnp.round(jnp.asarray(x) / a).astype(jnp.int8)
        ti, ta = tav.quantize_rows(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
        assert np.abs(ti.numpy()).max() == 127


def test_headbatch_is_the_function_of_full():
    qkv, bg, joint = (torch.from_numpy(a) for a in _inputs(14))
    full = tav.run_ref(qkv, bg, joint, "full", num_heads=H, scale=SCALE)
    hb = tav.run_ref(qkv, bg, joint, "headbatch", num_heads=H, scale=SCALE)
    for f, h_ in zip(full, hb):
        torch.testing.assert_close(h_, f, rtol=0, atol=1e-6)


@pytest.mark.parametrize("variant", ["noexp", "nomask", "matmul-only"] +
                         list(INT8))
def test_every_variant_differs_from_full(variant):
    """A variant that fell through to the full kernel would pass the parity
    tests of its neighbours: each must move the output."""
    qkv, bg, joint = (torch.from_numpy(a) for a in _inputs(15))
    full = tav.run_ref(qkv, bg, joint, "full", num_heads=H, scale=SCALE)
    got = tav.run_ref(qkv, bg, joint, variant, num_heads=H, scale=SCALE)
    assert float((got[0] - full[0]).abs().max()) > 1e-4


def test_pv8_key_order_is_the_accumulator_layout_and_keeps_the_product():
    """The key order of the tensor-core int8pv kernel's P V, derived here from
    the mma.sync fragment layouts: lane 4g + t holds S accumulator keys
    8j + 2t and 8j + 2t + 1 of n8 tile j (columns 2t, 2t + 1 of a C
    fragment), and the s8 A fragment of m16n8k32 wants k positions 4t..4t+3
    (register a0) and 16+4t..16+4t+3 (a2), lowest byte first.  Packing the
    thread's own P values in register order puts key 2t, 2t+1 (tile 0),
    8+2t, 9+2t (tile 1) at positions 4t..4t+3 and tiles 2, 3 likewise at
    16+4t..  The map is a permutation of each 32-key chunk, so staging V's
    keys in that order gives the int32 product of P and V exactly."""
    order = tav.pv8_key_order()
    want = [None] * 32
    for t in range(4):
        held = [8 * j + 2 * t + e for j in range(4) for e in range(2)]
        for i, key in enumerate(held[:4]):
            want[4 * t + i] = key
        for i, key in enumerate(held[4:]):
            want[16 + 4 * t + i] = key
    assert order == want
    assert sorted(order) == list(range(32))
    rng = np.random.default_rng(18)
    n = 3 * 32   # three chunks
    p = torch.from_numpy(rng.integers(-127, 128, (16, n))).to(torch.int32)
    v = torch.from_numpy(rng.integers(-127, 128, (n, 64))).to(torch.int32)
    perm = torch.tensor([32 * (pos // 32) + order[pos % 32]
                         for pos in range(n)])
    assert torch.equal(p[:, perm] @ v[perm], p @ v)
    assert not torch.equal(perm, torch.arange(n))


def test_unknown_variant_is_a_system_exit():
    qkv, bg, joint = (torch.from_numpy(a) for a in _inputs(16))
    with pytest.raises(SystemExit, match="unknown variant"):
        tav.run(qkv, bg, joint, "ful", num_heads=H, scale=SCALE)
    with pytest.raises(SystemExit, match="unknown variant"):
        tav.main(["ful", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown flag"):
        tav.main(["full", "--devcie", "cpu"])


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    qkv, bg, joint = (torch.from_numpy(a) for a in _inputs(17))
    before = dict(tav.launches)
    for variant in tav._VARIANTS:
        got = tav.run(qkv, bg, joint, variant, num_heads=H, scale=SCALE)
        want = tav.run_ref(qkv, bg, joint, variant, num_heads=H, scale=SCALE)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tav.launches == before


def test_main_prints_one_line_per_variant_and_the_differences(capsys):
    ms = tav.main(["--all", "--batch", "2", "--device", "cpu"], n=N, c=C,
                  num_heads=H, chunk=1, iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(ms) == set(tav._VARIANTS)
    for variant, line in zip(tav._VARIANTS, lines):
        assert line.startswith(f"{variant}: ") and "ms/layer" in line
        assert "not a device time" in line
    assert sum(ln.startswith("difference ") for ln in lines) == len(tav._DIFFS)
    one = tav.main(["int8pv", "--batch", "2", "--device", "cpu"], n=N, c=C,
                   num_heads=H, chunk=1, iters=1)
    assert list(one) == ["int8pv"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tav._VARIANTS)
def test_cuda_kernels_match_plain_version(variant):
    """The hand-written kernels against run_ref on the card, 12 heads of 64,
    N = 197 and a ragged 37; tolerances as in chip_smoke.py (an int8 P V out
    may be a step of V off on 0.1 % of its elements)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, (atol, rtol) in ((torch.float32, (5e-5, 1e-4)),
                                (torch.bfloat16, (1e-2, 2 ** -6))):
        for n in (197, 37):
            qkv = torch.randn((4, n, 3 * 768), generator=g, device="cuda")
            qkv[:, :, :2 * 768] += 0.5
            qkv = qkv.to(dtype)
            bg = (torch.rand((4, n), generator=g, device="cuda") < 0.3).float()
            joint = torch.softmax(torch.randn((4, n, n), generator=g,
                                              device="cuda"), dim=-1)
            before = tav.launches[variant]
            got = tav.run(qkv, bg, joint, variant)
            assert tav.launches[variant] == before + 1
            want = tav.run_ref(qkv, bg, joint, variant)
            if variant == "noexp":
                rtol = max(rtol, 1e-3)
            for i, (a, w) in enumerate(zip(got, want)):
                a, w = a.float(), w.float()
                if i == 0 and variant in ("int8pv", "int8both"):
                    over = (a - w).abs() > atol + rtol * w.abs()
                    assert float(over.float().mean()) <= 1e-3
                    continue
                torch.testing.assert_close(a, w, atol=atol, rtol=rtol)
