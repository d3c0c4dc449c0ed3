"""Attention-kernel ablations: where does a layer's attention time go?

Each variant strips or swaps one stage of the fused attention kernel with the
in-kernel rollout update, so that the cost of exp, the mask, the softmax and
the int8 forms of the two products can be read off differences (the port of
scripts/attn_variants.py of the TPU package).

    python3 -m vision_transformer_cam_tpu_torch.scripts.attn_variants <variant>
    python3 -m vision_transformer_cam_tpu_torch.scripts.attn_variants --all

Variants: full, noexp (softmax -> s / sum(s)), matmul-only (p = s * 0.001),
nomask, int8qk (S = int8 Q K^T with per-row scales made in the kernel), int8pv
(P and V quantized to int8 for P V), int8both, headbatch (the function of
full; the heads side by side in a thread block, one warp each, in place of
the serial head loop).  ``--batch`` (default 512), ``--device`` (default the
card; ``cpu`` runs the plain versions and says so).

``run`` launches the hand-written kernels of ``kernels/csrc/attn_variants.cu``
on CUDA tensors and runs ``run_ref``, the plain PyTorch version, on CPU
tensors; ``launches`` counts the launches by variant.  bf16 runs the
tensor-core design, kernel 1's with one stage stripped or swapped (``full``
is kernel 1's bf16 rollout variant, bit for bit), so that the differences say
where kernel 1's time goes; float32 runs the FMA design (``variants_design``).
"""

from __future__ import annotations

import sys

import torch

from vision_transformer_cam_tpu_torch.kernels.attention import (
    _DTYPE_CODES, _check_shapes, check_head_width)
from vision_transformer_cam_tpu_torch.utils import (check_cli_flags,
                                                    resolve_device)
from vision_transformer_cam_tpu_torch.utils.profiling import timeit

N, C, H = 197, 768, 12
SCALE = 0.125
DEPTH = 12

_VARIANTS = ("full", "noexp", "matmul-only", "nomask", "int8qk", "int8pv",
             "int8both", "headbatch")
launches = {v: 0 for v in _VARIANTS}
# The tensor-core design takes bf16 at N <= VARIANTS_TC_MAX_N (the serial
# variants: the [16, N] float32 head mean, and int8pv's int8 V of the whole
# head, in shared memory beside the warps' rings) and N <= HEADBATCH_TC_MAX_N
# (headbatch: a [16, N] float32 tile for each of its 4 warps).  The FMA design
# takes float32 (its [32, N] float32 tiles of S and the head mean; headbatch
# a [H, 16, N] tile, N <= 205 at 12 heads).
VARIANTS_TC_MAX_N = 780
HEADBATCH_TC_MAX_N = 736
VARIANT_DESIGNS = {"fma": 0, "tensor-core": 1}
# The design bf16 runs; only chip_smoke.py sets "fma", to time the earlier
# one beside it.  No flag reaches it.
_variants_bf16_design = "tensor-core"
# what --all reads off the times: (label, variant, the variant it is held to)
_DIFFS = (("exp", "full", "noexp"), ("mask", "full", "nomask"),
          ("softmax (exp, sum, divide)", "full", "matmul-only"),
          ("int8 QK^T in place of float", "int8qk", "full"),
          ("int8 PV in place of float", "int8pv", "full"),
          ("both int8 products", "int8both", "full"),
          ("heads side by side", "headbatch", "full"))


def _check_variant(variant):
    if variant not in _VARIANTS:
        # an unknown name must not fall through to the full kernel and print
        # a plausible mislabeled number
        raise SystemExit(f"unknown variant {variant!r}; one of {_VARIANTS}")


def variants_design(dtype, variant, n: int) -> str:
    """The CUDA design of ``variant`` for qkv of ``dtype`` at sequence length
    ``n``: "tensor-core" for bfloat16 up to ``VARIANTS_TC_MAX_N`` (headbatch
    ``HEADBATCH_TC_MAX_N``), past which it raises: no design is taken in its
    place.  "fma" for float32, whose launch checks its own shared memory."""
    _check_variant(variant)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the variant kernels take bfloat16 or float32 qkv, "
                        f"got {dtype}")
    if dtype == torch.float32:
        return "fma"
    limit = HEADBATCH_TC_MAX_N if variant == "headbatch" else VARIANTS_TC_MAX_N
    if _variants_bf16_design == "tensor-core" and n > limit:
        raise ValueError(f"the tensor-core {variant} kernel takes N <= {limit} "
                         f"(its shared memory), got {n}")
    return _variants_bf16_design


def pv8_key_order():
    """The key order in which the tensor-core int8pv kernel stages V (and so
    forms the k dimension of P V), within each chunk of 32 keys: position
    4t + i of a k32 step is key 2t + (i & 1) + 8 (i >> 1), plus 16 in the
    upper half, the keys the S accumulators of lane 4g + t already hold in
    that order.  ``pv8_key`` of the kernel source, as a list."""
    return [(p & 16) + 2 * ((p & 15) >> 2) + (p & 1) + 8 * ((p >> 1) & 1)
            for p in range(32)]


def _int_matmul(a, b):
    """a @ b of integer-valued tensors with an exact sum: float64 holds every
    partial sum (< 2^53), as an int32 accumulator does."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def quantize_rows(x, dim):
    """Dynamic symmetric int8 along ``dim``, as the int8 variants quantize in
    the kernel: scale = max|x| / 127 in float32, values round(x / scale)
    (half to even).  Returns (int8 values, float32 scales with ``dim`` kept).
    The divisor is a tensor: on a CUDA tensor ATen turns a division by a
    Python number into a multiplication by its reciprocal, which is not the
    true float32 division the kernels (and jnp) make, and bf16 data put
    x / scale on exact .5 ties where the last bit of the scale decides."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=dim, keepdim=True) / _f127(x)
    return torch.round(x32 / scale).to(torch.int8), scale


def _f127(x):
    return torch.full((), 127.0, dtype=torch.float32, device=x.device)


def run_ref(qkv, bg, joint, variant, *, num_heads: int = H,
            scale: float = SCALE):
    """Plain PyTorch version of every variant, following the TPU kernels
    line by line.

    qkv: [B, N, 3C] (heads contiguous inside q|k|v); bg: [B, N] (1.0 =
    background); joint: [B, N, N].  Returns (out [B, N, C] and cls_row
    [B, N] in qkv's dtype, J' = 0.5 * (hm @ J + J) in joint's dtype), hm the
    head mean of P.  S, P and the sums are float32; P is rounded to v's
    dtype before P V (int8pv: to int8 at x127).  ``headbatch`` computes the
    function of ``full`` over all heads at once."""
    _check_variant(variant)
    _check_shapes(qkv, bg, joint, num_heads)
    b, n, c3 = qkv.shape
    c, h = c3 // 3, num_heads
    f32 = torch.float32
    q, k, v = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
    if variant in ("int8qk", "int8both"):
        qi, qa = quantize_rows(q, -1)
        ki, ka = quantize_rows(k, -1)
        s32 = _int_matmul(qi, ki.transpose(-1, -2))
        s = s32 * (qa * scale) * ka.transpose(-1, -2)
    else:
        s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if variant != "nomask":
        bgf = bg.to(f32)
        s = s + ((1.0 - bgf)[:, :, None] * (bgf * -100.0)[:, None, :])[:, None]
    if variant == "matmul-only":
        p = s * 0.001
    elif variant == "noexp":
        p = s / s.sum(dim=-1, keepdim=True)
    else:
        e = torch.exp(torch.clamp_max(s, 80.0))
        p = e / e.sum(dim=-1, keepdim=True)
    cls_row = p[:, :, 0, :].sum(dim=1) / h
    hm = p.sum(dim=1) / h
    if variant in ("int8pv", "int8both"):
        pi = torch.round(p * 127.0).to(torch.int8)
        vi, va = quantize_rows(v, -2)
        ov = _int_matmul(pi, vi) * (va / _f127(va))
    else:
        ov = torch.matmul(p.to(v.dtype).to(f32), v.to(f32))
    out = ov.to(qkv.dtype).transpose(1, 2).reshape(b, n, c)
    jf = joint.to(f32)
    newj = 0.5 * (torch.matmul(hm.to(joint.dtype).to(f32), jf) + jf)
    return out, cls_row.to(qkv.dtype), newj.to(joint.dtype)


def run(qkv, bg, joint, variant, *, num_heads: int = H, scale: float = SCALE):
    """Same contract as ``run_ref``.  CPU tensors run the plain version; CUDA
    tensors launch the variant's kernel (qkv bfloat16 or float32, contiguous,
    16-byte aligned, head width 64; bg float32 or bf16; joint float32) in
    the design ``variants_design`` picks, or raise: bf16 the tensor-core
    design (N <= ``VARIANTS_TC_MAX_N``, headbatch ``HEADBATCH_TC_MAX_N``),
    float32 the FMA design (N as far as its tiles fit shared memory: about
    780 for the serial variants, and [heads, 16, N] float32 for headbatch,
    N <= 205 at 12 heads)."""
    _check_variant(variant)
    if qkv.device.type == "cpu":
        return run_ref(qkv, bg, joint, variant, num_heads=num_heads,
                       scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"attn_variants.run: no kernel for device "
                         f"{qkv.device}")
    _check_shapes(qkv, bg, joint, num_heads)
    if joint is None:
        raise ValueError("attn_variants.run needs the joint [B, N, N]")
    if bg.device != qkv.device or joint.device != qkv.device:
        raise ValueError("qkv, bg and joint must be on the same device")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (qkv, bg, joint)):
        raise ValueError("attn_variants.run is not differentiable; call it "
                         "without gradient tracking")
    if not bg.is_floating_point() or bg.dtype == torch.float64:
        raise TypeError(f"bg must be a float32/bfloat16 tensor, got {bg.dtype}")
    if joint.dtype != torch.float32 or not joint.is_contiguous():
        raise TypeError("joint must be a contiguous float32 tensor")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    b, n, c3 = qkv.shape
    c = c3 // 3
    check_head_width("variants", c // num_heads)
    design = variants_design(qkv.dtype, variant, n)

    from vision_transformer_cam_tpu_torch.kernels import _build
    lib = _build.load()
    name = variant.replace("-", "_")
    entry = getattr(lib, "vitcam_attn_variant_" + name)
    bg32 = bg.to(torch.float32).contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    cls_row = torch.empty((b, n), dtype=qkv.dtype, device=qkv.device)
    newj = torch.empty_like(joint)   # never in place: tiles read all of J
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = entry(qkv.data_ptr(), bg32.data_ptr(), joint.data_ptr(),
                    out.data_ptr(), cls_row.data_ptr(), newj.data_ptr(), b, n,
                    num_heads, c // num_heads, float(scale),
                    _DTYPE_CODES[qkv.dtype], VARIANT_DESIGNS[design], stream)
    if err:
        msg = lib.vitcam_cuda_error_string(err).decode()
        need = lib.vitcam_attn_variant_smem_bytes(
            n, _build.ATTN_VARIANT_ENTRIES.index(name), num_heads,
            VARIANT_DESIGNS[design])
        raise RuntimeError(
            f"attn_variants {variant} kernel launch failed ({design} design): "
            f"cudaError {err} ({msg}); shared memory needed {need} bytes")
    launches[variant] += 1
    return out, cls_row, newj


def inputs(batch, device, dtype=torch.bfloat16, n=N, c=C):
    """Seeded inputs on ``device``: qkv ~ N(0, 1), 30 % background, J = I."""
    qkv = torch.randn((batch, n, 3 * c),
                      generator=torch.Generator().manual_seed(0)).to(dtype)
    bg = (torch.rand((batch, n), generator=torch.Generator().manual_seed(1))
          < 0.3).to(torch.float32)
    joint = torch.eye(n, dtype=torch.float32).expand(batch, n, n).contiguous()
    return qkv.to(device), bg.to(device), joint.to(device)


def main(argv=None, *, n=N, c=C, num_heads=H, chunk=20, iters=3):
    """Times one variant (or with ``--all`` the eight in turn) and prints one
    line each; returns {variant: ms per layer}.  ``n``, ``c``, ``num_heads``
    and the window sizes are arguments so that a test can run a small shape."""
    argv = list(sys.argv[1:] if argv is None else argv)
    check_cli_flags(["attn_variants"] + argv, bool_flags=("--all",),
                    value_flags=("--batch", "--device"), prog="attn_variants")

    def value(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    names = [a for i, a in enumerate(argv) if not a.startswith("--")
             and (i == 0 or argv[i - 1] not in ("--batch", "--device"))]
    variants = _VARIANTS if "--all" in argv else (names or ["full"])[:1]
    for variant in variants:
        _check_variant(variant)
    device = resolve_device(value("--device", None))
    batch = int(value("--batch", 512))
    where = "" if device.type == "cuda" else \
        " [plain versions on the CPU: not a device time]"
    qkv, bg, joint = inputs(batch, device, n=n, c=c)
    with torch.inference_mode():
        ms = {}
        for variant in variants:
            # two warm-ups, then the best of ``iters`` windows of ``chunk``
            # launches, each closed by one wait for the card
            ms[variant] = timeit(
                lambda: run(qkv, bg, joint, variant, num_heads=num_heads),
                chunk=chunk, iters=iters, device=device)
            print(f"{variant}: {ms[variant]:.2f} ms/layer "
                  f"({ms[variant] * DEPTH:.1f} ms per 12-layer model){where}",
                  flush=True)
    if "--all" in argv:
        for label, a, b_ in _DIFFS:
            print(f"difference {label}: {a} - {b_} = {ms[a] - ms[b_]:+.3f} "
                  f"ms/layer ({100 * (ms[a] - ms[b_]) / ms['full']:+.1f} % of "
                  f"full){where}", flush=True)
    return ms


if __name__ == "__main__":
    main()
